"""Multi-process execution: one process per device, one process group.

Counterpart of sfm_tpu/parallel/distributed.py.  The JAX twin joins one
process per host to a global runtime (``jax.distributed``) and places
each host's scene rows with ``NamedSharding``.  Here every device is a
process of its own (a rank), joined to one ``torch.distributed`` group:
NCCL when the ranks compute on cards, gloo on the CPU.  The sharded
programs (``parallel/multiscene.py``, ``parallel/batch_runner.py``,
``parallel/multi_scan.run_scenes_scan(mesh=...)``) are the same on one
host and on several; only the group's address and the rank numbering
differ.

``launch`` starts the ranks of one host from a parent process (the
``spawn`` start method: a child imports only the module that defines its
function, so a rank imports no JAX) and collects what each returns.
"""

from __future__ import annotations

import datetime
import queue
import socket
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch.distributed.device_mesh import DeviceMesh

from sfm_tpu_torch.parallel.mesh import make_mesh, local_scenes, rank_device
from sfm_tpu_torch.utils.device import resolve, to_device

# how long a collective, the group's rendezvous included, may wait for a
# rank: a rank that failed leaves the others waiting no longer than this
GROUP_TIMEOUT_S = 300


def initialize(coordinator_address: str, num_processes: int,
               process_id: int, device="cuda") -> None:
    """Join this process to the group as rank ``process_id`` of
    ``num_processes``.

    Call once per process, before anything else touches the device.  The
    canonical entry order of a rank::

        from sfm_tpu_torch.parallel import distributed
        distributed.initialize("host:port", n, rank)   # first
        mesh = distributed.global_mesh(...)             # then the rest

    ``coordinator_address``: ``"host:port"`` of rank 0 (a ``tcp://`` init
    method).  ``device="cuda"`` (the default; raises without a card) makes
    an NCCL group and binds the rank to card ``process_id % cards`` of its
    host (hosts with equal card counts, ranks numbered host by host);
    ``device="cpu"`` makes a gloo group.  Collectives wait at most
    ``GROUP_TIMEOUT_S`` seconds."""
    dev = resolve(device)
    if dev.type == "cuda":
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    addr = coordinator_address
    if not addr.startswith("tcp://"):
        addr = f"tcp://{addr}"
    dist.init_process_group(
        "nccl" if dev.type == "cuda" else "gloo", init_method=addr,
        world_size=num_processes, rank=process_id,
        timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))


def global_mesh(hyp_axis: int = 1, device="cuda") -> DeviceMesh:
    """``("scene", "hyp")`` mesh over every rank of the group (every
    host): ``make_mesh`` at the world size."""
    return make_mesh(None, hyp_axis=hyp_axis, device=device)


def scene_shard(mesh: DeviceMesh, global_batch) -> torch.Tensor:
    """This rank's rows of a scene batch, as a tensor on its device.

    ``global_batch`` is the FULL (S, ...) batch, identical on every rank
    (cheap for metadata-scale inputs).  The rank keeps the rows of its
    ``scene`` coordinate: the rows that the JAX twin's
    ``make_array_from_process_local_data`` gives the process that owns
    that coordinate.  Raises when S does not divide by the scene axis."""
    rows = local_scenes(mesh, len(global_batch))
    local = np.asarray(global_batch)[rows.start:rows.stop]
    return to_device(np.ascontiguousarray(local), rank_device(mesh))


# ---------------------------------------------------------------------------
# launching the ranks of one host
# ---------------------------------------------------------------------------


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(fn, args, rank: int, world: int, addr: str, device,
               results) -> None:
    """A rank's process: join the group, run ``fn(*args)``, report."""
    try:
        if torch.device(device).type == "cpu":
            torch.set_num_threads(1)  # world ranks share the host's cores
        initialize(addr, world, rank, device)
        out = fn(*args)
        # no rank leaves while another still talks to it
        dist.barrier(device_ids=[torch.cuda.current_device()]
                     if dist.get_backend() == "nccl" else None)
        results.put((rank, True, out))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def launch(fn, nprocs: int, args=(), device="cuda",
           timeout_s: float = 600.0) -> list:
    """Run ``fn(*args)`` on ``nprocs`` ranks of one host and return each
    rank's result, in rank order.

    Each rank is a fresh process (``spawn``) that calls ``initialize``
    first: NCCL with rank r on card r (``device="cuda"``, the default;
    raises when the host has fewer than ``nprocs`` cards: two ranks of one
    group never share a card), or gloo on the CPU (``device="cpu"``, one
    thread a rank).  ``fn`` must be importable by name (a module-level
    function) and its results picklable (numpy, not device tensors).
    A rank that raises makes the call raise with its traceback; so does
    a rank that dies, and a job that outlasts ``timeout_s``.  Every rank
    is stopped before the call returns."""
    dev = resolve(device)
    if dev.type == "cuda" and torch.cuda.device_count() < nprocs:
        raise RuntimeError(
            f"{nprocs} ranks need {nprocs} cards, one each; this host has "
            f"{torch.cuda.device_count()}")
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    addr = f"127.0.0.1:{_free_port()}"
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, args, r, nprocs, addr, dev.type, results))
             for r in range(nprocs)]
    out: dict[int, object] = {}
    deadline = time.monotonic() + timeout_s
    try:
        for p in procs:
            p.start()
        while len(out) < nprocs:  # drain before joining
            try:
                rank, ok, payload = results.get(timeout=1.0)
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in out and p.exitcode not in (None, 0)]
                if dead:
                    try:  # its traceback may still be on the way
                        rank, ok, payload = results.get(timeout=5.0)
                    except queue.Empty:
                        raise RuntimeError(
                            f"rank {dead[0]} died with exit code "
                            f"{procs[dead[0]].exitcode}") from None
                elif time.monotonic() > deadline:
                    raise TimeoutError(f"{nprocs} ranks of {fn.__name__} "
                                       f"outlasted {timeout_s} s")
                else:
                    continue
            if not ok:
                raise RuntimeError(f"rank {rank} of {fn.__name__} "
                                   f"failed:\n{payload}")
            out[rank] = payload
        for p in procs:
            p.join(max(deadline - time.monotonic(), 30.0))
            if p.exitcode != 0:
                raise RuntimeError(f"a rank of {fn.__name__} exited with "
                                   f"code {p.exitcode}")
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(10.0)
                if p.is_alive():
                    p.kill()
                    p.join()
        results.close()
    return [out[r] for r in range(nprocs)]


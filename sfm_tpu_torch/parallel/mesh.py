"""Device-mesh construction.

Counterpart of sfm_tpu/parallel/mesh.py.  The JAX twin lays the devices
of one controller out as a ``Mesh`` with a ``scene`` axis (data
parallelism over independent reconstructions, BASELINE config 5) and a
``hyp`` axis (RANSAC hypotheses split over devices).  Here a mesh is over
processes: one rank per device, joined in one ``torch.distributed``
process group (``parallel/distributed.initialize``), NCCL between cards
and gloo on the CPU.  ``init_device_mesh`` lays the ranks out as
``(scene, hyp)`` and makes one process group per row and column, so the
sharded code runs per rank on plain tensors and reduces explicitly over
``mesh.get_group("scene")`` or ``mesh.get_group("hyp")``, as the JAX
twin's ``shard_map`` programs do over their named axes.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from sfm_tpu_torch.utils.device import resolve


def make_mesh(n_devices: int | None = None, hyp_axis: int = 1,
              device="cuda") -> DeviceMesh:
    """A ``("scene", "hyp")`` mesh of shape ``(n // hyp_axis, hyp_axis)``
    over the ranks of the process group.

    ``hyp_axis`` ranks split the hypotheses of one RANSAC; the rest run
    scenes in parallel.  ``n_devices`` defaults to the group's world size
    and must equal it: a rank is one device, so a mesh cannot take a
    subset of the ranks.  ``device``: ``"cuda"`` (the default; the rank's
    card, set by ``initialize``) or ``"cpu"``."""
    dev = resolve(device)
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call "
                           "parallel.distributed.initialize first")
    world = dist.get_world_size()
    n = n_devices or world
    if n % hyp_axis != 0:
        raise ValueError(f"n_devices={n} not divisible by hyp_axis={hyp_axis}")
    if n != world:
        raise ValueError(f"n_devices={n} is not the process group's world "
                         f"size {world}: a mesh spans every rank, one "
                         "device each")
    return init_device_mesh(dev.type, (n // hyp_axis, hyp_axis),
                            mesh_dim_names=("scene", "hyp"))


def local_scenes(mesh: DeviceMesh, n_scenes: int) -> range:
    """The global indices of the scenes this rank holds: the rows of its
    ``scene`` coordinate (``P("scene")`` in the JAX twin), the same on every
    rank of one ``hyp`` row."""
    n_scene = mesh.size(0)
    if n_scenes % n_scene != 0:
        raise ValueError(f"batch {n_scenes} not divisible by scene axis "
                         f"{n_scene}")
    per = n_scenes // n_scene
    c = mesh.get_local_rank("scene")
    return range(c * per, (c + 1) * per)


def rank_device(mesh: DeviceMesh, device=None) -> torch.device:
    """The device this rank computes on: its card (the current CUDA device,
    which ``initialize`` set) or the CPU.  Raises when ``device`` names
    another type than the mesh's."""
    if device is not None and resolve(device).type != mesh.device_type:
        raise ValueError(f"device {device!r} on a {mesh.device_type!r} mesh")
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def gather_scenes(mesh: DeviceMesh, local):
    """Every ``scene`` coordinate's ``local`` (picklable, numpy payloads),
    in coordinate order: one ``all_gather_object`` over the ``scene``
    group.  Ranks of one ``scene`` coordinate hold the same scenes, so no
    scene is gathered twice."""
    n_scene = mesh.size(0)
    out = [None] * n_scene
    dist.all_gather_object(out, (mesh.get_local_rank("scene"), local),
                           group=mesh.get_group("scene"))
    return [v for _, v in sorted(out, key=lambda cv: cv[0])]

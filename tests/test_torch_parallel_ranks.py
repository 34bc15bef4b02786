"""The rank functions of the port's parallel tests (no tests here).

``tests/test_torch_parallel.py`` and ``tests/test_torch_batch_runner.py``
start these in gloo ranks on the CPU through
``sfm_tpu_torch.parallel.distributed.launch``.  A rank imports only this
module and the port, so it imports neither JAX nor the JAX package.  The
inputs (numpy, the JAX package's draws included) come from the test, and
each function returns numpy for the test to hold against the JAX twin.
"""

import torch
import torch.distributed as dist

from sfm_tpu_torch.models import tracker
from sfm_tpu_torch.ops import ba
from sfm_tpu_torch.parallel import (batch_runner, distributed, mesh as
                                    mesh_lib, multiscene)
from sfm_tpu_torch.parallel.multi_scan import _GATHERED, run_scenes_scan


def _np(t):
    return t.detach().cpu().numpy()


def mesh_cases(cases) -> dict:
    """``make_mesh(n, hyp)`` for each case: (shape by name, this rank's
    coordinate), or the ``ValueError``'s text."""
    out = {}
    for n, hyp in cases:
        try:
            m = mesh_lib.make_mesh(n, hyp_axis=hyp, device="cpu")
        except ValueError as e:
            out[(n, hyp)] = str(e)
        else:
            out[(n, hyp)] = (dict(zip(m.mesh_dim_names, m.shape)),
                             tuple(m.get_coordinate()))
    return out


def _scene_step(m, s: dict) -> dict:
    """``make_scene_step`` on this rank's rows of the problem ``s``."""
    shard = lambda a: distributed.scene_shard(m, a)  # noqa: E731
    step = multiscene.make_scene_step(m, s["kcfg"], num_hypotheses=s["H"],
                                      ba_iters=2)
    state = tracker.TrackerState(*(shard(s["state"][k])
                                   for k in tracker.TrackerState._fields))
    prob = ba.BAProblem(*(shard(s["prob"][k])
                          for k in ba.BAProblem._fields))
    with torch.no_grad():
        new_state, rp, ba_out, metrics = step(
            shard(s["pri"]), torch.as_tensor(s["K"]),
            tuple(shard(p) for p in s["pyr0"]),
            tuple(shard(p) for p in s["pyr1"]), state, prob)
    return {
        "scenes": list(mesh_lib.local_scenes(m, len(s["pri"]))),
        "state": {k: _np(v) for k, v in new_state._asdict().items()},
        "rp": {k: _np(v) for k, v in rp._asdict().items()},
        "ba": tuple(_np(v) for v in ba_out),
        "metrics": {k: _np(v) for k, v in metrics.items()},
    }


def four_ranks(d: dict) -> dict:
    """The 4-rank job: the mesh cases; ``find_E_sharded`` on a (1, 4)
    mesh with the JAX twin's per-rank draws and with the rank's own
    generator; ``make_scene_step`` on a (4, 1) mesh, two scenes a rank,
    on each problem of ``d["steps"]``."""
    out = {"mesh": mesh_cases(d["mesh_cases"])}
    m = mesh_lib.make_mesh(4, hyp_axis=4, device="cpu")
    h = m.get_local_rank("hyp")
    xi, xj, valid = (torch.as_tensor(d["E_in"][k])
                     for k in ("xi", "xj", "valid"))
    kw = dict(num_hypotheses_total=d["E_total"],
              sampson_thresh=d["E_thresh"])
    with torch.no_grad():
        E, c = multiscene.find_E_sharded(
            3, xi, xj, valid, m, pri=torch.as_tensor(d["E_pri"][h]), **kw)
        E_gen, c_gen = multiscene.find_E_sharded(3, xi, xj, valid, m, **kw)
    out["E"] = (_np(E), _np(c), _np(E_gen), _np(c_gen))

    m = mesh_lib.make_mesh(4, device="cpu")
    out["steps"] = [_scene_step(m, s) for s in d["steps"]]
    return out


def _scan_fields(res) -> dict:
    """A ``run_scenes_scan`` result without its views and timers, and the
    map of each local view."""
    out = {k: res[k] for k in _GATHERED}
    out["maps"] = {s: v.map_xyz for s, v in enumerate(res["views"])
                   if v is not None}
    return out


def two_ranks(d: dict) -> dict:
    """The 2-rank job: the group's collectives and ``scene_shard`` on the
    global mesh; the scene-sharded two-view stage of
    tests/distributed_worker.py; ``batch_runner.run_scenes`` with the JAX
    twin's draws; ``run_scenes_scan(mesh=...)`` with a checkpoint, then
    resumed from it."""
    m = distributed.global_mesh(hyp_axis=1, device="cpu")
    out = {"mesh": dict(zip(m.mesh_dim_names, m.shape)),
           "rank": dist.get_rank()}
    idx = torch.tensor(m.get_local_rank("scene"))
    dist.all_reduce(idx, group=m.get_group("scene"))
    out["scene_index_sum"] = int(idx)

    tv = d["two_view"]
    xi, xj, valid, pri = (distributed.scene_shard(m, tv[k])
                          for k in ("xi", "xj", "valid", "pri"))
    out["rows"] = {"xi": _np(xi), "valid": _np(valid)}
    with torch.no_grad():
        rp = multiscene.batched_two_view(pri, xi, xj, valid,
                                         **tv["kwargs"])
    totals = torch.stack([torch.sum(rp.num_inliers).double(),
                          torch.sum(rp.ok).double()])
    dist.all_reduce(totals, group=m.get_group("scene"))
    out["two_view"] = {"inliers": float(totals[0]), "ok": int(totals[1]),
                       "local_inliers": _np(rp.num_inliers)}

    rs = d["run_scenes"]
    res = batch_runner.run_scenes(
        rs["datasets"], m, kcfg=rs["kcfg"], rcfg=rs["rcfg"], device="cpu",
        _pri_source=lambda s, i: rs["pri"][s, i - 1])
    out["run_scenes"] = res

    sc = d["scan"]
    kw = dict(frames=sc["frames"], chunk=sc["chunk"], p_cap=sc["p_cap"],
              p_ba=sc["p_ba"], mesh=m, device="cpu",
              checkpoint_path=sc["checkpoint"])
    with torch.no_grad():
        first = run_scenes_scan(sc["datasets"], sc["cfg"], checkpoint_every=1,
                                **kw)
        resumed = run_scenes_scan(sc["datasets"], sc["cfg"], resume=True,
                                  **kw)
    out["scan"] = _scan_fields(first)
    out["scan_resumed"] = _scan_fields(resumed)
    return out

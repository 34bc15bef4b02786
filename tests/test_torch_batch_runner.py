"""PyTorch port vs JAX package: the multi-process layer, the lockstep batch
runner and the scene-sharded ``run_scenes_scan(mesh=...)``, on the CPU.

One job of 2 gloo ranks (tests/test_torch_parallel_ranks.py, no JAX),
started with the module and running beside this process's side:

  * ``distributed``: the global mesh, a sum over the ``scene`` group and
    ``scene_shard`` against the rows tests/distributed_worker.py's
    processes get, then that worker's scene-sharded two-view stage;
  * ``batch_runner.run_scenes`` on tests/test_parallel.py's four 5-frame
    rings against the JAX twin on ``make_mesh(4)`` with its draws;
  * ``run_scenes_scan(mesh=...)`` on the dry run's two 9-frame rings
    against the port's own unsharded run in this process, bit for bit,
    and again resumed from the checkpoint the sharded run wrote.
"""

import dataclasses
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sfm_tpu.config import KLTConfig as JKLTConfig, \
    RansacConfig as JRansacConfig
from sfm_tpu.parallel import batch_runner as jbr, mesh as jmesh

from sfm_tpu_torch.config import KLTConfig, RansacConfig
from sfm_tpu_torch.ops import umeyama
from sfm_tpu_torch.parallel import distributed, dryrun, multiscene
from sfm_tpu_torch.parallel.multi_scan import _GATHERED, run_scenes_scan
from tests import test_torch_parallel_ranks as ranks
from tests.test_torch_parallel import worker_two_view_batch

torch.set_num_threads(1)

RS_KLT = dict(max_tracks=256, min_tracks=120, pyr_levels=3, win_radius=5,
              iters=10)
RS_RANSAC = dict(num_hypotheses=128, sampson_thresh=2e-5, min_inliers=30)
RS_S, RS_F = 4, 5
SCAN_S = 2


def _run_scenes_rings(root):
    """tests/test_parallel.py:118-151's four rings (5 frames, 320x240,
    20 degrees, texture seeds 10-13)."""
    from sfm_tpu_torch.utils.dataset import TempleRing
    from sfm_tpu_torch.utils.synthetic import (SyntheticRingSpec,
                                               generate_dataset)

    dss = []
    for s in range(RS_S):
        spec = SyntheticRingSpec(n_frames=RS_F, width=320, height=240,
                                 fx=760.0, fy=760.0, arc_deg=20.0,
                                 seed=10 + s)
        generate_dataset(root / f"scene{s}", spec)
        dss.append(TempleRing.from_dir(root / f"scene{s}"))
    return dss


def _jax_run_scenes_draws(seed: int = 0):
    """The JAX runner's draws: scene keys ``split(PRNGKey(seed), S)``, each
    advanced by ``split(k)[1]`` every frame, one (H, N) ``uniform`` a
    frame and scene (N = the track table's size)."""
    keys = jax.random.split(jax.random.PRNGKey(seed), RS_S)
    H, N = RS_RANSAC["num_hypotheses"], RS_KLT["max_tracks"]
    pri = np.zeros((RS_S, RS_F - 1, H, N), np.float32)
    for i in range(1, RS_F):
        keys = jax.vmap(lambda k: jax.random.split(k)[1])(keys)
        for s in range(RS_S):
            pri[s, i - 1] = np.asarray(
                jax.random.uniform(keys[s], (H, N), jnp.float32))
    return pri


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    scan_root = tmp_path_factory.mktemp("scan_rings")
    return dict(
        two_view=worker_two_view_batch(),
        rs_datasets=_run_scenes_rings(tmp_path_factory.mktemp("rs_rings")),
        rs_pri=_jax_run_scenes_draws(),
        scan_datasets=dryrun.render_rings(scan_root, SCAN_S),
        checkpoint=tmp_path_factory.mktemp("scan_ckpt") / "ck")


@pytest.fixture(scope="module", autouse=True)
def two_ranks(inputs):
    """The 2-rank job, started with the module and read by the tests."""
    tv = {k: v for k, v in inputs["two_view"].items() if k != "keys"}
    data = dict(
        two_view=tv,
        run_scenes=dict(datasets=inputs["rs_datasets"],
                        kcfg=KLTConfig(**RS_KLT),
                        rcfg=RansacConfig(**RS_RANSAC),
                        pri=inputs["rs_pri"]),
        scan=dict(datasets=inputs["scan_datasets"], cfg=dryrun.ring_config(),
                  frames=dryrun.RING_FRAMES, chunk=dryrun.RING_CHUNK,
                  p_cap=dryrun.RING_P_CAP, p_ba=dryrun.RING_P_BA,
                  checkpoint=inputs["checkpoint"]))
    with ThreadPoolExecutor(1) as ex:
        fut = ex.submit(distributed.launch, ranks.two_ranks, 2, (data,),
                        "cpu", 600.0)
        yield fut
        fut.result()


def jax_process_rows(batch, n_procs: int = 2, n_local: int = 4,
                     hyp: int = 2) -> list:
    """The rows each process of tests/distributed_worker.py holds after
    the JAX package's ``scene_shard``: its global mesh is the
    ``(n_procs * n_local // hyp, hyp)`` grid of the devices, process p
    owns devices ``p * n_local ...``, and a process takes the rows of
    every ``scene`` slot whose first device it owns."""
    devs = np.arange(n_procs * n_local).reshape(-1, hyp)
    rows_per = len(batch) // devs.shape[0]
    return [np.concatenate([batch[slot * rows_per:(slot + 1) * rows_per]
                            for slot, d in enumerate(devs[:, 0])
                            if d // n_local == p])
            for p in range(n_procs)]


# ---------------------------------------------------------------------------
# distributed
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rank", [0, 1])
def test_torch_distributed_scene_shard_matches_jax_rows(inputs, two_ranks,
                                                        rank):
    """On the global mesh of 2 ranks ((2, 1): the port's rank is one
    device), ``scene_shard`` gives rank r exactly the rows that process r
    of tests/distributed_worker.py (2 processes x 4 devices, a (4, 2)
    mesh) holds, and the sum of scene indices over the ``scene`` group is
    n(n-1)/2, the worker's psum check."""
    out = two_ranks.result()[rank]
    assert out["rank"] == rank
    assert out["mesh"] == {"scene": 2, "hyp": 1}
    assert out["scene_index_sum"] == 2 * 1 // 2
    tv = inputs["two_view"]
    np.testing.assert_array_equal(out["rows"]["xi"],
                                  jax_process_rows(tv["xi"])[rank])
    np.testing.assert_array_equal(out["rows"]["valid"],
                                  jax_process_rows(tv["valid"])[rank])


def test_torch_distributed_two_view_psum(inputs, two_ranks):
    """The worker's scene-sharded two-view stage with the JAX twin's draws:
    each rank's per-scene inlier counts are bit for bit those of
    ``batched_two_view`` on the whole batch in this process, and the sums
    over the ``scene`` group meet the worker's bars (every scene ok,
    inliers > 90 % of all correspondences) on both ranks."""
    tv = inputs["two_view"]
    with torch.no_grad():
        rp = multiscene.batched_two_view(
            torch.as_tensor(tv["pri"]), torch.as_tensor(tv["xi"]),
            torch.as_tensor(tv["xj"]), torch.as_tensor(tv["valid"]),
            **tv["kwargs"])
    whole = rp.num_inliers.numpy()
    S, N = tv["xi"].shape[:2]
    for r, out in enumerate(two_ranks.result()):
        t = out["two_view"]
        np.testing.assert_array_equal(t["local_inliers"],
                                      whole[2 * r:2 * r + 2])
        assert t["ok"] == S
        assert t["inliers"] == float(whole.sum())
        assert t["inliers"] > 0.9 * S * N


# ---------------------------------------------------------------------------
# the lockstep batch runner
# ---------------------------------------------------------------------------


def test_torch_run_scenes_matches_jax(inputs, two_ranks):
    """``batch_runner.run_scenes`` on four 5-frame rings over 2 ranks (two
    scenes each), with the JAX twin's draws, against the JAX twin's
    ``run_scenes`` on ``make_mesh(4)``: both ranks return all four
    scenes, the same on both; every frame's inlier count within 2 % of
    the JAX twin's; each scene's camera centers within 1e-2 of the JAX
    twin's (composed unit-scale steps of relative poses held to 1e-3 /
    2e-3 each) up to the first frame whose RANSAC saw another inlier
    count than the JAX twin's; and each trajectory meets the JAX test's
    bar, Sim(3) ATE under 0.2 of its extent.

    Past such a frame the two runs are different runs: the tracks there
    differ by the last bits of LK, and a frame whose lateral and forward
    poses nearly tie can fall into either (scene 3's fourth frame does,
    239 inliers against 240; the JAX twin's ``find_E_ransac`` on the
    port's tracks and draws picks the port's pose)."""
    dss = inputs["rs_datasets"]
    jres = jbr.run_scenes(dss, jmesh.make_mesh(4),
                          kcfg=JKLTConfig(**RS_KLT),
                          rcfg=JRansacConfig(**RS_RANSAC))
    outs = [o["run_scenes"] for o in two_ranks.result()]
    for k in ("centers", "inliers"):
        np.testing.assert_array_equal(outs[0][k], outs[1][k])
    C, Cj = outs[0]["centers"], jres["centers"]
    assert C.shape == Cj.shape == (RS_S, RS_F, 3)
    inl, inl_j = outs[0]["inliers"], jres["inliers"]
    assert (np.abs(inl - inl_j) <= 0.02 * inl_j).all()
    for s, ds in enumerate(dss):
        split = np.flatnonzero(inl[s] != inl_j[s])
        upto = int(split[0]) + 1 if len(split) else RS_F
        np.testing.assert_allclose(C[s, :upto], Cj[s, :upto], atol=1e-2)
        gt = np.stack([r.center for r in ds.records])
        ate = umeyama.ate(torch.as_tensor(C[s], dtype=torch.float64),
                          torch.as_tensor(gt), with_scale=True)
        ext = np.linalg.norm(gt - gt.mean(0), axis=1).max()
        assert float(ate["rmse"]) < 0.2 * ext, (s, float(ate["rmse"]) / ext)


# ---------------------------------------------------------------------------
# run_scenes_scan(mesh=...)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def unsharded(inputs):
    """The port's unsharded run of the same rings in this process."""
    with torch.no_grad():
        return run_scenes_scan(
            inputs["scan_datasets"], dryrun.ring_config(),
            frames=dryrun.RING_FRAMES, chunk=dryrun.RING_CHUNK,
            p_cap=dryrun.RING_P_CAP, p_ba=dryrun.RING_P_BA, device="cpu")


def _same_fields(got: dict, want: dict) -> None:
    for k in ("n_keyframes", "n_points", "metrics"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for s in range(SCAN_S):
        np.testing.assert_array_equal(got["centers"][s], want["centers"][s])
        np.testing.assert_array_equal(got["kf_frames"][s],
                                      want["kf_frames"][s])
        assert len(got["loop_edges"][s]) == len(want["loop_edges"][s])
        for a, b in zip(got["loop_edges"][s], want["loop_edges"][s]):
            for f in dataclasses.fields(a):
                np.testing.assert_array_equal(getattr(a, f.name),
                                              getattr(b, f.name), f.name)


@pytest.mark.parametrize("run", ["scan", "scan_resumed"])
def test_torch_run_scenes_scan_mesh_equals_unsharded(unsharded, inputs,
                                                     two_ranks, run):
    """``run_scenes_scan(mesh=...)`` over 2 ranks (one scene each; scene s
    draws from ``scene_seed(seed, s)`` with its global s) against the
    unsharded run of both scenes in this process: on both ranks every
    gathered field (keyframe centers and frames, keyframe and point
    counts, loop edges, the metric rows) is bit for bit the unsharded
    run's, and so is each rank's own scene's map, the one view it holds
    (the other is ``None``).  ``scan_resumed``: the same run resumed from
    the checkpoint the first one wrote after its first chunk, one file per
    ``scene`` coordinate beside the path."""
    want = unsharded
    assert all(k >= 3 for k in want["n_keyframes"])
    assert all(p > 50 for p in want["n_points"])
    for r, out in enumerate(two_ranks.result()):
        got = out[run]
        assert set(got) == set(_GATHERED) | {"maps"}
        _same_fields(got, want)
        assert list(got["maps"]) == [r]
        np.testing.assert_array_equal(got["maps"][r],
                                      want["views"][r].map_xyz)
    ck = inputs["checkpoint"]
    for c in range(SCAN_S):
        assert ck.with_name(f"ck_scene{c}.npz").exists()
        assert ck.with_name(f"ck_scene{c}.json").exists()

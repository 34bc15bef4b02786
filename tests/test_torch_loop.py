"""PyTorch port vs JAX package: loop closure, pose graph and the finalize
refinement, on the CPU.

Unit checks on random inputs made from a seed (descriptor scoring, the
three pose-graph solvers in float64, the structure-only point polish),
then one module-scoped JAX run and one port run of a reduced out-and-back
ring (320x240, 15 frames: out to 35 degrees and back in 5-degree steps),
in which every return keyframe revisits an outbound one and the loop
closure fires, and one more port run with the loop verification on the
host.  From the JAX run come a carry right before the first revisit (for
the keyframe branch with its loop verification, run on both sides from
that carry with the same RANSAC priorities) and the final drain (for the
pose-graph solve and the finalize on one drained dict).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sfm_tpu import config as jconfig
from sfm_tpu.models import scan_pipeline as jsp, tracker as jtracker
from sfm_tpu.models.mapstate import Edge as JEdge
from sfm_tpu.ops import (ba as jba, descriptors as jdesc,
                         posegraph as jpg)

from sfm_tpu_torch import config
from sfm_tpu_torch.models import scan_pipeline as sp
from sfm_tpu_torch.models.mapstate import Edge
from sfm_tpu_torch.ops import ba, descriptors, posegraph as pg, umeyama

torch.set_num_threads(1)

CHUNK, P_CAP, P_BA = 3, 4096, 256
SNAP_AFTER = 9      # frame 10 is the first revisit (of frame 4)
LONS = tuple(list(np.arange(0, 36, 5.0)) + list(np.arange(30, -1, -5.0)))


def _cfg(mod, **over):
    """The loop configuration of tests/test_scan_pipeline.py's out-and-back
    test at 320x240 (parallax gate scaled with the width), from either
    package's config module."""
    return mod.SystemConfig(
        frames=len(LONS),
        klt=mod.KLTConfig(max_tracks=512, min_tracks=300, pyr_levels=4,
                          win_radius=6, iters=16, min_distance=8),
        keyframe=mod.KeyframeConfig(min_inliers=60, min_gap=1,
                                    parallax_px=8.0),
        ransac=mod.RansacConfig(num_hypotheses=256, sampson_thresh=2e-5,
                                min_inliers=30),
        ba=mod.BAConfig(window=4, iters=3, max_points=256, global_iters=5),
        loop=mod.LoopConfig(enabled=True, min_kf_gap=6, score_thresh=0.94,
                            min_tracked=120, ransac_iters=1024,
                            ransac_thresh=2e-5, min_inliers=80,
                            device_verify=True),
        pose_graph=mod.PoseGraphConfig(mode="se3", iters=10),
        **over,
    )


@pytest.fixture(scope="module")
def out_and_back(tmp_path_factory):
    from sfm_tpu.utils.dataset import TempleRing
    from sfm_tpu.utils.synthetic import SyntheticRingSpec, generate_dataset

    out = tmp_path_factory.mktemp("torch_loop")
    spec = SyntheticRingSpec(n_frames=len(LONS), width=320, height=240,
                             fx=1100.0 * 320 / 480, fy=1100.0 * 320 / 480,
                             path_lons_deg=LONS)
    generate_dataset(out, spec)
    return TempleRing.from_dir(out)


def _leaves(c) -> dict:
    d = {k: np.asarray(getattr(c, k))
         for k in ("R_cw", "t_cw", "last_kf_frame", "kf_count", "slot_pid",
                   "fo_kf", "fo_uv", "X", "n_pts", "key")}
    d["trk"] = {k: np.asarray(v) for k, v in c.trk._asdict().items()}
    d["prev_pyr"] = [np.asarray(p) for p in c.prev_pyr]
    d["ring"] = {k: np.asarray(v) for k, v in c.ring._asdict().items()}
    return d


def _jax_carry(d: dict):
    return jsp.ScanCarry(
        trk=jtracker.TrackerState(
            **{k: jnp.asarray(v) for k, v in d["trk"].items()}),
        prev_pyr=tuple(jnp.asarray(p) for p in d["prev_pyr"]),
        ring=jsp.KeyframeRing(
            **{k: jnp.asarray(v) for k, v in d["ring"].items()}),
        **{k: jnp.asarray(d[k])
           for k in ("R_cw", "t_cw", "last_kf_frame", "kf_count",
                     "slot_pid", "fo_kf", "fo_uv", "X", "n_pts", "key")})


@pytest.fixture(scope="module")
def jax_run(out_and_back):
    """The JAX pipeline over the ring; its carry is snapshotted after frame
    ``SNAP_AFTER`` (a chunk boundary) and frame ``SNAP_AFTER + 1`` is run
    once more from the snapshot through the same compiled ``run_chunk``.
    The final state is drained for the host-side tests."""
    ds = out_and_back
    n = len(ds.records)
    cfg = _cfg(jconfig)
    s = jsp.ScanSfM(ds.K, cfg, n_frames=n, chunk=CHUNK, p_cap=P_CAP,
                    p_ba=P_BA)
    snap = None
    for i in range(n):
        s.process(i, ds.records[i].img, ds.load_gray(i))
        if i == SNAP_AFTER:
            assert not s._pending
            snap = _leaves(s.carry)
    s._flush()
    c = s.carry
    K_, T_ = c.ring.pid.shape
    drained = jsp._unpack_drain(np.asarray(jsp._drain_stage(c), np.float64),
                                K_, T_, c.ring.desc.shape[1], c.X.shape[0])
    poses = jsp._unpack_ring_poses(
        np.asarray(jsp._ring_pose_stage(c), np.float64), K_)
    s.finalize()

    k = SNAP_AFTER + 1
    g = ds.load_gray(k)
    imgs = jnp.stack([jnp.asarray(g)] + [jnp.zeros_like(g)] * (CHUNK - 1))
    idxs = np.zeros((CHUNK,), np.int32)
    idxs[0] = k
    fvalid = np.zeros((CHUNK,), bool)
    fvalid[0] = True
    _, ys = jsp.run_chunk(cfg, s.p_ba, s._Kj, _jax_carry(snap), imgs,
                          jnp.asarray(idxs), jnp.asarray(fvalid))
    _, k1, k2 = jax.random.split(jnp.asarray(snap["key"]), 3)
    shape = (cfg.ransac.num_hypotheses, cfg.klt.max_tracks)
    step = dict(leaves=snap, gray=g, y=np.asarray(ys[0], np.float64),
                pri_frame=np.asarray(jax.random.uniform(k1, shape)),
                pri_edge=np.asarray(jax.random.uniform(k2, shape)))
    return ds, s, step, drained, poses


def _torch_scan(ds, device_verify: bool):
    n = len(ds.records)
    cfg = _cfg(config)
    cfg = dataclasses.replace(cfg, loop=dataclasses.replace(
        cfg.loop, device_verify=device_verify))
    s = sp.ScanSfM(ds.K, cfg, n_frames=n, chunk=CHUNK, p_cap=P_CAP,
                   p_ba=P_BA, device="cpu")
    for i in range(n):
        s.process(i, ds.records[i].img, ds.load_gray(i))
    s.finalize()
    return ds, s


@pytest.fixture(scope="module")
def torch_run(out_and_back):
    return _torch_scan(out_and_back, device_verify=True)


# ---------------------------------------------------------------------------
# unit checks
# ---------------------------------------------------------------------------


def test_torch_score_bank_matches_jax(rng):
    """Cosine scores of one descriptor against a bank with invalid rows:
    the same matvec (float32, summation order aside) and -inf rows."""
    bank = rng.standard_normal((16, descriptors.DESC_DIM)).astype(np.float32)
    bank /= np.linalg.norm(bank, axis=1, keepdims=True)
    valid = rng.random(16) < 0.7
    d = bank[3] + 0.1 * rng.standard_normal(descriptors.DESC_DIM).astype(
        np.float32)
    ref = np.asarray(jdesc.score_bank(jnp.asarray(bank), jnp.asarray(valid),
                                      jnp.asarray(d)))
    out = descriptors.score_bank(torch.as_tensor(bank),
                                 torch.as_tensor(valid),
                                 torch.as_tensor(d)).numpy()
    assert np.isneginf(out[~valid]).all() and np.isneginf(ref[~valid]).all()
    np.testing.assert_allclose(out[valid], ref[valid], atol=1e-6)


def _random_graph(rng, N=12):
    """A noisy chain of N poses plus three loop edges (one of them to node
    0), two padding edges, half the edges with t_full set."""
    from scipy.spatial.transform import Rotation

    R = Rotation.random(N, random_state=int(rng.integers(1 << 30)))
    R = R.as_matrix()
    C = rng.standard_normal((N, 3))
    ei = np.r_[np.arange(N - 1), [0, 2, 5], [0, 0]]
    ej = np.r_[np.arange(1, N), [N - 1, N - 3, N - 2], [0, 0]]
    E = len(ei)
    noise = Rotation.from_rotvec(rng.normal(0, 0.02, (E, 3))).as_matrix()
    Rm = np.stack([R[j].T @ R[i] @ q for i, j, q in zip(ei, ej, noise)])
    tm = np.stack([R[j].T @ (C[i] - C[j]) for i, j in zip(ei, ej)])
    tm += rng.normal(0, 0.02, (E, 3))
    valid = np.ones(E, bool)
    valid[-2:] = False
    C0 = C + rng.normal(0, 0.1, (N, 3))
    w_rot = rng.uniform(0.5, 2.0, E)
    w_trans = rng.uniform(0.5, 2.0, E)
    t_full = rng.random(E) < 0.5
    s_meas = rng.uniform(0.8, 1.25, E)
    return (R, C0, ei, ej, Rm, tm, w_rot, w_trans, valid, t_full), s_meas


@pytest.mark.parametrize("solver", ["se3_dir", "se3_full", "sim3",
                                    "centers"])
def test_torch_posegraph_matches_jax(rng, solver):
    """One random float64 graph with loop edges through each solver on
    both sides.  Same residuals, exact per-edge Jacobians (forward mode on
    both sides), the same LM schedule and Cholesky solves in float64: the
    poses agree to 1e-8 (observed ~1e-14)."""
    arrays, s_meas = _random_graph(rng)
    jp = jpg.PoseGraphProblem(*(jnp.asarray(a) for a in arrays))
    tp = pg.PoseGraphProblem(*(torch.as_tensor(a) for a in arrays))
    assert tp.R_cw.dtype == torch.float64
    if solver.startswith("se3"):
        mode = solver[4:]
        rj, cj, ij = jpg.optimize_se3(jp, mode=mode, iters=10)
        rt, ct, it = pg.optimize_se3(tp, mode=mode, iters=10)
    elif solver == "sim3":
        rj, cj, sj, ij = jpg.optimize_sim3(jp, s_meas=jnp.asarray(s_meas),
                                           mode="dir", iters=10)
        rt, ct, st, it = pg.optimize_sim3(tp, s_meas=torch.as_tensor(s_meas),
                                          mode="dir", iters=10)
        np.testing.assert_allclose(st.numpy(), np.asarray(sj), atol=1e-8)
    else:
        rj, cj, ij = jpg.optimize_centers(jp)
        rt, ct, it = pg.optimize_centers(tp)
    np.testing.assert_allclose(rt.numpy(), np.asarray(rj), atol=1e-8)
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), atol=1e-8)
    if "cost" in ij:
        assert float(it["cost"]) < float(it["cost0"])
        np.testing.assert_allclose(float(it["cost"]), float(ij["cost"]),
                                   rtol=1e-8)


def test_torch_refine_points_matches_jax(rng):
    """The frozen-pose point polish on a random float32 problem (6 poses,
    300 points, 10 % of the observations masked, 5 points invalid), with
    the gather plan on both sides.  Float32, per-point 3x3 solves summed
    in another order: points agree to 1e-5 relative to their depth, the
    costs to 1e-4 relative.  A cap below the largest per-point count
    drops the observations past it on both sides, to the same result
    (it raises only under the numeric checks, tests/test_torch_debug.py)."""
    from scipy.spatial.transform import Rotation

    F, P, M = 6, 300, 1200
    R = Rotation.from_rotvec(rng.normal(0, 0.1, (F, 3))).as_matrix()
    t = rng.normal(0, 0.2, (F, 3))
    X = rng.normal(0, 1, (P, 3)) + [0, 0, 5]
    cam = rng.integers(0, F, M)
    pid = rng.integers(0, P, M)
    Xc = np.einsum("mij,mj->mi", R[cam], X[pid]) + t[cam]
    obs = Xc[:, :2] / Xc[:, 2:] + rng.normal(0, 1e-3, (M, 2))
    ov = rng.random(M) < 0.9
    pv = np.ones(P, bool)
    pv[-5:] = False
    arrays = [R.astype(np.float32), t.astype(np.float32),
              (X + rng.normal(0, 0.05, (P, 3))).astype(np.float32),
              cam.astype(np.int32), pid.astype(np.int32),
              obs.astype(np.float32), ov, pv]
    cap = int(np.bincount(pid[ov], minlength=P).max())
    Xj, ij = jba.refine_points(jba.BAProblem(*map(jnp.asarray, arrays)),
                               iters=5, max_obs_per_point=cap)
    prob = ba.BAProblem(*map(torch.as_tensor, arrays))
    Xt, it = ba.refine_points(prob, iters=5, max_obs_per_point=cap)
    np.testing.assert_allclose(Xt.numpy(), np.asarray(Xj), atol=5 * 1e-5)
    for k in ("cost0", "cost"):
        np.testing.assert_allclose(float(it[k]), float(ij[k]), rtol=1e-4)
    assert float(it["cost"]) < 0.5 * float(it["cost0"])
    # without a cap the plan takes the table's own largest count
    Xn, _ = ba.refine_points(prob, iters=5)
    assert torch.equal(Xn, Xt)
    Xj, ij = jba.refine_points(jba.BAProblem(*map(jnp.asarray, arrays)),
                               iters=5, max_obs_per_point=cap - 1)
    Xt, it = ba.refine_points(prob, iters=5, max_obs_per_point=cap - 1)
    np.testing.assert_allclose(Xt.numpy(), np.asarray(Xj), atol=5 * 1e-5)
    for k in ("cost0", "cost"):
        np.testing.assert_allclose(float(it[k]), float(ij[k]), rtol=1e-4)


# ---------------------------------------------------------------------------
# the keyframe branch with its loop verification, from a JAX carry
# ---------------------------------------------------------------------------


def test_torch_keyframe_loop_verify_from_jax_carry(jax_run):
    """Frame 10 from the JAX carry after frame 9, same RANSAC priorities:
    a keyframe whose best older keyframe (4, the same viewpoint) passes
    the gates, so both sides run the LK re-track + PnP verification.  The
    loop-verify pack agrees: the same decision and candidate, inlier and
    tracked counts within 2 %, the relative scale within 1e-3, the edge's
    rotation within 2e-3 and its translation within 2 % of the median
    keyframe step (the verified pose comes out of a twelve-step float32
    PnP on track sets that may differ by a few tracks)."""
    ds, _, st, _, _ = jax_run
    cfg = _cfg(config)
    Kt = torch.as_tensor(np.asarray(ds.K, np.float32))
    carry = sp.carry_from_numpy(st["leaves"], device="cpu")
    # the converted carry holds the stored keyframe grays
    img = st["leaves"]["ring"]["img"]
    assert img.shape[1:] == (240, 320) and img[:SNAP_AFTER + 1].any()
    np.testing.assert_array_equal(carry.ring.img.numpy(), img)
    with torch.no_grad():
        carry, y = sp.frame_step(
            cfg, P_BA, Kt, carry, torch.as_tensor(st["gray"]),
            SNAP_AFTER + 1, pri_frame=torch.as_tensor(st["pri_frame"]),
            pri_edge=torch.as_tensor(st["pri_edge"]))
    y = y.numpy().astype(np.float64)
    yj = st["y"]
    assert yj[sp.Y_KF] == 1.0 and yj[sp.Y_LV_OK] == 1.0
    for col in (sp.Y_KF, sp.Y_KFID, sp.Y_LOOP_K, sp.Y_LV_OK, sp.Y_LV_I):
        assert y[col] == yj[col], col
    assert abs(y[sp.Y_LOOP_S] - yj[sp.Y_LOOP_S]) < 1e-4
    for col in (sp.Y_LV_INL, sp.Y_LV_NTR):
        assert abs(y[col] - yj[col]) <= 0.02 * yj[col], col
    assert abs(y[sp.Y_LV_SREL] - yj[sp.Y_LV_SREL]) < 1e-3
    R, Rj = (a[sp.Y_LV_R:sp.Y_LV_R + 9] for a in (y, yj))
    np.testing.assert_allclose(R, Rj, atol=2e-3)
    ring_t = st["leaves"]["ring"]["t_cw"][:SNAP_AFTER + 1]
    step = float(np.median(np.linalg.norm(np.diff(ring_t, axis=0), axis=1)))
    t, tj = (a[sp.Y_LV_T:sp.Y_LV_T + 3] for a in (y, yj))
    assert np.linalg.norm(t - tj) < 0.02 * step
    # the keyframe's gray went into the ring
    np.testing.assert_array_equal(carry.ring.img[SNAP_AFTER + 1].numpy(),
                                  st["gray"])


# ---------------------------------------------------------------------------
# pose graph and finalize on one drained dict
# ---------------------------------------------------------------------------


def _port_edges(edges):
    return [Edge(**dataclasses.asdict(e)) for e in edges]


def test_torch_pose_graph_solve_and_gt_finalize_on_one_drain(jax_run):
    """The JAX run's final drain and ring poses, and its loop edges, given
    to ``_pose_graph_solve`` and to ``finalize(drained=..., refine=False)``
    of both packages, with use_gt_scale on.  The solve is float64 on both
    sides and returns float32 poses: they agree to 1e-6.  The finalize is
    host numpy on both sides (GT re-anchor of the trajectory, rescale of
    the edges and the map): centers, edges and points agree to 1e-9."""
    ds, sj, _, drained, poses = jax_run
    loops = [e for e in sj.edges if e.is_loop]
    assert len(loops) >= 1
    n = len(ds.records)
    kw = dict(n_frames=n, chunk=CHUNK, p_cap=P_CAP, p_ba=P_BA,
              gt_records=ds.records)
    jsf = jsp.ScanSfM(ds.K, _cfg(jconfig, use_gt_scale=True), **kw)
    tsf = sp.ScanSfM(ds.K, _cfg(config, use_gt_scale=True), device="cpu",
                     **kw)
    jsf.loop_edges = [dataclasses.replace(e) for e in loops]
    tsf.loop_edges = _port_edges(loops)
    assert all(isinstance(e, JEdge) for e in jsf.loop_edges)

    Rj, tj = jsf._pose_graph_solve(poses)
    Rt, tt = tsf._pose_graph_solve(poses)
    assert Rt.dtype == tt.dtype == np.float32
    np.testing.assert_allclose(Rt, Rj, atol=1e-6)
    np.testing.assert_allclose(tt, tj, atol=1e-6)
    n_kf = poses["n_kf"]
    assert np.abs(tt[:n_kf] - poses["t_cw"][:n_kf]).max() > 1e-5  # moved

    names = [r.img for r in ds.records]
    jsf._names, tsf._names = list(names), list(names)
    jsf.finalize(drained=drained, refine=False)
    tsf.finalize(drained=drained, refine=False)
    assert [k.frame_idx for k in tsf.kfs] == [k.frame_idx for k in jsf.kfs]
    np.testing.assert_allclose(np.stack([k.center for k in tsf.kfs]),
                               np.stack([k.center for k in jsf.kfs]),
                               atol=1e-9)
    # the re-anchor sets every keyframe baseline to its GT length
    est = np.stack([k.center for k in tsf.kfs])
    gt = np.stack([ds.records[k.frame_idx].center for k in tsf.kfs])
    np.testing.assert_allclose(np.linalg.norm(np.diff(est, axis=0), axis=1),
                               np.linalg.norm(np.diff(gt, axis=0), axis=1),
                               rtol=1e-5)
    assert len(tsf.edges) == len(jsf.edges)
    for a, b in zip(tsf.edges, jsf.edges):
        assert (a.i, a.j, a.is_loop) == (b.i, b.j, b.is_loop)
        np.testing.assert_allclose(a.t_ji, b.t_ji, atol=1e-9)
    np.testing.assert_allclose(tsf.map_xyz, jsf.map_xyz, atol=1e-9)
    est_map = tsf.map_xyz.copy()
    # with the refinement rounds (the host twins _retriangulate and
    # _refine_structure on the drained arrays; the pose graph ran, so round
    # 0 re-triangulates): the same keyframes and centers, the points within
    # the polish's tolerance of test_torch_refine_points_matches_jax
    jsf._pg_ran = tsf._pg_ran = True
    jsf.finalize(drained=drained)
    tsf.finalize(drained=drained)
    np.testing.assert_allclose(np.stack([k.center for k in tsf.kfs]),
                               np.stack([k.center for k in jsf.kfs]),
                               atol=1e-9)
    assert tsf.map_xyz.shape == jsf.map_xyz.shape
    np.testing.assert_allclose(tsf.map_xyz, jsf.map_xyz, atol=5e-5)
    assert np.abs(tsf.map_xyz - est_map).max() > 1e-4  # the rounds ran


def _drained_host_inputs(drained):
    n_kf, n_pts = (int(x) for x in drained["counts"])
    return tuple(drained[k][:n_kf] for k in ("R_cw", "t_cw", "pid", "uv",
                                               "tvalid")) + (
        drained["X"][:n_pts],)


def test_torch_host_retriangulate_matches_jax(jax_run):
    """The finalize's host DLT on the JAX run's drained arrays: the
    selection (``_retri_prep``, numpy on both sides) is identical; the
    packed DLT on its operands in float64 agrees to 1e-9 (both solve the
    same normal equations in closed form).  In float32, as finalize runs
    it, some points are so ill-conditioned (short baselines) that both
    packages land up to ~0.4 from the float64 point, each by its own
    rounding; so the port's float32 solve is held to be as accurate as
    JAX's against that float64 solve: the median, 95th percentile and
    largest error of its points within 2x of JAX's (observed: 1.13e-5
    against 9.67e-6 at the median).  ``_retriangulate`` is that solve
    gated by ``_retri_post``."""
    ds, _, _, drained, _ = jax_run
    args = _drained_host_inputs(drained)
    kw = dict(n_frames=len(ds.records), chunk=CHUNK, p_cap=P_CAP, p_ba=P_BA)
    jsf = jsp.ScanSfM(ds.K, _cfg(jconfig), **kw)
    tsf = sp.ScanSfM(ds.K, _cfg(config), device="cpu", **kw)
    ops_j, ok_j = jsf._retri_prep(*args)
    ops_t, ok_t = tsf._retri_prep(*args)
    np.testing.assert_array_equal(ok_t, ok_j)
    assert ok_t.sum() > 100
    for a, b in zip(ops_t, ops_j):
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)
    # (the JAX package runs with x64 on)
    pj = np.asarray(jsp._dlt_packed(
        *(jnp.asarray(a, jnp.float64) for a in ops_j)))
    assert pj.dtype == np.float64
    pt = sp._dlt_packed(*(torch.as_tensor(a, dtype=torch.float64)
                          for a in ops_t)).numpy()
    np.testing.assert_allclose(pt, pj, atol=1e-9, rtol=0)
    n = len(args[-1])
    pj32 = np.asarray(jsp._dlt_packed(*map(jnp.asarray, ops_j)),
                      np.float64)[:n]
    pt32 = sp._dlt_packed(*map(torch.as_tensor, ops_t)).numpy().astype(
        np.float64)[:n]
    err_t = np.linalg.norm(pt32[:, :3] - pt[:n, :3], axis=1)[ok_t]
    err_j = np.linalg.norm(pj32[:, :3] - pt[:n, :3], axis=1)[ok_t]
    for q in (50, 95, 100):
        assert np.percentile(err_t, q) <= 2 * np.percentile(err_j, q), q
    Xt = tsf._retriangulate(*args)
    np.testing.assert_array_equal(Xt, tsf._retri_post(pt32, ok_t, args[-1]))
    assert (Xt != args[-1]).any()  # points moved


def test_torch_host_refine_structure_matches_jax(jax_run):
    """The finalize's host point polish on the JAX run's drained arrays:
    the same float32 problem (``_refine_prep``: every observation, padded
    as the JAX twin pads), polished with ``refine_points`` on both sides,
    agrees to the tolerance of test_torch_refine_points_matches_jax
    (5e-5)."""
    ds, _, _, drained, _ = jax_run
    args = _drained_host_inputs(drained)
    kw = dict(n_frames=len(ds.records), chunk=CHUNK, p_cap=P_CAP, p_ba=P_BA)
    jsf = jsp.ScanSfM(ds.K, _cfg(jconfig), **kw)
    tsf = sp.ScanSfM(ds.K, _cfg(config), device="cpu", **kw)
    prob_t, m_t = tsf._refine_prep(*args)
    prob_j, m_j = jsf._refine_prep(*args)
    assert m_t == m_j > 30
    for a, b in zip(prob_t, prob_j):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    Xj = jsf._refine_structure(*args)
    Xt = tsf._refine_structure(*args)
    np.testing.assert_allclose(Xt, Xj, atol=5e-5)
    assert np.abs(Xt - args[-1]).max() > 1e-4  # the polish moved points


# ---------------------------------------------------------------------------
# loop closure end to end: both packages from the same frames
# ---------------------------------------------------------------------------


def test_torch_loop_closure_end_to_end(jax_run, torch_run):
    """Both packages over the same 15 frames with loop closure, pose graph
    and the finalize refinement on.  The port keeps the JAX run's
    keyframes and finds the same loop edges (i, j) (every return keyframe
    revisits its outbound twin); each edge's relative scale agrees within
    5e-3 (a PnP pose on track sets that may differ by a few tracks); the
    finalized centers agree within 1 % of the trajectory's extent.  And
    the bars of the JAX package's own out-and-back test: revisits within
    0.15 of each other, 0.6 < s_rel < 1.6, Sim(3) ATE under 6 % of the
    extent."""
    ds, s = torch_run
    _, sj, _, _, _ = jax_run
    assert [k.frame_idx for k in s.kfs] == [k.frame_idx for k in sj.kfs]
    loops = {(e.i, e.j): e for e in s.edges if e.is_loop}
    loops_j = {(e.i, e.j): e for e in sj.edges if e.is_loop}
    assert len(loops) >= 1 and set(loops) == set(loops_j)
    for ij, e in loops.items():
        assert abs(e.s_rel - loops_j[ij].s_rel) < 5e-3
        assert e.j - e.i >= 6
        gi = ds.records[s.kfs[e.i].frame_idx].center
        gj = ds.records[s.kfs[e.j].frame_idx].center
        assert np.linalg.norm(gi - gj) < 0.15
        assert 0.6 < e.s_rel < 1.6, e.s_rel
    assert s.pg_solves >= 1 and s._pg_ran
    assert any("loop" in m for m in s.metrics)
    est = np.stack([kf.center for kf in s.kfs])
    est_j = np.stack([kf.center for kf in sj.kfs])
    gt = np.stack([ds.records[kf.frame_idx].center for kf in s.kfs])
    extent = float(np.linalg.norm(gt - gt.mean(0), axis=1).max())
    extent_est = float(np.linalg.norm(est - est.mean(0), axis=1).max())
    assert np.linalg.norm(est - est_j, axis=1).max() < 0.01 * extent_est
    res = umeyama.ate(torch.as_tensor(est), torch.as_tensor(gt),
                      with_scale=True)
    assert float(res["rmse"]) / extent < 0.06
    assert np.isfinite(s.map_xyz).all() and len(s.map_xyz) > 200
    assert 0.8 < len(s.map_xyz) / len(sj.map_xyz) < 1.25


def test_torch_loop_closure_host_verify(jax_run, torch_run):
    """The host-driven verification (``loop.device_verify=False``: the
    chunk's candidates gated on the host, verified by LK + PnP between
    chunks) over the same frames: the keyframes and loop edges (i, j) of
    the device-verified run, and the bars of the JAX package's own test."""
    ds, s = _torch_scan(torch_run[0], device_verify=False)
    _, s_dev = torch_run
    assert s.carry.ring.img.shape[1:] == (1, 1)  # no grays in the ring
    assert [k.frame_idx for k in s.kfs] == [k.frame_idx for k in s_dev.kfs]
    loops = {(e.i, e.j): e for e in s.edges if e.is_loop}
    assert set(loops) == {(e.i, e.j) for e in s_dev.edges if e.is_loop}
    for e in loops.values():
        assert 0.6 < e.s_rel < 1.6, e.s_rel
    assert s.pg_solves >= 1 and s.loop_verifications == 0
    est = np.stack([kf.center for kf in s.kfs])
    gt = np.stack([ds.records[kf.frame_idx].center for kf in s.kfs])
    extent = float(np.linalg.norm(gt - gt.mean(0), axis=1).max())
    res = umeyama.ate(torch.as_tensor(est), torch.as_tensor(gt),
                      with_scale=True)
    assert float(res["rmse"]) / extent < 0.06


def test_torch_e_ransac_loop_verify_recovers_relative_pose(out_and_back):
    """The host path's fallback verification (taken for an old keyframe
    with fewer than 30 mapped tracks, which the runs above never meet):
    Shi-Tomasi re-detect, LK re-track and E-RANSAC on frames 3 and 5 (10
    degrees apart), through ``ScanSfM._verify_pair`` with its seeded
    generator.  It accepts the pair and recovers the ground-truth relative
    pose: rotation within 5e-3, translation direction within 1e-2 (the
    JAX package's twin lands within 2e-3 and 2.2e-3 of it on the same
    pair)."""
    ds = out_and_back
    cfg = _cfg(config)
    cfg = dataclasses.replace(cfg, loop=dataclasses.replace(
        cfg.loop, device_verify=False))
    s = sp.ScanSfM(ds.K, cfg, n_frames=len(ds.records), device="cpu")
    R, t, inliers, n_tracked = s._verify_pair(
        torch.as_tensor(np.array(ds.load_gray(3))),
        torch.as_tensor(np.array(ds.load_gray(5))))
    assert R is not None
    assert n_tracked >= cfg.loop.min_tracked
    assert inliers >= cfg.loop.min_inliers
    r3, r5 = ds.records[3], ds.records[5]
    R_ji = r5.R @ r3.R.T
    t_ji = r5.t - R_ji @ r3.t
    np.testing.assert_allclose(R, R_ji, atol=5e-3)
    np.testing.assert_allclose(t, t_ji / np.linalg.norm(t_ji), atol=1e-2)

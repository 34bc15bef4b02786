"""PyTorch port vs JAX package: loop closure, pose graph and the finalize
refinement, on the CPU: the pipeline runs.

One module-scoped JAX run and one port run of tests/test_torch_loop.py's
reduced out-and-back ring (320x240, 15 frames: out to 35 degrees and back
in 5-degree steps) at its loop configuration, in which every return
keyframe revisits an outbound one and the loop closure fires, and one
more port run with the loop verification on the host.  From the JAX run
come a carry right before the first revisit (for the keyframe branch
with its loop verification, run on both sides from that carry with the
same RANSAC priorities) and the final drain (for the pose-graph solve and
the finalize on one drained dict).
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

from sfm_tpu_torch import config
from sfm_tpu_torch.models import scan_pipeline as sp
from sfm_tpu_torch.models.mapstate import Edge
from sfm_tpu_torch.ops import umeyama
from tests.test_torch_loop import _cfg, out_and_back  # noqa: F401 (fixture)

torch.set_num_threads(1)

CHUNK, P_CAP, P_BA = 3, 4096, 256
SNAP_AFTER = 9      # frame 10 is the first revisit (of frame 4)


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

"""PyTorch port vs JAX package: the host-driven pipeline ``SfMSystem``, on
the CPU.

Two rings, each with one module-scoped JAX run and one port run
(``device="cpu"``) to which the JAX run's own RANSAC draws are handed (the
JAX system splits its key once per RANSAC call and draws
``uniform(sub, (H,N))``; ``JaxDraws`` repeats that):

* ring 1, tests/test_system.py's 8-frame 480x360 ring and ``small_cfg``,
  here: per frame the keyframe decision, inliers, tracks, map points and
  edges, then the exported artifacts and the keyframe edges against GT
  (tests/test_system.py's relative-edge check);
* ring 2, tests/test_torch_loop.py's 15-frame 320x240 out-and-back ring
  with loop closure and the pose graph on, in
  tests/test_torch_system_ring2.py: the loop edges; then the pose graph
  and the global BA over its 15 keyframes (the AoS path, F=64, P=16384),
  each run by the port on the JAX run's own pre-finalize state.  A file of
  its own: pytest-xdist's ``--dist loadfile`` hands out the files that
  collect more tests first, and two files of at most six tests start
  after the JAX package's longest file.

The ORB loop flavor on ring 2 is in tests/test_torch_system_orb.py.

Plus the loop PnP stage against JAX's, and ``_pnp_loop_edge`` against its
body as it was before its PnP part was factored out into ``_loop_pnp``.
"""

import csv

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sfm_tpu import config as jconfig
from sfm_tpu.models import scan_pipeline as jsp, system as jsystem
from sfm_tpu.ops import umeyama as jume
from sfm_tpu.utils.dataset import TempleRing
from sfm_tpu.utils.synthetic import SyntheticRingSpec, generate_dataset

from sfm_tpu_torch import config
from sfm_tpu_torch.models import scan_pipeline as sp, system
from sfm_tpu_torch.ops import epipolar, klt, pnp as pnp_ops, umeyama
from sfm_tpu_torch.ops.linalg import nanmedian

torch.set_num_threads(1)

FILES = ("keyframes_camera_centers.csv", "posegraph_edges.csv",
         "templeRing_sparse_points.ply")
LONS = tuple(list(np.arange(0, 36, 5.0)) + list(np.arange(30, -1, -5.0)))


class JaxDraws:
    """The JAX SfMSystem's RANSAC draws: one split of its key per call,
    then ``uniform(sub, (H,N), float32)``."""

    def __init__(self, seed: int):
        self.key = jax.random.PRNGKey(seed)
        self.calls = 0

    def __call__(self, H: int, N: int):
        self.key, sub = jax.random.split(self.key)
        self.calls += 1
        return np.asarray(jax.random.uniform(sub, (H, N), jnp.float32))


def small_cfg(mod):
    """tests/test_system.py's ``small_cfg``, from either config module."""
    return mod.SystemConfig(
        frames=8,
        klt=mod.KLTConfig(max_tracks=512, min_tracks=300, min_distance=8,
                          pyr_levels=3, win_radius=5, iters=10),
        ransac=mod.RansacConfig(num_hypotheses=256, sampson_thresh=2e-5,
                                min_inliers=40),
        keyframe=mod.KeyframeConfig(min_inliers=150, min_gap=1,
                                    parallax_px=6.0),
    )


def loop_cfg(mod, method="descriptor"):
    """tests/test_torch_loop.py's ``_cfg`` (loop closure, SE(3) pose graph,
    global_iters=5) with the given loop flavor, from either config
    module."""
    return mod.SystemConfig(
        frames=len(LONS),
        klt=mod.KLTConfig(max_tracks=512, min_tracks=300, pyr_levels=4,
                          win_radius=6, iters=16, min_distance=8),
        keyframe=mod.KeyframeConfig(min_inliers=60, min_gap=1,
                                    parallax_px=8.0),
        ransac=mod.RansacConfig(num_hypotheses=256, sampson_thresh=2e-5,
                                min_inliers=30),
        ba=mod.BAConfig(window=4, iters=3, max_points=256, global_iters=5),
        loop=mod.LoopConfig(enabled=True, method=method, min_kf_gap=6,
                            score_thresh=0.94, min_tracked=120,
                            ransac_iters=1024, ransac_thresh=2e-5,
                            min_inliers=80, device_verify=True),
        pose_graph=mod.PoseGraphConfig(mode="se3", iters=10),
    )


def _run(s, ds, finalize=True):
    for i in range(len(ds)):
        s.process(i, ds.records[i].img, ds.load_gray(i))
    if finalize:
        s.finalize()
    return s


@pytest.fixture(scope="module")
def ring1(tmp_path_factory):
    out = tmp_path_factory.mktemp("sys_ring1")
    generate_dataset(out, SyntheticRingSpec(
        n_frames=8, width=480, height=360, fx=1100.0, fy=1100.0,
        arc_deg=40.0))
    ds = TempleRing.from_dir(out)
    sj = _run(jsystem.SfMSystem(ds.K, small_cfg(jconfig),
                                gt_records=ds.records), ds)
    st = system.SfMSystem(ds.K, small_cfg(config), gt_records=ds.records,
                          device="cpu")
    st._pri_source = draws = JaxDraws(st.cfg.ransac.seed)
    _run(st, ds)
    return ds, sj, st, draws


def ring2_dataset(out):
    """Ring 2: tests/test_torch_loop.py's out-and-back ring, under out."""
    generate_dataset(out, SyntheticRingSpec(
        n_frames=len(LONS), width=320, height=240, fx=1100.0 * 320 / 480,
        fy=1100.0 * 320 / 480, path_lons_deg=LONS))
    return TempleRing.from_dir(out)


# ---------------------------------------------------------------------------
# ring 1: frame by frame, then the exports and the edges
# ---------------------------------------------------------------------------


def test_torch_system_frames_match_jax(ring1):
    """Per frame: the same keyframe decision and edge count, and inliers,
    tracks and map points within 2 % of JAX's (the tracker agrees with
    JAX up to border-LK and corner-tie tracks, ROADMAP Queue 3, and one
    track more or less changes what is triangulated).  The port drew one
    (H,N) sample per RANSAC call, as JAX did: two per frame after the
    first (frame two-view + keyframe edge)."""
    ds, sj, st, draws = ring1
    assert len(sj.metrics) == len(st.metrics) == len(ds)
    for a, b in zip(sj.metrics, st.metrics):
        assert a["keyframe"] == b["keyframe"], (a, b)
        assert a.get("edges") == b.get("edges"), (a, b)
        for k in ("inliers", "tracks", "map_points"):
            if a.get(k) is not None:
                assert abs(a[k] - b[k]) <= 0.02 * a[k], (k, a, b)
    n_kf = sum(m["keyframe"] for m in sj.metrics)
    assert draws.calls == (len(ds) - 1) + (n_kf - 1)
    assert len(st.kfs) == len(sj.kfs) >= 4
    assert st.map.num_obs >= 2 * st.map.num_points > 200


def _csv(path):
    with open(path) as f:
        return list(csv.reader(f))


def test_torch_system_exports_match_jax(ring1, tmp_path):
    """The same three files with the same CSV headers and row kinds;
    keyframe centres within 1e-3 of the trajectory's extent after the
    global BA; exported (culled) point count within 2 % of JAX's."""
    ds, sj, st, _ = ring1
    ij = sj.export(tmp_path / "jax", dataset=ds)
    it = st.export(tmp_path / "port", dataset=ds)
    for f in FILES:
        assert (tmp_path / "port" / f).exists(), f
    assert sorted(p.name for p in (tmp_path / "port").iterdir()) == \
        sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert {k: ij[k] for k in ("keyframes", "edges")} == \
        {k: it[k] for k in ("keyframes", "edges")}
    for f in FILES[:2]:
        a, b = _csv(tmp_path / "jax" / f), _csv(tmp_path / "port" / f)
        assert a[0] == b[0] and len(a) == len(b), f
    ej, et = (_csv(tmp_path / d / FILES[1]) for d in ("jax", "port"))
    kind = ej[0].index("kind")
    assert [r[kind] for r in ej] == [r[kind] for r in et]
    Cj = np.stack([k.center for k in sj.kfs])
    Ct = np.stack([k.center for k in st.kfs])
    extent = float(np.linalg.norm(Cj - Cj.mean(0), axis=1).max())
    assert float(np.abs(Cj - Ct).max()) <= 1e-3 * extent
    nj = ij["map_points"] - ij["culled"]
    nt = it["map_points"] - it["culled"]
    assert abs(nj - nt) <= 0.02 * nj


def _edges_and_gt(ds, s):
    """A system's keyframe edges (R_ji, t_ji) and the GT relative poses of
    the same keyframes' frames, stacked, float64 (tests/test_system.py:
    71-89)."""
    R, t, R_gt, t_gt = [], [], [], []
    for e in s.edges:
        ri = ds.records[s.kfs[e.i].frame_idx]
        rj = ds.records[s.kfs[e.j].frame_idx]
        Rg = rj.R @ ri.R.T
        R.append(e.R_ji)
        t.append(e.t_ji)
        R_gt.append(Rg)
        t_gt.append(rj.t - Rg @ ri.t)
    return [np.stack(a).astype(np.float64) for a in (R, t, R_gt, t_gt)]


def test_torch_system_edges_vs_gt(ring1):
    """tests/test_system.py's relative-edge check on the port's run: the
    port's ``edge_errors`` of its keyframe edges against GT, medians under
    JAX's bars (rotation 2.0 degrees, direction 4.0 degrees); and, on the
    same edges in float64, equal to JAX's ``edge_errors`` within 1e-6
    degrees (arccos near 1 turns an ulp of its argument into sqrt(2 ulp)
    = 1.5e-8 rad = 8.5e-7 degrees; elsewhere the two agree to ~1e-13)."""
    ds, _, st, _ = ring1
    assert len(st.edges) == len(st.kfs) - 1 >= 3
    arrays = _edges_and_gt(ds, st)
    rot, dirn = (a.numpy() for a in umeyama.edge_errors(
        *(torch.as_tensor(a) for a in arrays)))
    assert rot.dtype == dirn.dtype == np.float64
    assert np.median(rot) < 2.0, rot
    assert np.median(dirn) < 4.0, dirn
    rot_j, dir_j = jax.jit(jume.edge_errors)(*map(jnp.asarray, arrays))
    np.testing.assert_allclose(rot, np.asarray(rot_j), rtol=0, atol=1e-6)
    np.testing.assert_allclose(dirn, np.asarray(dir_j), rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# loop PnP: the host pipeline's stage and the factored-out PnP part
# ---------------------------------------------------------------------------


def _pnp_inputs(ring1):
    """Keyframe 0's mapped tracks re-tracked into keyframe 2 of the port's
    ring-1 run: the inputs of ``_loop_pnp_stage``."""
    ds, _, st, _ = ring1
    old, new = st.kfs[0], st.kfs[2]
    pids = st.map.pids_for(old.ids)
    m_old = old.valid & (pids >= 0)
    X_slot = np.zeros((len(pids), 3), np.float32)
    X_slot[m_old] = st.map.xyz()[pids[m_old]]
    R_wc0, t_wc0 = old.pose_wc
    return (st, ds.load_gray(old.frame_idx), ds.load_gray(new.frame_idx),
            old.uv.astype(np.float32), X_slot, m_old,
            R_wc0.astype(np.float32), t_wc0.astype(np.float32))


def test_torch_loop_pnp_stage_matches_jax(ring1):
    """``_loop_pnp_stage`` (what ``SfMSystem._try_loop_pnp`` runs) against
    JAX's on the same inputs: pose within 1e-4, inlier and tracked counts
    within 1 % or one track (LK on border tracks, ROADMAP Queue 3)."""
    st, g0, g1, uv, X, m, R0, t0 = _pnp_inputs(ring1)
    kc = st.cfg.klt
    hd = st.cfg.ba.huber_delta / float(st.K[0, 0])
    args = dict(levels=kc.pyr_levels, lk_iters=kc.iters,
                radius=kc.win_radius, fb_thresh=kc.fb_thresh,
                huber_delta=hd)
    pj = np.asarray(jsp._loop_pnp_stage(
        jnp.asarray(st.K, jnp.float32), jnp.asarray(g0, jnp.float32),
        jnp.asarray(g1, jnp.float32), jnp.asarray(uv), jnp.asarray(X),
        jnp.asarray(m), jnp.asarray(R0), jnp.asarray(t0), **args))
    t = torch.as_tensor
    pt = sp._loop_pnp_stage(
        st._Kt, t(g0).float(), t(g1).float(), t(uv), t(X), t(m), t(R0),
        t(t0), **args).numpy()
    assert pj.shape == pt.shape == (15,)
    np.testing.assert_allclose(pt[:12], pj[:12], atol=1e-4)
    assert pj[13] > 50 and abs(pt[13] - pj[13]) <= max(1, 0.01 * pj[13])
    assert pj[12] >= 30 and abs(pt[12] - pj[12]) <= max(1, 0.01 * pj[12])


def _pnp_loop_edge_before(kcfg, Kf, ring, X, pyr_old, pyr_new, cand_kf,
                          cur_kf, huber_delta):
    """``scan_pipeline._pnp_loop_edge`` as it read before its LK + PnP part
    moved into ``_loop_pnp`` (the reference for bit-for-bit equality)."""
    f32 = torch.float32
    P_CAP = X.shape[0]
    pid_old = ring.pid[cand_kf]
    m_old = ring.tvalid[cand_kf] & (pid_old >= 0)
    X_old = X[torch.clamp(pid_old, 0, P_CAP - 1).long()]
    R_cw_o, C_o = ring.R_cw[cand_kf], ring.t_cw[cand_kf]
    R_wc0, t_wc0 = sp._wc(R_cw_o, C_o)
    new_pts, ok = klt.lk_track_fb(
        pyr_old, pyr_new, ring.uv[cand_kf], m_old, levels=kcfg.pyr_levels,
        iters=kcfg.iters, radius=kcfg.win_radius, fb_thresh=kcfg.fb_thresh,
        device=X.device)
    xj = epipolar.normalize_by_K(Kf, new_pts.to(f32))
    use = ok & m_old
    Rv, tv, info = pnp_ops.refine_pose(R_wc0, t_wc0, X_old, xj, use,
                                       iters=12, huber_delta=huber_delta)
    R_ji = Rv @ R_cw_o
    t_ji = Rv @ C_o + tv
    d_i = (X_old @ Rv.T + tv)[:, 2]
    ok_i = m_old & (d_i > 1e-9)
    pid_j = ring.pid[cur_kf]
    m_j = ring.tvalid[cur_kf] & (pid_j >= 0)
    X_j = X[torch.clamp(pid_j, 0, P_CAP - 1).long()]
    d_j = ((X_j - ring.t_cw[cur_kf]) @ ring.R_cw[cur_kf])[:, 2]
    ok_j = m_j & (d_j > 1e-9)
    med_i = nanmedian(sp._nan_where(ok_i, d_i))
    med_j = nanmedian(sp._nan_where(ok_j, d_j))
    s_ok = ((torch.sum(ok_i) >= 20) & (torch.sum(ok_j) >= 20)
            & (med_i > 1e-12))
    s_rel = torch.nan_to_num(
        torch.where(s_ok, med_j / torch.clamp(med_i, min=1e-12),
                    torch.ones_like(med_i)), nan=1.0)
    return torch.cat([
        R_ji.reshape(9).to(f32), t_ji.to(f32),
        torch.stack([info["inliers"].to(f32), torch.sum(use).to(f32),
                     s_rel.to(f32), torch.sum(m_old).to(f32)]),
    ])


def test_torch_pnp_loop_edge_unchanged_by_factoring(ring1):
    """``_pnp_loop_edge`` returns, bit for bit, what its body returned
    before the factoring, on a two-row ring made from the port's ring-1
    run (keyframe 0 -> keyframe 2)."""
    st, g0, g1, *_ = _pnp_inputs(ring1)
    old, new = st.kfs[0], st.kfs[2]
    T = len(old.ids)
    ring = sp._empty_ring(2, T, torch.device("cpu"))
    for r, kf in enumerate((old, new)):
        ring.R_cw[r] = torch.as_tensor(kf.R_cw, dtype=torch.float32)
        ring.t_cw[r] = torch.as_tensor(kf.t_cw, dtype=torch.float32)
        ring.uv[r] = torch.as_tensor(kf.uv, dtype=torch.float32)
        ring.ids[r] = torch.as_tensor(kf.ids, dtype=torch.int32)
        ring.tvalid[r] = torch.as_tensor(kf.valid)
        ring.pid[r] = torch.as_tensor(st.map.pids_for(kf.ids),
                                      dtype=torch.int32)
    X = torch.as_tensor(st.map.xyz(), dtype=torch.float32)
    kc = st.cfg.klt
    pyr = [sp._build_pyr(torch.as_tensor(g).float(), kc.pyr_levels)
           for g in (g0, g1)]
    hd = st.cfg.ba.huber_delta / st._Kt[0, 0]
    now = sp._pnp_loop_edge(kc, st._Kt, ring, X, *pyr, 0, 1, hd)
    before = _pnp_loop_edge_before(kc, st._Kt, ring, X, *pyr, 0, 1, hd)
    assert torch.equal(now, before)
    assert float(now[13]) > 50  # a real verification, not an empty one

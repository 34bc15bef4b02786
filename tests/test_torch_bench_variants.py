"""PyTorch port vs JAX package: what bench.py's other configurations run
that the 47-frame ring does not, on the CPU.

- The keyframe gate's skip branch and the keyframe branch's own edge
  LO-RANSAC (the non-reuse arm: the previous keyframe is not the previous
  frame), on a 14-frame 320x240 ring whose steps alternate a large one
  (the gate keyframes) and a small one (the gate skips), as
  bench_dense_variant's 94-frame ring does at full size: one JAX and one
  port ``ScanSfM`` run with JAX's draws.
- The keyframe branch with ``use_gt_scale`` (bench_gtscale_se3), one frame
  from the JAX run's carry at a keyframe whose previous keyframe is two
  frames back.
- bench_hyp4096's pair stage (pyramid, forward-backward LK at 2 levels,
  LO-RANSAC over 4096 hypotheses) with JAX's draws.
- The renders of bench_stock_thresholds' structured texture and of
  explicit camera paths (``path_lons_deg``), and the stock-gate ring's
  path of ``chip_smoke.py`` against bench_dense_variant's arithmetic.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sfm_tpu import config as jconfig
from sfm_tpu.models import scan_pipeline as jsp
from sfm_tpu.utils import synthetic as jsyn

import chip_smoke as cs
from sfm_tpu_torch import config
from sfm_tpu_torch.models import scan_pipeline as sp
from sfm_tpu_torch.utils import synthetic as tsyn
from tests.test_torch_pipeline import _leaves
from tests.test_torch_pipeline_run import _jax_carry
from tools import jax_draws

torch.set_num_threads(1)

# steps alternate large (the gate keyframes: per-frame median flow over
# PARALLAX_PX) and small (under it: skipped), large first, so that the
# keyframes are the odd frames and each one's previous keyframe is two
# frames back
LARGE_DEG, SMALL_DEG, N_FRAMES, PARALLAX_PX = 6.0, 2.0, 14, 8.0
CHUNK, P_CAP, P_BA = 2, 4096, 256
# the JAX run's carry is kept after each of these skipped frames (chunk
# boundaries); the next frame keyframes, two frames after its previous
# keyframe
SNAPS = (2, 4, 6, 8, 10, 12)
SNAP_GT = 4  # the one the gt-scale step starts from


def _lons():
    steps = ([LARGE_DEG, SMALL_DEG] * N_FRAMES)[:N_FRAMES - 1]
    return tuple(np.concatenate([[0.0], np.cumsum(steps)]))


def _cfg(mod, **over):
    """tests/test_torch_pipeline.py's small configuration at the gate of
    this ring, from either package's config module."""
    return mod.SystemConfig(
        frames=N_FRAMES,
        klt=mod.KLTConfig(max_tracks=512, min_tracks=300, pyr_levels=4,
                          win_radius=6, iters=16, min_distance=8),
        keyframe=mod.KeyframeConfig(min_inliers=60, min_gap=1,
                                    parallax_px=PARALLAX_PX),
        ransac=mod.RansacConfig(num_hypotheses=256, sampson_thresh=2e-5,
                                min_inliers=30),
        ba=mod.BAConfig(window=4, iters=3, max_points=256, global_iters=0),
        loop=mod.LoopConfig(enabled=False),
        **over,
    )


@pytest.fixture(scope="module")
def ring(tmp_path_factory):
    from sfm_tpu.utils.dataset import TempleRing

    out = tmp_path_factory.mktemp("stockgate_ring")
    # tests/test_torch_loop.py's camera and texture on this path
    spec = jsyn.SyntheticRingSpec(
        n_frames=N_FRAMES, width=320, height=240, fx=1100.0 * 320 / 480,
        fy=1100.0 * 320 / 480, path_lons_deg=_lons())
    jsyn.generate_dataset(out, spec)
    return TempleRing.from_dir(out)


@pytest.fixture(scope="module")
def jax_run(ring):
    """The JAX pipeline over the ring, its carry snapshotted after each
    frame of SNAPS."""
    s = jsp.ScanSfM(ring.K, _cfg(jconfig), n_frames=N_FRAMES, chunk=CHUNK,
                    p_cap=P_CAP, p_ba=P_BA)
    snaps = {}
    for i in range(N_FRAMES):
        s.process(i, ring.records[i].img, ring.load_gray(i))
        if i in SNAPS:
            assert not s._pending
            snaps[i] = _leaves(s.carry)
    s.finalize()
    return s, snaps


def _step_both(ring, leaves, k: int, **over):
    """Frame k + 1 from the JAX carry ``leaves`` through both packages
    (``_cfg(**over)``, JAX's draws): (JAX's metrics row and carry leaves,
    the port's)."""
    gt = np.stack([r.center for r in ring.records]).astype(np.float32)
    g = ring.load_gray(k + 1)
    imgs = jnp.stack([jnp.asarray(g)] + [jnp.zeros_like(g)] * (CHUNK - 1))
    idxs = np.zeros((CHUNK,), np.int32)
    idxs[0] = k + 1
    carry_j, ys = jsp.run_chunk(
        _cfg(jconfig, **over), P_BA, jnp.asarray(ring.K, jnp.float32),
        _jax_carry(leaves), imgs, jnp.asarray(idxs),
        jnp.asarray(np.arange(CHUNK) == 0), gt_C=jnp.asarray(gt))
    _, k1, k2 = jax.random.split(jnp.asarray(leaves["key"]), 3)
    shape = (256, 512)
    with torch.no_grad():
        carry, y = sp.frame_step(
            _cfg(config, **over), P_BA,
            torch.as_tensor(np.asarray(ring.K, np.float32)),
            sp.carry_from_numpy(leaves, device="cpu"),
            torch.as_tensor(np.array(g)), k + 1,
            pri_frame=torch.as_tensor(np.array(
                jax.random.uniform(k1, shape, jnp.float32))),
            pri_edge=torch.as_tensor(np.array(
                jax.random.uniform(k2, shape, jnp.float32))),
            gt_C=torch.as_tensor(gt))
    return ((np.asarray(ys[0], np.float64), _leaves(carry_j)),
            (y.numpy().astype(np.float64), sp.carry_to_numpy(carry)))


@pytest.fixture(scope="module")
def torch_run(ring):
    """The port's run with the JAX run's draws, counting the keyframe
    branch's own edge LO-RANSACs (the branch called without the frame's
    two-view result)."""
    cfg = _cfg(config)
    s = sp.ScanSfM(ring.K, cfg, n_frames=N_FRAMES, chunk=CHUNK, p_cap=P_CAP,
                   p_ba=P_BA, device="cpu")
    s._pri_source = jax_draws.scan_draws(
        cfg.ransac.seed, cfg.ransac.num_hypotheses, cfg.klt.max_tracks)
    branch, edge_runs = sp._keyframe_branch, []

    def counted(*a, rp_frame=None, **k):
        edge_runs.append(rp_frame is None)
        return branch(*a, rp_frame=rp_frame, **k)

    sp._keyframe_branch = counted
    try:
        with torch.no_grad():
            for i in range(N_FRAMES):
                s.process(i, ring.records[i].img, ring.load_gray(i))
            s.finalize()
    finally:
        sp._keyframe_branch = branch
    return s, sum(edge_runs)


def test_torch_stock_gate_skips_as_jax(jax_run, torch_run):
    """Under the same draws the port keyframes on JAX's frames, and the
    gate skips at least a third of them; the keyframe branch's own edge
    LO-RANSAC ran on >= 3 keyframes on both sides (JAX runs it wherever
    the previous keyframe is not the previous frame; the port's count is
    its calls of the branch without the frame's two-view result), so the
    comparison is not vacuous."""
    sj, _ = jax_run
    s, port_edge_runs = torch_run
    kf_j = [kf.frame_idx for kf in sj.kfs]
    assert [kf.frame_idx for kf in s.kfs] == kf_j
    cad = cs.keyframe_cadence(kf_j, N_FRAMES)
    assert cad["skipped_frames"] >= N_FRAMES // 3
    assert cad["edge_ransac_runs"] >= 3 and port_edge_runs >= 3
    assert port_edge_runs >= cad["edge_ransac_runs"]
    assert len(s.edges) == len(sj.edges) == len(s.kfs) - 1


def test_torch_stock_gate_keyframe_steps_match_jax(ring, jax_run,
                                                   torch_run):
    """Each keyframe of the ring whose previous keyframe is two frames back
    (frames 3, 5, ..., 13), one frame from the JAX run's carry after the
    skipped frame before it, on both sides with JAX's draws: the branch's
    own edge LO-RANSAC and what follows hold to the bars of one frame of
    tests/test_torch_pipeline_run.py (the same decisions; rotation within
    2e-3; the centre, the edge and the propagated scale within 2 % of the
    step's baseline; inlier counts within 2 % or 2).  A whole run is not
    held so: over a run the propagated scale of one keyframe moves with a
    point more or less (here by up to 6 %), though each step agrees.
    Beside it, the port's whole run meets the accuracy bar of
    tests/test_torch_pipeline_run.py (Sim(3) ATE under 5 % of the
    trajectory's extent) and its map is within 2 % of JAX's in size."""
    from sfm_tpu_torch.ops import umeyama

    sj, snaps = jax_run
    for k in SNAPS:
        (yj, want), (y, got) = _step_both(ring, snaps[k], k)
        for col in (sp.Y_KF, sp.Y_OK, sp.Y_KFID):
            assert y[col] == yj[col], (k, col)
        assert yj[sp.Y_KF] == 1.0
        for col in (sp.Y_INL, sp.Y_EDGE_INL, sp.Y_PNP_INL, sp.Y_NEW_PTS):
            assert abs(y[col] - yj[col]) <= max(0.02 * yj[col], 2), (k, col)
        kf = int(want["kf_count"]) - 1
        rt, rj = got["ring"], want["ring"]
        base = float(np.linalg.norm(rj["t_cw"][kf] - rj["t_cw"][kf - 1]))
        assert abs(y[sp.Y_SCALE] - yj[sp.Y_SCALE]) < 0.02 * yj[sp.Y_SCALE]
        np.testing.assert_allclose(got["R_cw"], want["R_cw"], atol=2e-3)
        assert np.linalg.norm(got["t_cw"] - want["t_cw"]) < 0.02 * base, k
        np.testing.assert_allclose(rt["e_Rji"][kf], rj["e_Rji"][kf],
                                   atol=2e-3)
        assert np.linalg.norm(rt["e_tji"][kf] - rj["e_tji"][kf]) < 0.02 * (
            np.linalg.norm(rj["e_tji"][kf])), k
    s, _ = torch_run
    est = np.stack([kf.center for kf in s.kfs])
    gt = np.stack([ring.records[kf.frame_idx].center for kf in s.kfs])
    res = umeyama.ate(torch.as_tensor(est), torch.as_tensor(gt),
                      with_scale=True)
    extent = float(np.linalg.norm(gt - gt.mean(0), axis=1).max())
    assert float(res["rmse"]) < 0.05 * extent
    assert abs(len(s.map_xyz) - len(sj.map_xyz)) <= 0.02 * len(sj.map_xyz)


def test_torch_gtscale_edge_from_jax_carry(ring, jax_run):
    """Frame SNAP_GT + 1 from the JAX carry after frame SNAP_GT (a skipped
    frame) with ``use_gt_scale`` on both sides and JAX's draws: a
    keyframe whose previous keyframe is two frames back, so the branch
    solves its own edge LO-RANSAC; its scale is the GT baseline (exact:
    within 1e-6 relative), and the edge, the pose and the ring as one
    frame of tests/test_torch_pipeline_run.py (rotation within 2e-3,
    position within 2 % of the step's baseline, inlier counts within 2 %
    or 2)."""
    _, snaps = jax_run
    k = SNAP_GT
    leaves = snaps[k]
    assert int(leaves["last_kf_frame"]) == k - 1
    (yj, want), (y, got) = _step_both(ring, leaves, k, use_gt_scale=True)
    gt = np.stack([r.center for r in ring.records]).astype(np.float32)
    assert y[sp.Y_KF] == yj[sp.Y_KF] == 1.0
    assert y[sp.Y_KFID] == yj[sp.Y_KFID]
    s_gt = float(np.linalg.norm(gt[k + 1] - gt[k - 1]))
    np.testing.assert_allclose([y[sp.Y_SCALE], yj[sp.Y_SCALE]], s_gt,
                               rtol=1e-6)
    for col in (sp.Y_INL, sp.Y_EDGE_INL, sp.Y_PNP_INL, sp.Y_NEW_PTS):
        assert abs(y[col] - yj[col]) <= max(0.02 * yj[col], 2), col
    kf = int(want["kf_count"]) - 1
    assert int(got["kf_count"]) == kf + 1
    rt, rj = got["ring"], want["ring"]
    np.testing.assert_array_equal(rt["frame"], rj["frame"])
    np.testing.assert_allclose(rt["e_Rji"][kf], rj["e_Rji"][kf], atol=2e-3)
    np.testing.assert_allclose(rt["e_tji"][kf], rj["e_tji"][kf],
                               atol=0.02 * s_gt)
    np.testing.assert_allclose(got["R_cw"], want["R_cw"], atol=2e-3)
    assert np.linalg.norm(got["t_cw"] - want["t_cw"]) < 0.02 * s_gt
    np.testing.assert_allclose(rt["R_cw"], rj["R_cw"], atol=2e-3)
    assert np.abs(rt["t_cw"] - rj["t_cw"]).max() < 0.02 * s_gt


def test_torch_hyp4096_pair_stage_matches_jax(ring):
    """bench_hyp4096's pair stage at T=256 on frames 0 and 1 of the ring
    (2 pyramid levels, 16 LK iterations, radius 6, FB 1.0; 4096
    hypotheses, Sampson 2e-5, 30 inliers), JAX's draws on both sides: the
    same inlier count, R and t within 1e-4."""
    from sfm_tpu.models.system import build_pyramid_u8 as jpyr
    from sfm_tpu.ops import epipolar as jep, klt as jklt

    from sfm_tpu_torch.models.system import build_pyramid_u8
    from sfm_tpu_torch.ops import epipolar, klt

    T, L, H = 256, 2, 4096
    rng = np.random.default_rng(0)
    pos = rng.uniform([20, 20], [300, 220], (T, 2)).astype(np.float32)
    g0, g1 = ring.load_gray(0), ring.load_gray(1)
    key = jax.random.PRNGKey(0)
    Kj = jnp.asarray(ring.K, jnp.float32)

    @jax.jit
    def pair(im0, im1, p):
        q, ok = jklt.lk_track_fb(jpyr(im0, L), jpyr(im1, L), p,
                                 jnp.ones(T, bool), levels=L, iters=16,
                                 radius=6, fb_thresh=1.0)
        rp = jep.find_E_ransac(key, jep.normalize_by_K(Kj, p),
                               jep.normalize_by_K(Kj, q), ok,
                               num_hypotheses=H, sampson_thresh=2e-5,
                               min_inliers=30)
        return rp.R, rp.t, rp.num_inliers, ok

    Rj, tj, nj, okj = (np.asarray(a) for a in pair(
        jnp.asarray(g0), jnp.asarray(g1), jnp.asarray(pos)))
    Kt = torch.as_tensor(np.asarray(ring.K, np.float32))
    p = torch.as_tensor(pos)
    with torch.no_grad():
        q, ok = klt.lk_track_fb(
            build_pyramid_u8(torch.as_tensor(g0), L),
            build_pyramid_u8(torch.as_tensor(g1), L), p,
            torch.ones(T, dtype=torch.bool), levels=L, iters=16, radius=6,
            fb_thresh=1.0, device="cpu")
        rp = epipolar.find_E_ransac(
            None, epipolar.normalize_by_K(Kt, p),
            epipolar.normalize_by_K(Kt, q), ok, num_hypotheses=H,
            sampson_thresh=2e-5, min_inliers=30,
            pri=jax_draws.uniform(jax_draws.key(0), (H, T)))
    assert int(nj) >= 30 and bool(rp.ok)
    np.testing.assert_array_equal(ok.numpy(), okj)
    assert int(rp.num_inliers) == int(nj)
    np.testing.assert_allclose(rp.R.numpy(), Rj, atol=1e-4)
    np.testing.assert_allclose(rp.t.numpy(), tj, atol=1e-4)


def test_torch_variant_rings_render_as_jax(tmp_path):
    """The port's renderer gives the JAX package's images and GT bit for
    bit on the structured texture with an explicit camera path
    (bench_stock_thresholds' ring at 320x240 over its first 3 cameras)
    and on the stock-gate ring of chip_smoke.py with its steps in either
    phase (first 2 cameras at full size); and chip_smoke.stockgate_lons
    is bench_dense_variant's path, bit for bit its arithmetic."""
    from sfm_tpu.utils.dataset import TempleRing

    n_frames, a = 94, 2.4  # bench.py bench_dense_variant's lines
    n_inc = n_frames - 1
    n_large = n_inc // 2
    n_small = n_inc - n_large
    b = (360.0 - n_small * a) / n_large
    pattern = ([a, b] * ((n_inc + 1) // 2))[:n_inc]
    lons = np.concatenate([[0.0], np.cumsum(pattern)])
    np.testing.assert_array_equal(cs.stockgate_lons(), lons)
    other = cs.stockgate_lons(large_first=True)
    assert other[-1] == pytest.approx(360.0, abs=1e-9)
    assert np.allclose(np.diff(other)[1::2], a)

    structured = dataclasses.replace(
        cs.structured_spec(), n_frames=3, width=320, height=240,
        fx=760.0, fy=760.0,
        path_lons_deg=cs.structured_spec().path_lons_deg[:3])
    for name, spec in (("structured", structured),):
        for pkg, gen in (("j", jsyn), ("t", tsyn)):
            gen.generate_dataset(
                tmp_path / f"{name}_{pkg}",
                getattr(gen, "SyntheticRingSpec")(
                    **dataclasses.asdict(spec)))
        dj = TempleRing.from_dir(tmp_path / f"{name}_j")
        dt = TempleRing.from_dir(tmp_path / f"{name}_t")
        pars = [next((tmp_path / f"{name}_{pkg}").glob("*_par.txt"))
                for pkg in "jt"]
        assert pars[0].read_text() == pars[1].read_text()
        for i in range(len(dj.records)):
            np.testing.assert_array_equal(dt.load_gray(i), dj.load_gray(i))
    for large_first in (False, True):
        spec = cs.stockgate_spec(large_first=large_first,
                                 seed=8 if large_first else None)
        jspec = jsyn.SyntheticRingSpec(**dataclasses.asdict(spec))
        Kt, Rt, tt, Ct, _ = tsyn.make_ring_cameras(spec)
        Kj, Rj, tj, Cj, _ = jsyn.make_ring_cameras(jspec)
        np.testing.assert_array_equal(np.stack(Ct), np.stack(Cj))
        tex_t, tex_j = tsyn._make_texture(spec), jsyn._make_texture(jspec)
        np.testing.assert_array_equal(tex_t, tex_j)
        for i in (0, 1):
            np.testing.assert_array_equal(
                tsyn.render_frame(spec, Kt, Rt[i], tt[i], tex_t),
                jsyn.render_frame(jspec, Kj, Rj[i], tj[i], tex_j))

"""Tests of the PyTorch/CUDA port that need a CUDA device (a CUDA kernel
has no CPU mode).  Marked ``gpu``; each skips without a card.

This file imports neither ``jax`` nor anything of the JAX package, so it
runs on a machine that has only torch and the CUDA toolkit:

    python -m pytest tests/test_torch_card.py -m gpu --noconftest -q

(``--noconftest`` keeps tests/conftest.py, which imports jax, from loading;
the ``rng`` fixture and ``make_textured`` are this file's own copies.)
"""

import numpy as np
import pytest
import torch

from sfm_tpu_torch.ops import ba
from sfm_tpu_torch.ops.kernels import lk_kernels, shi_tomasi_kernel


@pytest.fixture()
def rng():
    # function-scoped so every test sees the same deterministic stream
    # regardless of execution order
    return np.random.default_rng(0)


def make_textured(rng, H=128, W=256):
    from scipy.ndimage import gaussian_filter

    return (gaussian_filter(rng.standard_normal((H, W)), 2.0) * 60
            + 128).astype(np.float32)


@pytest.mark.gpu
def test_torch_kernels_match_plain_on_card(rng):
    """The five CUDA kernels against their plain versions on the card
    (``python3 chip_smoke.py`` runs the same comparison at full size)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    dev = torch.device("cuda")
    a = torch.as_tensor(make_textured(rng, 120, 160), device=dev)
    b = torch.roll(a, (2, -3), (0, 1)).contiguous()
    # K1 bit for bit at every radius the port uses and the ends of its
    # range, on whole and partial 32x32 tiles
    for img in (a, torch.as_tensor(make_textured(rng, 61, 83), device=dev)):
        for r in (1, 2, 3, 8):
            out = shi_tomasi_kernel.shi_tomasi_score(img, r)
            ref = shi_tomasi_kernel.shi_tomasi_score_plain(img, r)
            assert torch.equal(out, ref), (tuple(img.shape), r)
    pts = torch.as_tensor(rng.uniform(30, [130, 90], (100, 2)),
                          dtype=torch.float32, device=dev)
    v0 = torch.zeros_like(pts)
    # K5 and K2 bit for bit, garbage starts included, at the widths of LK
    # radius 1, 3, 6 and 10 and at one width outside the compiled set
    st = torch.as_tensor(rng.integers(-40, 200, (100, 2)),
                         dtype=torch.int32, device=dev)
    st[0] = torch.tensor([-2**31, 2**31 - 1], dtype=torch.int32)
    m = lk_kernels.MARGIN
    for w0, w1 in ((6, 6 + 2 * m), (10, 10 + 2 * m), (16, 16 + 2 * m),
                   (24, 24 + 2 * m), (17, 17 + 2 * m)):
        for w in (w0, w1):
            assert torch.equal(lk_kernels.lk_gather(b, st, w),
                               lk_kernels.lk_gather_plain(b, st, w)), w
        got = lk_kernels.lk_gather_pair(a, st, w0, b, st.flip(0), w1)
        want = lk_kernels.lk_gather_pair_plain(a, st, w0, b, st.flip(0), w1)
        assert all(torch.equal(x, y) for x, y in zip(got, want)), (w0, w1)
    # K3, and K4 on K5's windows, at the default config's radius (P = 11)
    # and the bench's (P = 13)
    for radius in (5, 6):
        P = 2 * radius + 1
        out = lk_kernels.lk_level_fused(a, b, pts, v0, 8, radius, 1e-4)
        ref = lk_kernels.lk_level_plain(a, b, pts, v0, 8, radius, 1e-4)
        assert float((out - ref).abs().max()) <= 1e-4, radius
        o0 = pts - radius
        blk0, a0 = lk_kernels._load_blocks(a, o0, P, 0, lk_kernels.lk_gather)
        tmpl = lk_kernels.template_patch(blk0, a0, o0, P)
        blk1, a1 = lk_kernels._load_blocks(b, o0, P, lk_kernels.MARGIN,
                                           lk_kernels.lk_gather)
        out = lk_kernels.lk_level_tmpl(blk1, tmpl, o0 - a1, v0, 8, 1e-4)
        ref = lk_kernels.lk_level_tmpl_plain(blk1, tmpl, o0 - a1, v0, 8,
                                             1e-4)
        assert float((out - ref).abs().max()) <= 1e-4, radius


@pytest.mark.gpu
def test_torch_bundle_adjust_aos_on_card_matches_cpu():
    """The AoS bundle adjustment (F*P > 8192, the global final BA) on the
    card against itself on the CPU, float64, F=9 poses, P=1024 points:
    the same LM history (cost0, then the cost after each step) to 1e-9
    relative, the cost falling by over 10x, and poses and
    points to 1e-9 (both sides sum the blocks in the fixed order of the
    sort-based plan; what differs is the order inside the library's
    matmuls and reductions, at float64 rounding).  The plan makes the card
    run bit-reproducible: a second run on the card gives the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    g = np.random.default_rng(3)
    F, P, M = 9, 1024, 4096
    X = g.standard_normal((P, 3)) * [0.5, 0.5, 0.3] + [0.0, 0.0, 4.0]
    ang = 0.08 * (np.arange(F) - F / 2)
    c, s = np.cos(ang), np.sin(ang)
    R = np.zeros((F, 3, 3))
    R[:, 0, 0], R[:, 0, 2], R[:, 1, 1] = c, s, 1.0
    R[:, 2, 0], R[:, 2, 2] = -s, c
    C = np.stack([4.0 * s, 0.1 * np.arange(F), 4.0 - 4.0 * c], -1)
    t = -np.einsum("fij,fj->fi", R, C)
    cam = g.integers(0, F, M)
    pid = g.integers(0, P, M)
    Xc = np.einsum("mij,mj->mi", R[cam], X[pid]) + t[cam]
    obs = Xc[:, :2] / Xc[:, 2:3] + g.standard_normal((M, 2)) * 1e-4
    leaves = dict(
        R_wc=R, t_wc=t + g.standard_normal((F, 3)) * 0.01,
        X=X + g.standard_normal((P, 3)) * 0.01, cam_idx=cam, pid_idx=pid,
        obs=obs, obs_valid=g.random(M) < 0.95,
        point_valid=g.random(P) < 0.97)

    def run(dev):
        p = ba.BAProblem(**{k: torch.as_tensor(v, device=dev)
                            for k, v in leaves.items()})
        assert p.X.dtype == torch.float64
        with torch.no_grad():
            out = ba.bundle_adjust(p, iters=10, huber_delta=2e-3)
        return [x.cpu() for x in out[:3]] + [
            torch.cat([out[3]["cost0"][None], out[3]["cost_hist"]]).cpu()]

    Rc, tc, Xc_, hc = run("cpu")
    Rg, tg, Xg, hg = run("cuda")
    np.testing.assert_allclose(hg.numpy(), hc.numpy(), rtol=1e-9)
    assert float(hg[-1]) < 0.1 * float(hg[0])  # cost0 -> final cost
    for a, b in ((Rg, Rc), (tg, tc), (Xg, Xc_)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-9)
    again = run("cuda")
    assert all(torch.equal(a, b) for a, b in zip(again, (Rg, tg, Xg, hg)))


@pytest.mark.gpu
def test_torch_scene_batched_kernels_match_single_launches(rng):
    """K1 and K3 with a scene axis (S=3) on the card: one launch over the
    stack gives the bits of one launch per scene (NaN flows included, as
    bit patterns), and each scene's result meets its plain version's rule
    (K1 bit for bit; K3 within 1e-4 px on tracks away from the border, as
    in test_torch_kernels_match_plain_on_card).  ``chip_smoke.py`` runs
    the same comparison at the multi-scene runner's shapes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    dev = torch.device("cuda")
    S = 3
    a = torch.stack([torch.as_tensor(make_textured(rng, 120, 160),
                                     device=dev) for _ in range(S)])
    b = torch.stack([torch.roll(x, (2, -s), (0, 1))
                     for s, x in enumerate(a)]).contiguous()
    for r in (2, 3):
        out = shi_tomasi_kernel.shi_tomasi_score(a, r)
        for s in range(S):
            assert torch.equal(out[s],
                               shi_tomasi_kernel.shi_tomasi_score(a[s], r))
            assert torch.equal(
                out[s], shi_tomasi_kernel.shi_tomasi_score_plain(a[s], r))
    pts = torch.as_tensor(rng.uniform(30, [130, 90], (S, 100, 2)),
                          dtype=torch.float32, device=dev)
    pts[1, :5] = float("nan")
    v0 = torch.zeros_like(pts)
    n = lk_kernels.level_launches
    out = lk_kernels.lk_level_fused(a, b, pts, v0, 8, 6, 1e-4)
    assert lk_kernels.level_launches == n + 1
    for s in range(S):
        one = lk_kernels.lk_level_fused(a[s], b[s], pts[s], v0[s], 8, 6,
                                        1e-4)
        assert torch.equal(out[s].view(torch.int32), one.view(torch.int32))
        ref = lk_kernels.lk_level_plain(a[s], b[s], pts[s], v0[s], 8, 6,
                                        1e-4)
        ok = torch.isfinite(pts[s]).all(-1)
        assert float((out[s] - ref)[ok].abs().max()) <= 1e-4, s


def _bits(t):
    """A float32 tensor's bit patterns (NaN flows compare equal)."""
    return t.contiguous().view(torch.int32)


@pytest.mark.gpu
def test_torch_lk_bf16_kernels_are_f32_on_rounded_images(rng):
    """K3, K4, K5 and K2 on bfloat16 storage (SFM_TPU_LK_BF16=1) launch
    their bfloat16 instantiations and give, bit for bit, their float32
    launches on the same images rounded to bfloat16 (the kernels convert
    each pixel exactly as they stage it); a float16 image, or a pair of
    mixed dtypes, raises TypeError.  ``python3 chip_smoke.py`` also holds
    them to their bfloat16 plain versions at full size."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    dev = torch.device("cuda")
    bf = torch.bfloat16
    a = torch.as_tensor(make_textured(rng, 120, 160), device=dev)
    b = torch.roll(a, (2, -3), (0, 1)).contiguous()
    a16, b16 = a.to(bf), b.to(bf)
    ar, br = a16.float(), b16.float()  # the rounded images in float32
    pts = torch.as_tensor(rng.uniform(0, [159, 119], (100, 2)),
                          dtype=torch.float32, device=dev)
    pts[:4] = float("nan")
    v0 = torch.as_tensor(rng.uniform(-2, 2, (100, 2)), dtype=torch.float32,
                         device=dev)
    n16 = lk_kernels.bf16_launches
    # K3
    for radius in (5, 6, 12):
        out = lk_kernels.lk_level_fused(a16, b16, pts, v0, 8, radius, 1e-4)
        ref = lk_kernels.lk_level_fused(ar, br, pts, v0, 8, radius, 1e-4)
        assert torch.equal(_bits(out), _bits(ref)), radius
    # K5 and K2 at the LK widths and one outside the compiled set
    st = torch.as_tensor(rng.integers(-40, 200, (100, 2)), dtype=torch.int32,
                         device=dev)
    st[0] = torch.tensor([-2**31, 2**31 - 1], dtype=torch.int32)
    m = lk_kernels.MARGIN
    for w0, w1 in ((6, 6 + 2 * m), (16, 16 + 2 * m), (17, 17 + 2 * m)):
        for w in (w0, w1):
            got = lk_kernels.lk_gather(b16, st, w)
            assert got.dtype == bf
            assert torch.equal(got.float(), lk_kernels.lk_gather(br, st, w))
            assert torch.equal(got, lk_kernels.lk_gather_plain(b16, st, w))
        got = lk_kernels.lk_gather_pair(a16, st, w0, b16, st.flip(0), w1)
        want = lk_kernels.lk_gather_pair(ar, st, w0, br, st.flip(0), w1)
        assert all(x.dtype == bf and torch.equal(x.float(), y)
                   for x, y in zip(got, want)), (w0, w1)
    # K4 on bfloat16 windows with the float32 template
    for radius in (5, 6):
        P = 2 * radius + 1
        o0 = pts - radius
        blk0, a0 = lk_kernels._load_blocks(a16, o0, P, 0, lk_kernels.lk_gather)
        tmpl = lk_kernels.template_patch(blk0, a0, o0, P)
        assert tmpl.dtype == torch.float32
        blk1, a1 = lk_kernels._load_blocks(b16, o0 + v0, P, m,
                                           lk_kernels.lk_gather)
        out = lk_kernels.lk_level_tmpl(blk1, tmpl, o0 - a1, v0, 8, 1e-4)
        ref = lk_kernels.lk_level_tmpl(blk1.float(), tmpl, o0 - a1, v0, 8,
                                       1e-4)
        assert torch.equal(_bits(out), _bits(ref)), radius
    # 3 K3 + 3 x (2 K5 + 1 K2) + 2 x (2 K5 + 1 K4)
    assert lk_kernels.bf16_launches - n16 == 3 + 9 + 6
    # no other storage, and no mixed pair
    h = a.half()
    for call in (
            lambda: lk_kernels.lk_gather(h, st, 16),
            lambda: lk_kernels.lk_gather(a.double(), st, 16),
            lambda: lk_kernels.lk_gather_pair(h, st, 16, b.half(), st, 28),
            lambda: lk_kernels.lk_level_fused(h, b.half(), pts, v0, 8, 6,
                                              1e-4),
            lambda: lk_kernels.lk_level_fused(a16, br, pts, v0, 8, 6, 1e-4),
            lambda: lk_kernels.lk_level_tmpl(blk1.half(), tmpl, o0 - a1, v0,
                                             8, 1e-4)):
        with pytest.raises(TypeError):
            call()


@pytest.mark.gpu
def test_torch_lk_k4_k5_scene_stack_match_single_launches(rng):
    """K5 and K4 with a scene axis (S=3), on float32 and on bfloat16
    storage: one launch over the stack gives the bits of one launch per
    scene (NaN flows included), each scene's windows clamped against its
    own image; the stacked K5 is its plain version bit for bit.
    ``python3 chip_smoke.py`` holds the same at the multi-scene runner's
    shapes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    dev = torch.device("cuda")
    S, T, radius = 3, 100, 6
    P = 2 * radius + 1
    m = lk_kernels.MARGIN
    a = torch.stack([torch.as_tensor(make_textured(rng, 120, 160),
                                     device=dev) for _ in range(S)])
    b = torch.stack([torch.roll(x, (2, -s), (0, 1))
                     for s, x in enumerate(a)]).contiguous()
    pts = torch.as_tensor(rng.uniform(0, [159, 119], (S, T, 2)),
                          dtype=torch.float32, device=dev)
    pts[1, :5] = float("nan")
    v0 = torch.as_tensor(rng.uniform(-2, 2, (S, T, 2)), dtype=torch.float32,
                         device=dev)
    for dt in (torch.float32, torch.bfloat16):
        a_, b_ = a.to(dt), b.to(dt)
        n5, n4 = lk_kernels.gather1_launches, lk_kernels.tmpl_launches
        o0 = pts - radius
        blk0, a0 = lk_kernels._load_blocks(a_, o0, P, 0, lk_kernels.lk_gather)
        blk1, a1 = lk_kernels._load_blocks(b_, o0 + v0, P, m,
                                           lk_kernels.lk_gather)
        tmpl = lk_kernels.template_patch(blk0, a0, o0, P)
        out = lk_kernels.lk_level_tmpl(blk1, tmpl, o0 - a1, v0, 8, 1e-4)
        assert (lk_kernels.gather1_launches - n5,
                lk_kernels.tmpl_launches - n4) == (2, 1)
        assert blk1.shape == (S, T, P + 2 * m + 3, P + 2 * m + 3)
        assert out.shape == (S, T, 2)
        starts = lk_kernels.window_start(o0 + v0, m + 1, 120, 160,
                                         P + 2 * m + 3).to(torch.int32)
        assert torch.equal(blk1, lk_kernels.lk_gather_plain(
            b_, starts, P + 2 * m + 3))
        for s in range(S):
            one = lk_kernels.lk_gather(b_[s], starts[s], P + 2 * m + 3)
            assert torch.equal(blk1[s], one), (dt, s)
            res = lk_kernels.lk_level_tmpl(blk1[s], tmpl[s], (o0 - a1)[s],
                                           v0[s], 8, 1e-4)
            assert torch.equal(_bits(out[s]), _bits(res)), (dt, s)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("arm", ["tmpl", "unfused"])
def test_torch_lk_track_fb_stacked_arms_match_per_scene_on_card(
        rng, monkeypatch, arm, dtype):
    """``klt.lk_track_fb`` on a scene stack (S=3, 90 tracks a scene: the
    stacked table is no whole number of 4-track rows per scene) on the
    card under arm (b) (SFM_TPU_LK_FUSED_TMPL=0: K5 + K4) and arm (c)
    (SFM_TPU_LK_FUSED=0: K5 + the plain loop), float32 and bfloat16
    storage: flows and masks bit for bit the per-scene calls, with the
    stack served by one K5 launch per window set (and one K4 launch) per
    level and direction."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from sfm_tpu_torch.ops import image as im, klt

    monkeypatch.setenv("SFM_TPU_LK_FUSED", "1" if arm == "tmpl" else "0")
    monkeypatch.setenv("SFM_TPU_LK_FUSED_TMPL", "0")
    monkeypatch.setenv("SFM_TPU_LK_BF16", "1" if dtype == "bf16" else "0")
    dev = torch.device("cuda")
    S, T, levels = 3, 90, 3
    a = torch.stack([torch.as_tensor(make_textured(rng, 120, 160),
                                     device=dev) for _ in range(S)])
    b = torch.stack([torch.roll(x, (2 - s, s - 3), (0, 1))
                     for s, x in enumerate(a)])
    pyr0 = tuple(torch.stack(x) for x in zip(
        *(im.build_pyramid(x, levels) for x in a)))
    pyr1 = tuple(torch.stack(x) for x in zip(
        *(im.build_pyramid(x, levels) for x in b)))
    pts = torch.as_tensor(rng.uniform(0, [159, 119], (S, T, 2)),
                          dtype=torch.float32, device=dev)
    valid = torch.as_tensor(rng.random((S, T)) < 0.9, device=dev)
    n5, n4 = lk_kernels.gather1_launches, lk_kernels.tmpl_launches
    new, ok = klt.lk_track_fb(pyr0, pyr1, pts, valid, levels, 8, 4,
                              device=dev)
    assert lk_kernels.gather1_launches - n5 == 2 * levels * 2
    assert lk_kernels.tmpl_launches - n4 == (levels * 2 if arm == "tmpl"
                                             else 0)
    assert ok.float().mean() > 0.5
    for s in range(S):
        ns, oks = klt.lk_track_fb(tuple(p[s] for p in pyr0),
                                  tuple(p[s] for p in pyr1), pts[s],
                                  valid[s], levels, 8, 4, device=dev)
        assert torch.equal(_bits(new[s]), _bits(ns)), s
        assert torch.equal(ok[s], oks), s


@pytest.mark.gpu
def test_torch_disparity_on_card_matches_cpu(rng):
    """The stereo matcher (models.mesh._disparity_sad, plain PyTorch) on a
    96x128 fronto-parallel pair at disparity 6, 16 disparities, radius 3,
    SGM on: the card against the CPU, to the shares of
    tests/test_torch_mesh.py (lr_ok equal on >= 99 % of the pixels, the
    integer disparity on >= 99 % of those both keep, |delta| <= 0.05 px at
    the 99th percentile).  ``python3 chip_smoke.py`` runs the same
    comparison at 640x480 with 128 disparities."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from sfm_tpu_torch.models import mesh

    img = make_textured(rng, 96, 160)
    left = torch.as_tensor(img[:, 16:144].copy())
    right = torch.as_tensor(img[:, 22:150].copy())
    dc, oc = mesh._disparity_sad(left, right, 16, 3)
    dg, og = mesh._disparity_sad(left.cuda(), right.cuda(), 16, 3)
    dc, oc, dg, og = dc.numpy(), oc.numpy(), dg.cpu().numpy(), og.cpu().numpy()
    assert (oc == og).mean() >= 0.99
    both = oc & og
    same = (np.rint(dc) == np.rint(dg)) | (np.abs(dc - dg) <= 1e-3)
    assert same[both].mean() >= 0.99
    assert np.percentile(np.abs(dc - dg)[both], 99) <= 0.05


def _scene_step_rank(d: dict) -> dict:
    """Rank 0 of a one-rank NCCL group: ``make_scene_step`` on two scenes,
    and the same stages called on the same tensors without the group.
    Returns, per output, whether the two agree bit for bit."""
    from sfm_tpu_torch.config import KLTConfig
    from sfm_tpu_torch.models import tracker
    from sfm_tpu_torch.ops import epipolar
    from sfm_tpu_torch.parallel import mesh as mesh_lib, multiscene

    m = mesh_lib.make_mesh(1, device="cuda")
    dev = mesh_lib.rank_device(m, "cuda")
    cuda = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    kcfg = KLTConfig(max_tracks=d["pos"].shape[1], min_tracks=8,
                     pyr_levels=2, win_radius=3, iters=6)
    pyr0 = tuple(map(cuda, d["pyr0"]))
    pyr1 = tuple(map(cuda, d["pyr1"]))
    S, T = d["pos"].shape[:2]
    state = tracker.TrackerState(
        pos=cuda(d["pos"]), valid=torch.ones((S, T), dtype=torch.bool,
                                             device=dev),
        ids=torch.arange(T, dtype=torch.int32, device=dev).repeat(S, 1),
        next_id=torch.full((S,), T, dtype=torch.int32, device=dev))
    prob = ba.BAProblem(**{k: cuda(v) for k, v in d["prob"].items()})
    K, pri = cuda(d["K"]), cuda(d["pri"])
    step = multiscene.make_scene_step(m, kcfg, num_hypotheses=pri.shape[1])
    with torch.no_grad():
        new_state, rp, ba_out, metrics = step(pri, K, pyr0, pyr1, state,
                                              prob)
        new, ok = multiscene.batched_lk(pyr0, pyr1, state.pos, state.valid,
                                        2, 6, 3, device=dev)
        matched = state.valid & ok
        rp1 = multiscene.batched_two_view(
            pri, epipolar.normalize_by_K(K, state.pos),
            epipolar.normalize_by_K(K, new), matched,
            num_hypotheses=pri.shape[1], min_inliers=8)
        ba1 = multiscene.batched_ba_step(prob, iters=2)
    out = {"valid": torch.equal(new_state.valid, matched),
           "pos": torch.equal(new_state.pos[matched], new[matched]),
           "tracks_alive": int(metrics["tracks_alive"]) == int(matched.sum()),
           "inliers": int(metrics["inliers"]) == int(rp1.num_inliers.sum()),
           "ba_cost": torch.equal(metrics["ba_cost"], ba1[3]["cost"].sum())}
    for k, v in rp._asdict().items():
        out[f"rp.{k}"] = torch.equal(v, getattr(rp1, k))
    for k, a, b in zip(("R_wc", "t_wc", "X"), ba_out, ba1[:3]):
        out[k] = torch.equal(a, b)
    out["on_card"] = new_state.pos.is_cuda and rp.R.is_cuda
    return out


@pytest.mark.gpu
def test_torch_scene_step_nccl_one_rank_matches_stages(rng):
    """``parallel.multiscene.make_scene_step`` in a one-rank NCCL group on
    cuda:0 (started by ``distributed.launch``), two scenes of 64 tracks on
    96x128 textures shifted by (1, 2) px, with given draws: the new track
    table, every ``RelPose`` field, the BA outputs and the three metrics
    all-reduced over the ``scene`` group are bit for bit those of the same
    stages (``batched_lk``, ``batched_two_view``, ``batched_ba_step``)
    called without a group."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from sfm_tpu_torch.parallel import distributed

    S, T, P, M = 2, 64, 16, 64
    imgs = np.stack([make_textured(rng, 96, 128) for _ in range(S)])
    moved = np.roll(imgs, (1, 2), axis=(1, 2))
    t_wc = np.zeros((S, 2, 3), np.float32)
    t_wc[:, 1, 0] = 0.5
    d = dict(
        pyr0=(imgs, np.ascontiguousarray(imgs[:, ::2, ::2])),
        pyr1=(moved, np.ascontiguousarray(moved[:, ::2, ::2])),
        pos=rng.uniform(10, 80, (S, T, 2)).astype(np.float32),
        K=np.array([[100.0, 0, 64], [0, 100.0, 48], [0, 0, 1]], np.float32),
        pri=rng.random((S, 64, T)).astype(np.float32),
        prob=dict(
            R_wc=np.tile(np.eye(3, dtype=np.float32), (S, 2, 1, 1)),
            t_wc=t_wc,
            X=(rng.standard_normal((S, P, 3)) * 0.3
               + [0, 0, 4.0]).astype(np.float32),
            cam_idx=np.tile(np.arange(M, dtype=np.int32) % 2, (S, 1)),
            pid_idx=np.tile(np.arange(M, dtype=np.int32) % P, (S, 1)),
            obs=np.zeros((S, M, 2), np.float32),
            obs_valid=np.ones((S, M), bool),
            point_valid=np.ones((S, P), bool)))
    (out,) = distributed.launch(_scene_step_rank, 1, (d,), device="cuda",
                                timeout_s=300.0)
    assert all(out.values()), {k: v for k, v in out.items() if not v}

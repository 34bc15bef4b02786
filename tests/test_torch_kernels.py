"""PyTorch port vs JAX package: the modules that hold a CUDA kernel
(corner response, LK level, tracker), on the CPU.

On the CPU a kernel wrapper takes its plain PyTorch version, so these tests
hold the plain versions (the arithmetic the CUDA kernels repeat) to the JAX
functions on the same numpy inputs.  Where the JAX function reaches a Pallas
kernel it runs in interpret mode, as tests/test_pallas_kernels.py runs it.
The kernels themselves are held to the plain versions on the card by
``chip_smoke.py`` and by tests/test_torch_card.py (marked ``gpu``, free of
JAX so that it runs on the card's machine).
"""

import importlib.util
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sfm_tpu.config import KLTConfig as JKLTConfig
from sfm_tpu.models import tracker as jtracker
from sfm_tpu.ops import features as jfeatures, image as jim, klt as jklt
from sfm_tpu.ops.pallas import shi_tomasi_kernel as jst

from sfm_tpu_torch.config import KLTConfig
from sfm_tpu_torch.models import tracker
from sfm_tpu_torch.ops import features, image as im, klt
from sfm_tpu_torch.ops.kernels import lk_kernels, shi_tomasi_kernel

torch.set_num_threads(1)


def make_textured(rng, H=128, W=256):
    from scipy.ndimage import gaussian_filter

    return (gaussian_filter(rng.standard_normal((H, W)), 2.0) * 60
            + 128).astype(np.float32)


def t32(a):
    return torch.as_tensor(np.asarray(a, np.float32))


# ---------------------------------------------------------------------------
# image primitives
# ---------------------------------------------------------------------------


def test_torch_pyramid_and_gradients_match_jax(rng):
    """Exact: 2x2 means and central differences are the same few float32
    operations on both sides (sum of four, times 0.25; difference, times
    0.5)."""
    a = make_textured(rng, 120, 160)
    pj = jim.build_pyramid(jnp.asarray(a), 4)
    pt = im.build_pyramid(t32(a), 4)
    for x, y in zip(pj, pt):
        # atol 2e-5: a mean of four values near 128 may round its sum in
        # another order (1 ulp of 512 is 6e-5, a quarter of it survives)
        np.testing.assert_allclose(y.numpy(), np.asarray(x), atol=2e-5)
    gxj, gyj = jim.gradients(jnp.asarray(a))
    gxt, gyt = im.gradients(t32(a))
    np.testing.assert_array_equal(gxt.numpy(), np.asarray(gxj))
    np.testing.assert_array_equal(gyt.numpy(), np.asarray(gyj))


@pytest.mark.parametrize("radius", [1, 2, 3])
def test_torch_box_filter_matches_jax(rng, radius):
    """The port's direct box sum against the JAX one and the float64 truth.
    Tolerance against JAX: its cumulative-sum form carries an absolute
    error of eps_f32 times the running sum (up to H*W/16 * max value
    here), whatever the order the scan adds in; the direct form is held to
    the float64 truth much tighter."""
    a = np.abs(make_textured(rng, 96, 128)) * 10.0
    ref = np.asarray(jim.box_filter(jnp.asarray(a), radius))
    out = im.box_filter(t32(a), radius).numpy()
    k = 2 * radius + 1
    truth = np.zeros_like(a, dtype=np.float64)
    pad = np.pad(a.astype(np.float64), radius)
    for dy in range(k):
        for dx in range(k):
            truth += pad[dy:dy + a.shape[0], dx:dx + a.shape[1]]
    run_max = float(np.cumsum(np.cumsum(a.astype(np.float64), 0), 1).max())
    np.testing.assert_allclose(out, ref,
                               atol=4 * np.finfo(np.float32).eps * run_max)
    np.testing.assert_allclose(out, truth, rtol=1e-6)


# ---------------------------------------------------------------------------
# K1: corner response
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("radius", [2, 3])
def test_torch_shi_tomasi_matches_jax_whole_map(rng, radius):
    """Plain version vs features.shi_tomasi_score on the WHOLE map (same
    border semantics: zero gradient on the border, zero-padded box sum).
    Tolerance: the JAX box sums are cumulative-sum differences in float32,
    whose absolute error is eps times the running sum of squared gradients
    over the image; the response inherits it once per structure-tensor
    entry.  The port's direct sums are exact to 1e-7 relative."""
    a = make_textured(rng, 120, 160)
    ref = np.asarray(jfeatures.shi_tomasi_score(jnp.asarray(a), radius))
    out = features.shi_tomasi_score(t32(a), radius).numpy()
    gx, gy = np.gradient(a.astype(np.float64))
    run_max = float((gx ** 2 + gy ** 2).sum())
    atol = 8 * np.finfo(np.float32).eps * run_max
    assert atol < 0.02 * ref.max()  # the bound still means something
    np.testing.assert_allclose(out, ref, atol=atol)
    # and the float64 truth of the same formula, tightly
    a64 = torch.as_tensor(a, dtype=torch.float64)
    truth = shi_tomasi_kernel.shi_tomasi_score_plain(a64, radius).numpy()
    np.testing.assert_allclose(out, truth, rtol=2e-5, atol=1e-3)


def test_torch_shi_tomasi_matches_pallas_interior(rng):
    """Plain version vs the TPU kernel in interpret mode on the interior
    (the TPU kernel wraps around at the border, the port does not).  Both
    sum directly, so the tolerance is the one the JAX package holds its
    kernel to (rtol 1e-4, atol 1e-3)."""
    a = make_textured(rng)
    ref = np.asarray(jst.shi_tomasi_score_pallas(jnp.asarray(a),
                                                 block_radius=2,
                                                 interpret=True))
    out = features.shi_tomasi_score(t32(a), 2).numpy()
    b = 4
    np.testing.assert_allclose(out[b:-b, b:-b], ref[b:-b, b:-b], rtol=1e-4,
                               atol=1e-3)


def test_torch_shi_tomasi_dispatch_cpu_takes_plain(rng):
    """A CPU tensor goes to the plain version and counts no launch."""
    a = t32(make_textured(rng, 64, 64))
    before = shi_tomasi_kernel.launches
    out = shi_tomasi_kernel.shi_tomasi_score(a, 3)
    assert shi_tomasi_kernel.launches == before
    assert torch.equal(out, shi_tomasi_kernel.shi_tomasi_score_plain(a, 3))


def test_torch_detect_corners_matches_jax(rng):
    """Same corners as the JAX detector: the response maps agree to
    ~1e-6 relative, so a cell's argmax or the global ranking flips only on
    a near-tie.  Bar: at least 98 % of the JAX corners are found at the
    identical pixel, and validity counts agree within 1 %."""
    a = make_textured(rng, 240, 320)
    ex = rng.uniform(20, [300, 220], (40, 2)).astype(np.float32)
    ev = rng.random(40) < 0.7
    xy_j, sc_j, v_j = jfeatures.detect_corners(
        jnp.asarray(a), jnp.asarray(ex), jnp.asarray(ev), max_new=300,
        cell=8, quality=0.01, block_radius=3)
    xy_t, sc_t, v_t = features.detect_corners(
        t32(a), t32(ex), torch.as_tensor(ev), max_new=300, cell=8,
        quality=0.01, block_radius=3, device="cpu")
    xy_j, v_j = np.asarray(xy_j), np.asarray(v_j)
    xy_t, v_t = xy_t.numpy(), v_t.numpy()
    assert xy_t.shape == xy_j.shape and v_t.dtype == bool
    assert abs(int(v_t.sum()) - int(v_j.sum())) <= 0.01 * v_j.sum()
    set_j = {tuple(p) for p in xy_j[v_j]}
    set_t = {tuple(p) for p in xy_t[v_t]}
    assert len(set_j & set_t) >= 0.98 * len(set_j)
    # no corner in a cell an existing track occupies
    cells = {(int(x // 8), int(y // 8)) for x, y in ex[ev]}
    assert not any((int(x // 8), int(y // 8)) in cells for x, y in xy_t[v_t])


# ---------------------------------------------------------------------------
# K2 / K3: LK window gather and level
# ---------------------------------------------------------------------------


def test_torch_lk_gather_pair_is_slicing(rng):
    """The gather's plain version returns exactly the requested windows,
    with starts clamped into the image (dead tracks carry garbage)."""
    a = rng.standard_normal((60, 80)).astype(np.float32)
    b = rng.standard_normal((60, 80)).astype(np.float32)
    T = 50
    s0 = np.stack([rng.integers(-30, 110, T), rng.integers(-30, 90, T)], -1)
    s1 = np.stack([rng.integers(-30, 110, T), rng.integers(-30, 90, T)], -1)
    s0[0] = [-2**31, 2**31 - 1]
    o0, o1 = lk_kernels.lk_gather_pair(
        t32(a), torch.as_tensor(s0.astype(np.int32)), 16,
        t32(b), torch.as_tensor(s1.astype(np.int32)), 28)
    assert o0.shape == (T, 16, 16) and o1.shape == (T, 28, 28)
    for t in range(T):
        x0, y0 = np.clip(s0[t, 0], 0, 80 - 16), np.clip(s0[t, 1], 0, 60 - 16)
        x1, y1 = np.clip(s1[t, 0], 0, 80 - 28), np.clip(s1[t, 1], 0, 60 - 28)
        np.testing.assert_array_equal(o0[t].numpy(),
                                      a[y0:y0 + 16, x0:x0 + 16])
        np.testing.assert_array_equal(o1[t].numpy(),
                                      b[y1:y1 + 28, x1:x1 + 28])


def _lk_case(rng, T=150, border=False):
    img0 = make_textured(rng, 120, 160)
    img1 = np.roll(img0, (2, -3), axis=(0, 1))
    pts = rng.uniform(20, [140, 100], (T, 2)).astype(np.float32)
    if border:  # tracks within the search window of every border
        nb = T // 5
        pts[:nb, 0] = rng.uniform(0, 12, nb)
        pts[nb:2 * nb, 0] = rng.uniform(147, 159, nb)
        pts[2 * nb:3 * nb, 1] = rng.uniform(0, 12, nb)
        pts[3 * nb:4 * nb, 1] = rng.uniform(107, 119, nb)
    v0 = rng.uniform(-2, 2, (T, 2)).astype(np.float32)
    return img0, img1, pts, v0


# (SFM_TPU_PALLAS, SFM_TPU_LK_FUSED, SFM_TPU_LK_FUSED_TMPL) of each arm;
# the port reads the last two at call time and takes the same arm
ARMS = {
    "xla": ("0", "0", "0"),       # JAX: XLA loop; port: arm (c)
    "fused": ("1", "1", "1"),     # pair gather + lk_iter_tmpl; port: K3
    "tmpl": ("1", "1", "0"),      # load_blocks + lk_iter; port: K5 + K4
    "unfused": ("1", "0", "0"),   # load_blocks + XLA loop; port: K5 + loop
}


def _set_arm(monkeypatch, arm: str):
    for name, val in zip(("SFM_TPU_PALLAS", "SFM_TPU_LK_FUSED",
                          "SFM_TPU_LK_FUSED_TMPL"), ARMS[arm]):
        monkeypatch.setenv(name, val)


def _jax_lk_level(monkeypatch, img0, img1, pts, v0, pallas,
                  iters=8, radius=6):
    """klt._lk_level of the JAX package on the arm ``pallas`` names (a bool
    picks "fused" or "xla"), Pallas kernels in interpret mode.  The arm's
    switches stay set for the port's call that follows."""
    arm = pallas if isinstance(pallas, str) else (
        "fused" if pallas else "xla")
    _set_arm(monkeypatch, arm)
    jax.clear_caches()
    return np.asarray(jklt._lk_level(
        jnp.asarray(img0), jnp.asarray(img1), jnp.asarray(pts),
        jnp.asarray(v0), iters, radius, 1e-4))


@pytest.mark.parametrize("pallas", [False, True, "tmpl", "unfused"],
                         ids=["xla_path", "fused_pallas_interpret",
                              "tmpl_pallas_interpret",
                              "unfused_pallas_interpret"])
def test_torch_lk_level_matches_jax(rng, monkeypatch, pallas):
    """Port's LK level vs klt._lk_level on each arm, with the same switches
    on both sides: the XLA path; the fused Pallas path (pair gather +
    in-kernel template); the template-passed-in path
    (SFM_TPU_LK_FUSED_TMPL=0: one-image gathers + lk_iter_pallas, the
    port's K5 + K4); the unfused path (SFM_TPU_LK_FUSED=0: one-image
    gathers + the loop outside any kernel).  Pallas in interpret mode.
    Same bar as the JAX package holds its own fused kernel to: atol 1e-4 px
    on every track, median under 1e-5 — window starts, clamp bounds and
    fractions are identical, only the order of the P*P sums differs."""
    img0, img1, pts, v0 = _lk_case(rng)
    ref = _jax_lk_level(monkeypatch, img0, img1, pts, v0, pallas)
    out = klt._lk_level(t32(img0), t32(img1), t32(pts), t32(v0), 8, 6,
                        1e-4).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-4)
    assert np.median(np.abs(out - ref)) < 1e-5
    # the tracks did move towards the true shift (-3, +2)
    assert np.median(np.abs(out - np.array([-3.0, 2.0]))) < 0.05


@pytest.mark.parametrize("pallas", [False, True],
                         ids=["xla_path", "fused_pallas_interpret"])
def test_torch_lk_level_border_tracks_match_jax(rng, monkeypatch, pallas):
    """Tracks within the search window of every border: the window clamp
    bites and the un-clamped fraction extrapolates.  A clamp bound that is
    off by a row moves these tracks by whole pixels.  LK on a heavily
    extrapolated patch can be chaotic (amplifies the last bit), so the bar
    is: 95 % of the border tracks within 1e-3 px, all interior ones within
    1e-4 px."""
    img0, img1, pts, v0 = _lk_case(rng, T=200, border=True)
    v0 = v0 * 0.25 + np.array([-3.0, 2.0], np.float32)
    ref = _jax_lk_level(monkeypatch, img0, img1, pts, v0, pallas)
    out = klt._lk_level(t32(img0), t32(img1), t32(pts), t32(v0), 8, 6,
                        1e-4).numpy()
    d = np.abs(out - ref).max(-1)
    nb = 4 * (200 // 5)
    assert np.isfinite(out).all()
    assert (d[:nb] < 1e-3).mean() >= 0.95, np.sort(d[:nb])[-12:]
    np.testing.assert_array_less(d[nb:], 1e-4)


def test_torch_lk_level_unequal_shapes_matches_jax(rng, monkeypatch):
    """A 120x160 template image and a 120x152 search image (the JAX
    package takes its template-passed-in arm for a pair of unequal shapes):
    the port returns flows, and they agree with JAX's interpret-mode Pallas
    path at the bar of ``test_torch_lk_level_matches_jax``.

    The fused kernel K3 takes one shape only: its CUDA wrapper raises for
    unequal shapes.  On the CPU the wrapper takes its plain version, which
    does not check, so the wrapper is replaced here by one that checks as
    the card does: the level must not route such a pair to K3."""
    real = lk_kernels.lk_level_fused

    def as_on_card(img0, img1, p0_l, v, iters, radius, min_det,
                   margin=lk_kernels.MARGIN):
        lk_kernels._check_image_pair(img0, img1, 2 * radius + 2 * margin + 4,
                                     "lk_level_fused")
        return real(img0, img1, p0_l, v, iters, radius, min_det, margin)

    monkeypatch.setattr(lk_kernels, "lk_level_fused", as_on_card)
    img0, img1, pts, v0 = _lk_case(rng)
    img1 = np.ascontiguousarray(img1[:, :152])
    ref = _jax_lk_level(monkeypatch, img0, img1, pts, v0, True)
    out = klt._lk_level(t32(img0), t32(img1), t32(pts), t32(v0), 8, 6,
                        1e-4).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-4)
    assert np.median(np.abs(out - ref)) < 1e-5
    assert np.median(np.abs(out - np.array([-3.0, 2.0]))) < 0.05


def test_torch_lk_gather_plain_matches_load_blocks_pallas(rng):
    """K5's plain version against load_blocks_pallas (interpret mode): the
    TPU kernel returns 8 more rows, anchored at an aligned row below the
    clamped start; rows [d, d+WIN) of its block are the window, d = start
    - anchor.  Bit-exact, including INT_MIN/INT_MAX starts and the starts
    NaN origins cast to."""
    from sfm_tpu.ops.pallas.block_gather_kernel import load_blocks_pallas

    a = make_textured(rng, 120, 160)
    T, WIN = 64, 28
    s = np.stack([rng.integers(-40, 200, T), rng.integers(-40, 160, T)], -1)
    s[:4] = [[-2**31, -2**31], [2**31 - 1, 2**31 - 1], [0, 160 - WIN],
             [160 - WIN, 0]]
    starts = s.astype(np.int32)
    blocks, anchors = load_blocks_pallas(jnp.asarray(a), jnp.asarray(starts),
                                         WIN, interpret=True)
    blocks, anchors = np.asarray(blocks), np.asarray(anchors)
    d = np.clip(starts[:, 1], 0, 120 - WIN) - anchors[:, 1]
    assert ((d >= 0) & (d < blocks.shape[1] - WIN + 1)).all()
    ref = np.stack([blocks[t, d[t]:d[t] + WIN] for t in range(T)])
    out = lk_kernels.lk_gather(t32(a), torch.as_tensor(starts), WIN)
    np.testing.assert_array_equal(out.numpy(), ref)
    np.testing.assert_array_equal(
        out.numpy(), lk_kernels.lk_gather_plain(t32(a), torch.as_tensor(
            starts), WIN).numpy())


def _chip_smoke():
    """chip_smoke.py at the repository's root, loaded by path."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("win", [6, 28, 39])
def test_torch_lk_gather_library_call_is_plain(rng, win):
    """The one PyTorch call that chip_smoke.py times beside K5
    (``lk_gather_library``: every window as a strided view, one
    aten::index at starts clamped beforehand) gathers exactly what K5's
    plain version does, on garbage starts and INT_MIN/INT_MAX, so its
    ``library_ms`` times the same function."""
    cs = _chip_smoke()
    H, W = 60, 80
    img = t32(make_textured(rng, H, W))
    st = torch.as_tensor(cs.garbage_starts(rng, H, W, win, 64))
    sx, sy = lk_kernels._clamp_starts(st, H, W, win)
    assert torch.equal(cs.lk_gather_library(img, sx, sy, win),
                       lk_kernels.lk_gather_plain(img, st, win))


def test_torch_lk_level_tmpl_plain_matches_lk_iter_pallas(rng):
    """K4's plain version against lk_iter_pallas (interpret mode) on the
    same windows and template: the TPU kernel's raw aligned blocks with
    their row remainder d, the port's exact windows (d = 0).  atol 1e-4 px
    on every track (only the order of the P*P sums differs)."""
    from sfm_tpu.ops.pallas.block_gather_kernel import load_blocks_pallas
    from sfm_tpu.ops.pallas.lk_iter_kernel import lk_iter_pallas

    img0, img1, pts, v0 = _lk_case(rng, T=96)
    P, WIN = 13, 13 + 2 * lk_kernels.MARGIN + 3
    o0 = t32(pts) - 6
    blk0, a0 = lk_kernels._load_blocks(t32(img0), o0, P, 0)
    tmpl = lk_kernels.template_patch(blk0, a0, o0, P)
    o1 = t32(pts) + t32(v0) - 6
    start = lk_kernels.window_start(o1, lk_kernels.MARGIN + 1, 120, 160, WIN)
    starts = start.to(torch.int32)
    blk1 = lk_kernels.lk_gather(t32(img1), starts, WIN)
    base = o0 - start
    out = lk_kernels.lk_level_tmpl(blk1, tmpl, base, t32(v0), 8,
                                   1e-4).numpy()
    raw, anchors = load_blocks_pallas(jnp.asarray(img1),
                                      jnp.asarray(starts.numpy()), WIN,
                                      interpret=True)
    d = starts.numpy()[:, 1] - np.asarray(anchors)[:, 1]
    ref = np.asarray(lk_iter_pallas(
        raw, jnp.asarray(d), jnp.asarray(tmpl.permute(1, 2, 0).numpy()),
        jnp.asarray(base.numpy()), jnp.asarray(v0), P=P,
        slack=int(raw.shape[1]) - WIN, iters=8, min_det=1e-4,
        interpret=True))
    np.testing.assert_allclose(out, ref, atol=1e-4)
    assert np.median(np.abs(out - np.array([-3.0, 2.0]))) < 0.05


@pytest.mark.parametrize("radius", [3, 5, 6, 10])
def test_torch_lk_one_map_is_the_five_reads(rng, radius):
    """The identity the LK kernels' loop rests on (csrc/lk_iterate.cuh):
    one (P+2)^2 bilinear map at pixel offset (-1, -1), cut at the five
    offsets, is bit for bit each of the five ``_bil_t`` reads of the plain
    version (cur and the four gradient neighbours) - for fractions in
    [0, 1), extrapolated to -3 and 12, and NaN."""
    P = 2 * radius + 1
    T = 48
    sub = t32(rng.standard_normal((T, P + 3, P + 3)) * 60 + 128)
    f = rng.uniform(0.0, 1.0, (T, 2)).astype(np.float32)
    f[:4] = [[-3.0, 12.0], [12.0, -3.0], [-3.0, -3.0], [12.0, 12.0]]
    f[4] = np.nan
    f[5, 0] = np.nan
    fx, fy = t32(f[:, 0]), t32(f[:, 1])
    m = lk_kernels._bil_t(sub, fx, fy, P + 2, -1, -1)
    assert m.shape == (T, P + 2, P + 2)
    for ox, oy in ((0, 0), (1, 0), (-1, 0), (0, 1), (0, -1)):
        cut = m[:, 1 + oy:1 + oy + P, 1 + ox:1 + ox + P]
        ref = lk_kernels._bil_t(sub, fx, fy, P, ox, oy)
        nan = torch.isnan(ref)
        assert torch.equal(torch.isnan(cut), nan)
        assert bool(nan[4:6].all()) and not bool(nan[6:].any())
        assert torch.equal(cut[~nan], ref[~nan])


def test_torch_lk_level_nan_positions(rng, monkeypatch):
    """40 % NaN positions (dead slots): valid tracks stay finite and agree
    with JAX; NaN slots are free to return garbage, but nothing raises and
    no index leaves its window."""
    img0, img1, pts, _ = _lk_case(rng, T=64)
    bad = rng.random(64) < 0.4
    pts[bad] = np.nan
    v0 = np.zeros((64, 2), np.float32)
    ref = _jax_lk_level(monkeypatch, img0, img1, pts, v0, False)
    out = klt._lk_level(t32(img0), t32(img1), t32(pts), t32(v0), 8, 6,
                        1e-4).numpy()
    assert np.isfinite(out[~bad]).all()
    np.testing.assert_allclose(out[~bad], ref[~bad], atol=1e-4)


def test_torch_lk_window_geometry(rng):
    """The geometry the kernels share, on hand-made cases: start clipped in
    float after nan_to_num; sub-window origin clipped to [1, WIN-P-2] with
    the fraction left un-clamped."""
    o = torch.tensor([[5.5, 7.25], [-3.0, 2.0], [200.0, 200.0],
                      [float("nan"), float("inf")]])
    s = lk_kernels.window_start(o, 7, 120, 160, 28)
    np.testing.assert_array_equal(
        s.numpy(), [[0, 0], [0, 0], [132, 92], [0, 92]])
    s = lk_kernels.window_start(o[:1] + 30, 7, 120, 160, 28)
    np.testing.assert_array_equal(s.numpy(), [[28, 30]])
    qii, f = lk_kernels._qf(
        torch.tensor([[10.5, 0.25], [40.0, -2.5]]),
        torch.tensor([[3.0, 0.0], [0.0, 0.0]]), 13, 28, 28)
    np.testing.assert_array_equal(qii.numpy(), [[6, 0], [12, 0]])
    np.testing.assert_allclose(f.numpy(), [[0.5, -0.75], [27.0, -3.5]])


def test_torch_lk_track_fb_matches_jax(rng):
    """Forward-backward pyramidal LK, 3 levels: positions of tracks both
    sides accept agree within 1e-3 px (rounding carried through 2x3 levels
    of 10 iterations), and the accept masks agree on 99 %."""
    a = make_textured(rng, 240, 320)
    b = np.roll(a, (3, -5), axis=(0, 1))
    T = 200
    pts = rng.uniform(30, [290, 210], (T, 2)).astype(np.float32)
    valid = rng.random(T) < 0.9
    pj0 = tuple(jim.build_pyramid(jnp.asarray(a), 3))
    pj1 = tuple(jim.build_pyramid(jnp.asarray(b), 3))
    fj, okj = jklt.lk_track_fb(pj0, pj1, jnp.asarray(pts),
                               jnp.asarray(valid), 3, 10, 6)
    pt0 = im.build_pyramid(t32(a), 3)
    pt1 = im.build_pyramid(t32(b), 3)
    ft, okt = klt.lk_track_fb(pt0, pt1, t32(pts), torch.as_tensor(valid),
                              3, 10, 6, device="cpu")
    okj, okt = np.asarray(okj), okt.numpy()
    assert (okj == okt).mean() >= 0.99
    both = okj & okt
    assert both.sum() > 0.7 * T
    np.testing.assert_allclose(ft.numpy()[both], np.asarray(fj)[both],
                               atol=1e-3)


# ---------------------------------------------------------------------------
# tracker
# ---------------------------------------------------------------------------


def _jax_state_leaves(st):
    return {k: np.asarray(v) for k, v in st._asdict().items()}


@pytest.mark.parametrize("starve", [False, True],
                         ids=["no_replenish", "replenish"])
def test_torch_tracker_step_from_converted_state(rng, starve):
    """tracker.step from the JAX state converted field for field: same
    matched mask on 99 % of the slots, positions of matched tracks within
    1e-3 px, same ids; with replenish (min_tracks above the survivors) the
    same number of new tracks with the same id range, 98 % of them at the
    same pixel (corner ties, see test_torch_detect_corners_matches_jax)."""
    a = make_textured(rng, 240, 320)
    b = np.roll(a, (2, -3), axis=(0, 1))
    kw = dict(max_tracks=256, min_tracks=250 if starve else 10,
              pyr_levels=3, win_radius=6, iters=10, min_distance=8)
    jcfg, cfg = JKLTConfig(**kw), KLTConfig(**kw)
    st_j = jtracker.bootstrap(jnp.asarray(a), jcfg)
    st_t = tracker.state_from_numpy(_jax_state_leaves(st_j), device="cpu")
    back = tracker.state_to_numpy(st_t)
    for k, v in _jax_state_leaves(st_j).items():
        assert back[k].dtype == v.dtype, k
        np.testing.assert_array_equal(back[k], v)

    pj0 = tuple(jim.build_pyramid(jnp.asarray(a), 3))
    pj1 = tuple(jim.build_pyramid(jnp.asarray(b), 3))
    nj, prev_j, m_j = jtracker.step(pj0, pj1, st_j, jcfg)
    pt0 = im.build_pyramid(t32(a), 3)
    pt1 = im.build_pyramid(t32(b), 3)
    nt, prev_t, m_t = tracker.step(pt0, pt1, st_t, cfg, device="cpu")
    m_j, m_t = np.asarray(m_j), m_t.numpy()
    assert (m_j == m_t).mean() >= 0.99
    np.testing.assert_array_equal(prev_t.numpy(), np.asarray(prev_j))
    both = m_j & m_t
    np.testing.assert_allclose(nt.pos.numpy()[both],
                               np.asarray(nj.pos)[both], atol=1e-3)
    np.testing.assert_array_equal(nt.ids.numpy()[both],
                                  np.asarray(nj.ids)[both])
    if starve:
        assert int(nt.next_id) > int(st_t.next_id)
        assert abs(int(nt.next_id) - int(nj.next_id)) <= 3
        new_j = np.asarray(nj.valid) & ~m_j
        new_t = nt.valid.numpy() & ~m_t
        pj = {tuple(p) for p in np.asarray(nj.pos)[new_j]}
        pt = {tuple(p) for p in nt.pos.numpy()[new_t]}
        assert len(pj & pt) >= 0.95 * len(pj)
    else:
        assert int(nt.next_id) == int(nj.next_id)
        np.testing.assert_array_equal(nt.valid.numpy(), m_t)


def test_torch_tracker_bootstrap_matches_jax(rng):
    a = make_textured(rng, 240, 320)
    kw = dict(max_tracks=256, min_tracks=10, pyr_levels=3, win_radius=6,
              iters=10, min_distance=8)
    st_j = jtracker.bootstrap(jnp.asarray(a), JKLTConfig(**kw))
    st_t = tracker.bootstrap(t32(a), KLTConfig(**kw), device="cpu")
    assert int(st_t.next_id) == int(st_j.next_id)
    pj = {tuple(p) for p in np.asarray(st_j.pos)[np.asarray(st_j.valid)]}
    pt = {tuple(p) for p in st_t.pos.numpy()[st_t.valid.numpy()]}
    assert len(pj & pt) >= 0.98 * len(pj)
    assert st_t.pos.dtype == torch.float32 and st_t.ids.dtype == torch.int32


# ---------------------------------------------------------------------------
# package hygiene
# ---------------------------------------------------------------------------


def test_torch_port_imports_no_jax():
    """A fresh interpreter that imports the whole port has neither jax nor
    the JAX package in sys.modules."""
    code = (
        "import sys, importlib, pkgutil\n"
        "import sfm_tpu_torch\n"
        "for m in pkgutil.walk_packages(sfm_tpu_torch.__path__, "
        "'sfm_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'sfm_tpu' or "
        "m.startswith('sfm_tpu.')]\n"
        "assert not bad, bad\n"
        "import torch\n"
        "assert torch.backends.cuda.matmul.allow_tf32 is False\n"
        "assert torch.backends.cudnn.allow_tf32 is False\n"
        "assert torch.get_float32_matmul_precision() == 'highest'\n"
        "print('clean')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("clean")


@pytest.mark.parametrize("entry", ["bootstrap", "detect_corners",
                                   "lk_track_fb", "init_state"])
def test_torch_default_device_raises_without_cuda(rng, entry):
    """Entry points default to the card; without one they raise instead of
    running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    a = t32(make_textured(rng, 64, 64))
    cfg = KLTConfig(max_tracks=32, min_tracks=4, pyr_levels=2)
    calls = {
        "bootstrap": lambda: tracker.bootstrap(a, cfg),
        "init_state": lambda: tracker.init_state(8),
        "detect_corners": lambda: features.detect_corners(
            a, torch.zeros((1, 2)), torch.zeros(1, dtype=torch.bool), 8, 8),
        "lk_track_fb": lambda: klt.lk_track_fb(
            [a], [a], torch.zeros((4, 2)), torch.ones(4, dtype=torch.bool),
            1, 2, 2),
    }
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calls[entry]()

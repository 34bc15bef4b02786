"""PyTorch port vs JAX package: bfloat16 LK block storage
(SFM_TPU_LK_BF16=1) and the scene axis of the template-passed-in and
unfused LK arms, on the CPU.

The JAX package picks its LK storage dtype once (``klt._lk_dtype``,
memoized in ``_LK_DTYPE_RESOLVED`` because it is read at trace time), so
its side is switched by patching that module state and evicting the traces
of the jitted functions that read it (``JaxLkStorage``), before and after;
the port reads SFM_TPU_LK_BF16 at every call.  Pallas kernels run in interpret mode, as tests/test_pallas_kernels.py
runs them; on the CPU every port kernel is its plain version, and
tests/test_torch_card.py holds the CUDA kernels to those on the card.
tests/test_torch_lk_bf16_scan.py holds a whole ScanSfM run in bfloat16.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sfm_tpu.config import KLTConfig as JKLTConfig
from sfm_tpu.models import scan_pipeline as jsp, tracker as jtracker
from sfm_tpu.ops import image as jim, klt as jklt

from sfm_tpu_torch.config import KLTConfig
from sfm_tpu_torch.models import tracker
from sfm_tpu_torch.ops import features, image as im, klt
from sfm_tpu_torch.ops.kernels import lk_kernels
from sfm_tpu_torch.utils import debug

torch.set_num_threads(1)

BF = torch.bfloat16


def make_textured(rng, H=128, W=256):
    from scipy.ndimage import gaussian_filter

    return (gaussian_filter(rng.standard_normal((H, W)), 2.0) * 60
            + 128).astype(np.float32)


def t32(a):
    return torch.as_tensor(np.asarray(a, np.float32))


def rounded(x):
    """A float32 tensor rounded to bfloat16 and back (what bf16 storage
    holds, in float32)."""
    return x.to(BF).float()


# (SFM_TPU_PALLAS, SFM_TPU_LK_FUSED, SFM_TPU_LK_FUSED_TMPL) of each arm, as
# in tests/test_torch_kernels.py; the port reads the last two
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


# every jitted function of the JAX package that these tests reach and whose
# trace reads ``klt._lk_dtype``: ``lk_track`` and each jitted caller of it
JAX_LK_JITS = (jklt.lk_track, jklt.lk_track_fb, jtracker.step,
               jsp.run_chunk, jsp._loop_verify_stage, jsp._loop_pnp_stage,
               jsp._loop_pnp_edge_stage)


class JaxLkStorage:
    """Sets the JAX package's LK storage dtype for a block, and evicts the
    traces of ``JAX_LK_JITS`` on entry and on exit: the dtype is read at
    trace time, so a cached trace would keep the other one.  The rest of
    the process's compile caches stays."""

    def __init__(self, dtype):
        self.dtype = dtype

    @staticmethod
    def _evict():
        for f in JAX_LK_JITS:
            f.clear_cache()

    def __enter__(self):
        self.old = jklt._LK_DTYPE_RESOLVED
        jklt._LK_DTYPE_RESOLVED = self.dtype
        self._evict()

    def __exit__(self, *exc):
        jklt._LK_DTYPE_RESOLVED = self.old
        self._evict()


def _lk_case(rng, T=150):
    img0 = make_textured(rng, 120, 160)
    img1 = np.roll(img0, (2, -3), axis=(0, 1))
    pts = rng.uniform(20, [140, 100], (T, 2)).astype(np.float32)
    v0 = rng.uniform(-2, 2, (T, 2)).astype(np.float32)
    return img0, img1, pts, v0


# ---------------------------------------------------------------------------
# the switch
# ---------------------------------------------------------------------------


def test_torch_lk_bf16_switch_is_read_at_call_time(rng, monkeypatch):
    """SFM_TPU_LK_BF16 unset or "0" (or anything but "1") stores the LK
    pyramids in float32, "1" in bfloat16, and ``lk_track`` reads it at
    each call: both settings in one process reach the level with their
    dtype."""
    monkeypatch.delenv("SFM_TPU_LK_BF16", raising=False)
    assert klt.lk_dtype() == torch.float32
    for val, want in (("0", torch.float32), ("1", BF), ("", torch.float32),
                      (" 1 ", BF), ("yes", torch.float32)):
        monkeypatch.setenv("SFM_TPU_LK_BF16", val)
        assert klt.lk_dtype() == want, val

    seen = []
    real = lk_kernels.lk_level_fused

    def spy(img0, img1, *args, **kw):
        seen.append((img0.dtype, img1.dtype))
        return real(img0, img1, *args, **kw)

    monkeypatch.setattr(lk_kernels, "lk_level_fused", spy)
    a = t32(make_textured(rng, 64, 80))
    pyr = im.build_pyramid(a, 2)
    pts = t32(rng.uniform(20, 50, (16, 2)))
    valid = torch.ones(16, dtype=torch.bool)
    for val in ("1", "0", "1"):
        monkeypatch.setenv("SFM_TPU_LK_BF16", val)
        klt.lk_track(pyr, pyr, pts, valid, 2, 2, 3, device="cpu")
    assert seen == [(BF, BF)] * 2 + [(torch.float32,) * 2] * 2 + [(BF, BF)] * 2


def test_torch_lk_bf16_check_finite_sees_bf16(rng):
    """The wrappers' NaN/Inf check (``debug.check_finite``) works on the
    bfloat16 windows the gathers write."""
    w = torch.ones((4, 6, 6), dtype=BF)
    assert debug._bad(w) is False
    w[2, 3, 1] = float("nan")
    assert debug._bad(w) is True
    w[2, 3, 1] = float("inf")
    assert debug._bad(w) is True


# ---------------------------------------------------------------------------
# one LK level
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arm", ["xla", "fused", "tmpl", "unfused"],
                         ids=["xla_path", "fused_pallas_interpret",
                              "tmpl_pallas_interpret",
                              "unfused_pallas_interpret"])
def test_torch_lk_level_bf16_matches_jax(rng, monkeypatch, arm):
    """One LK level on bfloat16 images, the port against the JAX package
    on each arm, with the same switches on both sides (Pallas in interpret
    mode).  The bars of test_torch_lk_level_matches_jax: atol 1e-4 px on
    every track, median under 1e-5 (both sides upcast the bfloat16 pixels
    before any arithmetic; only the order of the P*P sums differs)."""
    img0, img1, pts, v0 = _lk_case(rng)
    _set_arm(monkeypatch, arm)
    # JAX's level reads no storage switch: it stores what it is given
    ref = np.asarray(jklt._lk_level(
        jnp.asarray(img0, jnp.bfloat16), jnp.asarray(img1, jnp.bfloat16),
        jnp.asarray(pts), jnp.asarray(v0), 8, 6, 1e-4))
    out = klt._lk_level(t32(img0).to(BF), t32(img1).to(BF), t32(pts),
                        t32(v0), 8, 6, 1e-4)
    assert out.dtype == torch.float32
    out = out.numpy()
    np.testing.assert_allclose(out, ref, atol=1e-4)
    assert np.median(np.abs(out - ref)) < 1e-5
    assert np.median(np.abs(out - np.array([-3.0, 2.0]))) < 0.05


@pytest.mark.parametrize("arm", ["fused", "tmpl", "unfused"])
def test_torch_lk_bf16_plain_equals_f32_on_rounded(rng, monkeypatch, arm):
    """The port's plain versions on bfloat16 storage give, bit for bit,
    their float32 run on the images rounded to bfloat16 (tolerance 0), on
    each arm: one level, and ``lk_track_fb`` with the switch on against
    the switch off on rounded pyramids (the cast inside ``lk_track``)."""
    img0, img1, pts, v0 = _lk_case(rng, T=90)
    a, b = t32(img0), t32(img1)
    _set_arm(monkeypatch, arm)
    out16 = klt._lk_level(a.to(BF), b.to(BF), t32(pts), t32(v0), 8, 6, 1e-4)
    out32 = klt._lk_level(rounded(a), rounded(b), t32(pts), t32(v0), 8, 6,
                          1e-4)
    assert torch.equal(out16, out32)

    pyr0, pyr1 = im.build_pyramid(a, 3), im.build_pyramid(b, 3)
    valid = torch.ones(90, dtype=torch.bool)
    monkeypatch.setenv("SFM_TPU_LK_BF16", "1")
    f16, ok16 = klt.lk_track_fb(pyr0, pyr1, t32(pts), valid, 3, 8, 5,
                                device="cpu")
    monkeypatch.setenv("SFM_TPU_LK_BF16", "0")
    f32, ok32 = klt.lk_track_fb([rounded(p) for p in pyr0],
                                [rounded(p) for p in pyr1], t32(pts), valid,
                                3, 8, 5, device="cpu")
    assert torch.equal(f16, f32) and torch.equal(ok16, ok32)
    assert ok16.float().mean() > 0.5


# ---------------------------------------------------------------------------
# forward-backward LK
# ---------------------------------------------------------------------------


def test_torch_lk_track_fb_bf16_matches_jax(rng, monkeypatch):
    """Forward-backward LK in bfloat16, the port against the JAX package in
    bfloat16 (default arms: JAX's XLA path, the port's K3 plain version),
    at the bars of test_torch_lk_track_fb_matches_jax: accept masks agree
    on 99 %, positions of tracks both accept within 1e-3 px."""
    a = make_textured(rng, 240, 320)
    b = np.roll(a, (3, -5), axis=(0, 1))
    T = 200
    pts = rng.uniform(30, [290, 210], (T, 2)).astype(np.float32)
    valid = rng.random(T) < 0.9
    with JaxLkStorage(jnp.bfloat16):
        fj, okj = jklt.lk_track_fb(
            tuple(jim.build_pyramid(jnp.asarray(a), 3)),
            tuple(jim.build_pyramid(jnp.asarray(b), 3)),
            jnp.asarray(pts), jnp.asarray(valid), 3, 10, 6)
        fj, okj = np.asarray(fj), np.asarray(okj)
    monkeypatch.setenv("SFM_TPU_LK_BF16", "1")
    ft, okt = klt.lk_track_fb(im.build_pyramid(t32(a), 3),
                              im.build_pyramid(t32(b), 3), t32(pts),
                              torch.as_tensor(valid), 3, 10, 6, device="cpu")
    okt = okt.numpy()
    assert (okj == okt).mean() >= 0.99
    both = okj & okt
    assert both.sum() > 0.7 * T
    np.testing.assert_allclose(ft.numpy()[both], fj[both], atol=1e-3)


def test_torch_lk_bf16_matches_f32(rng, monkeypatch):
    """The port's bfloat16 storage against its float32 on the input and at
    the bars of the JAX package's tests/test_klt.py::test_lk_bf16_matches_f32
    (the same 240x320 texture from the same seed, shifted by (3.7, -2.2)
    px with a cubic spline), its corners tracked over 3 levels: near the
    same survivors (at most 2 % differ) and converged flows within
    hundredths of a pixel (median < 0.02 px, max < 0.3 px)."""
    from scipy.ndimage import shift as nd_shift

    img0 = make_textured(rng, 240, 320)
    img1 = nd_shift(img0, (-2.2, 3.7), order=3,
                    mode="nearest").astype(np.float32)
    pyr0 = im.build_pyramid(t32(img0), 3)
    pyr1 = im.build_pyramid(t32(img1), 3)
    xy, _, valid = features.detect_corners(
        t32(img0), torch.zeros((1, 2)), torch.zeros(1, dtype=torch.bool),
        max_new=128, cell=10, device="cpu")

    def run(flag):
        monkeypatch.setenv("SFM_TPU_LK_BF16", flag)
        new, ok = klt.lk_track_fb(pyr0, pyr1, xy, valid, levels=3, iters=10,
                                  radius=5, device="cpu")
        return new.numpy(), ok.numpy()

    new32, ok32 = run("0")
    new16, ok16 = run("1")
    both = ok32 & ok16
    assert both.sum() > 20
    assert (ok32 ^ ok16).sum() <= max(2, int(0.02 * ok32.sum()))
    d = np.linalg.norm(new32[both] - new16[both], axis=1)
    assert np.median(d) < 0.02 and d.max() < 0.3


# ---------------------------------------------------------------------------
# the scene axis of arms (b) and (c)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("arm", ["tmpl", "unfused"])
def test_torch_stacked_arms_match_jax_vmap(rng, monkeypatch, arm, dtype):
    """``lk_track_fb`` on scene-stacked pyramids (S=3) under arm (b)
    (SFM_TPU_LK_FUSED_TMPL=0) and arm (c) (SFM_TPU_LK_FUSED=0), in float32
    and bfloat16, against the JAX package's ``jax.vmap(lk_track_fb)`` on
    the same switches (Pallas in interpret mode, the multi-scene runner's
    form), at the ``lk_track_fb`` bars (masks agree on 99 %, positions
    within 1e-3 px).  A spy counts the port's calls: per level and
    direction two K5 calls (template and search windows) and, on arm (b),
    one K4 call, for all three scenes together."""
    S, T, levels, iters, radius = 3, 100, 2, 8, 4
    a = np.stack([make_textured(rng, 96, 128) for _ in range(S)])
    b = np.stack([np.roll(x, (2 - s, s - 3), axis=(0, 1))
                  for s, x in enumerate(a)])
    pts = rng.uniform(0, [127, 95], (S, T, 2)).astype(np.float32)
    valid = rng.random((S, T)) < 0.9
    _set_arm(monkeypatch, arm)
    jdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    with JaxLkStorage(jdt):
        pj0 = tuple(jnp.stack(x) for x in zip(
            *(jim.build_pyramid(jnp.asarray(x), levels) for x in a)))
        pj1 = tuple(jnp.stack(x) for x in zip(
            *(jim.build_pyramid(jnp.asarray(x), levels) for x in b)))
        fj, okj = jax.vmap(lambda p0, p1, x, v: jklt.lk_track_fb(
            p0, p1, x, v, levels, iters, radius))(
                pj0, pj1, jnp.asarray(pts), jnp.asarray(valid))
        fj, okj = np.asarray(fj), np.asarray(okj)

    calls = {"lk_gather": [], "lk_level_tmpl": []}
    for name in calls:
        real = getattr(lk_kernels, name)

        def spy(*args, _real=real, _name=name, **kw):
            calls[_name].append(tuple(args[0].shape))
            return _real(*args, **kw)
        monkeypatch.setattr(lk_kernels, name, spy)
    monkeypatch.setenv("SFM_TPU_LK_BF16", "1" if dtype == "bf16" else "0")
    pt0 = tuple(torch.stack(x) for x in zip(
        *(im.build_pyramid(t32(x), levels) for x in a)))
    pt1 = tuple(torch.stack(x) for x in zip(
        *(im.build_pyramid(t32(x), levels) for x in b)))
    ft, okt = klt.lk_track_fb(pt0, pt1, t32(pts), torch.as_tensor(valid),
                              levels, iters, radius, device="cpu")
    n = levels * 2  # levels x directions
    assert len(calls["lk_gather"]) == 2 * n
    assert all(c[0] == S for c in calls["lk_gather"])  # the whole stack
    assert len(calls["lk_level_tmpl"]) == (n if arm == "tmpl" else 0)
    assert all(c[:2] == (S, T) for c in calls["lk_level_tmpl"])

    okt = okt.numpy()
    assert ft.shape == (S, T, 2)
    assert (okj == okt).mean() >= 0.99
    both = okj & okt
    assert both.sum() > 0.6 * S * T
    np.testing.assert_allclose(ft.numpy()[both], fj[both], atol=1e-3)


# ---------------------------------------------------------------------------
# the slice as a whole
# ---------------------------------------------------------------------------


def _jax_state_leaves(st):
    return {k: np.asarray(v) for k, v in st._asdict().items()}


@pytest.mark.parametrize("starve", [False, True],
                         ids=["no_replenish", "replenish"])
def test_torch_tracker_step_bf16_from_converted_state(rng, monkeypatch,
                                                      starve):
    """``tracker.step`` with bfloat16 LK storage on both sides, from the
    JAX state converted field for field, at the bars of
    test_torch_tracker_step_from_converted_state: the same matched mask on
    99 % of the slots, matched tracks within 1e-3 px with the same ids;
    with replenish the same number of new tracks (within 3), 95 % of them
    at the same pixel."""
    a = make_textured(rng, 240, 320)
    b = np.roll(a, (2, -3), axis=(0, 1))
    kw = dict(max_tracks=256, min_tracks=250 if starve else 10,
              pyr_levels=3, win_radius=6, iters=10, min_distance=8)
    jcfg, cfg = JKLTConfig(**kw), KLTConfig(**kw)
    with JaxLkStorage(jnp.bfloat16):
        st_j = jtracker.bootstrap(jnp.asarray(a), jcfg)
        nj, prev_j, m_j = jtracker.step(
            tuple(jim.build_pyramid(jnp.asarray(a), 3)),
            tuple(jim.build_pyramid(jnp.asarray(b), 3)), st_j, jcfg)
        m_j = np.asarray(m_j)
        nj = _jax_state_leaves(nj)
    st_t = tracker.state_from_numpy(_jax_state_leaves(st_j), device="cpu")
    monkeypatch.setenv("SFM_TPU_LK_BF16", "1")
    nt, prev_t, m_t = tracker.step(im.build_pyramid(t32(a), 3),
                                   im.build_pyramid(t32(b), 3), st_t, cfg,
                                   device="cpu")
    m_t = m_t.numpy()
    assert (m_j == m_t).mean() >= 0.99
    np.testing.assert_array_equal(prev_t.numpy(), np.asarray(prev_j))
    both = m_j & m_t
    np.testing.assert_allclose(nt.pos.numpy()[both], nj["pos"][both],
                               atol=1e-3)
    np.testing.assert_array_equal(nt.ids.numpy()[both], nj["ids"][both])
    if starve:
        assert abs(int(nt.next_id) - int(nj["next_id"])) <= 3
        new_j = nj["valid"] & ~m_j
        new_t = nt.valid.numpy() & ~m_t
        pj = {tuple(p) for p in nj["pos"][new_j]}
        pt = {tuple(p) for p in nt.pos.numpy()[new_t]}
        assert len(pj & pt) >= 0.95 * len(pj)
    else:
        assert int(nt.next_id) == int(nj["next_id"])

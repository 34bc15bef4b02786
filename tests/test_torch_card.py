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

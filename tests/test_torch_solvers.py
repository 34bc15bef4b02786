"""PyTorch port vs JAX package: the geometric solvers and the host-side
copies, on the CPU, same numpy inputs on both sides.

The JAX package runs float32 here wherever the scan pipeline pins float32
(the inputs are cast to float32 before they reach either side), so the two
sides differ only by the order of a few sums and by fused multiply-adds.
Tolerances say what that leaves.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sfm_tpu import config as jconfig
from sfm_tpu.ops import (ba as jba, descriptors as jdesc, epipolar as jepi,
                         lie as jlie, linalg as jlinalg, pnp as jpnp,
                         triangulate as jtri, umeyama as jume)
from sfm_tpu.utils import artifacts as jart, np_geom as jgeom, \
    synthetic as jsyn

from sfm_tpu_torch import config
from sfm_tpu_torch.ops import (ba, descriptors, epipolar, lie, linalg, pnp,
                               triangulate, umeyama)
from sfm_tpu_torch.utils import artifacts, np_geom, synthetic

torch.set_num_threads(1)

F32 = np.float32


def tt(a, dtype=torch.float32):
    return torch.as_tensor(np.asarray(a)).to(dtype)


def jj(a, dtype=jnp.float32):
    return jnp.asarray(np.asarray(a), dtype)


# ---------------------------------------------------------------------------
# linalg / lie
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [3, 4, 9])
def test_torch_jacobi_eigh_matches_jax(rng, n):
    """Same rotations in the same cyclic order: eigenvalues agree to a few
    float32 ulps of the largest one, eigenvectors (sign included — no sign
    fix-up on either side) to 1e-4 where the gap to the neighbours is not
    tiny."""
    A = rng.standard_normal((20, n, n))
    A = (A + A.transpose(0, 2, 1)).astype(F32)
    wj, Vj = jlinalg.jacobi_eigh(jj(A))
    wt, Vt = linalg.jacobi_eigh(tt(A))
    wj, Vj = np.asarray(wj), np.asarray(Vj)
    scale = np.abs(wj).max()
    np.testing.assert_allclose(wt.numpy(), wj, atol=2e-6 * scale)
    gap = np.min(np.abs(np.diff(wj, axis=-1)), axis=-1)
    ok = gap > 0.05
    assert ok.sum() >= 10
    np.testing.assert_allclose(Vt.numpy()[ok], Vj[ok], atol=1e-4)
    # and it is an eigendecomposition
    rec = Vt @ torch.diag_embed(wt) @ Vt.transpose(-1, -2)
    np.testing.assert_allclose(rec.numpy(), A, atol=2e-5 * scale)


def test_torch_svd3_and_nullvec_match_jax(rng):
    """One-sided Jacobi, as it is in the JAX package: U, s, Vt agree with
    their signs and order (they pick the (R,t) branch downstream)."""
    A = rng.standard_normal((50, 3, 3)).astype(F32)
    A[:5, :, 2] = A[:5, :, 0] * 2.0  # rank-2 cases take the completion path
    Uj, sj, Vtj = (np.asarray(x) for x in jlinalg.svd3_jacobi(jj(A)))
    Ut, st, Vtt = (x.numpy() for x in linalg.svd3_jacobi(tt(A)))
    np.testing.assert_allclose(st, sj, atol=2e-6 * sj.max())
    full = sj[:, 2] > 1e-3
    np.testing.assert_allclose(Ut[full], Uj[full], atol=2e-4)
    np.testing.assert_allclose(Vtt[full], Vtj[full], atol=2e-4)
    np.testing.assert_allclose(Ut @ (st[..., None] * Vtt), A, atol=1e-5)
    # same handedness where the rank is full; in the rank-2 cases the third
    # column's sign follows the rounding noise in A v2 on either side, and U
    # is orthonormal all the same
    np.testing.assert_allclose(np.linalg.det(Ut[full]),
                               np.linalg.det(Uj[full]), atol=1e-4)
    np.testing.assert_allclose(np.abs(np.linalg.det(Ut)), 1.0, atol=1e-4)
    B = rng.standard_normal((30, 8, 9)).astype(F32)
    nj = np.asarray(jlinalg.nullvec_lstsq(jj(B)))
    nt = linalg.nullvec_lstsq(tt(B)).numpy()
    np.testing.assert_allclose(nt, nj, atol=1e-4)
    np.testing.assert_allclose(np.einsum("bij,bj->bi", B, nt), 0, atol=1e-4)


def test_torch_solve_psd_and_small_helpers_match_jax(rng):
    M = rng.standard_normal((10, 30, 30))
    A = (M @ M.transpose(0, 2, 1) + 0.5 * np.eye(30)).astype(F32)
    b = rng.standard_normal((10, 30)).astype(F32)
    xj = np.asarray(jlinalg.solve_psd(jj(A), jj(b), jitter=1e-12))
    xt = linalg.solve_psd(tt(A), tt(b), jitter=1e-12).numpy()
    # conditioning ~1e3: float32 solves agree to ~1e-3 relative
    np.testing.assert_allclose(xt, xj, rtol=2e-3, atol=2e-4)
    A3 = rng.standard_normal((40, 3, 3)).astype(F32)
    np.testing.assert_allclose(linalg.inv3(tt(A3)).numpy(),
                               np.asarray(jlinalg.inv3(jj(A3))),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(linalg.det3(tt(A3)).numpy(),
                               np.asarray(jlinalg.det3(jj(A3))),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        linalg.enforce_rank2(tt(A3)).numpy(),
        np.asarray(jlinalg.enforce_rank2(jj(A3))), atol=1e-4)
    pts = rng.standard_normal((4, 25, 2)).astype(F32)
    val = rng.random((4, 25)) < 0.8
    pj, Tj = jlinalg.normalize_points_hartley(jj(pts), jnp.asarray(val))
    pt, Tt = linalg.normalize_points_hartley(tt(pts), torch.as_tensor(val))
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), atol=1e-5)
    np.testing.assert_allclose(Tt.numpy(), np.asarray(Tj), atol=1e-5)
    nv = linalg.nullvec_inviter(tt(rng.standard_normal((6, 4, 4))))
    assert nv.shape == (6, 4)


def test_torch_nanmedian_matches_jax(rng):
    """Mean of the two middle values for an even count, NaN for none —
    jnp.nanmedian, not torch.nanmedian (which takes the lower one)."""
    x = rng.standard_normal((6, 11)).astype(F32)
    x[0, :3] = np.nan          # 8 left: even
    x[1, :4] = np.nan          # 7 left: odd
    x[2, :] = np.nan           # none
    x[3, 1:] = np.nan          # one
    ref = np.asarray(jnp.nanmedian(jj(x), axis=-1))
    out = linalg.nanmedian(tt(x)).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-7, equal_nan=True)
    assert np.isnan(out[2])
    assert out[0] != torch.nanmedian(tt(x[0])).item()


def test_torch_lie_matches_jax(rng):
    w = (rng.standard_normal((30, 3)) * np.array([[1e-5], [0.3], [3.0]])
         .repeat(10, 0)).astype(F32)
    Rj = np.asarray(jlie.so3_exp(jj(w)))
    Rt = lie.so3_exp(tt(w)).numpy()
    np.testing.assert_allclose(Rt, Rj, atol=1e-6)
    np.testing.assert_allclose(lie.so3_log(tt(Rj)).numpy(),
                               np.asarray(jlie.so3_log(jj(Rj))), atol=2e-5)
    # near pi, in float64 (the branch the loop edges need)
    wpi = np.array([[np.pi - 1e-5, 0, 0], [0, -(np.pi - 1e-4), 0.0]])
    Rpi = np.asarray(jlie.so3_exp(jnp.asarray(wpi)))
    np.testing.assert_allclose(
        lie.so3_log(torch.as_tensor(Rpi)).numpy(),
        np.asarray(jlie.so3_log(jnp.asarray(Rpi))), atol=1e-9)
    t = rng.standard_normal((30, 3)).astype(F32)
    Ri, ti = lie.pose_inv(tt(Rj), tt(t))
    Rc, tc = lie.pose_compose(tt(Rj), tt(t), Ri, ti)
    np.testing.assert_allclose(Rc.numpy(), np.tile(np.eye(3), (30, 1, 1)),
                               atol=1e-5)
    np.testing.assert_allclose(tc.numpy(), 0, atol=1e-5)
    np.testing.assert_array_equal(lie.hat(tt(w)).numpy(),
                                  np.asarray(jlie.hat(jj(w))))


# ---------------------------------------------------------------------------
# two-view geometry
# ---------------------------------------------------------------------------


def make_two_view(rng, n=300, noise=0.0, outlier_frac=0.0):
    X = rng.standard_normal((n, 3)) * np.array([0.5, 0.5, 0.3]) \
        + np.array([0, 0, 4.0])
    w = rng.standard_normal(3) * 0.1
    R = lie.so3_exp(torch.as_tensor(w)).numpy()
    t = rng.standard_normal(3)
    t = 0.5 * t / np.linalg.norm(t)
    Xj = X @ R.T + t
    xi = X[:, :2] / X[:, 2:3]
    xj = Xj[:, :2] / Xj[:, 2:3]
    if noise:
        xi = xi + rng.standard_normal(xi.shape) * noise
        xj = xj + rng.standard_normal(xj.shape) * noise
    n_out = int(n * outlier_frac)
    if n_out:
        xi[:n_out] = rng.uniform(-0.5, 0.5, (n_out, 2))
        xj[:n_out] = rng.uniform(-0.5, 0.5, (n_out, 2))
    return xi.astype(F32), xj.astype(F32), R, t, X


def test_torch_epipolar_pieces_match_jax(rng):
    xi, xj, R, t, _ = make_two_view(rng, n=64, noise=1e-4)
    xi8, xj8 = xi.reshape(8, 8, 2), xj.reshape(8, 8, 2)
    Ej = np.asarray(jepi.eight_point_E(jj(xi8), jj(xj8)))
    Et = epipolar.eight_point_E(tt(xi8), tt(xj8)).numpy()
    # E is defined up to the null vector's sign, which both sides take
    # from the same Jacobi run
    np.testing.assert_allclose(Et, Ej, atol=5e-4)
    ej = np.asarray(jepi.sampson_error(jj(Ej), jj(xi)[None], jj(xj)[None]))
    et = epipolar.sampson_error(tt(Ej), tt(xi)[None], tt(xj)[None]).numpy()
    np.testing.assert_allclose(et, ej, rtol=1e-3, atol=1e-9)
    Rsj, tsj = jepi.decompose_E(jj(Ej))
    Rst, tst = epipolar.decompose_E(tt(Ej))
    # an essential matrix has two equal singular values, so which of the
    # two leads after the sort is rounding noise: the four candidates come
    # out as the same SET on both sides, possibly in another order (the
    # cheirality vote downstream picks by votes, not by position)
    Rst, tst = Rst.numpy(), tst.numpy()
    Rsj, tsj = np.asarray(Rsj), np.asarray(tsj)
    for b in range(Rsj.shape[0]):
        for c in range(4):
            d = (np.abs(Rst[b] - Rsj[b, c]).max((-1, -2))
                 + np.abs(tst[b] - tsj[b, c]).max(-1))
            assert d.min() < 2e-3, (b, c, d)
    K = np.array([[1520.0, 0.5, 319.5], [0, 1500.0, 239.5], [0, 0, 1]], F32)
    px = rng.uniform(0, 600, (50, 2)).astype(F32)
    np.testing.assert_allclose(
        epipolar.normalize_by_K(tt(K), tt(px)).numpy(),
        np.asarray(jepi.normalize_by_K(jj(K), jj(px))), atol=1e-7)
    Xt, zi, zj = epipolar.triangulate_two_view(
        tt(R)[None], tt(t)[None], tt(xi)[None], tt(xj)[None])
    Xjx, zij, zjj = jepi.triangulate_two_view(
        jj(R)[None], jj(t)[None], jj(xi)[None], jj(xj)[None])
    np.testing.assert_allclose(Xt.numpy(), np.asarray(Xjx), rtol=2e-3,
                               atol=2e-3)
    assert ((zi.numpy() > 0) == (np.asarray(zij) > 0)).all()


@pytest.mark.parametrize("outlier_frac", [0.0, 0.3])
def test_torch_find_E_ransac_matches_jax_shared_priorities(rng,
                                                           outlier_frac):
    """Same (H,N) sampling priorities on both sides (JAX draws them from its
    key; the port takes them through ``pri=``): same minimal samples, same
    hypotheses, the same local optimum.  Bar: inlier masks agree on 99 % of
    the points, inlier counts within 2 %, R within 1e-3, t within 2e-3 (the
    polish is ten Gauss-Newton steps in float32 on both sides, with a
    forward-mode Jacobian there and an analytic one here)."""
    xi, xj, R, t, _ = make_two_view(rng, n=400, noise=2e-4,
                                    outlier_frac=outlier_frac)
    N, H = len(xi), 256
    valid = rng.random(N) < 0.9
    key = jax.random.PRNGKey(3)
    pri = np.asarray(jax.random.uniform(key, (H, N), dtype=jnp.float32))
    rj = jepi.find_E_ransac(key, jj(xi), jj(xj), jnp.asarray(valid),
                            num_hypotheses=H, sampson_thresh=1e-5,
                            min_inliers=50)
    with torch.no_grad():
        rt = epipolar.find_E_ransac(None, tt(xi), tt(xj),
                                    torch.as_tensor(valid),
                                    num_hypotheses=H, sampson_thresh=1e-5,
                                    min_inliers=50, pri=tt(pri))
    assert bool(rt.ok) == bool(rj.ok) is True
    mj, mt = np.asarray(rj.inlier_mask), rt.inlier_mask.numpy()
    assert (mj == mt).mean() >= 0.99
    assert abs(int(rt.num_inliers) - int(rj.num_inliers)) \
        <= 0.02 * int(rj.num_inliers)
    assert rt.num_inliers.dtype == torch.int32
    np.testing.assert_allclose(rt.R.numpy(), np.asarray(rj.R), atol=1e-3)
    np.testing.assert_allclose(rt.t.numpy(), np.asarray(rj.t), atol=2e-3)
    assert not mt[~valid].any()
    # and it is the true pose (the translation's direction is the weakly
    # observed part at this baseline and noise: within 5 degrees)
    t_unit = t / np.linalg.norm(t)
    assert abs(float(rt.t.numpy() @ t_unit)) > 0.996


def test_torch_find_E_ransac_generator_is_deterministic(rng):
    """Without ``pri`` the priorities come from the torch.Generator: same
    seed, same result; the generator advances between calls."""
    xi, xj, _, _, _ = make_two_view(rng, n=200, noise=2e-4,
                                    outlier_frac=0.2)
    valid = torch.ones(200, dtype=torch.bool)

    def run(seed):
        g = torch.Generator()
        g.manual_seed(seed)
        with torch.no_grad():
            r = epipolar.find_E_ransac(g, tt(xi), tt(xj), valid,
                                       num_hypotheses=64,
                                       sampson_thresh=1e-5, min_inliers=30)
        return r, g

    r1, g1 = run(5)
    r2, _ = run(5)
    assert torch.equal(r1.R, r2.R) and torch.equal(r1.inlier_mask,
                                                   r2.inlier_mask)
    assert bool(r1.ok)
    g0 = torch.Generator()
    g0.manual_seed(5)
    assert not torch.equal(g0.get_state(), g1.get_state())


# ---------------------------------------------------------------------------
# PnP / triangulation / BA
# ---------------------------------------------------------------------------


def make_pnp(rng, n=200, noise=1e-4, outliers=0):
    X = rng.standard_normal((n, 3)) * np.array([0.4, 0.4, 0.25]) \
        + np.array([0, 0, 4.0])
    w = rng.standard_normal(3) * 0.3
    R = lie.so3_exp(torch.as_tensor(w)).numpy()
    t = rng.standard_normal(3) * 0.3 + np.array([0, 0, 0.2])
    Xc = X @ R.T + t
    obs = Xc[:, :2] / Xc[:, 2:3] + rng.standard_normal((n, 2)) * noise
    if outliers:
        obs[:outliers] += rng.uniform(0.05, 0.2, (outliers, 2))
    return R, t, X, obs


def test_torch_refine_pose_matches_jax_batched_starts(rng):
    """Two starts refined as one batch (the keyframe branch's dual-init
    PnP) against jax.vmap of the JAX function: same accept/reject
    sequence, so poses agree to 1e-4 and inlier counts exactly or within
    one point on the 3-delta boundary."""
    R, t, X, obs = make_pnp(rng, noise=2e-4, outliers=20)
    valid = rng.random(len(X)) < 0.9
    dw = np.array([[0.03, -0.02, 0.01], [-0.05, 0.04, 0.02]])
    R0 = np.stack([lie.so3_exp(torch.as_tensor(d)).numpy() @ R for d in dw])
    t0 = np.stack([t + 0.05, t - 0.03])
    Rj, tj, ij = jax.vmap(lambda a, b: jpnp.refine_pose(
        a, b, jj(X), jj(obs), jnp.asarray(valid), iters=10,
        huber_delta=2e-3))(jj(R0), jj(t0))
    with torch.no_grad():
        Rt, ttt, it = pnp.refine_pose(tt(R0), tt(t0), tt(X), tt(obs),
                                      torch.as_tensor(valid), iters=10,
                                      huber_delta=2e-3)
    np.testing.assert_allclose(Rt.numpy(), np.asarray(Rj), atol=1e-4)
    np.testing.assert_allclose(ttt.numpy(), np.asarray(tj), atol=2e-4)
    assert np.abs(it["inliers"].numpy() - np.asarray(ij["inliers"])).max() <= 1
    np.testing.assert_allclose(it["cost"].numpy(), np.asarray(ij["cost"]),
                               rtol=2e-3)
    np.testing.assert_allclose(it["cost0"].numpy(), np.asarray(ij["cost0"]),
                               rtol=1e-4)
    assert it["inliers"].dtype == torch.int32
    # a single start (no batch dim) works too and gives the same pose
    with torch.no_grad():
        R1, t1, i1 = pnp.refine_pose(tt(R0[0]), tt(t0[0]), tt(X), tt(obs),
                                     torch.as_tensor(valid), iters=10,
                                     huber_delta=2e-3)
    np.testing.assert_allclose(R1.numpy(), Rt[0].numpy(), atol=1e-6)
    np.testing.assert_allclose(R1.numpy(), R, atol=2e-3)


def test_torch_triangulate_dlt_matches_jax(rng):
    n = 300
    X = rng.standard_normal((n, 3)) * 0.4 + np.array([0, 0, 4.0])
    Ra = np.stack([lie.so3_exp(torch.as_tensor(
        rng.standard_normal(3) * 0.05)).numpy() for _ in range(n)])
    Rb = np.stack([lie.so3_exp(torch.as_tensor(
        rng.standard_normal(3) * 0.05)).numpy() for _ in range(n)])
    ta = rng.standard_normal((n, 3)) * 0.1
    tb = rng.standard_normal((n, 3)) * 0.1 + np.array([0.4, 0, 0])
    pa = np.einsum("nij,nj->ni", Ra, X) + ta
    pb = np.einsum("nij,nj->ni", Rb, X) + tb
    xa = pa[:, :2] / pa[:, 2:] + rng.standard_normal((n, 2)) * 1e-4
    xb = pb[:, :2] / pb[:, 2:] + rng.standard_normal((n, 2)) * 1e-4
    args = (Ra, ta, xa, Rb, tb, xb)
    Xj, zaj, zbj = jtri.triangulate_dlt(*(jj(a) for a in args))
    Xt, zat, zbt = triangulate.triangulate_dlt(*(tt(a) for a in args))
    # normal equations of a 4x3 system in float32 (condition ~1e3 squared):
    # both sides are within ~1e-3 of each other and of the truth
    np.testing.assert_allclose(Xt.numpy(), np.asarray(Xj), atol=2e-3)
    np.testing.assert_allclose(zat.numpy(), np.asarray(zaj), atol=2e-3)
    np.testing.assert_allclose(zbt.numpy(), np.asarray(zbj), atol=2e-3)
    assert np.median(np.abs(Xt.numpy() - X)) < 5e-3
    ej = jtri.reprojection_error(jj(Ra), jj(ta), Xj, jj(xa))
    et = triangulate.reprojection_error(tt(Ra), tt(ta),
                                        torch.as_tensor(np.asarray(Xj)),
                                        tt(xa))
    np.testing.assert_allclose(et.numpy(), np.asarray(ej), atol=1e-6)


def make_ba_problem(rng, F=4, P=120, noise=1e-4, perturb=0.02, step=0.15):
    X_gt = rng.standard_normal((P, 3)) * np.array([0.4, 0.4, 0.25]) \
        + np.array([0, 0, 4.0])
    R_gt, t_gt = [], []
    for f in range(F):
        ang = step * (f - F / 2)
        Rm = lie.so3_exp(torch.tensor([0.0, ang, 0.0],
                                      dtype=torch.float64)).numpy()
        C = np.array([4.0 * np.sin(ang), 0.2 * f, 4.0 - 4.0 * np.cos(ang)])
        R_gt.append(Rm)
        t_gt.append(-Rm @ C)
    R_gt, t_gt = np.stack(R_gt), np.stack(t_gt)
    cam, pid, obs = [], [], []
    for f in range(F):
        Xc = X_gt @ R_gt[f].T + t_gt[f]
        proj = Xc[:, :2] / Xc[:, 2:3]
        cam += [f] * P
        pid += list(range(P))
        obs.append(proj + rng.standard_normal((P, 2)) * noise)
    obs = np.concatenate(obs)
    R0, t0 = [R_gt[0]], [t_gt[0]]
    for f in range(1, F):
        dw = rng.standard_normal(3) * perturb
        R0.append(lie.so3_exp(torch.as_tensor(dw)).numpy() @ R_gt[f])
        t0.append(t_gt[f] + rng.standard_normal(3) * perturb)
    X0 = X_gt + rng.standard_normal((P, 3)) * perturb
    M = len(obs)
    obs_valid = rng.random(M) < 0.9
    point_valid = rng.random(P) < 0.95
    leaves = dict(R_wc=np.stack(R0).astype(F32), t_wc=np.stack(t0).astype(F32),
                  X=X0.astype(F32), cam_idx=np.asarray(cam, np.int32),
                  pid_idx=np.asarray(pid, np.int32), obs=obs.astype(F32),
                  obs_valid=obs_valid, point_valid=point_valid)
    return leaves, R_gt, t_gt


def test_torch_bundle_adjust_matches_jax(rng):
    """Window BA on the SoA path, same problem on both sides: cost0 equal
    to 1e-5 relative (one pass of sums), the linearization's blocks to
    1e-4, and after 5 LM steps the same accept/reject history — poses
    within 1e-4, points within 1e-3, cost within 1 %.  The one-hot
    reductions are float32 matmuls on both sides whose summation order is
    the library's; atomics are not involved on the CPU, and on the card
    torch.matmul is deterministic for a fixed shape."""
    leaves, R_gt, t_gt = make_ba_problem(rng)
    pj = jba.BAProblem(**{k: jnp.asarray(v) for k, v in leaves.items()})
    pt = ba.BAProblem(**{k: torch.as_tensor(v) for k, v in leaves.items()})
    hd = 2e-3
    c0j = float(jba.ba_cost_soa(pj, hd))
    c0t = float(ba.ba_cost(pt, hd))
    assert abs(c0t - c0j) <= 1e-5 * c0j
    Hj, bj, Aj = jba._linearize_soa(pj, hd)
    Ht, bt, At = ba._linearize_soa(pt, hd)
    np.testing.assert_allclose(Ht.numpy(), np.asarray(Hj), rtol=1e-4,
                               atol=1e-4 * float(np.abs(Hj).max()))
    np.testing.assert_allclose(At.numpy(), np.asarray(Aj), rtol=1e-4,
                               atol=1e-4 * float(np.abs(Aj).max()))
    lam = 1e-3
    dxj, dXj = jba._solve_schur_soa(Hj, bj, Aj, pj.point_valid,
                                    jnp.float32(lam), 1)
    dxt, dXt = ba._solve_schur_soa(tt(Hj), tt(bj), tt(Aj), pt.point_valid,
                                   torch.tensor(lam), 1)
    np.testing.assert_allclose(dxt.numpy(), np.asarray(dxj), rtol=2e-3,
                               atol=2e-5)
    np.testing.assert_allclose(dXt.numpy(), np.asarray(dXj), rtol=2e-3,
                               atol=2e-5)

    Rj, tj, Xj, ij = jba.bundle_adjust(pj, iters=5, huber_delta=hd, n_fix=1)
    with torch.no_grad():
        Rt, t_t, Xt, it = ba.bundle_adjust(pt, iters=5, huber_delta=hd,
                                           n_fix=1)
    assert abs(float(it["cost0"]) - float(ij["cost0"])) <= 1e-5 * c0j
    assert float(it["cost"]) < 0.5 * float(it["cost0"])
    np.testing.assert_allclose(float(it["cost"]), float(ij["cost"]),
                               rtol=1e-2)
    np.testing.assert_allclose(Rt.numpy(), np.asarray(Rj), atol=1e-4)
    np.testing.assert_allclose(t_t.numpy(), np.asarray(tj), atol=2e-4)
    pv = leaves["point_valid"]
    np.testing.assert_allclose(Xt.numpy()[pv], np.asarray(Xj)[pv], atol=1e-3)
    np.testing.assert_array_equal(Rt[0].numpy(), leaves["R_wc"][0])  # gauge
    # frozen points
    with torch.no_grad():
        _, _, Xf, _ = ba.bundle_adjust(pt, iters=2, huber_delta=hd,
                                       update_points=False)
    np.testing.assert_array_equal(Xf.numpy(), leaves["X"])


def test_torch_ba_cost_soa_matches_jax(rng):
    """``ba_cost_soa`` on tests/test_ba.py:60-77's problem (every regime of
    the robust cost: inliers, Huber tail, gross outlier, a point behind
    every camera, invalid observations), float64 on both sides: equal to
    JAX's ``ba_cost_soa`` and its tensor-form ``ba_cost`` within 1e-12
    relative (the same sums, in another order)."""
    from test_ba import make_ba_problem as make_jax_ba_problem

    prob, *_ = make_jax_ba_problem(rng, noise=1e-3)
    obs = np.asarray(prob.obs).copy()
    obs[5] += 0.5        # gross outlier (past _CUTOFF*delta)
    obs[17] += 0.03      # Huber linear tail
    X = np.asarray(prob.X).copy()
    X[3] = [0.0, 0.0, -5.0]  # behind every camera
    obs_valid = np.asarray(prob.obs_valid).copy()
    obs_valid[40:60] = False
    leaves = {k: np.asarray(v) for k, v in prob._asdict().items()}
    leaves.update(obs=obs, X=X, obs_valid=obs_valid)
    assert leaves["X"].dtype == np.float64
    pj = jba.BAProblem(**{k: jnp.asarray(v) for k, v in leaves.items()})
    pt = ba.BAProblem(**{k: torch.as_tensor(v) for k, v in leaves.items()})
    for delta in (1e-2, 2e-3):
        c_soa = float(jba.ba_cost_soa(pj, delta))
        c_t = ba.ba_cost_soa(pt, delta)
        assert c_t.dtype == torch.float64
        assert float(c_t) == pytest.approx(c_soa, rel=1e-12)
        assert float(c_t) == pytest.approx(float(jba.ba_cost(pj, delta)),
                                           rel=1e-12)


def test_torch_pnp_cost_float64_matches_jax(rng):
    """``pnp_cost`` in float64 with every regime of the robust cost
    (inliers, Huber tail, gross outlier, points behind the camera, invalid
    observations): equal to JAX's within 1e-12 relative, the behind-camera
    penalty (2 cap + 1) kept in float64 as JAX keeps it."""
    R, t, X, obs = make_pnp(rng, n=60, noise=1e-3)
    obs[5] += 0.5        # gross outlier
    obs[17] += 0.03      # Huber linear tail
    X[3] = [0.0, 0.0, -5.0]  # behind the camera
    X[9] = [0.1, 0.2, -3.0]
    valid = np.ones(60, bool)
    valid[40:50] = False
    for delta in (1e-2, 2e-3):
        cj = float(jpnp.pnp_cost(jnp.asarray(R), jnp.asarray(t),
                                 jnp.asarray(X), jnp.asarray(obs),
                                 jnp.asarray(valid), delta))
        ct = pnp.pnp_cost(*(torch.as_tensor(a) for a in (R, t, X, obs)),
                          torch.as_tensor(valid), delta)
        assert ct.dtype == torch.float64
        assert float(ct) == pytest.approx(cj, rel=1e-12)


def test_torch_bundle_adjust_refuses_large_problems():
    """F*P > 8192 no longer raises: such a problem takes the AoS path
    (held to the JAX package in tests/test_torch_ba_aos.py).  With no valid
    observation the cost is 0, no step is accepted, and the poses and
    points come back as they went in."""
    z = torch.zeros
    p = ba.BAProblem(R_wc=torch.eye(3).repeat(9, 1, 1), t_wc=z((9, 3)),
                     X=z((1024, 3)), cam_idx=z(4, dtype=torch.int32),
                     pid_idx=z(4, dtype=torch.int32), obs=z((4, 2)),
                     obs_valid=z(4, dtype=torch.bool),
                     point_valid=z(1024, dtype=torch.bool))
    R, t, X, info = ba.bundle_adjust(p, iters=2)
    assert float(info["cost0"]) == 0.0 and float(info["cost"]) == 0.0
    assert torch.equal(R, p.R_wc) and torch.equal(t, p.t_wc)
    assert torch.equal(X, p.X)


def test_torch_umeyama_and_descriptor_match_jax(rng):
    src = rng.standard_normal((40, 3))
    Rm = lie.so3_exp(torch.tensor([0.3, -0.2, 0.5],
                                  dtype=torch.float64)).numpy()
    dst = 2.5 * src @ Rm.T + np.array([1.0, -2.0, 0.5]) \
        + rng.standard_normal((40, 3)) * 1e-3
    rj = jume.ate(jnp.asarray(src), jnp.asarray(dst), with_scale=True)
    rt = umeyama.ate(src, dst, with_scale=True)
    for k in ("rmse", "mean", "median", "max", "scale"):
        np.testing.assert_allclose(float(rt[k]), float(rj[k]), rtol=1e-9)
    assert rt["per_point"].dtype == torch.float64
    s, R_, t_ = umeyama.umeyama(src.astype(F32), dst.astype(F32),
                                with_scale=False)
    assert float(s) == 1.0 and R_.dtype == torch.float64
    img = (rng.random((480, 640)) * 255).astype(F32)
    dj = np.asarray(jdesc.global_desc_32(jj(img)))
    dt = descriptors.global_desc_32(tt(img)).numpy()
    assert dt.shape == (descriptors.DESC_DIM,)
    np.testing.assert_allclose(dt, dj, atol=1e-6)


# ---------------------------------------------------------------------------
# the port's own copies of the stdlib / numpy modules
# ---------------------------------------------------------------------------


def test_torch_config_copy_has_same_precedence(tmp_path):
    raw = {"common": {"klt": {"max_tracks": 100, "win_size": [11, 11]},
                      "ba": {"lambda": 0.5}},
           "python": {"klt": {"max_tracks": 200}},
           "cpp": {"klt": {"max_tracks": 300}, "loop_closure": {
               "min_inliers": 7}},
           "tpu": {"klt": {"iters": 3}},
           "system": {"frames": 9, "translation_mode": "full"}}
    path = tmp_path / "config.json"
    path.write_text(json.dumps(raw))
    ov = {"klt.pyr_levels": 5, "ransac.seed": 4}
    a = jconfig.load_config(path, overrides=ov)
    b = config.load_config(path, overrides=ov)
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert b.klt.max_tracks == 300 and b.klt.win_radius == 5
    assert b.klt.iters == 3 and b.klt.pyr_levels == 5
    assert dataclasses.asdict(jconfig.SystemConfig()) \
        == dataclasses.asdict(config.SystemConfig())


def test_torch_synthetic_and_artifacts_copies_are_identical(tmp_path, rng):
    """Same rendered frame, byte-identical CSV/PLY for the same inputs."""
    spec_kw = dict(n_frames=3, width=160, height=120, fx=380.0, fy=380.0,
                   arc_deg=20.0, texture_size=256)
    sj, st = jsyn.SyntheticRingSpec(**spec_kw), \
        synthetic.SyntheticRingSpec(**spec_kw)
    Kj, Rsj, tsj, _, _ = jsyn.make_ring_cameras(sj)
    Kt, Rst, tst, _, _ = synthetic.make_ring_cameras(st)
    np.testing.assert_array_equal(Kj, Kt)
    fj = jsyn.render_frame(sj, Kj, Rsj[1], tsj[1], jsyn._make_texture(sj))
    ft = synthetic.render_frame(st, Kt, Rst[1], tst[1],
                                synthetic._make_texture(st))
    np.testing.assert_array_equal(fj, ft)

    pts = rng.standard_normal((50, 3))
    rows = [dict(kf_id=i, frame_idx=2 * i, image=f"im{i}.png", x=float(i),
                 y=0.5, z=-1.25e-7, lat=float("nan"), lon=3.0)
            for i in range(4)]
    edges = [dict(i=0, j=1, kind="odom", rvec=np.array([0.1, 0.2, 0.3]),
                  t=np.array([1.0, 0.0, 1e-9]))]
    for mod, d in ((jart, tmp_path / "a"), (artifacts, tmp_path / "b")):
        d.mkdir()
        mod.write_ply_xyz(d / "p.ply", pts)
        mod.write_csv_centers(d / "c.csv", rows)
        mod.write_posegraph_edges(d / "e.csv", edges)
    for name in ("p.ply", "c.csv", "e.csv"):
        assert (tmp_path / "a" / name).read_bytes() \
            == (tmp_path / "b" / name).read_bytes()
    np.testing.assert_allclose(artifacts.read_ply_xyz(tmp_path / "b/p.ply"),
                               pts, atol=1e-5)
    w = rng.standard_normal(3)
    np.testing.assert_array_equal(np_geom.so3_exp(w), jgeom.so3_exp(w))
    np.testing.assert_array_equal(np_geom.so3_log(np_geom.so3_exp(w)),
                                  jgeom.so3_log(jgeom.so3_exp(w)))

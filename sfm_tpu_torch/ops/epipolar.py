"""Essential-matrix estimation: batched 8-point + LO-RANSAC + pose recovery.

Counterpart of sfm_tpu/ops/epipolar.py (reference: cpp/src/
templering_sfm.cpp:609-761 — ``eight_point_E``, ``sampson_err``,
``find_E_ransac`` with sequential hypotheses, E→(R,t) with 4-candidate
cheirality voting).

All H hypotheses run as one tensor program — (H,8) samples, (H,8,9)
design matrices, one batched SVD, one (H,N) Sampson scoring.  Where the
JAX twin ``vmap``s a per-candidate function, the batch dimension is
written out here.  Convention: points are K-normalized; x_j^T E x_i = 0
with E = [t]_x R and x_j ~ R x_i + t.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from sfm_tpu_torch.ops import lie, linalg
from sfm_tpu_torch.ops.features import top_k_stable


class RelPose(NamedTuple):
    """Relative pose i->j (x_j = R x_i + t, ‖t‖=1) + inlier stats.
    ref: cpp RelPose struct at cpp:641-645."""

    R: torch.Tensor  # (3,3)
    t: torch.Tensor  # (3,)
    E: torch.Tensor  # (3,3)
    inlier_mask: torch.Tensor  # (N,) bool
    num_inliers: torch.Tensor  # () int32
    ok: torch.Tensor  # () bool


def normalize_by_K(K, pts):
    """Pixel -> K-normalized homogeneous-2D coords (ref cpp:498-501)."""
    fx, fy = K[0, 0], K[1, 1]
    cx, cy = K[0, 2], K[1, 2]
    s = K[0, 1]
    y = (pts[..., 1] - cy) / fy
    x = (pts[..., 0] - cx - s * y) / fx
    return torch.stack([x, y], dim=-1)


def _design_row(xi, xj):
    """Row of the epipolar constraint x_j^T E x_i = 0 (ref cpp:612-621)."""
    xi1, yi1 = xi[..., 0], xi[..., 1]
    xj1, yj1 = xj[..., 0], xj[..., 1]
    one = torch.ones_like(xi1)
    return torch.stack(
        [xj1 * xi1, xj1 * yi1, xj1, yj1 * xi1, yj1 * yi1, yj1, xi1, yi1, one],
        dim=-1,
    )


def eight_point_E(xi, xj, weights=None):
    """Batched 8-point: (...,M,2)x2 -> (...,3,3) rank-2 essential matrices.

    SVD null vector of the (M,9) design, projected to the essential cone
    with equalized singular values."""
    A = _design_row(xi, xj)  # (...,M,9)
    if weights is not None:
        A = A * weights[..., None]
    e = linalg.nullvec_lstsq(A)
    E = e.reshape(*e.shape[:-1], 3, 3)
    u, s, vt = linalg.svd3_jacobi(E)
    sbar = 0.5 * (s[..., 0] + s[..., 1])
    s2 = torch.stack([sbar, sbar, torch.zeros_like(sbar)], dim=-1)
    return (u * s2[..., None, :]) @ vt


def _homog(x):
    return torch.cat([x, torch.ones_like(x[..., :1])], dim=-1)


def sampson_error(E, xi, xj, return_den: bool = False):
    """First-order geometric error (ref: cpp:629-638). xi/xj (...,N,2)."""
    pi = _homog(xi)  # (...,N,3)
    pj = _homog(xj)
    Epi = torch.einsum("...ij,...nj->...ni", E, pi)
    Etpj = torch.einsum("...ji,...nj->...ni", E, pj)
    num = torch.sum(pj * Epi, dim=-1) ** 2
    den = (Epi[..., 0] ** 2 + Epi[..., 1] ** 2
           + Etpj[..., 0] ** 2 + Etpj[..., 1] ** 2)
    err = num / torch.clamp(den, min=1e-18)
    if return_den:
        return err, den
    return err


def decompose_E(E):
    """E -> 4 candidate (R, t) pairs, det-fixed (ref: cpp:680-712)."""
    u, _, vt = linalg.svd3_jacobi(E)
    # ensure proper rotations
    u = u * torch.sign(linalg.det3(u))[..., None, None]
    vt = vt * torch.sign(linalg.det3(vt))[..., None, None]
    W = torch.tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]],
                     dtype=E.dtype, device=E.device)
    R1 = u @ W @ vt
    R2 = u @ W.T @ vt
    t = u[..., :, 2]
    Rs = torch.stack([R1, R1, R2, R2], dim=-3)
    ts = torch.stack([t, -t, t, -t], dim=-2)
    return Rs, ts


def triangulate_two_view(R, t, xi, xj):
    """Linear two-view triangulation in the cam-i frame.

    P_i=[I|0], P_j=[R|t]; batched DLT over points (ref: the inline DLT at
    cpp:714-754 used for cheirality voting). xi/xj (...,N,2) normalized.
    Returns X_i (...,N,3) and depths (z_i, z_j)."""
    eye = torch.eye(3, dtype=R.dtype, device=R.device).expand(
        *R.shape[:-2], 3, 3)
    zero = torch.zeros((*R.shape[:-2], 3), dtype=R.dtype, device=R.device)
    Pi = torch.cat([eye, zero[..., None]], dim=-1)  # (...,3,4)
    Pj = torch.cat([R, t[..., None]], dim=-1)

    def rows(P, x):
        # (...,N,2,4): [x*P3 - P1 ; y*P3 - P2]
        P = P[..., None, :, :]  # (...,1,3,4)
        r1 = x[..., 0:1] * P[..., 2, :] - P[..., 0, :]
        r2 = x[..., 1:2] * P[..., 2, :] - P[..., 1, :]
        return torch.stack([r1, r2], dim=-2)

    A = torch.cat([rows(Pi, xi), rows(Pj, xj)], dim=-2)  # (...,N,4,4)
    Xh = linalg.nullvec_lstsq(A)  # (...,N,4)
    w = Xh[..., 3]
    w = torch.where(w.abs() < 1e-18, torch.full_like(w, 1e-18), w)
    X = Xh[..., :3] / w[..., None]
    zi = X[..., 2]
    zj = torch.einsum("...ij,...nj->...ni", R, X)[..., 2] + t[..., None, 2]
    return X, zi, zj


def _tangent_basis(t):
    """(...,3,2) orthonormal basis of the plane orthogonal to unit t."""
    ex = torch.tensor([1.0, 0.0, 0.0], dtype=t.dtype, device=t.device)
    ey = torch.tensor([0.0, 1.0, 0.0], dtype=t.dtype, device=t.device)
    a = torch.where(t[..., :1].abs() < 0.9, ex, ey)
    b1 = torch.linalg.cross(t, a, dim=-1)
    b1 = b1 / torch.linalg.vector_norm(b1, dim=-1, keepdim=True)
    b2 = torch.linalg.cross(t, b1, dim=-1)
    return torch.stack([b1, b2], dim=-1)


def _polish_rt(R0, t0, xi, xj, valid, thr, iters: int = 10,
               damping: float = 1e-8):
    """Gauss-Newton on the essential manifold, batched over candidates:
    R0 (C,3,3), t0 (C,3); xi/xj (N,2); valid (N,).

    Parameterizes E = [t]x R with a 5-dof update (so3 twist + 2-dof
    tangent of unit t) and minimizes the robust Sampson distance
    r = sqrt(max(err, 1e-18)).  The JAX twin takes the (N,5) Jacobian by
    forward-mode differentiation at p = 0; here it is written out: with
    E(p) = hat(t(p)) exp(hat(p[:3])) R,
      dE/dp_k = hat(t) hat(e_k) R               k = 0..2
      dE/dp_k = hat(d t/d p_k) R                k = 3, 4
    (d t/d p_k the derivative of the re-normalized t + B p[3:]), and the
    chain rule through err = num/den and the two clamps."""
    dtype = xi.dtype
    dev = xi.device
    pi = _homog(xi)  # (N,3)
    pj = _homog(xj)
    eye3 = torch.eye(3, dtype=dtype, device=dev)
    gens = lie.hat(eye3)  # (3,3,3): hat(e_k)
    eye5 = torch.eye(5, dtype=dtype, device=dev)
    R, t = R0, t0
    for _ in range(iters):
        B = _tangent_basis(t)  # (C,3,2)
        n = torch.linalg.vector_norm(t, dim=-1, keepdim=True)  # (C,1)
        tn = t / n
        That = lie.hat(tn)  # (C,3,3)
        E = That @ R
        # residual at p = 0
        Epi = torch.einsum("cij,nj->cni", E, pi)
        Etpj = torch.einsum("cji,nj->cni", E, pj)
        s = torch.sum(pj * Epi, dim=-1)  # (C,N)
        num = s * s
        den = (Epi[..., 0] ** 2 + Epi[..., 1] ** 2
               + Etpj[..., 0] ** 2 + Etpj[..., 1] ** 2)
        den_c = torch.clamp(den, min=1e-18)
        err = num / den_c
        r0 = torch.sqrt(torch.clamp(err, min=1e-18))
        # dE/dp: (C,5,3,3)
        dE_w = torch.einsum("cij,kjl,clm->ckim", That, gens, R)
        Bt = B.transpose(-1, -2)  # (C,2,3)
        dtn = Bt / n[..., None] - t[:, None, :] * (
            torch.sum(Bt * t[:, None, :], dim=-1, keepdim=True)
            / (n ** 3)[..., None])
        dE_t = lie.hat(dtn) @ R[:, None]
        dE = torch.cat([dE_w, dE_t], dim=1)
        dEpi = torch.einsum("ckij,nj->ckni", dE, pi)  # (C,5,N,3)
        dEtpj = torch.einsum("ckji,nj->ckni", dE, pj)
        ds = torch.sum(pj * dEpi, dim=-1)  # (C,5,N)
        dnum = 2.0 * s[:, None] * ds
        dden = 2.0 * (Epi[:, None, :, 0] * dEpi[..., 0]
                      + Epi[:, None, :, 1] * dEpi[..., 1]
                      + Etpj[:, None, :, 0] * dEtpj[..., 0]
                      + Etpj[:, None, :, 1] * dEtpj[..., 1])
        dden = torch.where((den > 1e-18)[:, None], dden,
                           torch.zeros_like(dden))
        derr = dnum / den_c[:, None] - num[:, None] * dden / (
            den_c * den_c)[:, None]
        dr = torch.where((err > 1e-18)[:, None],
                         derr / (2.0 * r0)[:, None], torch.zeros_like(derr))
        J = dr.transpose(-1, -2)  # (C,N,5)

        mask = valid[None] & (r0 * r0 < thr)
        nan = torch.full_like(r0, float("nan"))
        med = linalg.nanmedian(torch.where(mask, r0, nan), dim=-1)
        med = torch.where(torch.isnan(med), torch.sqrt(thr), med)
        w = (mask & (r0 < 3.0 * med[:, None] + 1e-15)).to(dtype)
        Jw = J * w[..., None]
        H = Jw.transpose(-1, -2) @ J + damping * eye5
        g = torch.einsum("cna,cn->ca", Jw, r0)
        dp = -linalg.solve_psd_small(H, g, jitter=1e-12)
        R = lie.so3_exp(dp[:, :3]) @ R
        tn2 = t + torch.einsum("cij,cj->ci", B, dp[:, 3:])
        t = tn2 / torch.linalg.vector_norm(tn2, dim=-1, keepdim=True)
    return R, t


def _front_votes(Rs, ts, xi, xj, inlier_mask, max_votes: int = 32):
    """Count triangulated inliers in front of both cameras for each (R,t)
    candidate. Rs (...,C,3,3), ts (...,C,3), inlier_mask (...,N) with the
    same leading dims; xi/xj (N,2). Returns (votes (...,C), n_available
    (...))."""
    # deterministically take the first ``max_votes`` inliers: sort key puts
    # inliers first, stable order otherwise
    key = torch.where(inlier_mask, 0, 1)
    order = torch.argsort(key, dim=-1, stable=True)
    idx = order[..., :max_votes]
    sel_valid = torch.gather(inlier_mask, -1, idx)
    vi = xi[idx]  # (...,V,2)
    vj = xj[idx]
    _, zi, zj = triangulate_two_view(Rs, ts, vi[..., None, :, :],
                                     vj[..., None, :, :])  # (...,C,V)
    votes = torch.sum(((zi > 0) & (zj > 0)) & sel_valid[..., None, :],
                      dim=-1)
    return votes, torch.sum(sel_valid, dim=-1)


def _take(x, idx):
    """x[..., idx, ...] along the dim right after idx's dims: x (...,C,*),
    idx (...) -> (...,*)."""
    nb = idx.dim()
    tail = x.shape[nb + 1:]
    ix = idx.reshape(*idx.shape, 1, *([1] * len(tail))).expand(
        *idx.shape, 1, *tail)
    return torch.gather(x, nb, ix).squeeze(nb)


def _cheirality_vote(Rs, ts, xi, xj, inlier_mask, max_votes: int = 32):
    """Pick the (R,t) candidate with most points in front of both cameras
    (ref: cpp:714-754 votes with <=20 triangulated inliers)."""
    votes, _ = _front_votes(Rs, ts, xi, xj, inlier_mask, max_votes)
    best = torch.argmax(votes, dim=-1)
    return _take(Rs, best), _take(ts, best), _take(votes, best)


def sample_priorities(generator, H: int, N: int, device):
    """(H,N) uniform sampling priorities from ``generator`` (a
    ``torch.Generator`` on ``device``)."""
    return torch.rand((H, N), generator=generator, dtype=torch.float32,
                      device=device)


def find_E_ransac(
    generator,
    xi,
    xj,
    valid,
    num_hypotheses: int = 1024,
    sampson_thresh: float = 1e-3,
    min_inliers: int = 60,
    max_votes: int = 32,
    refine: bool = True,
    lo_starts: int = 16,
    pri=None,
):
    """Batched-hypothesis LO-RANSAC for the essential matrix.

    Three fully-batched stages:
      1. H minimal 8-point hypotheses scored by inlier count;
      2. the top ``lo_starts`` hypotheses each refined by manifold
         Gauss-Newton on the robust Sampson cost (multi-start local
         optimization);
      3. final model chosen by truncated (MSAC) cost behind a cheirality
         gate.

    Args:
      generator: ``torch.Generator`` on the tensors' device, the source of
        the (H,N) sampling priorities; ignored when ``pri`` is given.
      xi, xj: (N,2) K-normalized correspondences.
      valid: (N,) bool mask (fixed-capacity padding).
      pri: optional (H,N) f32 sampling priorities (tests hand the same
        array to this function and to its JAX twin).
    Returns RelPose.
    """
    N = xi.shape[0]
    H = num_hypotheses
    dtype = xi.dtype
    dev = xi.device
    thr = torch.as_tensor(sampson_thresh, dtype=dtype, device=dev)

    # Sample (H,8) distinct valid indices: per-hypothesis random priority
    # with invalid entries at -inf, take top-8 (ties: lower index first).
    if pri is None:
        pri = sample_priorities(generator, H, N, dev)
    ninf = torch.full_like(pri, float("-inf"))
    pri = torch.where(valid[None, :], pri, ninf)
    _, sample_idx = top_k_stable(pri, 8)  # (H,8)

    E = eight_point_E(xi[sample_idx], xj[sample_idx])  # (H,3,3)
    err = sampson_error(E, xi[None], xj[None])  # (H,N)
    inl = (err < thr) & valid[None]
    counts = torch.sum(inl, dim=-1)

    if refine:
        K = lo_starts
        # diverse multi-start: half the slots take the best hypotheses by
        # count, half stride across the whole ranking
        order = torch.argsort(-counts, stable=True)
        k_top = K // 2
        stride = max(H // max(K - k_top, 1), 1)
        pick = torch.cat([order[:k_top], order[::stride][: K - k_top]])
        Ek = E[pick]  # (K,3,3)
        mask_k = inl[pick]  # (K,N)
        # per-candidate cheirality vote picks the physical (R,t) branch
        Rk, tk, _ = _cheirality_vote(*decompose_E(Ek), xi, xj, mask_k,
                                     max_votes)
        # multi-start manifold GN polish (batched over candidates)
        Rk, tk = _polish_rt(Rk, tk, xi, xj, valid, thr)
        Ek = torch.matmul(lie.hat(tk), Rk)
        err_k = sampson_error(Ek, xi[None], xj[None])
        mask_k = (err_k < thr) & valid[None]
        # truncated (MSAC) cost discriminates converged local minima where
        # raw inlier counts cannot
        cost = torch.sum(
            torch.where(valid[None], torch.minimum(err_k, thr),
                        torch.zeros_like(err_k)), dim=-1)
        # cheirality gate AFTER polish: the degenerate (rotation-absorbed)
        # basin triangulates a large fraction of inliers behind a camera
        vote_cap = 4 * max_votes
        votes_p, n_avail = _front_votes(Rk[:, None], tk[:, None], xi, xj,
                                        mask_k, vote_cap)
        votes_p = votes_p[:, 0]
        passes = votes_p.to(dtype) >= 0.9 * n_avail.to(dtype)
        gated = torch.where(passes, cost, torch.full_like(cost, float("inf")))
        any_pass = torch.any(passes)
        best_k = torch.where(any_pass, torch.argmin(gated),
                             torch.argmax(votes_p))
        R, t = Rk[best_k], tk[best_k]
        E_best = Ek[best_k]
        mask = mask_k[best_k]
        count = torch.sum(mask)
        votes = votes_p[best_k]
        # guard: if local optimization lost the consensus entirely, fall
        # back to the raw count-best hypothesis
        raw_best = torch.argmax(counts)
        fell_apart = count < torch.clamp(counts[raw_best] // 2, min=8)
        E_fb = E[raw_best]
        R_fb, t_fb, votes_fb = _cheirality_vote(
            *decompose_E(E_fb), xi, xj, inl[raw_best], max_votes)
        R = torch.where(fell_apart, R_fb, R)
        t = torch.where(fell_apart, t_fb, t)
        E_best = torch.where(fell_apart, E_fb, E_best)
        mask = torch.where(fell_apart, inl[raw_best], mask)
        votes = torch.where(fell_apart, votes_fb, votes)
        count = torch.sum(mask)
    else:
        best = torch.argmax(counts)
        E_best = E[best]
        mask = inl[best]
        count = counts[best]
        R, t, votes = _cheirality_vote(*decompose_E(E_best), xi, xj, mask,
                                       max_votes)

    ok = (count >= min_inliers) & (votes > 0)
    return RelPose(R=R, t=t, E=E_best, inlier_mask=mask,
                   num_inliers=count.to(torch.int32), ok=ok)

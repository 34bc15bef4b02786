"""Batched small-matrix linear algebra.

Counterpart of sfm_tpu/ops/linalg.py (reference: cpp/include/linalg.hpp:
133-201 ``jacobi_eig_sym``, cpp/include/dense.hpp:54-119, cpp/src/
templering_sfm.cpp:537-607 ``svd3``/``enforce_rank2``).  Everything
broadcasts over leading batch dims, so thousands of RANSAC hypotheses or
map points run as one tensor program.

The Jacobi algorithms are ported as they are, not replaced by
``torch.linalg.eigh/svd``: their ordering and sign conventions decide
which of the four (R,t) branches of an essential matrix wins downstream.
Where the JAX twin builds new arrays with ``.at[].set``, this code writes
into a private clone in place.
"""

from __future__ import annotations

import math

import torch

from sfm_tpu_torch.utils import debug


def _jacobi_t(tau, apq, tiny: float):
    """tan of the rotation angle from tau = (aqq-app)/(2 apq)."""
    with debug.nan_ok():  # tau*tau may overflow to +inf: then t = 0
        t = torch.sign(tau) / (tau.abs() + torch.sqrt(1.0 + tau * tau))
    return torch.where(apq.abs() < tiny, torch.zeros_like(t), t)


def jacobi_eigh(A, sweeps: int = 18):
    """Batched cyclic Jacobi eigensolver for small symmetric matrices.

    A (...,n,n) symmetric (intended n<=10). Returns (w (...,n) ascending,
    V (...,n,n) with eigenvectors in columns)."""
    n = A.shape[-1]
    A = A.clone()
    V = torch.eye(n, dtype=A.dtype, device=A.device).expand(A.shape).clone()
    tiny = 1e-30
    pairs = [(p, q) for p in range(n - 1) for q in range(p + 1, n)]
    for _ in range(sweeps):
        for p, q in pairs:
            app = A[..., p, p]
            aqq = A[..., q, q]
            apq = A[..., p, q]
            safe = torch.where(apq.abs() < tiny, torch.full_like(apq, tiny),
                               apq)
            theta = 0.5 * (aqq - app) / safe
            t = _jacobi_t(theta, apq, tiny)
            c = (1.0 / torch.sqrt(1.0 + t * t))[..., None]
            s = t[..., None] * c
            # rows p,q
            Ap, Aq = A[..., p, :], A[..., q, :]
            new_p, new_q = c * Ap - s * Aq, s * Ap + c * Aq
            A[..., p, :], A[..., q, :] = new_p, new_q
            # cols p,q
            Ap, Aq = A[..., :, p], A[..., :, q]
            new_p, new_q = c * Ap - s * Aq, s * Ap + c * Aq
            A[..., :, p], A[..., :, q] = new_p, new_q
            Vp, Vq = V[..., :, p], V[..., :, q]
            new_p, new_q = c * Vp - s * Vq, s * Vp + c * Vq
            V[..., :, p], V[..., :, q] = new_p, new_q
    w = torch.diagonal(A, dim1=-2, dim2=-1)
    order = torch.argsort(w, dim=-1, stable=True)
    w = torch.gather(w, -1, order)
    V = torch.gather(V, -1, order[..., None, :].expand(V.shape))
    return w, V


def smallest_eigvec_sym(A):
    """Unit eigenvector of the smallest eigenvalue of symmetric A (...,n,n).

    Used for 8-point null vectors (A^T A, 9x9) and DLT triangulation (4x4),
    replacing jacobi_eig_sym calls at cpp:626, cpp:1504.
    """
    _, vecs = jacobi_eigh(A)
    return vecs[..., :, 0]


def onesided_jacobi(A, sweeps: int = 12):
    """Batched one-sided Jacobi SVD core: orthogonalizes the n columns of
    A (...,m,n) by plane rotations accumulated into V.

    Returns (AV (...,m,n) with mutually orthogonal columns u_k·s_k,
    s (...,n) column norms UNsorted, V (...,n,n)). Unlike the
    eigen-of-AᵀA route this never squares the condition number."""
    n = A.shape[-1]
    A = A.clone()
    V = torch.eye(n, dtype=A.dtype, device=A.device).expand(
        *A.shape[:-2], n, n).clone()
    tiny = 1e-30
    pairs = [(p, q) for p in range(n - 1) for q in range(p + 1, n)]
    for _ in range(sweeps):
        for p, q in pairs:
            ap = A[..., :, p]
            aq = A[..., :, q]
            app = torch.sum(ap * ap, dim=-1)
            aqq = torch.sum(aq * aq, dim=-1)
            apq = torch.sum(ap * aq, dim=-1)
            safe = torch.where(apq.abs() < tiny, torch.full_like(apq, tiny),
                               apq)
            tau = 0.5 * (aqq - app) / safe
            t = _jacobi_t(tau, apq, tiny)
            c = (1.0 / torch.sqrt(1.0 + t * t))[..., None]
            s = t[..., None] * c
            new_p, new_q = c * ap - s * aq, s * ap + c * aq
            A[..., :, p], A[..., :, q] = new_p, new_q
            vp, vq = V[..., :, p], V[..., :, q]
            new_p, new_q = c * vp - s * vq, s * vp + c * vq
            V[..., :, p], V[..., :, q] = new_p, new_q
    s = torch.linalg.vector_norm(A, dim=-2)
    return A, s, V


def nullvec_lstsq(A):
    """Unit null vector of A (...,m,n): right-singular vector of the
    smallest singular value via batched one-sided Jacobi."""
    _, s, V = onesided_jacobi(A)
    idx = torch.argmin(s, dim=-1)
    idx = idx[..., None, None].expand(*idx.shape, V.shape[-2], 1)
    return torch.gather(V, -1, idx)[..., 0]


def nullvec_inviter(A, iters: int = 6):
    """Approximate unit null vector of A (...,m,n) via shift-inverted
    power iteration on B = AᵀA (n small).  Not for the 8-point solver —
    E estimation keeps the one-sided Jacobi's full f32 accuracy."""
    n = A.shape[-1]
    B = torch.einsum("...mi,...mj->...ij", A, A)
    tr = torch.diagonal(B, dim1=-2, dim2=-1).sum(-1)[..., None, None]
    eps = 1e-7 * tr + 1e-30
    Bs = B + eps * torch.eye(n, dtype=A.dtype, device=A.device)
    L = cholesky_unrolled(Bs)
    x = torch.full((*A.shape[:-2], n), 1.0 / math.sqrt(n), dtype=A.dtype,
                   device=A.device)
    for _ in range(iters):
        y = _forward_sub(L, x)
        x = _backward_sub(L.transpose(-1, -2), y)
        x = x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + 1e-30)
    return x


def _unit(like, i: int):
    e = torch.zeros_like(like)
    e[..., i] = 1.0
    return e


def svd3_jacobi(A):
    """Batched 3x3 SVD (U, s descending, Vt) via one-sided Jacobi with
    Gram-Schmidt completion of U for tiny singular values (the batched
    equivalent of the reference's svd3, cpp:537-593)."""
    AV_u, s_u, V_u = onesided_jacobi(A)
    order = torch.argsort(-s_u, dim=-1, stable=True)
    s = torch.gather(s_u, -1, order)
    oc = order[..., None, :].expand(V_u.shape)
    V = torch.gather(V_u, -1, oc)
    AV = torch.gather(AV_u, -1, oc)
    s_safe = torch.maximum(s, 1e-12 * (s[..., :1] + 1e-30))
    U = AV / s_safe[..., None, :]
    # Gram-Schmidt re-orthonormalization (robust for rank-deficient A)
    norm = lambda x: torch.linalg.vector_norm(x, dim=-1, keepdim=True)  # noqa: E731
    u0 = U[..., :, 0]
    n0 = norm(u0)
    u0 = torch.where(n0 > 1e-6, u0 / torch.clamp(n0, min=1e-30), _unit(u0, 0))
    u1 = U[..., :, 1]
    u1 = u1 - u0 * torch.sum(u0 * u1, dim=-1, keepdim=True)
    n1 = norm(u1)
    h = torch.where(u0[..., :1].abs() < 0.9, _unit(u0, 0), _unit(u0, 1))
    alt1 = torch.linalg.cross(u0, h, dim=-1)
    alt1 = alt1 / torch.clamp(norm(alt1), min=1e-30)
    u1 = torch.where(n1 > 1e-6, u1 / torch.clamp(n1, min=1e-30), alt1)
    u2 = torch.linalg.cross(u0, u1, dim=-1)
    # orient u2 to match A v2 (so U s Vt = A for full-rank A); keep the
    # right-handed completion when s2 ~ 0 (rank-2 input)
    av2 = AV[..., :, 2]
    d2 = torch.sum(u2 * av2, dim=-1, keepdim=True)
    sign2 = torch.where(d2.abs() > 1e-9, torch.sign(d2), torch.ones_like(d2))
    u2 = u2 * sign2
    U = torch.stack([u0, u1, u2], dim=-1)
    return U, s, V.transpose(-1, -2)


def det3(A):
    """Closed-form batched 3x3 determinant."""
    return (
        A[..., 0, 0] * (A[..., 1, 1] * A[..., 2, 2] - A[..., 1, 2] * A[..., 2, 1])
        - A[..., 0, 1] * (A[..., 1, 0] * A[..., 2, 2] - A[..., 1, 2] * A[..., 2, 0])
        + A[..., 0, 2] * (A[..., 1, 0] * A[..., 2, 1] - A[..., 1, 1] * A[..., 2, 0])
    )


def inv3(A):
    """Closed-form batched 3x3 inverse (ref: dense.hpp:96-119)."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    A11 = e * i - f * h
    A12 = c * h - b * i
    A13 = b * f - c * e
    A21 = f * g - d * i
    A22 = a * i - c * g
    A23 = c * d - a * f
    A31 = d * h - e * g
    A32 = b * g - a * h
    A33 = a * e - b * d
    det = a * A11 + b * A21 + c * A31
    det = torch.where(det.abs() < 1e-18, torch.full_like(det, 1e-18), det)
    inv_det = 1.0 / det
    M = torch.stack(
        [
            torch.stack([A11, A12, A13], -1),
            torch.stack([A21, A22, A23], -1),
            torch.stack([A31, A32, A33], -1),
        ],
        dim=-2,
    )
    return M * inv_det[..., None, None]


def cholesky_unrolled(A):
    """Dense Cholesky with an unrolled column loop (vectorized rank-1
    downdates), for the small systems of this package (5..48 dims)."""
    n = A.shape[-1]
    L = torch.zeros_like(A)
    idx = torch.arange(n, device=A.device)
    for j in range(n):
        d = torch.sqrt(torch.clamp(A[..., j, j], min=1e-30))
        col = A[..., :, j] / d[..., None]
        col = torch.where(idx >= j, col, torch.zeros_like(col))
        L[..., :, j] = col
        A = A - col[..., :, None] * col[..., None, :]
    return L


def _forward_sub(L, b):
    """Solve L y = b (L lower-triangular), unrolled."""
    n = L.shape[-1]
    y = torch.zeros_like(b)
    for i in range(n):
        acc = torch.sum(L[..., i, :] * y, dim=-1)
        y[..., i] = (b[..., i] - acc) / L[..., i, i]
    return y


def _backward_sub(U, b):
    """Solve U x = b (U upper-triangular), unrolled."""
    n = U.shape[-1]
    x = torch.zeros_like(b)
    for i in range(n - 1, -1, -1):
        acc = torch.sum(U[..., i, :] * x, dim=-1)
        x[..., i] = (b[..., i] - acc) / U[..., i, i]
    return x


def solve_psd_small(A, b, jitter: float = 0.0):
    """Cholesky solve for PSD A with n<=48, fully unrolled."""
    n = A.shape[-1]
    if jitter:
        A = A + jitter * torch.eye(n, dtype=A.dtype, device=A.device)
    L = cholesky_unrolled(A)
    y = _forward_sub(L, b)
    return _backward_sub(L.transpose(-1, -2), y)


def solve_psd(A, b, jitter: float = 0.0):
    """Solve A x = b for symmetric positive-(semi)definite A via Cholesky.

    Small systems use the unrolled Cholesky (as the JAX twin does); large
    ones go to the library's blocked factorization."""
    n = A.shape[-1]
    if n <= 48:
        return solve_psd_small(A, b, jitter)
    if jitter:
        A = A + jitter * torch.eye(n, dtype=A.dtype, device=A.device)
    L = torch.linalg.cholesky(A)
    return torch.cholesky_solve(b[..., None], L)[..., 0]


def svd3(A):
    """Batched 3x3 SVD (U, s, Vt); ref cpp:537-593 builds this by hand."""
    return svd3_jacobi(A)


def enforce_rank2(E):
    """Project (...,3,3) onto the essential manifold's rank-2 cone by zeroing
    the smallest singular value (ref: cpp:595-607)."""
    u, s, vt = svd3_jacobi(E)
    s2 = s.clone()
    s2[..., 2] = 0.0
    return (u * s2[..., None, :]) @ vt


def normalize_points_hartley(pts, valid=None):
    """Hartley normalization: translate centroid to origin, scale mean norm
    to sqrt(2). Returns (pts_n, T) with T (3,3) such that p_n = T p_h."""
    if valid is None:
        mean = torch.mean(pts, dim=-2, keepdim=True)
        d = torch.linalg.vector_norm(pts - mean, dim=-1).mean(dim=-1)
    else:
        w = valid[..., None].to(pts.dtype)
        cnt = torch.clamp(torch.sum(w, dim=-2, keepdim=True), min=1.0)
        mean = torch.sum(pts * w, dim=-2, keepdim=True) / cnt
        d = torch.sum(torch.linalg.vector_norm((pts - mean) * w, dim=-1),
                      dim=-1) / torch.clamp(cnt[..., 0, 0], min=1.0)
    s = math.sqrt(2.0) / torch.clamp(d, min=1e-12)
    pts_n = (pts - mean) * s[..., None, None]
    zeros = torch.zeros_like(s)
    ones = torch.ones_like(s)
    T = torch.stack(
        [
            torch.stack([s, zeros, -s * mean[..., 0, 0]], -1),
            torch.stack([zeros, s, -s * mean[..., 0, 1]], -1),
            torch.stack([zeros, zeros, ones], -1),
        ],
        dim=-2,
    )
    return pts_n, T


def nanmedian(x, dim: int = -1):
    """Median over ``dim`` ignoring NaNs, the mean of the two middle values
    for an even count (what ``jnp.nanmedian`` returns; ``torch.nanmedian``
    returns the lower one). All-NaN slices give NaN."""
    x = x.movedim(dim, -1)
    with debug.nan_ok():  # NaN in, NaN out for an all-NaN slice
        srt, _ = torch.sort(x, dim=-1)  # NaNs sort last
        n = torch.sum(~torch.isnan(x), dim=-1, keepdim=True)
        lo = torch.clamp((n - 1) // 2, min=0)
        hi = torch.clamp(n // 2, max=x.shape[-1] - 1)
        med = (0.5 * torch.gather(srt, -1, lo)
               + 0.5 * torch.gather(srt, -1, hi))
        nan = torch.full_like(med, float("nan"))
        return torch.where(n > 0, med, nan)[..., 0]

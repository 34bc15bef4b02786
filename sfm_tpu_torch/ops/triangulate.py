"""Batched DLT triangulation in the world frame.

Counterpart of sfm_tpu/ops/triangulate.py (reference: cpp/src/
templering_sfm.cpp:1477-1516 ``triangulate_dlt``: 4x4 design rows
``x·P3−P1`` from world→cam extrinsics in K-normalized coords).  N points
(each with its own pair of cameras) solve as one batched closed-form 3x3
system.
"""

from __future__ import annotations

import torch


def _rows(R, t, x):
    """DLT rows for world→cam (R,t) and normalized obs x.

    R (...,3,3), t (...,3), x (...,2) -> (...,2,4)."""
    P = torch.cat([R, t[..., None]], dim=-1)  # (...,3,4)
    r1 = x[..., 0:1] * P[..., 2, :] - P[..., 0, :]
    r2 = x[..., 1:2] * P[..., 2, :] - P[..., 1, :]
    return torch.stack([r1, r2], dim=-2)


def _solve33_closed(M, b, eps):
    """Closed-form (adjugate) solve of (M + eps·I) x = b for batched
    symmetric 3x3 M, unrolled into (N,) scalar ops (the reference's
    closed-form inv3 is dense.hpp:96-119)."""
    m00 = M[..., 0, 0] + eps
    m11 = M[..., 1, 1] + eps
    m22 = M[..., 2, 2] + eps
    m01 = M[..., 0, 1]
    m02 = M[..., 0, 2]
    m12 = M[..., 1, 2]
    c00 = m11 * m22 - m12 * m12
    c01 = m02 * m12 - m01 * m22
    c02 = m01 * m12 - m02 * m11
    c11 = m00 * m22 - m02 * m02
    c12 = m01 * m02 - m00 * m12
    c22 = m00 * m11 - m01 * m01
    det = m00 * c00 + m01 * c01 + m02 * c02
    det = torch.where(det.abs() < 1e-30, torch.full_like(det, 1e-30), det)
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    x0 = (c00 * b0 + c01 * b1 + c02 * b2) / det
    x1 = (c01 * b0 + c11 * b1 + c12 * b2) / det
    x2 = (c02 * b0 + c12 * b1 + c22 * b2) / det
    return torch.stack([x0, x1, x2], dim=-1)


def triangulate_dlt(R_a, t_a, x_a, R_b, t_b, x_b):
    """Triangulate world points from two observations each.

    Args: per-point world→camera extrinsics (N,3,3)/(N,3) and K-normalized
    observations (N,2) in cameras a and b.
    Returns (X_world (N,3), z_a (N,), z_b (N,)) — depths for cheirality
    gating (ref: py:928-933 requires z>0 in both views).
    """
    A = torch.cat([_rows(R_a, t_a, x_a), _rows(R_b, t_b, x_b)], dim=-2)
    # inhomogeneous DLT (w=1, Hartley-Zisserman): solve the 4x3
    # overdetermined system A[:, :3] X = -A[:, 3] by normal equations
    # with a closed-form 3x3 solve (the reference's own DLT squares the
    # condition number the same way, cpp:1477-1516)
    A3 = A[..., :3]
    a4 = A[..., 3]
    M = torch.einsum("...mi,...mj->...ij", A3, A3)
    b = -torch.einsum("...mi,...m->...i", A3, a4)
    tr = M[..., 0, 0] + M[..., 1, 1] + M[..., 2, 2]
    eps = 1e-12 * tr + 1e-30
    X = _solve33_closed(M, b, eps)
    z_a = torch.einsum("...ij,...j->...i", R_a, X)[..., 2] + t_a[..., 2]
    z_b = torch.einsum("...ij,...j->...i", R_b, X)[..., 2] + t_b[..., 2]
    return X, z_a, z_b


def reprojection_error(R, t, X, x_obs):
    """Normalized-coordinate reprojection error (N,) for world→cam (R,t)."""
    Xc = torch.einsum("...ij,...j->...i", R, X) + t
    z = Xc[..., 2]
    z = torch.where(z.abs() < 1e-18, torch.full_like(z, 1e-18), z)
    proj = Xc[..., :2] / z[..., None]
    return torch.linalg.vector_norm(proj - x_obs, dim=-1)

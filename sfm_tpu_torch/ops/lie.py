"""SO(3)/SE(3) Lie-group operations on trailing (3,)/(3,3) dims,
broadcasting over arbitrary leading batch dims.

Counterpart of sfm_tpu/ops/lie.py (reference: cpp/include/linalg.hpp:
90-124 ``so3_exp``/``so3_log``, cpp/include/so3.hpp hat/vee).
"""

from __future__ import annotations

import math

import torch

_EPS = 1e-12


def hat(w):
    """(...,3) -> (...,3,3) skew-symmetric matrix. ref: so3.hpp:8-14."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    zeros = torch.zeros_like(wx)
    return torch.stack(
        [
            torch.stack([zeros, -wz, wy], dim=-1),
            torch.stack([wz, zeros, -wx], dim=-1),
            torch.stack([-wy, wx, zeros], dim=-1),
        ],
        dim=-2,
    )


def vee(W):
    """(...,3,3) skew -> (...,3). ref: so3.hpp:16-18."""
    return torch.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], dim=-1)


def so3_exp(w):
    """Rodrigues formula exp: so(3) vector -> rotation matrix.

    Small-angle-safe via Taylor branches on the sinc coefficients
    (ref: linalg.hpp:90-108 has the same two-branch structure).
    """
    theta2 = torch.sum(w * w, dim=-1)
    theta = torch.sqrt(theta2 + _EPS)
    small = theta2 < 1e-8
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta)) / (theta2 + _EPS))
    W = hat(w)
    W2 = W @ W
    eye = torch.eye(3, dtype=w.dtype, device=w.device).expand(W.shape)
    return eye + a[..., None, None] * W + b[..., None, None] * W2


def so3_log(R):
    """Rotation matrix -> so(3) vector; robust near theta=0 and theta=pi.

    ref: linalg.hpp:111-124 uses the plain trace formula; the near-pi
    branch (axis from the dominant diagonal of (R+I)/2) keeps edges with
    large rotations well-defined.
    """
    dtype = R.dtype
    tr = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    # clip strictly inside (-1, 1), with a margin that scales with the
    # dtype's eps (a fixed 1e-12 rounds to exactly 1.0 in f32)
    margin = 10.0 * torch.finfo(dtype).eps
    cos_t = torch.clamp((tr - 1.0) * 0.5, -1.0 + margin, 1.0 - margin)
    theta = torch.arccos(cos_t)
    sin_t = torch.sin(theta)

    # generic branch: w = theta/(2 sin t) * vee(R - R^T)
    v = vee(R - R.transpose(-1, -2))
    generic_scale = torch.where(
        theta < 1e-5,
        0.5 + theta * theta / 12.0,  # Taylor of theta/(2 sin theta)
        theta / (2.0 * sin_t + _EPS),
    )
    w_generic = generic_scale[..., None] * v

    # near-pi branch: R ~= 2 a a^T - I  =>  a a^T = (R + I)/2
    eye = torch.eye(3, dtype=dtype, device=R.device).expand(R.shape)
    B = (R + eye) * 0.5
    diag = torch.stack([B[..., 0, 0], B[..., 1, 1], B[..., 2, 2]], dim=-1)
    k = torch.argmax(diag, dim=-1)
    idx = k[..., None, None].expand(*k.shape, 3, 1)
    col = torch.gather(B, -1, idx)[..., 0]
    axis = col / (torch.linalg.vector_norm(col, dim=-1, keepdim=True) + _EPS)
    # fix sign so that vee(R - R^T) agrees (sin t may be tiny but signed)
    neg = torch.sum(axis * v, dim=-1, keepdim=True) < 0.0
    sign = torch.where(neg, -1.0, 1.0).to(dtype)
    w_pi = theta[..., None] * axis * sign

    near_pi = (math.pi - theta) < 1e-3
    return torch.where(near_pi[..., None], w_pi, w_generic)


def quat_to_rot(q):
    """Unit quaternion (w,x,y,z) -> rotation matrix; used by synthetic data."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack(
        [
            torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                         2 * (x * z + w * y)], -1),
            torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                         2 * (y * z - w * x)], -1),
            torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                         1 - 2 * (x * x + y * y)], -1),
        ],
        dim=-2,
    )


# ---------------------------------------------------------------------------
# SE(3) poses: a pose batch is a pair (R: (...,3,3), t: (...,3)), stored
# either camera-to-world (R_cw, t_cw) or world-to-camera (R_wc, t_wc).
# ---------------------------------------------------------------------------


def pose_inv(R, t):
    """Invert an SE(3) transform: (R, t) -> (R^T, -R^T t)."""
    Rt = R.transpose(-1, -2)
    return Rt, -torch.einsum("...ij,...j->...i", Rt, t)


def pose_compose(Ra, ta, Rb, tb):
    """(Ra,ta) ∘ (Rb,tb): apply b first, then a."""
    return Ra @ Rb, torch.einsum("...ij,...j->...i", Ra, tb) + ta


def compose_right_inv_ij(R_cw, t_cw, R_ji, t_ji):
    """Next camera-to-world pose from current pose and relative pose i->j.

    ref: py:117-127 ``PoseCW.compose_right_inv_ij`` / cpp:170-178.
    If T_cw maps cam_i->world and T_ji maps cam_i->cam_j (x_j = R_ji x_i + t_ji),
    then T_cw' = T_cw ∘ T_ji^{-1} maps cam_j->world.
    """
    R_ij, t_ij = pose_inv(R_ji, t_ji)
    return pose_compose(R_cw, t_cw, R_ij, t_ij)


def se3_exp(xi):
    """(...,6) twist [w | v] -> (R, t) with exact V(w) integration."""
    w, v = xi[..., :3], xi[..., 3:]
    theta2 = torch.sum(w * w, dim=-1)
    theta = torch.sqrt(theta2 + _EPS)
    small = theta2 < 1e-8
    R = so3_exp(w)
    W = hat(w)
    W2 = W @ W
    b = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta)) / (theta2 + _EPS))
    c = torch.where(small, 1.0 / 6.0 - theta2 / 120.0,
                    (theta - torch.sin(theta)) / (theta2 * theta + _EPS))
    eye = torch.eye(3, dtype=xi.dtype, device=xi.device).expand(R.shape)
    V = eye + b[..., None, None] * W + c[..., None, None] * W2
    return R, torch.einsum("...ij,...j->...i", V, v)


def se3_log(R, t):
    """(R, t) -> (...,6) twist [w | v]."""
    w = so3_log(R)
    theta2 = torch.sum(w * w, dim=-1)
    theta = torch.sqrt(theta2 + _EPS)
    W = hat(w)
    W2 = W @ W
    small = theta2 < 1e-8
    # V^{-1} = I - W/2 + (1/theta^2)(1 - a/(2b)) W^2,  a=sinc, b=(1-cos)/t^2
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta)) / (theta2 + _EPS))
    coef = torch.where(small, 1.0 / 12.0 + theta2 / 720.0,
                       (1.0 - a / (2.0 * b)) / (theta2 + _EPS))
    eye = torch.eye(3, dtype=R.dtype, device=R.device).expand(R.shape)
    Vinv = eye - 0.5 * W + coef[..., None, None] * W2
    v = torch.einsum("...ij,...j->...i", Vinv, t)
    return torch.cat([w, v], dim=-1)


def rvec_from_R(R):
    """Alias matching the reference exporter naming (cpp so3.hpp:20-23)."""
    return so3_log(R)

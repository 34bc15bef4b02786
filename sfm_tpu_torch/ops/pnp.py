"""Robust 3D-2D (PnP) pose refinement against the sparse map.

Counterpart of sfm_tpu/ops/pnp.py.  Once a map exists, the new pose comes
from robust Levenberg-Marquardt on 3D→2D reprojection (single camera,
points fixed).  Residuals/Jacobians are the same analytic forms as the BA
pose block (ref cpp:944-976), batched over observations — and over the
starting poses: where the JAX twin is ``vmap``ped over the two starts of
the keyframe branch, ``R0``/``t0`` carry a leading batch dimension here.
"""

from __future__ import annotations

import torch

from sfm_tpu_torch.ops import lie, linalg

_CUTOFF = 10.0


def _residuals(R_wc, t_wc, X, obs):
    """R_wc (...,3,3), t_wc (...,3); X (M,3), obs (M,2) shared."""
    Xc = torch.einsum("...ij,mj->...mi", R_wc, X) + t_wc[..., None, :]
    z = Xc[..., 2]
    z_safe = torch.where(z.abs() < 1e-6, torch.full_like(z, 1e-6), z)
    r = Xc[..., :2] / z_safe[..., None] - obs
    return r, Xc, z > 1e-6


def pnp_cost(R_wc, t_wc, X, obs, valid, huber_delta):
    r, _, z_ok = _residuals(R_wc, t_wc, X, obs)
    n = torch.linalg.vector_norm(r, dim=-1)
    quad = 0.5 * n * n
    lin = huber_delta * (n - 0.5 * huber_delta)
    rho = torch.where(n <= huber_delta, quad, lin)
    cap = huber_delta * (_CUTOFF * huber_delta - 0.5 * huber_delta)
    rho = torch.clamp(rho, max=cap)
    behind = torch.where(valid, 2.0 * cap + 1.0, 0.0).to(rho.dtype)
    rho = torch.where(z_ok, rho, behind)
    return torch.sum(torch.where(valid, rho, torch.zeros_like(rho)), dim=-1)


def refine_pose(R0, t0, X, obs, valid, iters: int = 10,
                lambda0: float = 1e-4, huber_delta: float = 2e-3):
    """Robust LM pose refinement (world→cam R0,t0 init; K-normalized obs).

    R0 (...,3,3), t0 (...,3): one start, or a batch of starts refined
    together against the same X (M,3), obs (M,2), valid (M,).
    Returns (R_wc, t_wc, info) with inlier stats at the solution, each
    with the starts' leading dims."""
    dtype = X.dtype
    dev = X.device
    batch = R0.shape[:-2]
    R, t = R0, t0
    lam = torch.full(batch, lambda0, dtype=dtype, device=dev)
    cost0 = pnp_cost(R0, t0, X, obs, valid, huber_delta)
    cost = cost0
    for _ in range(iters):
        r, Xc, z_ok = _residuals(R, t, X, obs)
        n = torch.linalg.vector_norm(r, dim=-1)
        w = torch.sqrt(torch.clamp(huber_delta / torch.clamp(n, min=1e-12),
                                   max=1.0))
        # adaptive gross-outlier gate: a fixed multiple of huber_delta
        # would also cut true points when the INIT error exceeds it, so
        # widen by the current robust residual scale
        use = valid & z_ok
        med = linalg.nanmedian(
            torch.where(use, n, torch.full_like(n, float("nan"))), dim=-1)
        med = torch.where(torch.isnan(med),
                          torch.full_like(med, huber_delta), med)
        cut = torch.clamp(3.0 * med, min=_CUTOFF * huber_delta)
        w = torch.where(n > cut[..., None], torch.zeros_like(w), w)
        w = w * use.to(dtype)
        z = Xc[..., 2]
        z = torch.where(z.abs() < 1e-6, torch.full_like(z, 1e-6), z)
        inv_z = 1.0 / z
        x, y = Xc[..., 0], Xc[..., 1]
        zero = torch.zeros_like(inv_z)
        Jproj = torch.stack(
            [
                torch.stack([inv_z, zero, -x * inv_z * inv_z], dim=-1),
                torch.stack([zero, inv_z, -y * inv_z * inv_z], dim=-1),
            ],
            dim=-2,
        )
        Jw = -torch.einsum("...mij,...mjk->...mik", Jproj, lie.hat(Xc))
        J = torch.cat([Jw, Jproj], dim=-1) * w[..., None, None]
        rw = r * w[..., None]
        H = torch.einsum("...mia,...mib->...ab", J, J)
        g = torch.einsum("...mia,...mi->...a", J, rw)
        dH = torch.diagonal(H, dim1=-2, dim2=-1)
        H = H + torch.diag_embed(
            lam[..., None] * torch.clamp(dH, min=1e-8) + 1e-10)
        dx = -linalg.solve_psd_small(H, g, jitter=1e-12)
        dR = lie.so3_exp(dx[..., :3])
        R_try = dR @ R
        t_try = torch.einsum("...ij,...j->...i", dR, t) + dx[..., 3:]
        new_cost = pnp_cost(R_try, t_try, X, obs, valid, huber_delta)
        accept = new_cost < cost
        R = torch.where(accept[..., None, None], R_try, R)
        t = torch.where(accept[..., None], t_try, t)
        cost = torch.where(accept, new_cost, cost)
        lam = torch.where(accept, lam * 0.3, lam * 2.0)

    r, _, z_ok = _residuals(R, t, X, obs)
    n = torch.linalg.vector_norm(r, dim=-1)
    inl = valid & z_ok & (n < 3.0 * huber_delta)
    n_inl = torch.sum(inl, dim=-1)
    info = {"cost0": cost0, "cost": cost,
            "inliers": n_inl.to(torch.int32),
            "inlier_rms": torch.sqrt(
                torch.sum(torch.where(inl, n * n, torch.zeros_like(n)),
                          dim=-1)
                / torch.clamp(n_inl, min=1).to(dtype))}
    return R, t, info

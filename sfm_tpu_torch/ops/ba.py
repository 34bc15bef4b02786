"""Sliding-window bundle adjustment: batched Schur-complement LM.

Counterpart of sfm_tpu/ops/ba.py, structure-of-arrays path (reference:
cpp/src/templering_sfm.cpp:848-1097 ``bundle_adjust_window`` — analytic
Jacobians cpp:944-976, per-point Schur elimination cpp:1011-1057, 6Wx6W
reduced camera solve cpp:1073, SE(3) manifold update cpp:1081-1095, gauge
fix cpp:1067-1071).

Residuals + Jacobians for ALL observations are one vectorized evaluation
on (M,) scalars; the block Hessians assemble with two one-hot matmuls;
the point blocks are eliminated with a closed-form 3x3 inverse; the
reduced camera system solves by Cholesky; the LM loop accepts or rejects
each step.  Everything is fixed-shape: (F) window poses, (P) points, (M)
padded observations.  Only window-sized problems (F*P <= 8192) are
supported so far.

Conventions: poses are world→camera (R_wc, t_wc); observations are
K-normalized image coords; update is left-multiplicative SE(3):
``T' = exp([w|v]) ∘ T``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from sfm_tpu_torch.ops import lie, linalg


class BAProblem(NamedTuple):
    """Fixed-shape BA problem. Invalid obs/points are masked out."""

    R_wc: torch.Tensor  # (F,3,3)
    t_wc: torch.Tensor  # (F,3)
    X: torch.Tensor  # (P,3)
    cam_idx: torch.Tensor  # (M,) int in [0,F)
    pid_idx: torch.Tensor  # (M,) int in [0,P)
    obs: torch.Tensor  # (M,2) normalized coords
    obs_valid: torch.Tensor  # (M,) bool
    point_valid: torch.Tensor  # (P,) bool


_CUTOFF = 10.0  # gross-outlier gate, in units of huber_delta

_SOA_LIMIT = 8192  # F*P above which the JAX twin leaves the SoA path


def _camera_points(p: BAProblem):
    """Camera-frame coordinates of every observation's point, as three
    (M,) vectors, plus the gathered rotation rows."""
    cam, pid = p.cam_idx.long(), p.pid_idx.long()
    Rg = p.R_wc[cam]
    tg = p.t_wc[cam]
    Xg = p.X[pid]
    Xc = [Rg[:, i, 0] * Xg[:, 0] + Rg[:, i, 1] * Xg[:, 1]
          + Rg[:, i, 2] * Xg[:, 2] + tg[:, i] for i in range(3)]
    return Xc, Rg, cam, pid


def ba_cost_soa(p: BAProblem, huber_delta: float) -> torch.Tensor:
    """Total robust cost (for LM accept/reject and metrics)."""
    Xc, _, _, _ = _camera_points(p)
    z = Xc[2]
    z_ok = p.obs_valid & (z > 1e-6)
    iz = 1.0 / torch.where(z.abs() < 1e-6, torch.full_like(z, 1e-6), z)
    rx = Xc[0] * iz - p.obs[:, 0]
    ry = Xc[1] * iz - p.obs[:, 1]
    n = torch.sqrt(rx * rx + ry * ry)
    rho = torch.where(n <= huber_delta, 0.5 * n * n,
                      huber_delta * (n - 0.5 * huber_delta))
    # truncate at the gross-outlier gate (consistent with the weights)
    cap = huber_delta * (_CUTOFF * huber_delta - 0.5 * huber_delta)
    rho = torch.clamp(rho, max=cap)
    # observations behind the camera get the worst-case penalty so LM
    # steps that push points behind a camera are rejected
    behind = torch.where(p.obs_valid, 2.0 * cap + 1.0, 0.0).to(rho.dtype)
    rho = torch.where(z_ok, rho, behind)
    return torch.sum(torch.where(p.obs_valid, rho, torch.zeros_like(rho)))


def _linearize_soa(p: BAProblem, huber_delta):
    """Structure-of-arrays linearization for window-sized problems.

    Every per-observation quantity is an (M,) vector, and all reductions
    ride two matmuls against one-hot membership matrices:

      camera side  (27,M) @ (M,F)      21 Hcc-triangle + 6 bc rows
      point side   (9+18F,M) @ (M,P)   6 Hpp-triangle + 3 bp + F*18 W

    (plain matmuls outside any kernel, as in the JAX twin; summation order
    inside them is the library's).

    Returns (Hcc (F,6,6), bc (F,6), ApT (9+18F,P)) where ApT rows are
    the point-side sums: [Hpp 00,01,02,11,12,22 | bp x,y,z |
    W[f,a,k] at row 9 + f*18 + a*3 + k].
    """
    F = p.R_wc.shape[0]
    P = p.X.shape[0]
    dtype = p.X.dtype
    dev = p.X.device
    Xc, Rg, cam, pid = _camera_points(p)
    r_ = [[Rg[:, i, j] for j in range(3)] for i in range(3)]
    z = torch.where(Xc[2].abs() < 1e-6, torch.full_like(Xc[2], 1e-6), Xc[2])
    iz = 1.0 / z
    u = Xc[0] * iz
    v = Xc[1] * iz
    rx = u - p.obs[:, 0]
    ry = v - p.obs[:, 1]
    n = torch.sqrt(rx * rx + ry * ry)
    w = torch.sqrt(torch.clamp(huber_delta / torch.clamp(n, min=1e-12),
                               max=1.0))
    w = torch.where(n > _CUTOFF * huber_delta, torch.zeros_like(w), w)
    z_ok = p.obs_valid & (Xc[2] > 1e-6)
    w = w * (z_ok & p.point_valid[pid]).to(dtype)

    # Jc rows (pose tangent [w|t], left-mult SE(3): -Jproj·hat(Xc) | Jproj
    # expanded to scalars)
    one = torch.ones_like(u)
    Jc0 = [-u * v, 1.0 + u * u, -v, iz, 0.0 * one, -u * iz]
    Jc1 = [-(1.0 + v * v), u * v, u, 0.0 * one, iz, -v * iz]
    # Jp rows: Jproj @ R_wc  ->  iz*(r0k - u*r2k), iz*(r1k - v*r2k)
    Jp0 = [iz * (r_[0][k] - u * r_[2][k]) for k in range(3)]
    Jp1 = [iz * (r_[1][k] - v * r_[2][k]) for k in range(3)]
    Jc0 = [a * w for a in Jc0]
    Jc1 = [a * w for a in Jc1]
    Jp0 = [a * w for a in Jp0]
    Jp1 = [a * w for a in Jp1]
    rwx = rx * w
    rwy = ry * w

    iu6 = [(a, b) for a in range(6) for b in range(a, 6)]   # 21
    iu3 = [(0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2)]  # 6
    cam_rows = (
        [Jc0[a] * Jc0[b] + Jc1[a] * Jc1[b] for a, b in iu6]
        + [Jc0[a] * rwx + Jc1[a] * rwy for a in range(6)]
    )
    W18 = [Jc0[a] * Jp0[k] + Jc1[a] * Jp1[k]
           for a in range(6) for k in range(3)]
    oc_f = [(cam == f).to(dtype) for f in range(F)]
    pt_rows = (
        [Jp0[a] * Jp0[b] + Jp1[a] * Jp1[b] for a, b in iu3]
        + [Jp0[a] * rwx + Jp1[a] * rwy for a in range(3)]
        + [wab * of for of in oc_f for wab in W18]
    )
    Vc = torch.stack(cam_rows)               # (27,M)
    Vp = torch.stack(pt_rows)                # (9+18F,M)
    ocT = (cam[:, None] == torch.arange(F, device=dev)[None]).to(dtype)
    opT = (pid[:, None] == torch.arange(P, device=dev)[None]).to(dtype)
    AcT = Vc @ ocT                         # (27,F)
    ApT = Vp @ opT                         # (9+18F,P)

    Hcc = torch.zeros((F, 6, 6), dtype=dtype, device=dev)
    for li, (a, b) in enumerate(iu6):
        Hcc[:, a, b] = AcT[li]
        if a != b:
            Hcc[:, b, a] = AcT[li]
    bc = AcT[21:27].T                      # (F,6)
    return Hcc, bc, ApT


def _solve_schur_soa(Hcc, bc, ApT, point_valid, lam, n_fix: int):
    """Schur elimination of the points + reduced camera solve, in SoA form
    (ref cpp:1011-1078; gauge handled by solving only for poses >= n_fix).
    ``ApT`` is the (9+18F,P) point-side reduction of ``_linearize_soa``.
    Returns (dx_cam (F,6), dX (P,3))."""
    F = Hcc.shape[0]
    P = ApT.shape[1]
    dtype = Hcc.dtype
    dev = Hcc.device
    h = [ApT[i] for i in range(6)]         # 00,01,02,11,12,22
    bp3 = ApT[6:9]                         # (3,P)
    dmax = torch.maximum(torch.maximum(h[0], h[3]), h[5])
    damp = lam * torch.clamp(dmax, min=1e-6) + 1e-9
    pv = point_valid
    one = torch.ones_like(h[0])
    zero = torch.zeros_like(h[0])
    m00 = torch.where(pv, h[0] + damp, one)
    m01 = torch.where(pv, h[1], zero)
    m02 = torch.where(pv, h[2], zero)
    m11 = torch.where(pv, h[3] + damp, one)
    m12 = torch.where(pv, h[4], zero)
    m22 = torch.where(pv, h[5] + damp, one)
    c00 = m11 * m22 - m12 * m12
    c01 = m02 * m12 - m01 * m22
    c02 = m01 * m12 - m02 * m11
    c11 = m00 * m22 - m02 * m02
    c12 = m01 * m02 - m00 * m12
    c22 = m00 * m11 - m01 * m01
    det = m00 * c00 + m01 * c01 + m02 * c02
    det = torch.where(det.abs() < 1e-30, torch.full_like(det, 1e-30), det)
    idet = torch.where(pv, 1.0 / det, zero)
    Hi = [[c00 * idet, c01 * idet, c02 * idet],
          [c01 * idet, c11 * idet, c12 * idet],
          [c02 * idet, c12 * idet, c22 * idet]]

    # W[f,a,k] rows as one (F,6,3,P) view; T = W·Hpp⁻¹ per point
    Wm = ApT[9:9 + 18 * F].reshape(F, 6, 3, P)
    Him = torch.stack([torch.stack(row) for row in Hi])  # (3,3,P)
    # T[f,a,k] = sum_j W[f,a,j] Hi[j,k], summed j = 0,1,2 in order
    Tm = (Wm[:, :, 0, None, :] * Him[0][None, None]
          + Wm[:, :, 1, None, :] * Him[1][None, None]
          + Wm[:, :, 2, None, :] * Him[2][None, None])  # (F,6,3,P)
    # rows ordered ((f,a),k): (18F,P)->(6F,3P) keeps (k,p) adjacent, so ONE
    # matmul contracts both k and p
    A2 = Tm.reshape(6 * F, 3 * P)
    B2 = Wm.reshape(6 * F, 3 * P)
    S = -(A2 @ B2.T)                       # (6F,6F)
    Sf = S.reshape(F, 6, F, 6).clone()
    idx = torch.arange(F, device=dev)
    Sf[idx, :, idx, :] += Hcc
    Sf = Sf.reshape(6 * F, 6 * F)
    b = bc.reshape(6 * F) - A2 @ bp3.reshape(3 * P)
    dS = torch.diagonal(Sf)
    prior = torch.where(dS <= 0.0, 1.0, 0.0).to(dtype)
    Sf = Sf + torch.diag(lam * torch.clamp(dS, min=1e-6) + 1e-9 + prior)
    kfix = 6 * n_fix
    dx_red = linalg.solve_psd(Sf[kfix:, kfix:], -b[kfix:], jitter=1e-12)
    dx = torch.cat([torch.zeros(kfix, dtype=dtype, device=dev),
                    dx_red]).reshape(F, 6)

    # back-substitute: rhs_k = -bp_k - sum_{f,a} W[f,a,k] dx[f,a]
    rhs = -bp3 - torch.einsum("fakp,fa->kp", Wm, dx)
    dX = torch.stack(
        [Hi[k][0] * rhs[0] + Hi[k][1] * rhs[1] + Hi[k][2] * rhs[2]
         for k in range(3)], dim=-1)
    return dx, dX


def bundle_adjust(
    p: BAProblem,
    iters: int = 5,
    lambda0: float = 1e-3,
    huber_delta: float = 2e-3,
    n_fix: int = 1,
    update_points: bool = True,
):
    """Run ``iters`` LM steps with accept/reject. Returns
    (R_wc, t_wc, X, info dict).  The accept/reject selection stays on the
    device (``torch.where``), so the loop makes no host sync."""
    F = p.R_wc.shape[0]
    P = p.X.shape[0]
    if F * P > _SOA_LIMIT:
        raise NotImplementedError(
            f"bundle_adjust: F*P = {F * P} > {_SOA_LIMIT}; only the "
            "window-sized structure-of-arrays path is ported so far")
    dtype = p.R_wc.dtype
    dev = p.R_wc.device
    R_wc, t_wc, X = p.R_wc, p.t_wc, p.X
    cost0 = ba_cost_soa(p, huber_delta)
    cost = cost0
    lam = torch.as_tensor(lambda0, dtype=dtype, device=dev)
    hist = []
    for _ in range(iters):
        cur = p._replace(R_wc=R_wc, t_wc=t_wc, X=X)
        Hcc, bc, ApT = _linearize_soa(cur, huber_delta)
        dx, dX = _solve_schur_soa(Hcc, bc, ApT, p.point_valid, lam, n_fix)
        # trial update: left-mult SE(3) on poses (ref cpp:1081-1095)
        dR = lie.so3_exp(dx[:, :3])
        R_try = dR @ R_wc
        t_try = torch.einsum("fij,fj->fi", dR, t_wc) + dx[:, 3:]
        X_try = X + dX if update_points else X
        trial = p._replace(R_wc=R_try, t_wc=t_try, X=X_try)
        new_cost = ba_cost_soa(trial, huber_delta)
        accept = new_cost < cost
        R_wc = torch.where(accept, R_try, R_wc)
        t_wc = torch.where(accept, t_try, t_wc)
        X = torch.where(accept, X_try, X)
        cost = torch.where(accept, new_cost, cost)
        lam = torch.where(accept, lam * 0.3, lam * 2.0)  # ref py:839-843
        hist.append(cost)
    info = {"cost0": cost0, "cost": cost,
            "cost_hist": torch.stack(hist) if hist else cost0[None][:0],
            "lambda": lam}
    return R_wc, t_wc, X, info

"""Sliding-window bundle adjustment: batched Schur-complement LM.

Counterpart of sfm_tpu/ops/ba.py (reference:
cpp/src/templering_sfm.cpp:848-1097 ``bundle_adjust_window`` — analytic
Jacobians cpp:944-976, per-point Schur elimination cpp:1011-1057, 6Wx6W
reduced camera solve cpp:1073, SE(3) manifold update cpp:1081-1095, gauge
fix cpp:1067-1071).

Residuals + Jacobians for ALL observations are one vectorized evaluation;
the point blocks are eliminated with a batched 3x3 inverse; the reduced
camera system solves by Cholesky; the LM loop accepts or rejects each
step.  Everything is fixed-shape: (F) poses, (P) points, (M) padded
observations.  Two layouts, chosen by size as in the JAX twin:

  * window-sized problems (F*P <= 8192): structure of arrays, (M,)
    scalars whose block sums ride two one-hot matmuls
    (``_linearize_soa`` / ``_solve_schur_soa``);
  * larger ones (the global final BA, F=64 P=16384 at 47 keyframes):
    array of structures, (M,6,6)/(M,6,3)/... blocks summed per camera,
    per point and per (camera, point) by ``_segment_sum`` — a sort-based
    plan built once per solve, so the sums take one fixed order on every
    run (no float atomics: ``index_add_`` on CUDA is not
    bit-reproducible) — then dense (F,P,6,3) Schur contractions as
    matmuls (``_linearize`` / ``_solve_schur``).

``refine_points`` (frozen poses, the final structure polish) takes any
size.

Conventions: poses are world→camera (R_wc, t_wc); observations are
K-normalized image coords; update is left-multiplicative SE(3):
``T' = exp([w|v]) ∘ T``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from sfm_tpu_torch.ops import lie, linalg
from sfm_tpu_torch.utils import debug


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

_SOA_LIMIT = 8192  # F*P above which bundle_adjust takes the AoS path


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


def _project_residuals(R_wc, t_wc, X, cam_idx, pid_idx, obs, obs_valid):
    """Residuals + camera-frame points for all observations.

    Returns (r (M,2), Xc (M,3), z_ok (M,))."""
    cam, pid = cam_idx.long(), pid_idx.long()
    Xc = torch.einsum("mij,mj->mi", R_wc[cam], X[pid]) + t_wc[cam]
    z = Xc[:, 2]
    z_ok = obs_valid & (z > 1e-6)
    z_safe = torch.where(z.abs() < 1e-6, torch.full_like(z, 1e-6), z)
    r = Xc[:, :2] / z_safe[:, None] - obs
    return r, Xc, z_ok


def _huber_weight(r, delta):
    """sqrt-IRLS weight per obs: min(1, delta/‖r‖) (ref cpp:843-846);
    residuals beyond ``_CUTOFF*delta`` are gross outliers and get 0."""
    n = torch.linalg.vector_norm(r, dim=-1)
    w = torch.sqrt(torch.clamp(delta / torch.clamp(n, min=1e-12), max=1.0))
    return torch.where(n > _CUTOFF * delta, torch.zeros_like(w), w)


def ba_cost(p: BAProblem, huber_delta: float) -> torch.Tensor:
    """Total robust cost (for LM accept/reject and metrics), in (M,)
    scalar lanes on either Hessian layout."""
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
    # in rho's dtype: a float64 cost keeps the penalty's float64 value
    behind = (2.0 * cap + 1.0) * p.obs_valid.to(rho.dtype)
    rho = torch.where(z_ok, rho, behind)
    return torch.sum(torch.where(p.obs_valid, rho, torch.zeros_like(rho)))


# The JAX package's scalar-lane (SoA) twin of its tensor-form cost.  The
# port's ba_cost already computes in (M,) lanes, so the two names are one
# function here.
ba_cost_soa = ba_cost


def _segment_plan(seg, keep, n_seg: int):
    """Fixed-order reduction plan for the segment ids ``seg`` (M,) of the
    rows where ``keep`` holds: (ids (U,) of the segments present, G (U,cap)
    row indices of each one's rows in row order, M where a segment has
    fewer than cap).  One stable sort, then every sum through the plan
    reduces by gathers in one order on every run.  One host pull (cap)."""
    M = seg.shape[0]
    dev = seg.device
    s = torch.where(keep, seg.long(), torch.full_like(seg.long(), n_seg))
    order = torch.argsort(s, stable=True)
    ids, counts = torch.unique_consecutive(s[order], return_counts=True)
    starts = torch.cumsum(counts, 0) - counts
    real = ids < n_seg              # the dump segment sorts last
    ids, counts, starts = ids[real], counts[real], starts[real]
    cap = max(int(counts.max()) if len(counts) else 0, 1)
    r = torch.arange(cap, device=dev)
    pos = torch.clamp(starts[:, None] + r[None], max=M - 1)
    G = torch.where(r[None] < counts[:, None], order[pos],
                    torch.full_like(pos, M))
    return ids, G


def _segment_sum(vals, plan, n_seg: int):
    """(M, ...) values -> (n_seg, ...) per-segment sums by a plan of
    ``_segment_plan`` (absent segments are zero)."""
    ids, G = plan
    pad = torch.cat([vals, vals.new_zeros((1, *vals.shape[1:]))])
    out = vals.new_zeros((n_seg, *vals.shape[1:]))
    out[ids] = pad[G].sum(dim=1)
    return out


def _aos_plans(p: BAProblem):
    """The per-camera, per-point and per-(camera, point) plans of a problem
    (they depend only on its fixed observation table).  Invalid rows are
    left out: their weight is 0, so their blocks are exact zeros."""
    F = p.R_wc.shape[0]
    P = p.X.shape[0]
    cam, pid = p.cam_idx.long(), p.pid_idx.long()
    return (_segment_plan(cam, p.obs_valid, F),
            _segment_plan(pid, p.obs_valid, P),
            _segment_plan(cam * P + pid, p.obs_valid, F * P))


def _linearize(p: BAProblem, huber_delta, plans=None):
    """One vectorized linearization pass over all observations, array of
    structures, with fixed-order segment sums (``plans`` from
    ``_aos_plans``; made here when not given).

    Returns (Hcc (F,6,6), bc (F,6), Hpp (P,3,3), bp (P,3), W (F,P,6,3))."""
    F = p.R_wc.shape[0]
    P = p.X.shape[0]
    cam, pid = p.cam_idx.long(), p.pid_idx.long()
    r, Xc, z_ok = _project_residuals(p.R_wc, p.t_wc, p.X, cam, pid, p.obs,
                                     p.obs_valid)
    w = _huber_weight(r, huber_delta) * (z_ok & p.point_valid[pid]).to(
        r.dtype)
    z = torch.where(Xc[:, 2].abs() < 1e-6, torch.full_like(Xc[:, 2], 1e-6),
                    Xc[:, 2])
    inv_z = 1.0 / z
    x, y = Xc[:, 0], Xc[:, 1]
    zero = torch.zeros_like(inv_z)
    # Jproj (M,2,3), ref cpp:944-947
    Jproj = torch.stack(
        [
            torch.stack([inv_z, zero, -x * inv_z * inv_z], dim=-1),
            torch.stack([zero, inv_z, -y * inv_z * inv_z], dim=-1),
        ],
        dim=-2,
    )
    # pose block [-Jproj·hat(Xc) | Jproj] (left-mult SE(3); ref
    # cpp:961-976); point block Jproj·R_wc (ref cpp:949-957)
    Jw = -torch.einsum("mij,mjk->mik", Jproj, lie.hat(Xc))
    Jc = torch.cat([Jw, Jproj], dim=-1) * w[:, None, None]   # (M,2,6)
    Jp = torch.einsum("mij,mjk->mik", Jproj,
                      p.R_wc[cam]) * w[:, None, None]       # (M,2,3)
    rw = r * w[:, None]
    if plans is None:
        plans = _aos_plans(p)
    pc, pp, pw = plans
    Hcc = _segment_sum(torch.einsum("mia,mib->mab", Jc, Jc), pc, F)
    bc = _segment_sum(torch.einsum("mia,mi->ma", Jc, rw), pc, F)
    Hpp = _segment_sum(torch.einsum("mia,mib->mab", Jp, Jp), pp, P)
    bp = _segment_sum(torch.einsum("mia,mi->ma", Jp, rw), pp, P)
    W = _segment_sum(torch.einsum("mia,mib->mab", Jc, Jp), pw,
                     F * P).reshape(F, P, 6, 3)
    return Hcc, bc, Hpp, bp, W


def _solve_schur(Hcc, bc, Hpp, bp, W, point_valid, lam, n_fix: int):
    """Schur elimination of the points + reduced camera solve, array of
    structures (ref cpp:1011-1078; gauge handled by solving only for poses
    >= n_fix).  The (F,F,6,6) off-diagonal sum over points is one
    (6F,3P) x (3P,6F) matmul.  Returns (dx_cam (F,6), dX (P,3))."""
    F = Hcc.shape[0]
    P = Hpp.shape[0]
    dtype = Hcc.dtype
    dev = Hcc.device
    eye3 = torch.eye(3, dtype=dtype, device=dev)
    pv = point_valid[:, None, None]
    # damp + regularize invalid/under-constrained points
    diagp = torch.diagonal(Hpp, dim1=-2, dim2=-1)
    Hpp_d = Hpp + (lam * torch.clamp(diagp.amax(-1), min=1e-6)[:, None, None]
                   + 1e-9) * eye3
    Hpp_d = torch.where(pv, Hpp_d, eye3)
    Hpp_inv = torch.where(pv, linalg.inv3(Hpp_d), torch.zeros_like(Hpp_d))

    T = torch.einsum("fpij,pjk->fpik", W, Hpp_inv)          # (F,P,6,3)
    # rows (f,i), columns (p,k): S_off[(f,i),(g,j)] = sum_pk T W
    A2 = T.permute(0, 2, 1, 3).reshape(6 * F, 3 * P)
    B2 = W.permute(0, 2, 1, 3).reshape(6 * F, 3 * P)
    Sf = -(A2 @ B2.T)
    S4 = Sf.reshape(F, 6, F, 6)
    idx = torch.arange(F, device=dev)
    S4[idx, :, idx, :] += Hcc
    b = (bc - torch.einsum("fpik,pk->fi", T, bp)).reshape(6 * F)
    # LM damping on the camera diagonal; poses with NO observations
    # (fixed-capacity padding) get a unit prior
    dS = torch.diagonal(Sf)
    prior = torch.where(dS <= 0.0, 1.0, 0.0).to(dtype)
    Sf = Sf + torch.diag(lam * torch.clamp(dS, min=1e-6) + 1e-9 + prior)
    kfix = 6 * n_fix
    dx_red = linalg.solve_psd(Sf[kfix:, kfix:], -b[kfix:], jitter=1e-12)
    dx = torch.cat([torch.zeros(kfix, dtype=dtype, device=dev),
                    dx_red]).reshape(F, 6)

    # back-substitute points: dX = Hpp^{-1}(-bp - W^T dx)
    rhs = -bp - torch.einsum("fpik,fi->pk", W, dx)
    dX = torch.einsum("pij,pj->pi", Hpp_inv, rhs)
    return dx, dX


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
    (R_wc, t_wc, X, info dict).  Window-sized problems (F*P <= 8192) take
    the SoA layout, larger ones the AoS layout.  The accept/reject
    selection stays on the device (``torch.where``), so the loop makes no
    host sync (the AoS plans make one, before it)."""
    F = p.R_wc.shape[0]
    P = p.X.shape[0]
    soa = F * P <= _SOA_LIMIT
    plans = None if soa else _aos_plans(p)
    dtype = p.R_wc.dtype
    dev = p.R_wc.device
    R_wc, t_wc, X = p.R_wc, p.t_wc, p.X
    cost0 = ba_cost(p, huber_delta)
    cost = cost0
    lam = torch.as_tensor(lambda0, dtype=dtype, device=dev)
    hist = []
    for _ in range(iters):
        cur = p._replace(R_wc=R_wc, t_wc=t_wc, X=X)
        if soa:
            Hcc, bc, ApT = _linearize_soa(cur, huber_delta)
            dx, dX = _solve_schur_soa(Hcc, bc, ApT, p.point_valid, lam,
                                      n_fix)
        else:
            Hcc, bc, Hpp, bp, W = _linearize(cur, huber_delta, plans)
            dx, dX = _solve_schur(Hcc, bc, Hpp, bp, W, p.point_valid, lam,
                                  n_fix)
        # trial update: left-mult SE(3) on poses (ref cpp:1081-1095)
        dR = lie.so3_exp(dx[:, :3])
        R_try = dR @ R_wc
        t_try = torch.einsum("fij,fj->fi", dR, t_wc) + dx[:, 3:]
        X_try = X + dX if update_points else X
        trial = p._replace(R_wc=R_try, t_wc=t_try, X=X_try)
        new_cost = ba_cost(trial, huber_delta)
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


def _point_gather_plan(pid_idx, obs_valid, P: int, cap: int):
    """Scatter-free per-point reduction plan for a FIXED observation
    table: G[p, r] = index of point p's r-th valid observation (M when
    absent).  One stable argsort and one integer scatter here, then every
    LM iteration reduces with fixed-index gathers only: no float
    scatter-add, so the sums come out in one order on every run.  ``cap``
    bounds observations per point (the ring gives one per keyframe, so
    kf_cap is exact); rows past ``cap`` are dropped (they land in the
    dump row P), and under the opt-in numeric checks
    (``utils.debug``) a drop raises instead, as in the JAX twin.  With
    the checks off nothing here syncs with the host."""
    M = pid_idx.shape[0]
    dev = pid_idx.device
    seg = torch.where(obs_valid, pid_idx.long(),
                      torch.full_like(pid_idx.long(), P))
    order = torch.argsort(seg, stable=True)
    sorted_ids = seg[order]
    starts = torch.searchsorted(sorted_ids,
                                torch.arange(P, device=dev))
    rank = (torch.arange(M, device=dev)
            - starts[torch.clamp(sorted_ids, 0, P - 1)])
    real = sorted_ids < P
    if debug.numeric_checks_enabled():
        # a too-small cap silently under-assembles the Hessian; surface
        # it under the opt-in sanitizer flag (one host sync)
        overflow = int(torch.sum(real & (rank >= cap)))
        if overflow:
            raise FloatingPointError(
                f"_point_gather_plan: {overflow} observations exceed "
                f"max_obs_per_point={cap} and would be dropped")
    ok = real & (rank < cap)
    G = torch.full((P + 1, cap), M, dtype=torch.long, device=dev)
    G[torch.where(ok, sorted_ids, torch.full_like(sorted_ids, P)),
      torch.clamp(rank, 0, cap - 1)] = order       # row P: dump row
    return G[:P]


def _gathered_segment_sum(vals, G):
    """(M, ...) values -> (P, ...) per-point sums via the plan from
    ``_point_gather_plan`` (row M of the padded values is zero)."""
    pad = torch.cat([vals, vals.new_zeros((1, *vals.shape[1:]))])
    return pad[G].sum(dim=1)


def refine_points(p: BAProblem, iters: int = 5, lambda0: float = 1e-3,
                  huber_delta: float = 2e-3,
                  max_obs_per_point: int | None = None):
    """Structure-only LM: polish the map points against FROZEN poses.

    Monocular full-problem BA can lower reprojection error while bending
    the (weakly constrained) trajectory gauge, so the final refinement
    freezes poses and solves the independent per-point 3x3 GN systems only
    (the dual of the reference's cpp window BA, which updates poses and
    freezes points, cpp:1059-1060).  Returns (X, info).

    The per-point Hessian assembly always runs through the gather plan of
    ``_point_gather_plan`` with ``max_obs_per_point`` rows per point (the
    keyframe ring gives one observation per keyframe, so kf_cap is
    tight); without it the bound is the largest count of this table (one
    host pull)."""
    dtype, dev = p.X.dtype, p.X.device
    eye3 = torch.eye(3, dtype=dtype, device=dev)
    P_ = p.X.shape[0]
    cam, pid = p.cam_idx.long(), p.pid_idx.long()
    if max_obs_per_point is None:
        cnt = torch.bincount(pid[p.obs_valid], minlength=P_)
        max_obs_per_point = max(int(cnt.max()) if len(cnt) else 0, 1)
    plan = _point_gather_plan(pid, p.obs_valid, P_, max_obs_per_point)
    R_obs = p.R_wc[cam]
    pv_obs = p.point_valid[pid]

    X = p.X
    cost0 = ba_cost(p, huber_delta)
    cost = cost0
    lam = torch.as_tensor(lambda0, dtype=dtype, device=dev)
    hist = []
    for _ in range(iters):
        r, Xc, z_ok = _project_residuals(p.R_wc, p.t_wc, X, cam, pid,
                                         p.obs, p.obs_valid)
        w = _huber_weight(r, huber_delta) * (z_ok & pv_obs).to(dtype)
        z = torch.where(Xc[:, 2].abs() < 1e-6,
                        torch.full_like(Xc[:, 2], 1e-6), Xc[:, 2])
        inv_z = 1.0 / z
        x, y = Xc[:, 0], Xc[:, 1]
        zero = torch.zeros_like(inv_z)
        Jproj = torch.stack(
            [
                torch.stack([inv_z, zero, -x * inv_z * inv_z], dim=-1),
                torch.stack([zero, inv_z, -y * inv_z * inv_z], dim=-1),
            ],
            dim=-2,
        )
        Jp = torch.einsum("mij,mjk->mik", Jproj, R_obs) * w[:, None, None]
        rw = r * w[:, None]
        Hpp = _gathered_segment_sum(
            torch.einsum("mia,mib->mab", Jp, Jp), plan)
        bp = _gathered_segment_sum(torch.einsum("mia,mi->ma", Jp, rw), plan)
        diag = torch.diagonal(Hpp, dim1=-2, dim2=-1)
        damp = (lam * torch.clamp(diag.amax(-1), min=1e-6)[:, None, None]
                + 1e-9)
        Hd = Hpp + damp * eye3
        Hd = torch.where(p.point_valid[:, None, None], Hd, eye3)
        dX = -torch.einsum("pij,pj->pi", linalg.inv3(Hd), bp)
        X_try = torch.where(p.point_valid[:, None], X + dX, X)
        new_cost = ba_cost(p._replace(X=X_try), huber_delta)
        accept = new_cost < cost
        X = torch.where(accept, X_try, X)
        cost = torch.where(accept, new_cost, cost)
        lam = torch.where(accept, lam * 0.3, lam * 2.0)
        hist.append(cost)
    return X, {"cost0": cost0, "cost": cost,
               "cost_hist": torch.stack(hist) if hist else cost0[None][:0]}

"""Pose-graph optimization: batched SE(3) / Sim(3) LM + linear center-only
mode.

Counterpart of sfm_tpu/ops/posegraph.py (reference: python/src/
templering_sfm.py:601-700 ``PoseGraph`` — full SE(3) LM over poses 1..N-1
with translation modes full/dir/rot; cpp/src/templering_sfm.cpp:1131-1197
``posegraph_optimize_centers`` — translation-only linear least squares on
camera centers).

The residual of one edge is one function of its two nodes; its exact
Jacobian comes from ``torch.func.jacfwd`` over a 12- (SE(3)) or 14-wide
(Sim(3)) tangent, batched over edges with ``torch.func.vmap``, so the
number of tangents is independent of the node count N.  The per-edge
blocks are assembled into the dense normal equations with one-hot
matmuls (no scatter-add: the sums come out in one order on every run),
and the LM loop is a Python loop with the accept/reject selection on the
device.  Poses are camera-to-world (R_cw, C); pose 0 is the gauge and
stays fixed.  The host builds the problem in float64 and it is solved in
float64, as the JAX twin does under x64.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.func import jacfwd, vmap

from sfm_tpu_torch.ops import lie, linalg


class PoseGraphProblem(NamedTuple):
    R_cw: torch.Tensor  # (N,3,3)
    C: torch.Tensor  # (N,3) camera centers (t_cw)
    e_i: torch.Tensor  # (E,) int edge source
    e_j: torch.Tensor  # (E,) int edge target
    R_meas: torch.Tensor  # (E,3,3) measured R_ji
    t_meas: torch.Tensor  # (E,3) measured t_ji
    w_rot: torch.Tensor  # (E,)
    w_trans: torch.Tensor  # (E,)
    valid: torch.Tensor  # (E,) bool
    # optional per-edge override: True -> full (metric) translation
    # residual for this edge even in "dir" mode (pins the refreshed
    # odometry lengths, so that a dir-mode chain cannot slide its centers
    # along the fixed directions at zero cost)
    t_full: torch.Tensor | None = None


def _unit(t):
    return t / (torch.linalg.vector_norm(t) + 1e-12)


def _trans_residual(t_pred, t_meas, t_full, mode: str):
    if mode == "dir":
        return torch.where(t_full, t_pred - t_meas,
                           _unit(t_pred) - _unit(t_meas))
    if mode == "full":
        return t_pred - t_meas
    return torch.zeros_like(t_pred)  # "rot"


def _one_edge_residual(Ri, Ci, Rj, Cj, R_meas, t_meas, w_rot, w_trans,
                       valid, t_full, mode: str):
    """(6,) [rot | trans] residual of ONE edge (ref py:623-638)."""
    R_pred = Rj.T @ Ri
    t_pred = Rj.T @ (Ci - Cj)
    r_rot = lie.so3_log(R_meas.T @ R_pred)
    r_tr = _trans_residual(t_pred, t_meas, t_full, mode)
    r = torch.cat([r_rot * w_rot, r_tr * w_trans])
    return torch.where(valid, r, torch.zeros_like(r))


def _t_full_flags(p: PoseGraphProblem):
    return (p.t_full if p.t_full is not None
            else torch.zeros(p.e_i.shape[0], dtype=torch.bool,
                             device=p.e_i.device))


def _edge_args(p: PoseGraphProblem, R_cw, C):
    ei, ej = p.e_i.long(), p.e_j.long()
    return (R_cw[ei], C[ei], R_cw[ej], C[ej], p.R_meas, p.t_meas, p.w_rot,
            p.w_trans, p.valid, _t_full_flags(p))


def _edge_residuals(R_cw, C, p: PoseGraphProblem, mode: str):
    """(E,6) stacked [rot | trans] residuals (ref py:623-638)."""
    return vmap(lambda *a: _one_edge_residual(*a, mode))(
        *_edge_args(p, R_cw, C))


def _assemble_normal(N: int, D: int, e_i, e_j, r, Ji, Jj):
    """Per-edge Jacobian blocks (E,Dr,D) -> dense normal equations
    (H (N*D,N*D), g (N*D,)).

    Each edge touches its two nodes only, so its blocks land in four
    (D,D) tiles of H and two D-slices of g.  The JAX twin scatter-adds
    them; here the scatter is a contraction with the edges' one-hot node
    rows, which sums every tile in one fixed order."""
    dtype = Ji.dtype
    Oi = torch.nn.functional.one_hot(e_i.long(), N).to(dtype)  # (E,N)
    Oj = torch.nn.functional.one_hot(e_j.long(), N).to(dtype)
    JiTJi = torch.einsum("eri,erj->eij", Ji, Ji)
    JjTJj = torch.einsum("eri,erj->eij", Jj, Jj)
    JiTJj = torch.einsum("eri,erj->eij", Ji, Jj)
    H4 = (torch.einsum("en,em,eab->nmab", Oi, Oi, JiTJi)
          + torch.einsum("en,em,eab->nmab", Oj, Oj, JjTJj)
          + torch.einsum("en,em,eab->nmab", Oi, Oj, JiTJj)
          + torch.einsum("en,em,eab->nmab", Oj, Oi,
                         JiTJj.transpose(-1, -2)))
    g2 = (Oi.T @ torch.einsum("eri,er->ei", Ji, r)
          + Oj.T @ torch.einsum("eri,er->ei", Jj, r))
    H = H4.permute(0, 2, 1, 3).reshape(N * D, N * D)
    return H, g2.reshape(N * D)


def _with_value(f):
    """``f`` returning its value twice: as output and as jacfwd's aux."""
    def g(*a):
        r = f(*a)
        return r, r
    return g


def _lm_solve(H, g, lam, D: int, N: int):
    """Levenberg-Marquardt damping, the pose-0 gauge prior and the
    Cholesky solve of one step."""
    dtype, dev = H.dtype, H.device
    dH = torch.diagonal(H)
    H = H + torch.diag(lam * torch.clamp(dH, min=1e-8) + 1e-10)
    # gauge: freeze pose 0 rows/cols via a large prior
    prior = torch.cat([torch.full((D,), 1e12, dtype=dtype, device=dev),
                       torch.zeros(D * (N - 1), dtype=dtype, device=dev)])
    return linalg.solve_psd(H + torch.diag(prior), -g, jitter=1e-12)


def optimize_se3(p: PoseGraphProblem, mode: str = "dir", iters: int = 10,
                 lambda0: float = 0.01):
    """Full SE(3) pose-graph LM (python reference semantics, py:640-698).

    Pose 0 is fixed (gauge). Returns (R_cw, C, info)."""
    N = p.R_cw.shape[0]
    dtype, dev = p.R_cw.dtype, p.R_cw.device

    def f(dq, Ri, Ci, Rj, Cj, *rest):
        Ri2 = lie.so3_exp(dq[:3]) @ Ri
        Rj2 = lie.so3_exp(dq[6:9]) @ Rj
        return _one_edge_residual(Ri2, Ci + dq[3:6], Rj2, Cj + dq[9:12],
                                  *rest, mode)

    # exact per-edge Jacobian blocks (12 forward tangents, independent of
    # N); in_dims None: every edge is linearized at the same dq = 0
    per_edge = vmap(jacfwd(_with_value(f), has_aux=True),
                    in_dims=(None,) + (0,) * 10)
    z = torch.zeros(12, dtype=dtype, device=dev)

    def cost_of(R_cw, C):
        r = _edge_residuals(R_cw, C, p, mode)
        return torch.sum(r * r)

    R_cw, C = p.R_cw, p.C
    cost0 = cost_of(R_cw, C)
    cost = cost0
    lam = torch.as_tensor(lambda0, dtype=dtype, device=dev)
    hist = []
    for _ in range(iters):
        args = _edge_args(p, R_cw, C)
        J, r0e = per_edge(z, *args)                 # (E,6,12), (E,6)
        H, g = _assemble_normal(N, 6, p.e_i, p.e_j, r0e, J[..., :6],
                                J[..., 6:])
        dx = _lm_solve(H, g, lam, 6, N).reshape(N, 6)
        # left-multiplicative so3 on R_cw, additive on centers; pose 0
        # frozen
        dx = torch.cat([torch.zeros_like(dx[:1]), dx[1:]])
        R_try = lie.so3_exp(dx[:, :3]) @ R_cw
        C_try = C + dx[:, 3:]
        new_cost = cost_of(R_try, C_try)
        accept = new_cost < cost
        R_cw = torch.where(accept, R_try, R_cw)
        C = torch.where(accept, C_try, C)
        cost = torch.where(accept, new_cost, cost)
        lam = torch.where(accept, lam * 0.3, lam * 2.0)  # ref py:680-698
        hist.append(cost)
    return R_cw, C, {"cost0": cost0, "cost": cost,
                     "hist": torch.stack(hist) if hist else cost0[None][:0]}


def optimize_sim3(p: PoseGraphProblem, s_meas=None, mode: str = "dir",
                  iters: int = 10, lambda0: float = 0.01,
                  w_scale: float = 1.0):
    """Sim(3) pose-graph LM: per-node scale absorbs monocular scale drift
    (Strasdat-style 7-dof graph).

    Node i maps camera coords to world via ``x_w = s_i·R_cw,i·x_c + C_i``,
    so the predicted relative edge i→j is
      R_pred = R_jᵀR_i,  s_pred = s_i/s_j,  t_pred = R_jᵀ(C_i−C_j)/s_j.
    ``s_meas`` (E,) is the measured relative scale per edge (odometry
    edges 1.0, loop edges the drift the closure revealed).  Residuals:
    so3_log rotation, dir/full translation (as in ``optimize_se3``), and
    ``log(s_pred) − log(s_meas)``.

    Pose 0 fixes both the gauge and the global scale (s_0 ≡ 1).
    Returns (R_cw, C, s, info)."""
    N = p.R_cw.shape[0]
    dtype, dev = p.R_cw.dtype, p.R_cw.device
    if s_meas is None:
        s_meas = torch.ones(p.e_i.shape[0], dtype=dtype, device=dev)
    D = 7

    def one_edge(Ri, Ci, lsi, Rj, Cj, lsj, Rm, tm_, sm, wr, wt, val, tf):
        """(7,) [rot | trans | scale] residual of ONE edge."""
        R_pred = Rj.T @ Ri
        t_pred = Rj.T @ (Ci - Cj) / torch.exp(lsj)
        r_rot = lie.so3_log(Rm.T @ R_pred)
        r_tr = _trans_residual(t_pred, tm_, tf, mode)
        r_s = lsi - lsj - torch.log(torch.clamp(sm, min=1e-12))
        r = torch.cat([r_rot * wr, r_tr * wt, (w_scale * r_s)[None]])
        return torch.where(val, r, torch.zeros_like(r))

    def args_of(R_cw, C, log_s):
        ei, ej = p.e_i.long(), p.e_j.long()
        return (R_cw[ei], C[ei], log_s[ei], R_cw[ej], C[ej], log_s[ej],
                p.R_meas, p.t_meas, s_meas, p.w_rot, p.w_trans, p.valid,
                _t_full_flags(p))

    def f(dq, Ri, Ci, lsi, Rj, Cj, lsj, *rest):
        Ri2 = lie.so3_exp(dq[:3]) @ Ri
        Rj2 = lie.so3_exp(dq[7:10]) @ Rj
        return one_edge(Ri2, Ci + dq[3:6], lsi + dq[6], Rj2, Cj + dq[10:13],
                        lsj + dq[13], *rest)

    # per-edge exact Jacobian blocks (14 tangents, independent of N)
    per_edge = vmap(jacfwd(_with_value(f), has_aux=True),
                    in_dims=(None,) + (0,) * 13)
    z = torch.zeros(2 * D, dtype=dtype, device=dev)

    def cost_of(R_cw, C, log_s):
        r = vmap(one_edge)(*args_of(R_cw, C, log_s))
        return torch.sum(r * r)

    R_cw, C = p.R_cw, p.C
    log_s = torch.zeros(N, dtype=dtype, device=dev)
    cost0 = cost_of(R_cw, C, log_s)
    cost = cost0
    lam = torch.as_tensor(lambda0, dtype=dtype, device=dev)
    hist = []
    for _ in range(iters):
        args = args_of(R_cw, C, log_s)
        J, r0e = per_edge(z, *args)                 # (E,7,14), (E,7)
        H, g = _assemble_normal(N, D, p.e_i, p.e_j, r0e, J[..., :D],
                                J[..., D:])
        dx = _lm_solve(H, g, lam, D, N).reshape(N, D)
        dx = torch.cat([torch.zeros_like(dx[:1]), dx[1:]])
        R_try = lie.so3_exp(dx[:, :3]) @ R_cw
        C_try = C + dx[:, 3:6]
        ls_try = log_s + dx[:, 6]
        new_cost = cost_of(R_try, C_try, ls_try)
        accept = new_cost < cost
        R_cw = torch.where(accept, R_try, R_cw)
        C = torch.where(accept, C_try, C)
        log_s = torch.where(accept, ls_try, log_s)
        cost = torch.where(accept, new_cost, cost)
        lam = torch.where(accept, lam * 0.3, lam * 2.0)
        hist.append(cost)
    return R_cw, C, torch.exp(log_s), {
        "cost0": cost0, "cost": cost,
        "hist": torch.stack(hist) if hist else cost0[None][:0]}


def optimize_centers(p: PoseGraphProblem):
    """Translation-only linear solve on camera centers (C++ reference
    semantics, cpp:1131-1197): per edge the measured world-frame direction
    is scaled by the current estimated length; Jacobians are ±I; node 0 is
    the gauge. Rotations are untouched."""
    N = p.C.shape[0]
    dtype = p.C.dtype
    ei, ej = p.e_i.long(), p.e_j.long()
    Ri = p.R_cw[ei]
    # world direction of the measured edge: unit(R_cw,i · (−R_jiᵀ t_ji))
    d = -torch.einsum("eij,ej->ei", p.R_meas.transpose(-1, -2), p.t_meas)
    d = torch.einsum("eij,ej->ei", Ri, d)
    d = d / (torch.linalg.vector_norm(d, dim=-1, keepdim=True) + 1e-12)
    length = torch.linalg.vector_norm(p.C[ej] - p.C[ei], dim=-1,
                                      keepdim=True)
    d_meas = d * length  # cpp:1153-1157
    r = (p.C[ej] - p.C[ei]) - d_meas
    w = torch.where(p.valid, p.w_trans, torch.zeros_like(p.w_trans))

    # normal equations over centers: J has +I at j, −I at i per edge
    # (one-hot contractions, see _assemble_normal)
    Oi = torch.nn.functional.one_hot(ei, N).to(dtype)
    Oj = torch.nn.functional.one_hot(ej, N).to(dtype)
    D = Oj - Oi                                     # (E,N) edge incidence
    H = torch.einsum("en,e,em->nm", D, w, D)
    b = -(D.T @ (w[:, None] * r))
    # gauge fix node 0 (cpp:1179-1182)
    H[0, 0] += 1e9
    # one shared factorization solves all 3 coordinates (b is (N,3))
    L = torch.linalg.cholesky(
        H + 1e-9 * torch.eye(N, dtype=dtype, device=H.device))
    dC = torch.cholesky_solve(b, L)
    return p.R_cw, p.C + dC, {}

"""Umeyama Sim(3)/SE(3) alignment, ATE and relative-edge metrics.

Counterpart of sfm_tpu/ops/umeyama.py (reference: cpp/tools/
ate_keyframes.cpp:334-389 ``umeyama``, cpp/tools/gt_keyframe_edge.cpp:
333-384 relative-edge errors).  ``umeyama`` and ``ate`` compute in float64
whatever the inputs' dtype: these are the accuracy-critical reductions
that grade a run.  ``edge_errors`` keeps its inputs' dtype, as the JAX
twin does.
"""

from __future__ import annotations

import math

import torch

from sfm_tpu_torch.ops import lie, linalg


def umeyama(src, dst, with_scale: bool = True):
    """Least-squares similarity transform aligning src -> dst.

    Args:
      src, dst: (N,3) point sets.
      with_scale: Sim(3) if True, SE(3) (s=1) if False.
    Returns:
      (s, R, t) with dst ≈ s * R @ src + t.
    """
    src = torch.as_tensor(src).to(torch.float64)
    dst = torch.as_tensor(dst).to(torch.float64)
    n = src.shape[0]
    mu_s = torch.mean(src, dim=0)
    mu_d = torch.mean(dst, dim=0)
    xs = src - mu_s
    xd = dst - mu_d
    cov = (xd.T @ xs) / n  # (1/N) Σ yx^T, ref ate_keyframes.cpp:338-363
    u, s, vt = linalg.svd3_jacobi(cov)
    d = torch.sign(linalg.det3(u) * linalg.det3(vt))
    Dd = torch.ones(3, dtype=cov.dtype, device=cov.device)
    Dd[2] = d
    R = u @ torch.diag(Dd) @ vt
    var_s = torch.sum(xs * xs) / n
    if with_scale:
        scale = torch.sum(s * Dd) / torch.clamp(var_s, min=1e-18)
    else:
        scale = torch.ones((), dtype=cov.dtype, device=cov.device)
    t = mu_d - scale * R @ mu_s
    return scale, R, t


def ate(est, gt, with_scale: bool = True):
    """Absolute trajectory error after Umeyama alignment.

    Returns dict with rmse/mean/median/max and per-point errors,
    matching ate_keyframes.cpp:442-474 outputs.
    """
    est = torch.as_tensor(est).to(torch.float64)
    gt = torch.as_tensor(gt).to(torch.float64)
    s, R, t = umeyama(est, gt, with_scale)
    aligned = s * est @ R.T + t
    err = torch.linalg.vector_norm(aligned - gt, dim=-1)
    return {
        "rmse": torch.sqrt(torch.mean(err ** 2)),
        "mean": torch.mean(err),
        "median": linalg.nanmedian(err),
        "max": torch.max(err),
        "per_point": err,
        "scale": s,
    }


def edge_errors(R_est, t_est, R_gt, t_gt):
    """Relative-edge rotation error (deg) and translation-direction error
    (deg, min vs ±GT direction) — ref gt_keyframe_edge.cpp:377-384."""
    dR = R_est @ R_gt.transpose(-1, -2)
    rot_err = (torch.linalg.vector_norm(lie.so3_log(dR), dim=-1)
               * (180.0 / math.pi))
    a = t_est / (torch.linalg.vector_norm(t_est, dim=-1, keepdim=True)
                 + 1e-18)
    b = t_gt / (torch.linalg.vector_norm(t_gt, dim=-1, keepdim=True) + 1e-18)
    c = torch.clamp(torch.abs(torch.sum(a * b, dim=-1)), 0.0, 1.0)
    trans_err = torch.arccos(c) * (180.0 / math.pi)
    return rot_err, trans_err

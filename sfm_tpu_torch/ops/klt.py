"""Pyramidal Lucas-Kanade optical flow, batched over all tracks.

Counterpart of sfm_tpu/ops/klt.py (reference: cpp/src/templering_sfm.cpp:
307-466 ``KLTTracker``: coarse-to-fine per-track LK with 2x2 normal
equations over a (2r+1)^2 patch, forward+backward gating).

Each track loads ONE contiguous window per pyramid level; every LK
iteration is window algebra on it: bilinear interpolation with a per-track
fractional offset is four shifted multiplies, the image gradients are +-1
shifted reads of the same window.  The window margin bounds the per-level
search range; flows that drift outside are clamped by the window and
rejected by the forward-backward gate.

On the card one level is ONE launch of the fused CUDA kernel
(ops/kernels/lk_kernels.lk_level_fused: gather + template + all
iterations); on the CPU it is the plain version in the same module.
"""

from __future__ import annotations

import torch

from sfm_tpu_torch.ops.kernels import lk_kernels
from sfm_tpu_torch.ops.kernels.lk_kernels import (  # noqa: F401
    MARGIN, _bil_t, _load_blocks, _qf)
from sfm_tpu_torch.utils.device import resolve, to_device


def _lk_level(img0, img1, p0_l, v, iters: int, radius: int, min_det: float,
              margin: int = MARGIN):
    """Run ``iters`` LK updates at one pyramid level for all tracks.

    p0_l: (T,2) template positions at this level; v: (T,2) current flow.
    Returns the updated flow v."""
    return lk_kernels.lk_level_fused(img0, img1, p0_l, v, iters, radius,
                                     min_det, margin)


def lk_track(pyr0, pyr1, pts, valid, levels: int, iters: int, radius: int,
             min_det: float = 1e-4, device="cuda"):
    """Track ``pts`` from pyramid ``pyr0`` to ``pyr1`` (finest-first tuples).

    Returns (new_pts (T,2), ok (T,) bool). ref: cpp:402-460 coarse-to-fine.
    """
    dev = resolve(device)
    pyr0 = tuple(to_device(p, dev, torch.float32).contiguous() for p in pyr0)
    pyr1 = tuple(to_device(p, dev, torch.float32).contiguous() for p in pyr1)
    pts = to_device(pts, dev, torch.float32)
    valid = to_device(valid, dev)
    v = torch.zeros_like(pts)
    for L in range(levels - 1, -1, -1):
        scale = float(2 ** L)
        p0_l = pts / scale
        v = _lk_level(pyr0[L], pyr1[L], p0_l, v, iters, radius, min_det)
        if L > 0:
            v = v * 2.0
    new_pts = pts + v
    H, W = pyr1[0].shape
    b = float(radius)
    inb = ((new_pts[:, 0] >= b) & (new_pts[:, 0] < W - b)
           & (new_pts[:, 1] >= b) & (new_pts[:, 1] < H - b))
    return new_pts, valid & inb


def lk_track_fb(pyr0, pyr1, pts, valid, levels: int, iters: int, radius: int,
                fb_thresh: float = 1.0, device="cuda"):
    """Forward-backward LK with fb-error gating (ref: cpp:356-367).
    Returns (new_pts, ok).

    The backward pass re-tracks from scratch (full pyramid): a forward
    match stuck in a false minimum would trivially pass a check that is
    merely initialized at the negative forward flow."""
    dev = resolve(device)
    pts = to_device(pts, dev, torch.float32)
    fwd, ok_f = lk_track(pyr0, pyr1, pts, valid, levels, iters, radius,
                         device=dev)
    back, ok_b = lk_track(pyr1, pyr0, fwd, ok_f, levels, iters, radius,
                          device=dev)
    fb = torch.linalg.vector_norm(back - pts, dim=-1)
    ok = ok_f & ok_b & (fb < fb_thresh)
    return fwd, ok

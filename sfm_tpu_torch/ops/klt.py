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

One level runs through one of three arms, chosen as the JAX twin chooses
(sfm_tpu/ops/klt.py:319-412), with its environment switches read at call
time ("0" turns an arm off; both default on):

  (a) equal image shapes and SFM_TPU_LK_FUSED_TMPL not "0": ONE launch of
      the fused kernel K3 (gather + template + all iterations);
  (b) the shapes differ, or SFM_TPU_LK_FUSED_TMPL=0 (given a positive
      margin, a window that fits img1 and SFM_TPU_LK_FUSED not "0"): the
      template and search windows through the gather kernel K5, the
      template patch in PyTorch, all iterations in the kernel K4;
  (c) SFM_TPU_LK_FUSED=0 (or no margin, or a window wider than img1):
      windows through K5, the iteration loop in PyTorch (the JAX twin runs
      it as an XLA loop outside any kernel).

The JAX twin's SFM_TPU_PALLAS (which on the card would run no kernel) is
not read.  On the CPU every kernel is its plain version
(ops/kernels/lk_kernels).

Block storage (``lk_dtype``): SFM_TPU_LK_BF16=1 stores both pyramids in
bfloat16 from the first level on (``lk_track`` casts them, as the JAX
twin's does); anything else, unset included, keeps float32 (the JAX
package's default off a TPU).  Positions, flows, templates and every sum
stay float32: the kernels and plain versions upcast each pixel they read.

Scene axis (the multi-scene runner, parallel/multi_scan): ``lk_track`` and
``lk_track_fb`` also take scene-stacked pyramids, each level (S,H_L,W_L),
with points (S,T,2) and masks (S,T).  Each arm sends the whole stack to
one call per step, as the JAX twin does under ``jax.vmap``: arm (a) ONE
launch of K3 per level and direction; arm (b) two launches of K5 (the
template and the search windows) and one of K4; arm (c) two of K5 and one
pass of the plain iteration loop.  Every scene's result is the
single-scene one, bit for bit.
"""

from __future__ import annotations

import os

import torch

from sfm_tpu_torch.ops.kernels import lk_kernels
from sfm_tpu_torch.ops.kernels.lk_kernels import MARGIN, _load_blocks
from sfm_tpu_torch.utils.device import resolve, to_device


def _env_on(name: str) -> bool:
    """An arm switch of the JAX twin: anything but "0" leaves it on."""
    return os.environ.get(name, "").strip() != "0"


def lk_dtype() -> torch.dtype:
    """Block-storage dtype of the LK images (the JAX twin's ``_lk_dtype``):
    bfloat16 when SFM_TPU_LK_BF16 is "1", else float32.  Read at every
    call, as the arm switches are: the JAX twin memoizes its choice
    (``_LK_DTYPE_RESOLVED``) only because it is read at trace time inside
    jitted callers whose compile cache does not see the variable."""
    return (torch.bfloat16
            if os.environ.get("SFM_TPU_LK_BF16", "").strip() == "1"
            else torch.float32)


def _lk_level(img0, img1, p0_l, v, iters: int, radius: int, min_det: float,
              margin: int = MARGIN):
    """Run ``iters`` LK updates at one pyramid level for all tracks.

    p0_l: (T,2) template positions at this level; v: (T,2) current flow
    (or (S,H,W) images with (S,T,2) positions and flows for S scenes).
    The images are float32 or bfloat16 (``lk_dtype``).  Returns the
    updated flow v."""
    P = 2 * radius + 1
    WIN = P + 2 * margin + 3
    H1, W1 = img1.shape[-2:]
    fused_ok = (margin > 0 and H1 >= WIN and W1 >= WIN
                and _env_on("SFM_TPU_LK_FUSED"))
    if (fused_ok and _env_on("SFM_TPU_LK_FUSED_TMPL")
            and img0.shape == img1.shape):
        return lk_kernels.lk_level_fused(img0, img1, p0_l, v, iters, radius,
                                         min_det, margin)
    # arms (b) and (c): K5 windows of img0 (clamped to img0's own size) and
    # of img1, the template built here as the JAX twin builds it outside
    # its kernel; all scenes of a stack in each call
    o0 = p0_l - radius
    blk0, a0 = _load_blocks(img0, o0, P, 0, lk_kernels.lk_gather)
    tmpl = lk_kernels.template_patch(blk0, a0, o0, P)
    blk1, a1 = _load_blocks(img1, p0_l + v - radius, P, margin,
                            lk_kernels.lk_gather)
    if fused_ok:
        return lk_kernels.lk_level_tmpl(blk1, tmpl, o0 - a1, v, iters,
                                        min_det)
    # the loop outside any kernel, its origin formed as the XLA path's
    return lk_kernels._lk_iterate_plain(
        blk1, tmpl, lambda v: p0_l + v - radius - a1, v, iters, min_det)


def lk_track(pyr0, pyr1, pts, valid, levels: int, iters: int, radius: int,
             min_det: float = 1e-4, device="cuda"):
    """Track ``pts`` from pyramid ``pyr0`` to ``pyr1`` (finest-first tuples).

    Returns (new_pts (T,2), ok (T,) bool). ref: cpp:402-460 coarse-to-fine.
    Scene-stacked pyramids (levels (S,H_L,W_L)) with (S,T,2) points give
    (S,T,2) and (S,T); each scene is bounds-tested against its own image.
    Both pyramids are stored in ``lk_dtype()`` for the whole pass.
    """
    dev = resolve(device)
    dt = lk_dtype()
    pyr0 = tuple(to_device(p, dev, dt).contiguous() for p in pyr0)
    pyr1 = tuple(to_device(p, dev, dt).contiguous() for p in pyr1)
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
    H, W = pyr1[0].shape[-2:]
    b = float(radius)
    inb = ((new_pts[..., 0] >= b) & (new_pts[..., 0] < W - b)
           & (new_pts[..., 1] >= b) & (new_pts[..., 1] < H - b))
    return new_pts, valid & inb


def lk_track_fb(pyr0, pyr1, pts, valid, levels: int, iters: int, radius: int,
                fb_thresh: float = 1.0, device="cuda"):
    """Forward-backward LK with fb-error gating (ref: cpp:356-367).
    Returns (new_pts, ok); scene-stacked inputs as in ``lk_track``.

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

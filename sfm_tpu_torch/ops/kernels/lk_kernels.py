"""K2/K3 — LK window gather and fused LK level: CUDA wrappers + plain versions.

Counterpart of sfm_tpu/ops/pallas/block_gather_kernel.py
(``load_blocks_pair_pallas``) and sfm_tpu/ops/pallas/lk_iter_kernel.py
(``lk_iter_tmpl_pallas``); CUDA sources: csrc/lk_gather_pair.cu,
csrc/lk_level_fused.cu (shared window addressing in csrc/lk_common.cuh).

The plain versions are the port of the XLA ``fori_loop`` path of
sfm_tpu/ops/klt._lk_level: ``_load_blocks`` (here a direct window gather
by index), ``_qf``, ``_bil_t`` and the loop body.  Block storage is
float32 only.  A wrapper launches its kernel for CUDA tensors (or raises)
and takes the plain version only for CPU tensors.

Layout: tracks lead — blocks are (T, WIN, WIN), patches (T, P, P).  (The
JAX twin keeps tracks on the last axis for the TPU's lanes.)
"""

from __future__ import annotations

import torch

from sfm_tpu_torch.ops.kernels import build

MARGIN = 6  # per-level search margin in px beyond the patch

gather_launches = 0  # launches of the K2 gather kernel (plain int)
level_launches = 0   # launches of the K3 fused level kernel (plain int)


# ---------------------------------------------------------------------------
# window addressing (shared by the plain versions and the wrappers)
# ---------------------------------------------------------------------------


def window_start(origins, back: int, H: int, W: int, win: int):
    """Float top-left start of the ``win`` window around float patch
    ``origins`` (T,2): floor(nan_to_num(o)) - back, clipped to the image.

    Dead/lost slots can carry non-finite positions; NaN survives a clip and
    casts to an undefined integer, so sanitize before anything is cast."""
    start = torch.floor(torch.nan_to_num(origins)) - float(back)
    hi = torch.tensor([W - win, H - win], dtype=origins.dtype,
                      device=origins.device)
    return torch.minimum(torch.clamp(start, min=0.0), hi)


def _clamp_starts(starts, H: int, W: int, win: int):
    sx = torch.clamp(starts[:, 0], 0, max(W - win, 0))
    sy = torch.clamp(starts[:, 1], 0, max(H - win, 0))
    return sx.to(torch.int64), sy.to(torch.int64)


def _gather_windows(img, starts, win: int):
    """(T,win,win) windows of ``img`` at integer ``starts`` (T,2) = (x,y),
    clamped to the image: plain slicing, as one advanced-index gather."""
    H, W = img.shape
    sx, sy = _clamp_starts(starts, H, W, win)
    ar = torch.arange(win, device=img.device)
    rows = (sy[:, None] + ar)[:, :, None]
    cols = (sx[:, None] + ar)[:, None, :]
    return img[rows, cols]


# ---------------------------------------------------------------------------
# K2: pair gather
# ---------------------------------------------------------------------------


def lk_gather_pair_plain(img0, starts0, win0: int, img1, starts1, win1: int):
    """Template windows (T,win0,win0) of img0 and search windows
    (T,win1,win1) of img1 at integer starts (T,2), clamped to the image."""
    return (_gather_windows(img0, starts0, win0),
            _gather_windows(img1, starts1, win1))


def _check_image_pair(img0, img1, win: int, name: str):
    for im_ in (img0, img1):
        if im_.dtype != torch.float32 or im_.dim() != 2:
            raise TypeError(f"{name} takes 2-D float32 images, got "
                            f"{tuple(im_.shape)} {im_.dtype}")
        if not im_.is_contiguous():
            raise ValueError(f"{name} needs contiguous images")
    if img0.shape != img1.shape or img0.device != img1.device:
        raise ValueError(f"{name} needs two images of one shape on one "
                         f"device, got {tuple(img0.shape)} on {img0.device} "
                         f"and {tuple(img1.shape)} on {img1.device}")
    H, W = img1.shape
    if H < win or W < win:
        raise ValueError(f"{name}: image {H}x{W} smaller than the "
                         f"{win}-px window")


def _lk_gather_pair_cuda(img0, starts0, win0, img1, starts1, win1):
    global gather_launches
    _check_image_pair(img0, img1, max(win0, win1), "lk_gather_pair")
    T = starts0.shape[0]
    for s in (starts0, starts1):
        if (s.dtype != torch.int32 or s.shape != (T, 2)
                or s.device != img0.device or not s.is_contiguous()):
            raise TypeError("lk_gather_pair takes contiguous int32 starts "
                            "(T,2) on the images' device")
    lib = build.load()
    H, W = img0.shape
    out0 = torch.empty((T, win0, win0), dtype=torch.float32,
                       device=img0.device)
    out1 = torch.empty((T, win1, win1), dtype=torch.float32,
                       device=img0.device)
    with torch.cuda.device(img0.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.sfm_lk_gather_pair(
            img0.data_ptr(), img1.data_ptr(), H, W, starts0.data_ptr(),
            starts1.data_ptr(), T, int(win0), int(win1), out0.data_ptr(),
            out1.data_ptr(), stream)
    build.check_launch(code, "lk_gather_pair")
    gather_launches += 1
    return out0, out1


def lk_gather_pair(img0, starts0, win0: int, img1, starts1, win1: int):
    """K2. CUDA tensors -> kernel, CPU tensors -> plain slicing."""
    if img0.is_cuda:
        return _lk_gather_pair_cuda(img0, starts0, win0, img1, starts1, win1)
    return lk_gather_pair_plain(img0, starts0, win0, img1, starts1, win1)


# ---------------------------------------------------------------------------
# K3: fused LK level
# ---------------------------------------------------------------------------


def _load_blocks(img, origins, P: int, margin: int):
    """One contiguous square block per track around each float patch
    origin. Returns (blocks (T,WIN,WIN), anchors (T,2) float top-left)."""
    WIN = P + 2 * margin + 3  # +1 bilinear, +2 gradient shifts
    H, W = img.shape
    if H < WIN or W < WIN:
        raise ValueError(f"image {H}x{W} smaller than the {WIN}-px LK block")
    start = window_start(origins, margin + 1, H, W, WIN)
    return _gather_windows(img, start.to(torch.int32), WIN), start


def _qf(origins, anchors, P: int, WINx: int, WINy: int):
    """Integer sub-window origin (clipped per axis) + fractional rest.

    The fraction is NOT clamped: where the clip bites it extrapolates.  A
    NaN position keeps a NaN fraction (its flow comes out NaN) and gets
    origin 0 so that the gather below stays in range."""
    q = origins - anchors
    hi = torch.tensor([WINx - P - 2.0, WINy - P - 2.0], dtype=q.dtype,
                      device=q.device)
    qi = torch.minimum(torch.clamp(torch.floor(q), min=1.0), hi)
    qii = torch.nan_to_num(qi, nan=1.0).to(torch.int64) - 1
    return qii, q - qi


def _sub_windows(B, qii, S: int):
    """sub[t,i,j] = B[t, qii_y+i, qii_x+j] for i,j < S (per-track
    dynamic slice; selects what the JAX twin's barrel shifter selects)."""
    T, WINy, WINx = B.shape
    ar = torch.arange(S, device=B.device)
    rows = (qii[:, 1, None] + ar)[:, :, None]
    cols = (qii[:, 0, None] + ar)[:, None, :]
    lin = (rows * WINx + cols).reshape(T, S * S)
    return B.reshape(T, WINy * WINx).gather(1, lin).reshape(T, S, S)


def _bil_t(block, fx, fy, P: int, ox: int, oy: int):
    """(T,P,P) bilinear patch from (T,S,S) sub-blocks at static pixel
    offset (ox,oy) in {-1,0,1} and per-track fractions fx/fy."""
    y0 = 1 + oy
    x0 = 1 + ox
    w00 = block[:, y0: y0 + P, x0: x0 + P]
    w01 = block[:, y0: y0 + P, x0 + 1: x0 + P + 1]
    w10 = block[:, y0 + 1: y0 + P + 1, x0: x0 + P]
    w11 = block[:, y0 + 1: y0 + P + 1, x0 + 1: x0 + P + 1]
    fx = fx[:, None, None]
    fy = fy[:, None, None]
    return (
        w00 * (1.0 - fx) * (1.0 - fy)
        + w01 * fx * (1.0 - fy)
        + w10 * (1.0 - fx) * fy
        + w11 * fx * fy
    )


def lk_level_plain(img0, img1, p0_l, v, iters: int, radius: int,
                   min_det: float, margin: int = MARGIN):
    """``iters`` LK updates at one pyramid level for all tracks, in plain
    PyTorch (port of the XLA path of sfm_tpu/ops/klt._lk_level)."""
    P = 2 * radius + 1
    S = P + 3
    # template: fixed patch from img0 (no search margin)
    blk0, a0 = _load_blocks(img0, p0_l - radius, P, margin=0)
    # target: one block per track with the search margin, loaded once
    blk1, a1 = _load_blocks(img1, p0_l + v - radius, P, margin=margin)
    WINy0, WINx0 = blk0.shape[1], blk0.shape[2]
    WINy1, WINx1 = blk1.shape[1], blk1.shape[2]

    qii0, f0 = _qf(p0_l - radius, a0, P, WINx0, WINy0)
    tmpl = _bil_t(_sub_windows(blk0, qii0, S), f0[:, 0], f0[:, 1], P, 0, 0)

    for _ in range(iters):
        origins = p0_l + v - radius
        qii, f = _qf(origins, a1, P, WINx1, WINy1)
        sub = _sub_windows(blk1, qii, S)
        fx, fy = f[:, 0], f[:, 1]
        cur = _bil_t(sub, fx, fy, P, 0, 0)
        gx = 0.5 * (_bil_t(sub, fx, fy, P, 1, 0)
                    - _bil_t(sub, fx, fy, P, -1, 0))
        gy = 0.5 * (_bil_t(sub, fx, fy, P, 0, 1)
                    - _bil_t(sub, fx, fy, P, 0, -1))
        r = tmpl - cur
        gxx = torch.sum(gx * gx, dim=(1, 2))
        gxy = torch.sum(gx * gy, dim=(1, 2))
        gyy = torch.sum(gy * gy, dim=(1, 2))
        bx = torch.sum(gx * r, dim=(1, 2))
        by = torch.sum(gy * r, dim=(1, 2))
        det = gxx * gyy - gxy * gxy
        inv_det = torch.where(det.abs() > min_det, 1.0 / det,
                              torch.zeros_like(det))
        dvx = (gyy * bx - gxy * by) * inv_det
        dvy = (gxx * by - gxy * bx) * inv_det
        v = v + torch.stack([dvx, dvy], dim=-1)
    return v


def _lk_level_fused_cuda(img0, img1, p0_l, v, iters, radius, min_det,
                         margin):
    global level_launches
    P = 2 * radius + 1
    WIN = P + 2 * margin + 3
    _check_image_pair(img0, img1, WIN, "lk_level_fused")
    if margin <= 0:
        raise ValueError("lk_level_fused needs a positive search margin")
    T = p0_l.shape[0]
    for a in (p0_l, v):
        if (a.dtype != torch.float32 or a.shape != (T, 2)
                or a.device != img0.device):
            raise TypeError("lk_level_fused takes float32 (T,2) positions "
                            "and flows on the images' device")
    p0_l = p0_l.contiguous()
    v = v.contiguous()
    lib = build.load()
    H, W = img0.shape
    out = torch.empty((T, 2), dtype=torch.float32, device=img0.device)
    with torch.cuda.device(img0.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.sfm_lk_level_fused(
            img0.data_ptr(), img1.data_ptr(), H, W, p0_l.data_ptr(),
            v.data_ptr(), T, int(radius), int(margin), int(iters),
            float(min_det), out.data_ptr(), stream)
    build.check_launch(code, "lk_level_fused")
    level_launches += 1
    return out


def lk_level_fused(img0, img1, p0_l, v, iters: int, radius: int,
                   min_det: float, margin: int = MARGIN):
    """K3. CUDA tensors -> the fused kernel (gather + template + all
    iterations in one launch), CPU tensors -> ``lk_level_plain``."""
    if img1.is_cuda:
        return _lk_level_fused_cuda(img0, img1, p0_l, v, iters, radius,
                                    min_det, margin)
    return lk_level_plain(img0, img1, p0_l, v, iters, radius, min_det,
                          margin)

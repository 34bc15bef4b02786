"""Image primitives: pyramids, gradients, batched bilinear sampling.

Counterpart of sfm_tpu/ops/image.py (reference: cpp/src/templering_sfm.cpp:
183-232 — bilinear ``sample``, 2x2 box ``downsample2``, ``build_pyr``).
Plain functions on (H,W) tensors; they run on whatever device the image
lies on.
"""

from __future__ import annotations

import torch


def downsample2(img):
    """2x2 box-filter downsample (ref: cpp:200-218). Truncates odd edges."""
    H, W = img.shape
    H2, W2 = H // 2, W // 2
    x = img[: H2 * 2, : W2 * 2].reshape(H2, 2, W2, 2)
    return x.mean(dim=(1, 3))


def build_pyramid(img, levels: int):
    """List of ``levels`` images, finest first (ref: cpp:220-232)."""
    pyr = [img]
    for _ in range(levels - 1):
        pyr.append(downsample2(pyr[-1]))
    return pyr


def gradients(img):
    """Central-difference gradients (gx, gy), zero at borders
    (ref: cpp shi_tomasi uses the same stencil, cpp:243-249)."""
    gx = torch.zeros_like(img)
    gy = torch.zeros_like(img)
    gx[:, 1:-1] = 0.5 * (img[:, 2:] - img[:, :-2])
    gy[1:-1, :] = 0.5 * (img[2:, :] - img[:-2, :])
    return gx, gy


def bilinear(img, xy):
    """Bilinear sample ``img`` (H,W) at points ``xy`` (...,2) in (x,y) pixel
    coords; clamps to the valid domain (ref: cpp:183-198)."""
    H, W = img.shape
    x = torch.clamp(xy[..., 0], 0.0, W - 1.0)
    y = torch.clamp(xy[..., 1], 0.0, H - 1.0)
    x0 = torch.floor(x).to(torch.int64)
    y0 = torch.floor(y).to(torch.int64)
    fx = x - x0
    fy = y - y0
    x1 = torch.clamp(x0 + 1, max=W - 1)
    y1 = torch.clamp(y0 + 1, max=H - 1)
    v00 = img[y0, x0]
    v01 = img[y0, x1]
    v10 = img[y1, x0]
    v11 = img[y1, x1]
    return (
        v00 * (1 - fx) * (1 - fy)
        + v01 * fx * (1 - fy)
        + v10 * (1 - fx) * fy
        + v11 * fx * fy
    )


def _shift_zero(x, d: int, dim: int):
    """out[i] = x[i-d] along ``dim``, zeros shifted in (d of either sign)."""
    out = torch.zeros_like(x)
    n = x.shape[dim]
    if d > 0:
        out.narrow(dim, d, n - d).copy_(x.narrow(dim, 0, n - d))
    elif d < 0:
        out.narrow(dim, 0, n + d).copy_(x.narrow(dim, -d, n + d))
    else:
        out.copy_(x)
    return out


def box_filter(img, radius: int):
    """(2r+1)^2 box sum over the last two axes with zero boundary
    contributions (ref cpp:252-263), by 2r shifted adds per axis; an
    (H,W) image or a batch (...,H,W) of planes (the stereo cost volume).

    Not the cumulative-sum differences of the JAX twin: a float32
    cumulative sum over a 480-row image of squared gradients reaches ~1e7
    and its differences carry an absolute error of ~1, some 1e-4 of a
    strong corner's response; the direct sum's error is 1e-7 relative.
    The summation order is that of the CUDA kernel (centre, then -d, +d
    outward; rows first), so the kernel is held to it at rounding level."""
    row = img
    for d in range(1, radius + 1):
        row = row + _shift_zero(img, d, -1) + _shift_zero(img, -d, -1)
    out = row
    for d in range(1, radius + 1):
        out = out + _shift_zero(row, d, -2) + _shift_zero(row, -d, -2)
    return out

"""K1 — Shi-Tomasi corner-response map: CUDA kernel wrapper + plain version.

Counterpart of sfm_tpu/ops/pallas/shi_tomasi_kernel.py
(``shi_tomasi_score_pallas``); CUDA source: csrc/shi_tomasi.cu.

``shi_tomasi_score`` launches the kernel for a CUDA tensor (or raises) and
takes ``shi_tomasi_score_plain`` only for a CPU tensor.  Both use the plain
version's border semantics (zero gradient on the image border, zero-padded
box sum), so they agree on the whole map.
"""

from __future__ import annotations

import torch

from sfm_tpu_torch.ops import image as im
from sfm_tpu_torch.ops.kernels import build

launches = 0  # kernel launches made by shi_tomasi_score (plain int)

MAX_RADIUS = 8  # shared-memory tile budget of the kernel


def shi_tomasi_score_plain(img, block_radius: int = 2):
    """Min-eigenvalue corner response map (H,W); ref cpp:237-269.

    Same formula as sfm_tpu/ops/features.shi_tomasi_score; the box sums are
    direct shifted adds (``image.box_filter``) rather than the JAX twin's
    cumulative-sum differences — same function, float32 error 1e-7
    relative instead of ~1 absolute."""
    gx, gy = im.gradients(img)
    a = im.box_filter(gx * gx, block_radius)
    b = im.box_filter(gx * gy, block_radius)
    c = im.box_filter(gy * gy, block_radius)
    tr = a + c
    det = a * c - b * b
    disc = torch.sqrt(torch.clamp(tr * tr - 4.0 * det, min=0.0))
    return 0.5 * (tr - disc)


def _shi_tomasi_score_cuda(img, block_radius: int):
    global launches
    if img.dtype != torch.float32 or img.dim() != 2:
        raise TypeError(f"shi_tomasi_score kernel takes a 2-D float32 image, "
                        f"got {tuple(img.shape)} {img.dtype}")
    if not img.is_contiguous():
        raise ValueError("shi_tomasi_score kernel needs a contiguous image")
    if not 1 <= block_radius <= MAX_RADIUS:
        raise ValueError(f"block_radius {block_radius} outside "
                         f"[1, {MAX_RADIUS}]")
    lib = build.load()
    H, W = img.shape
    out = torch.empty_like(img)
    with torch.cuda.device(img.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.sfm_shi_tomasi(img.data_ptr(), H, W, int(block_radius),
                                  out.data_ptr(), stream)
    build.check_launch(code, "shi_tomasi")
    launches += 1
    return out


def shi_tomasi_score(img, block_radius: int = 2):
    """Corner response map; CUDA tensor -> kernel, CPU tensor -> plain."""
    if img.is_cuda:
        return _shi_tomasi_score_cuda(img, block_radius)
    return shi_tomasi_score_plain(img, block_radius)

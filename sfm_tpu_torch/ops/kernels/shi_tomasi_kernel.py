"""K1 — Shi-Tomasi corner-response map: CUDA kernel wrapper + plain version.

Counterpart of sfm_tpu/ops/pallas/shi_tomasi_kernel.py
(``shi_tomasi_score_pallas``); CUDA source: csrc/shi_tomasi.cu.

``shi_tomasi_score`` launches the kernel for a CUDA tensor (or raises) and
takes ``shi_tomasi_score_plain`` only for a CPU tensor; under the numeric
checks (``utils.debug``) it checks the kernel's map for NaN/Inf.  Both use
the plain version's border semantics (zero gradient on the image border,
zero-padded box sum), so they agree on the whole map.

Both take one (H,W) image or a stack of scenes' images (S,H,W), the axis
the JAX twin gets under ``jax.vmap`` (sfm_tpu/parallel/multi_scan.py): the
kernel maps the whole stack in one launch, the plain version scene by
scene.
"""

from __future__ import annotations

import torch

from sfm_tpu_torch.ops import image as im
from sfm_tpu_torch.ops.kernels import build
from sfm_tpu_torch.utils import debug

launches = 0  # kernel launches made by shi_tomasi_score (plain int)

MAX_RADIUS = 8  # the kernel is compiled for radius 1..MAX_RADIUS


def shi_tomasi_score_plain(img, block_radius: int = 2):
    """Min-eigenvalue corner response map (H,W), or (S,H,W) for a stack;
    ref cpp:237-269.

    Same formula as sfm_tpu/ops/features.shi_tomasi_score; the box sums are
    direct shifted adds (``image.box_filter``) rather than the JAX twin's
    cumulative-sum differences — same function, float32 error 1e-7
    relative instead of ~1 absolute."""
    if img.dim() == 3:
        return torch.stack([shi_tomasi_score_plain(x, block_radius)
                            for x in img])
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
    if img.dtype != torch.float32 or img.dim() not in (2, 3):
        raise TypeError(f"shi_tomasi_score kernel takes a float32 image "
                        f"(H,W) or stack (S,H,W), got {tuple(img.shape)} "
                        f"{img.dtype}")
    if not img.is_contiguous():
        raise ValueError("shi_tomasi_score kernel needs a contiguous image")
    if not 1 <= block_radius <= MAX_RADIUS:
        raise ValueError(f"block_radius {block_radius} outside "
                         f"[1, {MAX_RADIUS}]")
    lib = build.load()
    S, H, W = img.shape if img.dim() == 3 else (1, *img.shape)
    out = torch.empty_like(img)
    with torch.cuda.device(img.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.sfm_shi_tomasi(img.data_ptr(), S, H, W, int(block_radius),
                                  out.data_ptr(), stream)
    build.check_launch(code, "shi_tomasi")
    launches += 1
    return debug.check_finite(out, "shi_tomasi")


def shi_tomasi_score(img, block_radius: int = 2):
    """Corner response map of an (H,W) image or an (S,H,W) stack (one
    launch for the stack); CUDA tensor -> kernel, CPU tensor -> plain."""
    if img.is_cuda:
        return _shi_tomasi_score_cuda(img, block_radius)
    return shi_tomasi_score_plain(img, block_radius)

"""The yardstick of the kernels' roofline shares: the card's published
peaks and the operations and bytes of the Lucas-Kanade level that K3
(``lk_level_fused``) computes, counted from the algorithm at a launch's
shapes.  Nothing here reads the program, a compiled kernel or its
instruction counts, so the count is the same whatever implements the
level (the CUDA kernel, its plain PyTorch version, a later design).

Peaks: NVIDIA H100 SXM data sheet, dense, at its 700 W limit: 67 TFLOP/s
in float32 outside the tensor cores, 3.35 TB/s of HBM3.  The LK level is
float32 arithmetic with no matrix product, so its peak is the float32 one.
"""

from __future__ import annotations

from typing import NamedTuple

PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12


class LkLevelShape(NamedTuple):
    """One LK level launch: ``tracks`` (all scenes of a stack together),
    the level's image ``height`` x ``width``, patch ``radius``, search
    ``margin``, ``iters`` updates, the images' storage bytes per pixel
    (``img_bytes``: 4 float32, 2 bfloat16) and the images in the launch
    (``images``: 2 per scene)."""

    tracks: int
    height: int
    width: int
    radius: int
    margin: int
    iters: int
    img_bytes: int
    images: int


# per pixel of a (P+2)^2 bilinear map: four weighted taps (4 mul + 3 add)
BILINEAR_FLOPS = 7
# per pixel of the P^2 patch and update: two central differences (sub +
# mul each), the residual (sub), five products summed (gxx gxy gyy bx by)
PATCH_FLOPS = 4 + 1 + 10
# per track and update: the four bilinear weights (2 sub + 4 mul), the
# 2x2 solve (det 3, reciprocal 1, two rows 6) and the flow update (2)
TRACK_FLOPS = 6 + 3 + 1 + 6 + 2
# per track, once: the template's weights and the window origins
TEMPLATE_TRACK_FLOPS = 6 + 8


def lk_level_flops(s: LkLevelShape) -> float:
    """Operations of one LK level over all tracks: the template (one P^2
    bilinear patch) and ``iters`` updates, each one (P+2)^2 bilinear map
    read at five offsets (the value and the two central differences), the
    five sums and the 2x2 solve.  Every track runs every update: the
    algorithm has no early exit."""
    P = 2 * s.radius + 1
    per_iter = (BILINEAR_FLOPS * (P + 2) ** 2 + PATCH_FLOPS * P * P
                + TRACK_FLOPS)
    template = BILINEAR_FLOPS * P * P + TEMPLATE_TRACK_FLOPS
    return float(s.tracks) * (template + s.iters * per_iter)


def lk_level_bytes(s: LkLevelShape) -> float:
    """Bytes of one LK level: each input byte read once and each output
    byte written once.  Of each image, the pixels its windows cover, at
    most the whole image (template windows (P+3)^2 of the first image,
    search windows (P+2 margin+3)^2 of the second; windows overlap, and an
    overlapped pixel is read once); positions and flows in, flows out,
    float32 (T,2) each."""
    P = 2 * s.radius + 1
    win0 = P + 3
    win1 = P + 2 * s.margin + 3
    tracks_per_image = s.tracks / max(s.images // 2, 1)
    px = s.height * s.width
    per_scene = (min(px, tracks_per_image * win0 * win0)
                 + min(px, tracks_per_image * win1 * win1))
    images = per_scene * (s.images // 2) * s.img_bytes
    return float(images + 3 * s.tracks * 2 * 4)


def least_seconds(flops: float, nbytes: float) -> tuple[float, str]:
    """The least time the card could take, and which peak bounds it."""
    to = flops / PEAK_F32_FLOPS
    tb = nbytes / PEAK_BYTES_PER_S
    return (to, "operations") if to >= tb else (tb, "bytes")


def lk_level_least_seconds(s: LkLevelShape) -> float:
    return least_seconds(lk_level_flops(s), lk_level_bytes(s))[0]

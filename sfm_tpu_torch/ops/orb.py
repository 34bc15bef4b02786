"""Oriented binary features + Hamming matching (ORB-flavor loop closure).

Counterpart of sfm_tpu/ops/orb.py (reference: python/src/
templering_sfm.py:532-595 ``LoopClosure`` — cv2.ORB_create(4000)
keypoints/descriptors, BFMatcher Hamming knn with Lowe ratio 0.75):

  * keypoints = batched Shi-Tomasi corners (ops/features.py, so the corner
    response runs through the K1 kernel on the card);
  * orientation = intensity-centroid angle over a circular patch, one
    batched bilinear gather;
  * descriptor = 256 BRIEF comparisons on a box-blurred image with the
    pair pattern rotated per keypoint, one (K, 256, 2) gather;
  * Hamming distance for ALL pairs via one matmul of the bit matrices:
    d(a,b) = Σa + Σb − 2·a·b for a,b ∈ {0,1}^256 (sums of 0/1 products in
    float32 are exact integers, so any summation order gives the same
    distances).
"""

from __future__ import annotations

import numpy as np
import torch

from sfm_tpu_torch.ops import features, image as im
from sfm_tpu_torch.ops.features import top_k_stable
from sfm_tpu_torch.utils import debug
from sfm_tpu_torch.utils.device import resolve, to_device

N_BITS = 256
PATCH_R = 15.0


def _brief_pattern(seed: int = 9, n_bits: int = N_BITS,
                   radius: float = PATCH_R) -> torch.Tensor:
    """Fixed random BRIEF pair offsets (n_bits, 2, 2) f32, gaussian-
    clustered like ORB's learned pattern (the JAX twin's draws, bit for
    bit)."""
    rng = np.random.default_rng(seed)
    pat = rng.standard_normal((n_bits, 2, 2)) * (radius / 2.5)
    return torch.as_tensor(np.clip(pat, -radius, radius).astype(np.float32))


_PATTERN = _brief_pattern()


def _orientation(img, xy, radius: int = 7):
    """Intensity-centroid angle per keypoint (K,), one batched gather."""
    r = torch.arange(-radius, radius + 1, dtype=img.dtype, device=img.device)
    dy, dx = torch.meshgrid(r, r, indexing="ij")
    circ = (dx * dx + dy * dy) <= radius * radius
    offs = torch.stack([dx.reshape(-1), dy.reshape(-1)], dim=-1)  # (P,2)
    vals = im.bilinear(img, xy[:, None, :] + offs[None])          # (K,P)
    w = circ.reshape(-1).to(img.dtype)
    m10 = torch.sum(vals * (offs[:, 0] * w)[None], dim=-1)
    m01 = torch.sum(vals * (offs[:, 1] * w)[None], dim=-1)
    return torch.atan2(m01, m10)


def detect_and_describe(img, max_kp: int = 512, device="cuda"):
    """Oriented binary features for one image.

    Returns (xy (K,2) f32, desc (K,256) f32 in {0,1}, valid (K,) bool)."""
    dev = resolve(device)
    img = to_device(img, dev, torch.float32)
    xy, _, valid = features.detect_corners(
        img, torch.zeros((1, 2), device=dev),
        torch.zeros((1,), dtype=torch.bool, device=dev), max_new=max_kp,
        cell=8, quality=0.01, border=int(PATCH_R) + 2, device=dev)
    # smooth for BRIEF comparisons (box approximates the gaussian blur)
    blur = im.box_filter(img, 2) / 25.0
    theta = _orientation(blur, xy)
    c, s = torch.cos(theta)[:, None, None], torch.sin(theta)[:, None, None]
    pat = _PATTERN.to(dev)
    # rotate the pattern per keypoint: (K, n_bits, 2)
    px = pat[None, :, :, 0]
    py = pat[None, :, :, 1]
    rx = c * px - s * py
    ry = s * px + c * py
    pa = xy[:, None, :] + torch.stack([rx[:, :, 0], ry[:, :, 0]], dim=-1)
    pb = xy[:, None, :] + torch.stack([rx[:, :, 1], ry[:, :, 1]], dim=-1)
    va = im.bilinear(blur, pa)  # (K, n_bits)
    vb = im.bilinear(blur, pb)
    desc = (va < vb).to(torch.float32)
    return xy, desc, valid


def match_hamming(desc_a, valid_a, desc_b, valid_b, ratio: float = 0.75):
    """Lowe-ratio Hamming matching (ref py:544-555), all pairs by one
    matmul.  ``desc_a``/``valid_a`` may carry leading batch dimensions (a
    bank of keyframes matched against one ``desc_b``).

    Returns (idx_b (Ka,) best match per a, match_ok (Ka,) bool,
    dist (Ka,))."""
    sa = torch.sum(desc_a, dim=-1, keepdim=True)  # (Ka,1)
    sb = torch.sum(desc_b, dim=-1, keepdim=True)  # (Kb,1)
    D = sa + sb.T - 2.0 * (desc_a @ desc_b.T)     # Hamming distances
    with debug.nan_ok():  # +inf holds invalid b out; dist may stay inf
        D = torch.where(valid_b[None, :], D,
                        torch.full_like(D, float("inf")))
        # the two smallest per row, ties to the lower index (as lax.top_k)
        top2, idx2 = top_k_stable(-D, 2)
        d1 = -top2[..., 0]
        d2 = -top2[..., 1]
        ok = valid_a & (d1 < ratio * d2) & torch.isfinite(d1)
    return idx2[..., 0], ok, d1


def propose_candidates(match_counts: np.ndarray, kf_id: int, min_kf_gap: int,
                       top_k: int) -> list[int]:
    """Rank loop candidates >= min_kf_gap older by match count, keep the
    best top_k (ref py:561-570). Host-side (tiny)."""
    cands = [
        (int(match_counts[k]), k)
        for k in range(max(kf_id - min_kf_gap + 1, 0))
        if match_counts[k] > 0
    ]
    cands.sort(reverse=True)
    return [k for _, k in cands[:top_k]]

"""Global image descriptors for loop-closure candidate search.

Counterpart of sfm_tpu/ops/descriptors.py (reference: cpp/src/
templering_sfm.cpp:1100-1129 ``global_desc_32`` — box-downsample to ≤32,
nearest-resample to exactly 32x32, mean-removed, L2-normalized
1024-float vector).  The keyframe ring stores one per keyframe, and
``score_bank`` scores a keyframe against the whole ring with one matvec
(replacing the per-keyframe dot loop at cpp:1827-1830).
"""

from __future__ import annotations

import torch

from sfm_tpu_torch.ops import image as im

DESC_DIM = 32 * 32


def global_desc_32(img):
    """(H,W) f32 -> (1024,) mean-removed L2-normalized descriptor."""
    # box-downsample by 2 until both dims <= 32, then nearest-neighbor
    # resample to exactly 32x32 (ref cpp:1100-1115)
    while img.shape[0] > 32 or img.shape[1] > 32:
        img = im.downsample2(img)
    h, w = img.shape
    ar = torch.arange(32, device=img.device)
    yi = ar * h // 32
    xi = ar * w // 32
    d = img[yi][:, xi].reshape(-1)
    d = d - torch.mean(d)
    return d / (torch.linalg.vector_norm(d) + 1e-12)


def score_bank(bank, bank_valid, desc):
    """Cosine scores of ``desc`` against the keyframe bank.

    bank (KF_CAP, 1024), bank_valid (KF_CAP,) bool -> (KF_CAP,) scores
    with invalid rows at -inf. One matvec (ref cpp:1124-1129)."""
    s = bank @ desc
    return torch.where(bank_valid, s, torch.full_like(s, float("-inf")))

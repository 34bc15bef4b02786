"""Shi-Tomasi corner detection as one batched tensor program.

Counterpart of sfm_tpu/ops/features.py (reference: cpp/src/
templering_sfm.cpp:237-302 ``shi_tomasi``: central-difference gradients,
box structure tensor, min-eigenvalue score, quality threshold, greedy
min-distance NMS).

The greedy NMS is a grid-cell max: the image is tiled into
``min_distance``-sized cells, each cell keeps its best corner, and cells
touched by an existing track are suppressed (no two kept corners within
one cell).  The response map comes from the CUDA kernel on the card
(ops/kernels/shi_tomasi_kernel) and from its plain version on the CPU.
"""

from __future__ import annotations

import torch

from sfm_tpu_torch.ops.kernels import shi_tomasi_kernel
from sfm_tpu_torch.ops.kernels.shi_tomasi_kernel import (  # noqa: F401
    shi_tomasi_score_plain as shi_tomasi_score)
from sfm_tpu_torch.utils.device import resolve, to_device


def top_k_stable(x, k: int):
    """(values, indices) of the k largest entries of a 1-D/last-dim
    tensor, ties broken towards the lower index (what ``lax.top_k``
    promises and ``torch.topk`` does not)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def detect_corners(img, exclude_xy, exclude_valid, max_new: int, cell: int,
                   quality: float = 0.01, border: int = 8,
                   block_radius: int = 2, device="cuda"):
    """Top-``max_new`` corners outside occupied grid cells.

    Args:
      img: (H,W) f32 grayscale, or (S,H,W) for S scenes.
      exclude_xy: (T,2) existing track positions (x,y); (S,T,2) for S scenes.
      exclude_valid: (T,) bool; (S,T) for S scenes.
      max_new: number of corners to return (padded with valid=False).
      cell: min-distance grid cell size in px.
    Returns:
      xy (max_new,2) f32, score (max_new,), valid (max_new,) bool; with a
      leading S axis for S scenes.
    """
    dev = resolve(device)
    img = to_device(img, dev)
    exclude_xy = to_device(exclude_xy, dev)
    exclude_valid = to_device(exclude_valid, dev)
    score = shi_tomasi_kernel.shi_tomasi_score(img, block_radius)
    if img.dim() == 3:  # one map for all scenes, each ranked on its own
        outs = [_rank_corners(sc, ex, ev, max_new, cell, quality, border)
                for sc, ex, ev in zip(score, exclude_xy, exclude_valid)]
        return tuple(torch.stack(o) for o in zip(*outs))
    return _rank_corners(score, exclude_xy, exclude_valid, max_new, cell,
                         quality, border)


def _rank_corners(score, exclude_xy, exclude_valid, max_new: int, cell: int,
                  quality: float, border: int):
    """The best ``max_new`` corners of one (H,W) response map (see
    ``detect_corners``)."""
    dev = score.device
    H, W = score.shape
    # border + quality gating (ref cpp:271-284)
    yy = torch.arange(H, device=dev)[:, None]
    xx = torch.arange(W, device=dev)[None, :]
    in_border = ((xx >= border) & (xx < W - border)
                 & (yy >= border) & (yy < H - border))
    zero = torch.zeros((), dtype=score.dtype, device=dev)
    smax = torch.max(torch.where(in_border, score, zero))
    ok = in_border & (score > quality * smax)
    score = torch.where(ok, score, -torch.ones_like(score))

    # grid-cell max-pool NMS
    gh, gw = H // cell, W // cell
    sc = score[: gh * cell, : gw * cell].reshape(gh, cell, gw, cell)
    flat = sc.permute(0, 2, 1, 3).reshape(gh, gw, cell * cell)
    cell_best = flat.amax(dim=-1)  # (gh,gw)
    arg = torch.argmax(flat, dim=-1)  # first maximum within the cell
    cy = arg // cell
    cx = arg % cell
    gy = torch.arange(gh, device=dev)[:, None]
    gx = torch.arange(gw, device=dev)[None, :]
    best_x = (gx * cell + cx).to(torch.float32)
    best_y = (gy * cell + cy).to(torch.float32)

    # suppress cells occupied by existing tracks (and their 8-neighborhood,
    # matching the reference's min-distance exclusion, cpp:374-389)
    exy = torch.nan_to_num(exclude_xy)
    ex = torch.clamp((exy[:, 0] / cell).to(torch.int64), 0, gw - 1)
    ey = torch.clamp((exy[:, 1] / cell).to(torch.int64), 0, gh - 1)
    occ = torch.zeros((gh * gw,), dtype=torch.int32, device=dev)
    upd = exclude_valid.to(torch.int32)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            iy = torch.clamp(ey + dy, 0, gh - 1)
            ix = torch.clamp(ex + dx, 0, gw - 1)
            occ.index_add_(0, iy * gw + ix, upd)
    cell_best = torch.where(occ.reshape(gh, gw) > 0,
                            -torch.ones_like(cell_best), cell_best)

    # global top-k over cells (stable: equal scores keep cell order)
    k = min(max_new, gh * gw)
    top_scores, top_idx = top_k_stable(cell_best.reshape(-1), k)
    xy = torch.stack([best_x.reshape(-1)[top_idx],
                      best_y.reshape(-1)[top_idx]], dim=-1)
    valid = top_scores > 0.0
    if k < max_new:
        pad = max_new - k
        xy = torch.cat([xy, torch.zeros((pad, 2), dtype=xy.dtype, device=dev)])
        top_scores = torch.cat(
            [top_scores, -torch.ones((pad,), dtype=top_scores.dtype,
                                     device=dev)])
        valid = torch.cat([valid, torch.zeros((pad,), dtype=torch.bool,
                                              device=dev)])
    return xy, top_scores, valid

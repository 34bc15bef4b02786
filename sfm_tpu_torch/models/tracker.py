"""Stable-ID sparse feature tracker over a fixed-capacity track table.

Counterpart of sfm_tpu/models/tracker.py (reference: python/src/
templering_sfm.py:395-470 ``KLTTracker`` — detection with exclusion mask,
fwd+bwd LK with fb-error gate, replenish to ``max_tracks`` when below
``min_tracks``).  The dict-of-tracks is a ``(MAX_TRACKS,)`` masked table:
dead slots are reused by masked writes, ids grow monotonically.

The replenish branch (``lax.cond`` in the JAX twin) is a host branch on
the number of surviving tracks: one host sync per frame.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from sfm_tpu_torch.config import KLTConfig
from sfm_tpu_torch.ops import features, klt
from sfm_tpu_torch.utils.device import resolve, to_device


class TrackerState(NamedTuple):
    pos: torch.Tensor  # (T,2) f32 current positions
    valid: torch.Tensor  # (T,) bool
    ids: torch.Tensor  # (T,) i32 stable track ids (-1 when dead)
    next_id: torch.Tensor  # () i32


def init_state(max_tracks: int, device="cuda") -> TrackerState:
    dev = resolve(device)
    return TrackerState(
        pos=torch.zeros((max_tracks, 2), dtype=torch.float32, device=dev),
        valid=torch.zeros((max_tracks,), dtype=torch.bool, device=dev),
        ids=-torch.ones((max_tracks,), dtype=torch.int32, device=dev),
        next_id=torch.zeros((), dtype=torch.int32, device=dev),
    )


def state_from_numpy(leaves: dict, device="cuda") -> TrackerState:
    """TrackerState from the JAX twin's leaves pulled as numpy arrays —
    field for field, dtype for dtype (copies: the state is updated in
    place later)."""
    dev = resolve(device)
    return TrackerState(
        pos=to_device(np.array(leaves["pos"], np.float32), dev),
        valid=to_device(np.array(leaves["valid"], bool), dev),
        ids=to_device(np.array(leaves["ids"], np.int32), dev),
        next_id=to_device(np.array(leaves["next_id"], np.int32), dev),
    )


def state_to_numpy(state: TrackerState) -> dict:
    return {k: v.detach().cpu().numpy() for k, v in state._asdict().items()}


def _replenish(state: TrackerState, img, cfg: KLTConfig) -> TrackerState:
    """Detect new corners and write them into free slots (ref py:462-468)."""
    T = state.pos.shape[0]
    dev = state.pos.device
    xy, _, new_valid = features.detect_corners(
        img,
        state.pos,
        state.valid,
        max_new=T,
        cell=max(int(cfg.min_distance), 2),
        quality=cfg.quality,
        block_radius=max(int(cfg.block_size) // 2, 1),
        device=dev,
    )
    iota = torch.arange(T, dtype=torch.int32, device=dev)
    free = ~state.valid
    rank = torch.cumsum(free.to(torch.int32), dim=0) - 1
    # free_idx[k] = slot index of the k-th free slot (T where none).  The
    # JAX twin drops out-of-range scatter writes (mode="drop"); here every
    # table gets one extra dump row at index T that masked writes land in,
    # and the row is cut off again.
    free_idx = torch.full((T + 1,), T, dtype=torch.int32, device=dev)
    free_idx[torch.where(free, rank, T).long()] = iota
    free_idx = free_idx[:T]
    n_free = torch.sum(free)
    # k-th new detection goes to k-th free slot; only while both exist
    take = new_valid & (iota < n_free)
    slot = torch.where(take, free_idx, T).long()
    new_ids = (state.next_id
               + torch.cumsum(take.to(torch.int32), dim=0) - 1).to(torch.int32)

    def put(table, values):
        ext = torch.cat([table, table.new_zeros((1, *table.shape[1:]))])
        ext[slot] = values.to(table.dtype)
        return ext[:T]

    pos = put(state.pos, xy)
    valid = put(state.valid, torch.ones_like(take))
    ids = put(state.ids, torch.where(take, new_ids, -1))
    next_id = (state.next_id + torch.sum(take)).to(torch.int32)
    return TrackerState(pos=pos, valid=valid, ids=ids, next_id=next_id)


def bootstrap(img, cfg: KLTConfig, device="cuda") -> TrackerState:
    """Initial detection on the first frame (ref py:419-424 reset)."""
    dev = resolve(device)
    img = to_device(img, dev, torch.float32)
    return _replenish(init_state(cfg.max_tracks, dev), img, cfg)


def step(pyr_prev, pyr_cur, state: TrackerState, cfg: KLTConfig,
         device="cuda"):
    """Track all live tracks prev->cur, gate, and replenish if starved.

    Returns (new_state, prev_pos (T,2), matched (T,) bool) where
    ``matched`` marks tracks alive in BOTH frames (the correspondence set
    handed to two-view geometry, ref py:426-460 step return).
    """
    dev = resolve(device)
    new_pos, ok = klt.lk_track_fb(
        pyr_prev,
        pyr_cur,
        state.pos,
        state.valid,
        levels=cfg.pyr_levels,
        iters=cfg.iters,
        radius=cfg.win_radius,
        fb_thresh=cfg.fb_thresh,
        device=dev,
    )
    matched = state.valid & ok
    surv = TrackerState(
        pos=torch.where(matched[:, None], new_pos, state.pos),
        valid=matched,
        ids=torch.where(matched, state.ids, -1),
        next_id=state.next_id,
    )
    # host branch (the frame's replenish sync)
    if int(torch.sum(matched)) < cfg.min_tracks:
        surv = _replenish(surv, to_device(pyr_cur[0], dev, torch.float32),
                          cfg)
    return surv, state.pos, matched

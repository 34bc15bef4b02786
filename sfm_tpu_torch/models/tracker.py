"""Stable-ID sparse feature tracker over a fixed-capacity track table.

Counterpart of sfm_tpu/models/tracker.py (reference: python/src/
templering_sfm.py:395-470 ``KLTTracker`` — detection with exclusion mask,
fwd+bwd LK with fb-error gate, replenish to ``max_tracks`` when below
``min_tracks``).  The dict-of-tracks is a ``(MAX_TRACKS,)`` masked table:
dead slots are reused by masked writes, ids grow monotonically.

The replenish branch (``lax.cond`` in the JAX twin) is a host branch on
the number of surviving tracks: one host sync per frame.

``step_scenes``/``bootstrap_scenes`` serve S scenes at once (the
multi-scene runner, parallel/multi_scan): one LK pass over the stacked
pyramids, one host pull of every scene's survivor count, and one corner
map over the scenes that replenish.
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


def _detect(img, pos, valid, cfg: KLTConfig):
    """New corners outside the live tracks' cells: (xy, valid), for one
    (H,W) image or an (S,H,W) stack (one kernel launch)."""
    xy, _, new_valid = features.detect_corners(
        img,
        pos,
        valid,
        max_new=pos.shape[-2],
        cell=max(int(cfg.min_distance), 2),
        quality=cfg.quality,
        block_radius=max(int(cfg.block_size) // 2, 1),
        device=pos.device,
    )
    return xy, new_valid


def _fill_free(state: TrackerState, xy, new_valid) -> TrackerState:
    """Write new corners into the free slots of the table (the replenish
    of ref py:462-468)."""
    T = state.pos.shape[0]
    dev = state.pos.device
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
    return bootstrap_scenes(to_device(img, dev, torch.float32)[None], cfg)[0]


def step(pyr_prev, pyr_cur, state: TrackerState, cfg: KLTConfig,
         device="cuda"):
    """Track all live tracks prev->cur, gate, and replenish if starved.

    Returns (new_state, prev_pos (T,2), matched (T,) bool) where
    ``matched`` marks tracks alive in BOTH frames (the correspondence set
    handed to two-view geometry, ref py:426-460 step return).  The
    one-scene case of ``step_scenes``.
    """
    dev = resolve(device)
    one = [tuple(to_device(p, dev)[None] for p in pyr)
           for pyr in (pyr_prev, pyr_cur)]
    return step_scenes(*one, [state], cfg)[0]


def bootstrap_scenes(imgs, cfg: KLTConfig) -> list[TrackerState]:
    """``bootstrap`` of S scenes' first frames (S,H,W) f32, with one corner
    map for all of them."""
    S = imgs.shape[0]
    free = init_state(cfg.max_tracks, imgs.device)
    xy, new_valid = _detect(imgs, free.pos.expand(S, -1, -1),
                            free.valid.expand(S, -1), cfg)
    return [_fill_free(free, a, v) for a, v in zip(xy, new_valid)]


def step_scenes(pyr_prev, pyr_cur, states: list[TrackerState],
                cfg: KLTConfig):
    """``step`` for S scenes at once (counterpart of the JAX twin's
    ``step`` under ``jax.vmap``).  ``pyr_prev``/``pyr_cur``: per level the
    (S,H_L,W_L) stack of the scenes' pyramids.

    One fwd+bwd LK pass over the stack (arm (a): one K3 launch per level
    and direction for all scenes), ONE host pull of every scene's survivor
    count, and one corner map (one K1 launch) over the scenes that
    replenish.  Under vmap the JAX twin's replenish ``lax.cond`` is a
    select; a scene's replenish reads only that scene, so replenishing
    only the scenes below ``min_tracks`` gives the same tables.
    Returns one (state, prev_pos, matched) per scene.  (The host branch
    on the counts is the frame's replenish sync.)"""
    pos = torch.stack([s.pos for s in states])
    valid = torch.stack([s.valid for s in states])
    new_pos, ok = klt.lk_track_fb(
        pyr_prev, pyr_cur, pos, valid, levels=cfg.pyr_levels,
        iters=cfg.iters, radius=cfg.win_radius, fb_thresh=cfg.fb_thresh,
        device=pos.device)
    matched = valid & ok
    surv = [TrackerState(pos=torch.where(m[:, None], p, s.pos), valid=m,
                         ids=torch.where(m, s.ids, -1), next_id=s.next_id)
            for s, p, m in zip(states, new_pos, matched)]
    counts = torch.sum(matched, dim=-1).tolist()  # the frame's one pull
    need = [k for k, c in enumerate(counts) if c < cfg.min_tracks]
    if need:
        sel = torch.tensor(need, device=pos.device)
        xy, new_valid = _detect(
            pyr_cur[0].index_select(0, sel).to(torch.float32),
            torch.stack([surv[k].pos for k in need]),
            torch.stack([surv[k].valid for k in need]), cfg)
        for k, a, v in zip(need, xy, new_valid):
            surv[k] = _fill_free(surv[k], a, v)
    return [(s, st.pos, m) for s, st, m in zip(surv, states, matched)]

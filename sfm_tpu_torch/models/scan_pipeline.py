"""Device-resident SfM frame loop (single scene).

Counterpart of sfm_tpu/models/scan_pipeline.py (reference: cpp/src/
templering_sfm.cpp:1708-1871 main frame loop; python/src/
templering_sfm.py:1022-1059 ``ClassicSystem.process``).  The whole
per-frame pipeline (pyramid build → KLT tracking → two-view LO-RANSAC →
keyframe policy → edge RANSAC + scale propagation + PnP → first-vs-last
triangulation → map/observation bookkeeping → sliding-window Schur-LM BA)
runs on the device; the host uploads frames, branches on the keyframe
decision, and pulls one small metrics row per frame at the end of each
chunk.  Between chunks the host collects the loop edges the keyframe
branch verified (or verifies the chunk's candidates itself, with
``loop.device_verify`` off), solves the pose graph and pushes the corrected
poses back into the carry; ``finalize`` re-triangulates and polishes the
map against the final poses.

Device state (fixed capacity):
  * track table        (T,)    — TrackerState from models/tracker.py
  * keyframe ring      (K,)    — pose, frame idx, full (T,)-slot snapshot
                                 (uv/ids/valid), per-slot point ids, the
                                 32x32 global descriptor, the incoming
                                 odometry edge, and the keyframe's gray
                                 image (device-side loop verification)
  * map point table    (P,3)   — cursor-allocated, never compacted
  * per-slot overlays  (T,)    — current point id, first-observation
                                 (kf, uv) for deferred triangulation

The ring's per-slot point-id matrix ``pid (K,T)`` IS the observation
table: entry (k,s) with ``pid>=0`` means keyframe k observed point ``pid``
at ``uv[k,s]``.  Triangulating a track backfills its id into every earlier
ring row where the same track id occupied slot s, so window BA reads its
observation set with plain gathers.

Where the JAX twin's ``lax.scan``/``lax.cond`` make one compiled program,
this is a Python loop with host branches (replenish and the keyframe
decision, one host sync each per frame; the loop-verification gate, one
more per keyframe with loop closure on).  Where the JAX twin rebuilds the
ring and map tables with ``.at[].set``, this code updates them IN PLACE:
a carry handed to ``frame_step``/``run_chunk`` is consumed by the call.

``ScanSfM`` runs every single-scene configuration of the JAX twin, the
ORB loop flavor (``loop.method="orb"``) included.
"""

from __future__ import annotations

import dataclasses
import logging
from pathlib import Path

import numpy as np
import torch

from sfm_tpu_torch.config import (ExportGeometry, KLTConfig, SystemConfig,
                                  TranslationMode)
from sfm_tpu_torch.models import tracker
from sfm_tpu_torch.models.mapstate import Edge, Keyframe
from sfm_tpu_torch.ops import (ba as ba_ops, descriptors, epipolar,
                               features, image as im, klt, orb as orb_ops,
                               pnp as pnp_ops, posegraph as pg_ops,
                               triangulate)
from sfm_tpu_torch.ops.features import top_k_stable
from sfm_tpu_torch.ops.linalg import nanmedian
from sfm_tpu_torch.utils import artifacts, np_geom
from sfm_tpu_torch.utils.device import resolve, to_device

log = logging.getLogger("sfm_tpu_torch")

f32 = torch.float32
i32 = torch.int32

# per-frame metrics vector layout (the only per-frame device→host data).
# Y_KFID..Y_LV_T carry the device-verified loop edge (loop.device_verify):
# Y_LV_OK is 1.0 verified / 0.0 ran-and-rejected / -1.0 not-run.
Y_FRAME, Y_VALID, Y_KF, Y_OK, Y_INL, Y_PAR, Y_ALIVE, Y_NPTS, \
    Y_LOOP_S, Y_LOOP_K, Y_BA0, Y_BA1, Y_EDGE_INL, Y_SCALE, Y_PNP_INL, \
    Y_NEW_PTS, Y_KFID, Y_LV_OK, Y_LV_I, Y_LV_INL, Y_LV_NTR, \
    Y_LV_SREL = range(22)
Y_LV_R = 22          # ..30: R_ji row-major
Y_LV_T = 31          # ..33: t_ji
NY = 34


@dataclasses.dataclass
class KeyframeRing:
    """Fixed-capacity keyframe store, indexed by absolute kf_id.

    Capacity K bounds the number of keyframes per run (chosen by the host
    as next_pow2(n_frames) — every frame can be a keyframe)."""

    R_cw: torch.Tensor      # (K,3,3) camera-to-world rotation
    t_cw: torch.Tensor      # (K,3)   camera center
    frame: torch.Tensor     # (K,)    i32 source frame index
    kvalid: torch.Tensor    # (K,)    bool
    uv: torch.Tensor        # (K,T,2) track-table snapshot
    ids: torch.Tensor       # (K,T)   i32
    tvalid: torch.Tensor    # (K,T)   bool
    pid: torch.Tensor       # (K,T)   i32 point id observed at slot (-1 none)
    desc: torch.Tensor      # (K,D)   32x32 global descriptor
    e_Rji: torch.Tensor     # (K,3,3) odometry edge (k-1)->k
    e_tji: torch.Tensor     # (K,3)
    e_inl: torch.Tensor     # (K,)    i32
    e_valid: torch.Tensor   # (K,)    bool
    img: torch.Tensor       # (K,H,W) u8 keyframe grays for device-side
    #                         loop verification ((K,1,1) dummy when
    #                         loop.device_verify is off)


@dataclasses.dataclass
class ScanCarry:
    trk: tracker.TrackerState
    prev_pyr: tuple          # image pyramid of the previous frame
    R_cw: torch.Tensor       # (3,3) current camera-to-world pose
    t_cw: torch.Tensor       # (3,)
    last_kf_frame: torch.Tensor  # () i32
    kf_count: torch.Tensor   # () i32
    slot_pid: torch.Tensor   # (T,) i32 current map point per track slot
    fo_kf: torch.Tensor      # (T,) i32 first-observation keyframe (-1 none)
    fo_uv: torch.Tensor      # (T,2)
    ring: KeyframeRing
    X: torch.Tensor          # (P,3) map point table
    n_pts: torch.Tensor      # () i32 allocation cursor
    gen: torch.Generator | None = None  # RANSAC sampling (the JAX twin's
    #                                     PRNG key leaf)


def _orb_score_bank(d_bank, v_bank, d_j, v_j):
    """Ratio-passing ORB match counts of keyframe j against a bank of
    older keyframes, one batched call (ref py:557-570 candidate scoring).
    d_bank (K,N,256) f32 bits, v_bank (K,N) bool; returns (K,) int."""
    _, ok, _ = orb_ops.match_hamming(d_bank, v_bank, d_j, v_j)
    return torch.sum(ok, dim=-1)


_RING_DTYPES = {
    "R_cw": np.float32, "t_cw": np.float32, "frame": np.int32,
    "kvalid": bool, "uv": np.float32, "ids": np.int32, "tvalid": bool,
    "pid": np.int32, "desc": np.float32, "e_Rji": np.float32,
    "e_tji": np.float32, "e_inl": np.int32, "e_valid": bool,
    "img": np.uint8,
}
_CARRY_DTYPES = {
    "R_cw": np.float32, "t_cw": np.float32, "last_kf_frame": np.int32,
    "kf_count": np.int32, "slot_pid": np.int32, "fo_kf": np.int32,
    "fo_uv": np.float32, "X": np.float32, "n_pts": np.int32,
}


def carry_from_numpy(leaves: dict, device="cuda", seed: int = 12345
                     ) -> ScanCarry:
    """The port's carry from the leaves of the JAX twin's ``ScanCarry``
    pulled as numpy arrays: ``{"trk": {...}, "prev_pyr": [...], "ring":
    {...}, "R_cw": ..., ...}`` — field for field, dtype for dtype.  A
    ``key`` leaf is dropped: the port carries a ``torch.Generator``
    (seeded with ``seed``) instead."""
    dev = resolve(device)
    put = lambda a, dt: to_device(np.array(a, dt), dev)  # noqa: E731  (copy)
    ring = KeyframeRing(**{k: put(leaves["ring"][k], dt)
                           for k, dt in _RING_DTYPES.items()})
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return ScanCarry(
        trk=tracker.state_from_numpy(leaves["trk"], dev),
        prev_pyr=tuple(put(p, np.float32) for p in leaves["prev_pyr"]),
        ring=ring, gen=gen,
        **{k: put(leaves[k], dt) for k, dt in _CARRY_DTYPES.items()})


def carry_to_numpy(carry: ScanCarry) -> dict:
    """Inverse of ``carry_from_numpy`` (without a ``key`` leaf)."""
    pull = lambda t: t.detach().cpu().numpy()  # noqa: E731
    out = {k: pull(getattr(carry, k)) for k in _CARRY_DTYPES}
    out["trk"] = tracker.state_to_numpy(carry.trk)
    out["prev_pyr"] = [pull(p) for p in carry.prev_pyr]
    out["ring"] = {k: pull(getattr(carry.ring, k)) for k in _RING_DTYPES}
    return out


def carry_tensors(carry: ScanCarry) -> list:
    """Every tensor the carry holds (to check where the state lives)."""
    return ([getattr(carry, k) for k in _CARRY_DTYPES]
            + list(carry.trk) + list(carry.prev_pyr)
            + [getattr(carry.ring, k) for k in _RING_DTYPES])


def _empty_ring(K: int, T: int, device, H: int = 1, W: int = 1
                ) -> KeyframeRing:
    dev = device
    eyes = torch.eye(3, dtype=f32, device=dev).repeat(K, 1, 1)
    return KeyframeRing(
        img=torch.zeros((K, H, W), dtype=torch.uint8, device=dev),
        R_cw=eyes.clone(),
        t_cw=torch.zeros((K, 3), dtype=f32, device=dev),
        frame=-torch.ones((K,), dtype=i32, device=dev),
        kvalid=torch.zeros((K,), dtype=torch.bool, device=dev),
        uv=torch.zeros((K, T, 2), dtype=f32, device=dev),
        ids=-torch.ones((K, T), dtype=i32, device=dev),
        tvalid=torch.zeros((K, T), dtype=torch.bool, device=dev),
        pid=-torch.ones((K, T), dtype=i32, device=dev),
        desc=torch.zeros((K, descriptors.DESC_DIM), dtype=f32, device=dev),
        e_Rji=eyes.clone(),
        e_tji=torch.zeros((K, 3), dtype=f32, device=dev),
        e_inl=torch.zeros((K,), dtype=i32, device=dev),
        e_valid=torch.zeros((K,), dtype=torch.bool, device=dev),
    )


def _build_pyr(img, levels: int):
    return tuple(p.contiguous()
                 for p in im.build_pyramid(img.to(f32), levels))


def bootstrap_carry(cfg: SystemConfig, kf_cap: int, p_cap: int, img0,
                    idx0: int, device="cuda", seed: int | None = None
                    ) -> ScanCarry:
    """First frame: detect corners, register keyframe 0 (ref py:1022-1028
    bootstrap branch)."""
    dev = resolve(device)
    T = cfg.klt.max_tracks
    pyr = _build_pyr(to_device(img0, dev), cfg.klt.pyr_levels)
    trk = tracker.bootstrap(pyr[0], cfg.klt, device=dev)
    store_img = cfg.loop.enabled and cfg.loop.device_verify
    ring = _empty_ring(kf_cap, T, dev,
                       *(pyr[0].shape if store_img else (1, 1)))
    ring.frame[0] = int(idx0)
    ring.kvalid[0] = True
    ring.uv[0] = trk.pos.to(f32)
    ring.ids[0] = trk.ids
    ring.tvalid[0] = trk.valid
    ring.desc[0] = descriptors.global_desc_32(pyr[0]).to(f32)
    if store_img:
        ring.img[0] = pyr[0].to(torch.uint8)
    gen = torch.Generator(device=dev)
    gen.manual_seed(cfg.ransac.seed if seed is None else seed)
    minus1 = -torch.ones((T,), dtype=i32, device=dev)
    return ScanCarry(
        trk=trk,
        prev_pyr=pyr,
        R_cw=torch.eye(3, dtype=f32, device=dev),
        t_cw=torch.zeros(3, dtype=f32, device=dev),
        last_kf_frame=torch.tensor(int(idx0), dtype=i32, device=dev),
        kf_count=torch.ones((), dtype=i32, device=dev),
        slot_pid=minus1.clone(),
        fo_kf=torch.where(trk.valid, 0, -1).to(i32),
        fo_uv=trk.pos.to(f32).clone(),
        ring=ring,
        X=torch.zeros((p_cap, 3), dtype=f32, device=dev),
        n_pts=torch.zeros((), dtype=i32, device=dev),
        gen=gen,
    )


def _wc(R_cw, t_cw):
    """cam→world pose to world→cam."""
    R_wc = R_cw.transpose(-1, -2)
    t_wc = -torch.einsum("...ij,...j->...i", R_wc, t_cw)
    return R_wc, t_wc


def _cw(R_wc, t_wc):
    R_cw = R_wc.transpose(-1, -2)
    t_cw = -torch.einsum("...ij,...j->...i", R_cw, t_wc)
    return R_cw, t_cw


def _norm(x):
    return torch.linalg.vector_norm(x)


def _window_ba(cfg: SystemConfig, p_ba: int, Kf, ring: KeyframeRing,
               X, n_pts, kf_id: int):
    """Sliding-window Schur-LM BA over the keyframe ring (ref cpp:848-1097
    window semantics). The observation set is read straight out of the
    ring's (K,T) pid matrix.  Updates ``ring`` and ``X`` in place.

    Returns (R_cw_cur, t_cw_cur, cost0, cost)."""
    W = cfg.ba.window
    K, T = ring.pid.shape
    P_CAP = X.shape[0]
    dev = X.device

    w_start = max(kf_id - (W - 1), 0)
    w_idx = w_start + torch.arange(W, device=dev)           # (W,)
    row_ok = w_idx <= kf_id
    gidx = torch.clamp(w_idx, 0, K - 1)
    R_wc, t_wc = _wc(ring.R_cw[gidx], ring.t_cw[gidx])      # (W,3,3),(W,3)

    pid_w = ring.pid[gidx]                                  # (W,T)
    uv_w = ring.uv[gidx]                                    # (W,T,2)
    ov_w = ring.tvalid[gidx] & (pid_w >= 0) & row_ok[:, None]

    pid_flat = pid_w.reshape(-1).long()
    ov_flat = ov_w.reshape(-1)
    pid_safe = torch.clamp(pid_flat, 0, P_CAP - 1)
    # per-point window observation counts (integer scatter-add: exact and
    # order-independent)
    cnt = torch.zeros((P_CAP,), dtype=i32, device=dev).index_add_(
        0, pid_safe, ov_flat.to(i32))
    elig = (cnt >= 2) & (torch.arange(P_CAP, device=dev) < n_pts)
    # best-observed selection, capped at max_points (ref py:733-739 /
    # cpp:881); stable descending sort: among equal counts (there are
    # many) the lower point id wins, as lax.top_k has it
    score = torch.where(elig, cnt.to(f32), -torch.ones((), device=dev))
    top_c, loc_pid = top_k_stable(score, p_ba)
    loc_ok = (top_c > 0) & (torch.arange(p_ba, device=dev)
                            < cfg.ba.max_points)
    # inverse map point id -> local index; masked writes go to a dump row
    inv = torch.full((P_CAP + 1,), -1, dtype=i32, device=dev)
    inv[torch.where(loc_ok, loc_pid, P_CAP)] = torch.arange(
        p_ba, dtype=i32, device=dev)
    lp = inv[pid_safe]                                      # (W*T,)
    obs_ok = ov_flat & (pid_flat >= 0) & (lp >= 0)

    cam_idx = torch.arange(W, device=dev).repeat_interleave(T)
    obs_n = epipolar.normalize_by_K(Kf, uv_w.reshape(-1, 2))
    Xl = X[loc_pid]

    prob = ba_ops.BAProblem(
        R_wc=R_wc, t_wc=t_wc, X=Xl,
        cam_idx=cam_idx, pid_idx=torch.clamp(lp, 0, p_ba - 1).long(),
        obs=obs_n, obs_valid=obs_ok, point_valid=loc_ok,
    )
    fx = Kf[0, 0]
    Rn, tn, Xn, info = ba_ops.bundle_adjust(
        prob, iters=cfg.ba.iters, lambda0=cfg.ba.lambda0,
        huber_delta=cfg.ba.huber_delta / fx, n_fix=1,
        update_points=cfg.ba.update_points,
    )
    R_cw_n, t_cw_n = _cw(Rn, tn)

    # --- monocular gauge retraction -----------------------------------
    # BA with a single fixed pose leaves the global SCALE mode free
    # (uniform scaling about the anchor camera changes no reprojection),
    # so LM noise random-walks the scale a few percent per solve — which
    # compounds into collapse over tens of keyframes. A uniform rescale
    # about the anchor is an EXACT gauge transform, so restoring the
    # window's first baseline to its pre-solve length cancels the drift
    # without touching the reprojection optimum.
    i0, i1 = min(w_start, K - 1), min(w_start + 1, K - 1)
    C0 = ring.t_cw[i0].clone()              # anchor (n_fix=1: unchanged)
    b_before = _norm(ring.t_cw[i1] - C0)
    b_after = _norm(t_cw_n[1] - C0)
    ok_fix = row_ok[1] & (b_before > 1e-9) & (b_after > 1e-9)
    s_fix = torch.where(ok_fix, b_before / torch.clamp(b_after, min=1e-12),
                        torch.ones_like(b_before))

    n_rows = min(W, kf_id - w_start + 1)    # window rows that exist
    ring.R_cw[w_start:w_start + n_rows] = R_cw_n[:n_rows]
    ring.t_cw[w_start:w_start + n_rows] = t_cw_n[:n_rows]
    if cfg.ba.update_points:
        # loc_pid holds distinct ids (a top-k), so a masked blend writes
        # each selected point once and leaves the others as they were
        X[loc_pid] = torch.where(loc_ok[:, None], Xn, Xl)
    # one global similarity about C0 (poses in AND out of the window plus
    # all points): scaling the window alone would tear it away from the
    # older map, while the global transform is reprojection-exact
    ring.t_cw.copy_(C0 + s_fix * (ring.t_cw - C0))
    X.copy_(C0 + s_fix * (X - C0))
    cur = kf_id - w_start
    return (R_cw_n[cur], C0 + s_fix * (t_cw_n[cur] - C0),
            info["cost0"], info["cost"])


def _ransac(cfg: SystemConfig, gen, xi, xj, mask, pri=None):
    return epipolar.find_E_ransac(
        gen, xi, xj, mask,
        num_hypotheses=cfg.ransac.num_hypotheses,
        sampson_thresh=cfg.ransac.sampson_thresh,
        min_inliers=cfg.ransac.min_inliers,
        pri=pri,
    )


def _keyframe_branch(cfg: SystemConfig, p_ba: int, Kf, carry: ScanCarry,
                     idx: int, kf_id: int, rp_frame=None, pri=None,
                     gt_C=None):
    """All keyframe-time geometry + bookkeeping, device-side (ref
    py:951-988 add_keyframe / cpp:1765-1871 keyframe block).

    ``kf_id`` is the host's copy of ``carry.kf_count`` (bootstrap wrote
    keyframe 0).  With ``rp_frame`` (this frame's two-view result from the
    tracking prefix) the edge RANSAC is skipped: the caller passes it when
    the previous keyframe IS the previous frame and that result is ok —
    the snapshot then equals the prefix's input and the two solves are
    statistically identical.  ``pri``: optional (H,T) sampling priorities
    for the edge RANSAC (tests).

    ``gt_C`` (F,3) f32 per-frame ground-truth camera centers: when
    ``cfg.use_gt_scale`` is set, the edge translation is scaled by the GT
    baseline between the previous keyframe's frame and this frame (ref
    py:888-898) instead of the monocular scale estimate.

    With loop closure on (``loop.device_verify``), the best older keyframe
    by descriptor score is gated on the device and, when the gate passes
    (one host sync per keyframe decides), verified here: LK re-track of
    its mapped tracks into this frame, PnP against its map points, and the
    relative scale the closure reveals.  The edge rides out in the metrics
    row's loop-verify pack.

    Updates the carry in place and returns (carry, ykf)."""
    ring = carry.ring
    K = ring.pid.shape[0]
    P_CAP = carry.X.shape[0]
    dev = carry.X.device
    prev_i = kf_id - 1

    uv = carry.trk.pos.to(f32)
    ids = carry.trk.ids
    tval = carry.trk.valid

    # --- odometry-edge LO-RANSAC vs the previous keyframe snapshot -----
    # (ref cpp:1782-1798; slot-aligned id match replaces matching)
    puv = ring.uv[prev_i]
    shared = ring.tvalid[prev_i] & tval & (ring.ids[prev_i] == ids)
    R_cw_i, t_cw_i = ring.R_cw[prev_i].clone(), ring.t_cw[prev_i].clone()
    R_wc_i, t_wc_i = _wc(R_cw_i, t_cw_i)
    xi = epipolar.normalize_by_K(Kf, puv)
    xj = epipolar.normalize_by_K(Kf, uv)
    rp = rp_frame if rp_frame is not None else _ransac(
        cfg, carry.gen, xi, xj, shared, pri)
    # chain fallback: relative pose from the composed frame-to-frame chain
    R_wj = carry.R_cw.T
    R_chain = R_wj @ R_cw_i
    t_chain = R_wj @ (t_cw_i - carry.t_cw)
    t_chain_u = t_chain / (_norm(t_chain) + 1e-12)
    R_e = torch.where(rp.ok, rp.R, R_chain)
    t_eu = torch.where(rp.ok, rp.t, t_chain_u)

    # --- monocular scale propagation from mapped tracks (1-dof robust
    # LS) -----------------------------------------------------------------
    pid_ok = tval & (carry.slot_pid >= 0)
    Xs = carry.X[torch.clamp(carry.slot_pid, 0, P_CAP - 1).long()]
    if cfg.use_gt_scale and gt_C is not None:
        # GT baseline between the previous keyframe's frame and this one
        # (ref py:888-898): exact metric scale, no estimator, no clamp
        f_prev = torch.clamp(ring.frame[prev_i], min=0).long()
        s_gt = _norm(gt_C[int(idx)] - gt_C[f_prev])
        s_map = torch.where(s_gt > 1e-12, s_gt,
                            torch.ones_like(s_gt)).to(f32)
    else:
        s_map = _propagated_scale(ring, prev_i, Xs, pid_ok, R_wc_i, t_wc_i,
                                  R_e, t_eu, xj)

    # --- anchored pose + PnP refinement against the map ----------------
    R_a = R_e @ R_wc_i
    t_a = R_e @ t_wc_i + s_map * t_eu
    fx = Kf[0, 0]
    # dual-init PnP, both starts refined as one batch:
    #   1. the anchored pose (two-view edge + propagated scale)
    #   2. the PREVIOUS keyframe's pose (constant-position init): for
    #      ordinary inter-keyframe motion it is inside the convergence
    #      basin regardless of the propagated scale, so a mis-estimated
    #      s_map cannot poison the localization via a bad anchored init.
    # Keep the better solution by inlier count, then cost.
    R0s = torch.stack([R_a, R_wc_i])
    t0s = torch.stack([t_a, t_wc_i])
    Rs, ts, pinfos = pnp_ops.refine_pose(
        R0s, t0s, Xs, xj, pid_ok, iters=10,
        huber_delta=cfg.ba.huber_delta / fx)
    which = torch.argmax(pinfos["inliers"].to(f32) * 1e6 - pinfos["cost"])
    R_p, t_p = Rs[which], ts[which]
    pnp_inl = pinfos["inliers"][which]
    use_pnp = pnp_inl >= 30
    R_f = torch.where(use_pnp, R_p, R_a)
    t_f = torch.where(use_pnp, t_p, t_a)
    R_ji = R_f @ R_wc_i.T
    t_ji = t_f - R_ji @ t_wc_i
    R_cw_new, t_cw_new = _cw(R_f, t_f)

    # --- first-vs-last triangulation of unmapped tracks ----------------
    # (ref py:935-949 / cpp:1801-1813, with the refined pose)
    tri_cand = tval & (carry.slot_pid < 0) & (carry.fo_kf >= 0)
    fo = torch.clamp(carry.fo_kf, 0, K - 1).long()
    R_wc_f, t_wc_f = _wc(ring.R_cw[fo], ring.t_cw[fo])  # (T,3,3),(T,3)
    xa = epipolar.normalize_by_K(Kf, carry.fo_uv)
    T = uv.shape[0]
    Rb = R_f.expand(T, 3, 3)
    tb = t_f.expand(T, 3)
    X3, za, zb = triangulate.triangulate_dlt(R_wc_f, t_wc_f, xa, Rb, tb, xj)
    err_a = triangulate.reprojection_error(R_wc_f, t_wc_f, X3, xa)
    err_b = triangulate.reprojection_error(Rb, tb, X3, xj)
    ok_tri = (tri_cand & (za > 1e-6) & (zb > 1e-6)
              & (err_a < 0.01) & (err_b < 0.01))

    # --- cursor allocation of new point ids ----------------------------
    new_pid = (carry.n_pts + torch.cumsum(ok_tri.to(i32), dim=0)
               - 1).to(i32)
    ok_new = ok_tri & (new_pid < P_CAP)
    # new ids are distinct; writes of rejected tracks go to a dump row
    Xe = torch.cat([carry.X, carry.X.new_zeros((1, 3))])
    Xe[torch.where(ok_new, new_pid, P_CAP).long()] = X3.to(f32)
    X = Xe[:P_CAP]
    slot_pid = torch.where(ok_new, new_pid, carry.slot_pid)
    n_pts = (carry.n_pts + torch.sum(ok_new)).to(i32)

    # --- first-observation registration for fresh tracks ---------------
    fresh = tval & (slot_pid < 0) & (carry.fo_kf < 0)
    fo_kf = torch.where(fresh, kf_id, carry.fo_kf).to(i32)
    fo_uv = torch.where(fresh[:, None], uv, carry.fo_uv)

    # --- snapshot + edge into the ring (in place) ----------------------
    desc = descriptors.global_desc_32(carry.prev_pyr[0])
    t_store = t_ji
    if cfg.translation_mode != TranslationMode.FULL:
        n = _norm(t_ji)
        t_store = torch.where(n > 1e-12, t_ji / torch.clamp(n, min=1e-12),
                              t_ji)
    ring.R_cw[kf_id] = R_cw_new
    ring.t_cw[kf_id] = t_cw_new
    ring.frame[kf_id] = int(idx)
    ring.kvalid[kf_id] = True
    ring.uv[kf_id] = uv
    ring.ids[kf_id] = ids
    ring.tvalid[kf_id] = tval
    ring.pid[kf_id] = torch.where(tval, slot_pid, -1).to(i32)
    ring.desc[kf_id] = desc.to(f32)
    ring.e_Rji[kf_id] = R_ji.to(f32)
    ring.e_tji[kf_id] = t_store.to(f32)
    ring.e_inl[kf_id] = rp.num_inliers
    ring.e_valid[kf_id] = True
    if cfg.loop.enabled and cfg.loop.device_verify:
        ring.img[kf_id] = carry.prev_pyr[0].to(torch.uint8)
    # --- observation backfill: newly triangulated points get their id
    # written into every earlier ring row where the same track id held
    # slot s (full track history, ref py:935-975) ------------------------
    karange = torch.arange(K, dtype=i32, device=dev)[:, None]
    cond_bf = (
        ok_new[None, :]
        & (ring.ids == ids[None, :])
        & ring.tvalid
        & (karange >= fo_kf[None, :])
        & (karange < kf_id)
        & ring.kvalid[:, None]
    )
    ring.pid = torch.where(cond_bf, new_pid[None, :], ring.pid)

    # --- sliding-window BA ---------------------------------------------
    R_cw_cur, t_cw_cur, ba0, ba1 = _window_ba(
        cfg, p_ba, Kf, ring, X, n_pts, kf_id)

    # --- loop-closure candidate scoring (cpp:1827-1831) ----------------
    cand = (karange[:, 0] <= kf_id - cfg.loop.min_kf_gap) & ring.kvalid
    scores = descriptors.score_bank(ring.desc, cand, desc)
    best_k = torch.argmax(scores)
    best_s = scores[best_k]

    # --- device-side loop verification (loop.device_verify): the gates
    # (score, spatial consistency, mapped-track count) on the device, the
    # decision on the host (one sync), the LK re-track + PnP verification
    # only for a keyframe that passes (the reference fires per keyframe,
    # cpp:1822-1866); the edge rides out in the metrics row, the pose-graph
    # pushback is a host step ---------------------------------------------
    lv = _lv_not_run(dev)
    if cfg.loop.enabled and cfg.loop.device_verify:
        fire = _loop_gate(cfg, ring, kf_id, best_k, best_s)
        fire, bk = torch.stack([fire.to(torch.int64), best_k]).tolist()
        if fire:
            lv = _lv_verify(cfg, Kf, ring, X, carry.prev_pyr, kf_id, bk)

    carry.R_cw, carry.t_cw = R_cw_cur, t_cw_cur
    carry.last_kf_frame = torch.tensor(int(idx), dtype=i32, device=dev)
    carry.kf_count = torch.tensor(kf_id + 1, dtype=i32, device=dev)
    carry.slot_pid, carry.fo_kf, carry.fo_uv = slot_pid, fo_kf, fo_uv
    carry.X, carry.n_pts = X, n_pts

    ykf = torch.cat([
        torch.stack([
            torch.ones((), dtype=f32, device=dev),
            torch.where(torch.isfinite(best_s), best_s,
                        -torch.ones_like(best_s)).to(f32),
            best_k.to(f32),
            ba0.to(f32), ba1.to(f32),
            rp.num_inliers.to(f32),
            s_map.to(f32),
            pnp_inl.to(f32),
            torch.sum(ok_new).to(f32),
            torch.tensor(float(kf_id), dtype=f32, device=dev),
        ]),
        lv,
    ])
    return carry, ykf


def _propagated_scale(ring: KeyframeRing, prev_i: int, Xs, pid_ok, R_wc_i,
                      t_wc_i, R_e, t_eu, xj):
    """Monocular scale of the new edge from the mapped tracks (1-dof robust
    least squares, the median of per-track solutions), clamped to [1/3, 3]x
    the previous keyframe baseline."""
    Xi_cam = Xs @ R_wc_i.T + t_wc_i
    w3 = Xi_cam @ R_e.T
    a = t_eu[None, :2] - xj * t_eu[2]
    b = xj * w3[:, 2:3] - w3[:, :2]
    den = torch.sum(a * a, dim=-1)
    good = pid_ok & (Xi_cam[:, 2] > 1e-6) & (den > 1e-10)
    sols = torch.sum(a * b, dim=-1) / torch.where(
        den > 1e-10, den, torch.ones_like(den))
    s_est = nanmedian(torch.where(good, sols,
                                  torch.full_like(sols, float("nan"))))
    s_est = torch.where(torch.isnan(s_est), torch.ones_like(s_est), s_est)
    one = torch.ones_like(s_est)
    s_map = torch.where((torch.sum(good) >= 5) & (s_est > 1e-6), s_est, one)
    # monocular scale-smoothness prior: adjacent keyframe baselines on a
    # continuous trajectory change smoothly, but the median-of-ratios
    # scale estimate can misfire when few mapped tracks survive a hard
    # frame. Clamp the propagated step length to [1/3, 3]x the previous
    # keyframe baseline.
    b_prev = _norm(ring.t_cw[prev_i] - ring.t_cw[max(prev_i - 1, 0)])
    have_prev = (b_prev > 1e-9) & (prev_i >= 1)
    return torch.clamp(
        s_map,
        min=torch.where(have_prev, b_prev / 3.0, torch.zeros_like(b_prev)),
        max=torch.where(have_prev, 3.0 * b_prev,
                        torch.full_like(b_prev, float("inf"))),
    )


def _nan_where(mask, x):
    return torch.where(mask, x, torch.full_like(x, float("nan")))


def _loop_gate(cfg: SystemConfig, ring: KeyframeRing, kf_id: int, best_k,
               best_s):
    """0-dim bool: whether the loop candidate ``best_k`` of keyframe
    ``kf_id`` is worth a verification.  Spatial-consistency gate (twin of
    the host ``gate_loop_candidates``): true revisits are within a few
    odometry steps, noise-texture false positives anywhere on the
    trajectory; plus the descriptor score and the candidate's mapped-track
    count."""
    lcfg = cfg.loop
    K = ring.kvalid.shape[0]
    karange = torch.arange(K, device=ring.kvalid.device)
    kv_prev = ring.kvalid & (karange <= kf_id)
    Cs = ring.t_cw
    step_m = kv_prev[1:] & kv_prev[:-1]
    steps = torch.linalg.vector_norm(Cs[1:] - Cs[:-1], dim=-1)
    med = torch.nan_to_num(nanmedian(_nan_where(step_m, steps)), nan=1.0)
    nv = torch.clamp(torch.sum(kv_prev), min=1)
    ctr = torch.sum(torch.where(kv_prev[:, None], Cs,
                                torch.zeros_like(Cs)), dim=0) / nv
    extent = torch.amax(torch.where(
        kv_prev, torch.linalg.vector_norm(Cs - ctr, dim=-1),
        torch.zeros_like(Cs[:, 0])))
    b_cand = _norm(Cs[kf_id] - Cs[best_k])
    b_gate = torch.maximum(5.0 * med, 0.25 * extent)
    n_mapped_old = torch.sum(ring.tvalid[best_k] & (ring.pid[best_k] >= 0))
    return (torch.isfinite(best_s) & (best_s > lcfg.score_thresh)
            & (b_cand <= b_gate) & (n_mapped_old >= 30))


def _loop_pnp(kcfg, Kf, pyr_old, pyr_new, uv_old, X_old, m_old, R_wc0,
              t_wc0, huber_delta, pnp_iters: int = 12):
    """The PnP part of a loop verification: LK-retrack the old keyframe's
    mapped tracks ``uv_old`` (mask ``m_old``, map points ``X_old``) from
    pyramid ``pyr_old`` into ``pyr_new``, then robust PnP from the old
    keyframe's world->camera pose.  Returns (R_wc, t_wc, info, use) with
    ``use`` the tracks the PnP ran on."""
    new_pts, ok = klt.lk_track_fb(
        pyr_old, pyr_new, uv_old, m_old, levels=kcfg.pyr_levels,
        iters=kcfg.iters, radius=kcfg.win_radius, fb_thresh=kcfg.fb_thresh,
        device=X_old.device)
    xj = epipolar.normalize_by_K(Kf, new_pts.to(f32))
    use = ok & m_old
    R, t, info = pnp_ops.refine_pose(R_wc0, t_wc0, X_old, xj, use,
                                     iters=pnp_iters, huber_delta=huber_delta)
    return R, t, info, use


def _loop_pnp_stage(Kf, img_old, img_new, uv_old, X_old, m_old, R_wc0,
                    t_wc0, levels: int, lk_iters: int, radius: int,
                    fb_thresh, huber_delta, pnp_iters: int = 12):
    """Loop-closure verification via PnP against the old keyframe's map
    (the host pipeline's, ``SfMSystem._try_loop_pnp``).

    The reference verifies loops with an E-matrix re-estimate
    (cpp:1856-1859), but E = [t]x R vanishes with the baseline; once a map
    exists the strictly better measurement is 3D->2D: LK-retrack the old
    keyframe's MAPPED tracks into the new frame and run robust PnP —
    metric, scale-resolved, and accurate at any baseline.  One device
    program, one host pull.

    Returns pack [R_wc(9), t_wc(3), pnp_inliers, n_tracked, inlier_rms]."""
    kcfg = KLTConfig(pyr_levels=levels, iters=lk_iters, win_radius=radius,
                     fb_thresh=fb_thresh)
    R, t, info, use = _loop_pnp(
        kcfg, Kf, _build_pyr(img_old, levels), _build_pyr(img_new, levels),
        uv_old, X_old.to(f32), m_old, R_wc0.to(f32), t_wc0.to(f32),
        huber_delta, pnp_iters)
    return torch.cat([
        R.reshape(9).to(f32), t.to(f32),
        torch.stack([info["inliers"].to(f32), torch.sum(use).to(f32),
                     info["inlier_rms"].to(f32)]),
    ])


def _pnp_loop_edge(kcfg, Kf, ring: KeyframeRing, X, pyr_old, pyr_new,
                   cand_kf: int, cur_kf: int, huber_delta):
    """The loop edge cand_kf -> cur_kf measured with PnP (``_loop_pnp``):
    metric, scale-resolved, and accurate at any baseline (E = [t]x R
    vanishes with the baseline, so the reference's E-matrix re-estimate,
    cpp:1856-1859, is the fallback only) — and the relative scale the
    closure reveals: median depth of cur_kf's map points in its own pose
    over the old segment's at the PnP pose (node convention x_w = s·R·x_c
    + C gives s_rel = s_i/s_j; 1 when either side has fewer than 20
    depths).

    Returns one f32 tensor [R_ji (9), t_ji (3), inliers, n_tracked, s_rel,
    n_mapped_old], so the host needs a single pull."""
    P_CAP = X.shape[0]
    pid_old = ring.pid[cand_kf]
    m_old = ring.tvalid[cand_kf] & (pid_old >= 0)
    X_old = X[torch.clamp(pid_old, 0, P_CAP - 1).long()]
    R_cw_o, C_o = ring.R_cw[cand_kf], ring.t_cw[cand_kf]
    R_wc0, t_wc0 = _wc(R_cw_o, C_o)
    Rv, tv, info, use = _loop_pnp(kcfg, Kf, pyr_old, pyr_new,
                                  ring.uv[cand_kf], X_old, m_old, R_wc0,
                                  t_wc0, huber_delta)
    # pose-graph edge i->j from the metric PnP pose
    R_ji = Rv @ R_cw_o
    t_ji = Rv @ C_o + tv
    d_i = (X_old @ Rv.T + tv)[:, 2]
    ok_i = m_old & (d_i > 1e-9)
    pid_j = ring.pid[cur_kf]
    m_j = ring.tvalid[cur_kf] & (pid_j >= 0)
    X_j = X[torch.clamp(pid_j, 0, P_CAP - 1).long()]
    d_j = ((X_j - ring.t_cw[cur_kf]) @ ring.R_cw[cur_kf])[:, 2]
    ok_j = m_j & (d_j > 1e-9)
    med_i = nanmedian(_nan_where(ok_i, d_i))
    med_j = nanmedian(_nan_where(ok_j, d_j))
    s_ok = ((torch.sum(ok_i) >= 20) & (torch.sum(ok_j) >= 20)
            & (med_i > 1e-12))
    s_rel = torch.nan_to_num(
        torch.where(s_ok, med_j / torch.clamp(med_i, min=1e-12),
                    torch.ones_like(med_i)), nan=1.0)
    return torch.cat([
        R_ji.reshape(9).to(f32), t_ji.to(f32),
        torch.stack([info["inliers"].to(f32), torch.sum(use).to(f32),
                     s_rel.to(f32), torch.sum(m_old).to(f32)]),
    ])


def _lv_verify(cfg: SystemConfig, Kf, ring: KeyframeRing, X, pyr_new,
               kf_id: int, best_k: int):
    """Verify the loop edge best_k -> kf_id on the device: the old
    keyframe's pyramid from its stored gray, then ``_pnp_loop_edge``.
    Returns the 17-value loop-verify pack [ok, best_k, inliers, n_tracked,
    s_rel, R_ji (9), t_ji (3)]."""
    lcfg = cfg.loop
    pyr_old = _build_pyr(ring.img[best_k].to(f32), cfg.klt.pyr_levels)
    pack = _pnp_loop_edge(cfg.klt, Kf, ring, X, pyr_old, pyr_new, best_k,
                          kf_id, cfg.ba.huber_delta / Kf[0, 0])
    inliers, n_tracked = pack[12], pack[13]
    ok_edge = ((n_tracked >= min(lcfg.min_tracked, 30))
               & (inliers >= lcfg.min_inliers))
    head = torch.stack([ok_edge.to(f32), torch.full_like(inliers, best_k),
                        inliers, n_tracked, pack[14]])
    return torch.cat([head, pack[:12]])


def _lv_not_run(device):
    """The loop-verify pack of a keyframe no verification ran on."""
    return torch.cat([-torch.ones((2,), dtype=f32, device=device),
                      torch.zeros((15,), dtype=f32, device=device)])


def ykf_none(device="cuda") -> torch.Tensor:
    """The keyframe-branch metrics vector for a non-keyframe: kf flag 0,
    loop score/candidate -1, zeros, kf_id -1, not-run loop-verify pack."""
    dev = resolve(device)
    return torch.cat([
        torch.zeros((1,), dtype=f32, device=dev),
        torch.tensor([-1.0, -1.0], dtype=f32, device=dev),
        torch.zeros((6,), dtype=f32, device=dev),
        torch.tensor([-1.0], dtype=f32, device=dev),          # kf_id
        _lv_not_run(dev),
    ])


def _track_and_pose_rp(cfg: SystemConfig, Kf, carry: ScanCarry, img,
                       idx: int, pri=None):
    """The always-on per-frame prefix: pyramid build → KLT step →
    two-view LO-RANSAC → pose compose → keyframe policy.

    Returns (carry', make_kf, reuse, rp, y_pre): make_kf and reuse are
    0-dim bool tensors (reuse: the previous keyframe is the previous frame
    and rp is ok, so rp can serve as the keyframe edge); rp is the frame's
    two-view RelPose; y_pre = (rp_ok, rp_inliers, parallax, n_matched) as
    f32 scalars.  ``pri``: optional (H,T) sampling priorities (tests)."""
    dev = carry.X.device
    pyr = _build_pyr(img, cfg.klt.pyr_levels)
    trk, prev_pos, matched = tracker.step(
        carry.prev_pyr, pyr, carry.trk, cfg.klt, device=dev)
    # track death / replenish clears slot associations
    slot_pid = torch.where(matched, carry.slot_pid, -1).to(i32)
    fo_kf = torch.where(matched, carry.fo_kf, -1).to(i32)
    xi = epipolar.normalize_by_K(Kf, prev_pos.to(f32))
    xj = epipolar.normalize_by_K(Kf, trk.pos.to(f32))
    rp = _ransac(cfg, carry.gen, xi, xj, matched, pri)
    flow = torch.linalg.vector_norm(trk.pos - prev_pos, dim=-1)
    parallax = torch.nan_to_num(nanmedian(
        torch.where(matched, flow, torch.full_like(flow, float("nan")))))
    # frame-to-frame pose compose T_cw' = T_cw ∘ T_ji^{-1}
    # (ref py:117-127, py:1044); unit-scale between keyframes —
    # the keyframe stage re-derives metric scale from the map
    R_cw_n = torch.where(rp.ok, carry.R_cw @ rp.R.T, carry.R_cw)
    t_cw_n = torch.where(
        rp.ok,
        carry.R_cw @ (-rp.R.T @ rp.t) + carry.t_cw,
        carry.t_cw,
    )
    gap = idx - carry.last_kf_frame
    make_kf = (~rp.ok) | (
        (gap >= cfg.keyframe.min_gap)
        & ((parallax >= cfg.keyframe.parallax_px)
           | (rp.num_inliers < cfg.keyframe.min_inliers))
    )
    prev_kf_frame = carry.ring.frame.index_select(
        0, (carry.kf_count.long() - 1).reshape(1))[0]
    reuse = (prev_kf_frame == idx - 1) & rp.ok
    carry.trk, carry.prev_pyr = trk, pyr
    carry.R_cw, carry.t_cw = R_cw_n, t_cw_n
    carry.slot_pid, carry.fo_kf = slot_pid, fo_kf
    y_pre = (rp.ok.to(f32), rp.num_inliers.to(f32),
             parallax.to(f32), torch.sum(matched).to(f32))
    return carry, make_kf, reuse, rp, y_pre


def _pack_frame_metrics(carry: ScanCarry, idx: int, y_pre, ykf):
    rp_ok, rp_inl, parallax, n_matched = y_pre
    dev = ykf.device
    return torch.cat([
        torch.stack([
            torch.tensor(float(idx), dtype=f32, device=dev),
            torch.ones((), dtype=f32, device=dev), ykf[0],
            rp_ok, rp_inl, parallax, n_matched,
            carry.n_pts.to(f32),
        ]),
        ykf[1:],  # loop score/candidate, BA costs, edge inliers, scale,
        #           PnP inliers, new points, kf_id, loop-verify pack
    ])


def frame_step(cfg: SystemConfig, p_ba: int, Kf, carry: ScanCarry, img,
               idx: int, pri_frame=None, pri_edge=None, gt_C=None):
    """One frame: tracking prefix, then the keyframe branch when the
    policy asks for it.  The keyframe decision (with the edge-reuse flag
    and the keyframe counter) is the frame's one host pull here.
    ``gt_C``: optional (F,3) GT centers for cfg.use_gt_scale.
    Returns (carry, y (NY,) f32 metrics row)."""
    carry, make_kf, reuse, rp, y_pre = _track_and_pose_rp(
        cfg, Kf, carry, img, idx, pri=pri_frame)
    mk, ru, kf_id = torch.stack(
        [make_kf.to(i32), reuse.to(i32), carry.kf_count]).tolist()
    if mk:
        carry, ykf = _keyframe_branch(
            cfg, p_ba, Kf, carry, idx, kf_id,
            rp_frame=rp if ru else None, pri=pri_edge, gt_C=gt_C)
    else:
        ykf = ykf_none(carry.X.device)
    return carry, _pack_frame_metrics(carry, idx, y_pre, ykf)


def run_chunk(cfg: SystemConfig, p_ba: int, Kf, carry: ScanCarry,
              imgs, idxs, fvalid, gt_C=None, pri_for=None):
    """Process a chunk of frames.

    imgs: sequence of (H,W) u8/f32 tensors on the carry's device; idxs
    (C,) frame indices and fvalid (C,) bool on the host — padding frames
    (fvalid False) are no-ops with an all-zero metrics row, as in the JAX
    twin.  ``gt_C`` (F,3) optional per-frame GT centers for
    cfg.use_gt_scale (see _keyframe_branch).  ``pri_for``: optional
    callable frame index -> (pri_frame, pri_edge) (H,T) f32 priorities,
    handed to ``frame_step`` in place of the carry's generator (tests).
    Returns (carry, ys (C,NY) f32 on the device)."""
    dev = carry.X.device
    ys = []
    for img, idx, fval in zip(imgs, idxs, fvalid):
        if not bool(fval):
            ys.append(torch.zeros((NY,), dtype=f32, device=dev))
            continue
        pri = {}
        if pri_for is not None:
            pri = dict(zip(("pri_frame", "pri_edge"),
                           (to_device(np.asarray(a, np.float32), dev)
                            for a in pri_for(int(idx)))))
        carry, y = frame_step(cfg, p_ba, Kf, carry, img, int(idx),
                              gt_C=gt_C, **pri)
        ys.append(y)
    return carry, torch.stack(ys)


# ---------------------------------------------------------------------------
# Host-driven loop verification (loop.device_verify off)
# ---------------------------------------------------------------------------


def _loop_verify_stage(gen, Kf, img_old, img_new, levels: int,
                       lk_iters: int, radius: int, fb_thresh, cell: int,
                       quality, num_hypotheses: int, sampson_thresh,
                       min_inliers: int, pri=None):
    """Loop-candidate geometric verification (ref cpp:1833-1859):
    Shi-Tomasi re-detect on the old keyframe + LK fwd/bwd re-track +
    E-RANSAC gate.  Returns the pack [R (9), t (3), ok, inliers,
    n_tracked] as one f32 tensor, so the host needs a single pull."""
    dev = Kf.device
    pyr_old = _build_pyr(img_old, levels)
    pyr_new = _build_pyr(img_new, levels)
    xy, _, dvalid = features.detect_corners(
        pyr_old[0], torch.zeros((1, 2), device=dev),
        torch.zeros((1,), dtype=torch.bool, device=dev), max_new=1024,
        cell=cell, quality=quality, device=dev)
    new_pts, ok = klt.lk_track_fb(
        pyr_old, pyr_new, xy, dvalid, levels=levels, iters=lk_iters,
        radius=radius, fb_thresh=fb_thresh, device=dev)
    xi = epipolar.normalize_by_K(Kf, xy.to(f32))
    xj = epipolar.normalize_by_K(Kf, new_pts.to(f32))
    rp = epipolar.find_E_ransac(
        gen, xi, xj, ok, num_hypotheses=num_hypotheses,
        sampson_thresh=sampson_thresh, min_inliers=min_inliers, pri=pri)
    return torch.cat([
        rp.R.reshape(9).to(f32), rp.t.to(f32),
        torch.stack([rp.ok.to(f32), rp.num_inliers.to(f32),
                     torch.sum(ok).to(f32)]),
    ])


# ---------------------------------------------------------------------------
# Packed pulls and the finalize refinement
# ---------------------------------------------------------------------------


def _ring_pose_stage(carry: ScanCarry) -> np.ndarray:
    """ONE packed pull of the ring poses + odometry edges + bookkeeping
    used by the host between chunks (loop gating, pose-graph assembly),
    as float64 numpy."""
    ring = carry.ring
    flat = torch.cat([
        ring.R_cw.reshape(-1), ring.t_cw.reshape(-1),
        ring.frame.to(f32), ring.kvalid.to(f32),
        ring.e_Rji.reshape(-1), ring.e_tji.reshape(-1),
        ring.e_inl.to(f32), ring.e_valid.to(f32),
        carry.kf_count.to(f32)[None],
    ])
    return flat.cpu().numpy().astype(np.float64)


def _unpack_ring_poses(flat: np.ndarray, K: int) -> dict:
    return {
        "R_cw": flat[: K * 9].reshape(K, 3, 3),
        "t_cw": flat[K * 9: K * 12].reshape(K, 3),
        "frame": flat[K * 12: K * 13].astype(np.int64),
        "kvalid": flat[K * 13: K * 14] > 0.5,
        "e_Rji": flat[K * 14: K * 23].reshape(K, 3, 3),
        "e_tji": flat[K * 23: K * 26].reshape(K, 3),
        "e_inl": flat[K * 26: K * 27].astype(np.int64),
        "e_valid": flat[K * 27: K * 28] > 0.5,
        "n_kf": int(flat[K * 28]),
    }


def _finalize_refine_core(Kf, ring: KeyframeRing, X, n_pts: int,
                          do_retri0: bool, do_retri_later: bool,
                          enable_refine: bool, iters: int, rounds: int,
                          lambda0, huber_delta):
    """The refinement rounds of ``ScanSfM.finalize`` (re-triangulate +
    frozen-pose point polish), reading the ring in place.

    Each point's first/last observing (keyframe, slot) comes from two
    integer segment reductions over the ring's (K,T) point-id matrix
    (row-major (k,s) codes), and the polish uses every ring slot as a
    masked observation row.  A round re-triangulates only when its gate
    is set, and polishes only with ``enable_refine``.  Returns (X (P,3)
    f32, cost0, cost) with the costs None when no polish ran."""
    K_, T_ = ring.pid.shape
    P = X.shape[0]
    dev = X.device
    obs_ok = (ring.tvalid & (ring.pid >= 0) & (ring.pid < n_pts)
              & ring.kvalid[:, None])
    pid_safe = torch.where(obs_ok, ring.pid.long(),
                           torch.full_like(ring.pid, P, dtype=torch.long))
    BIG = K_ * T_
    code = torch.arange(BIG, device=dev).reshape(K_, T_)
    first = torch.full((P + 1,), BIG, dtype=torch.long, device=dev)
    first = first.scatter_reduce(
        0, pid_safe.reshape(-1),
        torch.where(obs_ok, code, torch.full_like(code, BIG)).reshape(-1),
        "amin")[:P]
    last = torch.full((P + 1,), -1, dtype=torch.long, device=dev)
    last = last.scatter_reduce(
        0, pid_safe.reshape(-1),
        torch.where(obs_ok, code, torch.full_like(code, -1)).reshape(-1),
        "amax")[:P]
    has = (first < BIG) & (last >= 0)
    fc = torch.clamp(first, 0, BIG - 1)
    lc = torch.clamp(last, 0, BIG - 1)
    ka, sa = fc // T_, fc % T_
    kb, sb = lc // T_, lc % T_
    ok2 = has & (ka != kb)
    # world->camera extrinsics from the (pose-graph-corrected) ring
    R_wc, t_wc = _wc(ring.R_cw, ring.t_cw)
    xa = epipolar.normalize_by_K(Kf, ring.uv[ka, sa].to(f32))
    xb = epipolar.normalize_by_K(Kf, ring.uv[kb, sb].to(f32))
    # the polish problem's static side: every (k,s) ring slot is an
    # observation row, invalid slots masked via obs_valid
    cam_idx = torch.arange(K_, device=dev).repeat_interleave(T_)
    pid_idx = torch.where(obs_ok, ring.pid.long(),
                          torch.zeros_like(pid_safe)).reshape(-1)
    obs_n = epipolar.normalize_by_K(Kf, ring.uv.reshape(-1, 2).to(f32))
    point_valid = torch.arange(P, device=dev) < n_pts
    X = X.to(f32)
    cost0 = cost = None
    for r in range(rounds):
        if do_retri0 if r == 0 else do_retri_later:
            X3, za, zb = triangulate.triangulate_dlt(
                R_wc[ka], t_wc[ka], xa, R_wc[kb], t_wc[kb], xb)
            good = (ok2 & (za > 1e-6) & (zb > 1e-6)
                    & torch.isfinite(X3).all(-1))
            X = torch.where(good[:, None], X3.to(f32), X)
        if enable_refine:
            prob = ba_ops.BAProblem(
                R_wc=R_wc.to(f32), t_wc=t_wc.to(f32), X=X,
                cam_idx=cam_idx, pid_idx=pid_idx, obs=obs_n,
                obs_valid=obs_ok.reshape(-1), point_valid=point_valid)
            X, info = ba_ops.refine_points(
                prob, iters=iters, lambda0=lambda0, huber_delta=huber_delta,
                max_obs_per_point=K_)  # ring: one obs per keyframe row
            if r == 0:
                cost0 = info["cost0"]
            cost = info["cost"]
    return X, cost0, cost


# ---------------------------------------------------------------------------
# Host wrapper
# ---------------------------------------------------------------------------


def _next_pow2(n: int, lo: int = 8) -> int:
    p = lo
    while p < n:
        p *= 2
    return p


class ScanSfM:
    """Host orchestrator for the device-resident pipeline.

    Per chunk of frames: one ``run_chunk`` call + one metrics pull.
    Between chunks: loop-closure edges (verified in the chunk, or by the
    host with ``loop.device_verify`` off) and the pose graph.  At the end:
    drain the ring, re-triangulate and polish the map, export.  Same
    external surface as the JAX twin (kfs / edges / metrics / export) so
    eval tooling is shared.

    ``device`` defaults to ``"cuda"``; without a card the constructor
    raises (pass ``device="cpu"`` to run the plain versions).
    """

    def __init__(self, K: np.ndarray, cfg: SystemConfig,
                 n_frames: int | None = None, chunk: int = 16,
                 p_cap: int = 16384, p_ba: int = 1024, gt_records=None,
                 device="cuda"):
        self.device = resolve(device)
        self._gt_C = None
        if cfg.use_gt_scale:
            if gt_records is None:
                raise ValueError(
                    "cfg.use_gt_scale requires gt_records (the dataset's "
                    "Middlebury records with GT centers, ref py:888-898)")
            self._gt_C = to_device(
                np.stack([r.center for r in gt_records]).astype(np.float32),
                self.device)
        self.K = np.asarray(K, np.float64)
        self._Kt = to_device(self.K.astype(np.float32), self.device)
        self.cfg = cfg
        self.chunk = int(chunk)
        self.kf_cap = _next_pow2((n_frames or cfg.frames) + 1, lo=16)
        self.p_cap = int(p_cap)
        self.p_ba = min(int(p_ba), self.p_cap)
        self.carry: ScanCarry | None = None
        self.metrics: list[dict] = []
        self.loop_edges: list[Edge] = []
        # keyframe images (frame_idx -> u8 gray) for the host-driven loop
        # verification and the ORB flavor; the device-verified path keeps
        # them in the ring
        self._keep_images = cfg.loop.enabled and (
            not cfg.loop.device_verify or cfg.loop.method == "orb")
        self._images: dict[int, np.ndarray] = {}
        # ORB flavor: per-keyframe features + a persistent device-side
        # descriptor bank (kf_cap, max_kp, 256)
        self._orb_ids: dict[int, tuple] = {}
        self._orb_bank = None
        self._orb_bank_valid = None
        # tests hand in the JAX twin's per-frame RANSAC priorities here
        # (callable frame index -> (pri_frame, pri_edge)); None draws from
        # the carry's generator
        self._pri_source = None
        self._names: list[str] = []
        self._pending: list[tuple[int, str, np.ndarray, torch.Tensor]] = []
        self.kfs: list[Keyframe] = []
        self.edges: list[Edge] = []
        self._X = np.zeros((0, 3))
        self._ring_pid = None
        self._pg_ran = False
        self.pg_solves = 0      # pose-graph solves pushed back so far
        self.loop_verifications = 0  # keyframes whose loop verification ran
        self.host_verifications = 0  # host loop verifications (each LK)
        self.refine_rounds = 1  # re-triangulate/refine cycles at finalize

    # -- streaming interface -------------------------------------------
    def process(self, frame_idx: int, img_name: str,
                gray_u8: np.ndarray) -> None:
        self._names.append(img_name)
        # start the frame's upload now; it is consumed at the next flush
        dev_img = torch.from_numpy(np.array(gray_u8)).to(
            self.device, non_blocking=True)
        if self.carry is None:
            if self._keep_images:
                self._images[int(frame_idx)] = np.asarray(gray_u8)
            with torch.no_grad():
                self.carry = bootstrap_carry(
                    self.cfg, self.kf_cap, self.p_cap, dev_img,
                    int(frame_idx), device=self.device)
            self.metrics.append(
                {"frame": frame_idx, "image": img_name, "keyframe": True,
                 "tracks": int(self.cfg.klt.max_tracks)})
            return
        self._pending.append((frame_idx, img_name, gray_u8, dev_img))
        if len(self._pending) >= self.chunk:
            self._flush()

    def _flush(self) -> None:
        if not self._pending:
            return
        C = self.chunk
        idxs = np.zeros((C,), np.int32)
        fvalid = np.zeros((C,), bool)
        imgs = []
        for k, (idx, _, _, d) in enumerate(self._pending):
            imgs.append(d)
            idxs[k] = idx
            fvalid[k] = True
        imgs.extend([imgs[0]] * (C - len(imgs)))  # tail chunk: padding
        names = {idx: name for idx, name, _, _ in self._pending}
        pend_imgs = {idx: g for idx, _, g, _ in self._pending}
        self._pending = []
        with torch.no_grad():
            self.carry, ys = run_chunk(
                self.cfg, self.p_ba, self._Kt, self.carry, imgs, idxs,
                fvalid, gt_C=self._gt_C, pri_for=self._pri_source)
        ys = ys.cpu().numpy().astype(np.float64)  # the chunk's one pull
        self.loop_verifications += int(
            ((ys[:, Y_VALID] > 0.5) & (ys[:, Y_LV_OK] > -0.5)).sum())
        for row in ys:
            if row[Y_VALID] < 0.5:
                continue
            fi = int(row[Y_FRAME])
            met = {
                "frame": fi,
                "image": names.get(fi, ""),
                "keyframe": bool(row[Y_KF] > 0.5),
                "inliers": int(row[Y_INL]),
                "parallax": float(row[Y_PAR]),
                "tracks": int(row[Y_ALIVE]),
                "map_points": int(row[Y_NPTS]),
            }
            if row[Y_KF] > 0.5:
                met["loop_score"] = float(row[Y_LOOP_S])
                met["loop_cand"] = int(row[Y_LOOP_K])
                met["ba_cost0"] = float(row[Y_BA0])
                met["ba_cost"] = float(row[Y_BA1])
                if self._keep_images and fi in pend_imgs:
                    self._images[fi] = np.asarray(pend_imgs[fi])
            self.metrics.append(met)
            log.info(
                "frame %d | kf=%s | inliers=%d | parallax=%.2f | "
                "tracks=%d | map_points=%d",
                fi, met["keyframe"], met["inliers"], met["parallax"],
                met["tracks"], met["map_points"],
            )
        with torch.no_grad():
            self._check_loops(ys)

    # -- loop closure + pose graph (between chunks) ---------------------
    @staticmethod
    def loop_candidate_rows(ys: np.ndarray, lcfg) -> np.ndarray:
        """Row mask of above-threshold loop candidates in a pulled
        metrics array — THE candidate predicate, shared by the pre-gate
        and `gate_loop_candidates` so the two cannot drift apart."""
        return ((ys[:, Y_VALID] > 0.5) & (ys[:, Y_KF] > 0.5)
                & (ys[:, Y_LOOP_S] > lcfg.score_thresh))

    @staticmethod
    def gate_loop_candidates(ys: np.ndarray, rp: dict,
                             lcfg) -> list[tuple[int, int, int]]:
        """Host-side (numpy-only) candidate gate: from the chunk's pulled
        metrics rows and an unpacked ring-pose dict, return the top-k
        ``(cand_kf, cur_kf, cur_frame)`` pairs worth a verification.

        Gates, in order: descriptor score threshold; top-k by score (the
        32x32 descriptor's margin between a true revisit and texture
        noise can be thin, so a single best-of-chunk row could starve the
        true loop behind a false candidate); dedup of repeated (cand, cur)
        pairs; and a spatial-consistency pre-gate — a true revisit's
        estimated centers are close (odometry drift is a small fraction of
        the trajectory) while descriptor false positives land anywhere on
        the ring."""
        rows = ys[ScanSfM.loop_candidate_rows(ys, lcfg)]
        if len(rows) == 0:
            return []
        order = np.argsort(-rows[:, Y_LOOP_S])[: max(lcfg.top_k, 1)]
        frames = rp["frame"]
        kvalid = rp["kvalid"]
        n_kf = rp["n_kf"]
        cs = rp["t_cw"][:n_kf]
        odo = np.linalg.norm(np.diff(cs, axis=0), axis=1)
        extent = float(np.linalg.norm(cs - cs.mean(0), axis=1).max()) \
            if n_kf else 0.0
        b_gate = max(5.0 * (float(np.median(odo)) if len(odo) else 1.0),
                     0.25 * extent)
        tried: set[tuple[int, int]] = set()
        cands: list[tuple[int, int, int]] = []
        for row in rows[order]:
            cand_kf = int(row[Y_LOOP_K])
            cur_frame = int(row[Y_FRAME])
            cur_kf_arr = np.nonzero(kvalid & (frames == cur_frame))[0]
            if len(cur_kf_arr) == 0 or not kvalid[cand_kf]:
                continue
            cur_kf = int(cur_kf_arr[0])
            if (cand_kf, cur_kf) in tried:
                continue
            tried.add((cand_kf, cur_kf))
            if (cand_kf < n_kf and cur_kf < n_kf
                    and np.linalg.norm(cs[cur_kf] - cs[cand_kf]) > b_gate):
                continue
            cands.append((cand_kf, cur_kf, cur_frame))
        return cands

    def _ring_poses(self) -> dict:
        return _unpack_ring_poses(_ring_pose_stage(self.carry),
                                  self.carry.ring.pid.shape[0])

    def _check_loops(self, ys: np.ndarray) -> None:
        """Loop closure after a chunk: collect the edges the chunk
        verified on the device (``loop.device_verify``), or verify the
        chunk's gated candidates here (ref cpp:1833-1859), then run the
        pose graph and push the corrected poses back into the carry.  With
        ``loop.method == "orb"`` the candidates come from ORB ratio
        matching instead (``_check_loops_orb``), and what the keyframe
        branch verified on the device is not read, as in the JAX twin."""
        lcfg = self.cfg.loop
        if not lcfg.enabled:
            return
        if lcfg.method == "orb":
            self._check_loops_orb(ys)
            return
        if lcfg.device_verify:
            self._collect_device_loops(ys)
            return
        # cheap ys-only pre-gate: most chunks have no above-threshold
        # candidate — skip the ring-pose pull entirely
        if not self.loop_candidate_rows(ys, lcfg).any():
            return
        rp = self._ring_poses()
        cands = self.gate_loop_candidates(ys, rp, lcfg)
        if cands and self._verify_candidates(cands, rp):
            self._pose_graph_pushback(pr=rp)

    def _verify_candidates(self, cands: list[tuple[int, int, int]],
                           rp: dict) -> bool:
        """Run the loop verification on already-gated ``(cand_kf, cur_kf,
        cur_frame)`` pairs, appending surviving ``Edge``s.  Returns True
        if any edge was added (the caller runs the pose-graph pushback)."""
        cs = rp["t_cw"][: rp["n_kf"]]
        frames = rp["frame"]
        found = False
        for cand_kf, cur_kf, cur_frame in cands:
            old_img = self._images.get(int(frames[cand_kf]))
            new_img = self._images.get(cur_frame)
            if old_img is None or new_img is None:
                continue  # image not retained (non-keyframe)
            edge = self._verify_loop(cand_kf, cur_kf, old_img, new_img, cs)
            if edge is None:
                continue
            self.loop_edges.append(edge)
            found = True
            self._mark_loop(cur_frame, cand_kf, cur_kf)
            log.info("loop closure %d -> %d (inliers %d)", cand_kf, cur_kf,
                     edge.inliers)
        return found

    def _mark_loop(self, frame: int, i: int, j: int) -> None:
        for met in reversed(self.metrics):
            if met.get("frame") == frame:
                met["loop"] = (i, j)
                break

    def _collect_device_loops(self, ys: np.ndarray) -> None:
        """Build ``Edge``s from the loop-verify packs of the chunk's
        metrics rows (the gates and the LK+PnP verification ran per
        keyframe in ``_keyframe_branch``) and run the pose-graph pushback
        if anything was found.  A candidate whose old keyframe has fewer
        than 30 mapped tracks is not verified on the device (degenerate
        map segment) and is logged and skipped."""
        lcfg = self.cfg.loop
        lw = self.cfg.pose_graph.loop_weight
        rows = ys[(ys[:, Y_VALID] > 0.5) & (ys[:, Y_KF] > 0.5)]
        hits = []
        for row in rows:
            if (row[Y_LOOP_S] > lcfg.score_thresh
                    and row[Y_LV_OK] < -0.5 and row[Y_LOOP_K] >= 0):
                log.debug("loop candidate %d->%d not verified on device "
                          "(gate fail or <30 mapped obs)",
                          int(row[Y_LOOP_K]), int(row[Y_KFID]))
            if row[Y_LV_OK] > 0.5:
                hits.append(row)
        if not hits:
            return
        # one packed pose pull for the dir-mode translation weight
        rp = self._ring_poses()
        cs = rp["t_cw"][: rp["n_kf"]]
        odo = np.linalg.norm(np.diff(cs, axis=0), axis=1)
        b_ref = float(np.median(odo)) if len(odo) else 1.0
        for row in hits:
            i, j = int(row[Y_LV_I]), int(row[Y_KFID])
            R_ji = np.asarray(row[Y_LV_R:Y_LV_R + 9],
                              np.float64).reshape(3, 3)
            t_ji = np.asarray(row[Y_LV_T:Y_LV_T + 3], np.float64)
            w_tr = lw
            if self.cfg.translation_mode != TranslationMode.FULL:
                b = float(np.linalg.norm(t_ji))
                w_tr = lw * min(1.0, b / max(b_ref, 1e-12))
            self.loop_edges.append(Edge(
                i=i, j=j, R_ji=R_ji, t_ji=t_ji,
                inliers=int(row[Y_LV_INL]), is_loop=True,
                w_rot=lw, w_trans=w_tr, s_rel=float(row[Y_LV_SREL])))
            self._mark_loop(int(row[Y_FRAME]), i, j)
            log.info("loop closure (device) %d -> %d (inliers %d, "
                     "tracked %d)", i, j, int(row[Y_LV_INL]),
                     int(row[Y_LV_NTR]))
        self._pose_graph_pushback(pr=rp)

    def _orb_for(self, kf_id: int, img) -> None:
        """Compute + cache ORB features for keyframe ``kf_id`` and write
        them into the persistent device-side descriptor bank (so scoring a
        new keyframe against ALL older ones is one batched call)."""
        if kf_id in self._orb_ids:
            return
        xy, d, v = orb_ops.detect_and_describe(
            to_device(np.asarray(img), self.device, f32),
            max_kp=self.cfg.loop.max_keypoints, device=self.device)
        if self._orb_bank is None:
            self._orb_bank = torch.zeros((self.kf_cap, *d.shape), dtype=f32,
                                         device=self.device)
            self._orb_bank_valid = torch.zeros(
                (self.kf_cap, v.shape[0]), dtype=torch.bool,
                device=self.device)
        self._orb_bank[kf_id] = d
        self._orb_bank_valid[kf_id] = v
        self._orb_ids[kf_id] = (xy, d, v)

    def _check_loops_orb(self, ys: np.ndarray) -> None:
        """ORB-flavor loop candidates (ref py:557-570: ratio matching
        against all >= min_kf_gap older keyframes, top-k by match count),
        verified by the same PnP-primary ``_verify_loop`` as the
        descriptor flavor.  Match counts for all candidates come from ONE
        batched call against the persistent bank."""
        lcfg = self.cfg.loop
        rows = ys[(ys[:, Y_VALID] > 0.5) & (ys[:, Y_KF] > 0.5)]
        if len(rows) == 0:
            return
        ring = self.carry.ring
        frames = ring.frame.cpu().numpy()
        kvalid = ring.kvalid.cpu().numpy()
        n_kf = int(self.carry.kf_count)
        cs = ring.t_cw.cpu().numpy().astype(np.float64)[:n_kf]
        found = False
        if 0 not in self._orb_ids and 0 in self._images:
            self._orb_for(0, self._images[0])  # bootstrap keyframe
        for row in rows:
            cur_frame = int(row[Y_FRAME])
            arr = np.nonzero(kvalid & (frames == cur_frame))[0]
            if len(arr) == 0:
                continue
            cur_kf = int(arr[0])
            img_j = self._images.get(cur_frame)
            if img_j is None:
                continue
            self._orb_for(cur_kf, img_j)
            _, d_j, v_j = self._orb_ids[cur_kf]
            counts = _orb_score_bank(self._orb_bank, self._orb_bank_valid,
                                     d_j, v_j).cpu().numpy()
            has = np.zeros(self.kf_cap, bool)
            for k in self._orb_ids:
                has[k] = True
            counts = np.where(has, counts, 0)
            lim = max(cur_kf - lcfg.min_kf_gap + 1, 0)
            scored = [(int(counts[k]), k) for k in range(lim)
                      if kvalid[k] and counts[k] >= lcfg.min_matches]
            scored.sort(reverse=True)
            for n, cand_kf in scored[: max(lcfg.top_k, 1)]:
                old_img = self._images.get(int(frames[cand_kf]))
                if old_img is None:
                    continue
                edge = self._verify_loop(cand_kf, cur_kf, old_img, img_j, cs)
                if edge is None:
                    continue
                self.loop_edges.append(edge)
                found = True
                self._mark_loop(cur_frame, cand_kf, cur_kf)
                log.info("loop closure (orb) %d -> %d (matches %d, "
                         "inliers %d)", cand_kf, cur_kf, n, edge.inliers)
                break
        if found:
            self._pose_graph_pushback()

    def _pnp_edge_from_pack(self, pack: np.ndarray, cand_kf: int,
                            cur_kf: int, cs: np.ndarray):
        """The loop ``Edge`` from a pulled `_pnp_loop_edge` pack
        ([R_ji (9), t_ji (3), inliers, n_tracked, s_rel, ...]); None when
        the PnP verification rejects the candidate."""
        lcfg = self.cfg.loop
        lw = self.cfg.pose_graph.loop_weight
        R_ji = pack[:9].reshape(3, 3)
        t_ji = pack[9:12]
        inliers = int(pack[12])
        n_tracked = int(pack[13])
        s_rel = float(pack[14])
        if n_tracked < min(lcfg.min_tracked, 30) \
                or inliers < lcfg.min_inliers:
            log.info("loop candidate %d->%d rejected "
                     "(pnp tracked=%d inliers=%d)",
                     cand_kf, cur_kf, n_tracked, inliers)
            return None
        w_tr = lw
        if self.cfg.translation_mode != TranslationMode.FULL:
            # dir-mode residual compares unit vectors: still gate the
            # translation by the (now metric, PnP-measured) baseline — a
            # zero-length translation has no direction
            odo = np.linalg.norm(np.diff(cs, axis=0), axis=1)
            b_ref = float(np.median(odo)) if len(odo) else 1.0
            w_tr = lw * min(1.0, float(np.linalg.norm(t_ji))
                            / max(b_ref, 1e-12))
        return Edge(i=cand_kf, j=cur_kf, R_ji=R_ji, t_ji=t_ji,
                    inliers=inliers, is_loop=True,
                    w_rot=lw, w_trans=w_tr, s_rel=s_rel)

    def _verify_loop(self, cand_kf: int, cur_kf: int, old_img, new_img,
                     cs: np.ndarray):
        """Verify a loop candidate and build its pose-graph edge.

        Primary path: PnP against the old keyframe's mapped tracks
        (``_pnp_loop_edge``) — metric and reliable at any baseline.
        Fallback (old keyframe has fewer than 30 mapped tracks): the
        reference-style corner re-detect + LK + E-RANSAC
        (``_loop_verify_stage``), its edge weight gated by the baseline
        since E degenerates as the baseline vanishes."""
        kcfg = self.cfg.klt
        ring = self.carry.ring
        lw = self.cfg.pose_graph.loop_weight
        self.host_verifications += 1
        old_t = torch.from_numpy(np.array(old_img)).to(self.device)
        new_t = torch.from_numpy(np.array(new_img)).to(self.device)
        # one scalar pull decides the branch
        n_mapped = int(torch.sum(ring.tvalid[cand_kf]
                                 & (ring.pid[cand_kf] >= 0)))
        if n_mapped >= 30:
            fx = float(self.K[0, 0])
            pack = _pnp_loop_edge(
                kcfg, self._Kt, ring, self.carry.X,
                _build_pyr(old_t, kcfg.pyr_levels),
                _build_pyr(new_t, kcfg.pyr_levels), cand_kf, cur_kf,
                self.cfg.ba.huber_delta / fx)
            return self._pnp_edge_from_pack(
                pack.cpu().numpy().astype(np.float64), cand_kf, cur_kf, cs)
        # ---- fallback: reference-style E-RANSAC verification ----------
        R, t, inliers, n_tracked = self._verify_pair(old_t, new_t)
        if R is None:
            log.info("loop candidate %d->%d rejected (tracked=%d)",
                     cand_kf, cur_kf, n_tracked)
            return None
        if self.cfg.translation_mode != TranslationMode.FULL:
            n = np.linalg.norm(t)
            if n > 1e-12:
                t = t / n
        # E = [t]x R vanishes with the baseline: gate BOTH rotation and
        # translation weights by the estimated baseline so a near-revisit
        # edge (direction AND rotation unobservable) self-silences
        odo = np.linalg.norm(np.diff(cs, axis=0), axis=1)
        b_ref = float(np.median(odo)) if len(odo) else 1.0
        b = float(np.linalg.norm(cs[cur_kf] - cs[cand_kf]))
        w_loop = lw * min(1.0, b / max(b_ref, 1e-12))
        return Edge(i=cand_kf, j=cur_kf, R_ji=R, t_ji=t, inliers=inliers,
                    is_loop=True, w_rot=w_loop, w_trans=w_loop)

    def _verify_pair(self, old_img, new_img):
        """E-RANSAC verification of an image pair.  Returns (R, t,
        inliers, n_tracked) with R None when the pair is rejected."""
        lcfg = self.cfg.loop
        kcfg = self.cfg.klt
        gen = torch.Generator(device=self.device)
        gen.manual_seed(self.cfg.ransac.seed + 7919)
        pack = _loop_verify_stage(
            gen, self._Kt, old_img, new_img, levels=kcfg.pyr_levels,
            lk_iters=kcfg.iters, radius=kcfg.win_radius,
            fb_thresh=kcfg.fb_thresh,
            cell=max(int(kcfg.min_distance), 2), quality=kcfg.quality,
            num_hypotheses=lcfg.ransac_iters,
            sampson_thresh=lcfg.ransac_thresh,
            min_inliers=lcfg.min_inliers,
        ).cpu().numpy().astype(np.float64)  # one pull
        ok, inliers, n_tracked = pack[12] > 0.5, int(pack[13]), int(pack[14])
        if (n_tracked < lcfg.min_tracked or not ok
                or inliers < lcfg.min_inliers):
            return None, None, inliers, n_tracked
        return pack[:9].reshape(3, 3), pack[9:12], inliers, n_tracked

    def _drain_edges(self, drained: dict):
        """Odometry edges from a drain dict or a ring-pose dict (both
        carry the e_* fields), plus the loop edges."""
        n_kf = (int(drained["counts"][0]) if "counts" in drained
                else drained["n_kf"])
        e_R, e_t = drained["e_Rji"], drained["e_tji"]
        e_inl, e_val = drained["e_inl"], drained["e_valid"]
        edges = [
            Edge(i=k - 1, j=k, R_ji=e_R[k], t_ji=e_t[k],
                 inliers=int(e_inl[k]), is_loop=False)
            for k in range(1, n_kf) if e_val[k]
        ]
        return edges + list(self.loop_edges)

    def _pose_graph_pushback(self, pr: dict | None = None) -> None:
        """Pose graph over the ring poses + edges; the corrected poses are
        written back into the device carry (ref py:990-1001 /
        cpp:1862).  ``pr``: a pre-pulled ring-pose dict (verification
        does not move poses, so the gate's pull is still exact here)."""
        if pr is None:
            pr = self._ring_poses()
        solved = self._pose_graph_solve(pr)
        if solved is None:
            return
        ring_R, ring_t = solved
        n_kf = pr["n_kf"]
        c = self.carry
        c.ring.R_cw.copy_(torch.from_numpy(ring_R))
        c.ring.t_cw.copy_(torch.from_numpy(ring_t))
        c.R_cw = to_device(ring_R[n_kf - 1], self.device)
        c.t_cw = to_device(ring_t[n_kf - 1], self.device)
        self._pg_ran = True
        self.pg_solves += 1

    def _pose_graph_solve(self, pr: dict):
        """Solve the pose graph from a pre-pulled ring-pose dict, in
        float64 on the device.  Returns the full-ring corrected
        ``(ring_R, ring_t)`` float32 arrays (rows past n_kf unchanged), or
        None when the graph is degenerate.  Does not touch the carry."""
        pcfg = self.cfg.pose_graph
        n_kf = pr["n_kf"]
        edges = self._drain_edges(drained=pr)
        if n_kf < 3 or len(edges) < 2:
            return None
        Np = _next_pow2(n_kf, lo=8)
        Ep = _next_pow2(len(edges), lo=8)
        R_all = pr["R_cw"]
        C_all = pr["t_cw"]
        R_cw = np.concatenate(
            [R_all[:n_kf], np.tile(np.eye(3), (Np - n_kf, 1, 1))])
        C = np.concatenate([C_all[:n_kf], np.zeros((Np - n_kf, 3))])
        e_i = np.zeros(Ep, np.int64)
        e_j = np.zeros(Ep, np.int64)
        R_meas = np.tile(np.eye(3), (Ep, 1, 1))
        t_meas = np.zeros((Ep, 3))
        t_meas[:, 2] = 1.0
        w_rot = np.zeros(Ep)
        w_trans = np.zeros(Ep)
        valid = np.zeros(Ep, bool)
        t_full = np.zeros(Ep, bool)
        s_meas = np.ones(Ep)
        for k, e in enumerate(edges):
            e_i[k], e_j[k] = e.i, e.j
            if not e.is_loop and e.j == e.i + 1:
                # refresh odometry constraints from the BA-refined ring
                # poses (metric, t_full) so the solve distributes loop
                # error instead of dragging refined poses toward raw
                # pre-BA measurements — and so dir-mode centers cannot
                # slide along fixed directions at zero cost
                R_meas[k] = R_all[e.j].T @ R_all[e.i]
                t_meas[k] = R_all[e.j].T @ (C_all[e.i] - C_all[e.j])
                t_full[k] = True
            else:
                R_meas[k], t_meas[k] = e.R_ji, e.t_ji
            w_rot[k] = pcfg.w_rot * e.w_rot
            w_trans[k] = pcfg.w_trans * e.w_trans
            valid[k] = True
            s_meas[k] = e.s_rel
        put = lambda a: to_device(a, self.device)  # noqa: E731
        prob = pg_ops.PoseGraphProblem(
            R_cw=put(R_cw), C=put(C), e_i=put(e_i), e_j=put(e_j),
            R_meas=put(R_meas), t_meas=put(t_meas), w_rot=put(w_rot),
            w_trans=put(w_trans), valid=put(valid), t_full=put(t_full))
        mode = self.cfg.translation_mode.value
        if pcfg.mode == "centers":
            R_new, C_new, _ = pg_ops.optimize_centers(prob)
        elif pcfg.mode == "sim3":
            R_new, C_new, _s, _ = pg_ops.optimize_sim3(
                prob, s_meas=put(s_meas), mode=mode, iters=pcfg.iters,
                lambda0=pcfg.lambda0)
        else:
            R_new, C_new, _ = pg_ops.optimize_se3(
                prob, mode=mode, iters=pcfg.iters, lambda0=pcfg.lambda0)
        ring_R = R_all.astype(np.float32).copy()
        ring_t = C_all.astype(np.float32).copy()
        ring_R[:n_kf] = R_new.cpu().numpy().astype(np.float32)[:n_kf]
        ring_t[:n_kf] = C_new.cpu().numpy().astype(np.float32)[:n_kf]
        return ring_R, ring_t

    # -- finalize + export ---------------------------------------------
    def _drain(self) -> dict:
        """Pull the drainable device state to the host (float64 / int64 /
        bool numpy arrays, the layout the JAX twin's ``_unpack_drain``
        gives)."""
        c = self.carry
        ring = c.ring
        d = {}
        for name in ("R_cw", "t_cw", "uv", "desc", "e_Rji", "e_tji"):
            d[name] = getattr(ring, name).cpu().numpy().astype(np.float64)
        for name in ("frame", "ids", "pid", "e_inl"):
            d[name] = getattr(ring, name).cpu().numpy().astype(np.int64)
        for name in ("tvalid", "e_valid"):
            d[name] = getattr(ring, name).cpu().numpy().astype(bool)
        d["X"] = c.X.cpu().numpy().astype(np.float64)
        d["counts"] = np.array([int(c.kf_count), int(c.n_pts)], np.float64)
        return d

    def finalize(self, drained: dict | None = None,
                 refine: bool = True) -> None:
        """Flush, drain the device state, re-triangulate and polish the
        map, and build the host-side keyframe/edge views.

        ``drained``: optional pre-pulled drain dict (the layout of
        ``_drain``); callers passing it must have no pending frames.  The
        refinement rounds read the device ring in place, so they run only
        without ``drained``; with it, a round that would have to run
        raises (the host twins of those rounds are not ported yet, see
        ROADMAP.md).  ``refine=False`` skips the rounds."""
        assert drained is None or not self._pending, \
            "finalize(drained=...) with pending frames"
        self._flush()
        if drained is None:
            if self.carry is None:
                raise RuntimeError(
                    "finalize() before any frame was processed")
            d = self._drain()
        else:
            d = drained
        n_kf = int(d["counts"][0])
        n_pts = int(d["counts"][1])
        R_cw = d["R_cw"][:n_kf]
        t_cw = d["t_cw"][:n_kf]
        frames = d["frame"][:n_kf]
        uv = d["uv"][:n_kf]
        ids = d["ids"][:n_kf]
        tvalid = d["tvalid"][:n_kf]
        pid = d["pid"][:n_kf]
        desc = d["desc"][:n_kf]
        X = d["X"][:n_pts]

        # Final refinement is STRUCTURE-ONLY: after a pose-graph
        # correction the map is triangulated against stale poses, so
        # re-triangulate first-vs-last with the corrected poses, then
        # polish points with frozen-pose LM (ops/ba.refine_points).  Full
        # pose+point BA here bends the monocular gauge: the trajectory is
        # already optimal from the window BA + PnP + pose graph.
        if refine and self.refine_rounds > 0:
            m = int((tvalid & (pid >= 0) & (pid < n_pts)).sum())
            do0 = self._pg_ran and n_pts >= 10
            later = n_pts >= 10
            en_ref = (self.cfg.ba.global_iters > 0 and n_kf >= 3
                      and n_pts >= 10 and m >= 30)
            if do0 or (later and self.refine_rounds > 1) or en_ref:
                if drained is not None:
                    raise NotImplementedError(
                        "finalize(drained=..., refine=True) needs the host "
                        "twins _retriangulate/_refine_structure, not "
                        "ported yet: see ROADMAP.md, Queue 1")
                fx = float(self.K[0, 0])
                with torch.no_grad():
                    Xd, cost0, cost = _finalize_refine_core(
                        self._Kt, self.carry.ring, self.carry.X, n_pts,
                        do0, later, en_ref, iters=self.cfg.ba.global_iters,
                        rounds=self.refine_rounds,
                        lambda0=self.cfg.ba.lambda0,
                        huber_delta=self.cfg.ba.huber_delta / fx)
                X = Xd.cpu().numpy().astype(np.float64)[:n_pts]
                if en_ref:
                    log.info("structure refine: cost %.3e -> %.3e "
                             "(%d kfs, %d pts, %d obs)", float(cost0),
                             float(cost), n_kf, n_pts, m)

        # gt-scale re-anchor: the window BA fixes only its oldest camera,
        # so the monocular scale gauge drifts NON-UNIFORMLY over a long
        # run even when every keyframe EDGE was created at the GT
        # baseline.  Re-apply the same per-edge GT information once more:
        # re-integrate the trajectory keeping the optimized edge
        # DIRECTIONS and rotations but setting each consecutive-keyframe
        # baseline to its GT length (the reference's scale_translation
        # semantic, ref py:888-898, applied to the final geometry).  The
        # map is rescaled by the median edge ratio about the first
        # keyframe (a global approximation; the metric contract of
        # use_gt_scale is the trajectory).
        s_edge = None
        s_anchor = 1.0
        if self.cfg.use_gt_scale and self._gt_C is not None and n_kf >= 2:
            gt = self._gt_C.cpu().numpy().astype(np.float64)[
                np.asarray(frames[:n_kf], int)]
            # ring poses are cam->world: t_cw IS the camera center
            C = np.asarray(t_cw[:n_kf], np.float64)
            dC = np.diff(C, axis=0)
            eb = np.linalg.norm(dC, axis=1)
            gb = np.linalg.norm(np.diff(gt, axis=0), axis=1)
            ok = eb > 1e-12
            if ok.any():
                s_edge = np.where(ok, gb / np.where(ok, eb, 1.0), 1.0)
                s_anchor = float(np.median(s_edge[ok]))
                t_cw = np.concatenate(
                    [C[:1], C[0] + np.cumsum(s_edge[:, None] * dC, 0)])
                if len(X):
                    X = C[0] + s_anchor * (X - C[0])

        self.kfs = [
            Keyframe(kf_id=k, frame_idx=int(frames[k]),
                     img_name=self._names[int(frames[k])],
                     R_cw=R_cw[k], t_cw=t_cw[k], ids=ids[k], uv=uv[k],
                     valid=tvalid[k], desc=desc[k])
            for k in range(n_kf)
        ]
        self.edges = self._drain_edges(d)
        if s_edge is not None:
            # odometry edge (k-1 -> k) gets ITS re-integrated edge scale;
            # loop edges (arbitrary i -> j) get the median
            self.edges = [
                dataclasses.replace(
                    e, t_ji=e.t_ji * (
                        s_edge[e.j - 1]
                        if not e.is_loop and 1 <= e.j <= len(s_edge)
                        else s_anchor))
                for e in self.edges
            ]
        self._X = X
        self._ring_pid = pid  # (n_kf, T) observation matrix, for tooling

    @property
    def map_xyz(self) -> np.ndarray:
        return self._X

    def export(self, out_dir, dataset=None) -> dict:
        out = Path(out_dir)
        out.mkdir(parents=True, exist_ok=True)
        rows = []
        for kf in self.kfs:
            lat, lon = (float("nan"), float("nan"))
            if dataset is not None:
                lat, lon = dataset.angles_for(kf.img_name)
            C = kf.center
            rows.append(dict(
                kf_id=kf.kf_id, frame_idx=kf.frame_idx, image=kf.img_name,
                x=float(C[0]), y=float(C[1]), z=float(C[2]),
                lat=lat, lon=lon))
        artifacts.write_csv_centers(
            out / "keyframes_camera_centers.csv", rows)
        edge_rows = []
        for e in self.edges:
            rvec = np_geom.so3_log(np.asarray(e.R_ji, np.float64))
            edge_rows.append(dict(
                i=e.i, j=e.j, kind="loop" if e.is_loop else "odom",
                rvec=rvec, t=e.t_ji))
        artifacts.write_posegraph_edges(out / "posegraph_edges.csv",
                                        edge_rows)
        culled = 0
        if self.cfg.export_geometry in (
                ExportGeometry.POINTCLOUD, ExportGeometry.BOTH):
            X = np.asarray(self._X, np.float64)
            if self.kfs and len(X):
                # cull export noise: a point whose best residual is past
                # the BA gross-outlier gate carried zero weight in every
                # solve (see np_geom.export_keep_mask)
                fx = float(self.K[0, 0])
                keep = np_geom.export_keep_mask(
                    self.K, np.stack([kf.R_cw for kf in self.kfs]),
                    np.stack([kf.center for kf in self.kfs]),
                    np.stack([kf.uv for kf in self.kfs]),
                    np.stack([kf.valid for kf in self.kfs]),
                    self._ring_pid, X,
                    thresh_norm=ba_ops._CUTOFF
                    * self.cfg.ba.huber_delta / fx)
                culled = int((~keep).sum())
                X = X[keep]
            artifacts.write_ply_xyz(
                out / "templeRing_sparse_points.ply", X)
        return {"keyframes": len(self.kfs), "map_points": len(self._X),
                "culled": culled, "edges": len(self.edges),
                "out": str(out)}

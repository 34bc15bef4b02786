"""Device-resident SfM frame loop (single scene).

Counterpart of sfm_tpu/models/scan_pipeline.py (reference: cpp/src/
templering_sfm.cpp:1708-1871 main frame loop; python/src/
templering_sfm.py:1022-1059 ``ClassicSystem.process``).  The whole
per-frame pipeline (pyramid build → KLT tracking → two-view LO-RANSAC →
keyframe policy → edge RANSAC + scale propagation + PnP → first-vs-last
triangulation → map/observation bookkeeping → sliding-window Schur-LM BA)
runs on the device; the host uploads frames, branches on the keyframe
decision, and pulls one small metrics row per frame at the end of each
chunk.

Device state (fixed capacity):
  * track table        (T,)    — TrackerState from models/tracker.py
  * keyframe ring      (K,)    — pose, frame idx, full (T,)-slot snapshot
                                 (uv/ids/valid), per-slot point ids, the
                                 32x32 global descriptor, and the incoming
                                 odometry edge
  * map point table    (P,3)   — cursor-allocated, never compacted
  * per-slot overlays  (T,)    — current point id, first-observation
                                 (kf, uv) for deferred triangulation

The ring's per-slot point-id matrix ``pid (K,T)`` IS the observation
table: entry (k,s) with ``pid>=0`` means keyframe k observed point ``pid``
at ``uv[k,s]``.  Triangulating a track backfills its id into every earlier
ring row where the same track id occupied slot s, so window BA reads its
observation set with plain gathers.

Where the JAX twin's ``lax.scan``/``lax.cond`` make one compiled program,
this is a Python loop with two host branches per frame (replenish, and the
keyframe decision: one host sync each).  Where the JAX twin rebuilds the
ring and map tables with ``.at[].set``, this code updates them IN PLACE:
a carry handed to ``frame_step``/``run_chunk`` is consumed by the call.

This slice runs with loop closure off and without the final structure
refinement; ``ScanSfM`` raises for configurations that need them.
"""

from __future__ import annotations

import dataclasses
import logging
from pathlib import Path

import numpy as np
import torch

from sfm_tpu_torch.config import (ExportGeometry, SystemConfig,
                                  TranslationMode)
from sfm_tpu_torch.models import tracker
from sfm_tpu_torch.models.mapstate import Edge, Keyframe
from sfm_tpu_torch.ops import (ba as ba_ops, descriptors, epipolar,
                               image as im, pnp as pnp_ops, triangulate)
from sfm_tpu_torch.ops.features import top_k_stable
from sfm_tpu_torch.ops.linalg import nanmedian
from sfm_tpu_torch.utils import artifacts, np_geom
from sfm_tpu_torch.utils.device import resolve, to_device

log = logging.getLogger("sfm_tpu_torch")

f32 = torch.float32
i32 = torch.int32

# per-frame metrics vector layout (the only per-frame device→host data).
# Y_KFID..Y_LV_T carry the device-verified loop edge of the JAX twin; this
# slice always writes the "not run" pack there (-1, -1, zeros).
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
    img: torch.Tensor       # (K,1,1) u8 placeholder (keyframe grays of the
    #                         JAX twin's device-side loop verification)


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
    ring = _empty_ring(kf_cap, T, dev)
    ring.frame[0] = int(idx0)
    ring.kvalid[0] = True
    ring.uv[0] = trk.pos.to(f32)
    ring.ids[0] = trk.ids
    ring.tvalid[0] = trk.valid
    ring.desc[0] = descriptors.global_desc_32(pyr[0]).to(f32)
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
                     idx: int, kf_id: int, rp_frame=None, pri=None):
    """All keyframe-time geometry + bookkeeping, device-side (ref
    py:951-988 add_keyframe / cpp:1765-1871 keyframe block).

    ``kf_id`` is the host's copy of ``carry.kf_count`` (bootstrap wrote
    keyframe 0).  With ``rp_frame`` (this frame's two-view result from the
    tracking prefix) the edge RANSAC is skipped: the caller passes it when
    the previous keyframe IS the previous frame and that result is ok —
    the snapshot then equals the prefix's input and the two solves are
    statistically identical.  ``pri``: optional (H,T) sampling priorities
    for the edge RANSAC (tests).

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
    s_map = torch.clamp(
        s_map,
        min=torch.where(have_prev, b_prev / 3.0, torch.zeros_like(b_prev)),
        max=torch.where(have_prev, 3.0 * b_prev,
                        torch.full_like(b_prev, float("inf"))),
    )

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

    # --- global-descriptor score of the best older keyframe (the metrics
    # row's loop_score/loop_cand; verification and pose graph are not in
    # this slice) ---------------------------------------------------------
    cand = (karange[:, 0] <= kf_id - cfg.loop.min_kf_gap) & ring.kvalid
    scores = torch.where(cand, ring.desc @ desc,
                         torch.full((K,), float("-inf"), device=dev))
    best_k = torch.argmax(scores)
    best_s = scores[best_k]

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
        _lv_not_run(dev),
    ])
    return carry, ykf


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
               idx: int, pri_frame=None, pri_edge=None):
    """One frame: tracking prefix, then the keyframe branch when the
    policy asks for it.  The keyframe decision (with the edge-reuse flag
    and the keyframe counter) is the frame's one host pull here.
    Returns (carry, y (NY,) f32 metrics row)."""
    carry, make_kf, reuse, rp, y_pre = _track_and_pose_rp(
        cfg, Kf, carry, img, idx, pri=pri_frame)
    mk, ru, kf_id = torch.stack(
        [make_kf.to(i32), reuse.to(i32), carry.kf_count]).tolist()
    if mk:
        carry, ykf = _keyframe_branch(
            cfg, p_ba, Kf, carry, idx, kf_id,
            rp_frame=rp if ru else None, pri=pri_edge)
    else:
        ykf = ykf_none(carry.X.device)
    return carry, _pack_frame_metrics(carry, idx, y_pre, ykf)


def run_chunk(cfg: SystemConfig, p_ba: int, Kf, carry: ScanCarry,
              imgs, idxs, fvalid):
    """Process a chunk of frames.

    imgs: sequence of (H,W) u8/f32 tensors on the carry's device; idxs
    (C,) frame indices and fvalid (C,) bool on the host — padding frames
    (fvalid False) are no-ops with an all-zero metrics row, as in the JAX
    twin.  Returns (carry, ys (C,NY) f32 on the device)."""
    dev = carry.X.device
    ys = []
    for img, idx, fval in zip(imgs, idxs, fvalid):
        if not bool(fval):
            ys.append(torch.zeros((NY,), dtype=f32, device=dev))
            continue
        carry, y = frame_step(cfg, p_ba, Kf, carry, img, int(idx))
        ys.append(y)
    return carry, torch.stack(ys)


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

    Per chunk of frames: one ``run_chunk`` call + one metrics pull. At the
    end: drain the ring and export.  Same external surface as the JAX
    twin (kfs / edges / metrics / export) so eval tooling is shared.

    ``device`` defaults to ``"cuda"``; without a card the constructor
    raises (pass ``device="cpu"`` to run the plain versions).
    """

    def __init__(self, K: np.ndarray, cfg: SystemConfig,
                 n_frames: int | None = None, chunk: int = 16,
                 p_cap: int = 16384, p_ba: int = 1024, gt_records=None,
                 device="cuda"):
        self.device = resolve(device)
        waits = []
        if cfg.loop.enabled:
            waits.append("cfg.loop.enabled (loop closure + pose graph)")
        if cfg.ba.global_iters > 0:
            waits.append("cfg.ba.global_iters > 0 (final structure "
                         "refinement, refine_points)")
        if cfg.use_gt_scale:
            waits.append("cfg.use_gt_scale (GT edge scaling + finalize "
                         "re-anchor)")
        if waits:
            raise NotImplementedError(
                "sfm_tpu_torch.ScanSfM does not support " + "; ".join(waits)
                + " yet: see ROADMAP.md, Queue 1, 'loop closure, pose "
                "graph, finalize refinement'. Set loop.enabled=False, "
                "ba.global_iters=0, use_gt_scale=False.")
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
        self._names: list[str] = []
        self._pending: list[tuple[int, str, torch.Tensor]] = []
        self.kfs: list[Keyframe] = []
        self.edges: list[Edge] = []
        self._X = np.zeros((0, 3))
        self._ring_pid = None

    # -- streaming interface -------------------------------------------
    def process(self, frame_idx: int, img_name: str,
                gray_u8: np.ndarray) -> None:
        self._names.append(img_name)
        # start the frame's upload now; it is consumed at the next flush
        dev_img = torch.from_numpy(np.array(gray_u8)).to(
            self.device, non_blocking=True)
        if self.carry is None:
            with torch.no_grad():
                self.carry = bootstrap_carry(
                    self.cfg, self.kf_cap, self.p_cap, dev_img,
                    int(frame_idx), device=self.device)
            self.metrics.append(
                {"frame": frame_idx, "image": img_name, "keyframe": True,
                 "tracks": int(self.cfg.klt.max_tracks)})
            return
        self._pending.append((frame_idx, img_name, dev_img))
        if len(self._pending) >= self.chunk:
            self._flush()

    def _flush(self) -> None:
        if not self._pending:
            return
        C = self.chunk
        idxs = np.zeros((C,), np.int32)
        fvalid = np.zeros((C,), bool)
        imgs = []
        for k, (idx, _, d) in enumerate(self._pending):
            imgs.append(d)
            idxs[k] = idx
            fvalid[k] = True
        imgs.extend([imgs[0]] * (C - len(imgs)))  # tail chunk: padding
        names = {idx: name for idx, name, _ in self._pending}
        self._pending = []
        with torch.no_grad():
            self.carry, ys = run_chunk(
                self.cfg, self.p_ba, self._Kt, self.carry, imgs, idxs,
                fvalid)
        ys = ys.cpu().numpy().astype(np.float64)  # the chunk's one pull
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
            self.metrics.append(met)
            log.info(
                "frame %d | kf=%s | inliers=%d | parallax=%.2f | "
                "tracks=%d | map_points=%d",
                fi, met["keyframe"], met["inliers"], met["parallax"],
                met["tracks"], met["map_points"],
            )

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

    def _drain_edges(self, drained: dict):
        """Odometry edges from a drain dict (plus any loop edges)."""
        n_kf = int(drained["counts"][0])
        e_R, e_t = drained["e_Rji"], drained["e_tji"]
        e_inl, e_val = drained["e_inl"], drained["e_valid"]
        edges = [
            Edge(i=k - 1, j=k, R_ji=e_R[k], t_ji=e_t[k],
                 inliers=int(e_inl[k]), is_loop=False)
            for k in range(1, n_kf) if e_val[k]
        ]
        return edges + list(self.loop_edges)

    def finalize(self) -> None:
        """Flush, drain the device state, and build the host-side
        keyframe/edge views.  (The JAX twin's re-triangulation and
        structure-only refinement rounds run only after a pose-graph
        correction or with ``ba.global_iters > 0``: neither is part of
        this slice.)"""
        self._flush()
        if self.carry is None:
            raise RuntimeError("finalize() before any frame was processed")
        d = self._drain()
        n_kf = int(d["counts"][0])
        n_pts = int(d["counts"][1])
        frames = d["frame"][:n_kf]
        pid = d["pid"][:n_kf]
        self.kfs = [
            Keyframe(kf_id=k, frame_idx=int(frames[k]),
                     img_name=self._names[int(frames[k])],
                     R_cw=d["R_cw"][k], t_cw=d["t_cw"][k], ids=d["ids"][k],
                     uv=d["uv"][k], valid=d["tvalid"][k], desc=d["desc"][k])
            for k in range(n_kf)
        ]
        self.edges = self._drain_edges(d)
        self._X = d["X"][:n_pts]
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

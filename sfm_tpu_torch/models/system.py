"""End-to-end SfM system: host-driven frame loop over device stages.

Counterpart of sfm_tpu/models/system.py (reference: python/src/
templering_sfm.py:858-1063 ``ClassicSystem``; the C++ main frame loop
cpp:1708-1871).  Control flow (keyframe decisions, map bookkeeping) stays
on the host in numpy; every numeric stage — pyramid build, KLT step,
LO-RANSAC, the fused keyframe geometry, BA, pose graph — runs on the
device at fixed capacities (``TRI_CAP``, ``PNP_CAP``, ``BA_OBS_CAP``,
``_gba_caps``) and hands its result back in ONE packed pull.

Precision follows the JAX twin: the stages that cast to float32 there
(two-view, keyframe geometry, loop PnP) run in float32; the BA and
pose-graph problems, which the JAX twin builds from float64 numpy under
x64, run in float64.  RANSAC draws its (H,N) sampling priorities from a
``torch.Generator`` on the device seeded with ``cfg.ransac.seed``, one
draw per call in the JAX twin's order of calls (see ``_next_key``).
"""

from __future__ import annotations

import logging
import time
from pathlib import Path

import numpy as np
import torch

from sfm_tpu_torch.config import (ExportGeometry, SystemConfig,
                                  TranslationMode)
from sfm_tpu_torch.models import tracker
from sfm_tpu_torch.models.mapstate import Edge, Keyframe, MapState
from sfm_tpu_torch.models.scan_pipeline import _loop_pnp_stage, _next_pow2
from sfm_tpu_torch.ops import (ba as ba_ops, descriptors, epipolar, features,
                               image as im, klt, orb as orb_ops,
                               pnp as pnp_ops, posegraph as pg_ops,
                               triangulate)
from sfm_tpu_torch.ops.linalg import nanmedian
from sfm_tpu_torch.utils import artifacts, np_geom
from sfm_tpu_torch.utils.device import resolve, to_device
from sfm_tpu_torch.utils.profiling import StageTimers

log = logging.getLogger("sfm_tpu_torch")

f32 = torch.float32
f64 = torch.float64


# Fixed per-stage capacities (the JAX twin's: each in-loop stage has one
# shape).  Overflow is truncated; for triangulation the leftover tracks
# stay pending until the next keyframe.
TRI_CAP = 1024
PNP_CAP = 1024
BA_OBS_CAP = 4096


def _gba_caps(n_kfs: int, n_pts: int, n_obs: int):
    """Global final BA capacities: a small bucket for tests / short runs,
    then power-of-two growth (F*P > 8192: the AoS path of ba.py)."""
    if n_kfs <= 8 and n_pts <= 1024 and n_obs <= 4096:
        return 8, 1024, 4096
    return (
        _next_pow2(n_kfs, lo=64),
        _next_pow2(n_pts, lo=16384),
        _next_pow2(n_obs, lo=32768),
    )


def build_pyramid_u8(img_u8, levels: int):
    """Image pyramid (finest first, float32) of a u8 or f32 device image."""
    return tuple(p.contiguous()
                 for p in im.build_pyramid(img_u8.to(f32), levels))


def _two_view_stage(pri, K, pi, pj, valid, num_hypotheses: int,
                    sampson_thresh, min_inliers: int):
    """Per-frame relative pose + median parallax (ref py:900-913, 882-886;
    cpp:1739, 1750-1759).  ``pri``: the (H,N) sampling priorities.
    Returns ONE packed (16,) f32 vector — [R(9), t(3), ok, num_inliers,
    parallax, n_alive] — so the host needs a single pull per call."""
    Kd = K.to(pi.dtype)
    xi = epipolar.normalize_by_K(Kd, pi)
    xj = epipolar.normalize_by_K(Kd, pj)
    rp = epipolar.find_E_ransac(
        None, xi, xj, valid, num_hypotheses=num_hypotheses,
        sampson_thresh=sampson_thresh, min_inliers=min_inliers, pri=pri)
    flow = torch.linalg.vector_norm(pj - pi, dim=-1)
    parallax = torch.nan_to_num(nanmedian(
        torch.where(valid, flow, torch.full_like(flow, float("nan")))))
    return torch.cat([
        rp.R.reshape(9).to(f32),
        rp.t.to(f32),
        torch.stack([
            rp.ok.to(f32),
            rp.num_inliers.to(f32),
            parallax.to(f32),
            torch.sum(valid).to(f32),
        ]),
    ])


class TwoView:
    """Host-side view of the packed two-view result."""

    __slots__ = ("R", "t", "ok", "num_inliers", "parallax", "n_alive")

    def __init__(self, pack: torch.Tensor):
        pack = pack.cpu().numpy().astype(np.float64)
        self.R = pack[:9].reshape(3, 3)
        self.t = pack[9:12]
        self.ok = bool(pack[12] > 0.5)
        self.num_inliers = int(pack[13])
        self.parallax = float(pack[14])
        self.n_alive = int(pack[15])


def _pack_state(state: tracker.TrackerState):
    """Track-table snapshot as ONE (T,4) f32 tensor: [x, y, id, valid]."""
    return torch.cat([
        state.pos.to(f32),
        state.ids.to(f32)[:, None],
        state.valid.to(f32)[:, None],
    ], dim=1)


def _snapshot_stage(state: tracker.TrackerState, img):
    """Keyframe snapshot + 32x32 global descriptor in ONE packed pull:
    (T*4 + 1024,) f32."""
    snap = _pack_state(state)
    desc = descriptors.global_desc_32(img)
    return torch.cat([snap.reshape(-1), desc.to(f32)])


def _keyframe_fused_stage(
    pri, K,
    prev_uv, prev_shared,
    cur_uv,
    R_chain_rel, t_chain_rel,
    R_wc_i, t_wc_i,
    pnp_X, pnp_uv, pnp_valid,
    tri_Ra, tri_ta, tri_uva, tri_uvb, tri_valid,
    fixed_scale,
    num_hypotheses: int, sampson_thresh, min_inliers: int,
    pnp_iters: int, pnp_huber,
):
    """The whole keyframe geometry in ONE device program + ONE pull:

      1. odometry-edge LO-RANSAC between the keyframe snapshots
         (ref cpp:1782-1798), chain fallback when it fails;
      2. monocular scale propagation from mapped points (1-dof robust LS);
      3. PnP pose refinement against the map (ops/pnp.py), anchored on the
         scaled edge;
      4. the final relative edge re-derived from the refined poses;
      5. first-vs-last DLT triangulation of new tracks with the refined
         pose (ref py:935-949).

    float32 throughout; returns one packed f32 vector."""
    Kd = K.to(f32)
    xi = epipolar.normalize_by_K(Kd, prev_uv)
    xj = epipolar.normalize_by_K(Kd, cur_uv)
    rp = epipolar.find_E_ransac(
        None, xi, xj, prev_shared, num_hypotheses=num_hypotheses,
        sampson_thresh=sampson_thresh, min_inliers=min_inliers, pri=pri)
    t_chain_u = t_chain_rel / (torch.linalg.vector_norm(t_chain_rel) + 1e-12)
    R_e = torch.where(rp.ok, rp.R, R_chain_rel)
    t_eu = torch.where(rp.ok, rp.t, t_chain_u)

    # --- scale propagation (vectorized twin of the old host loop) -----
    Xi = pnp_X @ R_wc_i.T + t_wc_i  # map points in the previous camera
    xjn = epipolar.normalize_by_K(Kd, pnp_uv)
    w3 = Xi @ R_e.T
    a = t_eu[None, :2] - xjn * t_eu[2]
    b = xjn * w3[:, 2:3] - w3[:, :2]
    den = torch.sum(a * a, dim=-1)
    good = pnp_valid & (Xi[:, 2] > 1e-6) & (den > 1e-10)
    sols = torch.sum(a * b, dim=-1) / torch.where(den > 1e-10, den,
                                                  torch.ones_like(den))
    s_est = nanmedian(torch.where(good, sols,
                                  torch.full_like(sols, float("nan"))))
    s_est = torch.nan_to_num(s_est, nan=1.0)
    enough = torch.sum(good) >= 5
    one = torch.ones_like(s_est)
    s_map = torch.where(enough & (s_est > 1e-6), s_est, one)
    s_map = torch.where(fixed_scale > 0.0, fixed_scale, s_map)

    # --- anchored pose (world→cam_j) ----------------------------------
    R_a = R_e @ R_wc_i
    t_a = R_e @ t_wc_i + s_map * t_eu

    # --- PnP refinement ------------------------------------------------
    R_p, t_p, info = pnp_ops.refine_pose(
        R_a, t_a, pnp_X, xjn, pnp_valid, iters=pnp_iters,
        huber_delta=pnp_huber)
    use_pnp = info["inliers"] >= 30
    R_f = torch.where(use_pnp, R_p, R_a)
    t_f = torch.where(use_pnp, t_p, t_a)

    # --- final edge from the refined poses -----------------------------
    R_ji = R_f @ R_wc_i.T
    t_ji = t_f - R_ji @ t_wc_i

    # --- triangulation with the refined pose ---------------------------
    xa = epipolar.normalize_by_K(Kd, tri_uva)
    xb = epipolar.normalize_by_K(Kd, tri_uvb)
    n_tri = tri_Ra.shape[0]
    Rb = R_f.expand(n_tri, 3, 3)
    tb = t_f.expand(n_tri, 3)
    X, za, zb = triangulate.triangulate_dlt(tri_Ra, tri_ta, xa, Rb, tb, xb)
    err_a = triangulate.reprojection_error(tri_Ra, tri_ta, X, xa)
    err_b = triangulate.reprojection_error(Rb, tb, X, xb)
    ok_tri = (tri_valid & (za > 1e-6) & (zb > 1e-6) & (err_a < 0.01)
              & (err_b < 0.01))

    return torch.cat([
        R_f.reshape(9).to(f32), t_f.to(f32),
        R_ji.reshape(9).to(f32), t_ji.to(f32),
        torch.stack([
            s_map.to(f32),
            rp.ok.to(f32),
            rp.num_inliers.to(f32),
            info["inliers"].to(f32),
        ]),
        X.reshape(-1).to(f32),
        ok_tri.to(f32),
    ])


def _ba_packed(prob: ba_ops.BAProblem, iters: int, lambda0, huber_delta,
               n_fix: int, update_points: bool):
    """Window BA, packed into one f32 vector [R, t, X, cost0, cost]."""
    R, t, X, info = ba_ops.bundle_adjust(
        prob, iters=iters, lambda0=lambda0, huber_delta=huber_delta,
        n_fix=n_fix, update_points=update_points)
    return torch.cat([
        R.reshape(-1).to(f32), t.reshape(-1).to(f32), X.reshape(-1).to(f32),
        torch.stack([info["cost0"].to(f32), info["cost"].to(f32)]),
    ])


def _triangulate_stage(K, R_a, t_a, uv_a, R_b, t_b, uv_b, valid):
    """Batched first-vs-last triangulation with cheirality + reprojection
    gating (ref py:922-949 / cpp:1801-1813)."""
    Kd = K.to(uv_a.dtype)
    xa = epipolar.normalize_by_K(Kd, uv_a)
    xb = epipolar.normalize_by_K(Kd, uv_b)
    X, za, zb = triangulate.triangulate_dlt(R_a, t_a, xa, R_b, t_b, xb)
    err_a = triangulate.reprojection_error(R_a, t_a, X, xa)
    err_b = triangulate.reprojection_error(R_b, t_b, X, xb)
    ok = valid & (za > 1e-6) & (zb > 1e-6) & (err_a < 0.01) & (err_b < 0.01)
    return X, ok


class SfMSystem:
    """The host-driven pipeline (the CLI's default). ref: ClassicSystem
    py:858-1063.

    ``device`` defaults to ``"cuda"``; without a card the constructor
    raises (pass ``device="cpu"`` to run the plain versions)."""

    def __init__(self, K: np.ndarray, cfg: SystemConfig, gt_records=None,
                 device="cuda"):
        self.device = resolve(device)
        self.K = np.asarray(K, np.float64)
        self.cfg = cfg
        self.gt = gt_records  # list[MiddleburyRecord] for --use-gt-scale
        self.kfs: list[Keyframe] = []
        self.edges: list[Edge] = []
        self.map = MapState()
        self.pose_R = np.eye(3)  # camera-to-world of current frame
        self.pose_t = np.zeros(3)
        self.state: tracker.TrackerState | None = None
        self.prev_pyr = None
        self.prev_frame_idx = -1
        self.last_kf_frame = -10**9
        self.first_obs: dict[int, tuple[int, np.ndarray]] = {}
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(cfg.ransac.seed)
        # tests hand in another source of (H,N) priorities here
        # (callable (H, N) -> array); None draws from self._gen
        self._pri_source = None
        self._Kt = to_device(self.K.astype(np.float32), self.device)
        self.metrics: list[dict] = []
        self.timers = StageTimers(self.device)
        self.loop_verifications = 0  # loop verifications that reached LK
        self.global_ba_shape = None  # (F, P, M) of the last global BA

    # ------------------------------------------------------------------
    def _next_key(self, H: int, N: int):
        """The (H,N) f32 sampling priorities of the next RANSAC call, where
        the JAX twin splits its key and draws ``uniform(sub, (H,N))``."""
        if self._pri_source is not None:
            return to_device(np.asarray(self._pri_source(H, N), np.float32),
                             self.device)
        return epipolar.sample_priorities(self._gen, H, N, self.device)

    def _put(self, a, dtype=f32):
        return to_device(np.asarray(a), self.device, dtype)

    def process(self, frame_idx: int, img_name: str,
                gray_u8: np.ndarray) -> dict:
        """Feed one frame (ref py:1022-1059). Returns per-frame metrics."""
        t0 = time.perf_counter()
        cfg = self.cfg
        dev = self.device
        with torch.no_grad():
            with self.timers.stage("pyramid"):
                pyr = build_pyramid_u8(
                    torch.from_numpy(np.array(gray_u8)).to(dev),
                    cfg.klt.pyr_levels)
            met = {"frame": frame_idx, "image": img_name}

            if self.state is None:
                self.state = tracker.bootstrap(pyr[0], cfg.klt, device=dev)
                self.prev_pyr = pyr
                self.prev_frame_idx = frame_idx
                self._add_keyframe(frame_idx, img_name, pyr)
                met.update(keyframe=True, tracks=int(self.cfg.klt.max_tracks))
                met["dt"] = time.perf_counter() - t0
                self.metrics.append(met)
                return met

            with self.timers.stage("klt"):
                self.state, prev_pos, matched = tracker.step(
                    self.prev_pyr, pyr, self.state, cfg.klt, device=dev)
            with self.timers.stage("two_view"):
                H, N = cfg.ransac.num_hypotheses, matched.shape[0]
                tv = TwoView(_two_view_stage(
                    self._next_key(H, N), self._Kt,
                    prev_pos.to(f32), self.state.pos.to(f32), matched,
                    num_hypotheses=H,
                    sampson_thresh=cfg.ransac.sampson_thresh,
                    min_inliers=cfg.ransac.min_inliers,
                ))  # single pull (the stage's real cost)
            ok = tv.ok
            inliers = tv.num_inliers
            parallax = tv.parallax

            force_kf = False
            if ok:
                scale = self._edge_scale(self.prev_frame_idx, frame_idx)
                # T_cw' = T_cw ∘ T_ji^{-1} (ref py:117-127), host 3x3 math
                R_ij = tv.R.T
                t_ij = -tv.R.T @ (tv.t * scale)
                self.pose_t = self.pose_R @ t_ij + self.pose_t
                self.pose_R = self.pose_R @ R_ij
            else:
                # geometry failure forces a keyframe (ref py:1031-1033 /
                # cpp:1740-1743)
                force_kf = True

            gap = frame_idx - self.last_kf_frame
            make_kf = force_kf or (
                gap >= cfg.keyframe.min_gap
                and (
                    parallax >= cfg.keyframe.parallax_px
                    or inliers < cfg.keyframe.min_inliers
                )
            )
            if make_kf:
                self._add_keyframe(frame_idx, img_name, pyr)

        self.prev_pyr = pyr
        self.prev_frame_idx = frame_idx
        met.update(
            keyframe=make_kf,
            inliers=inliers,
            parallax=parallax,
            tracks=tv.n_alive,
            map_points=self.map.num_points,
            edges=len(self.edges),
        )
        met["dt"] = time.perf_counter() - t0
        self.metrics.append(met)
        log.info(
            "frame %d | kf=%s | inliers=%d | parallax=%.2f | tracks=%d | "
            "map_points=%d | edges=%d",
            frame_idx, make_kf, inliers, parallax, met["tracks"],
            met["map_points"], met["edges"],
        )
        return met

    # ------------------------------------------------------------------
    def _edge_scale(self, i_frame: int, j_frame: int) -> float:
        """GT baseline scaling (ref py:888-898) or unit norm."""
        if self.cfg.use_gt_scale and self.gt is not None:
            Ci = self.gt[i_frame].center
            Cj = self.gt[j_frame].center
            s = float(np.linalg.norm(Cj - Ci))
            if s > 1e-12:
                return s
        return 1.0

    def _add_keyframe(self, frame_idx: int, img_name: str, pyr) -> None:
        """ref py:951-988 add_keyframe / cpp:1765-1871 keyframe block."""
        kf_id = len(self.kfs)
        T = self.cfg.klt.max_tracks
        with self.timers.stage("kf_snapshot"):
            packed = _snapshot_stage(self.state, pyr[0]).cpu().numpy(
            ).astype(np.float64)
        snap = packed[: T * 4].reshape(T, 4)
        desc = packed[T * 4:]
        uv = snap[:, :2]
        ids = snap[:, 2].astype(np.int64)
        valid = snap[:, 3] > 0.5

        tri_meta: list[tuple[int, int]] = []  # (tid, slot) of triangulations
        tri_results = None
        if kf_id > 0:
            prev = self.kfs[-1]
            with self.timers.stage("kf_geometry"):
                tri_meta, tri_results = self._run_keyframe_stage(
                    prev, ids, uv, valid, frame_idx)

        kf = Keyframe(
            kf_id=kf_id,
            frame_idx=frame_idx,
            img_name=img_name,
            R_cw=self.pose_R.copy(),
            t_cw=self.pose_t.copy(),
            ids=ids,
            uv=uv,
            valid=valid,
            desc=desc,
            pyr=pyr,
        )
        if self.cfg.loop.enabled and self.cfg.loop.method == "orb":
            with self.timers.stage("orb"):
                kf.orb = orb_ops.detect_and_describe(
                    pyr[0], max_kp=self.cfg.loop.max_keypoints,
                    device=self.device)
        self.kfs.append(kf)
        self.last_kf_frame = frame_idx
        with self.timers.stage("map_update"):
            self._update_map(kf, tri_meta, tri_results)

        # loop closure (ref cpp:1822-1866): descriptor search + verify
        found_loop = False
        if (
            self.cfg.loop.enabled
            and kf_id > 0
            and kf_id % max(self.cfg.loop_every_kf, 1) == 0
        ):
            with self.timers.stage("loop_closure"):
                found_loop = self._try_loop_closure(kf)

        # pose graph (cpp:1862 semantics: only once loop edges exist —
        # without loops the graph is chain-shaped and a solve would only
        # drag BA-refined poses back toward the raw two-view edges)
        have_loops = any(e.is_loop for e in self.edges)
        if kf_id >= 2 and have_loops and (
            found_loop or kf_id % max(self.cfg.posegraph_every_kf, 1) == 0
        ):
            with self.timers.stage("pose_graph"):
                self._run_pose_graph()

        if self.cfg.ba.iters > 0 and kf_id > 0:
            with self.timers.stage("local_ba"):
                self._run_local_ba()

    def _run_keyframe_stage(self, prev: Keyframe, ids, uv, valid,
                            frame_idx: int):
        """Host wrapper around the fused keyframe device stage: prepares
        the PnP / triangulation tables, runs ONE device program, and books
        the resulting pose + odometry edge. Returns the triangulation
        metadata + results for ``_update_map``."""
        shared = prev.valid & valid & (prev.ids == ids)
        R_wc_i, t_wc_i = prev.pose_wc

        # chain relative pose (fallback when the edge RANSAC fails)
        Rwj = self.pose_R.T
        R_chain = Rwj @ prev.R_cw
        t_chain = Rwj @ (prev.t_cw - self.pose_t)

        # PnP / scale tables from mapped tracks visible in this frame
        pids = self.map.pids_for(ids)
        selm = valid & (pids >= 0)
        sel_idx = np.nonzero(selm)[0][:PNP_CAP]
        n_map = len(sel_idx)
        pnp_X = np.zeros((PNP_CAP, 3))
        pnp_uv = np.zeros((PNP_CAP, 2))
        pnp_valid = np.zeros(PNP_CAP, bool)
        if n_map:
            pnp_X[:n_map] = self.map.xyz()[pids[sel_idx]]
            pnp_uv[:n_map] = uv[sel_idx]
            pnp_valid[:n_map] = True

        # triangulation tables: tracks without a map point whose first
        # observation is in an earlier keyframe (ref py:935-949 first-vs-
        # last); leftovers beyond TRI_CAP stay pending
        rest = np.nonzero(valid & (pids < 0))[0]
        tri_meta: list[tuple[int, int]] = []
        tri_Ra = np.zeros((TRI_CAP, 3, 3))
        tri_ta = np.zeros((TRI_CAP, 3))
        tri_uva = np.zeros((TRI_CAP, 2))
        tri_uvb = np.zeros((TRI_CAP, 2))
        tri_valid = np.zeros(TRI_CAP, bool)
        for slot in rest:
            tid = int(ids[slot])
            fo = self.first_obs.get(tid)
            if fo is None or len(tri_meta) >= TRI_CAP:
                continue
            k = len(tri_meta)
            fkf_id, fuv = fo
            Rwi_f, twi_f = self.kfs[fkf_id].pose_wc
            tri_Ra[k] = Rwi_f
            tri_ta[k] = twi_f
            tri_uva[k] = fuv
            tri_uvb[k] = uv[slot]
            tri_valid[k] = True
            tri_meta.append((tid, slot))

        fixed_scale = (
            self._edge_scale(prev.frame_idx, frame_idx)
            if self.cfg.use_gt_scale
            else -1.0
        )
        fx = float(self.K[0, 0])
        put, H = self._put, self.cfg.ransac.num_hypotheses
        pack = _keyframe_fused_stage(
            self._next_key(H, len(uv)), self._Kt,
            put(prev.uv), put(shared, torch.bool),
            put(uv),
            put(R_chain), put(t_chain),
            put(R_wc_i), put(t_wc_i),
            put(pnp_X), put(pnp_uv), put(pnp_valid, torch.bool),
            put(tri_Ra), put(tri_ta), put(tri_uva), put(tri_uvb),
            put(tri_valid, torch.bool),
            put(np.float32(fixed_scale)),
            num_hypotheses=H,
            sampson_thresh=self.cfg.ransac.sampson_thresh,
            min_inliers=self.cfg.ransac.min_inliers,
            pnp_iters=10,
            pnp_huber=self.cfg.ba.huber_delta / fx,
        ).cpu().numpy().astype(np.float64)
        # ONE pull for edge + scale + PnP + pose + triangulation
        R_f = pack[:9].reshape(3, 3)
        t_f = pack[9:12]
        R_ji = pack[12:21].reshape(3, 3)
        t_ji = pack[21:24]
        edge_inliers = int(pack[26])
        o = 28
        tri_X = pack[o: o + TRI_CAP * 3].reshape(TRI_CAP, 3)
        tri_ok = pack[o + TRI_CAP * 3: o + TRI_CAP * 4] > 0.5

        # new pose (world→cam back to cam→world)
        self.pose_R = R_f.T
        self.pose_t = -R_f.T @ t_f

        # odometry edge (normalized per translation mode, ref py:979-981)
        scale = self._edge_scale(prev.frame_idx, frame_idx)
        if self.cfg.translation_mode != TranslationMode.FULL:
            n = np.linalg.norm(t_ji)
            if n > 1e-12:
                t_ji = t_ji / n * scale
        self.edges.append(
            Edge(i=prev.kf_id, j=len(self.kfs), R_ji=R_ji, t_ji=t_ji,
                 inliers=edge_inliers, is_loop=False)
        )
        return tri_meta, (tri_X, tri_ok)

    def _loop_edge_weight(self, i: int, j: int) -> float:
        """Loop-edge weight, scaled by the estimated loop baseline
        relative to the typical odometry baseline: an E-matrix loop edge
        degrades as the baseline vanishes (E = [t]x R), so a near-exact
        revisit's edge self-silences (the reference's center-only solve
        does this by scaling with the edge length, cpp:1156-1157)."""
        lw = self.cfg.pose_graph.loop_weight
        cs = [kf.t_cw for kf in self.kfs]
        if len(cs) < 2:
            return lw
        odo = np.linalg.norm(np.diff(np.stack(cs), axis=0), axis=1)
        b_ref = float(np.median(odo))
        b = float(np.linalg.norm(cs[j] - cs[i])) if j < len(cs) else b_ref
        return lw * min(1.0, b / max(b_ref, 1e-12))

    @staticmethod
    def _relative_from_poses(kf_i: Keyframe, kf_j: Keyframe):
        """R_ji, t_ji from camera-to-world poses: x_j = R_ji x_i + t_ji."""
        R_ji = kf_j.R_cw.T @ kf_i.R_cw
        Rwj, twj = kf_j.pose_wc
        # cam_i origin (= its world center, kf_i.t_cw) expressed in cam_j
        t_ji = Rwj @ kf_i.t_cw + twj
        return R_ji, t_ji

    def _update_map(self, kf: Keyframe, tri_meta, tri_results) -> None:
        """Record observations; register triangulations computed by the
        fused keyframe stage (ref py:935-975 first-vs-last semantics)."""
        pids = self.map.pids_for(kf.ids)
        mapped = np.nonzero(kf.valid & (pids >= 0))[0]
        self.map.add_obs_batch(kf.kf_id, pids[mapped], kf.uv[mapped])

        if tri_results is not None:
            tri_X, tri_ok = tri_results
            new_tid, new_slot, new_pid, new_fkf = [], [], [], []
            for k, (tid, slot) in enumerate(tri_meta):
                if not tri_ok[k]:
                    continue
                pid = self.map.add_point(tid, tri_X[k])
                fkf_id, fuv = self.first_obs[tid]
                self.map.add_obs(fkf_id, pid, fuv)
                new_tid.append(tid)
                new_slot.append(slot)
                new_pid.append(pid)
                new_fkf.append(fkf_id)
            if new_pid:
                # backfill observations at every keyframe between first
                # sighting and (deferred) triangulation (ref py:935-975).
                # Tracks keep their slot while alive, so an id match at
                # the same slot identifies the observation.
                tids = np.asarray(new_tid)
                slots = np.asarray(new_slot)
                pids = np.asarray(new_pid)
                fkfs = np.asarray(new_fkf)
                for mid in self.kfs[int(fkfs.min()) + 1: kf.kf_id]:
                    m = (
                        (fkfs < mid.kf_id)
                        & mid.valid[slots]
                        & (mid.ids[slots] == tids)
                    )
                    if m.any():
                        self.map.add_obs_batch(
                            mid.kf_id, pids[m], mid.uv[slots[m]]
                        )
                self.map.add_obs_batch(kf.kf_id, pids, kf.uv[slots])

        # register first observations for brand-new tracks
        pids = self.map.pids_for(kf.ids)
        fresh = np.nonzero(kf.valid & (pids < 0))[0]
        for slot in fresh:
            tid = int(kf.ids[slot])
            if tid not in self.first_obs:
                self.first_obs[tid] = (kf.kf_id, kf.uv[slot].copy())

    # ------------------------------------------------------------------
    def _try_loop_closure(self, kf: Keyframe) -> bool:
        """Dispatch between the two reference loop-closure flavors:
        'descriptor' (cpp:1822-1866) and 'orb' (py:532-595)."""
        if self.cfg.loop.method == "orb":
            return self._try_loop_closure_orb(kf)
        return self._try_loop_closure_descriptor(kf)

    def _try_loop_closure_orb(self, kf: Keyframe) -> bool:
        """ORB-flavor: oriented-binary-feature ratio matching against
        candidates >= min_kf_gap older, top-k by match count, per-candidate
        E-RANSAC gate (ref py:557-595)."""
        lcfg = self.cfg.loop
        if kf.orb is None:
            return False
        xy_j, d_j, v_j = kf.orb
        cands = [
            k for k in self.kfs[: max(kf.kf_id - lcfg.min_kf_gap + 1, 0)]
            if k.orb is not None
        ]
        scored = []
        for old in cands:
            _, d_i, v_i = old.orb
            idx, ok, _ = orb_ops.match_hamming(d_i, v_i, d_j, v_j)
            n = int(ok.sum())
            if n >= lcfg.min_matches:
                scored.append((n, old, idx, ok))
        scored.sort(key=lambda s: -s[0])
        for n, old, idx, ok in scored[: lcfg.top_k]:
            pi = old.orb[0]
            pj = xy_j[idx]
            rp = TwoView(_two_view_stage(
                self._next_key(lcfg.ransac_iters, pi.shape[0]),
                self._Kt, pi.to(f32), pj.to(f32), ok,
                num_hypotheses=lcfg.ransac_iters,
                sampson_thresh=lcfg.ransac_thresh,
                min_inliers=lcfg.min_inliers,
            ))
            if rp.ok and rp.num_inliers >= lcfg.min_inliers:
                self._append_loop_edge(old, kf, rp)
                return True
        return False

    def _try_loop_closure_descriptor(self, kf: Keyframe) -> bool:
        """Descriptor search + PnP verify, or LK re-track + E-RANSAC gate
        (ref cpp:1822-1866). Returns True if a loop edge was added."""
        lcfg = self.cfg.loop
        cands = [
            k for k in self.kfs[: max(kf.kf_id - lcfg.min_kf_gap + 1, 0)]
            if k.desc is not None
        ]
        if not cands:
            return False
        bank = np.stack([k.desc for k in cands])
        scores = bank @ kf.desc
        best = int(np.argmax(scores))
        if float(scores[best]) <= lcfg.score_thresh:
            return False
        old = cands[best]
        if old.pyr is None:
            return False
        # primary verification: PnP against the old keyframe's mapped
        # tracks — metric and reliable at any baseline (E-matrix
        # verification degenerates at a near-exact revisit). A definitive
        # PnP rejection is final.
        pnp_verdict = self._try_loop_pnp(old, kf)
        if pnp_verdict is not None:
            return pnp_verdict
        # fallback (old keyframe has too few mapped tracks): re-detect on
        # the old keyframe and LK-track into the new one
        # (ref cpp:1836-1854: shi_tomasi 1200 pts + fwd/bwd LK)
        dev = self.device
        xy, _, dvalid = features.detect_corners(
            old.pyr[0], torch.zeros((1, 2), device=dev),
            torch.zeros((1,), dtype=torch.bool, device=dev),
            max_new=1024, cell=max(int(self.cfg.klt.min_distance), 2),
            quality=self.cfg.klt.quality, device=dev)
        new_pts, ok = klt.lk_track_fb(
            old.pyr, kf.pyr, xy, dvalid,
            levels=self.cfg.klt.pyr_levels, iters=self.cfg.klt.iters,
            radius=self.cfg.klt.win_radius, fb_thresh=self.cfg.klt.fb_thresh,
            device=dev)
        self.loop_verifications += 1
        if int(ok.sum()) < lcfg.min_tracked:  # one pull
            return False
        rp = TwoView(_two_view_stage(
            self._next_key(lcfg.ransac_iters, xy.shape[0]),
            self._Kt, xy.to(f32), new_pts.to(f32), ok,
            num_hypotheses=lcfg.ransac_iters,
            sampson_thresh=lcfg.ransac_thresh,
            min_inliers=lcfg.min_inliers,
        ))
        if not rp.ok or rp.num_inliers < lcfg.min_inliers:
            return False
        self._append_loop_edge(old, kf, rp)
        return True

    def _try_loop_pnp(self, old: Keyframe, kf: Keyframe) -> bool | None:
        """PnP loop verification against the old keyframe's mapped
        tracks; appends a metric loop edge on success. Returns None when
        not applicable (old keyframe has too few mapped tracks — caller
        falls back to the reference-style E-RANSAC verify), else the
        definitive verdict."""
        lcfg = self.cfg.loop
        pids = self.map.pids_for(old.ids)
        m_old = old.valid & (pids >= 0)
        if int(m_old.sum()) < 30:
            return None
        X_slot = np.zeros((len(pids), 3), np.float32)
        X_slot[m_old] = self.map.xyz()[pids[m_old]]
        R_wc0, t_wc0 = old.pose_wc
        fx = float(self.K[0, 0])
        kc = self.cfg.klt
        put = self._put
        pack = _loop_pnp_stage(
            self._Kt, old.pyr[0], kf.pyr[0], put(old.uv), put(X_slot),
            put(m_old, torch.bool), put(R_wc0), put(t_wc0),
            levels=kc.pyr_levels, lk_iters=kc.iters, radius=kc.win_radius,
            fb_thresh=kc.fb_thresh, huber_delta=self.cfg.ba.huber_delta / fx,
        ).cpu().numpy().astype(np.float64)  # one pull
        self.loop_verifications += 1
        R_wc_j = pack[:9].reshape(3, 3)
        t_wc_j = pack[9:12]
        inliers = int(pack[12])
        n_tracked = int(pack[13])
        if n_tracked < min(lcfg.min_tracked, 30) \
                or inliers < lcfg.min_inliers:
            return False
        R_ji = R_wc_j @ old.R_cw
        t_ji = R_wc_j @ old.t_cw + t_wc_j
        lw = self.cfg.pose_graph.loop_weight
        w_tr = lw
        if self.cfg.translation_mode != TranslationMode.FULL:
            # a zero-length metric translation has no direction for the
            # dir-mode residual to constrain
            cs = np.stack([k.t_cw for k in self.kfs])
            odo = np.linalg.norm(np.diff(cs, axis=0), axis=1)
            b_ref = float(np.median(odo)) if len(odo) else 1.0
            w_tr = lw * min(
                1.0, float(np.linalg.norm(t_ji)) / max(b_ref, 1e-12))
        self.edges.append(
            Edge(i=old.kf_id, j=kf.kf_id, R_ji=R_ji, t_ji=t_ji,
                 inliers=inliers, is_loop=True, w_rot=lw, w_trans=w_tr)
        )
        log.info("loop closure %d -> %d (pnp inliers %d)",
                 old.kf_id, kf.kf_id, inliers)
        if self.metrics:
            self.metrics[-1]["loop"] = (old.kf_id, kf.kf_id)
        return True

    def _append_loop_edge(self, old: Keyframe, kf: Keyframe,
                          rp: TwoView) -> None:
        t_ji = rp.t.copy()
        if self.cfg.translation_mode != TranslationMode.FULL:
            n = np.linalg.norm(t_ji)
            if n > 1e-12:
                t_ji = t_ji / n * self._edge_scale(old.frame_idx,
                                                   kf.frame_idx)
        w_loop = self._loop_edge_weight(old.kf_id, kf.kf_id)
        self.edges.append(
            Edge(i=old.kf_id, j=kf.kf_id, R_ji=rp.R.copy(),
                 t_ji=t_ji, inliers=rp.num_inliers, is_loop=True,
                 w_rot=w_loop, w_trans=w_loop)
        )
        log.info("loop closure %d -> %d (inliers %d)",
                 old.kf_id, kf.kf_id, rp.num_inliers)
        if self.metrics:
            self.metrics[-1]["loop"] = (old.kf_id, kf.kf_id)

    # ------------------------------------------------------------------
    def _run_pose_graph(self) -> None:
        """Optimize all keyframe poses over the edge graph and write back
        (ref py:990-1001 / cpp:1862). Mode from config: 'se3' = python
        reference semantics, 'sim3', 'centers' = cpp reference semantics.
        Solved in float64 on the device."""
        pcfg = self.cfg.pose_graph
        N = len(self.kfs)
        E = len(self.edges)
        if N < 3 or E < 2:
            return
        Np = _next_pow2(N, lo=8)
        Ep = _next_pow2(E, lo=8)
        R_cw = np.stack([kf.R_cw for kf in self.kfs] + [np.eye(3)] * (Np - N))
        C = np.stack([kf.t_cw for kf in self.kfs] + [np.zeros(3)] * (Np - N))
        e_i = np.zeros(Ep, np.int64)
        e_j = np.zeros(Ep, np.int64)
        R_meas = np.tile(np.eye(3), (Ep, 1, 1))
        t_meas = np.zeros((Ep, 3))
        t_meas[:, 2] = 1.0
        w_rot = np.zeros(Ep)
        w_trans = np.zeros(Ep)
        valid = np.zeros(Ep, bool)
        t_full = np.zeros(Ep, bool)
        for k, e in enumerate(self.edges):
            e_i[k] = e.i
            e_j[k] = e.j
            if not e.is_loop and e.j == e.i + 1:
                # refresh odometry constraints from the current (BA-
                # refined) poses, metric and with the full translation
                # residual even in dir mode (see the JAX twin): the solve
                # then distributes loop-closure error along the chain
                R_m, t_m = self._relative_from_poses(
                    self.kfs[e.i], self.kfs[e.j])
                R_meas[k], t_meas[k] = R_m, t_m
                t_full[k] = True
            else:
                R_meas[k] = e.R_ji
                t_meas[k] = e.t_ji
            w_rot[k] = pcfg.w_rot * e.w_rot
            w_trans[k] = pcfg.w_trans * e.w_trans
            valid[k] = True
        put = lambda a: to_device(a, self.device)  # noqa: E731
        prob = pg_ops.PoseGraphProblem(
            R_cw=put(R_cw), C=put(C), e_i=put(e_i), e_j=put(e_j),
            R_meas=put(R_meas), t_meas=put(t_meas), w_rot=put(w_rot),
            w_trans=put(w_trans), valid=put(valid), t_full=put(t_full))
        if pcfg.mode == "centers":
            R_new, C_new, _ = pg_ops.optimize_centers(prob)
        elif pcfg.mode == "sim3":
            s_meas = np.ones(Ep)
            for k, e in enumerate(self.edges):
                s_meas[k] = e.s_rel
            R_new, C_new, _s, _ = pg_ops.optimize_sim3(
                prob, s_meas=put(s_meas),
                mode=self.cfg.translation_mode.value,
                iters=pcfg.iters, lambda0=pcfg.lambda0)
        else:
            R_new, C_new, _ = pg_ops.optimize_se3(
                prob, mode=self.cfg.translation_mode.value,
                iters=pcfg.iters, lambda0=pcfg.lambda0)
        R_new = R_new.cpu().numpy().astype(np.float64)
        C_new = C_new.cpu().numpy().astype(np.float64)
        for k, kf in enumerate(self.kfs):
            kf.R_cw = R_new[k]
            kf.t_cw = C_new[k]
        # reset the running pose to the refreshed last keyframe
        # (ref py:993-1001)
        self.pose_R = self.kfs[-1].R_cw.copy()
        self.pose_t = self.kfs[-1].t_cw.copy()

    # ------------------------------------------------------------------
    def _ba_problem(self, R_wc, t_wc, X, cam_idx, pidx, obs_n, ovalid,
                    pvalid) -> ba_ops.BAProblem:
        """A BA problem from float64 / int host tables (float64 on the
        device, as the JAX twin builds it under x64)."""
        put = lambda a, dt=f64: to_device(a, self.device, dt)  # noqa: E731
        return ba_ops.BAProblem(
            R_wc=put(R_wc), t_wc=put(t_wc), X=put(X),
            cam_idx=put(cam_idx, torch.int64),
            pid_idx=put(pidx, torch.int64), obs=put(obs_n),
            obs_valid=put(ovalid, torch.bool),
            point_valid=put(pvalid, torch.bool))

    def _run_local_ba(self) -> None:
        """Sliding-window Schur-complement LM BA (ref py:1003-1020 /
        cpp:1820). Selects window points, solves on device, writes back
        poses + points, and re-anchors the running pose."""
        cfg = self.cfg.ba
        F = min(cfg.window, len(self.kfs))
        if F < 2:
            return
        win = self.kfs[-F:]
        win_ids = {kf.kf_id: k for k, kf in enumerate(win)}

        obs_kf, obs_pid, obs_uv = self.map.obs_arrays()
        if len(obs_kf) == 0:
            return
        in_win = np.isin(obs_kf, list(win_ids))
        pids_w, counts = np.unique(obs_pid[in_win], return_counts=True)
        pids_w = pids_w[counts >= 2]
        counts = counts[counts >= 2]
        if len(pids_w) == 0:
            return
        # cap to max_points, keeping the best-observed (ref py:733-739
        # caps at max_points; cpp:881 caps at 600)
        if len(pids_w) > cfg.max_points:
            keep = np.argsort(-counts)[: cfg.max_points]
            pids_w = pids_w[keep]
            counts = counts[keep]
        P = int(cfg.max_points)
        pid_local = -np.ones(self.map.num_points, np.int64)
        pid_local[pids_w] = np.arange(len(pids_w))

        sel = in_win & (pid_local[obs_pid] >= 0)
        m = int(sel.sum())
        if m < 12:
            return
        sel_idx = np.nonzero(sel)[0]
        if m > BA_OBS_CAP:
            # keep observations of the best-observed points first
            cnt_of_local = np.zeros(len(pids_w) + 1, np.int64)
            cnt_of_local[: len(pids_w)] = counts
            order = np.argsort(
                -cnt_of_local[pid_local[obs_pid[sel_idx]]], kind="stable"
            )
            sel_idx = sel_idx[order[:BA_OBS_CAP]]
            m = BA_OBS_CAP
        M = BA_OBS_CAP
        cam_idx = np.zeros(M, np.int32)
        pidx = np.zeros(M, np.int32)
        obs_n = np.zeros((M, 2))
        ovalid = np.zeros(M, bool)
        kf_map = np.zeros(max(k.kf_id for k in win) + 1, np.int32)
        for kfid, k in win_ids.items():
            kf_map[kfid] = k
        cam_idx[:m] = kf_map[obs_kf[sel_idx]]
        pidx[:m] = pid_local[obs_pid[sel_idx]]
        obs_n[:m] = np_geom.normalize_by_K(self.K, obs_uv[sel_idx])
        ovalid[:m] = True

        X = np.zeros((P, 3))
        pvalid = np.zeros(P, bool)
        X[: len(pids_w)] = self.map.xyz()[pids_w]
        pvalid[: len(pids_w)] = True

        # pad the pose axis to the configured window (padded poses have no
        # observations; they get a unit prior in the Schur solve and their
        # updates are discarded)
        Fp = cfg.window
        R_wc = np.stack(
            [kf.pose_wc[0] for kf in win] + [np.eye(3)] * (Fp - F)
        )
        t_wc = np.stack(
            [kf.pose_wc[1] for kf in win] + [np.zeros(3)] * (Fp - F)
        )
        prob = self._ba_problem(R_wc, t_wc, X, cam_idx, pidx, obs_n, ovalid,
                                pvalid)
        fx = float(self.K[0, 0])
        pack = _ba_packed(
            prob,
            iters=cfg.iters,
            lambda0=cfg.lambda0,
            huber_delta=cfg.huber_delta / fx,
            n_fix=1,
            update_points=cfg.update_points,
        ).cpu().numpy().astype(np.float64)  # one pull
        o1 = Fp * 9
        o2 = o1 + Fp * 3
        o3 = o2 + P * 3
        R_new = pack[:o1].reshape(Fp, 3, 3)
        t_new = pack[o1:o2].reshape(Fp, 3)
        for k, kf in enumerate(win):
            # world->cam back to cam->world
            kf.R_cw = R_new[k].T
            kf.t_cw = -R_new[k].T @ t_new[k]
        if cfg.update_points:
            X_new = pack[o2:o3].reshape(P, 3)
            xyz = self.map.xyz()
            xyz[pids_w] = X_new[: len(pids_w)]
            self.map.set_xyz(xyz)
        # re-anchor the running pose on the refined last keyframe
        # (ref py:1016-1020)
        self.pose_R = self.kfs[-1].R_cw.copy()
        self.pose_t = self.kfs[-1].t_cw.copy()
        if self.metrics:
            self.metrics[-1]["ba_cost0"] = float(pack[o3])
            self.metrics[-1]["ba_cost"] = float(pack[o3 + 1])

    # ------------------------------------------------------------------
    def finalize(self) -> None:
        """End-of-run global refinement: full-problem BA over all
        keyframes and map points (no reference counterpart)."""
        if self.cfg.ba.global_iters > 0 and len(self.kfs) >= 3:
            with torch.no_grad(), self.timers.stage("global_ba"):
                self._run_global_ba(self.cfg.ba.global_iters)

    def _run_global_ba(self, iters: int) -> None:
        obs_kf, obs_pid, obs_uv = self.map.obs_arrays()
        n_pts = self.map.num_points
        if n_pts < 10 or len(obs_kf) < 30:
            return
        nF = len(self.kfs)
        F, P, M = _gba_caps(nF, n_pts, len(obs_kf))
        n_pts = min(n_pts, P)
        keep = (obs_pid < n_pts)
        obs_kf, obs_pid, obs_uv = obs_kf[keep], obs_pid[keep], obs_uv[keep]
        m = min(len(obs_kf), M)
        cam_idx = np.zeros(M, np.int32)
        pidx = np.zeros(M, np.int32)
        obs_n = np.zeros((M, 2))
        ovalid = np.zeros(M, bool)
        cam_idx[:m] = obs_kf[:m]
        pidx[:m] = obs_pid[:m]
        obs_n[:m] = np_geom.normalize_by_K(self.K, obs_uv[:m])
        ovalid[:m] = True
        X = np.zeros((P, 3))
        pvalid = np.zeros(P, bool)
        X[:n_pts] = self.map.xyz()[:n_pts]
        pvalid[:n_pts] = True
        R_wc = np.stack(
            [kf.pose_wc[0] for kf in self.kfs] + [np.eye(3)] * (F - nF)
        )
        t_wc = np.stack(
            [kf.pose_wc[1] for kf in self.kfs] + [np.zeros(3)] * (F - nF)
        )
        prob = self._ba_problem(R_wc, t_wc, X, cam_idx, pidx, obs_n, ovalid,
                                pvalid)
        fx = float(self.K[0, 0])
        R_new, t_new, X_new, info = ba_ops.bundle_adjust(
            prob, iters=iters, lambda0=self.cfg.ba.lambda0,
            huber_delta=self.cfg.ba.huber_delta / fx, n_fix=1,
            update_points=True,
        )
        self.global_ba_shape = (F, P, M)
        R_new = R_new.cpu().numpy().astype(np.float64)
        t_new = t_new.cpu().numpy().astype(np.float64)
        for k, kf in enumerate(self.kfs):
            kf.R_cw = R_new[k].T
            kf.t_cw = -R_new[k].T @ t_new[k]
        xyz_new = X_new.cpu().numpy().astype(np.float64)[:n_pts]
        xyz = self.map.xyz()
        xyz[:n_pts] = xyz_new
        self.map.set_xyz(xyz)
        self.pose_R = self.kfs[-1].R_cw.copy()
        self.pose_t = self.kfs[-1].t_cw.copy()
        log.info("global BA: cost %.3e -> %.3e (%d kfs, %d pts, %d obs)",
                 float(info["cost0"]), float(info["cost"]), nF, n_pts, m)

    # ------------------------------------------------------------------
    # artifact export (ref py:1546-1588 / cpp:1873-1906)
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
        artifacts.write_csv_centers(out / "keyframes_camera_centers.csv", rows)
        edge_rows = []
        for e in self.edges:
            rvec = np_geom.so3_log(np.asarray(e.R_ji, np.float64))
            edge_rows.append(dict(
                i=e.i, j=e.j, kind="loop" if e.is_loop else "odom",
                rvec=rvec, t=e.t_ji))
        artifacts.write_posegraph_edges(out / "posegraph_edges.csv",
                                        edge_rows)
        # the sparse point cloud is only written for pointcloud/both
        # (ref py:1546-1557 gates on export_geometry; cpp:1887 likewise)
        culled = 0
        if self.cfg.export_geometry in (
                ExportGeometry.POINTCLOUD, ExportGeometry.BOTH):
            X = self.map.xyz()
            m = self.map
            if self.kfs and len(X) and m.num_obs:
                # cull export noise, same robust-kernel cutoff as the
                # scan pipeline's export (np_geom.export_keep_mask)
                fx = float(self.K[0, 0])
                obs_kf, obs_pid, obs_uv = m.obs_arrays()
                keep = np_geom.export_keep_mask_obs(
                    self.K,
                    np.stack([kf.R_cw for kf in self.kfs]),
                    np.stack([kf.center for kf in self.kfs]),
                    obs_kf, obs_pid, obs_uv, np.asarray(X, np.float64),
                    thresh_norm=ba_ops._CUTOFF
                    * self.cfg.ba.huber_delta / fx)
                culled = int((~keep).sum())
                X = np.asarray(X)[keep]
            artifacts.write_ply_xyz(out / "templeRing_sparse_points.ply", X)
        return {
            "keyframes": len(self.kfs),
            "map_points": self.map.num_points,
            "culled": culled,
            "edges": len(self.edges),
            "out": str(out),
        }

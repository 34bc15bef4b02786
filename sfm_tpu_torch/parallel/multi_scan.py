"""Multi-scene reconstruction: S scenes in lockstep, full mapping per scene.

Counterpart of sfm_tpu/parallel/multi_scan.py (BASELINE config 5: N
TempleRing-style sequences at once).  Every scene gets the work of a
single-scene ``ScanSfM`` run: tracking, LO-RANSAC, keyframe policy,
triangulation, sliding-window BA, loop closure with the pose graph,
finalize and export.

Where the JAX twin ``jax.vmap``s the whole per-frame program over a scene
axis, this runner keeps S single-scene carries (``ScanCarry``, one per
scene view) and batches what the kernels serve:

  * the tracker: one fwd+bwd LK pass over the scenes' stacked pyramids, so
    ONE launch of K3 per level and direction for all scenes
    (``tracker.step_scenes``), one host pull of the survivor counts, and
    one K1 corner map over the scenes that replenish; the bootstrap maps
    all first frames with one K1 launch;
  * the host pulls: one keyframe-decision pull per frame, one metrics pull
    per chunk, one ring-pose pull per loop check, one drain pull and one
    refinement pull at the end, each for all scenes.

The rest of the per-frame prefix (pyramid, RANSAC, pose compose, keyframe
policy) runs scene by scene through the single-scene code
(``scan_pipeline._pose_from_track``).  The keyframe branch runs only for
the scenes that keyframe.  The JAX twin runs it for every scene under one
``lax.cond`` on any(make_kf) and masks the result back in; its branch takes
its keys from the prefix's split, not from the carry, so the two agree.
Here a branch for a scene that does not keyframe would advance that scene's
``torch.Generator``, so none runs.

Draws: scene s draws from its carry's generator, seeded with
``scene_seed(seed, s)``: scene 0 takes exactly the single-scene stream
(``cfg.ransac.seed``), so adding scenes does not perturb it.

Loop closure is verified on the host (``loop.device_verify`` is forced
off, as in the JAX twin).  A scene's view holds the scene's own carry, so
its pose-graph pushback (``ScanSfM._pose_graph_pushback``) writes where
the JAX twin's ``_apply_pushback`` and ``_writeback_scene_poses`` copy
into the batched carry; those two have no counterpart here.

``mesh=`` spreads the scenes over the ranks of a ``("scene", "hyp")``
mesh (``parallel/mesh.make_mesh``), one device each: rank r runs this
runner on the scenes of its ``scene`` coordinate, each scene with its
global index for its draws, and the results are gathered over the
``scene`` group (the JAX twin places its batched carry with
``NamedSharding(P("scene"))`` under one controller instead).
"""

from __future__ import annotations

import dataclasses
import logging
import time
from pathlib import Path

import numpy as np
import torch

from sfm_tpu_torch.config import KLTConfig, SystemConfig
from sfm_tpu_torch.models import scan_pipeline as sp, tracker
from sfm_tpu_torch.parallel.mesh import gather_scenes, local_scenes, \
    rank_device
from sfm_tpu_torch.utils import debug
from sfm_tpu_torch.utils.device import resolve, to_device

log = logging.getLogger("sfm_tpu_torch")


def scene_seed(seed: int, s: int) -> int:
    """The RANSAC seed of scene ``s``: ``seed`` itself for scene 0 (the
    single-scene stream), else ``(seed + s * 0x9E3779B97F4A7C15) mod
    2**63`` (the JAX twin folds ``s`` into its key instead; the port's
    bits differ from it in any case)."""
    return seed if s == 0 else (seed + s * 0x9E3779B97F4A7C15) % 2 ** 63


def _bootstrap_scenes(cfg: SystemConfig, kf_cap: int, p_cap: int, imgs0,
                      idx0: int, seeds) -> list[sp.ScanCarry]:
    """(S,H,W) first frames -> one carry per scene, with one K1 corner map
    for all of them."""
    pyrs = [sp._build_pyr(im, cfg.klt.pyr_levels) for im in imgs0]
    trks = tracker.bootstrap_scenes(torch.stack([p[0] for p in pyrs]),
                                    cfg.klt)
    return [sp._carry_from_track(cfg, kf_cap, p_cap, pyr, trk, idx0, sd)
            for pyr, trk, sd in zip(pyrs, trks, seeds)]


def _run_chunk_scenes(cfg: SystemConfig, p_ba: int, Kf, carries, imgs,
                      idxs, fvalid, pri_for=None):
    """One chunk for all scenes.  imgs (S,C,H,W) on the carries' device;
    idxs (C,) and fvalid (C,) on the host (padding frames are no-ops with
    an all-zero metrics row).  ``pri_for``: optional callable (scene,
    frame) -> (pri_frame, pri_edge) (H,T) priorities in place of the
    scenes' generators (tests).

    Per frame: the pyramids, ONE batched tracker step, each scene's
    two-view prefix, ONE pull of every scene's keyframe decision, and the
    keyframe branch of the scenes that keyframe.  The carries are updated
    in place.  Returns (carries, ys (S,C,NY) f32 on the device).

    This is also the JAX twin's ``_run_chunk_scenes_gated``: the gate
    there keeps the keyframe branch from running for every scene on every
    frame, which here it never does, so both names run this one
    schedule."""
    dev = carries[0].X.device
    S = len(carries)
    L = cfg.klt.pyr_levels
    ys = [[] for _ in range(S)]
    for k, (idx, fval) in enumerate(zip(idxs, fvalid)):
        idx = int(idx)
        if not bool(fval):
            for y in ys:
                y.append(torch.zeros((sp.NY,), dtype=sp.f32, device=dev))
            continue
        pyrs = [sp._build_pyr(imgs[s, k], L) for s in range(S)]
        stacked = [tuple(torch.stack([p[lv] for p in ps]) for lv in range(L))
                   for ps in ([c.prev_pyr for c in carries], pyrs)]
        steps = tracker.step_scenes(*stacked, [c.trk for c in carries],
                                    cfg.klt)
        pri = [{} for _ in range(S)]
        if pri_for is not None:
            pri = [dict(zip(("pri_frame", "pri_edge"),
                            (to_device(np.asarray(a, np.float32), dev)
                             for a in pri_for(s, idx)))) for s in range(S)]
        pre = []
        for s, (c, pyr, (trk, prev_pos, matched)) in enumerate(
                zip(carries, pyrs, steps)):
            c, make_kf, reuse, rp, y_pre = sp._pose_from_track(
                cfg, Kf, c, pyr, trk, prev_pos, matched, idx,
                pri=pri[s].get("pri_frame"))
            pre.append((make_kf, reuse, rp, y_pre))
        # the frame's one pull: every scene's (make_kf, reuse, kf_count)
        dec = torch.stack([torch.stack([mk.to(sp.i32), ru.to(sp.i32),
                                        c.kf_count])
                           for (mk, ru, _, _), c in zip(pre, carries)])
        for s, (mk, ru, kf_id) in enumerate(dec.tolist()):
            rp, y_pre = pre[s][2], pre[s][3]
            if mk:
                _, ykf = sp._keyframe_branch(
                    cfg, p_ba, Kf, carries[s], idx, kf_id,
                    rp_frame=rp if ru else None,
                    pri=pri[s].get("pri_edge"))
            else:
                ykf = sp.ykf_none(dev)
            ys[s].append(sp._pack_frame_metrics(carries[s], idx, y_pre, ykf))
    return carries, torch.stack([torch.stack(y) for y in ys])


# the JAX twin's name for its any-scene-gated chunk program
_run_chunk_scenes_gated = _run_chunk_scenes


def _scene_view(datasets, images, cfg, s, n, chunk, p_cap, p_ba, device):
    """A per-scene ``ScanSfM`` shell that lends scene ``s`` the
    single-scene host machinery (loop verification, pose graph, finalize,
    export).  Its ``.carry`` is the scene's carry."""
    v = sp.ScanSfM(datasets[s].K, cfg, n_frames=n, chunk=chunk,
                   p_cap=p_cap, p_ba=p_ba, device=device)
    v._names = [datasets[s].records[i].img for i in range(n)]
    v._images[0] = np.asarray(images[s][0])  # bootstrap keyframe
    return v


def _drain_stage_scenes(carries) -> np.ndarray:
    """ONE drain pull for all scenes, (S, L) float64
    (``scan_pipeline._drain_stage`` layout)."""
    return torch.stack([sp._drain_stage(c) for c in carries]).cpu().numpy()


def _ring_pose_stage_scenes(carries) -> np.ndarray:
    """ONE packed pull of all scenes' ring poses, (S, L) float64
    (``scan_pipeline._ring_pose_flat`` layout)."""
    return torch.stack([sp._ring_pose_flat(c) for c in carries]
                       ).cpu().numpy().astype(np.float64)


def _verify_scene_stage(Kf, img_old, img_new, carry, cand_kf: int,
                        cur_kf: int, levels: int, lk_iters: int, radius: int,
                        fb_thresh, huber_delta):
    """The LK + PnP loop verification of keyframe ``cand_kf`` against
    ``cur_kf`` of one scene (``scan_pipeline._pnp_loop_edge`` on the
    scene's carry, pyramids built from the two grays).  Returns the 16-f32
    pack [R_ji (9), t_ji (3), inliers, n_tracked, s_rel, n_mapped_old]."""
    kcfg = KLTConfig(pyr_levels=levels, iters=lk_iters, win_radius=radius,
                     fb_thresh=fb_thresh)
    return sp._pnp_loop_edge(
        kcfg, Kf, carry.ring, carry.X, sp._build_pyr(img_old, levels),
        sp._build_pyr(img_new, levels), cand_kf, cur_kf, huber_delta)


def _finalize_refine_scenes_stage(Kf, carries, n_pts, do0, later, enab,
                                  iters: int, rounds: int, lambda0,
                                  huber_delta) -> np.ndarray:
    """``_finalize_refine_core`` for each scene on its own ring and map,
    with that scene's gate flags, and ONE pull of all results: (S, P*3+2)
    float64 rows [X | cost0 | cost] (costs NaN where no polish ran)."""
    outs = [sp._finalize_refine_core(Kf, c.ring, c.X, n, f0, fl, fe, iters,
                                     rounds, lambda0, huber_delta)
            for c, n, f0, fl, fe in zip(carries, n_pts, do0, later, enab)]
    with debug.nan_ok():  # NaN: no polish ran
        rows = []
        for X, cost0, cost in outs:
            costs = torch.stack([torch.as_tensor(
                float("nan") if v is None else v, dtype=sp.f32,
                device=X.device) for v in (cost0, cost)])
            rows.append(torch.cat([X.reshape(-1), costs]))
        return torch.stack(rows).cpu().numpy().astype(np.float64)


def _refine_scenes(views, cfg: SystemConfig) -> None:
    """The refinement rounds of ``ScanSfM.finalize`` for every scene
    (finalize ran with ``refine=False``), with the gate flags the
    single-scene finalize computes, in one pull.  Updates each view's
    ``_X`` in place."""
    if not views or views[0].refine_rounds < 1:
        return
    rounds = views[0].refine_rounds
    do0, later, enab, touched = [], [], [], []
    for v in views:
        n_kf, n_pts = len(v.kfs), len(v._X)
        m = 0
        if n_kf:
            tval = np.stack([kf.valid for kf in v.kfs])
            m = int((tval & (v._ring_pid >= 0)
                     & (v._ring_pid < n_pts)).sum())
        do0.append(bool(v._pg_ran and n_pts >= 10))
        later.append(bool(n_pts >= 10))
        enab.append(bool(cfg.ba.global_iters > 0 and n_kf >= 3
                         and n_pts >= 10 and m >= 30))
        touched.append(do0[-1] or enab[-1] or (rounds > 1 and later[-1]))
    sel = [s for s, t in enumerate(touched) if t]
    if not sel:
        return
    fx = float(views[0].K[0, 0])
    with torch.no_grad():
        out = _finalize_refine_scenes_stage(
            views[0]._Kt, [views[s].carry for s in sel],
            [len(views[s]._X) for s in sel], [do0[s] for s in sel],
            [later[s] for s in sel], [enab[s] for s in sel],
            iters=cfg.ba.global_iters, rounds=rounds,
            lambda0=cfg.ba.lambda0, huber_delta=cfg.ba.huber_delta / fx)
    for row, s in zip(out, sel):
        v = views[s]
        v._X = row[:-2].reshape(-1, 3)[: len(v._X)]
        if enab[s]:
            log.info("structure refine (scene %d): cost %.3e -> %.3e "
                     "(%d kfs, %d pts)", s, row[-2], row[-1], len(v.kfs),
                     len(v._X))


def _kf_rows(rows: np.ndarray) -> np.ndarray:
    return rows[(rows[:, sp.Y_VALID] > 0.5) & (rows[:, sp.Y_KF] > 0.5)]


# the result fields that a mesh run gathers over its ``scene`` group
_GATHERED = ("centers", "kf_frames", "n_keyframes", "n_points",
             "loop_edges", "metrics")


def _scene_path(path, c: int) -> Path:
    """The checkpoint of ``scene`` coordinate ``c``, beside ``path``."""
    p = Path(path)
    return p.with_name(f"{p.stem}_scene{c}{p.suffix}")


def run_scenes_scan(datasets, cfg: SystemConfig, frames: int | None = None,
                    chunk: int = 16, p_cap: int = 16384, p_ba: int = 1024,
                    seed: int | None = None, images=None, mesh=None,
                    gated: bool = True, out_dirs=None,
                    checkpoint_path=None, checkpoint_every: int = 0,
                    resume: bool = False, device="cuda", _pri_source=None):
    """Reconstruct N scenes in lockstep with full per-scene mapping + BA,
    loop closure, pose graph, and finalize/export: the work of a
    single-scene ``ScanSfM`` run per scene (loop checks per chunk, per
    scene, as in the single-scene pipeline).

    ``datasets``: TempleRing handles with identical K/shape.  ``images``:
    optional preloaded grays, ``images[s][i]`` (keeps file IO out of the
    timing).  ``mesh``: a ``("scene", "hyp")`` ``DeviceMesh``
    (``parallel/mesh.make_mesh``); this rank then runs the scenes of its
    ``scene`` coordinate (S must divide by the scene axis) and every rank
    returns JAX's layout for all S scenes (below); ``device`` must be of
    the mesh's type.  ``gated``: accepted for the JAX twin's
    signature; both values run the one schedule of ``_run_chunk_scenes``
    (the JAX package's own ``test_gated_matches_ungated`` shows its two
    schedules agree).  ``out_dirs``: optional per-scene output directories
    for the artifacts (centers CSV, edges CSV, PLY); under a mesh each
    ``scene`` coordinate exports its own scenes (the ranks of ``hyp``
    coordinate 0 write).  ``checkpoint_path`` + ``checkpoint_every``: write a resumable
    checkpoint (every scene's carry, generator state included, each
    scene's loop/pose-graph state and the pulled metric rows) every N
    chunks; ``resume=True`` re-enters a run from ``checkpoint_path``
    bit-identically (same datasets/config/capacities required).  Under a
    mesh each ``scene`` coordinate writes and resumes its own scenes, in
    ``<stem>_scene<c><suffix>`` beside the path (written by the ranks of
    ``hyp`` coordinate 0, read by all).  ``seed``: RANSAC seed of scene 0 (default ``cfg.ransac.seed``); scene
    s draws from ``scene_seed(seed, s)``.  ``device``: ``"cuda"`` (the
    default; raises without a card) or ``"cpu"``.  ``_pri_source``: tests
    hand in RANSAC priorities here, a callable (scene, frame) ->
    (pri_frame, pri_edge).

    Returns a dict with per-scene keyframe centers, keyframe frames,
    counts, loop edges, map sizes, the views, the metric rows (S, F, NY)
    and the phase timers.  Centers/frames are the post-pose-graph,
    post-finalize keyframe values (``ScanSfM.kfs``).  Under a mesh every
    field but two holds all S scenes on every rank (gathered as numpy
    over the ``scene`` group); ``timers`` are this rank's, and ``views``
    holds this rank's scenes' views and ``None`` elsewhere: the one place
    where the layout differs from the JAX twin's single controller (a
    view holds the scene's device carry, which stays on its rank)."""
    n = frames or min(len(d) for d in datasets)
    if mesh is None:
        return _run_scenes_scan(
            datasets, cfg, n, chunk, p_cap, p_ba, seed, images, gated,
            out_dirs, checkpoint_path, checkpoint_every, resume,
            resolve(device), _pri_source)
    dev = rank_device(mesh, device)
    sc = local_scenes(mesh, len(datasets))
    c = mesh.get_local_rank("scene")
    writer = mesh.get_local_rank("hyp") == 0

    def mine(xs):
        return None if xs is None else list(xs)[sc.start:sc.stop]

    res = _run_scenes_scan(
        mine(datasets), cfg, n, chunk, p_cap, p_ba, seed, mine(images),
        gated, mine(out_dirs) if writer else None,
        None if checkpoint_path is None else _scene_path(checkpoint_path, c),
        checkpoint_every if writer else 0, resume, dev, _pri_source,
        scene0=sc.start)
    parts = gather_scenes(mesh, {k: res[k] for k in _GATHERED})
    out = {k: [x for p in parts for x in p[k]] for k in _GATHERED}
    for k in ("n_keyframes", "n_points", "metrics"):
        out[k] = np.concatenate([p[k] for p in parts])
    views = [None] * len(datasets)
    views[sc.start:sc.stop] = res["views"]
    return {"timers": res["timers"], **out, "views": views}


def _run_scenes_scan(datasets, cfg: SystemConfig, n: int, chunk: int,
                     p_cap: int, p_ba: int, seed, images, gated: bool,
                     out_dirs, checkpoint_path, checkpoint_every: int,
                     resume: bool, dev: torch.device, pri_source,
                     scene0: int = 0):
    """``run_scenes_scan`` of the scenes ``datasets`` on ``dev`` (without
    a mesh: all of them).  ``scene0``: the global index of the first, which
    sets the scenes' draws (``scene_seed``, ``pri_source``)."""
    from sfm_tpu_torch.utils import checkpoint as ckpt

    S = len(datasets)
    # host-side loop verification, as the JAX twin forces: there a device
    # verification under vmap would run for every scene on every keyframe
    if cfg.loop.enabled and cfg.loop.device_verify:
        cfg = dataclasses.replace(
            cfg, loop=dataclasses.replace(cfg.loop, device_verify=False))
    if images is None:
        images = [[d.load_gray(i) for i in range(n)] for d in datasets]
    base = cfg.ransac.seed if seed is None else seed
    views = [_scene_view(datasets, images, cfg, s, n, chunk, p_cap, p_ba,
                         dev) for s in range(S)]
    kf_cap, p_ba = views[0].kf_cap, views[0].p_ba
    Kf = views[0]._Kt
    ys_all = []
    # coarse host-side phase timers (the per-chunk ys pull and the
    # finalize pulls are real syncs, so the segments are attributable)
    tm = {"chunks": 0.0, "loop_check": 0.0, "finalize": 0.0}
    start_ci = 0
    with torch.no_grad():
        if resume:
            carries, meta, ys_ck, loops = ckpt.load_multiscene_checkpoint(
                checkpoint_path, device=dev)
            if meta["n_scenes"] != S:
                raise ValueError(f"checkpoint {checkpoint_path} holds "
                                 f"{meta['n_scenes']} scenes, not {S}")
            start_ci = meta["next_chunk"]
            tm.update(meta["timers"])
            if ys_ck is not None:
                ys_all.append(ys_ck)
                # each view's keyframe grays, from the pulled metric rows
                for s in range(S):
                    for fi in _kf_rows(ys_ck[s])[:, sp.Y_FRAME].astype(int):
                        views[s]._images[int(fi)] = images[s][int(fi)]
            for s in range(S):
                views[s].loop_edges = loops[s]
                views[s]._pg_ran = meta["pg_ran"][s]
        else:
            imgs0 = torch.stack([to_device(np.array(images[s][0]), dev)
                                 for s in range(S)])
            carries = _bootstrap_scenes(
                cfg, kf_cap, p_cap, imgs0, 0,
                [scene_seed(base, scene0 + s) for s in range(S)])
        for v, c in zip(views, carries):
            v.carry = c
        H, W = np.asarray(images[0][0]).shape

        def _assemble(start):
            """One chunk's (S,C,H,W) image batch, its copy to the card
            started (non-blocking, from pinned memory) so that it overlaps
            the running chunk."""
            stop = min(start + chunk, n)
            imgs = np.zeros((S, chunk, H, W), np.uint8)
            idxs = np.zeros((chunk,), np.int32)
            fvalid = np.zeros((chunk,), bool)
            for k, fi in enumerate(range(start, stop)):
                for s in range(S):
                    imgs[s, k] = images[s][fi]
                idxs[k] = fi
                fvalid[k] = True
            t = torch.from_numpy(imgs)
            if dev.type == "cuda":
                t = t.pin_memory().to(dev, non_blocking=True)
            return t, idxs, fvalid

        starts = list(range(1, n, chunk))
        run = _run_chunk_scenes_gated if gated else _run_chunk_scenes
        pri_for = None if pri_source is None else (
            lambda s, i: pri_source(scene0 + s, i))
        nxt = _assemble(starts[start_ci]) if starts[start_ci:] else None
        for ci in range(start_ci, len(starts)):
            t0 = time.perf_counter()
            imgs_t, idxs, fvalid = nxt
            _, ys = run(cfg, p_ba, Kf, carries, imgs_t, idxs, fvalid,
                        pri_for=pri_for)
            if ci + 1 < len(starts):
                nxt = _assemble(starts[ci + 1])
            ys_c = ys.cpu().numpy().astype(np.float64)  # the chunk's pull
            ys_all.append(ys_c)
            t1 = time.perf_counter()
            tm["chunks"] += t1 - t0
            _check_loops_scenes(cfg, views, images, ys_c)
            tm["loop_check"] += time.perf_counter() - t1
            if (checkpoint_path is not None and checkpoint_every > 0
                    and (ci + 1) % checkpoint_every == 0
                    and ci + 1 < len(starts)):
                ckpt.save_multiscene_checkpoint(
                    checkpoint_path, carries, views, ys_all, ci + 1, tm)
        ys = np.concatenate(ys_all, axis=1)
        t2 = time.perf_counter()

        # per-scene finalize (drain + re-triangulate + structure-only
        # refine) from ONE drain pull for all scenes
        c0 = carries[0]
        K_, T_ = c0.ring.pid.shape
        D_, P_ = c0.ring.desc.shape[1], c0.X.shape[0]
        drain_flat = _drain_stage_scenes(carries)
        t2a = time.perf_counter()
        tm["finalize_drain"] = t2a - t2
        for s in range(S):
            views[s].finalize(
                drained=sp._unpack_drain(drain_flat[s], K_, T_, D_, P_),
                refine=False)
        t2b = time.perf_counter()
        tm["finalize_host"] = t2b - t2a
        _refine_scenes(views, cfg)
        tm["finalize_refine"] = time.perf_counter() - t2b
        tm["finalize"] = time.perf_counter() - t2
    if out_dirs is not None:
        for s in range(S):
            views[s].export(out_dirs[s], dataset=datasets[s])

    return {
        "timers": tm,
        "centers": [np.stack([kf.center for kf in v.kfs])
                    if v.kfs else np.zeros((0, 3)) for v in views],
        "kf_frames": [np.asarray([kf.frame_idx for kf in v.kfs])
                      for v in views],
        "n_keyframes": np.asarray([len(v.kfs) for v in views]),
        "n_points": np.asarray([int(c.n_pts) for c in carries]),
        "loop_edges": [list(v.loop_edges) for v in views],
        "views": views,
        "metrics": ys,
    }


def _check_loops_scenes(cfg: SystemConfig, views, images,
                        ys_c: np.ndarray) -> None:
    """The loop checks after a chunk, per scene, gated on the pulled
    metric rows so that scenes without candidates cost nothing more."""
    lcfg = cfg.loop
    maybe: list[int] = []
    for s, v in enumerate(views):
        rows = _kf_rows(ys_c[s])
        for fi in rows[:, sp.Y_FRAME].astype(int):
            v._images[int(fi)] = images[s][int(fi)]
        if not lcfg.enabled:
            continue
        # ORB candidates come from the descriptor bank, scored per new
        # keyframe: any keyframe makes a candidate scene; the descriptor
        # flavor pre-gates on the ring score
        if (len(rows) if lcfg.method == "orb" else
                sp.ScanSfM.loop_candidate_rows(ys_c[s], lcfg).any()):
            maybe.append(s)
    if not maybe:
        return
    carries = [v.carry for v in views]
    K_ = int(carries[0].ring.pid.shape[0])
    rp_flat = _ring_pose_stage_scenes(carries)
    if lcfg.method == "orb":
        # the per-scene path, after the JAX twin's gate on the keyframe
        # count (no scene can close a loop before min_kf_gap keyframes;
        # as there, the ORB features of keyframes in chunks this gate
        # skips are not computed)
        for s in maybe:
            if int(rp_flat[s][K_ * 28]) <= lcfg.min_kf_gap:
                continue
            views[s]._check_loops(ys_c[s])
        return
    kcfg = cfg.klt
    for s in maybe:
        v = views[s]
        rp = sp._unpack_ring_poses(rp_flat[s], K_)
        cands = sp.ScanSfM.gate_loop_candidates(ys_c[s], rp, lcfg)
        if not cands:
            continue
        fx = float(v.K[0, 0])

        def verify(cand_kf, cur_kf, old_img, new_img, cs, v=v):
            # counted per LK pass: the fused stage, and the E-RANSAC
            # fallback's own in _verify_loop
            v.host_verifications += 1
            pack = _verify_scene_stage(
                v._Kt, to_device(np.array(old_img), v.device),
                to_device(np.array(new_img), v.device), v.carry,
                cand_kf, cur_kf, levels=kcfg.pyr_levels,
                lk_iters=kcfg.iters, radius=kcfg.win_radius,
                fb_thresh=kcfg.fb_thresh,
                huber_delta=cfg.ba.huber_delta / fx)
            pack = pack.cpu().numpy().astype(np.float64)
            if pack[15] < 30:
                # unmapped old keyframe: the rare E-RANSAC fallback
                return v._verify_loop(cand_kf, cur_kf, old_img, new_img, cs)
            return v._pnp_edge_from_pack(pack, cand_kf, cur_kf, cs)

        if v._verify_candidates(cands, rp, verify=verify,
                                label=f" (scene {s})"):
            v._pose_graph_pushback(pr=rp)

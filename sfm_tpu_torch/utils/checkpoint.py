"""Checkpoint / resume for the three pipelines.

Counterpart of sfm_tpu/utils/checkpoint.py, with its file layout: one
``.npz`` of arrays and one ``.json`` of metadata per checkpoint (plus a
``.loops.npz`` of loop edges for ``ScanSfM``), the JAX twin's array and
metadata names.  The JAX twin's PRNG key (``rng_key`` / ``key``) has no
place here: the port's RANSAC generator is a ``torch.Generator``, whose
state (``get_state()``, a uint8 vector) is stored as ``gen_state``.
Resuming restores it, so a resumed run continues bit-identically.

  * ``save_checkpoint`` / ``load_checkpoint``: ``SfMSystem``
    (models/system.py).
  * ``save_scan_checkpoint`` / ``load_scan_checkpoint``: ``ScanSfM``
    (models/scan_pipeline.py), at a chunk boundary.  The loader also reads
    a checkpoint written by the JAX package; its generator is then seeded
    from ``cfg.ransac.seed``, as ``scan_pipeline.carry_from_numpy`` does.
  * ``save_multiscene_checkpoint`` / ``load_multiscene_checkpoint``:
    ``parallel.multi_scan.run_scenes_scan``, with the scenes' carries
    stacked on a leading scene axis as the JAX twin's batched carry has
    them (``_carry_to_arrays`` / ``_carry_from_arrays``).
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

from sfm_tpu_torch.utils.device import resolve


def _edge_meta(e) -> dict:
    return dict(i=e.i, j=e.j, inliers=e.inliers, is_loop=e.is_loop,
                w_rot=e.w_rot, w_trans=e.w_trans, s_rel=e.s_rel)


def _edges_from(metas, R, t) -> list:
    from sfm_tpu_torch.models.mapstate import Edge

    return [Edge(i=em["i"], j=em["j"], R_ji=R[k], t_ji=t[k],
                 inliers=em["inliers"], is_loop=em.get("is_loop", True),
                 w_rot=em["w_rot"], w_trans=em["w_trans"],
                 s_rel=em.get("s_rel", 1.0))
            for k, em in enumerate(metas)]


def _gen_from(state, device, seed: int) -> torch.Generator:
    """A generator on ``device`` with the stored ``state``, or seeded with
    ``seed`` where the checkpoint holds none (the JAX package's files)."""
    gen = torch.Generator(device=device)
    if state is None:
        gen.manual_seed(seed)
    else:
        gen.set_state(torch.from_numpy(np.array(state, np.uint8)))
    return gen


def _write(path: Path, arrays: dict, meta: dict) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(path.with_suffix(".npz"), **arrays)
    path.with_suffix(".json").write_text(json.dumps(meta))


def _read(path) -> tuple:
    path = Path(path)
    return (np.load(path.with_suffix(".npz")),
            json.loads(path.with_suffix(".json").read_text()))


# ---------------------------------------------------------------------------
# SfMSystem
# ---------------------------------------------------------------------------


def save_checkpoint(system, path: str | Path) -> None:
    """Serialize the full ``SfMSystem`` state into one .npz + meta json,
    the previous frame's gray included (``prev_img``), so that
    ``load_checkpoint`` restores the tracker's pyramid too."""
    path = Path(path)
    arrays: dict[str, np.ndarray] = {}
    meta: dict = {
        "n_kfs": len(system.kfs),
        "n_edges": len(system.edges),
        "prev_frame_idx": system.prev_frame_idx,
        "last_kf_frame": system.last_kf_frame,
        "kf_meta": [
            dict(kf_id=k.kf_id, frame_idx=k.frame_idx, img_name=k.img_name)
            for k in system.kfs
        ],
        "edge_meta": [_edge_meta(e) for e in system.edges],
        "first_obs_tid": [int(t) for t in system.first_obs],
        "point_tid": list(system.map.point_tid),
    }
    arrays["pose_R"] = system.pose_R
    arrays["pose_t"] = system.pose_t
    arrays["gen_state"] = system._gen.get_state().numpy()
    u8 = lambda p: np.clip(p.cpu().numpy(), 0, 255).astype(np.uint8)  # noqa: E731
    if system.prev_pyr is not None:
        arrays["prev_img"] = u8(system.prev_pyr[0])
    if system.kfs:
        arrays["kf_R"] = np.stack([k.R_cw for k in system.kfs])
        arrays["kf_t"] = np.stack([k.t_cw for k in system.kfs])
        arrays["kf_ids"] = np.stack([k.ids for k in system.kfs])
        arrays["kf_uv"] = np.stack([k.uv for k in system.kfs])
        arrays["kf_valid"] = np.stack([k.valid for k in system.kfs])
        arrays["kf_desc"] = np.stack(
            [k.desc if k.desc is not None else np.zeros(1024)
             for k in system.kfs])
        # each keyframe's finest pyramid level, so that loop closure can
        # fire against pre-checkpoint keyframes after a resume (pyr and
        # ORB features are rebuilt on load)
        if all(k.pyr is not None for k in system.kfs):
            arrays["kf_img"] = np.stack([u8(k.pyr[0]) for k in system.kfs])
    if system.edges:
        arrays["edge_R"] = np.stack([e.R_ji for e in system.edges])
        arrays["edge_t"] = np.stack([e.t_ji for e in system.edges])
    arrays["points"] = system.map.xyz()
    obs_kf, obs_pid, obs_uv = system.map.obs_arrays()
    arrays["obs_kf"] = obs_kf
    arrays["obs_pid"] = obs_pid
    arrays["obs_uv"] = obs_uv
    if system.first_obs:
        arrays["first_obs_kf"] = np.array(
            [system.first_obs[t][0] for t in system.first_obs], np.int32)
        arrays["first_obs_uv"] = np.stack(
            [system.first_obs[t][1] for t in system.first_obs])
    if system.state is not None:
        for f in ("pos", "valid", "ids"):
            arrays[f"trk_{f}"] = getattr(system.state, f).cpu().numpy()
        arrays["trk_next"] = system.state.next_id.cpu().numpy()
    _write(path, arrays, meta)


def load_checkpoint(system, path: str | Path) -> None:
    """Restore state saved by ``save_checkpoint`` into ``system`` (which
    must have been constructed with the same K/config).  Continue with the
    frame after ``prev_frame_idx``.  Without a stored ``prev_img`` (the
    JAX package's files) the previous frame's pyramid is not restored:
    set ``system.prev_pyr`` (``build_pyramid_u8`` of that frame) before the
    next ``process``."""
    from sfm_tpu_torch.models import tracker
    from sfm_tpu_torch.models.mapstate import Keyframe
    from sfm_tpu_torch.models.system import build_pyramid_u8
    from sfm_tpu_torch.ops import orb as orb_ops

    z, meta = _read(path)
    dev = system.device
    cfg = system.cfg
    pyr_of = lambda a: build_pyramid_u8(  # noqa: E731
        torch.from_numpy(np.array(a, np.uint8)).to(dev), cfg.klt.pyr_levels)
    system.pose_R = z["pose_R"]
    system.pose_t = z["pose_t"]
    system._gen = _gen_from(z["gen_state"] if "gen_state" in z else None,
                            dev, cfg.ransac.seed)
    system.prev_frame_idx = meta["prev_frame_idx"]
    system.last_kf_frame = meta["last_kf_frame"]
    system.prev_pyr = pyr_of(z["prev_img"]) if "prev_img" in z else None
    system.kfs = []
    for k, km in enumerate(meta["kf_meta"]):
        kf = Keyframe(
            kf_id=km["kf_id"], frame_idx=km["frame_idx"],
            img_name=km["img_name"], R_cw=z["kf_R"][k], t_cw=z["kf_t"][k],
            ids=z["kf_ids"][k], uv=z["kf_uv"][k], valid=z["kf_valid"][k],
            desc=z["kf_desc"][k],
        )
        if "kf_img" in z:
            kf.pyr = pyr_of(z["kf_img"][k])
            if cfg.loop.enabled and cfg.loop.method == "orb":
                kf.orb = orb_ops.detect_and_describe(
                    kf.pyr[0], max_kp=cfg.loop.max_keypoints, device=dev)
        system.kfs.append(kf)
    system.edges = _edges_from(
        meta["edge_meta"], z["edge_R"] if "edge_R" in z else None,
        z["edge_t"] if "edge_t" in z else None)
    m = system.map
    pts = np.asarray(z["points"], np.float64).reshape(-1, 3)
    m._n_points = len(pts)
    m._X = pts.copy() if len(pts) else np.zeros((1024, 3))
    tids = np.asarray(meta["point_tid"], np.int64)
    m._point_tid = tids.copy() if len(tids) else np.zeros(1024, np.int64)
    m.rebuild_lookup()
    m._n_obs = len(z["obs_kf"])
    m._obs_kf = np.asarray(z["obs_kf"], np.int32).copy()
    m._obs_pid = np.asarray(z["obs_pid"], np.int32).copy()
    m._obs_uv = np.asarray(z["obs_uv"], np.float64).reshape(-1, 2).copy()
    if m._n_obs == 0:
        m._obs_kf = np.zeros(4096, np.int32)
        m._obs_pid = np.zeros(4096, np.int32)
        m._obs_uv = np.zeros((4096, 2))
    system.first_obs = {}
    if "first_obs_kf" in z:
        for t, kf, uv in zip(meta["first_obs_tid"], z["first_obs_kf"],
                             z["first_obs_uv"]):
            system.first_obs[int(t)] = (int(kf), uv)
    if "trk_pos" in z:
        system.state = tracker.state_from_numpy(
            {"pos": z["trk_pos"], "valid": z["trk_valid"],
             "ids": z["trk_ids"], "next_id": z["trk_next"]}, dev)


# ---------------------------------------------------------------------------
# ScanSfM: the carry is a set of fixed-shape tensors, so serialization is
# field by field exact and a resumed run continues bit-identically when
# saved at a chunk boundary.
# ---------------------------------------------------------------------------


def _carry_to_arrays(carry) -> dict[str, np.ndarray]:
    """Flatten a ``ScanCarry``, or a list of scenes' carries (every leaf
    then stacked on a leading S axis, the JAX twin's batched carry), into
    named numpy arrays.  The scalar fields (last_kf_frame/kf_count/n_pts)
    are stored as arrays, so the stacked (S,) case round-trips too."""
    from sfm_tpu_torch.models import scan_pipeline as sp

    carries = carry if isinstance(carry, list) else [carry]
    per = []
    for c in carries:
        d = sp.carry_to_numpy(c)
        a = {k: d[k] for k in sp._CARRY_DTYPES}
        a.update({f"trk_{k}": v for k, v in d["trk"].items()})
        a.update({f"ring_{k}": v for k, v in d["ring"].items()})
        a.update({f"pyr{i}": p for i, p in enumerate(d["prev_pyr"])})
        a["gen_state"] = c.gen.get_state().numpy()
        per.append(a)
    if not isinstance(carry, list):
        return per[0]
    return {k: np.stack([a[k] for a in per]) for k in per[0]}


def _carry_from_arrays(z, levels: int, device, seed: int, scene=None):
    """The carry of ``_carry_to_arrays``' arrays (of scene ``scene`` of a
    stacked set), with its generator state, or seeded with ``seed`` where
    the arrays hold none."""
    from sfm_tpu_torch.models import scan_pipeline, tracker

    pick = (lambda k: z[k]) if scene is None else (lambda k: z[k][scene])  # noqa: E731
    leaves = {k: pick(k) for k in scan_pipeline._CARRY_DTYPES}
    leaves["trk"] = {f: pick(f"trk_{f}")
                     for f in tracker.TrackerState._fields}
    leaves["ring"] = {f: pick(f"ring_{f}")
                      for f in scan_pipeline._RING_DTYPES}
    leaves["prev_pyr"] = [pick(f"pyr{i}") for i in range(levels)]
    carry = scan_pipeline.carry_from_numpy(leaves, device=device)
    carry.gen = _gen_from(pick("gen_state") if "gen_state" in z else None,
                          carry.X.device, seed)
    return carry


def save_scan_checkpoint(scan, path: str | Path) -> None:
    """Serialize a ``ScanSfM`` mid-run.  Flushes the pending frame buffer
    first so that the carry is at a chunk boundary."""
    path = Path(path)
    scan._flush()
    c = scan.carry
    arrays = _carry_to_arrays(c)
    for k in ("last_kf_frame", "kf_count", "n_pts"):  # in meta, as JAX has
        del arrays[k]
    if scan._images:  # keyframe-only image store (frame_idx -> u8 gray)
        kf_frames = sorted(scan._images)
        arrays["images"] = np.stack(
            [scan._images[f] for f in kf_frames]).astype(np.uint8)
        arrays["image_frames"] = np.asarray(kf_frames, np.int64)
    meta = {
        "scan": True,
        "levels": len(c.prev_pyr),
        "last_kf_frame": int(c.last_kf_frame),
        "kf_count": int(c.kf_count),
        "n_pts": int(c.n_pts),
        "names": scan._names,
        "metrics": scan.metrics,
        "pg_ran": scan._pg_ran,
        "loop_edges": [_edge_meta(e) for e in scan.loop_edges],
    }
    _write(path, arrays, meta)
    if scan.loop_edges:
        np.savez_compressed(
            path.with_suffix(".loops.npz"),
            R=np.stack([e.R_ji for e in scan.loop_edges]),
            t=np.stack([e.t_ji for e in scan.loop_edges]))


def load_scan_checkpoint(scan, path: str | Path) -> None:
    """Restore into a freshly constructed ``ScanSfM`` with the same config
    and capacities (a checkpoint of the port's or of the JAX package's).
    Continue by calling ``scan.process`` for later frames."""
    from sfm_tpu_torch.models.scan_pipeline import _RING_DTYPES

    path = Path(path)
    z, meta = _read(path)
    arrays = {k: z[k] for k in z.files}
    for k in ("last_kf_frame", "kf_count", "n_pts"):
        arrays[k] = np.asarray(meta[k], np.int32)
    if "ring_img" not in arrays:
        # checkpoints older than the keyframe-image store: rebuild it from
        # the stored keyframe grays when the config verifies on the
        # device, else the (K,1,1) dummy
        K_ = z["ring_frame"].shape[0]
        lcfg = scan.cfg.loop
        imgs = np.zeros((K_, 1, 1), np.uint8)
        if lcfg.enabled and lcfg.device_verify and "images" in z:
            imgs = np.zeros((K_, *z["images"].shape[1:]), np.uint8)
            at = {int(fr): k for k, fr in enumerate(z["image_frames"])}
            for k, fr in enumerate(z["ring_frame"]):
                if int(fr) in at:
                    imgs[k] = z["images"][at[int(fr)]]
        arrays["ring_img"] = imgs
    assert set(_RING_DTYPES) <= {k[5:] for k in arrays if k[:5] == "ring_"}
    scan.carry = _carry_from_arrays(arrays, meta["levels"], scan.device,
                                    scan.cfg.ransac.seed)
    scan._images = {}
    if "images" in z:
        for f, im in zip(z["image_frames"], z["images"]):
            scan._images[int(f)] = im
    scan._names = list(meta["names"])
    scan.metrics = list(meta["metrics"])
    scan._pg_ran = bool(meta.get("pg_ran", False))
    scan.loop_edges = []
    if meta["loop_edges"]:
        lz = np.load(path.with_suffix(".loops.npz"))
        scan.loop_edges = _edges_from(meta["loop_edges"], lz["R"], lz["t"])
    lcfg = scan.cfg.loop
    if lcfg.enabled and lcfg.method == "orb":
        # the ORB bank held every keyframe with a stored gray
        frames = z["ring_frame"]
        for k in np.nonzero(z["ring_kvalid"])[0]:
            if int(frames[k]) in scan._images:
                scan._orb_for(int(k), scan._images[int(frames[k])])


# ---------------------------------------------------------------------------
# run_scenes_scan
# ---------------------------------------------------------------------------


def save_multiscene_checkpoint(path: str | Path, carries, views,
                               ys_chunks: list[np.ndarray],
                               next_chunk: int, timers: dict) -> None:
    """Checkpoint a ``run_scenes_scan`` run at a chunk boundary: every
    scene's carry (stacked on a scene axis), each scene's loop/pose-graph
    state, and the pulled per-chunk metric rows.  ``next_chunk`` indexes
    the chunk-start list; resuming re-enters the chunk loop there,
    bit-identically."""
    arrays = _carry_to_arrays(list(carries))
    if ys_chunks:
        arrays["ys"] = np.concatenate(ys_chunks, axis=1)
    loops_R, loops_t, loop_meta = [], [], []
    for s, v in enumerate(views):
        for e in v.loop_edges:
            loops_R.append(e.R_ji)
            loops_t.append(e.t_ji)
            loop_meta.append(dict(scene=s, **_edge_meta(e)))
    if loops_R:
        arrays["loops_R"] = np.stack(loops_R)
        arrays["loops_t"] = np.stack(loops_t)
    meta = {
        "multiscene": True,
        "n_scenes": len(views),
        "levels": len(carries[0].prev_pyr),
        "next_chunk": int(next_chunk),
        "timers": {k: float(vv) for k, vv in timers.items()},
        "pg_ran": [bool(v._pg_ran) for v in views],
        "loop_meta": loop_meta,
    }
    _write(Path(path), arrays, meta)


def load_multiscene_checkpoint(path: str | Path, device="cuda"):
    """Returns (carries, meta, ys (S,C_done,NY) or None,
    loop_edges_by_scene) for ``run_scenes_scan(..., resume=True)``."""
    dev = resolve(device)
    z, meta = _read(path)
    S = meta["n_scenes"]
    carries = [_carry_from_arrays(z, meta["levels"], dev, 0, scene=s)
               for s in range(S)]
    ys = np.asarray(z["ys"]) if "ys" in z else None
    loops: list[list] = [[] for _ in range(S)]
    if meta["loop_meta"]:
        for em, e in zip(meta["loop_meta"], _edges_from(
                meta["loop_meta"], z["loops_R"], z["loops_t"])):
            loops[em["scene"]].append(e)
    return carries, meta, ys, loops

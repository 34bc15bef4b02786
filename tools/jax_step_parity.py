"""One frame of the port's ``ScanSfM`` from the JAX package's own state,
stage by stage, on ``chip_smoke.py``'s ring at full width, on the CPU.

The two packages' whole runs of the 47-frame ring part after a frame or
two (an LK track that does not converge amplifies the last bit of every
sum), so a difference in their ATE says little about where it comes from.
This holds the port to the JAX package one step at a time instead, so no
difference can build up: the JAX ``ScanSfM`` runs the ring at
``chip_smoke.SMOKE_OVERRIDES`` (chunk 1, so its carry can be taken after
any frame); after each frame ``k`` of ``--after`` its carry is taken, and
frame ``k + 1`` is run from that carry once by the JAX package's
``run_chunk`` and once by the port's ``frame_step`` (on the CPU, with the
JAX package's RANSAC draws for that frame).  One JSON line per step
compares, stage by stage:

  tracker     the track table (valid slots, kept tracks, their positions)
              and the alive count;
  two_view    the frame's LO-RANSAC pose flag, inliers, the median flow
              (parallax) and the keyframe decision;
  pose        the frame's pose (rotation, centre over the last keyframe
              baseline);
  keyframe    (keyframes only) edge RANSAC inliers, the propagated scale,
              PnP inliers, new points, map size, the window BA's cost
              before and after, and the ring's poses after it;
  loop        the loop descriptor score and candidate, and the device
              loop verification's pack (flag, inliers, relative scale).

Then the last frames: for each ``K`` of ``--tail``, the JAX run's state
after frame ``n - 1 - K`` is written as a scan checkpoint and loaded into
a new ``ScanSfM`` of each package, which runs the last ``K`` frames (the
port with the JAX package's draws) and ``finalize`` (the loop check and
pose graph of the flush, re-triangulation, the structure refinement).
``K = 0`` is ``finalize`` alone; ``K = 1`` adds the ring's last frame,
where the loop closes.  One JSON line a ``K`` compares the two: the ATE
ratio of the odometry poses at the checkpoint and of both results, loop
edges, map points and the largest keyframe-centre difference over the
trajectory's extent.

    JAX_PLATFORMS=cpu python tools/jax_step_parity.py \\
        [--after 0 1 11 23 35 45] [--tail 0 1] [--seed 12345]

On an 8-core x86 CPU the JAX run over the ring takes 6-9 min; then each
step takes about 1 min alone (3-4 min with three such processes side by
side), and each tail about 2 min a frame.  The lines this printed for the
ring's seeds are kept in docs/step_parity/ring47_seed<seed>.jsonl.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from sfm_tpu import config as jconfig  # noqa: E402
from sfm_tpu.models import scan_pipeline as jsp, tracker as jtracker  # noqa: E402
from sfm_tpu.utils import checkpoint as jcheckpoint  # noqa: E402
from sfm_tpu.utils.dataset import TempleRing  # noqa: E402
from sfm_tpu.utils.synthetic import (SyntheticRingSpec,  # noqa: E402
                                     generate_dataset)
from sfm_tpu_torch import config  # noqa: E402
from sfm_tpu_torch.models import scan_pipeline as sp  # noqa: E402
from sfm_tpu_torch.utils import checkpoint  # noqa: E402

P_CAP, P_BA = 16384, 1024


def leaves(c) -> dict:
    """A JAX ScanCarry as nested dicts of numpy arrays."""
    d = {k: np.asarray(getattr(c, k))
         for k in ("R_cw", "t_cw", "last_kf_frame", "kf_count", "slot_pid",
                   "fo_kf", "fo_uv", "X", "n_pts", "key")}
    d["trk"] = {k: np.asarray(v) for k, v in c.trk._asdict().items()}
    d["prev_pyr"] = [np.asarray(p) for p in c.prev_pyr]
    d["ring"] = {k: np.asarray(v) for k, v in c.ring._asdict().items()}
    return d


def jax_carry(d: dict):
    return jsp.ScanCarry(
        trk=jtracker.TrackerState(
            **{k: jnp.asarray(v) for k, v in d["trk"].items()}),
        prev_pyr=tuple(jnp.asarray(p) for p in d["prev_pyr"]),
        ring=jsp.KeyframeRing(
            **{k: jnp.asarray(v) for k, v in d["ring"].items()}),
        **{k: jnp.asarray(d[k])
           for k in ("R_cw", "t_cw", "last_kf_frame", "kf_count",
                     "slot_pid", "fo_kf", "fo_uv", "X", "n_pts", "key")})


def rot_deg(Ra, Rb) -> float:
    """Angle of Ra Rb^T in degrees."""
    c = (np.trace(np.asarray(Ra, np.float64) @ np.asarray(Rb, np.float64).T)
         - 1.0) / 2.0
    return float(np.degrees(np.arccos(np.clip(c, -1.0, 1.0))))


def center(R_cw, t_cw):
    """The camera centre of a carry or ring pose: both packages keep
    camera-to-world poses under the name ``R_cw``/``t_cw``, so ``t_cw`` is
    the centre (``Keyframe.center``)."""
    return np.asarray(t_cw, np.float64)


def pair(yj, yt, col) -> list:
    return [float(yj[col]), float(yt[col])]


def compare(k: int, before: dict, want: dict, yj, got: dict, yt) -> dict:
    # tracker
    vj, vt = want["trk"]["valid"], got["trk"]["valid"]
    old = before["trk"]["ids"]
    kept_j = vj & (want["trk"]["ids"] == old) & (old >= 0)
    kept_t = vt & (got["trk"]["ids"] == old) & (old >= 0)
    kept = kept_j & kept_t
    d = np.abs(got["trk"]["pos"][kept] - want["trk"]["pos"][kept]).max(-1)
    tracker = {
        "valid_agree": float((vj == vt).mean()),
        "kept_agree": float((kept_j == kept_t).mean()),
        "kept": int(kept.sum()),
        "kept_only_jax": int((kept_j & ~kept_t).sum()),
        "kept_only_port": int((kept_t & ~kept_j).sum()),
        "pos_share_under_1e-3": float((d < 1e-3).mean()) if len(d) else 1.0,
        "pos_median": float(np.median(d)) if len(d) else 0.0,
        "pos_max": float(d.max()) if len(d) else 0.0,
        "alive": pair(yj, yt, sp.Y_ALIVE)}
    two_view = {"ok": pair(yj, yt, sp.Y_OK), "inliers": pair(yj, yt, sp.Y_INL),
                "parallax": pair(yj, yt, sp.Y_PAR),
                "keyframe": pair(yj, yt, sp.Y_KF)}
    kf = int(want["kf_count"]) - 1
    rj = want["ring"]
    base = float(np.linalg.norm(center(rj["R_cw"][kf], rj["t_cw"][kf])
                                - center(rj["R_cw"][kf - 1],
                                         rj["t_cw"][kf - 1]))) if kf else 1.0
    pose = {"rot_deg": rot_deg(got["R_cw"], want["R_cw"]),
            "center_over_baseline": float(np.linalg.norm(
                center(got["R_cw"], got["t_cw"])
                - center(want["R_cw"], want["t_cw"]))) / base}
    out = {"step": f"{k}->{k + 1}", "tracker": tracker, "two_view": two_view,
           "pose": pose}
    if yj[sp.Y_KF] > 0.5:
        rt = got["ring"]
        n = kf + 1
        out["keyframe"] = {
            "edge_inliers": pair(yj, yt, sp.Y_EDGE_INL),
            "scale": pair(yj, yt, sp.Y_SCALE),
            "pnp_inliers": pair(yj, yt, sp.Y_PNP_INL),
            "new_points": pair(yj, yt, sp.Y_NEW_PTS),
            "map_points": pair(yj, yt, sp.Y_NPTS),
            "ba_cost_before": pair(yj, yt, sp.Y_BA0),
            "ba_cost_after": pair(yj, yt, sp.Y_BA1),
            "ring_rot_deg_max": max(rot_deg(rt["R_cw"][i], rj["R_cw"][i])
                                    for i in range(n)),
            "ring_center_over_baseline_max": max(float(np.linalg.norm(
                center(rt["R_cw"][i], rt["t_cw"][i])
                - center(rj["R_cw"][i], rj["t_cw"][i])))
                for i in range(n)) / base,
            "edge_rot_deg": rot_deg(rt["e_Rji"][kf], rj["e_Rji"][kf]),
            "same_frames": bool((rt["frame"] == rj["frame"]).all())}
        out["loop"] = {"score": pair(yj, yt, sp.Y_LOOP_S),
                       "candidate": pair(yj, yt, sp.Y_LOOP_K),
                       "verify_ok": pair(yj, yt, sp.Y_LV_OK),
                       "verify_inliers": pair(yj, yt, sp.Y_LV_INL),
                       "verify_scale": pair(yj, yt, sp.Y_LV_SREL)}
    return out


def ate_ratio(centers, frames, ds) -> float:
    return cs.centers_ate_ratio(list(centers), list(frames), ds)


def jax_draws(key, shape):
    """The JAX ScanSfM's draws from carry key ``key`` on: one split in
    three a frame, then ``uniform(k1)``, ``uniform(k2)`` of ``shape``."""
    state = [jnp.asarray(key)]

    def draws(idx):
        state[0], k1, k2 = jax.random.split(state[0], 3)
        return (np.asarray(jax.random.uniform(k1, shape, jnp.float32)),
                np.asarray(jax.random.uniform(k2, shape, jnp.float32)))
    return draws


def compare_tail(ds, cfg_j, cfg_t, ck: Path, k_tail: int) -> dict:
    """Both packages from the checkpoint ``ck`` (the JAX run after frame
    ``n - 1 - k_tail``): the last ``k_tail`` frames, then ``finalize``."""
    n = len(ds.records)
    kw = dict(n_frames=n, chunk=1, p_cap=P_CAP, p_ba=P_BA)
    js = jsp.ScanSfM(ds.K, cfg_j, **kw)
    jcheckpoint.load_scan_checkpoint(js, ck)
    ts = sp.ScanSfM(ds.K, cfg_t, device="cpu", **kw)
    checkpoint.load_scan_checkpoint(ts, ck)
    ring = leaves(js.carry)["ring"]
    n_kf = int(np.asarray(js.carry.kf_count))
    odo = ate_ratio([center(ring["R_cw"][i], ring["t_cw"][i])
                     for i in range(n_kf)], ring["frame"][:n_kf], ds)
    ts._pri_source = jax_draws(
        np.asarray(js.carry.key),
        (cfg_j.ransac.num_hypotheses, cfg_j.klt.max_tracks))
    for i in range(n - k_tail, n):
        js.process(i, ds.records[i].img, ds.load_gray(i))
    js.finalize()
    with torch.no_grad():
        for i in range(n - k_tail, n):
            ts.process(i, ds.records[i].img, ds.load_gray(i))
        ts.finalize()
    cj = np.stack([k.center for k in js.kfs])
    ct = np.stack([k.center for k in ts.kfs])
    fr = [k.frame_idx for k in js.kfs]
    gt = np.stack([ds.records[f].center for f in fr])
    extent = float(np.linalg.norm(gt - gt.mean(0), axis=1).max())
    return {"tail": k_tail, "keyframes": [len(js.kfs), len(ts.kfs)],
            "ate_ratio_odometry_at_checkpoint": odo,
            "ate_ratio": [ate_ratio(cj, fr, ds),
                          ate_ratio(ct, [k.frame_idx for k in ts.kfs], ds)],
            "loop_edges": [[(e.i, e.j) for e in x.edges if e.is_loop]
                           for x in (js, ts)],
            "map_points": [len(js.map_xyz), len(ts.map_xyz)],
            "center_max_over_extent": float(np.linalg.norm(
                cj - ct, axis=1).max()) / extent
            if len(cj) == len(ct) else None}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--after", type=int, nargs="*",
                    default=[0, 1, 11, 23, 35, 45])
    ap.add_argument("--tail", type=int, nargs="*", default=[0, 1])
    ap.add_argument("--seed", type=int, default=12345)
    args = ap.parse_args()
    after = sorted(set(args.after))

    cfg_j = jconfig.load_config(None, overrides=cs.SMOKE_OVERRIDES)
    cfg_j = dataclasses.replace(
        cfg_j, ransac=dataclasses.replace(cfg_j.ransac, seed=args.seed))
    cfg_t = config.load_config(None, overrides=cs.SMOKE_OVERRIDES)
    cfg_t = dataclasses.replace(
        cfg_t, ransac=dataclasses.replace(cfg_t.ransac, seed=args.seed))
    spec = SyntheticRingSpec(**dataclasses.asdict(cs.ring_spec()))
    torch.set_num_threads(8)
    with tempfile.TemporaryDirectory(prefix="jax_step_") as tmp:
        generate_dataset(Path(tmp), spec, name_prefix="templeR")
        ds = TempleRing.from_dir(Path(tmp))
        n = len(ds.records)
        t0 = time.perf_counter()
        s = jsp.ScanSfM(ds.K, cfg_j, n_frames=n, chunk=1, p_cap=P_CAP,
                        p_ba=P_BA)
        snaps = {}
        for i in range(n):
            s.process(i, ds.records[i].img, ds.load_gray(i))
            if i in after:
                assert not s._pending
                snaps[i] = leaves(s.carry)
            if n - 1 - i in args.tail:
                jcheckpoint.save_scan_checkpoint(
                    s, Path(tmp) / f"tail{n - 1 - i}")
        print(json.dumps({"jax_run_s": time.perf_counter() - t0}),
              flush=True)
        Kt = torch.as_tensor(np.asarray(ds.K, np.float32))
        shape = (cfg_j.ransac.num_hypotheses, cfg_j.klt.max_tracks)
        for k in after:
            g = ds.load_gray(k + 1)
            before = snaps[k]
            carry, ys = jsp.run_chunk(
                cfg_j, s.p_ba, s._Kj, jax_carry(before),
                jnp.asarray(g)[None], jnp.asarray([k + 1], jnp.int32),
                jnp.asarray([True]))
            _, k1, k2 = jax.random.split(jnp.asarray(before["key"]), 3)
            pri_frame = np.asarray(jax.random.uniform(k1, shape, jnp.float32))
            pri_edge = np.asarray(jax.random.uniform(k2, shape, jnp.float32))
            with torch.no_grad():
                ct = sp.carry_from_numpy(before, device="cpu")
                ct, yt = sp.frame_step(
                    cfg_t, P_BA, Kt, ct, torch.as_tensor(g.copy()), k + 1,
                    pri_frame=torch.as_tensor(pri_frame),
                    pri_edge=torch.as_tensor(pri_edge))
            print(json.dumps(compare(
                k, before, leaves(carry), np.asarray(ys[0], np.float64),
                sp.carry_to_numpy(ct), yt.numpy().astype(np.float64))),
                flush=True)
        for k_tail in sorted(set(args.tail)):
            print(json.dumps(compare_tail(ds, cfg_j, cfg_t,
                                          Path(tmp) / f"tail{k_tail}",
                                          k_tail)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

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
where the loop closes.  The two run frame by frame: after every frame
one line says how far the keyframe centres have parted, and at the first
frame where they part by more than 1 % of the extent it lists every
carry leaf that differs (``--carry`` adds the same to each one-frame
step).  Then one JSON line a ``K`` compares the two: the ATE ratio of the
odometry poses at the checkpoint and of both results, loop edges, map
points and the largest keyframe-centre difference over the trajectory's
extent.

``--fb-witness K`` holds the tracker's forward-backward gate of step
``K -> K + 1`` to float64: the pass runs from the JAX carry in each
package in float32 and in float64, and one line gives the tracks whose
keep decision differs between any two of the four, with their
forward-backward errors.

    JAX_PLATFORMS=cpu python tools/jax_step_parity.py \\
        [--after 0 1 11 23 35 45] [--tail 0 1 20 46] [--fb-witness 0 32] \\
        [--seed 12345] [--carry]

On an 8-core x86 CPU the JAX run over the ring takes 6-9 min; then each
step takes about 1 min alone (3-4 min with three such processes side by
side), and each tail about 2 min a frame.  The lines this printed for the
ring's seeds are kept in docs/step_parity/ring47_seed<seed>.jsonl.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
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


def carry_diff(want: dict, got: dict, tol: float = 1e-4) -> dict:
    """Every leaf of the carry after a step (``leaves`` / ``carry_to_numpy``
    layout; the image pyramid and the key left out) where the two packages
    differ: integer and boolean leaves entry by entry, float leaves where
    an entry differs by more than ``tol`` times the leaf's largest
    magnitude.  Per leaf: the count of such entries, the first few
    (flat index, JAX's value, the port's), and for floats the largest
    difference."""
    def walk(w, g, name):
        if isinstance(w, dict):
            for k in w:
                if k in g and k not in ("prev_pyr", "key", "img"):
                    yield from walk(w[k], g[k], f"{name}.{k}" if name else k)
            return
        w, g = np.asarray(w), np.asarray(g)
        if w.shape != g.shape:
            yield name, {"shape": [list(w.shape), list(g.shape)]}
            return
        if np.issubdtype(w.dtype, np.floating):
            wf, gf = w.astype(np.float64), g.astype(np.float64)
            d = np.abs(np.nan_to_num(wf - gf, nan=np.inf))
            d[np.isnan(wf) & np.isnan(gf)] = 0.0
            bad = d > tol * max(np.abs(np.nan_to_num(wf)).max(initial=0.0),
                                1e-30)
        else:
            bad = w != g
        if bad.any():
            idx = np.flatnonzero(bad)
            yield name, {"n": int(idx.size), "first": [
                [int(i), w.flat[i].item(), g.flat[i].item()]
                for i in idx[:6]],
                **({"max_abs": float(d.max())}
                   if np.issubdtype(w.dtype, np.floating) else {})}

    return dict(walk(want, got, ""))


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


def _fb_pass(level, xp, pyr0, pyr1, pts, valid, kc, fb_thresh):
    """``lk_track_fb`` written out over one package's ``_lk_level``
    (``level``; ``xp`` its array module), so that it runs in the dtype of
    its inputs: per track the forward position, the forward-backward error
    and the keep decision."""
    def track(p0, p1, q, ok):
        v = q * 0
        for L in range(kc.pyr_levels - 1, -1, -1):
            v = level(p0[L], p1[L], q / float(2 ** L), v, kc.iters,
                      kc.win_radius, 1e-4)
            if L > 0:
                v = v * 2.0
        new = q + v
        H, W = p1[0].shape[-2:]
        b = float(kc.win_radius)
        return new, ok & ((new[:, 0] >= b) & (new[:, 0] < W - b)
                          & (new[:, 1] >= b) & (new[:, 1] < H - b))

    fwd, ok_f = track(pyr0, pyr1, pts, valid)
    back, ok_b = track(pyr1, pyr0, fwd, ok_f)
    fb = xp.sqrt(((back - pts) ** 2).sum(-1))
    return (np.asarray(fwd, np.float64), np.asarray(fb, np.float64),
            np.asarray(ok_f & ok_b & (fb < fb_thresh)))


def fb_witness(k: int, before: dict, g, cfg_t, n_slots: int = 8) -> dict:
    """The tracker's forward-backward pass of step ``k -> k + 1`` from the
    JAX carry ``before``, in each package (its own pyramid of frame
    ``k + 1``, JAX's of frame ``k``) in float32 and in float64 (the same
    float32 pyramids and positions, upcast): how many valid tracks each
    keeps, how many keep decisions differ between each two of the four,
    and for the tracks where any two differ (the first ``n_slots``) the
    four FB errors, decisions and forward positions.  The gate is
    ``fb < cfg.klt.fb_thresh``."""
    from sfm_tpu.ops import klt as jklt
    from sfm_tpu_torch.ops import klt as tklt

    kc = cfg_t.klt
    pyr0 = [np.asarray(p, np.float32) for p in before["prev_pyr"]]
    pos = np.asarray(before["trk"]["pos"], np.float32)
    valid = np.asarray(before["trk"]["valid"])
    pyr1_j = [np.asarray(p) for p in jsp._build_pyr(jnp.asarray(g),
                                                     kc.pyr_levels)]
    with torch.no_grad():
        pyr1_t = [p.numpy() for p in sp._build_pyr(
            torch.as_tensor(g.copy()), kc.pyr_levels)]
    out = {}
    for dt in (np.float32, np.float64):
        name = "32" if dt == np.float32 else "64"
        with jax.enable_x64(dt == np.float64):
            out["jax" + name] = _fb_pass(
                jklt._lk_level, jnp, [jnp.asarray(p, dt) for p in pyr0],
                [jnp.asarray(p, dt) for p in pyr1_j], jnp.asarray(pos, dt),
                jnp.asarray(valid), kc, kc.fb_thresh)
        with torch.no_grad():
            tt = {np.float32: torch.float32, np.float64: torch.float64}[dt]
            out["port" + name] = _fb_pass(
                tklt._lk_level, torch,
                [torch.as_tensor(p).to(tt) for p in pyr0],
                [torch.as_tensor(p).to(tt) for p in pyr1_t],
                torch.as_tensor(pos).to(tt), torch.as_tensor(valid), kc,
                kc.fb_thresh)
    names = list(out)
    keep = {n: out[n][2] & valid for n in names}
    any_differ = np.zeros_like(valid)
    differ = {}
    for i, a in enumerate(names):
        for b in names[i + 1:]:
            d = keep[a] != keep[b]
            differ[f"{a}_{b}"] = int(d.sum())
            any_differ |= d
    slots = [{"slot": int(t),
              "fb": {n: float(out[n][1][t]) for n in names},
              "keep": {n: bool(keep[n][t]) for n in names},
              "fwd": {n: out[n][0][t].tolist() for n in names}}
             for t in np.flatnonzero(any_differ)[:n_slots]]
    return {"fb_witness": f"{k}->{k + 1}", "gate": kc.fb_thresh,
            "valid": int(valid.sum()),
            "pyr1_max_abs_diff": max(float(np.abs(a - b).max())
                                     for a, b in zip(pyr1_j, pyr1_t)),
            "kept": {n: int(keep[n].sum()) for n in names},
            "decisions_differ": differ, "slots": slots}


def compare_tail(ds, cfg_j, cfg_t, ck: Path, k_tail: int,
                 part: float = 0.01) -> dict:
    """Both packages from the checkpoint ``ck`` (the JAX run after frame
    ``n - 1 - k_tail``) frame by frame over the last ``k_tail`` frames, the
    port with the JAX package's draws, then ``finalize``.  After every
    frame it prints one line with the largest keyframe-centre difference
    over the trajectory's extent (``center_over_extent``), the track slots
    whose validity or id differ, and both map sizes; at the first frame
    where the centres part by more than ``part`` of the extent, that line
    also carries ``carry_diff`` of the two carries.  Returns the final
    comparison: the odometry ATE ratio at the checkpoint, both ATE ratios,
    loop edges, map sizes and the largest keyframe-centre difference."""
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
    gtc = np.stack([r.center for r in ds.records])
    extent = float(np.linalg.norm(gtc - gtc.mean(0), axis=1).max())
    parted = False
    for i in range(n - k_tail, n):
        js.process(i, ds.records[i].img, ds.load_gray(i))
        with torch.no_grad():
            ts.process(i, ds.records[i].img, ds.load_gray(i))
        want, got = leaves(js.carry), sp.carry_to_numpy(ts.carry)
        nk = min(int(want["kf_count"]), int(got["kf_count"]))
        dc = float(np.linalg.norm(want["ring"]["t_cw"][:nk].astype(
            np.float64) - got["ring"]["t_cw"][:nk], axis=1).max())
        line = {"tail": k_tail, "frame": i,
                "keyframes": [int(want["kf_count"]), int(got["kf_count"])],
                "center_over_extent": dc / extent,
                "track_slots_differ": int(np.sum(
                    (want["trk"]["valid"] != got["trk"]["valid"])
                    | (want["trk"]["ids"] != got["trk"]["ids"]))),
                "map_points": [int(want["n_pts"]), int(got["n_pts"])]}
        if not parted and dc / extent > part:
            parted = True
            line["carry_diff"] = carry_diff(want, got)
        print(json.dumps(line), flush=True)
    js.finalize()
    with torch.no_grad():
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
    ap.add_argument("--fb-witness", type=int, nargs="*", default=[],
                    metavar="K",
                    help="the tracker's forward-backward pass of step "
                         "K -> K+1 from the JAX carry, both packages in "
                         "float32 and float64 (fb_witness)")
    ap.add_argument("--carry", action="store_true",
                    help="also print, per step, every carry leaf where the "
                         "two packages differ (carry_diff)")
    args = ap.parse_args()
    after = sorted(set(args.after))

    cfg_j = jconfig.load_config(None, overrides=cs.SMOKE_OVERRIDES)
    cfg_j = dataclasses.replace(
        cfg_j, ransac=dataclasses.replace(cfg_j.ransac, seed=args.seed))
    cfg_t = config.load_config(None, overrides=cs.SMOKE_OVERRIDES)
    cfg_t = dataclasses.replace(
        cfg_t, ransac=dataclasses.replace(cfg_t.ransac, seed=args.seed))
    spec = SyntheticRingSpec(**dataclasses.asdict(cs.ring_spec()))
    if "OMP_NUM_THREADS" not in os.environ:  # set it to run several
        torch.set_num_threads(8)                # side by side
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
            if i in after or i in args.fb_witness:
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
            want, got = leaves(carry), sp.carry_to_numpy(ct)
            line = compare(k, before, want, np.asarray(ys[0], np.float64),
                           got, yt.numpy().astype(np.float64))
            if args.carry:
                line["carry"] = carry_diff(want, got)
            print(json.dumps(line), flush=True)
        for k in sorted(set(args.fb_witness)):
            print(json.dumps(fb_witness(k, snaps[k], ds.load_gray(k + 1),
                                        cfg_t)), flush=True)
        for k_tail in sorted(set(args.tail)):
            print(json.dumps(compare_tail(ds, cfg_j, cfg_t,
                                          Path(tmp) / f"tail{k_tail}",
                                          k_tail)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

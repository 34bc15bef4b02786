"""The comparison that decides ``correct``.

Answers, once the window has closed:

- each sequence of the window (each scene of a multi-scene batch), and
  the traced run's extra sequence where it ran to its end: its exported keyframe centres, pose-graph edges and sparse map against
  the renderer's ground truth (``ate_ratio``, ``edge_rot_med_deg``,
  ``map_cyl_med_rel``; limits the configuration states);
- each tracker call sampled in the window: the positions and the
  forward-backward gate the program handed back against the plain
  reference's, tracked again from the raw frames (``track_err_p99_px``:
  the 99th percentile of the distance over the tracks both keep, which a
  float32 kernel holds to a few ulps of a position and a lower precision
  or a shifted or dropped share of the tracks does not), and
  ``gate_flip_share``: the share of the tracks handed in on which the
  program's gate and the reference's disagree, pooled over every sampled
  call of the run (a gate that drops or keeps tracks wrongly, which the
  distance over the tracks both keep cannot see).  Their limits are set
  from readings, in ``portbench/cells/<workload>.json``.

Every number is the worst over the answers; each is printed beside its
limit.
"""

from __future__ import annotations

import hashlib

import numpy as np

from portbench import reference

FILES = ("keyframes_camera_centers.csv", "posegraph_edges.csv",
         "templeRing_sparse_points.ply")


def grade_sequence(out_dir, scene: dict) -> dict:
    """The numbers of one exported sequence; raises where an answer is
    missing or malformed (the caller counts that as a failed answer)."""
    kf_ids, fr, C = reference.read_centres(out_dir / FILES[0])
    if len(C) < 3 or not np.isfinite(C).all():
        raise ValueError(f"{len(C)} keyframes, finite: "
                         f"{bool(np.isfinite(C).all())}")
    ring_idx = np.asarray(scene["frames"])[fr]
    gt_C = scene["gt_C"][ring_idx]
    kf_frame = dict(zip(kf_ids.tolist(), ring_idx.tolist()))
    edges = reference.read_edges(out_dir / FILES[1])
    X = reference.read_ply(out_dir / FILES[2])
    if not edges or len(X) == 0:
        raise ValueError(f"{len(edges)} edges, {len(X)} map points")
    rot = reference.edge_rot_deg(edges, kf_frame, scene["gt_R"])
    cyl = reference.cylinder_rel(X, C, gt_C, scene["spec"].cylinder_radius)
    return {"ate_ratio": reference.ate_ratio(C, gt_C),
            "edge_rot_med_deg": float(np.median(rot)),
            "map_cyl_med_rel": float(np.median(cyl))}


def _frame_index(scenes: list[dict]) -> dict:
    idx = {}
    for sc in scenes:
        for img in sc["images"]:
            a = np.ascontiguousarray(img, np.uint8)
            idx[hashlib.sha1(a.tobytes()).hexdigest()] = a
    return idx


def _identify(img, index: dict):
    """The raw frame (of any scene: each has its own texture) whose
    float32 image ``img`` is, or None."""
    a = img.detach().to("cpu").float().numpy()
    u = np.clip(np.rint(a), 0, 255).astype(np.uint8)
    if not np.array_equal(u.astype(np.float32), a):
        return None
    return index.get(hashlib.sha1(u.tobytes()).hexdigest())


def grade_sample(smp: dict, scenes: list[dict], index: dict, device):
    """The numbers of each scene of one sampled tracker call whose frames
    were found, and the gate's (disagreements, tracks handed in) of each;
    [] where none was."""
    import torch

    out = []
    stacked = smp["img0"].dim() == 3
    n = smp["img0"].shape[0] if stacked else 1
    for s in range(n):
        pick = (lambda x: x[s]) if stacked else (lambda x: x)
        raw0 = _identify(pick(smp["img0"]), index)
        raw1 = _identify(pick(smp["img1"]), index)
        if raw0 is None or raw1 is None:
            continue
        L = smp["levels"]
        pts = pick(smp["pts"]).to(device=device, dtype=torch.float32)
        valid = pick(smp["valid"]).to(device).bool()
        fwd_ref, ok_ref = reference.track_fb(
            reference.pyramid(raw0, L, device),
            reference.pyramid(raw1, L, device), pts, valid, L,
            smp["iters"], smp["radius"], smp["fb_thresh"])
        fwd = pick(smp["fwd"]).to(device=device, dtype=torch.float32)
        ok = pick(smp["ok"]).to(device).bool()
        both = valid & ok & ok_ref
        if int(valid.sum()) == 0 or int(both.sum()) == 0:
            continue
        err = torch.linalg.vector_norm(fwd - fwd_ref, dim=-1)[both].double()
        flips = int((valid & (ok != ok_ref)).sum())
        out.append(({"track_err_p99_px": float(torch.quantile(err, 0.99))},
                    (flips, int(valid.sum()))))
    return out


def judge(answers, samples, scenes, cell, ctx) -> dict:
    import torch

    limits = {**cell.config.get("guarantees", {}), **cell.limits}
    worst: dict = {}
    failed, lines = 0, []

    def note(vals: dict) -> bool:
        bad = False
        for k, v in vals.items():
            worst[k] = max(worst.get(k, -np.inf), v)
            lim = limits.get(k)  # a number with no limit fails
            bad |= not (np.isfinite(v) and lim is not None and v <= lim)
        return bad

    n_seq = 0
    for out_dir, sc in answers:
        try:
            vals = grade_sequence(out_dir, sc)
        except (OSError, ValueError, IndexError, KeyError) as e:
            lines.append(f"answer {out_dir.name}: unreadable ({e})")
            failed += 1
            continue
        n_seq += 1
        failed += note(vals)
    index = _frame_index(scenes)
    n_track, flips, handed = 0, 0, 0
    torch.backends.cuda.matmul.allow_tf32 = False
    for smp in samples:
        for vals, (f, n) in grade_sample(smp, scenes, index, ctx.device):
            n_track += 1
            failed += note(vals)
            flips += f
            handed += n
    if handed:
        failed += note({"gate_flip_share": flips / handed})
    attempted = len(answers) + n_track
    numbers = {k: {"value": worst[k], "limit": limits.get(k)}
               for k in sorted(worst)}
    numbers["sequences"] = {"value": n_seq, "at_least": 1}
    numbers["tracker_calls"] = {"value": n_track, "at_least": 1}
    correct = failed == 0 and n_seq >= 1 and n_track >= 1
    for k, v in numbers.items():
        lim = (f"limit {v['limit']!r}" if "limit" in v
               else f"at least {v['at_least']}")
        lines.append(f"check {k} {v['value']!r} {lim}")
    lines.append(f"correct {correct} attempted {attempted} failed {failed}")
    return {"correct": correct, "attempted": attempted, "failed": failed,
            "numbers": numbers, "lines": lines}

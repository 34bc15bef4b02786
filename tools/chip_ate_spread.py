"""How far the trajectory error and the keyframe-edge errors of the 47-frame
ring move with the RANSAC draws alone, on a CUDA card.

The pipeline is chaotic: one track more or less at one frame moves every
later pose.  This runs ``chip_smoke.py``'s ring47 configuration
(``smoke_config()``, ``ring_spec()``) through ``ScanSfM`` and through
``SfMSystem`` once per RANSAC seed and prints one JSON line per run (Sim(3)
ATE over the trajectory's extent, keyframes, map points, loop edges, the
keyframe edges' median and max rotation and direction errors against GT
as ``chip_smoke.edge_errors_on_card`` computes them, wall seconds), then
the card's name and power limit, then one ``COMPARE`` JSON line per
pipeline against the JAX package's ATE over its own seeds on the CPU
(``chip_smoke.ATE_SEEDS_JAX_CPU``, from ``tools/jax_ring47_edges.py
--seeds``): each side's median, min and max, the ratio of the medians, the
one-sided Mann-Whitney U p-value of the port's being greater, and the
parity rule's verdict (PERF.md, Findings, the port's ATE over RANSAC
seeds): p >= 0.05 and the port's median <= 1.25x JAX's, with >= 30
keyframes, the loop edge (0, 46) and map points within 5 % of JAX's
median on every seed of the port.  A
seed labels a draw on each side and does not repeat it.  The spread over
seeds is the yardstick for an ATE or edge-error difference between two
runs that do not share their draws.

    python3 tools/chip_ate_spread.py --seeds 12345 12346 ... 12352
    python3 tools/chip_ate_spread.py --compare LOG   # no card: the
        COMPARE lines of the JSON lines a run printed into LOG

Needs one CUDA card and ``nvcc``.  One seed takes about 70 s on an NVIDIA
H100 80GB HBM3 (ScanSfM ~20-25 s, SfMSystem ~35-45 s), after a build and
warm-up run of about 2 min.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402
from tools import jax_draws  # noqa: E402


# the parity rule (PERF.md, Findings: the port's ATE over RANSAC seeds)
PARITY_P_MIN = 0.05
PARITY_MEDIAN_RATIO_MAX = 1.25
PARITY_MAP_POINTS_SHARE = 0.05


def compare(runs: list[dict]) -> list[dict]:
    """One verdict per pipeline of the port's runs ``runs`` (this tool's
    JSON lines) against the JAX package's seeds."""
    out = []
    for name, key in (("scan", "pipeline"), ("host", "host")):
        mine = [r for r in runs if r.get("pipeline") == name]
        ref = cs.ATE_SEEDS_JAX_CPU[key]
        if not mine or not ref:
            continue
        stats = cs.ate_seed_stats([r["ate_ratio"] for r in mine],
                                  ref.values())
        pts = cs.MAP_POINTS_JAX_CPU[key]
        agree = {
            "keyframes": all(r["keyframes"] >= 30 for r in mine),
            "loop_edge": all(cs.RING_LOOP_EDGE
                             in [tuple(e) for e in r["loop_edges"]]
                             for r in mine),
            "map_points": all(abs(r["map_points"] - pts)
                              <= PARITY_MAP_POINTS_SHARE * pts
                              for r in mine)}
        rule = {"p": stats["p_port_greater"] >= PARITY_P_MIN,
                "median_ratio": stats["median_ratio"]
                <= PARITY_MEDIAN_RATIO_MAX, **agree}
        out.append({"compare": name, "port_seeds": [r["seed"] for r in mine],
                    "jax_seeds": sorted(ref), **stats,
                    "map_points_jax_median": pts, "rule": rule,
                    "parity": all(rule.values())})
    return out


def record_runs(sp) -> dict:
    """Wrap a ScanSfM module's ``run_chunk`` and ``ScanSfM._pose_graph_solve``
    so that each run's per-frame metrics rows (``Y_*`` columns) and the
    keyframe centres that each pose-graph solve starts from are kept in
    the returned dict (``rows``, ``pre_pg``), for ``dump_run``.  Used on
    both packages' modules (tools/jax_ring47_edges.py --dump)."""
    rec = {"rows": [], "pre_pg": []}
    run_chunk, solve = sp.run_chunk, sp.ScanSfM._pose_graph_solve

    def run_chunk_rec(*a, **k):
        carry, ys = run_chunk(*a, **k)
        y = np.asarray(ys.cpu() if hasattr(ys, "cpu") else ys, np.float64)
        rec["rows"].extend(r.tolist() for r in y if r[sp.Y_VALID] > 0.5)
        return carry, ys

    def solve_rec(self, pr):
        n = pr["n_kf"]
        rec["pre_pg"].append(
            [[int(f), *map(float, c)]
             for f, c in zip(pr["frame"][:n], pr["t_cw"][:n])])
        return solve(self, pr)

    sp.run_chunk, sp.ScanSfM._pose_graph_solve = run_chunk_rec, solve_rec
    return rec


def dump_run(path: Path, s, rec: dict) -> None:
    """A run's metrics rows, the keyframe centres of its pose-graph
    solves' starts and its final keyframe centres ([frame, x, y, z]), as
    JSON; ``rec`` is emptied for the next run."""
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps({
        **rec,
        "centers": [[kf.frame_idx, *map(float, kf.center)] for kf in s.kfs],
    }))
    rec["rows"], rec["pre_pg"] = [], []


DUMP_COLUMNS = ("Y_INL", "Y_EDGE_INL", "Y_SCALE", "Y_PNP_INL", "Y_NEW_PTS",
                "Y_BA0", "Y_BA1")


def compare_dumps(dirs: list[str]) -> list[dict]:
    """Per seed, side by side for each dump directory (``--dump`` of this
    tool or of tools/jax_ring47_edges.py): the ATE ratio of the keyframe
    centres each pose-graph solve started from (the odometry) and of the
    final centres, the medians over keyframes of the metrics rows'
    columns DUMP_COLUMNS, and the loop rows (old keyframe, new keyframe,
    inliers, relative scale)."""
    from sfm_tpu_torch.models import scan_pipeline as sp

    with tempfile.TemporaryDirectory(prefix="sfm_dumps_") as tmp:
        ds, _, _ = cs.ring_dataset(Path(tmp))

    def ate(cs_):
        a = np.asarray(cs_, np.float64)
        return cs.centers_ate_ratio(list(a[:, 1:]), a[:, 0].astype(int), ds)

    out = []
    names = sorted({f.name for d in dirs for f in Path(d).glob("*.json")})
    for name in names:
        row = {"run": name}
        for d in dirs:
            f = Path(d) / name
            if not f.exists():
                continue
            j = json.loads(f.read_text())
            y = np.asarray(j["rows"], np.float64)
            kf = y[y[:, sp.Y_KF] > 0.5]
            lv = y[y[:, sp.Y_LV_OK] > 0.5]
            row[d] = {
                "ate_ratio_pre_pose_graph": [ate(c) for c in j["pre_pg"]],
                "ate_ratio": ate(j["centers"]),
                **{c.lower(): float(np.median(kf[:, getattr(sp, c)]))
                   for c in DUMP_COLUMNS},
                "loops": lv[:, [sp.Y_LV_I, sp.Y_KFID, sp.Y_LV_INL,
                                sp.Y_LV_SREL]].tolist()}
        out.append(row)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, nargs="+",
                    default=[12345, 12346, 12347, 12348, 12349])
    ap.add_argument("--pipelines", nargs="+", default=["scan", "host"],
                    choices=["scan", "host"])
    ap.add_argument("--jax-draws", action="store_true",
                    help="ScanSfM with the JAX package's draws for each "
                         "seed (tools/jax_draws.py) in place of the "
                         "port's generator: a seed then names the same "
                         "draws on both sides")
    ap.add_argument("--dump", metavar="DIR", default=None,
                    help="also write each ScanSfM run's metrics rows and "
                         "keyframe centres to DIR/scan<seed>.json")
    ap.add_argument("--compare", metavar="LOG", default=None,
                    help="no runs: compare the JSON lines in LOG")
    ap.add_argument("--compare-dumps", metavar="DIR", nargs="+",
                    default=None,
                    help="no runs: compare --dump directories run by run")
    args = ap.parse_args()
    if args.compare_dumps:
        for c in compare_dumps(args.compare_dumps):
            print("DUMPS", json.dumps(c), flush=True)
        return 0
    if args.compare:
        runs = [json.loads(ln) for ln in open(args.compare)
                if ln.startswith('{"pipeline"')]
        for c in compare(runs):
            print("COMPARE", json.dumps(c), flush=True)
        return 0
    if not torch.cuda.is_available():
        print("chip_ate_spread: no CUDA device available", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    import sfm_tpu_torch  # noqa: F401  (sets the precision policy)
    base = cs.smoke_config()
    runs = []
    if args.dump:
        from sfm_tpu_torch.models import scan_pipeline

        rec = record_runs(scan_pipeline)
    with tempfile.TemporaryDirectory(prefix="sfm_spread_") as tmp, \
            torch.no_grad():
        tmp = Path(tmp)
        ds, frames, names = cs.ring_dataset(tmp)
        cs.run_pipeline(dev, ds.K, frames, names, tmp / "warm")  # warm-up
        if args.dump:
            rec["rows"], rec["pre_pg"] = [], []
        for seed in args.seeds:
            cfg = dataclasses.replace(
                base, ransac=dataclasses.replace(base.ransac, seed=seed))
            for name in args.pipelines:
                out = tmp / f"{name}{seed}"
                if name == "scan":
                    pri = (jax_draws.scan_draws(
                        seed, cfg.ransac.num_hypotheses,
                        cfg.klt.max_tracks, device=dev)
                        if args.jax_draws else None)
                    s, info, dt, _ = cs.run_pipeline(dev, ds.K, frames,
                                                     names, out, cfg, pri)
                else:
                    s, info, dt, _ = cs.run_host(dev, ds, frames, out, cfg)
                runs.append({
                    "pipeline": name, "seed": seed,
                    "jax_draws": args.jax_draws and name == "scan",
                    "ate_ratio": cs.ate_ratio(s.kfs, ds),
                    "keyframes": info["keyframes"],
                    "map_points": info["map_points"],
                    "loop_edges": [(e.i, e.j) for e in s.edges if e.is_loop],
                    **cs.edge_errors_on_card(dev, s, ds),
                    "wall_s": dt})
                print(json.dumps(runs[-1]), flush=True)
                if args.dump and name == "scan":
                    dump_run(Path(args.dump) / f"{name}{seed}.json", s, rec)
    print(cs.nvidia_smi_line(), flush=True)
    for c in compare(runs):
        print("COMPARE", json.dumps(c), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

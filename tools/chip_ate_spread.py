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

Each JSON line also carries the run's K3 and K1 launch counts (set to 0
just before the run) and a SHA-1 of its keyframe centres' bytes, so two
runs can be shown bit for bit equal.  ``--jax-draws`` runs ``ScanSfM``
with the JAX package's draws (tools/jax_draws.py), so that a seed names
the same draws as ``tools/jax_ring47_edges.py``'s.  ``--swap k3``, ``k1``
or ``k3+k1`` runs the plain PyTorch version in place of K3
(``lk_level_fused``), K1 (``shi_tomasi_score``) or both, on the card, in
this process only (``swapped``): a difference between a run and its
swapped twin is that kernel's, and the swapped kernel shows 0 launches.
``--device cpu`` makes the same runs on the CPU.  ``--ring-seeds``
renders the ring with other texture seeds under the same cameras, so that
the tracker, which reads images and not poses, runs on other images: the
seeds of one ring share one tracker run.  ``--dump DIR`` writes each
``ScanSfM`` run's metrics rows and the poses each pose-graph solve starts
from; ``--compare-dumps DIR_REF DIR --paired`` (no card) then holds DIR
against DIR_REF, run by run, frame by frame and keyframe edge by keyframe
edge (``compare_paired``), and ``--compare LOG --against REF_LOG`` pairs
two sets of runs by texture and seed (``compare_runs``).

Needs one CUDA card and ``nvcc``, but for ``--device cpu``.  One seed
takes about 70 s on an NVIDIA H100 80GB HBM3 (ScanSfM ~20-25 s, SfMSystem
~35-45 s), after a build and warm-up run of about 2 min.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import hashlib
import importlib
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

# --swap: a kernel's route (module, wrapper, plain version) that this
# process rebinds to the plain version, on CUDA tensors too
SWAPS = {
    "k3": ("sfm_tpu_torch.ops.kernels.lk_kernels", "lk_level_fused",
           "lk_level_plain"),
    "k1": ("sfm_tpu_torch.ops.kernels.shi_tomasi_kernel",
           "shi_tomasi_score", "shi_tomasi_score_plain"),
}
SWAP_CHOICES = ("k3", "k1", "k3+k1")


@contextlib.contextmanager
def swapped(spec: str | None):
    """Within the block, the kernels that ``spec`` names ("k3", "k1",
    "k3+k1"; None: none) are replaced by their plain versions for every
    tensor, a CUDA tensor included: the wrapper's module attribute, which
    its callers look up at each call, is rebound to the plain version in
    this process's module.  Nothing is read from the environment or
    written anywhere else, and the kernels' routes are back on leaving the
    block."""
    saved = []
    try:
        for name in (spec.split("+") if spec else []):
            mod_name, route, plain = SWAPS[name]
            mod = importlib.import_module(mod_name)
            saved.append((mod, route, getattr(mod, route)))
            setattr(mod, route, getattr(mod, plain))
        yield
    finally:
        for mod, route, fn in reversed(saved):
            setattr(mod, route, fn)


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
    keyframe centres and rotations that each pose-graph solve starts from
    ([frame, c_x, c_y, c_z, R_cw row-major]) are kept in the returned dict
    (``rows``, ``pre_pg``), for ``dump_run``.  Used on
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
            [[int(f), *map(float, c), *map(float, np.ravel(R))]
             for f, c, R in zip(pr["frame"][:n], pr["t_cw"][:n],
                                pr["R_cw"][:n])])
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


def detectable_ratio(ref, mine) -> dict:
    """The ratio of ``mine`` over ``ref`` that a one-sided rank test at p
    0.05 finds with power 0.8 over these many runs at their spread, in the
    normal approximation: exp((z_0.95 + z_0.8) x se / sqrt(3 / pi)), se
    the standard error of the mean log ratio (``paired``: over the pairs'
    log ratios; ``unpaired``: of the difference of the two sides' mean
    logs) and 3 / pi the rank tests' efficiency against the t test on
    normal data."""
    la = np.log(np.asarray(ref, np.float64))
    lb = np.log(np.asarray(mine, np.float64))
    n = len(la)
    se = {"paired": np.std(lb - la, ddof=1) / np.sqrt(n),
          "unpaired": np.sqrt((np.var(la, ddof=1) + np.var(lb, ddof=1))
                              / n)}
    z = 1.6448536269514722 + 0.8416212335729143
    return {k: float(np.exp(z * v / np.sqrt(3.0 / np.pi)))
            for k, v in se.items()}


def compare_runs(ref: list[dict], runs: list[dict]) -> dict:
    """The ScanSfM runs ``runs`` against the reference's ``ref`` (JSON
    lines of this tool or of tools/jax_ring47_edges.py), paired by (ring
    texture seed, RANSAC seed): the pairs' ATE ratios, paired_stat of the
    ATE ratios and of the map sizes, ate_seed_stats of the two sets, the
    pairs whose either side lacks the loop edge RING_LOOP_EDGE, and
    detectable_ratio of the ATE ratios."""
    def key(r):
        return (r.get("ring_seed", cs.ring_spec().seed), r["seed"])

    def loop(r):
        return cs.RING_LOOP_EDGE in [tuple(e) for e in r["loop_edges"]]

    a = {key(r): r for r in ref if r["pipeline"] == "scan"}
    b = {key(r): r for r in runs if r["pipeline"] == "scan"}
    keys = sorted(a.keys() & b.keys())
    pa = [a[k]["ate_ratio"] for k in keys]
    pb = [b[k]["ate_ratio"] for k in keys]
    return {"pairs": [[*k, x, y] for k, x, y in zip(keys, pa, pb)],
            "ate_ratio": paired_stat(pa, pb),
            "map_points": paired_stat([a[k]["map_points"] for k in keys],
                                      [b[k]["map_points"] for k in keys]),
            "no_loop_edge": [[*k, not loop(a[k]), not loop(b[k])]
                             for k in keys
                             if not (loop(a[k]) and loop(b[k]))],
            "detectable_ratio": detectable_ratio(pa, pb),
            **cs.ate_seed_stats(pb, pa)}


# --paired: the metrics rows' columns held frame by frame
PAIRED_COLUMNS = ("Y_ALIVE", "Y_INL", "Y_PNP_INL", "Y_NEW_PTS", "Y_NPTS")


def pre_pose_graph_edges(pre_pg: list, ds) -> dict:
    """The keyframe edges (frame i, frame j) of consecutive keyframes of the
    last pose-graph solve's start (``pre_pg[-1]``: [frame, c_x, c_y, c_z,
    R_cw row-major] per keyframe) against the GT cameras of ``ds``: per
    edge (baseline ratio, its distance from 1, rotation error, direction
    error); none without a solve.  The baseline
    ratio is |C_j - C_i| over GT's, divided by its median over the run's
    edges (one global scale); the errors (degrees) are
    ``ops.umeyama.edge_errors`` in float64."""
    from sfm_tpu_torch.ops import umeyama

    if not pre_pg:  # no pose-graph solve in the run
        return {}
    a = np.asarray(pre_pg[-1], np.float64)
    a = a[np.argsort(a[:, 0], kind="stable")]
    f = a[:, 0].astype(int)
    # the ring's R_cw holds the camera's axes in the world: x_cam =
    # R_cw^T (X - c), so world -> camera is its transpose
    C, R = a[:, 1:4], a[:, 4:13].reshape(-1, 3, 3).transpose(0, 2, 1)
    Rji = R[1:] @ R[:-1].transpose(0, 2, 1)
    tji = np.einsum("kab,kb->ka", R[1:], C[:-1] - C[1:])
    gt = [cs._rel_pose(ds, i, j) for i, j in zip(f[:-1], f[1:])]
    gtc = np.stack([ds.records[i].center for i in f])
    rot, dirn = (x.numpy() for x in umeyama.edge_errors(
        torch.as_tensor(Rji), torch.as_tensor(tji),
        torch.as_tensor(np.stack([g[0] for g in gt])),
        torch.as_tensor(np.stack([g[1] for g in gt]))))
    ratio = (np.linalg.norm(np.diff(C, axis=0), axis=1)
             / np.linalg.norm(np.diff(gtc, axis=0), axis=1))
    ratio = ratio / np.median(ratio)
    return {(int(i), int(j)): (float(b), abs(float(b) - 1.0), float(r),
                               float(d))
            for i, j, b, r, d in zip(f[:-1], f[1:], ratio, rot, dirn)}


def paired_stat(ref, mine) -> dict:
    """Pairs (``ref[k]``, ``mine[k]``): each side's median, the median of
    the signed differences mine - ref, and the two-sided Wilcoxon
    signed-rank p-value of those differences (``scipy.stats.wilcoxon``,
    zero differences dropped; 1.0 when every difference is zero)."""
    from scipy.stats import wilcoxon

    ref, mine = np.asarray(ref, np.float64), np.asarray(mine, np.float64)
    d = mine - ref
    p = (float(wilcoxon(d).pvalue) if np.any(d != 0) else 1.0)
    return {"n": int(d.size), "ref_median": float(np.median(ref)),
            "median": float(np.median(mine)),
            "median_diff": float(np.median(d)), "p": p}


def compare_paired(ref_dir: str, dir_: str, ds) -> list[dict]:
    """Two --dump directories run under the same draws (the reference
    ``ref_dir``, e.g. the JAX package's, and ``dir_``), run by run (file
    names both have), held pair by pair: the metrics rows' PAIRED_COLUMNS
    frame by frame (frames both rows have), the pre-pose-graph keyframe
    edges (pre_pose_graph_edges against ``ds``'s GT) edge by edge (frame
    pairs both have), and run by run the Sim(3) ATE ratio of the keyframe
    centres the last pose-graph solve started from (the odometry; runs
    with a solve on both sides).  One paired_stat per metric over the
    pooled pairs, and under ``per_run`` one over the runs of each side's
    median in the run: frames and edges of one run are not independent
    samples, runs on other textures are."""
    from sfm_tpu_torch.models import scan_pipeline as sp

    names = sorted({f.name for f in Path(ref_dir).glob("*.json")}
                   & {f.name for f in Path(dir_).glob("*.json")})
    cols = [getattr(sp, c) for c in PAIRED_COLUMNS]
    keys = [c.lower() for c in PAIRED_COLUMNS] + [
        "edge_baseline_ratio", "edge_baseline_dev", "edge_rot_deg",
        "edge_dir_deg", "ate_ratio_pre_pose_graph"]
    pairs = {k: ([], []) for k in keys}
    per_run = {k: ([], []) for k in keys}
    for name in names:
        a, b = (json.loads((Path(d) / name).read_text())
                for d in (ref_dir, dir_))
        run = {k: ([], []) for k in keys}
        rows = [{int(r[sp.Y_FRAME]): r for r in j["rows"]} for j in (a, b)]
        for fr in sorted(rows[0].keys() & rows[1].keys()):
            for k, c in zip(keys, cols):
                run[k][0].append(rows[0][fr][c])
                run[k][1].append(rows[1][fr][c])
        ea, eb = (pre_pose_graph_edges(j["pre_pg"], ds) for j in (a, b))
        for e in sorted(ea.keys() & eb.keys()):
            for n, k in enumerate(keys[len(cols):-1]):
                run[k][0].append(ea[e][n])
                run[k][1].append(eb[e][n])
        if a["pre_pg"] and b["pre_pg"]:
            for side, j in enumerate((a, b)):
                c = np.asarray(j["pre_pg"][-1], np.float64)
                run[keys[-1]][side].append(cs.centers_ate_ratio(
                    list(c[:, 1:4]), c[:, 0].astype(int), ds))
        for k in keys:
            if run[k][0]:
                for side in (0, 1):
                    pairs[k][side].extend(run[k][side])
                    per_run[k][side].append(float(np.median(run[k][side])))
    # the baseline ratio is over its run's median, so its per-run median
    # is 1 on both sides by definition
    return [{"metric": k, "runs": names, **paired_stat(*pairs[k]),
             "per_run": None if k == "edge_baseline_ratio"
             else paired_stat(*per_run[k])} for k in keys]


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
    ap.add_argument("--against", metavar="LOG", default=None,
                    help="with --compare: hold the runs in LOG (e.g. "
                         "tools/jax_ring47_edges.py's lines) run by run, "
                         "paired by ring and RANSAC seed")
    ap.add_argument("--compare-dumps", metavar="DIR", nargs=2,
                    default=None,
                    help="DIR_REF DIR, with --paired (no runs): two --dump "
                         "directories run by run")
    ap.add_argument("--paired", action="store_true",
                    help="with --compare-dumps DIR_REF DIR: the metrics "
                         "rows frame by frame, the pre-pose-graph keyframe "
                         "edges edge by edge and the odometry ATE run by "
                         "run, DIR against DIR_REF (signed median "
                         "difference, Wilcoxon p)")
    ap.add_argument("--swap", choices=SWAP_CHOICES, default=None,
                    help="in this process only, run the plain version in "
                         "place of K3 (lk_level_fused), K1 "
                         "(shi_tomasi_score) or both, on the card too")
    ap.add_argument("--ring-seeds", type=int, nargs="+", default=None,
                    help="texture seeds of the ring (default: the ring's "
                         "own, 7): each renders another cylinder texture "
                         "under the same cameras, so the tracker runs on "
                         "other images")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="cpu: the same runs on the CPU (plain versions of "
                         "every kernel, no warm-up run; about 11 min a "
                         "ScanSfM run with four such processes of two "
                         "threads each on 8 x86 cores)")
    args = ap.parse_args()
    if args.paired or args.compare_dumps:
        if not (args.paired and args.compare_dumps):
            ap.error("dumps are compared as --compare-dumps DIR_REF DIR "
                     "--paired")
        ds, _, _ = cs.ring_dataset()
        for c in compare_paired(*args.compare_dumps, ds):
            print("PAIRED", json.dumps(c), flush=True)
        return 0
    if args.compare:
        runs = [json.loads(ln) for ln in open(args.compare)
                if ln.startswith('{"pipeline"')]
        if args.against:
            ref = [json.loads(ln) for ln in open(args.against)
                   if ln.startswith('{"pipeline"')]
            print("PAIRED_ATE", json.dumps(compare_runs(ref, runs)),
                  flush=True)
            return 0
        for c in compare(runs):
            print("COMPARE", json.dumps(c), flush=True)
        return 0
    if args.device == "cuda" and not torch.cuda.is_available():
        print("chip_ate_spread: no CUDA device available", file=sys.stderr)
        return 1
    dev = torch.device(args.device, 0 if args.device == "cuda" else None)
    import sfm_tpu_torch  # noqa: F401  (sets the precision policy)
    base = cs.smoke_config()
    runs, rec = [], None
    if args.dump:
        from sfm_tpu_torch.models import scan_pipeline

        rec = record_runs(scan_pipeline)
    ring0 = cs.ring_spec().seed
    with tempfile.TemporaryDirectory(prefix="sfm_spread_") as tmp, \
            torch.no_grad(), swapped(args.swap):
        tmp = Path(tmp)
        for ring in args.ring_seeds or [ring0]:
            ds, frames, names = cs.ring_dataset(ring)
            if dev.type == "cuda" and not runs:  # warm-up
                cs.run_pipeline(dev, ds.K, frames, names, tmp / "warm")
            if args.dump:
                rec["rows"], rec["pre_pg"] = [], []
            for seed in args.seeds:
                runs.extend(seed_runs(args, dev, base, ds, frames, names,
                                      tmp, ring, seed, rec))
    print(cs.nvidia_smi_line() if dev.type == "cuda" else "device: cpu",
          flush=True)
    for c in compare([r for r in runs if r["ring_seed"] == ring0]):
        print("COMPARE", json.dumps(c), flush=True)
    return 0


def seed_runs(args, dev, base, ds, frames, names, tmp: Path, ring: int,
              seed: int, rec) -> list[dict]:
    """The runs of ``args.pipelines`` on the ring ``ds`` (texture seed
    ``ring``) at RANSAC seed ``seed``: one JSON line each, printed, and
    for ``ScanSfM`` its dump under ``args.dump`` (``scan<seed>.json`` on
    the default ring, ``scan<seed>_ring<ring>.json`` on another)."""
    cfg = dataclasses.replace(
        base, ransac=dataclasses.replace(base.ransac, seed=seed))
    suffix = "" if ring == cs.ring_spec().seed else f"_ring{ring}"
    runs = []
    for name in args.pipelines:
        out = tmp / f"{name}{seed}{suffix}"
        cs.reset_launches()
        if name == "scan":
            pri = (jax_draws.scan_draws(
                seed, cfg.ransac.num_hypotheses, cfg.klt.max_tracks,
                device=dev) if args.jax_draws else None)
            s, info, dt, _ = cs.run_pipeline(dev, ds.K, frames, names, out,
                                             cfg, pri)
        else:
            s, info, dt, _ = cs.run_host(dev, ds, frames, out, cfg)
        counts = cs.read_launches()
        runs.append({
            "pipeline": name, "seed": seed, "ring_seed": ring,
            "jax_draws": args.jax_draws and name == "scan",
            "swap": args.swap,
            "launches": {"k3": counts["lk_level_fused"],
                         "k1": counts["shi_tomasi_score"]},
            "ate_ratio": cs.ate_ratio(s.kfs, ds),
            "centers_sha1": hashlib.sha1(np.stack(
                [kf.center for kf in s.kfs]).tobytes()).hexdigest(),
            "keyframes": info["keyframes"],
            "map_points": info["map_points"],
            "loop_edges": [(e.i, e.j) for e in s.edges if e.is_loop],
            **cs.edge_errors_on_card(dev, s, ds),
            "wall_s": dt})
        print(json.dumps(runs[-1]), flush=True)
        if args.dump and name == "scan":
            dump_run(Path(args.dump) / f"{name}{seed}{suffix}.json", s, rec)
    return runs


if __name__ == "__main__":
    sys.exit(main())

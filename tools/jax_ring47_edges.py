"""The JAX package's own trajectory error and keyframe-edge errors on
``chip_smoke.py``'s ring, on the CPU, per RANSAC seed: the reference figures
beside which ``chip_smoke.py`` grades the port's edges and its ATE over
seeds (``EDGE_MEDIANS_JAX_CPU``, ``ATE_SEEDS_JAX_CPU``).

Renders ``chip_smoke.ring_spec()`` (the 47-frame 640x480 360-degree ring)
with the JAX package's ``generate_dataset``, runs it through the JAX
package's ``ScanSfM`` and ``SfMSystem`` at ``chip_smoke.SMOKE_OVERRIDES``
(process, finalize, export) once per pipeline and RANSAC seed
(``cfg.ransac.seed``), and prints one JSON line per run: seed, keyframes,
map points, loop edges, Sim(3) ATE over the trajectory's extent, the
median and max rotation and direction errors (degrees) of every keyframe
edge against the ring's GT relative poses, by the JAX package's
``umeyama.edge_errors`` in float64, and wall seconds.  The draws are the
JAX package's own, so a run of the port does not repeat them: a seed
labels a draw on each side, and ``tools/chip_ate_spread.py`` compares the
two distributions.

    JAX_PLATFORMS=cpu python tools/jax_ring47_edges.py [scan] [host] \
        [--seeds 12345 12346 ...] [--ring-seeds 7 8 ...] [--dump DIR]

One run takes about 6 min (``scan``) or 9 min (``host``) alone on an
8-core x86 CPU, and about twice that with three such processes side by
side; the default is seed 12345 (the configuration's own).

The modes ``stockgate94``, ``structured_stock``, ``gtscale`` and
``hyp4096`` run bench.py's other configurations through the JAX package
on the CPU, as ``chip_smoke.py``'s ``variants`` phase runs them through
the port on the card, and print one JSON line per seed with the fields
that phase prints:

- ``stockgate94``: bench_dense_variant's 94-frame ring at the stock
  keyframe gate (``chip_smoke.stockgate_spec()``, ``VARIANT_OVERRIDES``);
  keyframes and their frame indices, skipped frames, ``edge_ransac_runs``
  (keyframes whose previous keyframe is not the previous frame), map
  points, loop edges, Sim(3) ATE ratio;
- ``structured_stock``: bench_stock_thresholds' structured-texture ring
  at the stock thresholds, the same fields;
- ``gtscale``: ``ring_spec()`` with ``use_gt_scale`` and the GT records:
  the same fields plus the Sim(3) and SE(3) ATE (RMSE and ratio) over all
  keyframes and over the first 4, and the Sim(3) alignment scale;
- ``hyp4096``: bench_hyp4096's pair stage on frames 0 and 1 of
  ``ring_spec()`` with the draws of ``jax.random.PRNGKey(seed)`` (default
  ``HYP_SEED`` = 0, the JAX bench's first call): inliers, tracked tracks,
  R, t, and the rotation and direction errors against the GT relative
  pose.

    JAX_PLATFORMS=cpu python tools/jax_ring47_edges.py stockgate94 \
        structured_stock gtscale hyp4096 [--seeds ...]

``docs/bench_variants/jax_cpu.jsonl`` keeps these lines (its README names
each command); ``chip_smoke.VARIANTS_JAX_CPU`` cites them.
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

import jax.numpy as jnp  # noqa: E402

import chip_smoke as cs  # noqa: E402
from tools import chip_ate_spread  # noqa: E402
from sfm_tpu import config as jconfig  # noqa: E402
from sfm_tpu.models import scan_pipeline as jsp, system as jsystem  # noqa: E402
from sfm_tpu.ops import umeyama  # noqa: E402
from sfm_tpu.utils.dataset import TempleRing  # noqa: E402
from sfm_tpu.utils.synthetic import (SyntheticRingSpec,  # noqa: E402
                                     generate_dataset)


def run(which: str, ds, seed: int, out_dir: Path):
    """One run of ``which`` at ``seed``: (the pipeline object, its JSON
    line)."""
    cfg = jconfig.load_config(None, overrides=cs.SMOKE_OVERRIDES)
    cfg = dataclasses.replace(
        cfg, ransac=dataclasses.replace(cfg.ransac, seed=seed))
    n = len(ds.records)
    t0 = time.perf_counter()
    if which == "scan":
        s = jsp.ScanSfM(ds.K, cfg, n_frames=n, chunk=32, p_cap=16384,
                        p_ba=1024)
    else:
        s = jsystem.SfMSystem(ds.K, cfg, gt_records=ds.records)
    for i in range(n):
        s.process(i, ds.records[i].img, ds.load_gray(i))
    s.finalize()
    wall = time.perf_counter() - t0
    info = s.export(out_dir, dataset=ds)
    gt = [cs._rel_pose(ds, s.kfs[e.i].frame_idx, s.kfs[e.j].frame_idx)
          for e in s.edges]

    def f64(xs):
        return jnp.asarray(np.stack(xs).astype(np.float64))

    rot, dirn = (np.asarray(a) for a in umeyama.edge_errors(
        f64([e.R_ji for e in s.edges]), f64([e.t_ji for e in s.edges]),
        f64([g[0] for g in gt]), f64([g[1] for g in gt])))
    est = np.stack([k.center for k in s.kfs]).astype(np.float64)
    gtc = np.stack([ds.records[k.frame_idx].center for k in s.kfs])
    res = umeyama.ate(jnp.asarray(est), jnp.asarray(gtc), with_scale=True)
    extent = float(np.linalg.norm(gtc - gtc.mean(0), axis=1).max())
    line = {"pipeline": which, "seed": seed, "keyframes": len(s.kfs),
            "map_points": int(info["map_points"]),
            "loop_edges": [(e.i, e.j) for e in s.edges if e.is_loop],
            "ate_ratio": float(res["rmse"]) / extent,
            "edge_count": len(rot),
            "edge_rot_median_deg": float(np.median(rot)),
            "edge_rot_max_deg": float(rot.max()),
            "edge_dir_median_deg": float(np.median(dirn)),
            "edge_dir_max_deg": float(dirn.max()),
            "wall_s": wall}
    return s, line


VARIANTS = ("stockgate94", "structured_stock", "gtscale", "hyp4096")


def variant_dataset(name: str, root: Path):
    """The ring of variant ``name`` rendered by the JAX package under
    ``root``."""
    spec = {"stockgate94": cs.stockgate_spec,
            "structured_stock": cs.structured_spec}.get(name, cs.ring_spec)()
    generate_dataset(root, SyntheticRingSpec(**dataclasses.asdict(spec)),
                     name_prefix="templeR")
    return TempleRing.from_dir(root)


def jax_ate(est, gt, with_scale: bool) -> tuple[float, float]:
    """The JAX package's ``umeyama.ate`` (float64): (RMSE, scale)."""
    r = umeyama.ate(jnp.asarray(est, jnp.float64),
                    jnp.asarray(gt, jnp.float64), with_scale=with_scale)
    return float(r["rmse"]), float(r["scale"])


def run_variant(name: str, ds, seed: int, out_dir: Path) -> dict:
    """One ScanSfM run of variant ``name`` (not hyp4096) at ``seed``."""
    cfg = jconfig.load_config(None, overrides=cs.VARIANT_OVERRIDES[name])
    cfg = dataclasses.replace(
        cfg, ransac=dataclasses.replace(cfg.ransac, seed=seed))
    n = len(ds.records)
    t0 = time.perf_counter()
    s = jsp.ScanSfM(ds.K, cfg, n_frames=n, chunk=32, p_cap=16384,
                    p_ba=1024,
                    gt_records=ds.records if cfg.use_gt_scale else None)
    for i in range(n):
        s.process(i, ds.records[i].img, ds.load_gray(i))
    s.finalize()
    wall = time.perf_counter() - t0
    info = s.export(out_dir, dataset=ds)
    est = np.stack([k.center for k in s.kfs]).astype(np.float64)
    gtc = np.stack([ds.records[k.frame_idx].center for k in s.kfs])
    extent = float(np.linalg.norm(gtc - gtc.mean(0), axis=1).max())
    line = {"mode": name, "seed": seed, "frames": n,
            "keyframes": len(s.kfs),
            **cs.keyframe_cadence([k.frame_idx for k in s.kfs], n),
            "map_points": int(info["map_points"]),
            "loop_edges": [(e.i, e.j) for e in s.edges if e.is_loop],
            "ate_ratio": jax_ate(est, gtc, True)[0] / extent,
            "wall_s": wall}
    if cfg.use_gt_scale:
        line.update(cs.gtscale_grades(jax_ate, est, gtc))
    return line


def run_hyp4096(ds, seed: int) -> dict:
    """bench_hyp4096's pair stage (one jitted program, as bench.py's) on
    frames 0 and 1 with the draws of ``jax.random.PRNGKey(seed)``."""
    import jax

    from sfm_tpu.models.system import build_pyramid_u8
    from sfm_tpu.ops import epipolar, klt

    Kf = jnp.asarray(ds.K, jnp.float32)
    pos = jnp.asarray(cs.hyp_tracks())
    valid = jnp.ones(cs.HYP_TRACKS, bool)

    @jax.jit
    def pair(key, im0, im1, pos, valid):
        p0 = build_pyramid_u8(im0, cs.HYP_LEVELS)
        p1 = build_pyramid_u8(im1, cs.HYP_LEVELS)
        new_pos, ok = klt.lk_track_fb(p0, p1, pos, valid,
                                      levels=cs.HYP_LEVELS, iters=cs.ITERS,
                                      radius=cs.RADIUS, fb_thresh=1.0)
        xi = epipolar.normalize_by_K(Kf, pos)
        xj = epipolar.normalize_by_K(Kf, new_pos)
        rp = epipolar.find_E_ransac(
            key, xi, xj, valid & ok, num_hypotheses=cs.HYP_H,
            sampson_thresh=cs.HYP_SAMPSON, min_inliers=cs.HYP_MIN_INLIERS)
        return rp.R, rp.t, rp.num_inliers, jnp.sum(valid & ok)

    t0 = time.perf_counter()
    R, t, inl, n_ok = (np.asarray(a) for a in pair(
        jax.random.PRNGKey(seed), jnp.asarray(ds.load_gray(0)),
        jnp.asarray(ds.load_gray(1)), pos, valid))
    wall = time.perf_counter() - t0
    R_gt, t_gt = cs._rel_pose(ds, 0, 1)
    rot, dirn = (float(np.asarray(a)) for a in umeyama.edge_errors(
        jnp.asarray(R, jnp.float64), jnp.asarray(t, jnp.float64),
        jnp.asarray(R_gt), jnp.asarray(t_gt)))
    return {"mode": "hyp4096", "seed": seed, "hypotheses": cs.HYP_H,
            "pyr_levels": cs.HYP_LEVELS, "tracks": cs.HYP_TRACKS,
            "inliers": int(inl), "tracked": int(n_ok),
            "R": R.astype(np.float64).tolist(),
            "t": t.astype(np.float64).tolist(),
            "rot_err_gt_deg": rot, "dir_err_gt_deg": dirn,
            "wall_s_first_call": wall}


def main_variants(modes, seeds) -> int:
    """The JSON lines of bench.py's other configurations (``VARIANTS``)."""
    for name in modes:
        with tempfile.TemporaryDirectory(prefix="jax_variant_") as tmp:
            ds = variant_dataset(name, Path(tmp) / "ring")
            if name == "hyp4096":
                for seed in seeds or [cs.HYP_SEED]:
                    print(json.dumps(run_hyp4096(ds, seed)), flush=True)
                continue
            for seed in seeds or [cs.smoke_config().ransac.seed]:
                print(json.dumps(run_variant(name, ds, seed,
                                             Path(tmp) / f"out{seed}")),
                      flush=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("pipelines", nargs="*", default=["scan", "host"],
                    help="scan (ScanSfM) and/or host (SfMSystem) on "
                         "ring47; or any of " + ", ".join(VARIANTS))
    ap.add_argument("--seeds", type=int, nargs="+", default=None,
                    help="RANSAC seeds (default: 12345; hyp4096: the "
                         "PRNGKey seed, default HYP_SEED)")
    ap.add_argument("--ring-seeds", type=int, nargs="+", default=None,
                    help="texture seeds of the ring (default: the ring's "
                         "own), as tools/chip_ate_spread.py --ring-seeds")
    ap.add_argument("--dump", metavar="DIR", default=None,
                    help="also write each ScanSfM run's metrics rows and "
                         "keyframe centres to DIR/scan<seed>.json, as "
                         "tools/chip_ate_spread.py --dump does")
    args = ap.parse_args()
    if set(args.pipelines) <= set(VARIANTS):
        return main_variants(args.pipelines, args.seeds)
    if not set(args.pipelines) <= {"scan", "host"}:
        ap.error("pipelines are scan and host, or the variants "
                 + ", ".join(VARIANTS) + " (not both kinds at once)")
    args.seeds = args.seeds or [12345]
    rec = chip_ate_spread.record_runs(jsp) if args.dump else None
    ring0 = cs.ring_spec().seed
    for ring in args.ring_seeds or [ring0]:
        spec = SyntheticRingSpec(**{**dataclasses.asdict(cs.ring_spec()),
                                    "seed": ring})
        suffix = "" if ring == ring0 else f"_ring{ring}"
        with tempfile.TemporaryDirectory(prefix="jax_ring47_") as tmp:
            generate_dataset(Path(tmp), spec, name_prefix="templeR")
            ds = TempleRing.from_dir(Path(tmp))
            for w in args.pipelines:
                for seed in args.seeds:
                    s, line = run(w, ds, seed, Path(tmp) / f"{w}{seed}")
                    print(json.dumps({**line, "ring_seed": ring}),
                          flush=True)
                    if rec is not None and w == "scan":
                        chip_ate_spread.dump_run(
                            Path(args.dump) / f"scan{seed}{suffix}.json", s,
                            rec)
    return 0


if __name__ == "__main__":
    sys.exit(main())

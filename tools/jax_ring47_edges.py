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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("pipelines", nargs="*", default=["scan", "host"],
                    help="scan (ScanSfM) and/or host (SfMSystem)")
    ap.add_argument("--seeds", type=int, nargs="+", default=[12345])
    ap.add_argument("--ring-seeds", type=int, nargs="+", default=None,
                    help="texture seeds of the ring (default: the ring's "
                         "own), as tools/chip_ate_spread.py --ring-seeds")
    ap.add_argument("--dump", metavar="DIR", default=None,
                    help="also write each ScanSfM run's metrics rows and "
                         "keyframe centres to DIR/scan<seed>.json, as "
                         "tools/chip_ate_spread.py --dump does")
    args = ap.parse_args()
    rec = chip_ate_spread.record_runs(jsp) if args.dump else None
    if not set(args.pipelines) <= {"scan", "host"}:
        ap.error("pipelines are scan and host")
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

"""How far the trajectory error and the keyframe-edge errors of the 47-frame
ring move with the RANSAC draws alone, on a CUDA card.

The pipeline is chaotic: one track more or less at one frame moves every
later pose.  This runs ``chip_smoke.py``'s ring47 configuration
(``smoke_config()``, ``ring_spec()``) through ``ScanSfM`` and through
``SfMSystem`` once per RANSAC seed and prints one JSON line per run (Sim(3)
ATE over the trajectory's extent, keyframes, map points, loop edges, the
keyframe edges' median and max rotation and direction errors against GT
as ``chip_smoke.edge_errors_on_card`` computes them, wall seconds), then
the card's name and power limit.  The spread over seeds is the yardstick
for an ATE or edge-error difference between two runs that do not share
their draws (PERF.md, Findings).

    python3 tools/chip_ate_spread.py --seeds 12345 12346 12347 12348 12349

Needs one CUDA card and ``nvcc``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import tempfile
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, nargs="+",
                    default=[12345, 12346, 12347, 12348, 12349])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_ate_spread: no CUDA device available", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    import sfm_tpu_torch  # noqa: F401  (sets the precision policy)

    base = cs.smoke_config()
    with tempfile.TemporaryDirectory(prefix="sfm_spread_") as tmp, \
            torch.no_grad():
        tmp = Path(tmp)
        ds, frames, names = cs.ring_dataset(tmp)
        cs.run_pipeline(dev, ds.K, frames, names, tmp / "warm")  # warm-up
        for seed in args.seeds:
            cfg = dataclasses.replace(
                base, ransac=dataclasses.replace(base.ransac, seed=seed))
            for name in ("scan", "host"):
                out = tmp / f"{name}{seed}"
                if name == "scan":
                    s, info, dt, _ = cs.run_pipeline(dev, ds.K, frames,
                                                     names, out, cfg)
                else:
                    s, info, dt, _ = cs.run_host(dev, ds, frames, out, cfg)
                print(json.dumps({
                    "pipeline": name, "seed": seed,
                    "ate_ratio": cs.ate_ratio(s.kfs, ds),
                    "keyframes": info["keyframes"],
                    "map_points": info["map_points"],
                    "loop_edges": [(e.i, e.j) for e in s.edges if e.is_loop],
                    **cs.edge_errors_on_card(dev, s, ds),
                    "wall_s": dt}), flush=True)
    print(cs.nvidia_smi_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Two checks of the port's LK kernels K3 (``lk_level_fused``) and K4
(``lk_level_tmpl``) on a CUDA card, beyond the one ``chip_smoke.py`` runs.

* ``--seeds S ...``: ``chip_smoke.py``'s check at the radii ``RADII_EXTRA``
  (``check_lk_level_radii``: ``T_RADII`` tracks, the rules and tolerances
  of the full-size check) on the inputs of each seed; one JSON line per
  seed says which kernel and radius passed, with the border tracks on
  which the kernel ends more than 1e-3 px from the plain version beside
  those on which the plain version's own perturbations move it that far
  (the rules ask the first to be at most the second), and the count for
  each of those perturbations alone.
* ``--against DIR``: the flows of this tree's kernels and of the kernels of
  the tree ``DIR`` (another commit, unpacked with ``git archive``), on the
  same inputs - for each seed, the inputs of the radii check (the same
  draws in the same order), then radius 1 and 6 on the draws that follow;
  four levels, with and without NaN positions, the 16-iteration launch -
  compared bit for bit on every non-NaN track.  Each tree's kernels run
  in a child process that imports that tree's ``sfm_tpu_torch`` (built
  there at first use); the inputs are made by this tree's
  ``chip_smoke.py`` in both.

    python3 tools/chip_lk_survey.py --seeds 0 1 2 3 --against /path/to/tree

Needs one CUDA card and ``nvcc``.  Exits 1 when the flows of the two trees
differ, else 0 (a seed that fails the radii check is reported, not an
error).
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]


def chip_smoke():
    """This tree's ``chip_smoke.py``, loaded by path (the ``sfm_tpu_torch``
    it imports is the first on the import path)."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def survey(seeds: list[int]) -> None:
    cs = chip_smoke()
    dev = torch.device("cuda", 0)
    pyr0, pyr1 = cs.lk_inputs(dev, np.random.default_rng(0))
    keys = ("radius", "ok", "border_far", "border_far_by", "max_abs_err",
            "max_abs_err_border", "max_step_excess")
    for seed in seeds:
        line = {"seed": seed}
        with torch.no_grad():
            for name, level in (("k3", cs.k3_level), ("k4", cs.k4_level)):
                row = cs.check_lk_level_radii(dev, pyr0, pyr1, level,
                                              {"ok": True}, seed)
                line[name] = [{k: e[k] for k in keys} for e in row["radii"]]
        line["ok"] = all(e["ok"] for k in ("k3", "k4") for e in line[k])
        print(json.dumps(line), flush=True)


def flows(seeds: list[int], out: str) -> None:
    """The child: K3's and K4's flows on every input (seeds x radii x
    levels x NaN shares), and which tracks are non-NaN, saved to
    ``out``."""
    import sfm_tpu_torch
    from sfm_tpu_torch.ops.kernels import lk_kernels as lk

    cs = chip_smoke()
    dev = torch.device("cuda", 0)
    pyr0, pyr1 = cs.lk_inputs(dev, np.random.default_rng(0))
    res = {"package": sfm_tpu_torch.__file__}
    with torch.no_grad():
        for seed in seeds:
            rng = np.random.default_rng(seed)
            for r in flow_radii(cs):
                win = 2 * r + 1 + 2 * lk.MARGIN + 3
                for L in range(cs.LEVELS):
                    H, W = pyr0[L].shape
                    flow = np.array(cs.SHIFT_XY, np.float32) / 2 ** L
                    for nan_frac in (0.0, 0.4):
                        T = cs.T_RADII
                        pts = cs.level_points(rng, H, W, T, win)
                        bad = rng.random(T) < nan_frac
                        pts[bad] = np.nan
                        v0 = flow + rng.uniform(-0.7, 0.7, (T, 2))
                        p = torch.as_tensor(pts, device=dev)
                        v = torch.as_tensor(v0.astype(np.float32), device=dev)
                        key = f"seed {seed} radius {r} level {L} nan {nan_frac}"
                        res[key + " good"] = torch.as_tensor(~bad)
                        for name, level in (("k3", cs.k3_level),
                                            ("k4", cs.k4_level)):
                            res[f"{key} {name}"] = level(
                                pyr0, pyr1, L, p, v, cs.ITERS, "kernel",
                                r).cpu()
    torch.save(res, out)


def flow_radii(cs) -> tuple[int, ...]:
    return (*cs.RADII_EXTRA, 1, cs.RADIUS)


def against(seeds: list[int], other: Path) -> bool:
    """Runs ``flows`` in a child per tree and compares their bits."""
    got = []
    with tempfile.TemporaryDirectory() as tmp:
        for tree in (REPO, other):
            out = os.path.join(tmp, f"{len(got)}.pt")
            env = {**os.environ, "PYTHONPATH": str(tree)}
            subprocess.run([sys.executable, __file__, "--flows", out,
                            "--seeds", *map(str, seeds)], env=env, check=True,
                           timeout=1800)
            got.append(torch.load(out))
    line = {"against": str(other), **compare(*got)}
    print(json.dumps(line), flush=True)
    return line["bit_for_bit"]


def compare(a: dict, b: dict) -> dict:
    """How many non-NaN tracks' flows of ``flows``' outputs a and b differ
    in any bit, of how many."""
    tracks = differing = 0
    worst = 0.0
    for key, good in a.items():
        if not key.endswith(" good"):
            continue
        base = key[:-len(" good")]
        for name in ("k3", "k4"):
            x, y = a[f"{base} {name}"][good], b[f"{base} {name}"][good]
            same = (x.view(torch.int32) == y.view(torch.int32)).all(-1)
            tracks += int(same.numel())
            differing += int((~same).sum())
            if bool((~same).any()):
                worst = max(worst, float((x - y).abs().max()))
    return {"packages": [a["package"], b["package"]], "tracks": tracks,
            "differing": differing, "max_abs_diff": worst,
            "bit_for_bit": differing == 0}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[0])
    ap.add_argument("--against", type=Path, default=None,
                    help="another tree whose kernels to compare bit for bit")
    ap.add_argument("--flows", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_lk_survey: no CUDA device available", file=sys.stderr)
        return 1
    if args.flows:
        flows(args.seeds, args.flows)
        return 0
    ok = True
    if args.against is not None:
        ok = against(args.seeds, args.against.resolve())
    sys.path.insert(0, str(REPO))
    survey(args.seeds)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())

"""Helpers of the benchmark's tests: one run of ``portbench/run.py`` in a
fresh process at the rehearsal size (``--device cpu``: the kernels' plain
versions at the files' ``tiny`` sizes), and one in this process with the
program's timed path broken underneath."""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

# runs run.py as __main__, then writes its exit code and the top-level
# names of every module loaded to the file named by argv[1]
_WRAP = """
import json, runpy, sys
out = sys.argv[1]
sys.argv = ["portbench/run.py"] + sys.argv[2:]
code = 0
try:
    runpy.run_path(sys.argv[0], run_name="__main__")
except SystemExit as e:
    code = e.code
mods = sorted({m.split(".")[0] for m in list(sys.modules)})
open(out, "w").write(json.dumps({"rc": code, "modules": mods}))
"""


def run_subprocess(root: Path, tmp: Path, workload: str, seed: int,
                   trace: int = 0, extra=(), env=None, timeout=600):
    """(exit code, result object or None, stderr, loaded top-level module
    names) of one run from the checkout ``root``."""
    info = tmp / "wrap.json"
    e = {**os.environ, "TMPDIR": str(tmp), "OMP_NUM_THREADS": "2",
         **(env or {})}
    p = subprocess.run(
        [sys.executable, "-c", _WRAP, str(info), "--workload", workload,
         "--seed", str(seed), "--seconds", "1", "--trace", str(trace),
         "--device", "cpu", *extra],
        cwd=root, env=e, capture_output=True, text=True, timeout=timeout)
    lines = p.stdout.strip().splitlines()
    result = json.loads(lines[-1]) if lines and p.returncode == 0 else None
    wrap = json.loads(info.read_text()) if info.exists() else {}
    return p.returncode, result, p.stderr, wrap.get("modules", [])


def run_inprocess(workload: str, seed: int, trace: int = 0):
    """(result object, check lines) of one run in this process."""
    from portbench import harness

    args = harness.parse(["--workload", workload, "--seed", str(seed),
                          "--seconds", "1", "--trace", str(trace),
                          "--device", "cpu"])
    return harness.run_cell(args, harness.load_cell(args), time.perf_counter())


def copy_checkout(tmp: Path) -> tuple[Path, dict]:
    """A copy of the manifest and ``portbench/`` under ``tmp``, and the
    environment that gives its runs this checkout's program."""
    import shutil

    root = tmp / "checkout"
    root.mkdir()
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    shutil.copytree(ROOT / "portbench", root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = {"PYTHONPATH": str(ROOT) + os.pathsep
           + os.environ.get("PYTHONPATH", "")}
    return root, env


def workloads(root: Path = ROOT) -> list[str]:
    return [w["name"] for w in
            json.loads((root / "BENCHMARK.json").read_text())["workloads"]]


# cells whose files stay under portbench/ while the manifest leaves them
# out: (configuration, traffic, the host-clock metrics each reports)
LEFT_OUT = {
    "templering_scan.ring47": ("templering_scan", "ring47",
                               ("scan.finalize_s",)),
    "templering_host.ring47": ("templering_host", "ring47",
                               ("host.two_view_ms", "host.kf_geometry_ms")),
    "templering_scan.dense94": ("templering_scan", "dense94",
                                ("scan.finalize_s",)),
}
_UNITS = {"scan.finalize_s": "s", "host.two_view_ms": "ms",
          "host.kf_geometry_ms": "ms"}
_CONFIGS = {"templering_scan": "portbench/configs/templering_scan.json",
            "templering_host": "portbench/configs/templering_host.json"}


def with_left_out(m: dict, names=tuple(LEFT_OUT)) -> dict:
    """The manifest ``m`` with the cells ``names`` of ``LEFT_OUT`` added
    back as a manifest entry would add them: their configurations,
    workloads, host-clock metrics, and every device metric of the
    manifest in each."""
    m = json.loads(json.dumps(m))
    have = {c["name"] for c in m["configs"]}
    for name in names:
        config, traffic, metrics = LEFT_OUT[name]
        if config not in have:
            have.add(config)
            m["configs"].append({"name": config, "source": "x",
                                 "file": _CONFIGS[config],
                                 "reduced": [], "why": "x"})
        m["workloads"].append({"name": name, "config": config,
                               "traffic": traffic, "chips": 1, "why": "x"})
        for e in m["end_to_end"] + m["per_layer"]:
            if "workloads" in e:
                e["workloads"].append(name)
        for k in metrics:
            e = next((e for e in m["per_layer"] if e["name"] == k), None)
            if e is None:
                m["per_layer"].append({
                    "name": k, "unit": _UNITS[k], "better": "lower",
                    "source": "host_clock", "layer": "x",
                    "moves": "frames_per_s", "workloads": [name]})
            elif name not in e["workloads"]:
                e["workloads"].append(name)
    return m

"""A later PR adds a configuration, a traffic mix, a cell and a per-layer
metric by adding files and manifest entries: in a copy of the manifest and
of ``portbench/``, the harness finds and runs all four by name, and no
file that was there is edited."""

import hashlib
import json

from portbench.tests.runner import copy_checkout, run_subprocess

READER = '''"""window.units: units the window ran (a test's throwaway metric)."""


def read(run):
    return float(len(run.units)) if run.units else None
'''


def _digests(root):
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes())
            .hexdigest() for p in sorted(root.rglob("*")) if p.is_file()}


def test_new_cell_by_files_alone(tmp_path):
    root, env = copy_checkout(tmp_path)
    before = _digests(root)
    pb = root / "portbench"
    cfg = json.loads((pb / "configs" / "templering_scan.json").read_text())
    cfg["overrides"]["klt.iters"] = 12
    (pb / "configs" / "scan_iters12.json").write_text(json.dumps(cfg))
    (pb / "traffic" / "arc9.json").write_text(json.dumps({
        "why": "nine views over 60 degrees", "scenes": 1,
        "path": {"type": "arc", "frames": 9, "arc_deg": 60.0},
        "frames_used": 9, "warmup": {"out_and_back": 2},
        "track_sample_p": 0.5}))
    (pb / "metrics" / "window.units.py").write_text(READER)
    (pb / "cells" / "scan_iters12.arc9.json").write_text(json.dumps(
        {"limits": {"track_err_p99_px": 0.0005,
                     "gate_flip_share": 0.001}}))
    m = json.loads((root / "BENCHMARK.json").read_text())
    m["configs"].append({"name": "scan_iters12", "source": "x",
                         "file": "portbench/configs/scan_iters12.json",
                         "reduced": [], "why": "x"})
    m["workloads"].append({"name": "scan_iters12.arc9",
                           "config": "scan_iters12", "traffic": "arc9",
                           "chips": 1, "why": "x"})
    m["per_layer"].append({"name": "window.units", "unit": "units",
                           "better": "lower", "source": "host_clock",
                           "layer": "frame loop", "moves": "frames_per_s",
                           "workloads": ["scan_iters12.arc9"]})
    (root / "BENCHMARK.json").write_text(json.dumps(m))
    after = _digests(root)
    assert {k: after[k] for k in before if k != "BENCHMARK.json"} == {
        k: v for k, v in before.items() if k != "BENCHMARK.json"}
    # the copy's harness, with the program of this checkout
    rc, res, err, _ = run_subprocess(root, tmp_path, "scan_iters12.arc9",
                                     seed=44, trace=1, env=env)
    assert rc == 0, err[-3000:]
    assert res["correct"] is True, err[-2000:]
    assert res["metrics"]["window.units"]["value"] >= 2
    rc, res, err, _ = run_subprocess(root, tmp_path, "scan_iters12.arc9",
                                     seed=44, trace=0, env=env)
    assert rc == 0, err[-3000:]
    assert set(res["metrics"]) == {"frames_per_s", "setup_s"}

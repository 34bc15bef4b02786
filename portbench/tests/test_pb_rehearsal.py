"""Each cell of the manifest runs on the CPU at the rehearsal size through
the kernels' plain versions, prints one result line of the contract's
shape as its last line, proves correct, and leaves no module of JAX or of
the JAX package loaded."""

import json

import pytest

from portbench.tests.runner import (LEFT_OUT, ROOT, copy_checkout,
                                    run_subprocess, with_left_out, workloads)

FORBIDDEN = {"jax", "jaxlib", "flax", "sfm_tpu"}
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())


def _metrics(kind, workload):
    return {m["name"] for m in MANIFEST[kind]
            if workload in m.get("workloads", [workload])}


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("workload", workloads())
def test_cell_rehearsal(tmp_path, workload, trace):
    rc, res, err, mods = run_subprocess(ROOT, tmp_path, workload,
                                        seed=2 ** 31 + 7, trace=trace)
    assert rc == 0, err[-3000:]
    assert set(res) >= {"correct", "attempted", "failed", "metrics",
                        "device"}
    assert list(res)[-1] == "checks"
    assert res["correct"] is True, err[-2000:]
    assert res["attempted"] >= 2 and res["failed"] == 0
    got = set(res["metrics"])
    if trace:
        # the CPU has no device trace: only the host-clock readers read
        assert got <= _metrics("per_layer", workload)
        assert "busy_s" in res["device"] and "window_s" in res["device"]
    else:
        assert got == _metrics("end_to_end", workload)
        for m in res["metrics"].values():
            assert m["value"] > 0
    assert not FORBIDDEN & set(mods), mods
    assert "sfm_tpu_torch" in mods
    # the numbers compared, each beside its limit, end standard error
    tail = err.strip().splitlines()[-1]
    assert tail.startswith("correct True")


def _left_out_run(tmp_path, workload):
    """A cell out of the manifest, added back by manifest entries alone,
    rehearsed with ``--trace 1``."""
    root, env = copy_checkout(tmp_path)
    m = with_left_out(json.loads((root / "BENCHMARK.json").read_text()),
                      [workload])
    (root / "BENCHMARK.json").write_text(json.dumps(m))
    rc, res, err, _ = run_subprocess(root, tmp_path, workload, seed=12,
                                     trace=1, env=env)
    assert rc == 0, err[-3000:]
    assert set(LEFT_OUT[workload][2]) <= set(res["metrics"])
    return res, err


def test_host_cell_reads_its_stage_timers(tmp_path):
    """``SfMSystem``'s cell (out of the manifest while the program fails
    it on some seeds) added back by manifest entries alone."""
    res, err = _left_out_run(tmp_path, "templering_host.ring47")
    assert res["correct"] is True, err[-2000:]
    assert {"host.two_view_ms", "host.kf_geometry_ms"} <= set(res["metrics"])


@pytest.mark.parametrize("workload", ["templering_scan.ring47",
                                      "templering_scan.dense94"])
def test_left_out_scan_cell_reads_its_finalize(tmp_path, workload):
    """Its reader reads whatever ``correct`` says: the program misses the
    ATE bar on some rings (why the cells are out of the manifest), and
    ``ring47``'s rehearsal ring of this seed is one of them."""
    res, _ = _left_out_run(tmp_path, workload)
    assert res["metrics"]["scan.finalize_s"]["value"] > 0
    assert list(res)[-1] == "checks"


def test_no_result_without_a_card(tmp_path):
    import subprocess
    import sys

    p = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         workloads()[0], "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, env={"PATH": "/usr/bin:/bin", "TMPDIR": str(tmp_path),
                       "CUDA_VISIBLE_DEVICES": ""},
        capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert p.stdout.strip() == ""


def test_no_result_without_the_program(tmp_path):
    """In a directory that holds only BENCHMARK.json and portbench/."""
    import shutil
    import subprocess
    import sys

    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", workloads()[0],
         "--seed", "1", "--seconds", "1", "--trace", "0", "--device", "cpu"],
        cwd=tmp_path, env={"PATH": "/usr/bin:/bin", "TMPDIR": str(tmp_path)},
        capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert p.stdout.strip() == ""

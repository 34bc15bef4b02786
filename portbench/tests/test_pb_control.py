"""The control of the comparison that decides ``correct``, on the card at
each cell's own size: the program with its bfloat16 LK storage switched on
(``SFM_TPU_LK_BF16=1``, the nearest precision below the float32 that the
configurations state) comes out as not correct on three seeds, and the
program as the configuration states it as correct on the same seeds.

    python -m pytest portbench/tests/test_pb_control.py -m gpu -q

(about a minute a run on an H100; skipped without a card)."""

import json
import subprocess
import sys

import pytest

from portbench.tests.runner import ROOT, workloads

SEEDS = (2 ** 31 + 101, 2 ** 31 + 202, 2 ** 31 + 303)


def _run(tmp_path, workload, seed, control):
    extra = ["--control", "lk_bf16"] if control else []
    p = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", workload,
         "--seed", str(seed), "--seconds", "1", "--trace", "0", *extra],
        cwd=ROOT, capture_output=True, text=True, timeout=900,
        env={**__import__("os").environ, "TMPDIR": str(tmp_path)})
    assert p.returncode == 0, p.stderr[-3000:]
    return json.loads(p.stdout.strip().splitlines()[-1]), p.stderr


@pytest.mark.gpu
@pytest.mark.parametrize("workload", workloads())
@pytest.mark.parametrize("seed", SEEDS)
def test_control_is_not_correct(cuda, tmp_path, workload, seed):
    res, err = _run(tmp_path, workload, seed, control=True)
    assert res["correct"] is False, err[-2000:]
    res, err = _run(tmp_path, workload, seed, control=False)
    assert res["correct"] is True, err[-2000:]

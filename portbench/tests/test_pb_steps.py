"""The traced part of a run covers the frames it says it covers: every
frame-tracker step of a one-scene entry (``tracker.step``, which steps
through ``tracker.step_scenes``) and of the multi-scene runner counts
once, so ``frame_loop.launches_per_frame`` divides by the frames that the
profiler saw."""

import json
import time

import pytest

from portbench.tests.runner import LEFT_OUT, copy_checkout, with_left_out


@pytest.mark.parametrize("workload", ["templering_scan.ring47",
                                      "templering_host.ring47",
                                      "templering_scan.ring47x4"])
def test_traced_part_counts_the_frames_it_steps(monkeypatch, tmp_path,
                                                workload):
    from portbench import harness, trace
    from sfm_tpu_torch.models import tracker

    root, _ = copy_checkout(tmp_path)
    m = json.loads((root / "BENCHMARK.json").read_text())
    if workload in LEFT_OUT:
        m = with_left_out(m, [workload])
    (root / "BENCHMARK.json").write_text(json.dumps(m))

    # every step of all scenes passes through step_scenes once
    part = {"on": False, "steps": 0}
    inner = tracker.step_scenes

    def step_scenes(pyr_prev, pyr_cur, states, *a, **kw):
        if part["on"]:
            part["steps"] += 1
            part["scenes"] = len(states)
        return inner(pyr_prev, pyr_cur, states, *a, **kw)

    class Part:  # the profiler's part, without the profiler's cost
        def __init__(self, cuda):
            self.sessions = []

        def start(self):
            part["on"] = True

        def stop(self, name):
            part["on"] = False
            self.sessions.append((name, 1.0, []))

    monkeypatch.setattr(tracker, "step_scenes", step_scenes)
    monkeypatch.setattr(trace, "Profiler", Part)
    args = harness.parse(["--workload", workload, "--seed", "17",
                          "--seconds", "0.1", "--trace", "1",
                          "--device", "cpu"])
    cell = harness.Cell(root / "BENCHMARK.json", workload, True)
    res, lines = harness.run_cell(args, cell, time.perf_counter())
    assert res["correct"] is True, "\n".join(lines)
    steps = cell.traffic.get("trace", cell.config["trace"])["steps"]
    assert part["steps"] == steps[1] - steps[0]
    assert res["window"]["traced_part"]["frames"] == (
        part["steps"] * part["scenes"])

"""The comparison that decides ``correct`` catches a broken timed path: a
whole run at the rehearsal size, the look for a card skipped, with the
program broken underneath, for each fault a cell can have.  (No cell runs
on more than one chip, so no exchange between chips can be left out.)"""

import numpy as np
import pytest
import torch

from portbench.tests.runner import run_inprocess, workloads


def _stuck(track):
    """A tracker step that hands its state back unchanged."""
    def f(pyr0, pyr1, pts, valid, *a, **kw):
        return torch.as_tensor(pts).clone(), torch.as_tensor(valid).clone()
    return f


def _half(track):
    """Half of the tracks left out: the rest tracked, the left-out half
    handed back where it was, as if tracked."""
    def f(pyr0, pyr1, pts, valid, *a, **kw):
        new, ok = track(pyr0, pyr1, pts, valid, *a, **kw)
        n = new.shape[-2] // 2
        new = new.clone()
        new[..., n:, :] = torch.as_tensor(pts, dtype=new.dtype)[..., n:, :]
        return new, ok
    return f


def _shifted(track):
    """Every tracked position a quarter pixel off where it is produced."""
    def f(pyr0, pyr1, pts, valid, *a, **kw):
        new, ok = track(pyr0, pyr1, pts, valid, *a, **kw)
        return new + 0.25, ok
    return f


def _gate(track):
    """The forward-backward gate dropping every other track it is handed
    where it decides."""
    def f(pyr0, pyr1, pts, valid, *a, **kw):
        new, ok = track(pyr0, pyr1, pts, valid, *a, **kw)
        ok = ok.clone()
        ok[..., ::2] = False
        return new, ok
    return f


FAULTS = {"state_unchanged": _stuck, "half_left_out": _half,
          "answer_altered": _shifted, "gate_altered": _gate}


@pytest.mark.parametrize("workload", workloads())
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_fails(monkeypatch, workload, fault):
    from sfm_tpu_torch.ops import klt

    monkeypatch.setattr(klt, "lk_track_fb", FAULTS[fault](klt.lk_track_fb))
    try:
        res, lines = run_inprocess(workload, seed=31)
    except Exception as e:  # a run that cannot finish proves nothing right
        pytest.skip(f"the broken run raised {type(e).__name__}: {e}")
    assert res["correct"] is False, "\n".join(lines)
    if fault == "gate_altered":
        assert res["checks"]["gate_flip_share"]["value"] > 0.1


def test_exported_trajectory_altered_fails(monkeypatch):
    """The keyframe centres altered where the entry writes them."""
    from sfm_tpu_torch.utils import artifacts

    write = artifacts.write_csv_centers

    def altered(path, rows):
        # every other centre moved by a third of the trajectory's extent
        xs = [r["x"] for r in rows] + [r["y"] for r in rows]
        d = (max(xs) - min(xs)) / 3
        rows = [dict(r, x=r["x"] + (d if k % 2 else 0.0))
                for k, r in enumerate(rows)]
        return write(path, rows)

    monkeypatch.setattr(artifacts, "write_csv_centers", altered)
    res, lines = run_inprocess("templering_scan.ring47x4", seed=32)
    assert res["correct"] is False, "\n".join(lines)
    assert res["checks"]["ate_ratio"]["value"] > 0.05


def test_sound_run_is_correct():
    res, lines = run_inprocess("templering_scan.ring47x4", seed=31)
    assert res["correct"] is True, "\n".join(lines)
    assert all(np.isfinite(v["value"]) for v in res["checks"].values())

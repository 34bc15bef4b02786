"""Tracing / profiling: named stage timers aggregated per run, optional
``torch.profiler`` traces, and JSON emission.

Counterpart of sfm_tpu/utils/profiling.py.  Where the JAX twin blocks a
stage on ``block_until_ready``, a caller here ends a stage with
``torch.cuda.synchronize(device)`` (see ``StageTimers.stage``), so each
stage's wall time holds the device work it launched.
"""

from __future__ import annotations

import contextlib
import json
import time
from collections import defaultdict
from pathlib import Path

import torch


class StageTimers:
    """Accumulates wall-clock per named stage; cheap enough to leave on.

    ``device``: with a CUDA device, a stage ends with
    ``torch.cuda.synchronize(device)`` before the clock is read."""

    def __init__(self, device=None):
        self.device = torch.device(device) if device is not None else None
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            with annotate(name):
                yield
                if self.device is not None and self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] += dt
            self.counts[name] += 1

    def summary(self) -> dict:
        return {
            name: {
                "total_s": round(self.totals[name], 4),
                "count": self.counts[name],
                "mean_ms": round(1000.0 * self.totals[name]
                                 / max(self.counts[name], 1), 3),
            }
            for name in sorted(self.totals)
        }

    def dump(self, path) -> None:
        Path(path).write_text(json.dumps(self.summary(), indent=2))


@contextlib.contextmanager
def trace(log_dir: str | None):
    """``torch.profiler`` trace (host and, on a card, device activity) of
    a region, written to ``log_dir`` as a Chrome trace.  No-op when
    ``log_dir`` is None."""
    if not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    Path(log_dir).mkdir(parents=True, exist_ok=True)
    with profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(str(Path(log_dir) / "trace.json"))


@contextlib.contextmanager
def annotate(name: str):
    """Named range in a ``torch.profiler`` trace."""
    with torch.profiler.record_function(name):
        yield

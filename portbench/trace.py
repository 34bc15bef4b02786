"""The traced part of a window: ``torch.profiler`` on over a stated part of
it, and the reduction of its device timeline.

Device activity is every kernel, copy and fill on the card.  From the
timeline the reduction takes the union of those intervals (the device's
busy time), the kernels with their names and durations in order of start,
the largest device operations by total time, and the idle gaps between
busy intervals, each labelled with the traced part that was running and
the device operation that ended the gap (what the host was preparing
while the card waited).
"""

from __future__ import annotations

import time
from collections import defaultdict

import torch

NAME_CHARS = 96  # names in the breakdown are cut to this many characters


class Profiler:
    """Profiler on over the parts the harness marks, off elsewhere.  Each
    part is one profiling session, kept with its name, its host-clock
    wall time and its device activity."""

    def __init__(self, cuda: bool):
        self.cuda = cuda
        self.sessions = []  # (part, wall_s, [(kind, name, start, end) ns])
        self._prof = None
        self._t0 = 0.0

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        # the reduction reads device activity only: on a card the host's
        # operators are not recorded, which keeps the profiler's own cost
        # on the host (one record per launch) as low as it goes
        acts = [ProfilerActivity.CUDA if self.cuda else ProfilerActivity.CPU]
        if self.cuda:
            torch.cuda.synchronize()
        self._prof = profile(activities=acts)
        self._prof.__enter__()
        self._t0 = time.perf_counter()

    def stop(self, part: str) -> None:
        if self.cuda:
            torch.cuda.synchronize()
        wall = time.perf_counter() - self._t0
        self._prof.__exit__(None, None, None)
        cuda = torch.autograd.DeviceType.CUDA
        ev = []
        for e in self._prof.profiler.kineto_results.events():
            if e.device_type() == cuda:
                name = e.name()
                s = e.start_ns()
                ev.append((_kind(name), name, s, s + e.duration_ns()))
        self.sessions.append((part, wall, ev))
        self._prof = None


def _kind(name: str) -> str:
    """What a device activity is, from its name (CUPTI names copies
    ``Memcpy ...`` and fills ``Memset ...``; every other is a kernel)."""
    if name.startswith("Memcpy"):
        return "gpu_memcpy"
    if name.startswith("Memset"):
        return "gpu_memset"
    return "kernel"


def busy_intervals(events) -> list[tuple[int, int]]:
    """The union of the events' [start, end) intervals, sorted."""
    out = []
    for _, _, s, e in sorted(events, key=lambda x: x[2]):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def summarize(prof: Profiler, top: int = 10) -> dict:
    """busy_s and wall_s of the traced parts, their kernels (name, seconds
    in start order), launches, the top device operations by total seconds
    and the idle gaps by label."""
    busy_s = wall_s = 0.0
    kernels, gaps = [], defaultdict(float)
    by_name = defaultdict(float)
    for part, wall, ev in prof.sessions:
        wall_s += wall
        ev = sorted(ev, key=lambda x: x[2])
        busy = busy_intervals(ev)
        busy_s += sum(e - s for s, e in busy) / 1e9
        kernels += [(n, (e - s) / 1e9) for k, n, s, e in ev if k == "kernel"]
        for _, n, s, e in ev:
            by_name[n[:NAME_CHARS]] += (e - s) / 1e9
        if not busy:
            gaps[f"{part}: no device work"] += wall
            continue
        # each gap labelled by the device operation that ends it: what
        # the host was preparing while the card waited
        j = 0
        for (_, e0), (s1, _) in zip(busy, busy[1:]):
            while ev[j][2] < s1:
                j += 1
            gaps[f"{part}: before {ev[j][1]}"[:NAME_CHARS]] += (s1 - e0) / 1e9
        # the part's own start and end, before its first and after its
        # last device operation (durations on two clocks: no alignment)
        gaps[f"{part}: start and end"] += max(
            wall - (busy[-1][1] - busy[0][0]) / 1e9, 0.0)
    ops = sorted(by_name.items(), key=lambda x: -x[1])[:top]
    idle = sorted(gaps.items(), key=lambda x: -x[1])[:top]
    return {"busy_s": busy_s, "wall_s": wall_s, "kernels": kernels,
            "launches": len(kernels),
            "breakdown": {"device_ops": [[n, s] for n, s in ops],
                          "idle_gaps": [[n, s] for n, s in idle]}}

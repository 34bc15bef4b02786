"""device.idle_pct: the share of the traced part's wall time in which no
operation (kernel, copy, fill) ran on the card, from the union of the
device intervals on the profiler's timeline.  Nothing without a trace or
without device activity (a run on the CPU)."""


def read(run):
    t = run.trace
    if not t or t["busy_s"] <= 0 or t["wall_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["wall_s"])

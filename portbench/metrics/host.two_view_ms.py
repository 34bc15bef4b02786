"""host.two_view_ms: mean milliseconds of the ``SfMSystem`` stage
``two_view`` (its ``StageTimers``, which end each stage in a
synchronise), over the window's calls made with the profiler off.
Nothing where the entry has no such stage."""

STAGE = "two_view"


def read(run):
    total, calls = run.stage_timers.get(STAGE, (0.0, 0))
    return 1000.0 * total / calls if calls else None

"""host.kf_geometry_ms: mean milliseconds of the ``SfMSystem`` stage
``kf_geometry`` (its ``StageTimers``, which end each stage in a
synchronise), over the window's calls made with the profiler off.
Nothing where the entry has no such stage."""

STAGE = "kf_geometry"


def read(run):
    total, calls = run.stage_timers.get(STAGE, (0.0, 0))
    return 1000.0 * total / calls if calls else None

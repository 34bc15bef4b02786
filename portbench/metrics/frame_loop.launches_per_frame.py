"""frame_loop.launches_per_frame: kernels launched in the traced part per
frame stepped in it (scene-frames in a multi-scene batch).  Nothing
without kernels in the trace (a run on the CPU)."""


def read(run):
    t = run.trace
    if not t or not t["launches"] or not run.traced_frames:
        return None
    return t["launches"] / run.traced_frames

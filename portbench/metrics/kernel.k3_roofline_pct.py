"""kernel.k3_roofline_pct: K3 (``lk_level_fused``) in the traced part as
a share of its roofline: the sum over its launches of the least time the
card could take (``portbench.roofline``, the LK algorithm's operations
and bytes at each launch's shapes against the published peaks) over the
sum of their device times.  Launches are paired in order with the shapes
the harness recorded; nothing when the counts differ or K3 did not run
(a run on the CPU takes its plain version)."""

import sys

from portbench.roofline import lk_level_least_seconds

KERNEL = "lk_level_fused_kernel"


def read(run):
    if not run.trace:
        return None
    times = [s for n, s in run.trace["kernels"] if KERNEL in n]
    shapes = run.k3_shapes
    if not times or len(times) != len(shapes):
        if times or shapes:
            print(f"kernel.k3_roofline_pct: {len(times)} K3 launches in the "
                  f"trace, {len(shapes)} shapes recorded", file=sys.stderr)
        return None
    return 100.0 * sum(map(lk_level_least_seconds, shapes)) / sum(times)

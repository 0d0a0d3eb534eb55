"""Percent of the traced window's device idle time during which the
innermost open program span is `physics.sort` or `physics.substep`
itself (the intervals `glue_host_ms` sums): the device waiting on the
eager glue's dispatch."""

from benchmark.metrics import spans as S
from benchmark.metrics import yardstick as Y
from benchmark.metrics.glue_host_ms import GLUE


def read(run):
    calls = S.calls(run)
    if not calls or not run.trace.device_ops:
        return None
    lo, hi = run.trace.window
    idle = (hi - lo) - Y.busy_us(run.trace)
    if idle <= 0.0:
        return None
    return 100.0 * S.idle_us(run, [iv for c in calls for iv in c.own(GLUE)]) / idle

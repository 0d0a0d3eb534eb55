"""Percent of the traced window in which no operation ran on the device:
1 minus the union of the device intervals over the window."""

from benchmark.metrics import yardstick as Y


def read(run):
    if run.trace is None or not run.trace.device_ops:
        return None
    lo, hi = run.trace.window
    return 100.0 * (1.0 - Y.busy_us(run.trace) / (hi - lo))

"""95th percentile of the wall times of all frames in the window, each
from its start to its host read (Python's `statistics.quantiles`)."""

import statistics


def read(run):
    d = [c - a for a, _, c in run.steps]
    return 1e3 * (statistics.quantiles(d, n=20)[-1] if len(d) > 1 else d[0])

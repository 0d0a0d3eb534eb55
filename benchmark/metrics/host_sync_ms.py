"""Median over the traced calls of the host time in the program's
`sync.*` spans, where the host waits for the device or copies from
pageable host memory to it (0 where a call has none)."""

import statistics

from benchmark.metrics import spans as S


def read(run):
    calls = S.calls(run)
    if not calls:
        return None
    return 1e-3 * statistics.median(sum(b - a for _, a, b in c.named("sync."))
                                    for c in calls)

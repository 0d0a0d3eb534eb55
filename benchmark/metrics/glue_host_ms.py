"""Median over the traced frames of the host time in `physics.sort` and
`physics.substep` not covered by a child span (`kernel.*`, `sync.*`):
the eager glue's dispatch, from the program's own spans."""

import statistics

from benchmark.metrics import spans as S

GLUE = ("physics.sort", "physics.substep")


def read(run):
    calls = S.calls(run)
    if not calls:
        return None
    return 1e-3 * statistics.median(sum(b - a for a, b in c.own(GLUE)) for c in calls)

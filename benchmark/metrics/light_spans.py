"""The lighting bake's spans (`light.block` and the spans under it) of the
traced calls, for the readers of the bake's span metrics.

A call's spans are the tree under the `light.block` span that starts
inside the call's `bench.call` mark, on the marks' clock (as
`spans.calls` pairs the `frame` and `tiles` trees; where the marks moved,
the blocks pair with the marks in order).
"""

from __future__ import annotations

import bisect
import statistics

from benchmark.metrics import spans as S

ROOT = "light.block"


def calls(run) -> list | None:
    """One `spans.Call` per `bench.call` mark; None where the run has no
    trace or no `light.block` spans, or a mark holds none."""
    if run.trace is None:
        return None
    recorded = [s for s in S._program_spans() if s.end]
    outer = [s for s in recorded if s.parent is None and s.name == ROOT]
    marks = [(a, b) for n, a, b in run.trace.spans if n == "bench.call"]
    if not outer or not marks:
        return None
    starts = [s.start * 1e-3 for s in outer]
    if min(abs(starts[-1] - a) for a, _ in marks) < S.MOVED_US:
        picked = []
        for a, b in marks:
            k = bisect.bisect_left(starts, a)
            if k == len(outer) or starts[k] > b:
                return None
            picked.append((outer[k], 0.0))
    elif len(outer) >= len(marks):
        picked = [(s, a - s.start * 1e-3) for s, (a, _) in zip(outer[-len(marks):], marks)]
    else:
        return None
    by_root: dict = {}
    for s in recorded:
        by_root.setdefault(id(S._root(s)), []).append(s)
    return [S.Call([(x, x.start * 1e-3 + off, x.end * 1e-3 + off) for x in by_root[id(s)]])
            for s, off in picked]


def device_ms(run, name: str) -> float | None:
    """Median over the traced calls of the summed device time of the spans
    called `name` (their CUDA events); None where a call has no such span
    or one without events."""
    traced = calls(run)
    if not traced:
        return None
    per = []
    for c in traced:
        d = [s.device_ms for s, _, _ in c.spans if s.name == name]
        if not d or None in d:
            return None
        per.append(sum(d))
    return statistics.median(per)

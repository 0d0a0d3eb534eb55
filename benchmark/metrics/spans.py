"""The program's own spans (`w3d_torch.utils.profiler.spans()`) of the
traced calls, on the trace's time base, for the readers of span metrics.

The program records a span only while a `torch.profiler` session is
live, so the traced slice holds them.  A call's spans are the tree under
its outermost span (`frame` or `tiles`) that starts inside the call's
`bench.call` mark.  The program's clock is the marks' (`time.time_ns()`),
so the offset between them is zero unless `_trace_of` moved the marks;
then each outermost span is placed at its mark's start.
"""

from __future__ import annotations

import bisect
import statistics

from benchmark.metrics import yardstick as Y

OUTER = ("frame", "tiles")
MOVED_US = 1e6          # `_trace_of` moves its marks only by more than a second


class Call:
    """One traced call: its spans as (span, start us, end us) on the
    trace's time base, in the order they opened."""

    def __init__(self, spans: list):
        self.spans = spans

    def named(self, prefix: str) -> list:
        """(span, start, end) of the spans whose name starts with `prefix`."""
        return [(s, a, b) for s, a, b in self.spans if s.name.startswith(prefix)]

    def own(self, names) -> list:
        """(start, end) of the time in which the innermost open span is
        one named in `names`: those spans less their children."""
        kids: dict = {}
        for s, a, b in self.spans:
            kids.setdefault(id(s.parent), []).append((a, b))
        out = []
        for s, a, b in self.spans:
            if s.name in names:
                t = a
                for ka, kb in kids.get(id(s), []):
                    if ka > t:
                        out.append((t, ka))
                    t = max(t, kb)
                if b > t:
                    out.append((t, b))
        return out


def _program_spans() -> list:
    from w3d_torch.utils import profiler
    read = getattr(profiler, "spans", None)     # a program without spans
    return read() if read is not None else []


def _root(s):
    while s.parent is not None:
        s = s.parent
    return s


def calls(run) -> list | None:
    """The traced calls' spans, one `Call` per `bench.call` mark; None
    where the run has no trace or no program spans, where a mark holds no
    outermost span, or where an outermost span ends after its mark."""
    if run.trace is None:
        return None
    recorded = [s for s in _program_spans() if s.end]
    outer = [s for s in recorded if s.parent is None and s.name in OUTER]
    marks = [(a, b) for n, a, b in run.trace.spans if n == "bench.call"]
    if not outer or not marks:
        return None
    starts = [s.start * 1e-3 for s in outer]
    if min(abs(starts[-1] - a) for a, _ in marks) < MOVED_US:
        picked = []
        for a, b in marks:
            k = bisect.bisect_left(starts, a)
            if k == len(outer) or starts[k] > b:
                return None
            picked.append((outer[k], 0.0))
    elif len(outer) >= len(marks):       # the marks moved: pair them in order
        picked = [(s, a - s.start * 1e-3)
                  for s, (a, _) in zip(outer[-len(marks):], marks)]
    else:
        return None
    by_root: dict = {}
    for s in recorded:
        by_root.setdefault(id(_root(s)), []).append(s)
    out = []
    for (s, off), (a, b) in zip(picked, marks):
        if s.end * 1e-3 + off > b:
            return None
        out.append(Call([(x, x.start * 1e-3 + off, x.end * 1e-3 + off)
                         for x in by_root[id(s)]]))
    return out


def idle_us(run, intervals) -> float:
    """Microseconds of `intervals` (start, end) inside the traced window
    in which no device operation ran."""
    lo, hi = run.trace.window
    busy = Y.merged((s, e) for _, s, e in run.trace.device_ops)
    ends = [b for _, b in busy]
    total = 0.0
    for a, b in intervals:
        a, b = max(a, lo), min(b, hi)
        if b <= a:
            continue
        total += b - a
        k = bisect.bisect_right(ends, a)
        while k < len(busy) and busy[k][0] < b:
            total -= min(b, busy[k][1]) - max(a, busy[k][0])
            k += 1
    return total


def device_ms(run, name: str) -> float | None:
    """Median over the traced calls of the summed device time of the
    spans called `name` (their CUDA events); None where a call has no
    such span or one without events."""
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

"""Frame/section timing (port of `3dworld_tpu/utils/profiler.py`): the
reference's RESET_TIME/PRINT_TIME macros and aggregating
`timing_profiler` (count/total/max/avg per label, profiler.cpp:14-50,
3DWorld.h:1323-1328) as a label -> stats registry, copied as it is, and
the program's spans.

A `span` marks one phase of the program (`frame`, `physics.substep`,
`tiles.erode`, `kernel.pairs`, `sync.min_zval`, ...).  It records only
while a `torch.profiler` session is live, so a traced run sees inside the
program's calls and an untraced one pays a flag read per span.  Recorded
spans are read with `spans()`; each closed span also registers its host
time with `GLOBAL_PROFILER`, whose `report()` prints the
print_timing_profiler table of them.

Note on measuring device work: a span's host times say when the host
enqueued the phase; its device time (`device=True`) comes from CUDA
events on the stream.  Asynchronous launches make host times of device
work meaningless unless the scope forces its results.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field

import torch
import torch.autograd.profiler as _autograd_profiler


@dataclass
class _Entry:
    count: int = 0
    total: float = 0.0
    tmax: float = 0.0

    @property
    def avg(self) -> float:
        return self.total / max(self.count, 1)


@dataclass
class TimingProfiler:
    """timing_profiler equivalent: register(label) accumulates stats."""

    entries: dict = field(default_factory=dict)
    enabled: bool = True

    def register(self, label: str, seconds: float) -> None:
        if not self.enabled:
            return
        e = self.entries.setdefault(label, _Entry())
        e.count += 1
        e.total += seconds
        e.tmax = max(e.tmax, seconds)

    @contextlib.contextmanager
    def time(self, label: str):
        """with profiler.time("physics"): ...  (RESET_TIME/PRINT_TIME)"""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.register(label, time.perf_counter() - t0)

    def report(self) -> str:
        """print_timing_profiler-style table."""
        lines = [f"{'label':<32} {'count':>8} {'total_ms':>10} {'avg_ms':>9} {'max_ms':>9}"]
        for k in sorted(self.entries):
            e = self.entries[k]
            lines.append(f"{k:<32} {e.count:>8} {e.total * 1e3:>10.2f} "
                         f"{e.avg * 1e3:>9.3f} {e.tmax * 1e3:>9.3f}")
        return "\n".join(lines)

    def clear(self) -> None:
        self.entries.clear()


GLOBAL_PROFILER = TimingProfiler()

_SPANS: list = []       # recorded spans, in the order they opened
_OPEN: list = []        # the recorded spans open now, innermost last


class Span:
    """One recorded phase: `name`, `parent` (the recorded span open around
    it, or None), `start` and `end` in `time.time_ns()` (0 while open),
    and with `device` a CUDA event recorded on the current stream at each
    end (`events`)."""

    __slots__ = ("name", "device", "parent", "start", "end", "events")

    def __init__(self, name: str, device: bool):
        self.name = name
        self.device = device

    def __enter__(self):
        self.parent = _OPEN[-1] if _OPEN else None
        self.end = 0
        self.events = None
        if self.device:
            self.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))
            self.events[0].record()
        _SPANS.append(self)
        _OPEN.append(self)
        self.start = time.time_ns()
        return self

    def __exit__(self, *exc) -> bool:
        if self.events is not None:
            self.events[1].record()
        self.end = time.time_ns()
        _OPEN.pop()
        GLOBAL_PROFILER.register(self.name, (self.end - self.start) * 1e-9)
        return False

    @property
    def device_ms(self) -> float | None:
        """Device time from the start event to the end event, in ms (waits
        for the end event); None for a span without events."""
        if self.events is None:
            return None
        self.events[1].synchronize()
        return self.events[0].elapsed_time(self.events[1])


_OFF = contextlib.nullcontext()     # the span of a run without a live profiler


def span(name: str, device: bool = False):
    """``with span("physics.sort"): ...`` -- one phase of the program.

    While a `torch.profiler` session is live, a `Span` that records the
    phase; otherwise a shared one that records nothing, after one flag
    read.  Pass `device=True` where the phase's work runs on a card: its
    `device_ms` is then the phase's time on the device's clock, idle time
    included.  Spans nest on one thread."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return Span(name, device)


def spans(clear: bool = False) -> list:
    """The recorded spans, in the order they opened; `clear` forgets them."""
    out = list(_SPANS)
    if clear:
        _SPANS.clear()
    return out

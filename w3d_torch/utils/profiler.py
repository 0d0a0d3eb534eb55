"""Frame/section timing (port of `3dworld_tpu/utils/profiler.py`): the
reference's RESET_TIME/PRINT_TIME macros and aggregating
`timing_profiler` (count/total/max/avg per label, profiler.cpp:14-50,
3DWorld.h:1323-1328) as a label -> stats registry, copied as it is, plus
a `torch.profiler` trace scope in place of the JAX package's xprof hook.

Note on measuring device work: always force results (e.g.
`float(x.sum())` or `torch.cuda.synchronize()`) inside a timed scope —
asynchronous launches otherwise make wall times meaningless.
"""

from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass, field

import torch
from torch.profiler import ProfilerActivity, profile


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
timer = GLOBAL_PROFILER.time


@contextlib.contextmanager
def device_trace(log_dir: str):
    """`torch.profiler` scope over the CPU and, when a card is present, its
    CUDA activity (the counterpart of gpu_timer_t and the JAX package's
    xprof scope); writes a Chrome trace into `log_dir` on exit and yields
    the profiler (its `key_averages()` and `events()` are readable after
    the scope)."""
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))

"""The benchmark's general loop: one cell, one run.

Everything that belongs to one configuration, traffic mix or metric is
found by name, from `BENCHMARK.json`:

- `configs/<config>.json` holds the configuration's sizes as run, its
  source, `assumed` and `reduced`, the `system` that drives it and the
  limits of its correctness check;
- `systems/<system>.py` drives the program for such configurations: it
  makes the inputs from the seed, builds and warms the program, runs one
  step of a traffic mix, keeps the steps it is asked to keep and holds
  them against the plain reference in `reference/`;
- `traffic/<mix>.json` holds the mix's parameters, which the system reads;
- `metrics/<metric>.py` holds one metric's reader, `read(run)`, which
  returns a number or None when the run has nothing for it to read.  A
  metric split by cells (`host_enqueue_ms.pile`, `host_enqueue_ms.batch`)
  is read by the reader of its name before the first dot, unless it has
  one of its own.

A run: set-up (counted in `setup_s`, from the process's start), a closed
loop of steps for `seconds` (each ends in a host read), then with tracing
on a profiled slice of steps instead; the card's peak memory; the check
against the reference; the metrics.  Nothing compiles inside the window:
the set-up has built the kernel library and run every shape.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib
import importlib.util
import json
import os
import random
import subprocess
import sys
import time

from .metrics import yardstick as Y

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
# top-level module names that no run may load: the JAX package, its
# benchmark and JAX itself
FORBIDDEN = ("jax", "jaxlib", "flax", "w3d", "3dworld_tpu", "bench")


@dataclasses.dataclass
class Trace:
    """The profiled slice: device operations and kernels as (name, start
    us, end us), the benchmark's host spans, the slice's window in us and
    the steps in it."""

    device_ops: list
    kernels: list
    spans: list
    window: tuple
    steps: int

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-6


@dataclasses.dataclass
class Run:
    """What a metric reader reads."""

    setup_s: float
    steps: list                 # (start, enqueued, read) host seconds per step
    items_per_step: int
    trace: Trace | None         # with tracing on: the profiled slice
    work: dict                  # the traced steps' work, counted by the check

    @property
    def window_s(self) -> float:
        return self.steps[-1][2] - self.steps[0][0]


def read_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def cell(manifest: dict, workload: str) -> tuple[dict, dict]:
    """(the workload entry, its configuration entry)."""
    for w in manifest["workloads"]:
        if w["name"] == workload:
            for c in manifest["configs"]:
                if c["name"] == w["config"]:
                    return w, c
            raise ValueError(f"{workload}: configuration {w['config']} not listed")
    raise ValueError(f"no workload {workload!r} in BENCHMARK.json")


def metrics_of(manifest: dict, workload: str, trace: bool) -> list:
    """The metrics a run of `workload` reports: the end-to-end ones, or
    with tracing the per-layer ones, that apply to it."""
    key = "per_layer" if trace else "end_to_end"
    return [m for m in manifest[key]
            if "workloads" not in m or workload in m["workloads"]]


def reader_path(bench_dir: str, metric: str) -> str:
    """The reader of `metric`: `metrics/<metric>.py`, or else the one of
    its name before the first dot."""
    own = os.path.join(bench_dir, "metrics", metric + ".py")
    if os.path.isfile(own):
        return own
    return os.path.join(bench_dir, "metrics", metric.split(".")[0] + ".py")


def load_file_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def process_start_boot_s() -> float | None:
    """The process's start on the boot clock, from /proc; None without it."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        return int(fields[19]) / os.sysconf("SC_CLK_TCK")
    except (OSError, IndexError, ValueError):
        return None


def boot_s() -> float:
    return time.clock_gettime(time.CLOCK_BOOTTIME)


def forbidden_modules() -> list:
    return sorted(n for n in list(sys.modules)
                  if n.split(".")[0] in FORBIDDEN)


def power_limit() -> str:
    """The card's name and power limit as `nvidia-smi` reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "unknown"
    except (OSError, subprocess.TimeoutExpired, IndexError):
        return "unknown"


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def _trace_of(prof, n_enter: int, marks: list, steps: int) -> Trace:
    """The device operations of the profiled slice, and the host spans
    `marks` (name, start, end in unix ns), in microseconds.  The profiler
    converts the device's timestamps to unix time; should its trace start
    lie more than a second from the host's clock at its start (`n_enter`),
    the host spans move by the difference."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    kr = prof.profiler.kineto_results
    shift = kr.trace_start_ns() - n_enter
    log(f"trace: the profiler's start lies {shift * 1e-3:.1f} us from the host clock's")
    shift = shift if abs(shift) > 1e9 else 0
    spans = [(n, (a + shift) * 1e-3, (b + shift) * 1e-3) for n, a, b in marks]
    window = (spans[0][1], spans[-1][2]) if spans else (0.0, 0.0)
    ops = [(e.name(), e.start_ns() * 1e-3, e.end_ns() * 1e-3)
           for e in kr.events() if e.device_type() == cuda]
    inside = [o for o in ops if o[2] > window[0] and o[1] < window[1]]
    log(f"trace: {len(inside)} of {len(ops)} device operations in the traced "
        f"window; the first starts {(inside[0][1] - window[0]) if inside else 0:.1f} us "
        f"after it")
    kernels = [o for o in inside if not o[0].startswith(("Memcpy", "Memset"))]
    return Trace(device_ops=inside, kernels=kernels, spans=spans, window=window, steps=steps)


def _short(name: str) -> str:
    """A kernel's name without its return type and argument list."""
    name = name.replace("(anonymous namespace)::", "").replace("void ", "")
    return name.split("(")[0][:100]


def breakdown(trace: Trace) -> dict:
    """The ten device operations that took most time, and the ten longest
    idle gaps, each named by the host span it fell in and the operation
    before it."""
    by: dict = {}
    for n, s, e in trace.device_ops:
        by[_short(n)] = by.get(_short(n), 0.0) + (e - s) * 1e-6
    top = sorted(by.items(), key=lambda kv: -kv[1])[:10]
    lo, hi = trace.window
    busy = [iv for iv in Y.merged((s, e) for _, s, e in trace.device_ops)
            if iv[1] > lo and iv[0] < hi]
    edges = [lo] + [x for iv in busy for x in iv] + [hi]
    gaps = [(edges[k], edges[k + 1]) for k in range(0, len(edges) - 1, 2)
            if edges[k + 1] > edges[k]]
    ends = sorted((e, n) for n, _, e in trace.device_ops)
    out = []
    for s, e in sorted(gaps, key=lambda g: g[0] - g[1])[:10]:
        host = [n for n, a, b in trace.spans if a <= s < b]
        before = [n for t, n in ends if t <= s]
        label = (host[-1] if host else "between steps") + \
            (" after " + _short(before[-1]) if before else "")
        out.append([label, (e - s) * 1e-6])
    return {"device_ops": [[n, v] for n, v in top], "idle_gaps": out}


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", root: str = ROOT, bench_dir: str = BENCH_DIR,
             overrides: dict | None = None, start_boot_s: float | None = None,
             calibrate: bool = False, control: bool = True) -> dict:
    """Run one cell once and return its result line as a dict.  The
    limits' readings are under "checks"; with `calibrate` every reading
    is under "readings", and with `control` too the control's readings on
    the same steps under "control"."""
    import torch
    t_start = boot_s() if start_boot_s is None else start_boot_s
    manifest = read_json(os.path.join(root, "BENCHMARK.json"))
    wl, cent = cell(manifest, workload)
    cfg = read_json(os.path.join(root, cent["file"]))
    traffic = read_json(os.path.join(bench_dir, "traffic", wl["traffic"] + ".json"))
    if overrides:
        cfg = {**cfg, **overrides.get("config", {})}
        traffic = {**traffic, **overrides.get("traffic", {})}
    system = importlib.import_module(f"benchmark.systems.{cfg['system']}")
    readers = [(m, load_file_module(reader_path(bench_dir, m["name"]),
                                    "benchmark_metric_" + m["name"].replace(".", "_")))
               for m in metrics_of(manifest, workload, trace)]
    dev = torch.device(device)

    t_sys = boot_s()
    sut = system.setup(cfg, traffic, seed, dev)
    log(f"set-up: to the system's start {t_sys - t_start:.3f} s, the system "
        f"{boot_s() - t_sys:.3f} s")
    rng = random.Random(seed)
    if trace:
        first = traffic["trace_after"]
        sample = set(range(first, first + traffic["trace_steps"]))
    else:
        sample = set(rng.sample(range(traffic["check_from"]), traffic["check_sample"]))
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.synchronize()

    steps: list = []
    marks: list = []            # host spans of the traced steps, unix ns
    prof = None
    counts0: dict = {}
    t_first = time.perf_counter()
    setup_s = boot_s() - t_start
    i = 0
    while True:
        t0 = time.perf_counter()
        if not trace and i > 0 and t0 - t_first >= seconds:
            break
        if trace and i == traffic["trace_after"] - 1:
            # the device's activity only: recording every host operation
            # would double the host's time per frame.  The profiler starts
            # a step early, since its first device records come late.
            act = torch.profiler.ProfilerActivity
            prof = torch.profiler.profile(
                activities=[act.CUDA if dev.type == "cuda" else act.CPU])
            prof.__enter__()
            n_enter = time.time_ns()
            t0 = time.perf_counter()
        if trace and i == traffic["trace_after"]:
            counts0 = sut.counters()
            t0 = time.perf_counter()
        n0 = time.time_ns()
        out = sut.call(i)
        t1, n1 = time.perf_counter(), time.time_ns()
        sut.read(out)
        t2, n2 = time.perf_counter(), time.time_ns()
        steps.append((t0, t1, t2))
        if trace and i in sample:
            marks += [("bench.call", n0, n1), ("bench.read", n1, n2)]
        sut.keep(i, out, i in sample)
        i += 1
        if trace and i == traffic["trace_after"] + traffic["trace_steps"]:
            break
    counters: dict = {}
    if prof is not None:
        prof.__exit__(None, None, None)
        counters = {k: v - counts0.get(k, 0) for k, v in sut.counters().items()}
    if dev.type == "cuda":
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated(dev)
    else:
        peak = 0
    bad = forbidden_modules()
    if bad:
        raise RuntimeError(f"modules of the JAX package or of JAX are loaded: {bad}")

    traced = sorted(sample) if trace else []
    tr = _trace_of(prof, n_enter, marks, len(traced)) if prof is not None else None
    del prof
    window = steps[-1][2] - steps[0][0]
    log(f"window: {len(steps)} steps in {window:.3f} s, set-up {setup_s:.3f} s")

    sut.close()
    t_check = time.perf_counter()
    check = sut.check("program", work=trace)
    log(f"check against the reference: {time.perf_counter() - t_check:.3f} s")
    limits = cfg["check"]["limits"]
    readings = check["readings"]
    missing = [k for k in limits if k not in readings]
    if missing:
        raise RuntimeError(f"the check read no {missing}")
    correct = all(readings[k] <= lim for k, lim in limits.items())
    run = Run(setup_s=setup_s, steps=steps[-len(traced):] if trace else steps,
              items_per_step=sut.items_per_step, trace=tr, work=check.get("work", {}))
    metrics = {}
    for m, reader in readers:
        v = reader.read(run)
        if v is None:
            if not trace:
                raise RuntimeError(f"end-to-end metric {m['name']} read nothing")
            continue
        metrics[m["name"]] = {"value": v, "unit": m["unit"]}

    info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
            "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else dev.type,
            "count": int(wl["chips"]), "memory_peak_bytes": int(peak)}
    if dev.type == "cuda":
        info["power_limit"] = power_limit()
    if tr is not None:
        info["busy_s"] = Y.busy_us(tr) * 1e-6
        info["window_s"] = tr.window_s
    result = {"correct": bool(correct), "attempted": len(steps),
              "failed": int(check["failed"]), "metrics": metrics, "device": info}
    if tr is not None:
        result["breakdown"] = breakdown(tr)
        result["counters"] = counters
    for k, v in readings.items():
        if k not in limits:
            log(f"reading {k} {v!r} (not compared)")
    if calibrate:
        result["readings"] = readings
        if control:
            result["control"] = sut.check("control", work=False)["readings"]
    result["checks"] = {k: {"value": readings[k], "limit": lim} for k, lim in limits.items()}
    return result

"""The benchmark's yardstick for per-layer metrics: the card's published
peaks, each kernel's least time from the operations and bytes its inputs
need, and the device's busy time in a profiler trace.

`bound_ms`, `pairs_bound` and `erosion_bound` (with their operation
counts) are copies of `w3d_torch/utils/kernel_probe.py`'s, the narrow
phase's bound is the one of `chip_smoke.py`'s kernel phase, and
`busy_us` is `w3d_torch/utils/profile_step.device_busy`'s union of
kernel intervals; they live here so that a change to the program cannot
change how it is measured.
"""

from __future__ import annotations

import statistics

HBM_BYTES_PER_S = 3.35e12    # H100 SXM device memory (NVIDIA data sheet)
FP32_OPS_PER_S = 67e12       # H100 SXM float32 outside the tensor cores

# operations per unit of work, counted from the kernel sources (adds,
# multiplies, divides, square roots, min/max and compares each count one)
EROSION_OPS = {"live": 80,      # one droplet step's read and update
               "deposit": 14,   # a bilinear deposit's four taps
               "erode": 128}    # a 4x4 erosion stencil
PAIR_TEST_OPS = 12              # offsets, squared distance, sqrt, compare
PAIR_HIT_OPS = 50               # both sides' push and impulse terms
COBJ_TEST_OPS = 20              # per object and live cobj slot
COBJ_FIELDS = 27                # float columns of a cobj row the kernel reads


def bound_ms(nbytes: float, nops: float) -> tuple[float, str]:
    """(least ms the card could take, "bytes" or "operations"): the larger
    of the bytes over the memory rate and the operations over the float32
    rate."""
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    to = nops / FP32_OPS_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def pairs_bound(n: int, valid: int, hits: int) -> tuple[float, str]:
    """The banded pair pass over n sorted rows: 9 input columns and the
    active mask read, 6 deltas written; a test per valid pair in the band
    and the push and impulse per touching pair."""
    nbytes = 9 * n * 4 + n + 6 * n * 4
    return bound_ms(nbytes, PAIR_TEST_OPS * valid + PAIR_HIT_OPS * hits)


def erosion_bound(map_cells: int, droplets: int, angles: int,
                  stats: dict) -> tuple[float, str]:
    """One batch walk: the maps read and the deltas written, the start
    cells and directions read, the six parameters; the droplet-steps,
    deposits and stencils these droplets took."""
    nbytes = 2 * map_cells * 4 + 2 * droplets * 4 + angles * 4 + 24
    nops = sum(EROSION_OPS[k] * int(stats[k]) for k in EROSION_OPS)
    return bound_ms(nbytes, nops)


def narrow_bound(n: int, slots: int, live: int) -> tuple[float, str]:
    """The narrow phase of n spheres against a table of `slots` rows, of
    which `live` hold cobjs: 4 inputs and 6 outputs and the hit mask per
    sphere, the table once; a test per sphere and live slot."""
    m4 = -(-slots // 4) * 4
    return bound_ms((10 * 4 + 1) * n + COBJ_FIELDS * m4 * 4 + 32,
                    COBJ_TEST_OPS * n * live)


# ---------------------------------------------------------------------------
# the trace
# ---------------------------------------------------------------------------

def merged(intervals) -> list:
    """Sorted, non-overlapping union of (start, end) intervals."""
    out: list = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def busy_us(trace) -> float:
    """Microseconds in which any device operation ran, inside the traced
    window."""
    lo, hi = trace.window
    return sum(min(e, hi) - max(s, lo) for s, e in merged(
        (s, e) for _, s, e in trace.device_ops) if e > lo and s < hi)


def kernel_us(trace, name: str) -> float:
    """Summed device time of the kernels whose name contains `name`."""
    return sum(e - s for n, s, e in trace.kernels if name in n)


def kernel_count(trace, name: str) -> int:
    return sum(1 for n, _, _ in trace.kernels if name in n)


def roofline(trace, kernel: str, bound_ms_total: float) -> float | None:
    """Percent of `kernel`'s summed device time that its bound is; None
    where the trace holds no such kernel."""
    us = kernel_us(trace, kernel)
    if us <= 0.0 or bound_ms_total <= 0.0:
        return None
    return 100.0 * bound_ms_total * 1e3 / us


def median_ms(pairs) -> float | None:
    """Median of (start, end) host-clock spans in seconds, in ms."""
    d = [e - s for s, e in pairs]
    return 1e3 * statistics.median(d) if d else None

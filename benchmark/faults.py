"""Faults planted in the program's timed path, to read what the check
makes of them: `benchmark.calibrate --fault <name>` on the card at a
cell's own size, and `tests/test_bench_faults.py` on the CPU.

The erosion faults replace the program's erosion walk
(`w3d_torch/ops/cuda/erosion_kernel.erosion_walk`, the CUDA kernel on the
card, its plain version on the CPU) by a broken one:

- `walk_zero`: the walk returns no change at all;
- `walk_half`: the second half of each batch's droplets starts dead;
- `walk_no_rock`: the rock threshold lies above every relative height,
  so rock erodes at dirt's rate (2x where the engine erodes 0.5x).
"""

from __future__ import annotations

import contextlib

import torch

from w3d_torch.ops.cuda import erosion_kernel as EK

ROCK_THRESHOLD = 4   # index in the walk's six parameters


def _walk_zero(walk):
    def broken(hm, xi, zi, angles, p6):
        return torch.zeros_like(hm)
    return broken


def _walk_half(walk):
    def broken(hm, xi, zi, angles, p6):
        b = xi.shape[1] // 2
        dead = lambda v: torch.cat([v[:, :b], torch.full_like(v[:, b:], -10)], 1)
        return walk(hm, dead(xi).contiguous(), dead(zi).contiguous(), angles, p6)
    return broken


def _walk_no_rock(walk):
    def broken(hm, xi, zi, angles, p6):
        p = p6.clone()
        p[ROCK_THRESHOLD] = 2.0
        return walk(hm, xi, zi, angles, p)
    return broken


FAULTS = {"walk_zero": _walk_zero, "walk_half": _walk_half, "walk_no_rock": _walk_no_rock}


@contextlib.contextmanager
def planted(name: str):
    """The program with fault `name` in place of its erosion walk."""
    walk = EK.erosion_walk
    EK.erosion_walk = FAULTS[name](walk)
    try:
        yield
    finally:
        EK.erosion_walk = walk

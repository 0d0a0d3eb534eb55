"""Voxel ambient occlusion: per-cell openness from directional marches
(port of `3dworld_tpu/voxel/ao.py`).

The reference computes an `ao_lighting` grid over the voxel model with
flow-based propagation (voxels.h voxel_model).  Here, as in the JAX
package: for each cell, march 9 upward/lateral directions through the
solid mask with linearly growing steps (the tile-AO pattern lifted to
3-D); the occlusion contribution decays with first-hit distance.
"""

from __future__ import annotations

import torch

from ..ops.fmath import div32

# 9 directions: up, 4 laterals, 4 upward diagonals
_DIRS = [(0, 0, 1), (1, 0, 0), (-1, 0, 0), (0, 1, 0), (0, -1, 0),
         (1, 0, 1), (-1, 0, 1), (0, 1, 1), (0, -1, 1)]
NUM_STEPS = 4


def _shift3(a: torch.Tensor, dx: int, dy: int, dz: int) -> torch.Tensor:
    """out[z, y, x] = a[z + dz, y + dy, x + dx]; outside the grid is open
    (False)."""
    out = torch.zeros_like(a)
    if any(abs(d) >= n for d, n in zip((dz, dy, dx), a.shape)):
        return out
    src = tuple(slice(max(d, 0), n + min(d, 0)) for d, n in zip((dz, dy, dx), a.shape))
    dst = tuple(slice(max(-d, 0), n - max(d, 0)) for d, n in zip((dz, dy, dx), a.shape))
    out[dst] = a[src]
    return out


def voxel_ao(values: torch.Tensor, isolevel: float = 0.0) -> torch.Tensor:
    """AO in [0, 1] per voxel cell ([nz, ny, nx]); 1 = fully open."""
    solid = values < isolevel
    atten = torch.zeros(values.shape, dtype=torch.float32, device=values.device)
    total = 0.0
    for (dx, dy, dz) in _DIRS:
        not_hit = torch.ones_like(solid)
        off = 0
        for s in range(NUM_STEPS):
            off += s + 1  # triangular growth like tile AO
            hit = _shift3(solid, dx * off, dy * off, dz * off) & not_hit
            atten = atten + hit.to(torch.float32) * (NUM_STEPS - s)
            not_hit = not_hit & ~hit
        total += NUM_STEPS
    return 1.0 - div32(atten, total)

"""Tile ambient obscurance: 8-direction horizon ray march (port of
`3dworld_tpu/ops/ao.py`).

Re-expresses `tile_t::calc_mesh_ao_lighting` (tiled_mesh.cpp:586-661):
8 compass directions x NUM_AO_STEPS steps with linearly growing stride
(offsets = dir * s(s+1)/2, max AO_RAY_LEN=36 cells), ray rising
dz = 0.5*HALF_DXY per step; the FIRST occluding step s contributes
(NUM_AO_STEPS - s) obscurance; ao = 1 - atten / (8 * NUM_AO_STEPS).

Every (dir, step) pair is one whole-grid compare of a strided slice of
the padded context heightmap; batches over tiles on a leading axis.
"""

from __future__ import annotations

import torch

NUM_AO_DIRS = 8
NUM_AO_STEPS = 8
AO_RAY_LEN = NUM_AO_STEPS * (NUM_AO_STEPS + 1) // 2  # 36 (triangular)

_DIRS = [(x, y) for y in (-1, 0, 1) for x in (-1, 0, 1) if (x, y) != (0, 0)]
_TRI = [s * (s + 1) // 2 for s in range(1, NUM_AO_STEPS + 1)]  # 1,3,6,...,36


def tile_ao(context_zvals: torch.Tensor, stride: int, dz: float) -> torch.Tensor:
    """AO for the tile interior.

    context_zvals: [..., C, C] with C = stride + 2*AO_RAY_LEN (tile zvals
    padded by the halo the rays march through; may be batched over tiles).
    dz: per-step ray rise = 0.5*HALF_DXY.  Returns ao in [0,1],
    [..., stride, stride].
    """
    C = context_zvals.shape[-1]
    assert C == stride + 2 * AO_RAY_LEN, (C, stride)
    h = AO_RAY_LEN
    z0 = context_zvals[..., h:h + stride, h:h + stride]
    atten = torch.zeros_like(z0)
    for dx, dy in _DIRS:
        not_hit = torch.ones_like(z0, dtype=torch.bool)
        for s in range(NUM_AO_STEPS):
            off = _TRI[s]
            ys = h + dy * off
            xs = h + dx * off
            zn = context_zvals[..., ys:ys + stride, xs:xs + stride]
            hit = (zn > z0 + dz * (s + 1)) & not_hit
            atten = atten + hit.to(z0.dtype) * (NUM_AO_STEPS - s)
            not_hit = not_hit & ~hit
    return 1.0 - atten / (NUM_AO_DIRS * NUM_AO_STEPS)

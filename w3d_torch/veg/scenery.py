"""Scenery placement (port of `ScenerySet` and `place_scenery` from
`3dworld_tpu/veg/scenery.py`).

The reference scatters scenery objects (rocks, voxel rocks, logs, stumps,
plants) with type-specific generation (scenery.cpp:1643).  Placement is a
hash per mesh cell: the cells that pass a density test on flat enough
ground, lowest hash first.  The JAX package sorts the uint32 score with a
stable `argsort`, many cells tying at 0xFFFFFFFF; the port sorts an int64
copy of the same key stably, so ties and the `max_objs` cut fall as in
the JAX package.  The generators (rock meshes, logs, plants) are not
ported.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..utils import rng as w3d_rng

S_ROCK, S_VOXEL_ROCK, S_LOG, S_STUMP, S_PLANT = range(5)


class ScenerySet(NamedTuple):
    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor
    kind: torch.Tensor     # S_* id
    size: torch.Tensor
    rot: torch.Tensor      # orientation angle (logs)
    valid: torch.Tensor


def place_scenery(seed: int, tile_x0: float, tile_y0: float,
                  zvals: torch.Tensor, norm_z: torch.Tensor, world,
                  density: float = 0.3, max_objs: int = 128) -> ScenerySet:
    """Up to `max_objs` objects over the [my, mx] height grid `zvals`
    (world x of column c is (tile_x0 + c) * dx), on cells whose normal's z
    (`norm_z`) exceeds 0.5; on `zvals`' device."""
    my, mx = zvals.shape
    cell = torch.arange(my * mx, dtype=torch.int64, device=zvals.device)
    h = w3d_rng.xxhash_u32(cell, seed=seed ^ 0x5CE9)        # int64 in [0, 2^32)
    u = (h >> 8).to(torch.float32) / (1 << 24)
    ok = (u < density * 0.05) & (norm_z.reshape(-1) > 0.5)
    score = torch.where(ok, h, 0xFFFFFFFF)
    order = torch.argsort(score, stable=True)[:max_objs]
    valid = ok[order]
    cy = torch.div(order, mx, rounding_mode="floor").to(torch.float32)
    cx = (order % mx).to(torch.float32)
    h2 = w3d_rng.xxhash_u32(order, seed=seed + 7)
    kind = (h2 % 5).to(torch.int32)
    size = 0.02 + 0.06 * ((h2 >> 8).to(torch.float32) / (1 << 24))
    rot = 2 * math.pi * ((h2 >> 16).to(torch.float32) / (1 << 16))
    return ScenerySet(
        x=(tile_x0 + cx) * world.dx, y=(tile_y0 + cy) * world.dy,
        z=zvals.reshape(-1)[order],
        kind=kind, size=size, rot=rot, valid=valid,
    )

"""Realtime voxel editing: brushes, modified-block tracking and falling
chunks (port of `3dworld_tpu/voxel/edit.py`).

Reference: brush system with cube/constant/linear/quadratic falloff shapes
(voxels.h:11,40-56), applied by `update_voxel_sphere_region`
(voxels.cpp:1283,2112), with modified blocks queued and re-meshed next
frame (`proc_voxel_updates`, voxels.cpp:2118) and a brush journal for
save/undo (voxels.cpp:2135+).  A brush is one masked add over the whole
grid; block-level change tracking uses the reference's num_blocks XY
chunking.  The journal's file format is the JAX package's (one float32
row per brush in an .npy), so either package replays the other's.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops.fmath import div32, sqrt32
from .grid import flood

# voxels.h:11
VB_SHAPE_CUBE = 0
VB_SHAPE_CONSTANT = 1
VB_SHAPE_LINEAR = 2
VB_SHAPE_QUADRATIC = 3


class Brush(NamedTuple):
    """One brush application (voxel_brush_t): center, radius, weight, shape."""

    center: tuple
    radius: float
    weight: float       # positive adds material (lowers density value)
    shape: int = VB_SHAPE_LINEAR


def apply_brush(values: torch.Tensor, lo_pos, vsz, center, radius, weight,
                shape: int = VB_SHAPE_LINEAR) -> torch.Tensor:
    """Apply one brush to the [nz, ny, nx] density grid.

    Material add = subtracting from the density (solid is < isolevel).
    Falloff by shape: cube (sharp box), constant (sharp sphere), linear
    (1 - d/r), quadratic (1 - (d/r)^2)."""
    nz, ny, nx = values.shape
    ar = lambda n: torch.arange(n, dtype=torch.float32, device=values.device)
    dx = (lo_pos[0] + vsz[0] * ar(nx)[None, None, :]) - center[0]
    dy = (lo_pos[1] + vsz[1] * ar(ny)[None, :, None]) - center[1]
    dz = (lo_pos[2] + vsz[2] * ar(nz)[:, None, None]) - center[2]
    r = float(np.float32(radius))
    if shape == VB_SHAPE_CUBE:
        fall = ((torch.abs(dx) <= r) & (torch.abs(dy) <= r) & (torch.abs(dz) <= r)
                ).to(torch.float32)
    else:
        d = sqrt32(dx * dx + dy * dy + dz * dz)
        if shape == VB_SHAPE_CONSTANT:
            fall = (d <= r).to(torch.float32)
        elif shape == VB_SHAPE_QUADRATIC:
            q = div32(d, r)
            fall = torch.clamp(1.0 - q * q, min=0.0)
        else:  # linear
            fall = torch.clamp(1.0 - div32(d, r), min=0.0)
    return values - float(np.float32(weight)) * fall


def modified_blocks(center, radius, lo_pos, vsz, grid_shape, num_blocks: int):
    """Which (bx, by) XY blocks a brush touches (host-side; mirrors the
    reference's modified-block queue keyed by num_blocks^2 chunks)."""
    nz, ny, nx = grid_shape
    bx_sz = max(1, nx // num_blocks)
    by_sz = max(1, ny // num_blocks)
    x0 = int((center[0] - radius - lo_pos[0]) / vsz[0])
    x1 = int((center[0] + radius - lo_pos[0]) / vsz[0])
    y0 = int((center[1] - radius - lo_pos[1]) / vsz[1])
    y1 = int((center[1] + radius - lo_pos[1]) / vsz[1])
    out = set()
    for by in range(max(0, y0 // by_sz), min(num_blocks - 1, y1 // by_sz) + 1):
        for bx in range(max(0, x0 // bx_sz), min(num_blocks - 1, x1 // bx_sz) + 1):
            out.add((bx, by))
    return sorted(out)


class BrushJournal:
    """Brush history for save/undo (voxels.cpp:2135+ brush journal files)."""

    def __init__(self):
        self.brushes: list[Brush] = []

    def add(self, brush: Brush):
        self.brushes.append(brush)

    def undo(self):
        return self.brushes.pop() if self.brushes else None

    def replay(self, values, lo_pos, vsz):
        for b in self.brushes:
            values = apply_brush(values, lo_pos, vsz, b.center, b.radius,
                                 b.weight, b.shape)
        return values

    def save(self, path: str):
        arr = np.array([(b.center[0], b.center[1], b.center[2], b.radius,
                         b.weight, b.shape) for b in self.brushes], np.float32)
        np.save(path, arr)

    @classmethod
    def load(cls, path: str) -> "BrushJournal":
        j = cls()
        for row in np.load(path):
            j.add(Brush((float(row[0]), float(row[1]), float(row[2])),
                        float(row[3]), float(row[4]), int(row[5])))
        return j


# ---------------------------------------------------------------------------
# falling / unsupported chunks (voxels.cpp:606-716)
# ---------------------------------------------------------------------------
#
# After an edit, the reference flood-fills an "anchored" region from the
# mesh-contact voxels through 6-connected solid cells
# (remove_unconnected_outside_range + flood_fill_range, voxels.cpp:759-830);
# solid voxels left unanchored shift down ONE z level per drop tick until
# they land (voxels.cpp:694-716).


def _dilate6(mask: torch.Tensor) -> torch.Tensor:
    """6-neighbourhood (face-adjacent) binary dilation — the reference
    flood connectivity (FLOOD_FILL_INNER steps one axis at a time)."""
    out = mask.clone()
    for ax in range(3):
        n = mask.shape[ax]
        lo = [slice(None)] * 3
        hi = [slice(None)] * 3
        lo[ax], hi[ax] = slice(0, n - 1), slice(1, n)
        out[tuple(hi)] |= mask[tuple(lo)]
        out[tuple(lo)] |= mask[tuple(hi)]
    return out


def falling_mask(values: torch.Tensor, isolevel: float,
                 anchor_layers: int = 1) -> torch.Tensor:
    """[nz,ny,nx] bool: solid voxels NOT 6-connected to the bottom
    `anchor_layers` ground-contact layers (the unanchored set of
    remove_unconnected_outside_range)."""
    solid = values < isolevel
    seed = torch.zeros_like(solid)
    seed[:anchor_layers] = solid[:anchor_layers]
    return solid & ~flood(seed, solid, _dilate6)


def drop_unanchored_step(values: torch.Tensor, isolevel: float,
                         air_val: float = 1.0, anchor_layers: int = 1):
    """ONE drop tick: every unanchored solid voxel moves down one z level
    (voxels.cpp:706-714 — vacate the cell, write the value one step
    down).  Returns (new_values, any_fell) with any_fell a 0-d bool
    tensor."""
    fall = falling_mask(values, isolevel, anchor_layers=anchor_layers)
    vacated = torch.where(fall, isolevel + air_val, values)
    fall_above = torch.cat([fall[1:], torch.zeros_like(fall[:1])], dim=0)
    vals_above = torch.cat([values[1:], values[-1:]], dim=0)
    return torch.where(fall_above, vals_above, vacated), fall.any()


def settle_unanchored(values: torch.Tensor, isolevel: float,
                      air_val: float = 1.0, anchor_layers: int = 1,
                      max_steps: int | None = None):
    """Iterate drop ticks until every chunk lands (the reference reaches
    the same state over successive frames via next_frame_modified_blocks,
    voxels.cpp:685), at most `max_steps` (default nz) ticks.  Returns
    (values, steps_fallen) with steps_fallen a 0-d int32 tensor.  A tick
    after the chunks have landed changes nothing, so the loop reads
    whether anything fell only every few ticks."""
    if max_steps is None:
        max_steps = values.shape[0]
    steps = torch.zeros((), dtype=torch.int32, device=values.device)
    fell = torch.ones((), dtype=torch.bool, device=values.device)
    for i in range(max_steps):
        values, fell = drop_unanchored_step(values, isolevel, air_val=air_val,
                                            anchor_layers=anchor_layers)
        steps = steps + fell.to(torch.int32)
        if i % 4 == 3 and not bool(fell):
            break
    return values, steps

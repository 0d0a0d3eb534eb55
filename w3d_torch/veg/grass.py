"""Grass: per-blade tile blocks with wind animation and burn/cut state
(port of `3dworld_tpu/veg/grass.py`).

The reference generates per-blade grass quads in tile blocks with density
maps, wind sway, and burnable/cuttable per-blade state (grass.cpp:1141,
grass_tile_manager_t grass.h:58).  Here a tile's blades are hashed SoA
tensors (position/dir/height) on the tile's device, wind sway is one
elementwise pass over all blades, and burn/cut state is a per-blade
scalar.  The hashes are `utils/rng.xxhash_u32` (uint32 lanes in int64);
a blade's angle rounds the uint32 hash to float32 before the float
modulo, as the JAX package does, and sines and cosines go through
`ops/fmath`, so the card and the CPU give the same bits.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops.fmath import cos32, sin32, sqrt32
from ..utils import rng as w3d_rng


def _u24(h: torch.Tensor) -> torch.Tensor:
    """A hash's top 24 bits as a float32 in [0, 1)."""
    return (h >> 8).to(torch.float32) / float(1 << 24)


def _f32(v, device) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.float32, device=device)


class GrassBlock(NamedTuple):
    """SoA blades for one tile block."""

    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor
    dir_x: torch.Tensor    # blade lean direction
    dir_y: torch.Tensor
    height: torch.Tensor
    width: torch.Tensor
    burn: torch.Tensor     # 0 = green, 1 = fully burned
    cut: torch.Tensor      # remaining height fraction (cuttable state)


def gen_grass_block(seed: int, tile_x0: float, tile_y0: float,
                    zvals, grass_weight, world, blades_per_cell: int = 4,
                    grass_length: float = 0.02) -> GrassBlock:
    """Blades for a tile: positions hashed per (cell, blade); density
    gated by the biome grass weight (grass density maps); on `zvals`'
    device."""
    my, mx = zvals.shape
    dev = zvals.device
    n = my * mx * blades_per_cell
    idx = torch.arange(n, dtype=torch.int64, device=dev)
    cell = torch.div(idx, blades_per_cell, rounding_mode="floor")
    h1 = w3d_rng.xxhash_u32(idx, seed=seed)
    h2 = w3d_rng.xxhash_u32(idx, seed=seed + 1)
    h3 = w3d_rng.xxhash_u32(idx, seed=seed + 2)
    u1, u2, u3 = _u24(h1), _u24(h2), _u24(h3)
    cy = torch.div(cell, mx, rounding_mode="floor").to(torch.float32)
    cx = (cell % mx).to(torch.float32)
    gx = tile_x0 + cx + u1
    gy = tile_y0 + cy + u2
    x = gx * world.dx
    y = gy * world.dy
    z = zvals.reshape(-1)[cell]
    gw = grass_weight.reshape(-1)[cell]
    keep = u3 < gw  # density by grass biome weight
    # the uint32 hash rounds to float32 first, then a float modulo
    ang = 2 * np.pi * ((h1 ^ h2).to(torch.float32) % 1024) / 1024.0
    height = grass_length * (0.7 + 0.6 * u2) * keep.to(torch.float32)
    return GrassBlock(
        x=x, y=y, z=z, dir_x=cos32(ang), dir_y=sin32(ang),
        height=height,
        width=torch.full((n,), 0.1 * grass_length, dtype=torch.float32, device=dev),
        burn=torch.zeros((n,), dtype=torch.float32, device=dev),
        cut=torch.ones((n,), dtype=torch.float32, device=dev),
    )


def wind_sway(block: GrassBlock, wind_x, wind_y, time):
    """Per-blade wind offset at the blade tip (grass wind animation):
    phase from position, amplitude from wind speed and blade height.
    Returns the tips' (x, y, z)."""
    dev = block.x.device
    wind_x, wind_y, time = (_f32(v, dev) for v in (wind_x, wind_y, time))
    phase = 2.3 * block.x + 1.7 * block.y + 2.0 * time
    amp = 0.35 * sqrt32(wind_x * wind_x + wind_y * wind_y)
    sway = amp * (0.6 + 0.4 * sin32(phase)) * block.height * block.cut
    return block.x + sway * wind_x, block.y + sway * wind_y, \
        block.z + block.height * block.cut


def burn_grass_at(block: GrassBlock, cx, cy, radius, amount=1.0):
    """Ground-fire burn (enable_grass_fire / burn_grass semantics)."""
    dev = block.x.device
    cx, cy, radius, amount = (_f32(v, dev) for v in (cx, cy, radius, amount))
    d2 = (block.x - cx) ** 2 + (block.y - cy) ** 2
    f = torch.clamp(1.0 - d2 / torch.clamp(radius * radius, min=1e-9), min=0.0)
    return block._replace(burn=torch.clamp(block.burn + amount * f, 0.0, 1.0))


def cut_grass_at(block: GrassBlock, cx, cy, radius, height_frac=0.25):
    """Mow grass in a radius (modify_grass_at cut path)."""
    dev = block.x.device
    cx, cy, radius, height_frac = (_f32(v, dev) for v in (cx, cy, radius, height_frac))
    d2 = (block.x - cx) ** 2 + (block.y - cy) ** 2
    inside = d2 <= radius * radius
    return block._replace(cut=torch.where(inside, torch.minimum(block.cut, height_frac),
                                          block.cut))


# ---------------------------------------------------------------------------
# flowers (flower_manager_t::add_flowers, grass.cpp:813-839): per-cell
# flower_density * grass_density flowers, a sine-noise density test, and
# colors {WHITE, YELLOW, LT_BLUE} from a second noise field
# ---------------------------------------------------------------------------

FLOWER_COLORS = ((1.0, 1.0, 1.0),     # WHITE
                 (1.0, 1.0, 0.0),     # YELLOW
                 (0.6, 0.8, 1.0))     # LT_BLUE


class FlowerSet(NamedTuple):
    """SoA flowers for one tile block (flower_t fields)."""

    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor
    nx: torch.Tensor       # facing normal (mostly +z)
    ny: torch.Tensor
    nz: torch.Tensor
    radius: torch.Tensor
    height: torch.Tensor
    color: torch.Tensor    # [N, 3]
    alive: torch.Tensor    # density-gated mask


def gen_flowers(seed: int, tile_x0: float, tile_y0: float, zvals,
                grass_weight, world, flower_density: float = 1.0,
                grass_length: float = 0.02, grass_width: float = 0.002,
                max_per_cell: int = 2) -> FlowerSet:
    """Flowers for a tile: cells with grass density >= 0.5 spawn up to
    round(flower_density * density) flowers, gated by a hashed noise
    test (the reference's two force_sine density_gen fields are stood in
    by two xxhash-derived fields; same mechanism: one gates placement,
    one picks the color); on `zvals`' device."""
    my, mx = zvals.shape
    dev = zvals.device
    n = my * mx * max_per_cell
    idx = torch.arange(n, dtype=torch.int64, device=dev)
    cell = torch.div(idx, max_per_cell, rounding_mode="floor")
    slot = (idx % max_per_cell).to(torch.float32)
    u1 = _u24(w3d_rng.xxhash_u32(idx, seed=seed + 0xF10))
    u2 = _u24(w3d_rng.xxhash_u32(idx, seed=seed + 0xF11))
    u3 = _u24(w3d_rng.xxhash_u32(idx, seed=seed + 0xF12))
    dval = _u24(w3d_rng.xxhash_u32(cell, seed=seed + 0xF13))
    cval = _u24(w3d_rng.xxhash_u32(cell, seed=seed + 0xF14))
    gden = grass_weight.reshape(-1)[cell]
    num_per_bin = torch.round(flower_density * gden)
    keep = (gden >= 0.5) & (slot < num_per_bin)
    # density-function test (dval + jitter > hthresh -> skip)
    keep = keep & ((dval + 0.2 * (u1 - 0.5)) <= 0.75)
    cy = torch.div(cell, mx, rounding_mode="floor").to(torch.float32)
    cx = (cell % mx).to(torch.float32)
    x = (tile_x0 + cx + u1) * world.dx
    y = (tile_y0 + cy + u2) * world.dy
    z = zvals.reshape(-1)[cell]
    height = grass_length * (0.85 + 0.15 * u2)
    radius = grass_width * (1.5 + 1.0 * u3)
    # normal: +z with +-0.2 jitter
    jx = 0.2 * (2.0 * u1 - 1.0)
    jy = 0.2 * (2.0 * u3 - 1.0)
    nl = sqrt32(jx * jx + jy * jy + 1.0)
    cols = torch.tensor(FLOWER_COLORS, dtype=torch.float32, device=dev)
    cidx = (0.5 * 3 * (cval + 0.25 * (2.0 * u3 - 1.0))).to(torch.int32) % 3
    return FlowerSet(
        x=x, y=y, z=z + height,
        nx=jx / nl, ny=jy / nl, nz=1.0 / nl,
        radius=radius, height=height,
        color=cols[cidx.long()], alive=keep)


# ---------------------------------------------------------------------------
# ground fire spread (enable_grass_fire / add_ground_fire: fire creeps
# across grass cells, biased downwind, consuming fuel)
# ---------------------------------------------------------------------------

class GroundFire(NamedTuple):
    """Cell grids: fire intensity [my, mx] and remaining fuel [my, mx]
    (fuel ~ unburned grass density)."""

    intensity: torch.Tensor
    fuel: torch.Tensor


def make_ground_fire(fuel_map, device: torch.device | str = "cuda") -> GroundFire:
    f = torch.as_tensor(fuel_map, dtype=torch.float32, device=device)
    return GroundFire(intensity=torch.zeros_like(f), fuel=f)


def ignite_at(gf: GroundFire, gx: int, gy: int, amount: float = 1.0):
    intensity = gf.intensity.clone()
    intensity[gy, gx] += amount
    return gf._replace(intensity=intensity)


def step_ground_fire(gf: GroundFire, wind_x, wind_y,
                     spread: float = 0.35, burn_rate: float = 0.15,
                     decay: float = 0.9, ignite_thresh: float = 0.05
                     ) -> GroundFire:
    """One spread tick: intensity diffuses to the 4-neighborhood with a
    downwind bias, ignites cells with fuel, consumes fuel, and decays
    where fuel is gone — the reference's creeping grass fire as a
    cellular automaton (one stencil, no scatter)."""
    I = gf.intensity
    dev = I.device
    wind_x, wind_y = _f32(wind_x, dev), _f32(wind_y, dev)
    wxp = torch.clamp(wind_x, 0.0, 10.0)
    wxn = torch.clamp(-wind_x, 0.0, 10.0)
    wyp = torch.clamp(wind_y, 0.0, 10.0)
    wyn = torch.clamp(-wind_y, 0.0, 10.0)
    # neighbor inflow, upwind neighbors contribute more downwind
    inflow = (torch.roll(I, 1, 1) * (1.0 + wxp) + torch.roll(I, -1, 1) * (1.0 + wxn)
              + torch.roll(I, 1, 0) * (1.0 + wyp) + torch.roll(I, -1, 0) * (1.0 + wyn))
    spread_in = inflow * spread * 0.25
    catch = (spread_in > ignite_thresh) & (gf.fuel > 0.05)
    intensity = torch.where(catch, torch.maximum(I, spread_in), I)
    burning = intensity > ignite_thresh
    burn = torch.minimum(gf.fuel, burn_rate * intensity) * burning
    fuel = gf.fuel - burn
    # fire feeds on fuel (front self-sustains) and decays on spent cells
    intensity = torch.where(burning & (fuel > 0.05),
                            torch.clamp(intensity * 1.4, max=1.5),
                            intensity * decay)
    intensity = torch.where(intensity < 1e-3, 0.0, intensity)
    return GroundFire(intensity=intensity, fuel=fuel)


def scorch_grass(block: GrassBlock, gf: GroundFire, world,
                 rate: float = 0.3) -> GrassBlock:
    """Apply the fire grid to per-blade burn state (nearest-cell sample of
    intensity at each blade, like burn_grass_at but field-driven)."""
    my, mx = gf.intensity.shape
    gx = torch.clamp(block.x * world.dx_inv + mx // 2, 0, mx - 1).to(torch.int64)
    gy = torch.clamp(block.y * world.dy_inv + my // 2, 0, my - 1).to(torch.int64)
    inten = gf.intensity[gy, gx]
    return block._replace(burn=torch.clamp(block.burn + rate * inten, 0.0, 1.0))


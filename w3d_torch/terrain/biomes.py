"""Terrain texturing / biome weights (port of `3dworld_tpu/terrain/biomes.py`).

The reference builds per-tile weight textures over the 5 dirt layers
{sand, dirt, grass, rock, snow} by relative height with slope-based
grass/snow thresholds (`create_texture`/`get_tids`, Textures.cpp:1294+,
tiled_mesh.cpp:1071; thresholds `mesh_rh_dirt` mesh_gen.cpp:42-44,
`sthresh` slope bands) and low-frequency biome noise modulating dirt/grass
(`tile_t::update_terrain_params`, tiled_mesh.cpp:321).

Output: [..., 5, ny, nx] weight planes (component-major; sums to 1).
"""

from __future__ import annotations

import torch

from ..terrain import mesh as TM
from ..ops import noise as N
from ..ops.fmath import div32

# sthresh (mesh_gen.cpp:44): {grass, snow} x {lo, hi} surface-slope bands
STHRESH_GRASS = (0.68, 0.86)
STHRESH_SNOW = (0.48, 0.72)

SAND, DIRT, GRASS, ROCK, SNOW = range(5)


def biome_weights(zvals: torch.Tensor, norm_z: torch.Tensor, zmin, zmax,
                  cfg: TM.TerrainConfig = TM.TerrainConfig(),
                  biome_noise: torch.Tensor | None = None) -> torch.Tensor:
    """Per-vertex texture weights [..., 5, ny, nx].

    zvals [..., ny, nx] heights; norm_z surface-normal z (1 = flat);
    zmin/zmax floats or 0-d tensors; biome_noise optional low-frequency
    field in [-1, 1] shifting the dirt/grass balance
    (update_terrain_params semantics).
    """
    zv = TM.lttex_dirt_zvals(cfg)           # [5] relative-height thresholds
    span = zmax - zmin
    if isinstance(span, torch.Tensor):
        relh = (zvals - zmin) / torch.clamp(span, min=1e-9)
    else:
        relh = div32(zvals - zmin, max(span, 1e-9))
    if biome_noise is not None:
        relh = relh + 0.05 * biome_noise     # biome drift

    # piecewise-linear band weights: full at band center, blending across
    # a transition width around each threshold (get_tids interpolation)
    blend_w = 0.04
    ws = []
    prev_t = -1.0
    for i in range(5):
        t_lo = prev_t
        t_hi = zv[i]
        lo_edge = torch.clamp(div32(relh - (t_lo - blend_w), 2 * blend_w), 0.0, 1.0) \
            if i > 0 else torch.ones_like(relh)
        hi_edge = torch.clamp(div32((t_hi + blend_w) - relh, 2 * blend_w), 0.0, 1.0) \
            if i < 4 else torch.ones_like(relh)
        ws.append(lo_edge * hi_edge)
        prev_t = t_hi

    # slope modulation: steep surfaces lose grass and snow to rock
    g_lo, g_hi = STHRESH_GRASS
    s_lo, s_hi = STHRESH_SNOW
    ws[GRASS] = ws[GRASS] * torch.clamp(div32(norm_z - g_lo, g_hi - g_lo), 0.0, 1.0)
    ws[SNOW] = ws[SNOW] * torch.clamp(div32(norm_z - s_lo, s_hi - s_lo), 0.0, 1.0)
    # removed grass/snow becomes rock (the five planes summed in order, so
    # every device rounds the total alike)
    total = ws[0] + ws[1] + ws[2] + ws[3] + ws[4]
    ws[ROCK] = ws[ROCK] + torch.clamp(1.0 - total, min=0.0)
    w = torch.stack(ws, dim=-3)               # [..., 5, ny, nx]
    total = (ws[0] + ws[1] + ws[2] + ws[3] + ws[4]).unsqueeze(-3)
    return w / torch.clamp(total, min=1e-9)


def tile_biome_noise(table: N.SineTable, x0, y0, n: int, world,
                     scale: float = 32.0) -> torch.Tensor:
    """Low-frequency biome parameter field for a tile
    (~ update_terrain_params' height_gen at biome scale)."""
    xt, yt = N.sine_term_tables(table, x0 / scale, y0 / scale,
                                world.dx * scale, world.dy * scale, n, n,
                                world=world)
    v = N.eval_sine_grid(xt, yt)
    return torch.tanh(0.2 * v)

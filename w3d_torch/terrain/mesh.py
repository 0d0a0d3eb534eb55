"""Terrain generation helpers (port of the parts of
`3dworld_tpu/terrain/mesh.py` that the tile batch runs).

Configuration (`HmapParams`, `TerrainConfig`), the rock threshold
(`clip_hd1`), the plateau/crater/crack post-process (`postproc_noise_zval`),
the glaciation power curve (`apply_glaciate`) and the sine-table builder
(`gen_table_for`).  Ground-mode `gen_terrain` and the heightmap loader are
not ported yet.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..utils.constants import WorldConst
from ..ops import noise as N

# mesh_gen.cpp:20-28
W_PLANE_Z = 0.42
DEF_GLACIATE_EXP = 3.0
NTEX_DIRT = 5
MESH_RH_DIRT = (0.40, 0.44, 0.60, 0.75, 1.0)  # sand,dirt,ground,rock,snow (mesh_gen.cpp:42-44)


class HmapParams(NamedTuple):
    """Post-processing params (hmap_params_t): plateau/crater/crack + overlay
    sine/volcano.  Defaults are no-ops (mesh_gen.cpp:555-562,364-379)."""

    plat_bot: float = 1.0e9
    plat_h: float = 0.0
    plat_s: float = 0.0
    plat_max: float = 0.0
    crat_h: float = 1.0e9
    crat_s: float = 0.0
    crack_lo: float = 0.0
    crack_hi: float = 0.0
    crack_d: float = 0.0
    sine_mag: float = 0.0
    sine_freq: float = 0.0
    sine_bias: float = 0.0
    volcano_width: float = 0.0
    volcano_height: float = 0.0


class TerrainConfig(NamedTuple):
    """Static terrain-generation configuration (hashable)."""

    mode: int = N.MGEN_SINE
    shape: int = N.SHAPE_LINEAR
    mesh_seed: int = 0
    mesh_scale: float = 1.0
    mesh_scale_z: float = 1.0
    mesh_height_scale: float = 1.0
    glaciate: bool = True
    glaciate_exp: float = DEF_GLACIATE_EXP
    erosion_iters: int = 0
    erode_amount: float = 1.0
    water_h_off: float = 0.0
    water_h_off_rel: float = 0.0
    relh_adj_tex: float = 0.0
    mesh_freq_filter: int = N.FREQ_FILTER
    hmap: HmapParams = HmapParams()
    xoff2: int = 0
    yoff2: int = 0


def glaciate_exp_val(cfg: TerrainConfig) -> float:
    return cfg.glaciate_exp if cfg.glaciate else 1.0


def get_rel_wpz(cfg: TerrainConfig) -> float:
    """mesh_gen.cpp:344: relative water-plane height in [0,1]."""
    return float(np.clip(W_PLANE_Z + cfg.water_h_off_rel, 0.0, 1.0))


def lttex_dirt_zvals(cfg: TerrainConfig, temperature: float = 20.0):
    """init_terrain_mesh (mesh_gen.cpp:407-431): water-level-adjusted
    relative height thresholds for sand/dirt/ground/rock/snow."""
    rel_wpz = get_rel_wpz(cfg)
    zvals = []
    for i, def_h in enumerate(MESH_RH_DIRT):
        if def_h < W_PLANE_Z:
            h = def_h * rel_wpz / W_PLANE_Z
        else:
            rel_h = (def_h - W_PLANE_Z) / (1.0 - W_PLANE_Z)
            h = rel_wpz + rel_h * (1.0 - rel_wpz)
            if i == NTEX_DIRT - 1:  # snow
                h = min(h, def_h)
                if temperature > 40.0:
                    h += 0.01 * (temperature - 40.0)
        zvals.append(h)
    return zvals


def clip_hd1(cfg: TerrainConfig) -> float:
    """Rock-vs-dirt relative-height threshold (Textures.cpp:1757-1761)."""
    zv = lttex_dirt_zvals(cfg)
    gexp = glaciate_exp_val(cfg)
    h_dirt = [z ** gexp for z in zv]
    return 0.90 * h_dirt[1] + 0.10 * h_dirt[0]


def postproc_noise_zval(z: torch.Tensor, h: HmapParams) -> torch.Tensor:
    """Plateau / crater / crack shaping (mesh_gen.cpp:555-562)."""
    if h.plat_s != 0.0 or h.plat_h != 0.0:
        above = z > h.plat_bot
        plat = (h.plat_bot + h.plat_h * (z - h.plat_bot)
                + torch.clamp(h.plat_s * (z - h.plat_bot), max=h.plat_max))
        z = torch.where(above, plat, z)
    if h.crat_s != 0.0:
        z = torch.where(z > h.crat_h, h.crat_h - h.crat_s * (z - h.crat_h), z)
    if h.crack_d != 0.0:
        in_crack = (z > h.crack_lo) & (z < h.crack_hi)
        z = torch.where(in_crack, z - h.crack_d * torch.minimum(
            z - h.crack_lo, h.crack_hi - z), z)
    return z


def apply_glaciate(z: torch.Tensor, zmax_est: torch.Tensor,
                   cfg: TerrainConfig) -> torch.Tensor:
    """mesh_gen.cpp:358,380-385: relative-height power curve."""
    if not cfg.glaciate:
        return z
    zmax_est2 = 2.0 * zmax_est
    relh = (z + zmax_est) / zmax_est2
    relh = torch.clamp(relh, min=0.0)
    if cfg.glaciate_exp == 3.0:
        g = relh * relh * relh
    else:
        g = torch.pow(relh, cfg.glaciate_exp)
    return g * zmax_est2 - zmax_est


def gen_table_for(cfg: TerrainConfig, world: WorldConst,
                  device: torch.device | str = "cuda") -> N.SineTable:
    """The sine table of a terrain configuration (host-side, 450 draws)."""
    scaled_height = world.mesh_height * cfg.mesh_height_scale
    return N.gen_sine_table(world, cfg.mesh_seed, scaled_height, device=device)

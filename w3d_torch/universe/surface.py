"""Planet/moon surfaces: spherical heightmaps from 3D sine noise (port of
`3dworld_tpu/universe/surface.py`).

Re-expresses `upsurface` (upsurface.cpp:16-72): separable 3D sine-table
noise sampled on the unit sphere yields the surface height per direction;
biome coloring by temperature + water level (uplanet surface gen,
Universe.cpp:2073).

A lat-long grid of directions is evaluated as one batched program; the
per-axis term trick doesn't apply on the sphere (non-grid points), so the
noise evaluates densely: sin(fx*x + px) etc. as [P, K] tables, K = 60,
multiplied and summed over K.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import noise as N
from ..utils.rng import RandGen


def planet_surface(table: N.SineTable3D, nlat: int = 64, nlon: int = 128,
                   mag: float = 1.0) -> torch.Tensor:
    """Heightmap [nlat, nlon] over the sphere in approx [-1, 1], on the
    table's device."""
    dev = table.mag.device
    ar = lambda n: torch.arange(n, dtype=torch.float32, device=dev)
    lat = (ar(nlat) + 0.5) / nlat * np.pi - np.pi / 2
    lon = ar(nlon) / nlon * 2 * np.pi
    cl = torch.cos(lat)[:, None]
    x = (cl * torch.cos(lon)[None, :]).reshape(-1)
    y = (cl * torch.sin(lon)[None, :]).reshape(-1)
    z = torch.sin(lat)[:, None].expand(nlat, nlon).reshape(-1)
    # dense separable sum: val = sum_k mag_k sx_k sy_k sz_k at each point
    sx = torch.sin(table.fx[None, :] * x[:, None] * 4.0 + table.px[None, :])
    sy = torch.sin(table.fy[None, :] * y[:, None] * 4.0 + table.py[None, :])
    sz = torch.sin(table.fz[None, :] * z[:, None] * 4.0 + table.pz[None, :])
    val = (sx * sy * sz * table.mag[None, :]).sum(-1)
    return (mag * val).reshape(nlat, nlon)


def gen_planet_surface(seed: int, nlat: int = 64, nlon: int = 128,
                       water_level: float = 0.0, device: torch.device | str = "cuda"):
    """Full surface for a planet seed: (heights, water_mask) on `device`."""
    table = N.gen_sine_table_3d(1.0, 1.0, (seed & 0x7FFFFFFF) or 1,
                                ((seed * 77) & 0x7FFFFFFF) or 1, device=device)
    h = planet_surface(table, nlat, nlon)
    return h, h < water_level


def surface_color(heights: torch.Tensor, water_mask: torch.Tensor,
                  temp: float) -> torch.Tensor:
    """Biome coloring by temperature/water (uplanet color model,
    simplified): returns [3, nlat, nlon] RGB planes."""
    h = heights
    hot = float(np.clip(temp / 80.0, 0.0, 1.0))
    hc = torch.clamp(h, 0, 1)
    land_r = 0.4 + 0.4 * hot + 0.2 * hc
    land_g = 0.5 - 0.2 * hot + 0.2 * hc
    land_b = 0.25 + 0.1 * hc
    snow = h > 0.6
    r = torch.where(water_mask, 0.1, torch.where(snow, 0.9, land_r))
    g = torch.where(water_mask, 0.2, torch.where(snow, 0.9, land_g))
    b = torch.where(water_mask, 0.55, torch.where(snow, 0.95, land_b))
    return torch.stack([r, g, b])


def _linspace(stop: float, num: int, endpoint: bool, device) -> torch.Tensor:
    """`jnp.linspace(0.0, stop, num, endpoint)` in float32 as JAX computes
    it: stop * (i / div), the endpoint appended exactly."""
    div = num - 1 if endpoint else num
    step = torch.arange(div, dtype=torch.float32, device=device) / div
    stop_t = torch.tensor(stop, dtype=torch.float32, device=device)
    out = stop_t * step                  # + start * (1 - step), start 0
    return torch.cat([out, stop_t[None]]) if endpoint else out


def add_craters(heights: torch.Tensor, seed: int = 0, num: int = 24,
                max_radius: float = 0.12, depth: float = 0.35) -> torch.Tensor:
    """Crater displacement on the spherical heightmap (the reference
    renders craters in the planet fragment shader, craters.part via
    HAS_CRATERS, Universe.cpp:278-283; here they displace the surface
    geometry instead): classic bowl + raised-rim radial profile at
    hashed lat/lon centers, sizes log-distributed, one vectorized pass
    per crater.  heights: [nlat, nlon] in planet-radius units."""
    h = heights.to(torch.float32)
    nlat, nlon = h.shape
    dev = h.device
    rg = RandGen(seed + 17, 5 * seed + 29)
    lat = _linspace(np.pi, nlat, True, dev)[:, None]
    lon = _linspace(2.0 * np.pi, nlon, False, dev)[None, :]
    slat, clat_ = torch.sin(lat), torch.cos(lat)
    for _ in range(num):
        clat = rg.rand_uniform(0.15, np.pi - 0.15)
        clon = rg.rand_uniform(0.0, 2.0 * np.pi)
        r = max_radius * float(np.exp(rg.rand_uniform(-2.0, 0.0)))
        # great-circle angular distance to the crater center
        cosd = (slat * float(np.sin(clat)) * torch.cos(lon - clon)
                + clat_ * float(np.cos(clat)))
        ang = torch.arccos(torch.clamp(cosd, -1.0, 1.0))
        t = ang / r
        # bowl (t<1): depth*(t^2-1); rim (1<t<1.6): raised lip fading out
        bowl = depth * r * (t * t - 1.0)
        rim = 0.25 * depth * r * torch.clamp(1.0 - (t - 1.0) / 0.6, min=0.0)
        prof = torch.where(t < 1.0, bowl, torch.where(t < 1.6, rim, 0.0))
        h = h + prof
    return h

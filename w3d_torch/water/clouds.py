"""Clouds, wind fields, lightning (port of `3dworld_tpu/water/clouds.py`).

Reference: procedural 2D/3D cloud layers scrolled by wind (clouds.cpp),
global + local wind applied in physics (Physics.cpp:788-833), lightning
strikes from cloud height to the mesh that set fires (lightning.cpp,
display_world.cpp:1030-1033).  The cloud layer and the local wind are
tensor code over the port's `ops/noise`; a lightning path is host code
over the reference LCG, the same draws as the JAX package's.
"""

from __future__ import annotations

import torch

from ..ops import noise as N
from ..utils.rng import RandGen


def cloud_layer(time, wind_x, wind_y, nx: int = 128, ny: int = 128,
                density: float = 0.5, octaves: int = 5, seed: int = 0,
                device="cuda") -> torch.Tensor:
    """Scrolling fBm cloud density layer [ny, nx] in [0, 1]
    (gen_cloud_volumes' 2D layer; wind scroll like the cloud plane
    shader), on `device`."""
    xi = torch.arange(nx, dtype=torch.float32, device=device)[None, :] * 0.06 \
        + wind_x * time * 0.01
    yi = torch.arange(ny, dtype=torch.float32, device=device)[:, None] * 0.06 \
        + wind_y * time * 0.01
    x = torch.broadcast_to(xi, (ny, nx))
    y = torch.broadcast_to(yi, (ny, nx))
    v = N.fbm2d(x, y, 1.3, 2.1, octaves=octaves, seed=seed)
    return torch.clamp(0.5 + 0.5 * v - (0.5 - density), 0.0, 1.0)


def gen_lightning_strike(seed: int, cloud_z: float, ground_z: float,
                         x: float, y: float, num_segs: int = 16,
                         fork_prob: float = 0.3):
    """A jagged lightning path from cloud to ground with optional forks
    (l_strike gen, lightning.cpp): [(x, y, z), ...] main path + forks."""
    rg = RandGen(seed + 3, 2 * seed + 9)
    path = [(x, y, cloud_z)]
    dz = (cloud_z - ground_z) / num_segs
    cx, cy = x, y
    forks = []
    for i in range(num_segs):
        cx += 0.1 * (2 * rg.randd() - 1)
        cy += 0.1 * (2 * rg.randd() - 1)
        z = cloud_z - (i + 1) * dz
        path.append((cx, cy, z))
        if rg.randd() < fork_prob and i > 2:
            fx, fy, fz = cx, cy, z
            fork = [(fx, fy, fz)]
            for _ in range(4):
                fx += 0.15 * (2 * rg.randd() - 1)
                fy += 0.15 * (2 * rg.randd() - 1)
                fz -= 0.5 * dz
                fork.append((fx, fy, fz))
            forks.append(fork)
    return path, forks


def local_wind(px: torch.Tensor, py: torch.Tensor, pz: torch.Tensor, base_wind,
               time, gust_scale: float = 0.3, seed: int = 0):
    """Per-position wind = global wind + gust noise (get_local_wind,
    Physics.cpp:788): batched over positions, on their device."""
    gx = N.simplex2d(0.5 * px + 0.13 * time, 0.5 * py, seed)
    gy = N.simplex2d(0.5 * px, 0.5 * py + 0.17 * time, seed + 1)
    return (base_wind[0] * (1.0 + gust_scale * gx),
            base_wind[1] * (1.0 + gust_scale * gy),
            base_wind[2] * torch.ones_like(px))

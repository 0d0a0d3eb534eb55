"""Overhead map view: heightmap/water/city render + fractal bonus modes
(port of `3dworld_tpu/export/map_view.py`).

The reference's `draw_overhead_map` (map_view.cpp:127) renders the
terrain as a colored 2D map (height bands, water, buildings) with bonus
fractal modes (Mandelbrot etc., map_view.cpp:51-160).  Here: the same
products as image tensors on the heightmap's device; the city overlay is
host rasterization, as in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch


def terrain_map(heightmap, water_z, zmin, zmax) -> torch.Tensor:
    """[3, my, mx] RGB overhead map: height-banded land + water shading."""
    h = torch.as_tensor(heightmap, dtype=torch.float32)
    f32 = lambda v: torch.as_tensor(v, dtype=torch.float32, device=h.device)
    water_z, zmin, zmax = f32(water_z), f32(zmin), f32(zmax)
    relh = torch.clamp((h - zmin) / torch.clamp(zmax - zmin, min=1e-9), 0.0, 1.0)
    wet = h < water_z
    depth = torch.clamp((water_z - h) * 4.0, 0.0, 1.0)
    land_r = 0.25 + 0.55 * relh
    land_g = 0.45 + 0.35 * relh
    land_b = 0.2 + 0.25 * relh
    snow = relh > 0.8
    r = torch.where(wet, 0.1 * (1 - depth), torch.where(snow, 0.95, land_r))
    g = torch.where(wet, 0.3 * (1 - 0.7 * depth), torch.where(snow, 0.95, land_g))
    b = torch.where(wet, 0.55, torch.where(snow, 1.0, land_b))
    return torch.stack([r, g, b])


def overlay_roads_buildings(img, road_segs, building_parts, world) -> np.ndarray:
    """Stamp roads (gray) and buildings (dark) onto the map (host-side
    rasterization of the city overlays); returns a numpy [3, my, mx]."""
    out = (img.detach().cpu().numpy() if isinstance(img, torch.Tensor)
           else np.asarray(img)).copy()
    _, my, mx = out.shape
    for (x1, y1, x2, y2, wdt) in np.asarray(road_segs):
        xa, xb = int(min(x1, x2)), int(max(x1, x2)) + 1
        ya, yb = int(min(y1, y2)), int(max(y1, y2)) + 1
        out[:, max(ya, 0):min(yb, my), max(xa, 0):min(xb, mx)] = 0.35
    for p in np.asarray(building_parts):
        xa = int(p[0] / world.dx + mx // 2)
        ya = int(p[1] / world.dy + my // 2)
        xb = int(p[3] / world.dx + mx // 2) + 1
        yb = int(p[4] / world.dy + my // 2) + 1
        out[:, max(ya, 0):min(yb, my), max(xa, 0):min(xb, mx)] = 0.15
    return out


def mandelbrot(cx: float, cy: float, scale: float, n: int = 512,
               max_iter: int = 96, device: torch.device | str = "cuda") -> torch.Tensor:
    """Mandelbrot escape-iteration map (map_view.cpp bonus mode), [n, n]
    on `device`."""
    ar = torch.arange(n, dtype=torch.float32, device=device)
    step = lambda c: (ar / torch.tensor(float(n), device=device) - 0.5) * scale + c
    cr = step(cx)[None, :].expand(n, n)
    ci = step(cy)[:, None].expand(n, n)
    zr = torch.zeros((n, n), dtype=torch.float32, device=device)
    zi = torch.zeros_like(zr)
    cnt = torch.zeros_like(zr)
    for _ in range(max_iter):
        zr2 = zr * zr - zi * zi + cr
        zi2 = 2.0 * zr * zi + ci
        esc = (zr2 * zr2 + zi2 * zi2) > 4.0
        cnt = cnt + (~esc).to(torch.float32)
        zr = torch.where(esc, zr, zr2)
        zi = torch.where(esc, zi, zi2)
    return cnt / torch.tensor(float(max_iter), device=device)

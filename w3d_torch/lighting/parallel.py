"""Lighting bake over ranks (port of `3dworld_tpu/lighting/parallel.py`):
ray batches split across the mesh.

The reference's one multi-worker offline job is the lighting precompute:
N threads each trace a slice of the ray budget into a copy of the lmap,
and the copies merge when all are done (thread_manager_t,
ray_trace.cpp:516-618).  Here every rank traces ceil(num_rays / n) rays,
in batches of at most `batch` (the last one the remainder), into a zero
volume of its own; the ranks' volumes are gathered and summed in rank
order, and the sum is added to the input grid once.

The merge is an `all_gather` of the 12 accumulation channels summed in
rank order, not an `all_reduce`, whose order of additions depends on the
backend and its algorithm: so a bake is the same bit for bit over nccl and
gloo and from run to run, as every other deposit of the port is.

As the JAX function does, and unlike the single-device drivers in
`trace.py`, the bake applies only `_auto_transmission` to the params and
gives each batch the ray weight of its size.  Each rank's draws come from
the streams (seed, rank, batch, 1) for the rays and (seed, rank, batch, 2)
for the trace, made by `draws` (a `trace.DrawSource`, by default seeded
generators on the grid's device).
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.constants import WorldConst, DEFAULT_WORLD
from ..parallel.mesh import Mesh, all_gather_stack
from . import lmap as L
from . import trace as T

ACCUM_FIELDS = ("sc_r", "sc_g", "sc_b", "sv", "gc_r", "gc_g", "gc_b",
                "gv", "lc_r", "lc_g", "lc_b", "smoke")


def compute_sky_lighting_sharded(
        dev_mesh: Mesh, grid: L.LightGrid, cobjs, mesh_hf,
        num_rays: int, seed: int = 0,
        params: T.TraceParams = T.TraceParams(),
        world: WorldConst = DEFAULT_WORLD,
        batch: int = 65536, land_color=None, snow_depth=None,
        sky_color=(0.7, 0.8, 1.0),
        draws: T.DrawSource | None = None) -> L.LightGrid:
    """Sky bake over the ranks of `dev_mesh`: each rank traces
    ceil(num_rays / n) rays (the total rounds up to a multiple of n), and
    the volumes merge in rank order.  The sharded
    compute_ray_trace_lighting(LIGHTING_SKY)."""
    def rays(d, n):
        return T.sky_rays(d, n, world, sky_color=tuple(sky_color), ray_weight=float(n))
    return _sharded_bake(dev_mesh, grid, cobjs, mesh_hf, num_rays, seed, params,
                         world, batch, land_color, snow_depth, L.LIGHTING_SKY,
                         rays, draws)


def compute_global_lighting_sharded(
        dev_mesh: Mesh, grid: L.LightGrid, cobjs, mesh_hf,
        num_rays: int, sun_dir, seed: int = 0,
        params: T.TraceParams = T.TraceParams(),
        world: WorldConst = DEFAULT_WORLD,
        batch: int = 65536, land_color=None, snow_depth=None,
        sun_color=(1.0, 0.95, 0.85),
        draws: T.DrawSource | None = None) -> L.LightGrid:
    """Directional sun or moon bake over the ranks (the slice split of
    trace_ray_block_global)."""
    sd = tuple(float(v) for v in np.asarray(sun_dir, np.float32))

    def rays(d, n):
        return T.global_rays(d, n, sd, world, sun_color=tuple(sun_color),
                             ray_weight=float(n))
    return _sharded_bake(dev_mesh, grid, cobjs, mesh_hf, num_rays, seed, params,
                         world, batch, land_color, snow_depth, L.LIGHTING_GLOBAL,
                         rays, draws)


def _sharded_bake(dev_mesh, grid, cobjs, mesh_hf, num_rays, seed, params, world,
                  batch, land_color, snow_depth, ltype, rays, draws):
    params = T._auto_transmission(params, cobjs)
    draws = draws or T.DrawSource(grid.sv.device)
    per_rank = -(-num_rays // dev_mesh.size)
    # exact batch sizes, the last the remainder: padding it to `batch` would
    # trace extra rays of full weight and brighten the volume
    sizes = [min(batch, per_rank - i * batch) for i in range(-(-per_rank // batch))]
    local = grid._replace(**{f: torch.zeros_like(getattr(grid, f)) for f in ACCUM_FIELDS})
    for i, n in enumerate(sizes):
        local = T.trace_batch(local, cobjs, mesh_hf, *rays(draws(seed, dev_mesh.rank, i, 1), n),
                              draws(seed, dev_mesh.rank, i, 2), ltype=ltype, params=params,
                              world=world, land_color=land_color, snow_depth=snow_depth)
    parts = all_gather_stack(torch.stack([getattr(local, f) for f in ACCUM_FIELDS]),
                             dev_mesh)
    total = parts[0]
    for p in parts[1:]:          # rank order
        total = total + p
    return grid._replace(**{f: getattr(grid, f) + total[i]
                            for i, f in enumerate(ACCUM_FIELDS)})

"""Snow coverage precompute: batched snowflake ray casting (port of
`3dworld_tpu/water/snow.py`).

The reference casts up to 64M snowflake rays downward with wind offset
and deflection bounces, OMP-parallel, accumulating a sparse z-average
voxel map merged into render strips (`create_snow_map` snow.cpp:484-540,
`gen_snow_coverage`), with file save/load (snow.cpp:284-307).

One pass per ray batch: positions plus wind drift, straight-down rays
against the cobjs (`ops/ray.ray_cobjs_nearest`) and the heightfield
(`sample_mesh`, kernel B on the card), deflection rounds in lockstep, and
the landing heights averaged per mesh cell.  The JAX package's threefry
draws are a `SnowDraws` input (`draw_snow` makes them from a CPU
generator).  The per-cell sums go through `lighting/lmap.cell_sums`, a
fixed-order sum without atomics, so a snow map on the card equals the
CPU's bit for bit on the same draws; the JAX package scatter-adds in
another order, so its `snow_z` agrees within float32 rounding of the
sums and its counts exactly.  The map's file is the JAX package's `.npz`.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..utils.constants import WorldConst, DEFAULT_WORLD
from ..physics.cobjs import CobjSet
from ..ops import fmath
from ..ops import ray as R
from ..ops.cuda import sample_kernel as SK
from ..lighting.lmap import cell_sums

SNOW_RANDOM = 1.0        # snow_random config (deflection jitter scale)
MAX_DEFLECT = 4          # lockstep bound on the reference's iter<=100 loop
SNOW_MAX_SLOPE_NZ = 0.5  # surfaces steeper than this shed flakes


class SnowDraws(NamedTuple):
    """One batch's draws: the flakes' start x and y over the scene [B],
    and per deflection round the two standard normals of the lateral
    step, [MAX_DEFLECT - 1, B] each."""

    x: torch.Tensor
    y: torch.Tensor
    na: torch.Tensor
    nb: torch.Tensor


def draw_snow(batch: int, gen: torch.Generator, world: WorldConst = DEFAULT_WORLD,
              device="cuda") -> SnowDraws:
    """One batch's draws from the CPU generator `gen`, on `device`."""
    u = torch.rand((2, batch), generator=gen)
    n = torch.randn((2, MAX_DEFLECT - 1, batch), generator=gen)
    x = -world.x_scene + 2.0 * world.x_scene * u[0]
    y = -world.y_scene + 2.0 * world.y_scene * u[1]
    return SnowDraws(*(a.to(torch.float32).to(device) for a in (x, y, n[0], n[1])))


def snow_batch(draws: SnowDraws, mesh: torch.Tensor, cobjs: CobjSet, wind,
               world: WorldConst = DEFAULT_WORLD):
    """One ray batch -> (cell ids, landing z, valid).

    Deflection bounces (create_snow_map, snow.cpp:484-540): a flake
    whose ray hits a surface too steep to hold snow doesn't stick — it
    deflects by a Gaussian lateral step scaled by its remaining height
    fraction, pushed away from the surface (dot(delta, cnorm) >= 0), and
    falls again; up to MAX_DEFLECT rounds in lockstep (flakes needing
    more rounds than the bound land where they are).  The reference's
    cnorm.z <= 0 trigger is widened to cnorm.z < SNOW_MAX_SLOPE_NZ, as
    in the JAX package.  `wind` is a [3] tensor on the mesh's device."""
    batch = draws.x.shape[0]
    dev = mesh.device
    top = 2.0 * world.z_scene
    zbot = -world.z_scene
    # wind offset: flakes drift as they fall (snow.cpp wind_vector)
    fall_t = 1.5 * world.z_scene
    ox = draws.x + wind[0] * fall_t * 0.1
    oy = draws.y + wind[1] * fall_t * 0.1
    oz = torch.full((batch,), top, dtype=torch.float32, device=dev)
    zero = torch.zeros((batch,), dtype=torch.float32, device=dev)
    dz = torch.full((batch,), -1.0, dtype=torch.float32, device=dev)
    tmax = torch.full((batch,), 4.0 * world.z_scene, dtype=torch.float32, device=dev)
    present = R.present_types(cobjs)
    done = torch.zeros((batch,), dtype=torch.bool, device=dev)
    z_land = zero
    for it in range(MAX_DEFLECT):
        chit, ct, cnx, cny, cnz, _ = R.ray_cobjs_nearest(
            ox, oy, oz, zero, zero, dz, tmax, cobjs, present=present)
        mh = SK.sample_mesh(mesh, ox, oy, world)[0]
        z_cobj = oz - ct
        above = chit & (z_cobj > mh)
        land_cobj = above & (cnz >= SNOW_MAX_SLOPE_NZ)
        deflect = above & (cnz < SNOW_MAX_SLOPE_NZ) & ~done
        landed = ~done & (land_cobj | ~above)
        z_land = torch.where(landed, torch.where(land_cobj, z_cobj, mh), z_land)
        done = done | landed
        if it == MAX_DEFLECT - 1:
            # out of rounds: stick at the deflection point (iter>100 path)
            z_land = torch.where(deflect, z_cobj, z_land)
            break
        # deflect: Gaussian lateral step scaled by height fraction, away
        # from the surface (snow.cpp:516-527)
        val = torch.clamp(fmath.div32(z_cobj - zbot, top - zbot), 0.0, 1.0)
        dx_ = 0.1 * val * SNOW_RANDOM * draws.na[it]
        dy_ = 0.1 * val * SNOW_RANDOM * draws.nb[it]
        flip = (dx_ * cnx + dy_ * cny) < 0.0
        dx_ = torch.where(flip, -dx_, dx_)
        dy_ = torch.where(flip, -dy_, dy_)
        ox = torch.where(deflect, ox + dx_, ox)
        oy = torch.where(deflect, oy + dy_, oy)
        oz = torch.where(deflect, z_cobj + 1e-4, oz)

    mx, my = world.mesh_x, world.mesh_y
    gx = torch.floor(ox * world.dx_inv + mx // 2).to(torch.int32)
    gy = torch.floor(oy * world.dy_inv + my // 2).to(torch.int32)
    ok = (gx >= 0) & (gx < mx) & (gy >= 0) & (gy < my)
    cell = torch.where(ok, gy * mx + gx, mx * my)
    return cell, z_land, ok


class SnowDrawSource:
    """The draws of `create_snow_map`'s batch i: a CPU generator seeded
    from (`seed`, i), its draws copied to the device.  A caller (a test)
    replaces `batch` to inject other draws."""

    def __init__(self, seed: int = 0):
        self.seed = seed

    def batch(self, i: int, batch: int, world: WorldConst, device) -> SnowDraws:
        gen = torch.Generator().manual_seed(self.seed * 1_000_003 + 0x5704 + i)
        return draw_snow(batch, gen, world, device)


def create_snow_map(mesh: torch.Tensor, cobjs: CobjSet, num_rays: int,
                    wind=(0.4, 0.2, 0.0), world: WorldConst = DEFAULT_WORLD,
                    seed: int = 0, batch: int = 65536,
                    draws: SnowDrawSource | None = None):
    """Full snow map: (snow_z [my, mx], coverage [my, mx]) on the mesh's
    device.

    snow_z = mean landing height per cell (the sparse z-average voxel map),
    coverage = ray count per cell (normalizable to snow depth).  Each
    batch's per-cell sums are fixed-order (`cell_sums`), added to the
    totals batch by batch."""
    mx, my = world.mesh_x, world.mesh_y
    n_cells = mx * my
    dev = mesh.device
    draws = SnowDrawSource(seed) if draws is None else draws
    wind = torch.as_tensor(wind, dtype=torch.float32, device=dev)
    sums = torch.zeros((n_cells, 2), dtype=torch.float32, device=dev)
    nb = -(-num_rays // batch)
    for i in range(nb):
        cell, z, ok = snow_batch(draws.batch(i, batch, world, dev), mesh, cobjs,
                                 wind, world)
        vals = torch.stack([torch.where(ok, z, 0.0), ok.to(torch.float32)], 1)
        sums = sums + cell_sums(cell.long(), vals, n_cells)
    zsum = sums[:, 0].reshape(my, mx)
    cnt = sums[:, 1].reshape(my, mx)
    snow_z = torch.where(cnt > 0, zsum / torch.clamp(cnt, min=1.0), mesh)
    return snow_z, cnt


def save_snow_map(path: str, snow_z, coverage) -> None:
    """The JAX package's `.npz` (float32 `snow_z` and `coverage`)."""
    np.savez_compressed(path, snow_z=_host(snow_z), coverage=_host(coverage))


def load_snow_map(path: str, device="cuda"):
    """(snow_z, coverage) tensors on `device` from a file of either
    package."""
    with np.load(path) as z:
        return (torch.as_tensor(z["snow_z"], device=device),
                torch.as_tensor(z["coverage"], device=device))


def _host(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)

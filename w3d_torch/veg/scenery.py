"""Scenery: rocks, voxel rocks, logs, stumps, plants (port of
`3dworld_tpu/veg/scenery.py`).

The reference scatters scenery objects (rocks, voxel rocks, logs, stumps,
plants) with type-specific generation (scenery.cpp:1643).  Placement is a
hash per mesh cell: the cells that pass a density test on flat enough
ground, lowest hash first.  The JAX package sorts the uint32 score with a
stable `argsort`, many cells tying at 0xFFFFFFFF; the port sorts an int64
copy of the same key stably, so ties and the `max_objs` cut fall as in
the JAX package.

The per-kind generators hash a position as the JAX package does,
`(x * 1000).astype(int32).astype(uint32)`: truncated toward zero, a
negative value wrapping to 2^32 + v (here int64 then `& 0xFFFFFFFF`).
They sample the mesh through `sample_mesh` (kernel B on the card) and
round their divisions, cosines and sines through `ops/fmath`, so the card
gives the CPU's values bit for bit.  Voxel rocks reuse the voxel engine:
a sphere-attenuated 3-D sine field and marching tetrahedra.
`scenery_cobjs` reads the sets back once and packs them on the host.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..ops import fmath
from ..ops.cuda import sample_kernel as SK
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


def rock_field(seed: int, res: int = 16, device="cuda") -> torch.Tensor:
    """The voxel rock's [res, res, res] field: a 3-D sine field over
    [-1, 1]^3, attenuated by the distance from the centre (a solid blob)."""
    from ..ops import noise as N

    table = N.gen_sine_table_3d(1.0, 4.0, seed + 1, seed + 2, device=device)
    field = N.eval_sine3d_grid(table, (-1.0, -1.0, -1.0),
                               (2.0 / (res - 1),) * 3, res, res, res)
    g = (fmath.div32(torch.arange(res, dtype=torch.float32, device=device), res - 1)
         - 0.5) * 2.0
    r = fmath.sqrt32(g[None, None, :] ** 2 + g[None, :, None] ** 2
                     + g[:, None, None] ** 2)
    return 0.4 * field + (r - 0.7) * 3.0


def rock_triangles(field: torch.Tensor, size: float = 1.0) -> np.ndarray:
    """The isosurface of a rock field as [T, 3, 3] triangles scaled to
    [-size, size]^3."""
    from ..voxel import mc as MC

    res = field.shape[0]
    vx, vy, vz, valid = MC.marching_tets(field, 0.0, (-size, -size, -size),
                                         (2 * size / (res - 1),) * 3)
    return MC.compact_triangles(vx, vy, vz, valid)


def voxel_rock_mesh(seed: int, size: float = 1.0, res: int = 16,
                    device="cuda") -> np.ndarray:
    """One voxel-rock triangle mesh (surface_rock/voxel rock gen:
    sphere-attenuated 3D sine field + isosurface extraction)."""
    return rock_triangles(rock_field(seed, res, device), size)


# ---------------------------------------------------------------------------
# per-kind geometry (scenery.cpp): terrain-following logs, flared
# stumps, plants with leaf rings + berries, squashed surface rocks
# ---------------------------------------------------------------------------

# plant type table (pltype, scenery.cpp:28-37):
# (stem r,g,b, leaf r,g,b, berry r,g,b,a) — berry alpha 0 = no berries
PLANT_TYPES = np.array([
    (0.4, 0.6, 0.2, 0.7, 0.7, 0.7, 0.0, 0.0, 0.0, 0.0),   # mj_leaf
    (0.4, 0.6, 0.2, 0.7, 0.7, 0.7, 0.0, 0.0, 0.0, 0.0),   # plant1
    (0.4, 0.6, 0.2, 0.7, 0.7, 0.7, 0.5, 0.2, 0.7, 1.0),   # plant2 (purple)
    (0.4, 0.6, 0.2, 0.7, 0.7, 0.7, 0.9, 0.1, 0.05, 1.0),  # plant3 (red)
    (0.4, 0.6, 0.2, 0.7, 0.7, 0.7, 0.0, 0.0, 0.0, 0.0),   # plant4
    (0.6, 0.45, 0.25, 1.0, 1.0, 1.0, 0.0, 0.0, 0.0, 0.0),  # coffee
    (0.2, 0.7, 0.2, 0.1, 0.4, 0.1, 0.0, 0.0, 0.0, 0.0),   # seaweed (water)
], np.float32)
NUM_LAND_PLANT_TYPES = 6
NUM_PLANT_TYPES = 7


def _pos_hash(v: torch.Tensor, scale: float, seed: int) -> torch.Tensor:
    """xxhash of `(v * scale).astype(int32).astype(uint32)`: truncated
    toward zero, negatives wrapped to 2^32 + v."""
    return w3d_rng.xxhash_u32((v * scale).to(torch.int64) & 0xFFFFFFFF, seed=seed)


class LogSet(NamedTuple):
    """Terrain-following logs (s_log::create, scenery.cpp:569-600):
    endpoints independently snapped to the mesh, two radii."""

    x1: torch.Tensor
    y1: torch.Tensor
    z1: torch.Tensor
    x2: torch.Tensor
    y2: torch.Tensor
    z2: torch.Tensor
    r1: torch.Tensor
    r2: torch.Tensor
    valid: torch.Tensor


def gen_logs(set_: ScenerySet, mesh: torch.Tensor, world) -> LogSet:
    sel = set_.kind == S_LOG
    h = _pos_hash(set_.x, 1000, 0x106)
    u1 = fmath.div32((h & 0xFFFF).to(torch.float32), 65535.0)
    u2 = fmath.div32(((h >> 16) & 0xFFFF).to(torch.float32), 65535.0)
    r1 = 0.003 + 0.005 * u1           # rand_uniform2(0.003, 0.008)
    r2 = r1 * (0.9 + 0.2 * u2)
    length = torch.clamp(4.0 * r1 + u2 * 16.0 * r1, 0.03, 0.15)
    dx = fmath.cos32(set_.rot) * length
    dy = fmath.sin32(set_.rot) * length
    x2 = set_.x + dx
    y2 = set_.y + dy
    mh1 = SK.sample_mesh(mesh, set_.x, set_.y, world)[0]
    mh2 = SK.sample_mesh(mesh, x2, y2, world)[0]
    return LogSet(x1=set_.x, y1=set_.y, z1=mh1 + 0.85 * r1,
                  x2=x2, y2=y2, z2=mh2 + 0.85 * r2,
                  r1=r1, r2=r2, valid=set_.valid & sel)


class PlantSet(NamedTuple):
    """Plants: stem + leaf rings (s_plant::create_leaf_points) + berry
    clusters for types with a berry color."""

    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor
    height: torch.Tensor
    radius: torch.Tensor
    ptype: torch.Tensor        # index into PLANT_TYPES
    theta0: torch.Tensor       # ring start angle (derived from height)
    has_berries: torch.Tensor
    valid: torch.Tensor


def gen_plants(set_: ScenerySet, mesh: torch.Tensor, world,
               water_z: float = -1e9) -> PlantSet:
    sel = set_.kind == S_PLANT
    mh = SK.sample_mesh(mesh, set_.x, set_.y, world)[0]
    underwater = mh < water_z
    h = _pos_hash(set_.y, 1000, 0x91A)
    # water cells force the seaweed type (place land_plants_only logic)
    ptype = torch.where(underwater, NUM_PLANT_TYPES - 1,
                        (h % NUM_LAND_PLANT_TYPES).to(torch.int32)).to(torch.int32)
    height = set_.size * (2.0 + ((h >> 8) % 256).to(torch.float32) / 256.0)
    # theta0 = (int(1e6 * height) % 360) degrees (create_leaf_points)
    theta0 = torch.remainder(torch.floor(1.0e6 * height), 360.0) * (math.pi / 180.0)
    berry_a = torch.as_tensor(PLANT_TYPES[:, 9], device=mesh.device)
    has_berries = berry_a[ptype.long()] > 0.5
    return PlantSet(x=set_.x, y=set_.y, z=mh, height=height,
                    radius=fmath.div32(0.013 * height, 0.05) * set_.size,
                    ptype=ptype, theta0=theta0, has_berries=has_berries,
                    valid=set_.valid & sel)


def plant_leaf_points(p: PlantSet, nrings: int = 3, nleaves: int = 5):
    """[N, nrings*nleaves] leaf x, y and z: rings of leaves around the
    stem at increasing height, ring start angle theta0 (the reference's
    create_leaf_points layout)."""
    N = p.x.shape[0]
    dev = p.x.device
    ring = torch.arange(nrings, dtype=torch.float32, device=dev)
    leaf = torch.arange(nleaves, dtype=torch.float32, device=dev)
    th = (p.theta0[:, None, None] + ring[None, :, None] * 0.7
          + leaf[None, None, :] * (2 * math.pi / nleaves))
    zf = 0.5 + 0.5 * fmath.div32(ring[None, :, None] + 1.0, nrings)
    rr = p.radius[:, None, None] * (8.0 - 2.0 * ring[None, :, None])
    lx = p.x[:, None, None] + rr * fmath.cos32(th)
    ly = p.y[:, None, None] + rr * fmath.sin32(th)
    lz = p.z[:, None, None] + p.height[:, None, None] * zf
    return (lx.reshape(N, -1), ly.reshape(N, -1), lz.reshape(N, -1))


class RockSet(NamedTuple):
    """Surface rocks: spheres with per-axis squash (surface_rock /
    s_rock random scaling)."""

    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor
    radius: torch.Tensor
    sx: torch.Tensor
    sy: torch.Tensor
    sz: torch.Tensor
    valid: torch.Tensor


def gen_rocks(set_: ScenerySet, mesh: torch.Tensor, world) -> RockSet:
    sel = (set_.kind == S_ROCK) | (set_.kind == S_VOXEL_ROCK)
    mh = SK.sample_mesh(mesh, set_.x, set_.y, world)[0]
    h = _pos_hash(set_.x, 777, 0x20CC)

    def sq(sh):
        return 0.7 + 0.6 * ((h >> sh) % 256).to(torch.float32) / 256.0

    return RockSet(x=set_.x, y=set_.y, z=mh + 0.3 * set_.size,
                   radius=set_.size, sx=sq(0), sy=sq(8), sz=sq(16),
                   valid=set_.valid & sel)


def scenery_cobjs(set_: ScenerySet, logs: LogSet, plants: PlantSet,
                  rocks: RockSet, device="cuda"):
    """Collision objects for scenery (each type's add_cobjs), packed on
    `device`."""
    from ..scene import cobj as SC
    from ..physics.cobjs import COLL_SPHERE, COLL_CYLINDER_ROT, COLL_CYLINDER

    def host(t):
        return type(t)(*(a.detach().cpu().numpy() for a in t))

    set_, logs, plants, rocks = host(set_), host(logs), host(plants), host(rocks)
    sp = SC.SceneParse()
    v = set_.valid
    kind = set_.kind
    for i in range(len(v)):
        if not v[i]:
            continue
        if kind[i] in (S_ROCK, S_VOXEL_ROCK):
            sp.cobjs.append(SC.RawCobj(
                COLL_SPHERE, (float(rocks.x[i]), float(rocks.y[i]),
                              float(rocks.z[i])), r1=float(rocks.radius[i])))
        elif kind[i] == S_LOG:
            sp.cobjs.append(SC.RawCobj(
                COLL_CYLINDER_ROT,
                (float(logs.x1[i]), float(logs.y1[i]), float(logs.z1[i])),
                (float(logs.x2[i]), float(logs.y2[i]), float(logs.z2[i])),
                r1=float(logs.r1[i]), r2=float(logs.r2[i])))
        elif kind[i] == S_STUMP:
            x, y = float(set_.x[i]), float(set_.y[i])
            z = float(set_.z[i])
            s = float(set_.size[i])
            # flared base: radius2 = 1.3x top radius (s_stump::create)
            sp.cobjs.append(SC.RawCobj(
                COLL_CYLINDER, (x, y, z), (x, y, z + 1.5 * s),
                r1=1.3 * s, r2=s))
        elif kind[i] == S_PLANT:
            x, y = float(plants.x[i]), float(plants.y[i])
            z = float(plants.z[i])
            hgt = float(plants.height[i])
            sp.cobjs.append(SC.RawCobj(
                COLL_CYLINDER, (x, y, z), (x, y, z + hgt),
                r1=0.25 * hgt, r2=0.1 * hgt))
    return SC.pack_cobjs(sp, device=device)

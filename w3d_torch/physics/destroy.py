"""Destructible cobjs: blast destruction + fragment spawning (port of
`3dworld_tpu/physics/destroy.py`).

The reference marks cobjs destroyable/shatterable/explodeable and
fragments them into triangle debris on damage (`destroy_coll_objs`,
destroy_cobj.cpp), removing them from the collision structures.  Here,
as in the JAX package, destruction nulls cobj slots (COLL_NULL) and
fragments are FRAGMENT objects written into dead slots of the object
SoA: fixed shapes throughout.

The JAX `spawn_fragments` seeds numpy with the last word of a threefry
key; the port takes that integer seed, so the fragment velocities are
the same numpy draws.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import types as T
from .cobjs import CobjSet, COLL_NULL
from .step import ObjectState

# destroyability levels (collision_detect.h cobj destroy flags)
DESTROYABLE = 1
SHATTERABLE = 2
EXPLODEABLE = 3


class DestroyState(NamedTuple):
    levels: torch.Tensor   # [M] int32 per-cobj destroyability (0 = indestructible)


def make_destroy_state(cobjs: CobjSet, levels=None) -> DestroyState:
    """Per-cobj destroy levels on the cobjs' device (zeros by default)."""
    dev = cobjs.shape.device
    if levels is None:
        return DestroyState(torch.zeros(cobjs.size, dtype=torch.int32, device=dev))
    return DestroyState(torch.as_tensor(levels, dtype=torch.int32, device=dev))


def as_f32(v, like: torch.Tensor) -> torch.Tensor:
    """A number as the float32 0-d tensor a jitted JAX function receives,
    on `like`'s device (a fill, no copy from the host).  A CUDA tensor
    divided by a Python float is multiplied by its reciprocal, and a
    product of Python floats rounds once, not per factor as in float32."""
    if isinstance(v, torch.Tensor):
        return v.to(device=like.device, dtype=torch.float32)
    return torch.full((), v, dtype=torch.float32, device=like.device)


def destroy_coll_objs(cobjs: CobjSet, ds: DestroyState, cx, cy, cz, radius,
                      min_level: int = DESTROYABLE):
    """Remove destroyable cobjs whose center lies in the blast radius
    (destroy_coll_objs core).  Returns (cobjs', destroyed_mask [M])."""
    cx, cy, cz, radius = (as_f32(v, cobjs.p1) for v in (cx, cy, cz, radius))
    center = 0.5 * (torch.minimum(cobjs.p1, cobjs.p2) + torch.maximum(cobjs.p1, cobjs.p2))
    d2 = ((center[:, 0] - cx) ** 2 + (center[:, 1] - cy) ** 2
          + (center[:, 2] - cz) ** 2)
    hit = (d2 <= radius * radius) & (ds.levels >= min_level) & \
        (cobjs.shape != COLL_NULL)
    return cobjs._replace(shape=torch.where(hit, COLL_NULL, cobjs.shape)), hit


def spawn_fragments(state: ObjectState, table: T.ObjTypeTable, destroyed_centers,
                    num_per_cobj: int = 8, seed: int = 0,
                    speed: float = 1.0) -> ObjectState:
    """Spawn FRAGMENT objects from destroyed cobj centers into dead object
    slots (fragmenting into debris).  Velocities are numpy normal draws
    seeded with `seed` (the JAX package's `key_data(key)[-1]`)."""
    centers = np.asarray(destroyed_centers, np.float32).reshape(-1, 3)
    if len(centers) == 0:
        return state
    dead = np.where(state.status.cpu().numpy() == 0)[0]
    need = min(len(dead), len(centers) * num_per_cobj)
    if need == 0:
        return state
    src = np.repeat(centers, num_per_cobj, axis=0)[:need]
    rng = np.random.default_rng(int(seed))
    vel = rng.normal(0, speed, (need, 3)).astype(np.float32)
    vel[:, 2] = np.abs(vel[:, 2])
    tid = T.type_id("FRAGMENT")
    dev = state.px.device
    idx = torch.as_tensor(dead[:need], device=dev)
    col = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=dev)

    def put(a, v):
        a = a.clone()
        a[idx] = v
        return a

    return state._replace(
        px=put(state.px, col(src[:, 0])), py=put(state.py, col(src[:, 1])),
        pz=put(state.pz, col(src[:, 2])),
        vx=put(state.vx, col(vel[:, 0])), vy=put(state.vy, col(vel[:, 1])),
        vz=put(state.vz, col(vel[:, 2])),
        otype=put(state.otype, tid), status=put(state.status, 1),
        time=put(state.time, 0),
        # reused dead slots keep their old flags; stale Z/XY_STOPPED bits
        # would freeze the fragment mid-air (spawn_into_group resets too)
        flags=put(state.flags, 0),
        health=put(state.health, table.health[tid]))


class SurfaceDamage(NamedTuple):
    """surface_damage / charge_dist matrices (mesh.h:114-115) + decals."""

    damage: torch.Tensor    # [my, mx] accumulated surface damage
    decal_x: torch.Tensor   # [D] decal ring buffer
    decal_y: torch.Tensor
    decal_z: torch.Tensor
    decal_age: torch.Tensor
    head: torch.Tensor      # 0-d int32 ring position


def make_surface_damage(my: int, mx: int, max_decals: int = 256,
                        device: torch.device | str = "cuda") -> SurfaceDamage:
    z = lambda *s: torch.zeros(s, dtype=torch.float32, device=device)
    return SurfaceDamage(
        damage=z(my, mx), decal_x=z(max_decals), decal_y=z(max_decals),
        decal_z=z(max_decals),
        decal_age=torch.full((max_decals,), 1e9, dtype=torch.float32, device=device),
        head=torch.zeros((), dtype=torch.int32, device=device))


def add_surface_damage(sd: SurfaceDamage, gx, gy, amount) -> SurfaceDamage:
    """Accumulate mesh surface damage at a cell (weapon impacts)."""
    damage = sd.damage.clone()
    damage[gy, gx] += amount
    return sd._replace(damage=damage)


def add_decal(sd: SurfaceDamage, x, y, z) -> SurfaceDamage:
    """Write a decal into the ring buffer (decal objects); the slot index
    stays on the device."""
    i = (sd.head % sd.decal_x.shape[0]).long().reshape(1)

    def put(a, v):
        return a.index_put((i,), torch.as_tensor(v, dtype=a.dtype, device=a.device)
                           .reshape(1))

    return sd._replace(decal_x=put(sd.decal_x, x), decal_y=put(sd.decal_y, y),
                       decal_z=put(sd.decal_z, z), decal_age=put(sd.decal_age, 0.0),
                       head=sd.head + 1)

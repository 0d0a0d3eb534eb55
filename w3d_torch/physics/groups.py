"""Object group management: spawn rates, reaping, free-slot reuse (port
of `3dworld_tpu/physics/groups.py`).

The reference's `obj_group` holds a fixed-capacity array per object type
with per-frame appearance-rate spawning and oldest-replacement
(physics_objects.h:393-413; spawn logic build_world.cpp:408-445).  Here,
as in the JAX package, the single SoA population is partitioned by type
ranges, and spawning writes new objects into dead slots (oldest first)
in one masked pass.  The JAX package draws the spawn positions and
velocities from threefry; the port takes them as a `GroupDraws` input.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import types as T
from .step import ObjectState


class GroupSpec(NamedTuple):
    """Per-type group configuration (~ num_items / app_rate config)."""

    otype: int
    capacity: int
    app_rate: float      # expected spawns per frame


class GroupDraws(NamedTuple):
    """One spawn's draws for every slot: `uniform` [3, N] in [0, 1) (x, y,
    z), `normal` [3, N] standard normals (vx, vy, vz)."""

    uniform: torch.Tensor
    normal: torch.Tensor


def draw_group(n: int, generator: torch.Generator,
               device: torch.device | str = "cuda") -> GroupDraws:
    """GroupDraws for `n` slots from `generator` (on its device), moved to
    `device`."""
    gd = generator.device
    u = torch.rand((3, n), generator=generator, dtype=torch.float32, device=gd)
    g = torch.randn((3, n), generator=generator, dtype=torch.float32, device=gd)
    return GroupDraws(u.to(device), g.to(device))


def _in_range(u, lo, hi):
    """`jax.random.uniform(minval=lo, maxval=hi)` from its unit draw `u`:
    max(lo, u * (hi - lo) + lo) in float32."""
    lo32, hi32 = np.float32(lo), np.float32(hi)
    return torch.clamp(u * float(hi32 - lo32) + float(lo32), min=float(lo32))


def spawn_into_group(state: ObjectState, table: T.ObjTypeTable, draws: GroupDraws,
                     otype: int, max_spawn: int,
                     x_range=(-3.0, 3.0), y_range=(-3.0, 3.0),
                     z_range=(2.0, 3.0), v_scale: float = 0.2) -> ObjectState:
    """Spawn up to `max_spawn` new objects of `otype` into dead slots.

    Dead slots are selected oldest-first by a stable sort of (alive, -age);
    positions and velocities come from `draws`."""
    n = state.px.shape[0]
    alive = state.status > 0
    # priority: dead first, then oldest alive (reference replaces oldest)
    key_order = alive.to(torch.int32) * (1 << 24) - state.time
    order = torch.argsort(key_order, stable=True)
    rank_of = torch.empty_like(order)
    rank_of[order] = torch.arange(n, device=order.device)
    chosen = (rank_of < max_spawn) & ~alive   # only actually-dead slots
    u, g = draws
    hp = torch.ones(n, dtype=torch.float32, device=state.px.device) * table.health[otype]
    return state._replace(
        px=torch.where(chosen, _in_range(u[0], *x_range), state.px),
        py=torch.where(chosen, _in_range(u[1], *y_range), state.py),
        pz=torch.where(chosen, _in_range(u[2], *z_range), state.pz),
        vx=torch.where(chosen, v_scale * g[0], state.vx),
        vy=torch.where(chosen, v_scale * g[1], state.vy),
        vz=torch.where(chosen, v_scale * g[2], state.vz),
        otype=torch.where(chosen, otype, state.otype),
        status=torch.where(chosen, 1, state.status),
        time=torch.where(chosen, 0, state.time),
        flags=torch.where(chosen, 0, state.flags),
        health=torch.where(chosen, hp, state.health),
    )


def frame_spawns(spec: GroupSpec, frame: int) -> int:
    """Deterministic integer spawn count for a frame from the fractional
    appearance rate (accumulated remainder, like fticks-scaled app rates)."""
    return int(np.floor((frame + 1) * spec.app_rate) - np.floor(frame * spec.app_rate))


def group_stats(state: ObjectState, otype: int) -> int:
    """Live objects of `otype` (a host read)."""
    return int(((state.status > 0) & (state.otype == otype)).sum())

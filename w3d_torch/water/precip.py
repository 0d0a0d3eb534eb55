"""Precipitation: rain/snow/hail spawning + the accumulation matrix (port
of `3dworld_tpu/water/precip.py`).

The reference spawns precipitation as object groups (precipitation.cpp,
object types RAIN/SNOW/HAIL with Z_SCENE_SIZE-scaled lifetimes,
Physics.cpp:102-127) and lands them into `accumulation_matrix`
(mesh.h:113): snow piles up per mesh cell, melts above freezing, and
rainfall routes into the valley water volumes (RAIN_VOLUME,
update_valleys).

Spawn writes fresh drops into the dead slots of the object SoA; its
threefry draws in the JAX package are a `PrecipDraws` input here
(`draw_precip` makes them from a CPU generator, so every device gets the
same drops).  The free slots are a stable sort of `status`, as the JAX
package's `argsort(..., stable=True)`.  Accumulation adds 1.0 per landed
drop, so its sum is exact in any order; melt is elementwise.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..utils.constants import WorldConst, DEFAULT_WORLD
from ..physics import types as T
from ..physics.step import ObjectState

W_FREEZE_POINT = 0.0
MELT_RATE = 0.0015          # accumulation units per degree per frame
RAIN_VOLUME = 0.05          # water volume added per landed rain drop


class PrecipDraws(NamedTuple):
    """One spawn's draws, [n_spawn] float32 each: the drops' x and y over
    the scene and the standard normal of their z jitter."""

    x: torch.Tensor
    y: torch.Tensor
    zn: torch.Tensor


def draw_precip(n_spawn: int, gen: torch.Generator,
                world: WorldConst = DEFAULT_WORLD, device="cuda") -> PrecipDraws:
    """`n_spawn` drops' draws from the CPU generator `gen`, on `device`."""
    u = torch.rand((2, n_spawn), generator=gen)
    zn = torch.randn((n_spawn,), generator=gen)
    x = -world.x_scene + 2.0 * world.x_scene * u[0]
    y = -world.y_scene + 2.0 * world.y_scene * u[1]
    return PrecipDraws(*(a.to(torch.float32).to(device) for a in (x, y, zn)))


def spawn_precip(state: ObjectState, draws: PrecipDraws, kind: str,
                 world: WorldConst = DEFAULT_WORLD,
                 cloud_z: float = 1.5) -> ObjectState:
    """Recycle the oldest dead slots as fresh drops falling from the
    cloud layer (gen_precipitation: uniform over the scene); one drop per
    draw, where a dead slot is left."""
    otype = T.type_id(kind)     # "RAIN" | "SNOW" | "HAIL"
    n_spawn = draws.x.shape[0]
    idx = torch.argsort(state.status, stable=True)[:n_spawn]
    ok = state.status[idx] == 0
    dev = state.px.device

    def put(a, v):
        a = a.clone()
        a[idx] = torch.where(ok, v.to(a.dtype), a[idx])
        return a

    zeros = torch.zeros(n_spawn, dtype=torch.float32, device=dev)
    izeros = torch.zeros(n_spawn, dtype=torch.int32, device=dev)
    return state._replace(
        px=put(state.px, draws.x),
        py=put(state.py, draws.y),
        pz=put(state.pz, torch.full((n_spawn,), cloud_z, dtype=torch.float32,
                                    device=dev) + 0.2 * draws.zn),
        vx=put(state.vx, zeros),
        vy=put(state.vy, zeros),
        vz=put(state.vz, zeros),
        status=put(state.status, ok.to(torch.int32)),
        otype=put(state.otype, torch.full((n_spawn,), otype, dtype=torch.int32,
                                          device=dev)),
        time=put(state.time, izeros),
        flags=put(state.flags, izeros))


def accumulate_landed(accum: torch.Tensor, state: ObjectState, mesh=None,
                      world: WorldConst = DEFAULT_WORLD):
    """Landed snow/hail adds to the accumulation matrix; landed rain
    returns a water-volume total for the valley update.  A drop 'lands'
    when stopped on the mesh (status 2/3/4); `mesh` is unused, as in the
    JAX package's signature.  The cell is the drop's grid
    position truncated toward zero, then clipped, as the JAX package's
    `astype(int32)`.  Returns (accum, rain_volume, landed_mask)."""
    snow_id = T.type_id("SNOW")
    hail_id = T.type_id("HAIL")
    rain_id = T.type_id("RAIN")
    my, mx = accum.shape
    gx = torch.clamp((state.px * world.dx_inv + mx // 2).to(torch.int32), 0, mx - 1)
    gy = torch.clamp((state.py * world.dy_inv + my // 2).to(torch.int32), 0, my - 1)
    landed = (state.status >= 2) & (state.status <= 4)
    is_snowy = (state.otype == snow_id) | (state.otype == hail_id)
    is_rain = state.otype == rain_id
    add = (landed & is_snowy).to(torch.float32)
    accum = accum.index_put((gy.long(), gx.long()), add, accumulate=True)
    rain_volume = RAIN_VOLUME * (landed & is_rain).sum().to(torch.float32)
    return accum, rain_volume, landed & (is_snowy | is_rain)


def retire_landed(state: ObjectState, landed_mask: torch.Tensor) -> ObjectState:
    """Landed precipitation leaves the object population (the reference
    removes drops on ground contact after accumulating)."""
    return state._replace(status=torch.where(landed_mask, 0, state.status))


def melt_accumulation(accum: torch.Tensor, temperature) -> torch.Tensor:
    """Above-freezing melt (accumulation_matrix decay): linear in the
    temperature excess, floored at zero; the melt is computed in float32,
    as the JAX package's."""
    t = torch.as_tensor(temperature, dtype=torch.float32, device=accum.device)
    melt = torch.clamp(t - W_FREEZE_POINT, min=0.0) * MELT_RATE
    return torch.clamp(accum - melt, min=0.0)

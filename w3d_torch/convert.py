"""Carry state from the JAX package into the port.

The functions here take the JAX package's values after the caller has
turned their arrays into numpy (e.g. `jax.tree.map(np.asarray, value)`),
read them by field name, and build the port's tensors on a device, so both
packages can compute on the same inputs.  Nothing here imports jax.
`to_numpy` goes the other way, for comparisons and round trips.

JAX keeps per-object and per-type flags as uint32; the port keeps them as
int32 bit masks (every flag bit fits).
"""

from __future__ import annotations

import numpy as np
import torch

from .ops.noise import SineTable
from .physics.cobjs import CobjSet, GroupedCobjs
from .physics.step import ObjectState, PhysicsEnv
from .physics.types import ObjTypeTable
from .models.physics_model import SpheresWorld
from .water.ripples import RippleState
from .gameplay.player import PlayerState
from .terrain.mesh import TerrainState

_INT32_FIELDS = ("flags",)   # uint32 bit masks in JAX


def array(a, device, name: str = "") -> torch.Tensor:
    """One array (a field of a value below, a cobj field table, a map
    stack, a smoke grid, ...) -> a tensor of its own on `device`; uint32
    bit masks become int32."""
    a = np.asarray(a)
    if name in _INT32_FIELDS or a.dtype == np.uint32:
        a = a.astype(np.int32)
    return torch.as_tensor(a.copy(), device=device)


def _named(cls, src, device):
    return cls(**{f: array(getattr(src, f), device, f) for f in cls._fields})


def sine_table(src, device) -> SineTable:
    """A SineTable (or the 5-tuple of its arrays, in field order)."""
    if not hasattr(src, "mag"):
        src = SineTable(*src)
    return _named(SineTable, src, device)


def tile_inputs(table_arrs, x0, y0, zmax_est, wpz, device):
    """`TMOD.example_inputs`' (table, x0, y0, zmax_est, wpz) -> tensors."""
    f32 = lambda a: torch.as_tensor(np.array(a, np.float32), device=device)
    return sine_table(table_arrs, device), f32(x0), f32(y0), f32(zmax_est), f32(wpz)


def object_state(src, device) -> ObjectState:
    return _named(ObjectState, src, device)


def physics_env(src, device) -> PhysicsEnv:
    wh = getattr(src, "water_height", None)
    fields = {f: array(getattr(src, f), device, f)
              for f in PhysicsEnv._fields if f != "water_height"}
    return PhysicsEnv(**fields,
                      water_height=None if wh is None else array(wh, device))


def cobj_set(src, device) -> CobjSet:
    return _named(CobjSet, src, device)


def grouped_cobjs(src, device) -> GroupedCobjs:
    """A GroupedCobjs (packed `cobjs` + live `bounds`)."""
    return GroupedCobjs(cobj_set(src.cobjs, device), src.bounds)


def type_table(src, device) -> ObjTypeTable:
    return _named(ObjTypeTable, src, device)


def cobjs(src, device) -> CobjSet | GroupedCobjs:
    """A GroupedCobjs (it has `bounds`) or a plain CobjSet."""
    if hasattr(src, "bounds"):
        return grouped_cobjs(src, device)
    return cobj_set(src, device)


def spheres_world(src, device) -> SpheresWorld:
    """A SpheresWorld, its cobjs grouped or plain as `src`'s."""
    return SpheresWorld(state=object_state(src.state, device),
                        env=physics_env(src.env, device),
                        cobjs=cobjs(src.cobjs, device),
                        table=type_table(src.table, device))


def ripple_state(src, device) -> RippleState:
    return _named(RippleState, src, device)


def player_state(src, device) -> PlayerState:
    return _named(PlayerState, src, device)


def terrain_state(src, device) -> TerrainState:
    return _named(TerrainState, src, device)


def to_numpy(value):
    """Tensors -> numpy arrays through NamedTuples, GroupedCobjs, tuples
    and lists; anything else passes through."""
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy()
    if isinstance(value, GroupedCobjs):
        return GroupedCobjs(to_numpy(value.cobjs), value.bounds)
    if isinstance(value, tuple) and hasattr(value, "_fields"):
        return type(value)(*(to_numpy(v) for v in value))
    if isinstance(value, (tuple, list)):
        return type(value)(to_numpy(v) for v in value)
    return value


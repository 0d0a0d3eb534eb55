"""Teleporters + jump pads (port of `3dworld_tpu/gameplay/teleport.py`).

The reference's teleporters move objects entering a source sphere to a
destination point (teleporter.cpp:278, the 'x' cobj command); jump pads
boost vertical velocity.  One masked pass over the object SoA; the first
source an object is inside wins (a gather at `argmax`, where the JAX
package multiplies one-hot rows).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..physics.step import ObjectState


class Teleporters(NamedTuple):
    sx: torch.Tensor   # source centers
    sy: torch.Tensor
    sz: torch.Tensor
    radius: torch.Tensor
    dx: torch.Tensor   # destinations
    dy: torch.Tensor
    dz: torch.Tensor
    is_jump_pad: torch.Tensor  # bool: boost vz instead of teleporting


def make_teleporters(entries, device: torch.device | str = "cuda") -> Teleporters:
    """Rows of (sx, sy, sz, radius, dx, dy, dz, is_jump_pad)."""
    a = np.asarray(entries, np.float32).reshape(-1, 8)
    col = lambda k: torch.as_tensor(a[:, k].copy(), device=device)
    return Teleporters(sx=col(0), sy=col(1), sz=col(2), radius=col(3),
                       dx=col(4), dy=col(5), dz=col(6),
                       is_jump_pad=torch.as_tensor(a[:, 7] > 0.5, device=device))


def _inside(x, y, z, tp: Teleporters):
    d2 = ((x[:, None] - tp.sx[None, :]) ** 2 + (y[:, None] - tp.sy[None, :]) ** 2
          + (z[:, None] - tp.sz[None, :]) ** 2)
    return d2 <= (tp.radius * tp.radius)[None, :]


def _first(inside):
    """(any, first index) per row."""
    return torch.any(inside, dim=1), torch.argmax(inside.to(torch.int8), dim=1)


def apply_teleporters(state: ObjectState, tp: Teleporters,
                      jump_speed: float = 4.0) -> ObjectState:
    """Teleport/boost every live object inside a source sphere."""
    inside = _inside(state.px, state.py, state.pz, tp) & (state.status > 0)[:, None]
    any_in, first = _first(inside)
    jump = tp.is_jump_pad[first]
    tele = any_in & ~jump
    boost = any_in & jump
    return state._replace(
        px=torch.where(tele, tp.dx[first], state.px),
        py=torch.where(tele, tp.dy[first], state.py),
        pz=torch.where(tele, tp.dz[first], state.pz),
        vz=torch.where(boost, jump_speed, state.vz),
        status=torch.where(any_in, 1, state.status))


def apply_teleporters_smileys(s, tp: Teleporters):
    """Smileys walking into a teleporter take it (smileys route through
    teleporters, ai.cpp); jump pads are ignored by the ground AI.  `s` has
    x, y, z fields (and `health`, when it has one, gates on life)."""
    inside = _inside(s.x, s.y, s.z, tp) & (~tp.is_jump_pad)[None, :]
    if hasattr(s, "health"):
        inside = inside & (s.health > 0)[:, None]
    any_in, first = _first(inside)
    return s._replace(x=torch.where(any_in, tp.dx[first], s.x),
                      y=torch.where(any_in, tp.dy[first], s.y),
                      z=torch.where(any_in, tp.dz[first], s.z))

"""Player / camera physics: surface walking + collision push-out (port of
`3dworld_tpu/gameplay/player.py`).

The reference's camera is a collision sphere: `proc_sphere_coll` vs
mesh/cobjs/bridges, `set_true_obj_height` surface walking with
camera_height above the ground, step-height climbing, jumping, and
water wading (collision_detect.cpp camera paths, Physics.cpp player
motion).

One object, so every tensor is [1] — but it reuses the batched mesh
sample and narrow phase at N = 1: on the card the mesh sample is kernel B
(`ops/cuda/sample_kernel`), and `physics/step.cobj_hits` takes kernel C
for a grouped scene and the ungrouped `physics/cobjs.deepest_hits` for a
plain `CobjSet`.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..utils.constants import WorldConst, DEFAULT_WORLD
from ..physics.step import cobj_hits, outside_mesh
from ..ops.cuda import sample_kernel as SK

GRAVITY_Z = 0.4          # per-second^2 in scene units (player scale)
JUMP_VEL = 0.22


class PlayerState(NamedTuple):
    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor
    vz: torch.Tensor
    on_ground: torch.Tensor   # bool


def make_player(x=0.0, y=0.0, z=1.0,
                device: torch.device | str = "cuda") -> PlayerState:
    f = lambda v: torch.tensor([v], dtype=torch.float32, device=device)
    return PlayerState(f(x), f(y), f(z), f(0.0),
                       torch.zeros(1, dtype=torch.bool, device=device))


def _input(v):
    """A move input as float32: a tensor stays where it is (a device
    scalar is never read back), a number becomes a CPU scalar tensor."""
    if isinstance(v, torch.Tensor):
        return v.to(torch.float32)
    return torch.tensor(v, dtype=torch.float32)


def step_player(p: PlayerState, mesh: torch.Tensor, cobjs, move_x, move_y, jump,
                dt: float = 0.05, world: WorldConst = DEFAULT_WORLD,
                camera_radius: float = 0.045, camera_height: float = 0.08,
                step_height: float = 0.04, speed: float = 0.4) -> PlayerState:
    """One player tick: walk, climb small steps, fall, jump, and get
    pushed out of cobjs (proc_sphere_coll + set_true_obj_height).
    `cobjs` is a `GroupedCobjs`, a plain `CobjSet` or None; `move_x`,
    `move_y` and `jump` are numbers or scalar tensors."""
    x = p.x + speed * dt * _input(move_x)
    y = p.y + speed * dt * _input(move_y)
    # clamp to the mesh (the camera cannot leave the scene)
    x = torch.clamp(x, -world.x_scene + 0.01, world.x_scene - 0.01)
    y = torch.clamp(y, -world.y_scene + 0.01, world.y_scene - 0.01)

    # vertical motion first: jump or gravity, then integrate z
    jump = jump.to(torch.bool) if isinstance(jump, torch.Tensor) else bool(jump)
    vz = torch.where(p.on_ground & jump, JUMP_VEL, p.vz - GRAVITY_Z * dt)
    z = p.z + vz * dt

    # mesh floor (+ small-step climbing)
    mh, _nx, _ny, _nz = SK.sample_mesh(mesh, x, y, world)
    ground = mh + camera_height
    below = ground - z
    landed = (z <= ground) & (vz <= 0)
    # step climbing only while walking ON the ground and only up to
    # step_height (adding camera_height to the budget, or allowing it
    # mid-air, would snap jumps down and climb 3x-too-tall ledges)
    can_step = p.on_ground & (below > 0) & (below <= step_height)
    z = torch.where(landed | can_step, ground, z)
    vz = torch.where(landed | can_step, 0.0, vz)
    on_ground = landed | can_step

    # cobj push-out AFTER the z update: tops act as floors
    if cobjs is not None and cobjs.size > 0:
        hit, pen, cnx, cny, cnz, _e, _f = cobj_hits(
            x, y, z, torch.full_like(x, camera_radius), cobjs)
        push = hit.to(torch.float32) * pen
        x = x + push * cnx
        y = y + push * cny
        z = z + push * cnz
        standing_on_cobj = hit & (cnz > 0.5)
        vz = torch.where(standing_on_cobj, torch.clamp(vz, min=0.0), vz)
        on_ground = on_ground | standing_on_cobj

    off = outside_mesh(x, y, world)
    return p._replace(x=x, y=y, z=z, vz=vz, on_ground=on_ground & ~off)

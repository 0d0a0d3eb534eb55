"""World-mode frame orchestration (port of the ground half of
`3dworld_tpu/models/world.py`).

The reference's `display()` branches on world mode (3DWorld.h:1360);
WMODE_GROUND runs physics + water + smoke each frame
(display_world.cpp:768).  `ground_frames_chained` runs K such frames per
call: the JAX package scans them on the device; here they are a Python
loop of eager launches that never reads a device value back, so the host
queues all K frames without waiting.

Not ported yet: `ground_frame` (it reads a loaded `GroundScene`, with
platforms), `with_valley_water`, and the tiled and universe modes.
"""

from __future__ import annotations

import torch

from ..utils.constants import WorldConst
from ..physics import step as PS
from ..water import ripples as WR, smoke as WSM
from ..gameplay import player as PL


def ground_frames_chained(objects: PS.ObjectState, env: PS.PhysicsEnv, cobjs,
                          table, ripples: WR.RippleState, player: PL.PlayerState,
                          move_xy, world: WorldConst, frames: int,
                          substeps: int = 4, obj_collisions: bool = True,
                          smoke: torch.Tensor | None = None):
    """K ground frames: physics + ripples + player (+ smoke) per frame.

    `cobjs` is a `GroupedCobjs` or a plain `CobjSet`; `move_xy` is
    [frames, 2] per-frame player input (a tensor on the device, or numpy).
    Smoke steps through the gated `water/smoke.diffuse_smoke`, as the JAX
    frame's XLA call does.  Returns (objects, ripples, player, live
    [frames] int32), and the smoke grid last when `smoke` is given; `live`
    stays on the device."""
    wpz = env.water_plane_z
    inside = wpz > env.mesh_height
    depth = torch.clamp(wpz - env.mesh_height, min=0.0)

    st, rip, ply, smk = objects, ripples, player, smoke
    live = []
    for k in range(frames):
        st = PS.step_objects(st, env, cobjs, table, substeps=substeps,
                             world=world, obj_collisions=obj_collisions)
        rip, _ = WR.step_ripples(rip, inside, depth)
        ply = PL.step_player(ply, env.mesh_height, cobjs, move_xy[k][0],
                             move_xy[k][1], False, world=world)
        if smk is not None:       # distribute_smoke each frame
            smk = WSM.diffuse_smoke(smk)
        live.append((st.status > 0).sum(dtype=torch.int32))
    live = torch.stack(live)
    if smoke is None:
        return st, rip, ply, live
    return st, rip, ply, live, smk

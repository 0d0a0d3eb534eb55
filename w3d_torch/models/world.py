"""World-mode frame orchestration (port of the ground half of
`3dworld_tpu/models/world.py`).

The reference's `display()` branches on world mode (3DWorld.h:1360);
WMODE_GROUND runs physics + water + smoke each frame
(display_world.cpp:768).  `ground_frames_chained` runs K such frames per
call: the JAX package scans them on the device; here they are a Python
loop of eager launches that never reads a device value back, so the host
queues all K frames without waiting.

`ground_frame` steps a loaded `GroundScene` (scene/loader.py) by one
frame: the platform and trigger pass, riders, physics, ripples and gated
smoke; `with_valley_water` fills its terrain basins and feeds the water
surface to the physics env.  Not ported yet: the tiled and universe
modes.
"""

from __future__ import annotations

import torch

from ..utils.constants import WorldConst
from ..physics import step as PS
from ..water import ripples as WR, smoke as WSM
from ..gameplay import player as PL
from ..physics import platforms as PP
from ..scene.loader import GroundScene


def with_valley_water(scene: GroundScene, volumes_per_basin) -> GroundScene:
    """Fill terrain basins and feed the per-cell water surface into the
    physics env (water_matrix wiring: valleys -> check_water_collision).
    Edits `scene` in place and returns it."""
    from ..water import valleys as WV

    _labels, _zv, water, _wet = WV.fill_valleys(
        scene.env.mesh_height, volumes_per_basin, scene.world)
    scene.env = scene.env._replace(water_height=water)
    return scene


def ground_frame(scene: GroundScene, substeps: int = 4,
                 obj_collisions: bool = True) -> GroundScene:
    """One WMODE_GROUND frame: platforms + process_groups + ripples
    (display() loop; platform/trigger pass = display_world.cpp:889).
    Edits `scene` in place (objects, cobjs, platforms, ripples, the smoke
    grid) and returns it; nothing reads a device value back."""
    if scene.platforms is not None and scene.platforms.size > 0:
        st0 = scene.objects
        trig = None
        if scene.triggers is not None and scene.triggers.x.shape[0] > 0:
            trig = PP.eval_triggers(scene.triggers, st0.px, st0.py, st0.pz,
                                    scene.platforms)
        plats, mx, my, mz = PP.advance_platforms(scene.platforms, trig)
        rad = scene.table.radius[st0.otype.long()]
        dx, dy, dz = PP.rider_deltas(st0.px, st0.py, st0.pz, st0.status,
                                     scene.cobjs, plats, mx, my, mz, rad)
        scene.cobjs = PP.apply_platform_motion(scene.cobjs, plats, mx, my, mz)
        scene.objects = st0._replace(px=st0.px + dx, py=st0.py + dy,
                                     pz=st0.pz + dz)
        scene.platforms = plats
    st = PS.step_objects(scene.objects, scene.env, scene.cobjs, scene.table,
                         substeps=substeps, world=scene.world,
                         obj_collisions=obj_collisions)
    wpz = scene.env.water_plane_z
    inside = wpz > scene.terrain.mesh_height
    depth = torch.clamp(wpz - scene.terrain.mesh_height, min=0.0)
    ripples, _ = WR.step_ripples(scene.ripples, inside, depth)
    # smoke diffusion over the lmcell grid every frame (distribute_smoke,
    # smoke.cpp:184), gated by the HOST flag (set by whoever injects
    # smoke), so no device value is read to decide
    if scene.smoke_active and scene.light_grid is not None:
        scene.light_grid = scene.light_grid._replace(
            smoke=WSM.diffuse_smoke(scene.light_grid.smoke))
    scene.objects = st
    scene.ripples = ripples
    return scene


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

"""Scene assembly: config -> a runnable ground world (port of
`3dworld_tpu/scene/loader.py`).

The reference's `gen_scene` (3DWorld.cpp:2460 + build_world.cpp) loads
the config, generates the terrain, reads coll objects, creates object
groups and initializes lighting.  `load_scene` does the same against the
port's modules and returns a `GroundScene` on a device, which
`models/world.ground_frame` steps.  Loading is host work, apart from the
terrain (erosion through kernel A on the card) and scenery placement; the
host reads the finished mesh once (trees, scenery, the water plane).
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import torch

from ..utils.config import Config, load_config
from ..utils.constants import WorldConst
from ..utils.rng import RandGen
from ..terrain import mesh as TM
from ..ops import erosion as E
from ..physics import types as PT, step as PS, cobjs as PC
from ..physics import platforms as PP
from ..lighting import bake as LB
from ..lighting import lmap as LM
from ..water import ripples as WR
from . import cobj as SC
from .sphere_materials import parse_sphere_materials, SphereMaterials

EROSION_BATCH = 1024   # the ground terrain's erosion batches and steps
EROSION_STEPS = 256    # (ops/erosion.erode's defaults)


@dataclass
class GroundScene:
    cfg: Config
    world: WorldConst
    terrain: TM.TerrainState
    cobjs: PC.CobjSet
    table: PT.ObjTypeTable
    objects: PS.ObjectState
    env: PS.PhysicsEnv
    ripples: WR.RippleState
    light_grid: LM.LightGrid
    sphere_mats: SphereMaterials
    mat_first: int = -1   # first material type id (-1: no material spheres)
    # full scene-DSL entities (build_world.cpp parser outputs)
    parse: SC.SceneParse = None
    platforms: PP.PlatformSet = None
    triggers: PP.TriggerSet = None
    voxel: object = None        # VoxelGrid for voxel-landscape scenes
    smoke_active: bool = False  # host flag: smoke exists in light_grid
    trees: object = None        # (x, y, z, trunk_r, height) numpy arrays
    scenery: object = None      # veg.scenery.ScenerySet
    bake: object = None         # lighting.bake.LightBake of `num_light_rays`, or None
    # (smoke_active is set by the code that injects smoke; it gates
    # per-frame diffusion without a device probe)


def voxel_params_from_config(cfg):
    """`voxel <param> <val>` sub-config rows -> VoxelParams
    (voxel_params_t keyword block, 3DWorld.cpp voxel kwm)."""
    from ..voxel import grid as VG
    v = cfg.voxel

    def num(k, d):
        try:
            return float(v[k])
        except (KeyError, ValueError):
            return d

    return VG.VoxelParams(
        xsize=int(num("xsize", 64)), ysize=int(num("ysize", 64)),
        zsize=int(num("zsize", 32)),
        num_blocks=int(num("num_blocks", 12)),
        isolevel=num("isolevel", 0.0),
        elasticity=num("elasticity", 0.5),
        mag=num("mag", 1.0), freq=num("freq", 1.0),
        atten_thresh=num("atten_thresh", 1.0),
        z_gradient=num("z_gradient", 0.0),
        radius_val=num("radius_val", 0.5),
        invert=bool(int(num("invert", 0))),
        normalize_to_1=bool(int(num("normalize_to_1", 1))),
        make_closed_surface=bool(int(num("make_closed_surface", 1))),
        remove_unconnected=int(num("remove_unconnected", 1)),
        atten_at_edges=int(num("atten_at_edges", 0)),
        atten_top_mode=int(num("atten_top_mode", 0)),
        geom_rseed=int(num("geom_rseed", 123)),
    )


def erosion_angles(erosion_iters: int,
                   device: torch.device | str = "cuda") -> torch.Tensor:
    """The flat-spot directions a loaded scene's terrain erodes with,
    [ceil(erosion_iters / 1024), 256, 1024]: drawn from a CPU generator
    seeded 0 and copied to `device`, so every device gets the same draws
    (the JAX package draws from a fixed threefry key, which torch cannot
    reproduce; the parity tests put its draws in place of this function)."""
    g = torch.Generator().manual_seed(0)
    return E.draw_angles(erosion_iters, EROSION_BATCH, EROSION_STEPS, g,
                         device="cpu").to(device)


def _find(name: str, config_path: str, search_dirs) -> str | None:
    """`name` under the config's directory, its parent, or a search dir."""
    here = os.path.dirname(os.path.abspath(config_path))
    for d in (here, os.path.dirname(here), *search_dirs):
        p = os.path.join(d, name)
        if os.path.exists(p):
            return p
    return None


def load_scene(config_path: str, num_objects: int = 0, search_dirs: tuple = (),
               device: torch.device | str = "cuda") -> GroundScene:
    """Load a config_*.txt scene end to end onto `device`.  An eroded
    terrain erodes with `erosion_angles`' draws.  A config that sets
    `num_light_rays` gets the plan of its lighting bake (`bake`), which
    the app runs before its first frame."""
    cfg = load_config(config_path)
    world = cfg.world_const()
    tcfg = cfg.terrain_config()
    if cfg.rand_seed and tcfg.mesh_seed == 0:
        tcfg = tcfg._replace(mesh_seed=cfg.rand_seed)
    angles = (erosion_angles(tcfg.erosion_iters, device)
              if tcfg.erosion_iters > 0 else None)

    # image-driven mesh (read_mesh_height_image, mesh_gen.cpp:135-160):
    # mesh_height_image + read_heightmap 1 replaces procedural generation,
    # with the brush-journal modmap replayed on load (heightmap.cpp)
    terrain = None
    if cfg.read_heightmap and cfg.mh_filename:
        from ..utils.checkpoint import ModmapJournal
        here = os.path.dirname(os.path.abspath(config_path))
        for d in (here, os.path.dirname(here), *search_dirs):
            p = os.path.join(d, cfg.mh_filename)
            if os.path.exists(p):
                modmap = None
                if cfg.read_hmap_modmap_filename:
                    mp = os.path.join(d, cfg.read_hmap_modmap_filename)
                    if os.path.exists(mp):
                        modmap = ModmapJournal.load(mp)
                terrain = TM.terrain_from_heightmap(p, tcfg, world, modmap=modmap,
                                                    angles=angles, device=device)
                break
    if terrain is None:
        terrain = TM.gen_terrain(tcfg, world, angles=angles, device=device)

    # voxel landscape (create_voxel_landscape, 3DWorld.cpp:2178 +
    # gen_voxel_landscape): the procedural voxel terrain generates from the
    # scene's `voxel` sub-config and its top surface fuses into the physics
    # heightfield before trees and scenery are placed on it (the reference
    # adds voxel cobjs; the ball/mesh interaction collides with the
    # column-top surface, and VoxelCollider serves triangle queries)
    voxel = None
    if cfg.create_voxel_landscape and cfg.voxel:
        from ..voxel import grid as VG
        vp = voxel_params_from_config(cfg)
        voxel = VG.make_voxel_grid(vp, world, device=device)
        vsurf = VG.top_surface(voxel, vp.isolevel, out_shape=terrain.mesh_height.shape)
        mh = terrain.mesh_height
        terrain = terrain._replace(mesh_height=torch.maximum(
            mh, torch.where(torch.isfinite(vsurf), vsurf, mh)))

    # the host's one copy of the finished mesh and water plane
    hm_np = terrain.mesh_height.cpu().numpy()
    wz = -1e9 if cfg.disable_water else float(terrain.water_plane_z)

    # ground-mode trees (regen_trees at gen_scene, Tree.cpp): ntrees
    # seeded placements above water; each tree's TRUNK registers as a
    # collision cylinder (the reference's tree cobjs) appended to the
    # scene's cobj set below
    trees = None
    tree_cobjs = []
    if cfg.ntrees > 0:
        trg = RandGen((cfg.rand_seed or 1) + 43, (cfg.rand_seed or 1) * 3 + 7)
        my, mx = hm_np.shape
        tx, ty, tz, tr, th = [], [], [], [], []
        for _ in range(cfg.ntrees):
            gx = trg.rand() % mx
            gy = trg.rand() % my
            z = float(hm_np[gy, gx])
            if z <= wz:
                continue          # no trees under water
            h = (0.04 + 0.04 * trg.randd()) * world.z_scene
            tx.append((gx - mx // 2) * world.dx)
            ty.append((gy - my // 2) * world.dy)
            tz.append(z)
            tr.append(0.08 * h)
            th.append(h)
        trees = tuple(np.asarray(v, np.float32) for v in (tx, ty, tz, tr, th))
        lay = SC.CobjLayer(elasticity=0.4, color=(0.45, 0.33, 0.2, 1.0))
        for (x, y, z, r, h) in zip(*trees):
            tree_cobjs.append(SC.RawCobj(
                SC.COLL_CYLINDER, (float(x), float(y), float(z)),
                (float(x), float(y), float(z + h)),
                r1=float(r), r2=float(0.7 * r), layer=lay))

    # scenery (gen_scenery, scenery.cpp): rocks/boulders/logs/stumps
    # placed over the mesh unless disabled; ROCK kinds register sphere
    # cobjs (the reference's scenery rock cobjs)
    scenery = None
    scenery_cobjs = []
    if not cfg.disable_scenery:
        from ..veg import scenery as VS
        dzdx = np.gradient(hm_np, axis=1) / world.dx
        dzdy = np.gradient(hm_np, axis=0) / world.dy
        norm_z = 1.0 / np.sqrt(dzdx ** 2 + dzdy ** 2 + 1.0)
        scenery = VS.place_scenery(
            (cfg.rand_seed or 1) + 101,
            -(world.mesh_x // 2), -(world.mesh_y // 2),
            terrain.mesh_height, torch.as_tensor(norm_z, device=device), world)
        lay_r = SC.CobjLayer(elasticity=0.6, color=(0.5, 0.5, 0.5, 1.0))
        sx, sy, sz, sk, ss, sv = (t.cpu().numpy() for t in (
            scenery.x, scenery.y, scenery.z, scenery.kind, scenery.size,
            scenery.valid))
        for i in range(len(sx)):
            # rock-ish kinds (0/1 of the 5-kind table) get cobjs
            if sv[i] and sk[i] <= 1 and sz[i] > wz:
                scenery_cobjs.append(SC.RawCobj(
                    SC.COLL_SPHERE,
                    (float(sx[i]), float(sy[i]), float(sz[i])),
                    r1=float(ss[i]), layer=lay_r))

    # coll objects (resolved against the config dir + search dirs)
    parse = SC.SceneParse()
    if cfg.load_coll_objs and cfg.coll_obj_file:
        p = _find(cfg.coll_obj_file, config_path, search_dirs)
        if p is not None:
            parse = SC.parse_coll_obj_file(p, sphere_gen_seed=cfg.rand_seed,
                                           sphere_gen=cfg.sphere_gen)
    parse.cobjs.extend(tree_cobjs)       # trunk cylinders join the scene
    parse.cobjs.extend(scenery_cobjs)    # scenery rock cobjs
    cobjs = (SC.pack_cobjs(parse, device=device) if parse.cobjs
             else PC.empty_cobjs(128, device=device))
    platforms = PP.build_platforms(parse.platforms, device=device)
    triggers = PP.triggers_from_specs(parse.platforms, device=device)

    sphere_mats = SphereMaterials()
    if cfg.sphere_materials_fn:
        p = _find(cfg.sphere_materials_fn, config_path, search_dirs)
        if p is not None:
            sphere_mats = parse_sphere_materials(p)

    table = PT.make_type_table(z_scene=world.z_scene, device=device)
    n = num_objects or max(cfg.num_dodgeballs, 1)
    rng = np.random.default_rng(cfg.rand_seed or 1)
    pos = np.stack([
        rng.uniform(-0.8 * world.x_scene, 0.8 * world.x_scene, n),
        rng.uniform(-0.8 * world.y_scene, 0.8 * world.y_scene, n),
        rng.uniform(0.3 * world.z_scene, 0.9 * world.z_scene, n)], 1)
    mat_first = -1
    if sphere_mats.materials:
        # thrown spheres ARE material spheres in this scene
        # (throw_sphere spawns MAT_SPHERE with obj.direction = mat_ix,
        # sphere_materials.cpp:352-395): each material gets its own type
        # row (density/hardness/radius), objects cycle the material list
        table, mat_first = PT.extend_table_with_materials(
            table, sphere_mats.materials)
        otypes = mat_first + (np.arange(n) % len(sphere_mats.materials))
    else:
        otypes = np.full(n, PT.type_id("BALL"))
    objects = PS.make_state(pos, np.zeros((n, 3), np.float32), otypes, table)

    light_grid = LM.make_light_grid(world, device=device)
    bake = None
    if cfg.num_light_rays:
        # the load-time lighting bake (compute_ray_trace_lighting): the
        # sun at the config's `sun_rot`, the scene's lights as
        # compute_scene_lighting traces them, water and temperature as
        # the scene sets them.  The 'b' cube volumes (`parse.cube_lights`)
        # light the sky and global channels in 3DWorld; no tracer of the
        # port models them, and the bake leaves them out.
        params = LB.PRODUCTION._replace(water_plane_z=wz, temperature=cfg.temperature)
        bake = LB.LightBake(light_grid, cobjs, terrain.mesh_height, cfg.num_light_rays,
                            world=world, sun_rot=getattr(cfg, "sun_rot", None),
                            lights=parse.lights, seed=cfg.rand_seed, params=params)

    f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=device)
    env = PS.PhysicsEnv(
        mesh_height=terrain.mesh_height, water_plane_z=f32(wz),
        wind=f32(cfg.wind_velocity), temperature=f32(cfg.temperature),
        base_gravity=f32(cfg.gravity), zmin=f32(float(terrain.zmin)),
    )
    return GroundScene(
        cfg=cfg, world=world, terrain=terrain, cobjs=cobjs, table=table,
        objects=objects, env=env,
        ripples=WR.make_ripples(world.mesh_y, world.mesh_x, device=device),
        light_grid=light_grid,
        sphere_mats=sphere_mats,
        mat_first=mat_first,
        parse=parse, platforms=platforms, triggers=triggers,
        voxel=voxel, trees=trees, scenery=scenery, bake=bake,
    )

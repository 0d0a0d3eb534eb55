"""Torch port vs JAX package: the combined world step, state carried across
by `w3d_torch.convert`, and the port's independence from jax."""

import subprocess
import sys
import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import w3d  # noqa: F401
from w3d.ops import noise as JN
from w3d.ops import erosion as JE
from w3d.terrain import mesh as JM
from w3d.models import terrain_model as JTM
from w3d.models import physics_model as JPM
from w3d.physics import step as JPS
from w3d.ops.pallas.erosion_kernel import erode_tiles_pallas
from w3d.utils.constants import WorldConst as JWorld

from w3d_torch import convert, entry
from w3d_torch.models import terrain_model as TTM
from w3d_torch.terrain import mesh as TMESH
from w3d_torch.utils.constants import WorldConst as TWorld

from torch_port_util import jax_angle_tables, np_tree

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_combined(table, x0, y0, ze, wpz, sw, jm, jw, substeps):
    """The JAX composition the port's combined_step mirrors: the tile path
    `tile_batch_step(use_pallas_erosion=True)` runs on the TPU (Pallas
    erosion in interpret mode here), then one frame over tiles[0] with the
    banded pair pass the TPU runs."""
    cfg = jm.cfg
    z = JTM._tile_heights(JN.SineTable(*table), x0, y0, jm, jw, ze)
    ep = JE.ErosionParams(erode_amount=cfg.erode_amount, water_plane_z=wpz,
                          half_dxy=jw.half_dxy, zmin=-ze, zmax=ze,
                          rock_thresh=JM.clip_hd1(cfg),
                          relh_adj_tex=cfg.relh_adj_tex)
    tiles = erode_tiles_pallas(z, jm.erosion_iters_tt, ep, min_zval=-1.0e9,
                               batch_size=jm.erosion_batch,
                               max_steps=jm.erosion_steps, interpret=True)
    env = sw.env._replace(mesh_height=tiles[0])
    st = JPS.step_objects(sw.state, env, sw.cobjs, sw.table, substeps=substeps,
                          world=jw, obj_collisions=True, pair_method="banded")
    return np.asarray(tiles), np_tree(st)


def test_combined_step_matches_jax():
    """Tiles within 1e-3; positions/velocities within 1e-5, status, flags
    and time exact.  The tiles use erode_amount 0.01: the droplet walk turns
    the few-ulp differences of the two packages' noise heights into
    branch flips (see test_torch_terrain's tile test), and a smaller
    erode amount keeps each flip's effect small; the stages themselves are
    held tighter in test_torch_terrain."""
    jw, tw = JWorld(mesh_x=32, mesh_y=32), TWorld(mesh_x=32, mesh_y=32)
    kw = dict(tile_size=32, erosion_iters_tt=150, erosion_batch=128,
              erosion_steps=8)
    jm = JTM.TileModelConfig(cfg=JM.TerrainConfig(erode_amount=0.01), **kw)
    tm = TTM.TileModelConfig(cfg=TMESH.TerrainConfig(erode_amount=0.01),
                             use_pallas_erosion=True, **kw)
    table, x0, y0, ze, wpz = JTM.example_inputs(jm, jw, num_tiles=2)
    # the tiles sit near -7.5, under the ground cube: the frame samples
    # tiles[0] but its contacts are with the cobjs (the mesh contacts are
    # held in test_torch_physics)
    sw = JPM.build_spheres_world(num_objects=300, world=jw)
    st = sw.state
    sw = sw._replace(state=st._replace(pz=st.pz * 0.3 - 0.6,
                                       vz=st.vz * 8 - 3.0))
    ref_tiles, ref = _jax_combined(table, x0, y0, ze, wpz, sw, jm, jw, 4)

    targs = convert.tile_inputs(jax.tree.map(np.asarray, table), x0, y0, ze,
                                wpz, "cpu")
    ang = torch.as_tensor(jax_angle_tables(150, 128, 8))
    tsw = convert.spheres_world(np_tree(sw), "cpu")
    tiles, out = entry.combined_step(*targs, ang, tsw.state, tsw, tm, tw,
                                     substeps=4)
    assert tiles.shape == (2, 32, 32)
    np.testing.assert_allclose(tiles.numpy(), ref_tiles, rtol=0, atol=1e-3)
    for name in ("px", "py", "pz", "vx", "vy", "vz"):
        a, b = getattr(ref, name), getattr(out, name).numpy()
        assert np.abs(a - b).max() < 1e-5, (name, float(np.abs(a - b).max()))
    for name in ("status", "flags", "time"):
        a, b = getattr(ref, name), getattr(out, name).numpy()
        np.testing.assert_array_equal(a.astype(b.dtype), b, err_msg=name)
    assert (ref.time == 1).all() and (ref.status != 1).any()


def test_convert_round_trip():
    """JAX values -> numpy -> port tensors -> numpy is the identity (flags
    become int32 with the same bits)."""
    w = JWorld()
    sw = np_tree(JPM.build_spheres_world(num_objects=64, world=w))
    port = convert.spheres_world(sw, "cpu")
    back = convert.to_numpy(port)
    for part in ("state", "env", "table"):
        a, b = getattr(sw, part), getattr(back, part)
        for name in b._fields:
            va, vb = getattr(a, name), getattr(b, name)
            if va is None:
                assert vb is None
                continue
            assert vb.shape == np.shape(va), (part, name)
            np.testing.assert_array_equal(np.asarray(va).astype(vb.dtype), vb,
                                          err_msg=f"{part}.{name}")
    assert back.cobjs.bounds == tuple(tuple(b) for b in sw.cobjs.bounds)
    for name in back.cobjs.cobjs._fields:
        np.testing.assert_array_equal(
            np.asarray(getattr(sw.cobjs.cobjs, name)),
            getattr(back.cobjs.cobjs, name).astype(
                np.asarray(getattr(sw.cobjs.cobjs, name)).dtype), err_msg=name)
    table = JN.gen_sine_table(w, mesh_seed=5)
    t2 = convert.to_numpy(convert.sine_table(jax.tree.map(np.asarray, table),
                                             "cpu"))
    for a, b in zip(table, t2):
        np.testing.assert_array_equal(np.asarray(a), b)


def test_import_leaves_jax_out():
    """Importing the port, its entry points, every module of scene loading,
    of ground physics and game mode, of tiled mode (tiles, the city,
    the fauna, the event journal), of universe mode (generation, names,
    surfaces, asteroids, ship defs, fleets, combat), of lighting (volumes,
    dlights, the tracer, platform and group volumes, the sweep, building
    lighting), of the voxel engine, of the rest of the city (objects,
    tunnels, model instances, malls and backrooms, basement water,
    interaction, building gameplay), of trees and grass, of the map view,
    of the full-world build, of scenery, weather, state and checkpoint I/O,
    the profiler and edit menus, every model format, skinning, mesh
    optimization and textures, and the subpackages that import them, loads
    no jax, no
    module of the JAX package and nothing from its directory (its compiled
    `native/` parser included)."""
    code = ("import os, sys, w3d_torch, w3d_torch.entry, w3d_torch.convert, "
            "w3d_torch.app, w3d_torch.scene.loader, w3d_torch.scene.cobj, "
            "w3d_torch.scene.csg, w3d_torch.scene.model3d, "
            "w3d_torch.scene.sphere_materials, w3d_torch.physics.platforms, "
            "w3d_torch.veg.scenery, w3d_torch.lighting.lmap, "
            "w3d_torch.export.heightmap_io, w3d_torch.utils.config, "
            "w3d_torch.utils.checkpoint, "
            "w3d_torch.models.world, w3d_torch.gameplay.player, "
            "w3d_torch.water.ripples, w3d_torch.terrain.mesh, "
            "w3d_torch.ops.ray, w3d_torch.physics.destroy, w3d_torch.physics.groups, "
            "w3d_torch.physics.particles, w3d_torch.physics.movable, "
            "w3d_torch.water.valleys, w3d_torch.gameplay.game, w3d_torch.gameplay.ai, "
            "w3d_torch.gameplay.frame, w3d_torch.gameplay.waypoints, "
            "w3d_torch.gameplay.teleport, w3d_torch.gameplay.spray, "
            "w3d_torch.ops.ao, w3d_torch.ops.shadows, w3d_torch.terrain.biomes, "
            "w3d_torch.terrain.tiles, w3d_torch.city.plots, w3d_torch.city.roads, "
            "w3d_torch.city.buildings, w3d_torch.city.structures, "
            "w3d_torch.city.floorplan, w3d_torch.city.room_content, "
            "w3d_torch.city.clocks, w3d_torch.city.traffic, w3d_torch.city.people, "
            "w3d_torch.city.city_step, w3d_torch.city.assemble, "
            "w3d_torch.city.spectate, w3d_torch.veg.animals, w3d_torch.utils.events, "
            "w3d_torch.utils.assets, w3d_torch.utils.names, w3d_torch.universe, "
            "w3d_torch.universe.gen, w3d_torch.universe.surface, "
            "w3d_torch.universe.asteroids, w3d_torch.universe.ship_config, "
            "w3d_torch.universe.ships, w3d_torch.universe.combat, "
            "w3d_torch.lighting, w3d_torch.lighting.dlights, w3d_torch.lighting.trace, "
            "w3d_torch.lighting.accum, w3d_torch.lighting.sweep, "
            "w3d_torch.lighting.building_indir, w3d_torch.voxel, w3d_torch.voxel.grid, "
            "w3d_torch.voxel.mc256, w3d_torch.voxel.mc, w3d_torch.voxel.ao, "
            "w3d_torch.voxel.edit, w3d_torch.voxel.collide, w3d_torch.ops.fmath, "
            "w3d_torch.city.objects, w3d_torch.city.tunnels, "
            "w3d_torch.city.model_instances, w3d_torch.city.mall_backrooms, "
            "w3d_torch.city.building_water, w3d_torch.city.bldg_interact, "
            "w3d_torch.city.bldg_gameplay, w3d_torch.veg.trees, w3d_torch.veg.grass, "
            "w3d_torch.export.map_view, w3d_torch.full_world, "
            "w3d_torch.scene, w3d_torch.water, w3d_torch.veg, w3d_torch.utils, "
            "w3d_torch.export, w3d_torch.terrain.state_io, w3d_torch.utils.profiler, "
            "w3d_torch.utils.edit_ui, w3d_torch.water.snow, w3d_torch.water.precip, "
            "w3d_torch.water.clouds, w3d_torch.scene.read_mesh_formats, "
            "w3d_torch.scene.read_3ds, w3d_torch.scene.read_gltf, "
            "w3d_torch.scene.read_fbx, w3d_torch.scene.animation, "
            "w3d_torch.scene.mesh_opt, w3d_torch.export.textures, "
            "w3d_torch.export.texture_catalog; "
            "jaxdir = os.path.join(os.getcwd(), '3dworld_tpu'); "
            "bad = sorted(m for m, v in sys.modules.items() if m == 'jax' "
            "or m.startswith('jax.') or m == 'w3d' or m.startswith('w3d.') "
            "or 'w3dnative' in m "
            "or (getattr(v, '__file__', None) or '').startswith(jaxdir)); "
            "print(bad); sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr

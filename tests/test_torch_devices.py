"""The port's entry points, and the functions that make their inputs, put
their tensors on the card when no device is given, and never fall back to
the CPU: without CUDA, a call that names no device raises as PyTorch
raises for a CUDA tensor.

Whether a card exists is decided inside the test, never at import."""

import os
import tempfile

import numpy as np
import pytest
import torch

from w3d_torch.models import physics_model as PM
from w3d_torch.models import terrain_model as TMOD
from w3d_torch.ops import erosion as E
from w3d_torch.ops import noise as N
from w3d_torch.gameplay import player as PL
from w3d_torch.lighting import lmap as LM
from w3d_torch.physics import platforms as PP
from w3d_torch.physics import cobjs as PC
from w3d_torch.physics import types as PT
from w3d_torch.scene import cobj as SC
from w3d_torch.scene import loader as SL
from w3d_torch.terrain import mesh as TM
from w3d_torch.utils.checkpoint import ModmapJournal
from w3d_torch.utils.constants import WorldConst
from w3d_torch.water import ripples as WR
from w3d_torch import app as APP
from w3d_torch.gameplay import ai as AI, game as GG, spray as SP, teleport as TP
from w3d_torch.physics import destroy as PD, particles as PPT
from w3d_torch.city import assemble as CA, city_step as CCS, floorplan as CF
from w3d_torch.city import room_content as CRC
from w3d_torch.models import world as WM
from w3d_torch.terrain import tiles as TL
from w3d_torch.ops import noise as ON
from w3d_torch.universe import asteroids as UA, combat as UCB, ship_config as USC
from w3d_torch.universe import ships as USH, surface as USF
from w3d_torch.utils.kernel_probe import write_ship_defs
from w3d_torch.lighting import accum as LA, building_indir as LB, dlights as LD
from w3d_torch.lighting import trace as LT
from w3d_torch.voxel import collide as VC, grid as VG
from w3d_torch.city import objects as CO, people as CPE, tunnels as CTN
from w3d_torch.veg import animals as VA, grass as VGR, trees as VT
from w3d_torch.export import map_view as MV
from w3d_torch import full_world as FW
from w3d_torch.water import clouds as WC, precip as WP, snow as WSN
from w3d_torch.export import textures as TX, texture_catalog as TC
from w3d_torch.veg import scenery as VS
from w3d_torch.scene import animation as SA


def _snow_map_file(device=None):
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "snow.npz")
        WSN.save_snow_map(path, np.zeros((4, 4), np.float32), np.zeros((4, 4), np.float32))
        return WSN.load_snow_map(path)[0] if device is None else \
            WSN.load_snow_map(path, device=device)[0]


def _scenery_cobjs(device=None):
    """Scenery packed from CPU sets: the table goes to `device`, the card
    unless given."""
    z = torch.zeros(2)
    s = VS.ScenerySet(z, z, z, torch.tensor([VS.S_ROCK, VS.S_STUMP]), z + 0.05, z,
                      torch.ones(2, dtype=torch.bool))
    mesh, w = torch.zeros((4, 4)), WorldConst(mesh_x=4, mesh_y=4)
    parts = (VS.gen_logs(s, mesh, w), VS.gen_plants(s, mesh, w), VS.gen_rocks(s, mesh, w))
    kw = {} if device is None else dict(device=device)
    return VS.scenery_cobjs(s, *parts, **kw).r1


def _pose(device=None):
    sk = SA.make_simple_skeleton(2)
    return SA.evaluate_pose(sk, {}, 0.0) if device is None else \
        SA.evaluate_pose(sk, {}, 0.0, device=device)


def _city_objects():
    z = np.zeros(1, np.float32)
    return CO.objects_to_cobjs(CO.CityObjects(z, z, np.zeros(1, np.int32), z)).r1


def _people_sim():
    interior = CF.gen_interior((0.0, 0.0, 0.0, 4.0, 4.0, 2.4), 3, 0.8, seed=1)
    return CPE.BuildingPeopleSim(interior, 2).people.x


_TINY = FW.WorldSizes(mesh=8, erosion_iters=8, balls=4)


def _generator():
    return torch.Generator(device="cuda" if torch.cuda.is_available() else "cpu")


def _spheres_world():
    pos = torch.zeros((4, 3))
    vel = torch.zeros((4, 3))
    return PM.build_spheres_world(pos, vel).state.px


def _load_scene():
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "cfg.txt")
        with open(path, "w") as f:
            f.write("mesh_size 8 8 4\nnum_dodgeballs 2\ndisable_scenery 1\n")
        return SL.load_scene(path).objects.px


def _run_game():
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "cfg.txt")
        with open(path, "w") as f:
            f.write("mesh_size 8 8 4\nnum_dodgeballs 2\ndisable_scenery 1\n")
        return APP.run_ground(path, 1, 2, game=True, num_smileys=2).objects.px


def _modmap():
    j = ModmapJournal()
    j.add(1, 1, 1, 0.5)
    return j.apply(np.zeros((4, 4), np.float32))


def _tiled_world():
    """A TiledWorld over a city built on the CPU: its building people and
    elevator bank go to the default device."""
    cw = CA.build_city(np.zeros((64, 64), np.float32), num_cities=1, num_cars=4,
                       num_peds=4, seed=1, device="cpu")
    interior = CF.gen_interior((0.0, 0.0, 0.0, 1.2, 0.9, 0.4), 3, 0.08, seed=1)
    objs = CRC.furnish_rooms(interior, 0.08, seed=1)
    return WM.make_tiled_world(None, cw, builders=[(interior, 2, objs)]).city.people.x


def _combat_state():
    """A combat state over the written ship defs: its tables and pools go
    to the default device."""
    with tempfile.TemporaryDirectory() as d:
        defs = USC.parse_ship_defs(write_ship_defs(os.path.join(d, "defs.txt")))
    fleet = USH.fleet_from_defs(defs, lambda n: np.zeros((n, 3), np.float32))[0]
    return UCB.make_combat_state(fleet, UCB.build_combat_tables(defs), pool_size=8).fleet.px


def _run_universe():
    with tempfile.TemporaryDirectory() as d:
        return APP.run_universe(1, 1, ship_defs=os.path.join(d, "none.txt"), chunk=1).fleet.px


def _load_npz():
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "g.npz")
        LM.save_npz(LM.make_light_grid(WorldConst(mesh_x=4, mesh_y=4, mesh_z=2),
                                       device="cpu"), path)
        return LM.load_npz(path).sv


def _voxel_collider():
    """The collider extracts on its device (it keeps host triangles)."""
    vc = VC.VoxelCollider(VG.VoxelParams())
    vc.rebuild(np.ones((4, 9, 9), np.float32))
    return torch.zeros(1, device=vc.device)


def _building_setup():
    interior = CF.gen_interior((0.0, 0.0, 0.0, 1.0, 0.8, 0.3), 1, 0.1, seed=3)
    return LB.building_local_setup(interior, (0.0, 0.0, 0.0, 1.0, 0.8, 0.3), res=8)[3]


_SMALL = WorldConst(mesh_x=4, mesh_y=4, mesh_z=2)

MAKERS = {
    "spawn": lambda: PM.spawn(4, _generator())[0],
    "build_spheres_world": _spheres_world,
    "example_inputs": lambda: TMOD.example_inputs(
        TMOD.TileModelConfig(tile_size=16, erosion_iters_tt=8, erosion_batch=8,
                             erosion_steps=2), WorldConst(), _generator(),
        num_tiles=1)[1],
    "pack_cobjs": lambda: SC.pack_cobjs(PM.spheres_scene()).r1,
    "make_type_table": lambda: PT.make_type_table().radius,
    "gen_sine_table": lambda: N.gen_sine_table(WorldConst()).mag,
    "gen_table_for": lambda: TM.gen_table_for(TM.TerrainConfig(), WorldConst()).mag,
    "droplet_starts": lambda: E.droplet_starts(8, 16, 16)[0],
    "draw_angles": lambda: E.draw_angles(8, 8, 2, _generator()),
    "make_ripples": lambda: WR.make_ripples(4, 4).rval,
    "make_player": lambda: PL.make_player().x,
    "empty_cobjs": lambda: PC.empty_cobjs(4).r1,
    "load_scene": _load_scene,
    "make_light_grid": lambda: LM.make_light_grid(WorldConst(mesh_x=4, mesh_y=4,
                                                             mesh_z=2)).smoke,
    "build_platforms": lambda: PP.build_platforms([SC.PlatformSpec()]).fspeed,
    "make_triggers": lambda: PP.make_triggers([0.0], [0.0], [0.0], [1.0], [0]).x,
    "ModmapJournal.apply": _modmap,
    "make_ai_smileys": lambda: AI.make_ai_smileys([0.0], [0.0], [0]).x,
    "make_smileys": lambda: GG.make_smileys([0.0], [0.0], [0]).x,
    "make_weapon_states": lambda: GG.make_weapon_states(2).ammo,
    "make_scores": lambda: GG.make_scores(2).score,
    "make_destroy_state": lambda: PD.make_destroy_state(PC.empty_cobjs(4)).levels,
    "make_surface_damage": lambda: PD.make_surface_damage(4, 4).damage,
    "make_bubbles": lambda: PPT.make_bubbles(4).px,
    "make_clouds": lambda: PPT.make_clouds(4).px,
    "make_fires": lambda: PPT.make_fires(4).px,
    "make_decals": lambda: PPT.make_decals(4).px,
    "make_teleporters": lambda: TP.make_teleporters([[0, 0, 0, 1, 1, 1, 1, 0]]).sx,
    "make_paint_grid": lambda: SP.make_paint_grid(WorldConst(mesh_x=4, mesh_y=4)),
    "run_ground(game=True)": _run_game,
    "run_tiled": lambda: APP.run_tiled(1, 1, chunk=1).cars.t,
    "make_tiled_world": _tiled_world,
    "TileManager": lambda: TL.TileManager(tile_size=16).table.mag,
    "build_city": lambda: CA.build_city(np.zeros((64, 64), np.float32), num_cities=1,
                                        num_cars=4, num_peds=4).cars.t,
    "make_elevator_bank": lambda: CCS.make_elevator_bank(2).z,
    "run_universe": _run_universe,
    "gen_asteroid_field": lambda: UA.gen_asteroid_field(
        UA.draw_asteroid_field(4, torch.Generator()), 10.0).px,
    "gen_planet_surface": lambda: USF.gen_planet_surface(1, 4, 8)[0],
    "gen_sine_table_3d": lambda: ON.gen_sine_table_3d().mag,
    "make_fleet": lambda: USH.make_fleet(USH.draw_fleet(4, torch.Generator())).px,
    "make_player_ship": lambda: USH.make_player_ship().px,
    "make_claims": lambda: USH.make_claims(2).owner,
    "make_combat_state": _combat_state,
    "make_voxel_grid": lambda: VG.make_voxel_grid(
        VG.VoxelParams(xsize=8, ysize=8, zsize=4), WorldConst()).values,
    "create_procedural": lambda: VG.create_procedural(
        VG.VoxelParams(xsize=4, ysize=4, zsize=4), (0.0, 0.0, 0.0), (1.0, 1.0, 1.0)),
    "VoxelCollider": _voxel_collider,
    "TraceDraws": lambda: LT.TraceDraws(1).rays(6, 0, (4,)),
    "sky_rays": lambda: LT.sky_rays(LT.DrawSource()(1, 2), 4, WorldConst())[0],
    "record_platform_rays": lambda: LA.record_platform_rays(
        LT.TraceDraws(0), 8, (-9.0, -9.0, -9.0), (9.0, 9.0, 9.0)).ox,
    "pack_dlights": lambda: LD.pack_dlights([]).x,
    "load_npz": _load_npz,
    "BuildingIndirManager": lambda: LB.BuildingIndirManager(world=_SMALL).composite().lc_r,
    "building_local_setup": _building_setup,
    "gen_terrain": lambda: TM.gen_terrain(
        TM.TerrainConfig(mode=N.MGEN_SIMPLEX),
        WorldConst(mesh_x=8, mesh_y=8)).mesh_height,
    "pack_tunnels": lambda: CTN.pack_tunnels([]).get("x1"),
    "tunnels_to_cobjs": lambda: CTN.tunnels_to_cobjs(
        [CTN.TunnelSeg((0.0, 0.0, 0.0), (1.0, 0.0, 0.0), 0.1, 0)]).r1,
    "objects_to_cobjs": _city_objects,
    "BuildingPeopleSim": _people_sim,
    "draw_trees": lambda: VT.draw_trees(2, torch.Generator()).height,
    "draw_small_trees": lambda: VT.draw_small_trees(2, torch.Generator()).height,
    "make_ground_fire": lambda: VGR.make_ground_fire(np.zeros((4, 4))).fuel,
    "mandelbrot": lambda: MV.mandelbrot(0.0, 0.0, 1.0, n=4, max_iter=2),
    "draw_building_animals": lambda: VA.draw_building_animals(
        1, 2, 2, 2, torch.Generator()).spider_turn,
    "full_world.terrain_section": lambda: FW.terrain_section(
        _TINY, FW.WorldDraws(), WorldConst(mesh_x=8, mesh_y=8))[0].mesh_height,
    "full_world.physics_section": lambda: FW.physics_section(
        _TINY, FW.WorldDraws(), WorldConst(mesh_x=8, mesh_y=8))[0].state.px,
    "draw_precip": lambda: WP.draw_precip(4, torch.Generator()).x,
    "draw_snow": lambda: WSN.draw_snow(4, torch.Generator()).na,
    "load_snow_map": _snow_map_file,
    "cloud_layer": lambda: WC.cloud_layer(0.0, 0.1, 0.1, 4, 4),
    "cloud_texture": lambda: TX.cloud_texture(4),
    "marble_texture": lambda: TX.marble_texture(4),
    "plasma_texture": lambda: TX.plasma_texture(4),
    "noise_texture": lambda: TX.noise_texture(4),
    "texture_catalog.fbm_ramp": lambda: TC.fbm_ramp(4, (0.0, 0.0, 0.0), (1.0, 1.0, 1.0)),
    "rock_field": lambda: VS.rock_field(1, 4),
    "scenery_cobjs": _scenery_cobjs,
    "evaluate_pose": _pose,
}

# the same functions asked for the CPU
ON_CPU = {
    "draw_precip": lambda: WP.draw_precip(4, torch.Generator(), device="cpu").x,
    "draw_snow": lambda: WSN.draw_snow(4, torch.Generator(), device="cpu").na,
    "load_snow_map": lambda: _snow_map_file("cpu"),
    "cloud_layer": lambda: WC.cloud_layer(0.0, 0.1, 0.1, 4, 4, device="cpu"),
    "cloud_texture": lambda: TX.cloud_texture(4, device="cpu"),
    "marble_texture": lambda: TX.marble_texture(4, device="cpu"),
    "plasma_texture": lambda: TX.plasma_texture(4, device="cpu"),
    "noise_texture": lambda: TX.noise_texture(4, device="cpu"),
    "texture_catalog.fbm_ramp": lambda: TC.fbm_ramp(4, (0.0, 0.0, 0.0), (1.0, 1.0, 1.0),
                                                    device="cpu"),
    "rock_field": lambda: VS.rock_field(1, 4, device="cpu"),
    "scenery_cobjs": lambda: _scenery_cobjs("cpu"),
    "evaluate_pose": lambda: _pose("cpu"),
}


@pytest.mark.parametrize("name", sorted(MAKERS))
def test_defaults_to_the_card(name):
    make = MAKERS[name]
    if torch.cuda.is_available():
        assert make().device.type == "cuda"
    else:
        with pytest.raises((AssertionError, RuntimeError), match="(?i)cuda"):
            make()


@pytest.mark.parametrize("name", sorted(ON_CPU))
def test_runs_on_the_cpu_when_asked(name):
    assert ON_CPU[name]().device.type == "cpu"

"""Carry state from the JAX package into the port.

The functions here take the JAX package's values after the caller has
turned their arrays into numpy (e.g. `jax.tree.map(np.asarray, value)`),
read them by field name, and build the port's tensors on a device, so both
packages can compute on the same inputs.  Nothing here imports jax.
`ground_scene` carries a whole loaded scene: its host specs (config,
scene parse, sphere materials) become the port's dataclasses of the same
names.  The gameplay states (smileys, weapons, scores), the destroy and
particle states, group specs, teleporters and waypoint graphs carry
across field by field, and so do the tiled mode's values: the city state
(without the JAX key, whose draws are the port's `CityDraws`), the road
graph, the pedestrian nav, building people, animals, butterflies and
tiles; and the universe's: fleets, combat tables, projectile pools and
combat states, asteroid fields, the player ship, planet claims and 3-D
sine tables; and the lighting and voxel values: light grids, dlights,
recorded platform rays and voxel grids.  `to_numpy` goes the other way,
for comparisons and round trips; it needs neither jax nor the JAX
package.

JAX keeps per-object and per-type flags as uint32; the port keeps them as
int32 bit masks (every flag bit fits).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .ops.noise import SineTable, SineTable3D
from .physics.cobjs import CobjSet, GroupedCobjs
from .physics.step import ObjectState, PhysicsEnv
from .physics.types import ObjTypeTable
from .models.physics_model import SpheresWorld
from .water.ripples import RippleState
from .gameplay.player import PlayerState
from .terrain.mesh import TerrainState
from .physics.platforms import PlatformSet, TriggerSet
from .veg.scenery import ScenerySet
from .lighting.lmap import LightGrid
from .lighting.dlights import DLights
from .lighting.accum import AccumRays
from .voxel.grid import VoxelGrid
from .physics.destroy import DestroyState, SurfaceDamage
from .physics.groups import GroupSpec
from .physics.particles import BubblePool, CloudPool, FirePool, DecalPool
from .gameplay.ai import SmileyAI
from .gameplay.game import SmileyState, WeaponState, GameScore
from .gameplay.teleport import Teleporters
from .gameplay.waypoints import WaypointGraph
from .scene import cobj as SC, sphere_materials as SM
from .scene.loader import GroundScene
from .city import traffic as CT, people as CPE, city_step as CCS
from .terrain.tiles import Tile
from .veg.animals import AnimalState, ButterflyState
from .utils import config as CFG
from .utils.constants import WorldConst
from .universe.ships import FleetState, PlayerShip, PlanetClaims
from .universe.combat import CombatTables, ProjPool, CombatState
from .universe.asteroids import AsteroidField

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


def light_grid(src, device) -> LightGrid:
    return _named(LightGrid, src, device)


def platform_set(src, device) -> PlatformSet:
    return _named(PlatformSet, src, device)


def trigger_set(src, device) -> TriggerSet:
    return _named(TriggerSet, src, device)


def scenery_set(src, device) -> ScenerySet:
    return _named(ScenerySet, src, device)


def smiley_ai(src, device) -> SmileyAI:
    return _named(SmileyAI, src, device)


def smiley_state(src, device) -> SmileyState:
    return _named(SmileyState, src, device)


def weapon_state(src, device) -> WeaponState:
    return _named(WeaponState, src, device)


def game_score(src, device) -> GameScore:
    return _named(GameScore, src, device)


def destroy_state(src, device) -> DestroyState:
    return _named(DestroyState, src, device)


def surface_damage(src, device) -> SurfaceDamage:
    return _named(SurfaceDamage, src, device)


def bubble_pool(src, device) -> BubblePool:
    return _named(BubblePool, src, device)


def cloud_pool(src, device) -> CloudPool:
    return _named(CloudPool, src, device)


def fire_pool(src, device) -> FirePool:
    return _named(FirePool, src, device)


def decal_pool(src, device) -> DecalPool:
    return _named(DecalPool, src, device)


def teleporters(src, device) -> Teleporters:
    return _named(Teleporters, src, device)


def group_spec(src) -> GroupSpec:
    """A GroupSpec (host values: type id, capacity, rate)."""
    return GroupSpec(int(src.otype), int(src.capacity), float(src.app_rate))


def waypoint_graph(src) -> WaypointGraph:
    """A WaypointGraph (host numpy arrays, as in the JAX package)."""
    return WaypointGraph(*(np.asarray(getattr(src, f)).copy() for f in WaypointGraph._fields))


_SPEC_MODULES = (SC, SM, CFG)   # where the host dataclasses' port twins live


def host_spec(src):
    """A host-side spec value (a dataclass of the scene parser, the sphere
    materials or the config, nested in lists, tuples and dicts) -> the
    same value built from the port's dataclasses of the same names."""
    if dataclasses.is_dataclass(src) and not isinstance(src, type):
        name = type(src).__name__
        cls = next(getattr(m, name) for m in _SPEC_MODULES if hasattr(m, name))
        return cls(**{f.name: host_spec(getattr(src, f.name))
                      for f in dataclasses.fields(src)})
    if isinstance(src, (list, tuple)):
        return type(src)(host_spec(v) for v in src)
    if isinstance(src, dict):
        return {k: host_spec(v) for k, v in src.items()}
    return src


def voxel_grid(src, device) -> VoxelGrid:
    """A VoxelGrid (its density tensor; the geometry tuples as floats)."""
    return VoxelGrid(values=array(src.values, device),
                     lo_pos=tuple(float(v) for v in src.lo_pos),
                     vsz=tuple(float(v) for v in src.vsz))


def dlights(src, device) -> DLights:
    return _named(DLights, src, device)


def accum_rays(src, device) -> AccumRays:
    """A recorded platform ray set (its integer seed kept)."""
    return AccumRays(**{f: array(getattr(src, f), device) for f in AccumRays._fields
                        if f != "seed"}, seed=int(src.seed))


def ground_scene(src, device) -> GroundScene:
    """A loaded GroundScene, its arrays as numpy: tensors on `device`,
    host specs as the port's dataclasses, the trees as numpy, a voxel
    landscape's grid as a VoxelGrid."""
    opt = lambda f, v: None if v is None else f(v, device)
    w = src.world
    return GroundScene(
        cfg=host_spec(src.cfg),
        world=WorldConst(mesh_x=w.mesh_x, mesh_y=w.mesh_y, mesh_z=w.mesh_z,
                         x_scene=w.x_scene, y_scene=w.y_scene, z_scene=w.z_scene),
        terrain=terrain_state(src.terrain, device),
        cobjs=cobj_set(src.cobjs, device), table=type_table(src.table, device),
        objects=object_state(src.objects, device),
        env=physics_env(src.env, device),
        ripples=ripple_state(src.ripples, device),
        light_grid=opt(light_grid, src.light_grid),
        sphere_mats=host_spec(src.sphere_mats), mat_first=src.mat_first,
        parse=host_spec(src.parse),
        platforms=opt(platform_set, src.platforms),
        triggers=opt(trigger_set, src.triggers),
        smoke_active=src.smoke_active, voxel=opt(voxel_grid, src.voxel),
        trees=None if src.trees is None else tuple(np.asarray(a) for a in src.trees),
        scenery=opt(scenery_set, src.scenery))


def road_graph(src, device) -> CT.RoadGraph:
    return _named(CT.RoadGraph, src, device)


def ped_nav(src, device) -> CT.PedNav:
    return _named(CT.PedNav, src, device)


def people_state(src, device) -> CPE.PeopleState:
    return _named(CPE.PeopleState, src, device)


def animal_state(src, device) -> AnimalState:
    return _named(AnimalState, src, device)


def butterfly_state(src, device) -> ButterflyState:
    return _named(ButterflyState, src, device)


def tile(src, device) -> Tile:
    """A resident Tile (its key and its four arrays)."""
    return Tile(tx=int(src.tx), ty=int(src.ty), zvals=array(src.zvals, device),
                ao=array(src.ao, device), smask_sun=array(src.smask_sun, device),
                weights=array(src.weights, device))


def city_state(src, device) -> CCS.CityState:
    """A CityState (the JAX one's threefry `key` is dropped: the port takes
    the draws as `CityDraws`); helicopters, birds, trains and people may
    be None."""
    opt = lambda cls, v: None if v is None else _named(cls, v, device)
    return CCS.CityState(
        stoplights=_named(CT.StoplightSet, src.stoplights, device),
        cars=_named(CT.CarState, src.cars, device),
        peds=_named(CT.PedState, src.peds, device),
        people=opt(CPE.PeopleState, src.people),
        elev=_named(CCS.ElevatorBank, src.elev, device),
        helis=opt(CT.HeliState, src.helis), birds=opt(CT.BirdState, src.birds),
        trains=opt(CT.TrainState, src.trains))


def sine_table_3d(src, device) -> SineTable3D:
    return _named(SineTable3D, src, device)


def fleet_state(src, device) -> FleetState:
    """A FleetState; its optional fields stay None where the source's
    are."""
    return FleetState(**{f: None if getattr(src, f) is None
                         else array(getattr(src, f), device, f) for f in FleetState._fields})


def combat_tables(src, device) -> CombatTables:
    return _named(CombatTables, src, device)


def proj_pool(src, device) -> ProjPool:
    return _named(ProjPool, src, device)


def combat_state(src, device) -> CombatState:
    return CombatState(fleet=fleet_state(src.fleet, device), proj=proj_pool(src.proj, device),
                       **{f: array(getattr(src, f), device, f)
                          for f in ("cool", "ammo", "crew", "captured")})


def asteroid_field(src, device) -> AsteroidField:
    return _named(AsteroidField, src, device)


def player_ship(src, device) -> PlayerShip:
    return _named(PlayerShip, src, device)


def planet_claims(src, device) -> PlanetClaims:
    return _named(PlanetClaims, src, device)


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
    if isinstance(value, dict):
        return {k: to_numpy(v) for k, v in value.items()}
    if isinstance(value, Tile):
        return Tile(value.tx, value.ty, *(to_numpy(getattr(value, f))
                                          for f in ("zvals", "ao", "smask_sun", "weights")))
    return value


"""Object type table + physics constants (port of
`3dworld_tpu/physics/types.py`).

Transcribes the reference's ~50-entry `obj_type` parameter table
(`init_objects`, Physics.cpp:95-585) into SoA arrays: per-type radius,
gravity factor, elasticity, friction, air drag, density, lifetime, health,
damage, flags.  Derived quantities follow Physics.cpp:571-585:
terminal_vel = 1/air_factor, mass = 150000*density*volume (sphere),
lifetime scaled by 0.01/TIMESTEP; per-type overrides afterwards.

Per-object `status` and `flags` are int32 tensors; the flags are bit
masks (the JAX package keeps them as uint32, which torch lacks).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

# 3DWorld.h:49-90
LARGE_OBJ_RAD = 0.01
DEF_TIMESTEP = 0.007
GRAVITY = 300.0
STICK_THRESHOLD = 1.0
RAIN_MIN_TEMP = 2.0
SNOW_MAX_TEMP = -2.0
WATER_MAX_TEMP = 100.0
W_FREEZE_POINT = -0.1
CAMERA_RADIUS = 0.06
WATER_DENSITY = 1.0

# Physics.cpp:10-27
MIN_BOUNCE_VEL = 2.0
BOUNCE_CUTOFF = MIN_BOUNCE_VEL * MIN_BOUNCE_VEL
WATER_SURF_FRICTION = 0.95
ICE_BOUNCE_ELAS = 0.4
ICE_ELASTICITY = 0.95
WATER_ELASTIC = 0.6
LAND_ELASTICITY = 0.8
WATER_DAMPING = 0.1
CRITICAL_ANGLE = 0.5
MAX_SPLASH_DEPTH = 0.1  # 3DWorld.h:52
# surface rolling (surface_advance, Physics.cpp:10-15,980-1037)
KILL_DEPTH = 12.0
RECOVER_DEPTH = 1.0
SURF_ADV_STEP = 2.0

# Object type enum (3DWorld.h:1369-1375)
_TYPE_NAMES = (
    "RAIN SNOW HAIL LEAF BALL S_BALL SMILEY BLOOD CHARRED CHUNK "
    "SFPART ROCKET LANDMINE SEEK_D STAR5 PLASMA GRENADE CGRENADE SHRAPNEL SHELLC "
    "PROJC DROPLET WDROPLET SAND DIRT ROCK FRAGMENT PARTICLE HEALTH SHIELD "
    "POWERUP WEAPON AMMO WA_PACK CAMERA PRECIP BLAST_RADIUS PROJECTILE BEAM IMPACT "
    "PLASMA_LT_D LASER DROWNED BURNED FIRE FELL FROZEN SUFFOCATED CRUSHED GASSED "
    "WAYPOINT SMOKE DYNAM_PART SKULL GRASS TELEFRAG SAWBLADE MAT_SPHERE COLLISION RAPT_PROJ "
    "FREEZE_BOMB XLOCATOR XLOCATOR_DEATH JUMP_PAD TELEPORTER KEYCARD"
).split()
NUM_TOT_OBJS = len(_TYPE_NAMES)
globals().update({n: i for i, n in enumerate(_TYPE_NAMES)})

# Object flags (subset used by physics; physics_objects.h / 3DWorld.h)
OBJ_FLAG_EXPL = 1 << 0        # OBJ_EXPLODES
OBJ_FLAG_EXPL_COLL = 1 << 1   # EXPL_ON_COLL
OBJ_FLAG_COLL_DESTROYS = 1 << 2
OBJ_FLAG_IS_DROP = 1 << 3     # OBJ_IS_DROP
OBJ_FLAG_IS_PRECIP = 1 << 4
OBJ_FLAG_ROLLS = 1 << 5       # OBJ_ROLLS
OBJ_FLAG_NO_WATER_DAMAGE = 1 << 6
OBJ_FLAG_IS_FLAT = 1 << 7
OBJ_FLAG_NON_SOLID = 1 << 8
OBJ_FLAG_FALL_EVERYWHERE = 1 << 9
OBJ_FLAG_IS_CYLIN = 1 << 10

# Per-object state flags (3DWorld.h object flags)
FL_COLLIDED = 1 << 0       # OBJ_COLLIDED
FL_STATIC_COBJ_COLL = 1 << 1
FL_Z_STOPPED = 1 << 2
FL_XY_STOPPED = 1 << 3
FL_IN_WATER = 1 << 4
FL_FLOATING = 1 << 5
FL_UNDERWATER = 1 << 6
FL_IS_ON_ICE = 1 << 7
FL_ALL_COLL_STOPPED = FL_STATIC_COBJ_COLL | FL_Z_STOPPED | FL_XY_STOPPED


class ObjTypeTable(NamedTuple):
    """SoA per-type physics parameters, indexable by object type id."""

    radius: torch.Tensor
    air_factor: torch.Tensor
    friction: torch.Tensor
    gravity: torch.Tensor
    elasticity: torch.Tensor
    density: torch.Tensor
    terminal_vel: torch.Tensor
    mass: torch.Tensor
    lifetime: torch.Tensor
    health: torch.Tensor
    damage: torch.Tensor
    flags: torch.Tensor
    min_t: torch.Tensor
    max_t: torch.Tensor


# (air_factor, friction, gravity, elasticity, density, radius, lifetime,
#  health, damage, flags, min_t, max_t) — defaults: air 0.001, friction 0,
#  gravity 1, elasticity 0, density 1, radius 0.001, min_t -100, max_t 200
# (Physics.cpp:86-98); entries cited by type name from init_objects.
_D = dict  # noqa: E741
_TABLE = {
    "RAIN":     _D(air=0.2, fric=0.005, rad=0.0035, life="50+40*Z", dens=1.0, hp=5.0,
                   flags=OBJ_FLAG_IS_DROP | OBJ_FLAG_IS_PRECIP | OBJ_FLAG_FALL_EVERYWHERE,
                   min_t=RAIN_MIN_TEMP, max_t=WATER_MAX_TEMP),
    "SNOW":     _D(air=0.4, fric=3.0, rad=0.002, life="150+70*Z", dens=0.2, hp=10.0,
                   flags=OBJ_FLAG_IS_DROP | OBJ_FLAG_IS_PRECIP | OBJ_FLAG_FALL_EVERYWHERE,
                   min_t=-1000, max_t=SNOW_MAX_TEMP),
    "HAIL":     _D(air=0.175, fric=0.1, rad=0.0045, life="100+50*Z", dens=0.8, elas=0.8,
                   hp=30.0, flags=OBJ_FLAG_IS_PRECIP | OBJ_FLAG_FALL_EVERYWHERE,
                   min_t=SNOW_MAX_TEMP, max_t=RAIN_MIN_TEMP),
    "LEAF":     _D(air=0.5, fric=0.9, grav=0.01, rad=0.005, life=1200, dens=0.3, hp=4000.0,
                   flags=OBJ_FLAG_NO_WATER_DAMAGE | OBJ_FLAG_IS_FLAT),
    "BALL":     _D(air=0.05, fric=0.02, grav=0.3, rad=0.042, dam=2200.0, life=1600,
                   dens=0.7, elas=0.92, hp=20000.0, flags=OBJ_FLAG_ROLLS),
    "S_BALL":   _D(air=0.035, fric=0.02, rad=0.015, dam=8.0, life=210, dens=0.4,
                   elas=0.9, hp=10000.0),
    "SMILEY":   _D(air=0.005, fric=0.001, grav=0.4, rad=CAMERA_RADIUS, dam=50.0,
                   life=1000000, dens=1.2, elas=0.4, hp=100.0, min_t=-50.0, max_t=100.0),
    "BLOOD":    _D(air=0.15, fric=0.01, rad=0.004, life="90+10*Z", dens=1.0, hp=15.0,
                   flags=OBJ_FLAG_IS_DROP, max_t=WATER_MAX_TEMP),
    "CHARRED":  _D(air=0.2, fric=0.1, rad=0.003, life=240, dens=0.9, elas=0.5, hp=20.0,
                   max_t=1000),
    "CHUNK":    _D(air=0.08, fric=1.2, grav=0.6, rad=0.011, life=500, dens=1.2, elas=0.9,
                   hp=250.0),
    "SFPART":   _D(air=0.1, fric=0.06, rad=CAMERA_RADIUS / 6.0, life=1000, dens=0.5,
                   elas=0.9, hp=200.0),
    "ROCKET":   _D(air=0.02, fric=0.5, grav=0.0, rad=0.022, dam=400.0, life=300,
                   dens=1.3, hp=10.0, tv=0.5,
                   flags=OBJ_FLAG_EXPL | OBJ_FLAG_EXPL_COLL | OBJ_FLAG_COLL_DESTROYS),
    "LANDMINE": _D(air=0.01, fric=3.5, rad=0.03, dam=1200.0, life=1400, dens=2.5,
                   hp=80.0, flags=OBJ_FLAG_EXPL),
    "SEEK_D":   _D(air=0.015, fric=0.5, grav=0.0, rad=0.026, dam=1200.0, life=400,
                   dens=1.4, hp=12.0, tv=0.1,
                   flags=OBJ_FLAG_EXPL | OBJ_FLAG_EXPL_COLL | OBJ_FLAG_COLL_DESTROYS),
    "STAR5":    _D(air=0.1, fric=2.49, grav=0.12, rad=0.005, dam=40.0, life=500,
                   dens=1.8, elas=0.1, hp=600.0, tv=2.5),
    "PLASMA":   _D(air=0.012, fric=1.5, grav=0.04, rad=0.02, dam=250.0, life=700,
                   dens=0.12, elas=0.2, hp=0.1, min_t=-1000, max_t=10000,
                   flags=OBJ_FLAG_EXPL | OBJ_FLAG_EXPL_COLL),
    "GRENADE":  _D(air=0.07, fric=0.35, grav=0.6, rad=0.02, dam=15.0, life=35,
                   dens=1.2, elas=0.6, hp=70.0, flags=OBJ_FLAG_EXPL),
    "CGRENADE": _D(air=0.06, fric=0.45, grav=0.5, rad=0.04, dam=40.0, life=25,
                   dens=1.2, elas=0.6, hp=50.0, flags=OBJ_FLAG_EXPL),
    "SHRAPNEL": _D(air=0.05, fric=2.49, rad=0.003, dam=4.0, life=300, dens=4.0,
                   elas=0.5, hp=1000.0),
    "SHELLC":   _D(air=0.12, fric=0.9, grav=0.5, rad=0.0015, life=400, dens=1.8,
                   elas=0.8, hp=1000.0, flags=OBJ_FLAG_IS_CYLIN),
    "PROJC":    _D(air=0.0, fric=0.0, grav=0.0, rad=0.005, life=1000, dens=1.0, hp=1.0),
    "DROPLET":  _D(air=0.17, fric=0.005, rad=0.0035, life="40+10*Z", dens=1.0, hp=5.0,
                   flags=OBJ_FLAG_IS_DROP | OBJ_FLAG_FALL_EVERYWHERE,
                   min_t=W_FREEZE_POINT, max_t=WATER_MAX_TEMP),
    "WDROPLET": _D(air=0.17, fric=0.005, rad=0.0035, life="50+20*Z", dens=1.0, hp=10.0,
                   flags=OBJ_FLAG_IS_DROP, min_t=W_FREEZE_POINT, max_t=WATER_MAX_TEMP),
    "SAND":     _D(air=0.5, fric=0.3, rad=0.005, life=80, dens=1.5, elas=0.3, hp=300.0),
    "DIRT":     _D(air=0.25, fric=0.8, rad=0.008, life=700, dens=1.1, elas=0.6, hp=400.0),
    "ROCK":     _D(air=0.1, fric=0.9, rad=0.0099, dam=1.0, life=800, dens=1.8, elas=0.5,
                   hp=1000.0),
    "FRAGMENT": _D(air=0.06, fric=0.6, rad=0.0098, dam=1.0, life=400, dens=2.2,
                   elas=0.4, hp=800.0),
    "PARTICLE": _D(air=0.08, fric=0.2, rad=0.005, life=100, dens=1.6, elas=0.6,
                   grav=0.4, hp=1000.0, max_t=1000.0),
    "CAMERA":   _D(air=0.005, fric=0.001, grav=0.4, rad=CAMERA_RADIUS, life=0, dens=1.2,
                   elas=0.4, hp=100.0, min_t=-50.0, max_t=100.0),
    "GASSED":   _D(grav=0.0, rad=0.035, air=0.5, dens=0.01, min_t=-1000, max_t=1000,
                   flags=OBJ_FLAG_NON_SOLID),
    "WAYPOINT": _D(rad=CAMERA_RADIUS),
    "SAWBLADE": _D(air=0.01, fric=0.01, grav=0.01, rad=0.04, dam=100.0, life=400,
                   dens=0.4, elas=2.0, hp=500.0),
    "MAT_SPHERE": _D(air=0.05, fric=0.02, grav=1.0, rad=0.05, life=10000, dens=2.0,
                     elas=0.9, hp=10000.0, flags=OBJ_FLAG_NO_WATER_DAMAGE),
    "RAPT_PROJ": _D(air=0.01, fric=0.5, grav=0.1, rad=0.018, dam=200.0, life=150,
                    dens=0.1, hp=8.0,
                    flags=OBJ_FLAG_EXPL | OBJ_FLAG_EXPL_COLL | OBJ_FLAG_COLL_DESTROYS),
    "XLOCATOR": _D(air=0.02, fric=0.25, grav=1.0, rad=0.02, life=-1, dens=2.0,
                   elas=0.25, hp=100.0, flags=OBJ_FLAG_NO_WATER_DAMAGE),
    "TELEPORTER": _D(air=0.0, fric=0.0, grav=0.1, rad=0.05, life=300, dens=0.1,
                     elas=2.0, hp=10000.0, flags=OBJ_FLAG_NON_SOLID),
    "KEYCARD":  _D(air=0.25, fric=0.2, grav=1.0, rad=0.01, life=-1, dens=0.2,
                   elas=0.25, hp=1.0e10, flags=OBJ_FLAG_NO_WATER_DAMAGE),
    "SKULL":    _D(fric=0.2, rad=0.7 * CAMERA_RADIUS, life=600, dens=1.1, elas=0.75,
                   hp=25.0, flags=OBJ_FLAG_NO_WATER_DAMAGE),
    "FIRE":     _D(fric=2.0, grav=0.2, tv=1.5),
    "DYNAM_PART": _D(elas=1.0),
}
# HEALTH..WA_PACK share one powerup parameter set (Physics.cpp:547-557)
for _n in ("HEALTH", "SHIELD", "POWERUP", "WEAPON", "AMMO", "WA_PACK"):
    _TABLE[_n] = _D(air=0.05, fric=0.9, rad=0.025, life=2400, dens=0.05, elas=0.4,
                    hp=1600.0)
_TABLE["HEALTH"]["dam"] = -500.0
_TABLE["WA_PACK"]["dens"] = 0.5


def make_type_table(z_scene: float = 4.0, timestep: float = DEF_TIMESTEP,
                    device: torch.device | str = "cuda") -> ObjTypeTable:
    n = NUM_TOT_OBJS
    air = np.full(n, 0.001, np.float32)
    fric = np.zeros(n, np.float32)
    grav = np.ones(n, np.float32)
    elas = np.zeros(n, np.float32)
    dens = np.ones(n, np.float32)
    rad = np.full(n, 0.001, np.float32)
    life = np.zeros(n, np.int32)
    hp = np.zeros(n, np.float32)
    dam = np.zeros(n, np.float32)
    flags = np.zeros(n, np.int32)   # bit mask; every flag fits in int32
    min_t = np.full(n, -100.0, np.float32)
    max_t = np.full(n, 200.0, np.float32)
    tv_override = {}

    for name, d in _TABLE.items():
        i = _TYPE_NAMES.index(name)
        air[i] = d.get("air", 0.001)
        fric[i] = d.get("fric", 0.0)
        grav[i] = d.get("grav", 1.0)
        elas[i] = d.get("elas", 0.0)
        dens[i] = d.get("dens", 1.0)
        rad[i] = d.get("rad", 0.001)
        hp[i] = d.get("hp", 0.0)
        dam[i] = d.get("dam", 0.0)
        flags[i] = d.get("flags", 0)
        min_t[i] = d.get("min_t", -100.0)
        max_t[i] = d.get("max_t", 200.0)
        lf = d.get("life", 0)
        if isinstance(lf, str):  # "50+40*Z" forms (Z_SCENE_SIZE-dependent)
            a, b = lf.split("+")
            lf = int(float(a) + float(b.split("*")[0]) * z_scene)
        life[i] = lf
        if "tv" in d:
            tv_override[i] = d["tv"]

    # derived (Physics.cpp:571-585)
    volume = (4.0 / 3.0) * np.pi * rad ** 3
    tv = 1.0 / np.maximum(1e-6, air)
    mass = (150000.0 * dens * volume).astype(np.float32)
    life = np.where(life > 0, (0.01 / timestep) * life, life).astype(np.int32)
    mass[_TYPE_NAMES.index("BALL")] = 1.0
    for i, v in tv_override.items():
        tv[i] = v
    cols = dict(radius=rad, air_factor=air, friction=fric, gravity=grav,
                elasticity=elas, density=dens,
                terminal_vel=tv.astype(np.float32), mass=mass, lifetime=life,
                health=hp, damage=dam, flags=flags, min_t=min_t, max_t=max_t)
    return ObjTypeTable(**{k: torch.as_tensor(v, device=device)
                           for k, v in cols.items()})


def type_id(name: str) -> int:
    return _TYPE_NAMES.index(name)


def extend_table_with_materials(table: ObjTypeTable, mats,
                                timestep: float = DEF_TIMESTEP):
    """Append one type row per sphere material so thrown MAT_SPHEREs get
    per-material physics through the regular type gather: density from
    the material (`get_mat_sphere_density` sphere_materials.cpp:400),
    elasticity from hardness (`cp.elastic = mat.hardness` :280), radius
    scaled by radius_scale.  Returns (extended_table, first_type_id) —
    material i spawns with otype = first_type_id + i.  The new rows are
    built on the host and land on the table's device."""
    base = type_id("MAT_SPHERE")
    first = int(table.radius.shape[0])
    m = len(mats)

    def ext(col, vals=None):
        a = col.cpu().numpy()
        add = np.full(m, a[base], a.dtype) if vals is None \
            else np.asarray(vals, a.dtype)
        return torch.cat([col, torch.as_tensor(add, device=col.device)])

    rad = np.array([table.radius.cpu().numpy()[base] * mt.radius_scale
                    for mt in mats], np.float32)
    dens = np.array([mt.density for mt in mats], np.float32)
    elas = np.array([mt.hardness for mt in mats], np.float32)
    mass = (150000.0 * dens * (4.0 / 3.0) * np.pi * rad ** 3)
    return table._replace(
        radius=ext(table.radius, rad),
        air_factor=ext(table.air_factor),
        friction=ext(table.friction),
        gravity=ext(table.gravity),
        elasticity=ext(table.elasticity, elas),
        density=ext(table.density, dens),
        terminal_vel=ext(table.terminal_vel),
        mass=ext(table.mass, mass.astype(np.float32)),
        lifetime=ext(table.lifetime),
        health=ext(table.health),
        damage=ext(table.damage),
        flags=ext(table.flags),
        min_t=ext(table.min_t),
        max_t=ext(table.max_t)), first

"""The glue of the physics substep and frame: CUDA kernels
`csrc/substep_glue.cu`, one launch a phase in place of its tens of
elementwise PyTorch ops.

A substep is `advance` (air, gravity, wind, drag, the move), B,
`contact` (outside and on the mesh, water and ice), C, `respond` (cobj
response, water tail, mesh bounce, rolling), and on a pair substep D and
`apply_pairs`; a frame adds `take_rows` (the x sort's gather) and
`age_objects`.  Each wrapper takes the phase's plain PyTorch version in
`physics/step` for CPU tensors and the kernel for CUDA tensors, and
returns what the plain version returns, bit for bit; the carries'
tensors are rows of a few stacked buffers.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import build
from ...physics import types as T
from ...utils.constants import WorldConst

_F32 = ("tstep", "dx_inv", "dy_inv", "dx", "dy",
        "surf_air", "stick2", "stick", "gravity", "water_density", "freeze",
        "bounce_cutoff", "water_damping", "critical_angle", "splash",
        "water_elastic", "ice_elasticity", "ice_bounce_elas", "land_elasticity",
        "kill_depth", "recover_depth", "roll_step", "inv_dt", "large_rad")
_I32 = ("wmx", "wmy", "fl_collided", "fl_static_coll", "fl_z_stopped",
        "fl_xy_stopped", "fl_in_water", "fl_floating", "fl_underwater", "fl_on_ice")


def _struct(name: str, fields) -> type:
    return type(name, (ctypes.Structure,), {"_fields_": list(fields)})


def _ptrs(*names: str) -> list:
    return [(n, ctypes.c_void_p) for n in names]


# the C structs of csrc/substep_glue.cu, field for field
Consts = _struct("Consts", [(f, ctypes.c_float) for f in _F32]
                 + [(f, ctypes.c_int) for f in _I32])
TypeCols = _struct("TypeCols", _ptrs("rad", "air", "fric", "grav", "elas", "dens",
                                     "tv", "mass"))
Env = _struct("Env", _ptrs("gravity", "wind", "water_z", "temperature"))
Rows = _struct("Rows", _ptrs("px", "py", "pz", "vx", "vy", "vz", "status", "flags",
                             "otype"))
# physics/step.Moved's and Carry's fields, in their order
MOVED = ("px", "py", "pz", "vx", "vy", "vz", "status", "flags", "rad", "air_eff",
         "vz_old", "alive", "moving", "grounded", "z_stop", "xy_stop", "underwater",
         "in_water")
Moved = _struct("Moved", _ptrs(*MOVED))
Surface = _struct("Surface", _ptrs("mh", "mnx", "mny", "mnz", "wh"))
CARRY = ("px", "py", "pz", "vx", "vy", "vz", "status", "flags", "rad", "mh", "mnx",
         "mny", "mnz", "alive", "moving", "grounded", "xy_stop", "in_water",
         "off_mesh", "on_mesh", "touches_water", "wcoll", "ice_touch")
Carry = _struct("Carry", _ptrs(*CARRY))
Hits = _struct("Hits", _ptrs("hit", "pen", "nx", "ny", "nz", "elas", "fric"))
Columns = _struct("Columns", [("c", ctypes.c_void_p * 11)])

_P, _I = ctypes.c_void_p, ctypes.c_int
ADVANCE = build.Kernel("w3d_glue_advance", [Consts, TypeCols, Env, Rows, _P, _P, _P, _I])
CONTACT = build.Kernel("w3d_glue_contact",
                       [Consts, TypeCols, Env, Moved, Surface, _P, _P, _P, _P, _I, _I])
RESPOND = build.Kernel("w3d_glue_respond",
                       [Consts, TypeCols, Carry, Hits, _P, _P, _P, _P, _P, _I, _I, _I])
APPLY_PAIRS = build.Kernel("w3d_glue_apply_pairs", [Carry] + [_P] * 10 + [_I])
TAKE_ROWS = build.Kernel("w3d_glue_take_rows", [Columns, _P, _P, _I])
AGE = build.Kernel("w3d_glue_age", [_P] * 5 + [_I])
KERNELS = (ADVANCE, CONTACT, RESPOND, APPLY_PAIRS, TAKE_ROWS, AGE)
# each kernel under the name of its wrapper and plain phase
BY_NAME = dict(zip(("advance", "contact", "respond", "apply_pairs", "take_rows",
                    "age_objects"), KERNELS))

_XYZ = ("px", "py", "pz", "vx", "vy", "vz")
_MOVED_F32 = _XYZ + ("rad", "air_eff", "vz_old")   # `advance`'s float rows
_MOVED_MASKS = MOVED[11:]
_CONTACT_MASKS = ("off_mesh", "on_mesh", "touches_water", "wcoll", "ice_touch")


@functools.lru_cache(maxsize=16)
def consts(tstep: float, world: WorldConst) -> Consts:
    """The kernels' scalars: each the double the plain code hands PyTorch,
    rounded once to float32 (ctypes rounds to nearest); `inv_dt` is what
    PyTorch's CUDA division by the Python float DEF_TIMESTEP multiplies
    by: the reciprocal taken in double, then rounded."""
    return Consts(
        tstep=tstep, dx_inv=world.dx_inv, dy_inv=world.dy_inv, dx=world.dx, dy=world.dy,
        surf_air=1.0 - T.WATER_SURF_FRICTION, stick2=2.0 * T.STICK_THRESHOLD,
        stick=T.STICK_THRESHOLD, gravity=T.GRAVITY, water_density=T.WATER_DENSITY,
        freeze=T.W_FREEZE_POINT, bounce_cutoff=T.BOUNCE_CUTOFF,
        water_damping=T.WATER_DAMPING, critical_angle=T.CRITICAL_ANGLE,
        splash=T.MAX_SPLASH_DEPTH, water_elastic=T.WATER_ELASTIC,
        ice_elasticity=T.ICE_ELASTICITY, ice_bounce_elas=T.ICE_BOUNCE_ELAS,
        land_elasticity=T.LAND_ELASTICITY, kill_depth=T.KILL_DEPTH,
        recover_depth=T.RECOVER_DEPTH, roll_step=T.SURF_ADV_STEP / world.x_scene,
        inv_dt=1.0 / T.DEF_TIMESTEP,
        large_rad=T.LARGE_OBJ_RAD, wmx=world.mesh_x, wmy=world.mesh_y,
        fl_collided=T.FL_COLLIDED, fl_static_coll=T.FL_STATIC_COBJ_COLL,
        fl_z_stopped=T.FL_Z_STOPPED, fl_xy_stopped=T.FL_XY_STOPPED,
        fl_in_water=T.FL_IN_WATER, fl_floating=T.FL_FLOATING,
        fl_underwater=T.FL_UNDERWATER, fl_on_ice=T.FL_IS_ON_ICE)


def _on(dev: torch.device, name: str, t: torch.Tensor, dtype: torch.dtype,
        numel: int | None = None) -> torch.Tensor:
    """`t` as the kernels read it, contiguous; raises unless it is a `dtype`
    tensor of `numel` elements on `dev`."""
    if t.device != dev:
        raise ValueError(f"{name}: on {t.device}, expected {dev}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if numel is not None and t.numel() != numel:
        raise ValueError(f"{name}: {t.numel()} elements, expected {numel}")
    return t.contiguous()


def _device(t: torch.Tensor, what: str) -> bool:
    """True for a CUDA tensor (take the kernel), False for a CPU one."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {t.device}")
    return True


def _types(table: T.ObjTypeTable, dev: torch.device) -> tuple:
    cols = [_on(dev, f, getattr(table, f), torch.float32)
            for f in ("radius", "air_factor", "friction", "gravity", "elasticity",
                      "density", "terminal_vel", "mass")]
    return cols, TypeCols(*(c.data_ptr() for c in cols))


_DTYPES = {**dict.fromkeys(MOVED + CARRY, torch.float32), "status": torch.int32,
           "flags": torch.int32, "otype": torch.int32,
           **dict.fromkeys(MOVED[11:] + CARRY[13:], torch.bool)}


def _rows_struct(struct, v, names, n: int, dev: torch.device) -> tuple:
    """`struct` of the data pointers of `v`'s fields `names`, with the
    tensors, which the caller keeps until the launch."""
    ts = [_on(dev, f, getattr(v, f), _DTYPES[f], n) for f in names]
    return ts, struct(*(t.data_ptr() for t in ts))


def _env(env, dev: torch.device) -> tuple:
    ts = [_on(dev, "base_gravity", env.base_gravity, torch.float32, 1),
          _on(dev, "wind", env.wind, torch.float32, 3),
          _on(dev, "water_plane_z", env.water_plane_z, torch.float32, 1),
          _on(dev, "temperature", env.temperature, torch.float32, 1)]
    return ts, Env(*(t.data_ptr() for t in ts))


def advance(state, env, table: T.ObjTypeTable, tstep: float, world: WorldConst):
    """`physics/step.advance` (air, gravity, wind, drag, the move): its
    Moved."""
    from ...physics import step as PS
    if not _device(state.px, "advance"):
        return PS.advance(state, env, table, tstep, world)
    dev, n = state.px.device, state.px.shape[0]
    rows, rs = _rows_struct(Rows, state, _XYZ + ("status", "flags", "otype"), n, dev)
    cols, tc = _types(table, dev)
    ets, es = _env(env, dev)
    f = torch.empty((len(_MOVED_F32), n), dtype=torch.float32, device=dev)
    flags = torch.empty(n, dtype=torch.int32, device=dev)
    b = torch.empty((len(_MOVED_MASKS), n), dtype=torch.bool, device=dev)
    ADVANCE.launch(consts(tstep, world), tc, es, rs, f.data_ptr(), flags.data_ptr(),
                   b.data_ptr(), n)
    return PS.Moved(**dict(zip(_MOVED_F32, f)), status=rows[6], flags=flags,
                    **dict(zip(_MOVED_MASKS, b)))


def contact(m, mesh: tuple, wh, otype, env, table: T.ObjTypeTable, tstep: float,
            world: WorldConst, water: bool):
    """`physics/step.contact` (outside and on the mesh, water and ice) from
    B's sample `mesh` and the water map's `wh` (or None): its Carry."""
    from ...physics import step as PS
    if not _device(m.px, "contact"):
        return PS.contact(m, mesh, wh, otype, env, table, tstep, world, water)
    dev, n = m.px.device, m.px.shape[0]
    mts, ms = _rows_struct(Moved, m, MOVED, n, dev)
    sts = [_on(dev, f, t, torch.float32, n) for f, t in zip(("mh", "mnx", "mny", "mnz"), mesh)]
    if water and wh is not None:
        sts.append(_on(dev, "wh", wh, torch.float32, n))
    sf = Surface(*(t.data_ptr() for t in sts))
    otype = _on(dev, "otype", otype, torch.int32, n)
    cols, tc = _types(table, dev)
    ets, es = _env(env, dev)
    f = torch.empty((6, n), dtype=torch.float32, device=dev)
    s = torch.empty((2, n), dtype=torch.int32, device=dev)
    b = torch.empty((len(_CONTACT_MASKS), n), dtype=torch.bool, device=dev)
    CONTACT.launch(consts(tstep, world), tc, es, ms, sf, otype.data_ptr(), f.data_ptr(),
                   s.data_ptr(), b.data_ptr(), n, int(water))
    return PS.Carry(**dict(zip(_XYZ, f)), status=s[0], flags=s[1], rad=m.rad,
                    mh=sts[0], mnx=sts[1], mny=sts[2], mnz=sts[3], alive=m.alive,
                    moving=m.moving, grounded=m.grounded, xy_stop=m.xy_stop,
                    in_water=m.in_water, **dict(zip(_CONTACT_MASKS, b)))


def respond(c, otype, hits, env, table: T.ObjTypeTable, tstep: float,
            world: WorldConst, water: bool, pairs: bool):
    """`physics/step.respond`: (its Carry, None) or, with `pairs`,
    (Carry, (mass, elas, act))."""
    from ...physics import step as PS
    if not _device(c.px, "respond"):
        return PS.respond(c, otype, hits, env, table, tstep, world, water, pairs)
    dev, n = c.px.device, c.px.shape[0]
    cts, cs = _rows_struct(Carry, c, CARRY, n, dev)
    cols, tc = _types(table, dev)
    otype = _on(dev, "otype", otype, torch.int32, n)
    zmin = _on(dev, "zmin", env.zmin, torch.float32, 1)
    hs = Hits()
    if hits is not None:
        hts = [_on(dev, "hit", hits[0], torch.bool, n)]
        hts += [_on(dev, f, t, torch.float32, n)
                for f, t in zip(("pen", "nx", "ny", "nz", "elas", "fric"), hits[1:])]
        hs = Hits(*(t.data_ptr() for t in hts))
    f = torch.empty((8 if pairs else 6, n), dtype=torch.float32, device=dev)
    s = torch.empty((2, n), dtype=torch.int32, device=dev)
    act = torch.empty(n if pairs else 0, dtype=torch.bool, device=dev)
    RESPOND.launch(consts(tstep, world), tc, cs, hs, otype.data_ptr(), zmin.data_ptr(),
                   f.data_ptr(), s.data_ptr(), act.data_ptr(), n, int(water), int(pairs))
    out = c._replace(px=f[0], py=f[1], pz=f[2], vx=f[3], vy=f[4], vz=f[5],
                     status=s[0], flags=s[1])
    return out, ((f[6], f[7], act) if pairs else None)


def apply_pairs(c, act, deltas, env):
    """`physics/step.apply_pairs` (D's deltas, the wake, the kill
    conditions): its Carry."""
    from ...physics import step as PS
    if not _device(c.px, "apply_pairs"):
        return PS.apply_pairs(c, act, deltas, env)
    dev, n = c.px.device, c.px.shape[0]
    cts, cs = _rows_struct(Carry, c, CARRY, n, dev)
    act = _on(dev, "act", act, torch.bool, n)
    ds = [_on(dev, f"delta {k}", d, torch.float32, n) for k, d in enumerate(deltas)]
    if len(ds) != 6:
        raise ValueError(f"apply_pairs: {len(ds)} deltas, expected 6")
    zmin = _on(dev, "zmin", env.zmin, torch.float32, 1)
    f = torch.empty((6, n), dtype=torch.float32, device=dev)
    s = torch.empty(n, dtype=torch.int32, device=dev)
    APPLY_PAIRS.launch(cs, act.data_ptr(), *(d.data_ptr() for d in ds), zmin.data_ptr(),
                       f.data_ptr(), s.data_ptr(), n)
    return c._replace(px=f[0], py=f[1], pz=f[2], vx=f[3], vy=f[4], vz=f[5], status=s)


def take_rows(state, idx: torch.Tensor):
    """`physics/step.take_rows`: every column of `state` at the int64 rows
    `idx`, one launch for all 11."""
    from ...physics import step as PS
    if not _device(state.px, "take_rows"):
        return PS.take_rows(state, idx)
    dev, n = state.px.device, state.px.shape[0]
    cols = [_on(dev, f, t, t.dtype, n) for f, t in zip(state._fields, state)]
    if len(cols) != 11 or any(t.element_size() != 4 for t in cols):
        raise ValueError("take_rows: expected ObjectState's 11 columns of 4-byte values")
    idx = _on(dev, "idx", idx, torch.int64, n)
    out = torch.empty((len(cols), n), dtype=torch.int32, device=dev)
    TAKE_ROWS.launch(Columns((ctypes.c_void_p * 11)(*(t.data_ptr() for t in cols))),
                     idx.data_ptr(), out.data_ptr(), n)
    return type(state)(*(o.view(t.dtype) for o, t in zip(out, cols)))


def age_objects(state, table: T.ObjTypeTable):
    """`physics/step.age_objects` (age + lifetime kill)."""
    from ...physics import step as PS
    if not _device(state.px, "age_objects"):
        return PS.age_objects(state, table)
    dev, n = state.px.device, state.px.shape[0]
    ins = [_on(dev, "otype", state.otype, torch.int32, n),
           _on(dev, "lifetime", table.lifetime, torch.int32),
           _on(dev, "time", state.time, torch.int32, n),
           _on(dev, "status", state.status, torch.int32, n)]
    out = torch.empty((2, n), dtype=torch.int32, device=dev)
    AGE.launch(*(t.data_ptr() for t in ins), out.data_ptr(), n)
    return state._replace(time=out[0], status=out[1])

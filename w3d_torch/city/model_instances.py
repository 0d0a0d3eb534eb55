"""City model instancing: config-driven car/ped/helicopter meshes with
per-agent transform arrays driven by the traffic sim.

The reference loads `city car_model / ped_model / helicopter_model`
config rows into `city_model_t` (city_model.cpp:39-105: filename,
recalc_normals, two_sided, centered, body_material_id, fixed_color_id
[-2 => inline RGBA], xy_rot, swap_xyz, scale, lod_mult, helicopter
blade_mat_id, person anim_speed/is_zombie, keyword args, trailing
shadow_mat_ids), assigns each car a model by seeded draw, and renders
one instanced mesh per model with per-car transforms (cars.cpp,
city_model_loader_t).  Missing model files are NONFATAL — the
reference prints "does not exist; skipping"
(city_building_params.cpp:118,124) — so this layer falls back to a
procedural mesh per kind when a file is absent.

Output: `InstanceSet`s — one mesh + a [N, 4, 4] transform array — the
pure-export equivalent of the reference's instanced draw (north star
decouples rendering behind a mesh/state export).

Port of `3dworld_tpu/city/model_instances.py` (host code, copied): the
traffic states are the port's tensors, read back once per call.  Model
files of every format load through `scene/read_mesh_formats.load_model`;
an unreadable one takes the procedural fallback, like a missing file.
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass, field
from typing import NamedTuple

import numpy as np

from ..scene.model3d import Model3d


@dataclass
class CityModelSpec:
    """One parsed city model row (city_model_t, city_model.h:39)."""

    fn: str = ""
    recalc_normals: int = 1
    two_sided: bool = False
    centered: int = 0            # XYZ bit mask
    body_mat_id: int = -1
    fixed_color_id: int = -1     # -2 => custom_color holds RGBA
    custom_color: tuple = (1.0, 1.0, 1.0, 1.0)
    xy_rot: float = 0.0          # degrees
    swap_xz: bool = False
    swap_yz: bool = True         # default true like city_model_t
    scale: float = 1.0
    lod_mult: float = 1.0
    blade_mat_id: int = -1       # helicopters
    anim_speed: float = 1.0      # people
    is_zombie: bool = False
    rev_winding_mask: int = 0
    mirrored: bool = False
    allow_emissive: bool = False
    shadow_mat_ids: list = field(default_factory=list)
    kind: str = "car"


def _is_number(tok: str) -> bool:
    try:
        float(tok)
        return True
    except ValueError:
        return False


def parse_city_model_tokens(toks, is_helicopter=False, is_person=False,
                            kind="car") -> CityModelSpec:
    """Parse one row's tokens after the `city <kind>_model` prefix —
    same field order as city_model_t::read (city_model.cpp:39-105)."""
    it = iter(toks)
    nx = lambda: next(it)
    m = CityModelSpec(kind=kind)
    m.fn = nx().strip('"')
    m.recalc_normals = int(nx())
    m.two_sided = bool(int(nx()))
    m.centered = int(nx())
    m.body_mat_id = int(nx())
    m.fixed_color_id = int(nx())
    if m.fixed_color_id == -2:
        m.custom_color = (float(nx()), float(nx()), float(nx()), float(nx()))
    m.xy_rot = float(nx())
    swap_xyz = int(nx())
    m.swap_xz = bool(swap_xyz & 2)
    m.swap_yz = bool(swap_xyz & 1)
    m.scale = float(nx())
    m.lod_mult = float(nx())
    if is_helicopter:
        m.blade_mat_id = int(nx())
    if is_person:
        m.anim_speed = float(nx())
        m.is_zombie = bool(int(nx()))
    # keyword args (single `name=value` tokens) then trailing shadow
    # material ids (city_model.cpp:103 read loop)
    for tok in it:
        if "=" in tok:
            name, _, val = tok.partition("=")
            if name == "reverse_winding":
                m.rev_winding_mask = int(val, 0)
            elif name == "mirrored":
                m.mirrored = bool(int(val))
            elif name == "allow_emissive":
                m.allow_emissive = bool(int(val))
            continue   # unknown keywords: nonfatal skip
        if _is_number(tok):
            m.shadow_mat_ids.append(int(tok))
        else:
            break
    return m


_MODEL_KINDS = {"car_model": ("car", False, False),
                "ped_model": ("ped", False, True),
                "helicopter_model": ("helicopter", True, False)}


def parse_city_models(path: str, include_objects: bool = True) -> dict:
    """Scan a config file for `city *_model` rows (the city keyword
    block dispatch, city_building_params.cpp:96-126).  Agent kinds map
    to {car, ped, helicopter}; every OTHER `<name>_model` row (stoves,
    dryers, toilets, ... — the building_obj_model_loader set) lands in
    the `objects` dict keyed by its name.  Returns
    {car: [...], ped: [...], helicopter: [...], objects: {name: [...]}}."""
    out = {"car": [], "ped": [], "helicopter": [], "objects": {}}
    with open(path, "r", errors="replace") as f:
        for line in f:
            line = line.split("#", 1)[0].strip()
            toks = line.split()
            if len(toks) < 3 or toks[0] != "city" or \
                    not toks[1].endswith("_model"):
                continue
            ent = _MODEL_KINDS.get(toks[1])
            try:
                if ent is not None:
                    kind, is_heli, is_person = ent
                    out[kind].append(parse_city_model_tokens(
                        toks[2:], is_heli, is_person, kind))
                elif include_objects:
                    name = toks[1][:-len("_model")]
                    spec = parse_city_model_tokens(toks[2:], False, False,
                                                   name)
                    out["objects"].setdefault(name, []).append(spec)
            except (StopIteration, ValueError):
                continue   # malformed row: nonfatal, like the reference
    return out


# ---------------------------------------------------------------------------
# mesh resolution: real file through the loaders, procedural fallback
# ---------------------------------------------------------------------------

def _box_mesh(hx, hy, hz, z0=0.0):
    v = np.array([[sx * hx, sy * hy, z0 + (sz + 1) * hz * 0.5]
                  for sz in (-1, 1) for sy in (-1, 1) for sx in (-1, 1)],
                 np.float32)
    f = np.array([[0, 1, 3], [0, 3, 2], [4, 7, 5], [4, 6, 7],
                  [0, 5, 1], [0, 4, 5], [2, 3, 7], [2, 7, 6],
                  [0, 2, 6], [0, 6, 4], [1, 5, 7], [1, 7, 3]], np.int32)
    e = np.zeros((0, 3), np.float32)
    ei = np.full((len(f), 3), -1, np.int32)
    return Model3d(positions=v, normals=e, uvs=np.zeros((0, 2), np.float32),
                   faces=f, face_normals=ei, face_uvs=ei)


def _fallback_mesh(kind: str) -> Model3d:
    """Procedural stand-in sized like the reference's nominal agents
    (get_nom_car_size for cars; ped/heli bodies)."""
    from . import traffic as CT
    if kind == "car":
        return _box_mesh(0.5 * CT.CAR_LEN, 0.5 * CT.CAR_WID,
                         CT.CAR_HGT)
    if kind == "ped":
        return _box_mesh(0.02, 0.02, 0.12)
    if kind != "helicopter":       # building object models: unit box
        return _box_mesh(0.05, 0.05, 0.1)
    # helicopter: body box + a thin rotor slab
    body = _box_mesh(0.08, 0.03, 0.05)
    rotor = _box_mesh(0.12, 0.01, 0.005, z0=0.052)
    pos = np.concatenate([body.positions, rotor.positions])
    faces = np.concatenate([body.faces, rotor.faces + len(body.positions)])
    ei = np.full((len(faces), 3), -1, np.int32)
    return Model3d(positions=pos.astype(np.float32),
                   normals=np.zeros((0, 3), np.float32),
                   uvs=np.zeros((0, 2), np.float32),
                   faces=faces.astype(np.int32),
                   face_normals=ei, face_uvs=ei)


_MESH_CACHE: dict = {}


def resolve_mesh(spec: CityModelSpec, base_dir: str = ".") -> Model3d:
    """Load the spec's model through the format loaders with the spec's
    swap/rot/scale transform applied (geom_xform handling in
    read_assimp_model / model3d load); missing or unsupported files get
    the procedural fallback (nonfatal skip, city_building_params.cpp).
    Resolved meshes are cached per (spec identity, base_dir) — the
    reference likewise loads each model once into city_model_loader_t;
    per-frame exports must not re-read files."""
    ck = (spec.fn, spec.kind, spec.xy_rot, spec.swap_xz, spec.swap_yz,
          spec.scale, spec.centered, base_dir)
    hit = _MESH_CACHE.get(ck)
    if hit is not None:
        return hit
    out = _resolve_mesh_uncached(spec, base_dir)
    _MESH_CACHE[ck] = out
    return out


def _resolve_mesh_uncached(spec: CityModelSpec, base_dir: str) -> Model3d:
    path = spec.fn
    if not os.path.isabs(path):
        path = os.path.normpath(os.path.join(base_dir, path))
    mesh = None
    if os.path.exists(path):
        from ..scene.read_mesh_formats import LOAD_ERRORS, load_model
        try:
            mesh = load_model(path)
        except LOAD_ERRORS:
            mesh = None     # unreadable file: nonfatal skip
    if mesh is None:
        mesh = _fallback_mesh(spec.kind)
        return mesh     # fallback is already agent-sized and oriented
    v = np.asarray(mesh.positions, np.float32).copy()
    if spec.swap_yz:
        v = v[:, [0, 2, 1]]
    if spec.swap_xz:
        v = v[:, [2, 1, 0]]
    if spec.xy_rot:
        a = math.radians(spec.xy_rot)
        c, s = math.cos(a), math.sin(a)
        v = v @ np.array([[c, s, 0], [-s, c, 0], [0, 0, 1]], np.float32)
    # normalize footprint to the agent's nominal size, then spec scale
    lo = v.min(0)
    hi = v.max(0)
    ext = np.maximum(hi - lo, 1e-9)
    from . import traffic as CT
    nominal = {"car": CT.CAR_LEN, "ped": 0.24,
               "helicopter": 0.16}.get(spec.kind, 0.2)
    v = v * (spec.scale * nominal / ext.max())
    if spec.centered:
        ctr = 0.5 * (v.min(0) + v.max(0))
        for ax in range(3):
            if spec.centered & (1 << ax):
                v[:, ax] -= ctr[ax]
    return mesh._replace(positions=v)


# ---------------------------------------------------------------------------
# per-frame instance transforms from the sim state
# ---------------------------------------------------------------------------

class InstanceSet(NamedTuple):
    """One mesh + its instances (the export twin of an instanced draw)."""

    kind: str
    model_index: int
    mesh: Model3d
    transforms: np.ndarray      # [N, 4, 4] row-major model->world
    color: tuple | None


def _yaw_transforms(x, y, z, yaw):
    n = len(x)
    t = np.zeros((n, 4, 4), np.float32)
    c = np.cos(yaw)
    s = np.sin(yaw)
    t[:, 0, 0] = c
    t[:, 0, 1] = -s
    t[:, 1, 0] = s
    t[:, 1, 1] = c
    t[:, 2, 2] = 1.0
    t[:, 3, 3] = 1.0
    t[:, 0, 3] = x
    t[:, 1, 3] = y
    t[:, 2, 3] = z
    return t


def _assign_models(n: int, num_models: int, seed: int = 0):
    """Stable per-agent model pick (the reference rolls each car's model
    once at creation, cars.cpp)."""
    h = (np.arange(n, dtype=np.uint64) * np.uint64(2654435761)
         + np.uint64(seed * 40503)) & np.uint64(0xFFFFFFFF)
    return (h % max(num_models, 1)).astype(np.int32)


def city_instances(cars=None, graph=None, peds=None, helis=None,
                   specs: dict | None = None, base_dir: str = ".",
                   ground_z: float = 0.0, seed: int = 0) -> list:
    """Build the frame's InstanceSets from live sim states.

    cars/peds/helis are the traffic module's device states (fetched
    here); `specs` is parse_city_models output (procedural fallbacks
    are used when empty or files are missing)."""
    from . import traffic as CT
    specs = specs or {}
    out = []

    def meshes_for(kind):
        lst = specs.get(kind) or []
        if not lst:
            return [(_fallback_mesh(kind), None, 0)]
        return [(resolve_mesh(sp, base_dir),
                 (sp.custom_color if sp.fixed_color_id == -2 else None), i)
                for i, sp in enumerate(lst)]

    if cars is not None and graph is not None:
        cx, cy, cz, _hx, _hy, hh, heading = (a.cpu().numpy() for a in
                                             CT.car_geometry(cars, graph,
                                                             ground_z))
        models = meshes_for("car")
        pick = _assign_models(len(cx), len(models), seed)
        for (mesh, color, mi) in models:
            sel = pick == mi
            if not sel.any():
                continue
            out.append(InstanceSet(
                kind="car", model_index=mi, mesh=mesh,
                transforms=_yaw_transforms(cx[sel], cy[sel],
                                           cz[sel] - hh[sel],
                                           heading[sel]),
                color=color))
    if peds is not None:
        px = peds.x.cpu().numpy()
        py = peds.y.cpu().numpy()
        gx = peds.gx.cpu().numpy()
        gy = peds.gy.cpu().numpy()
        yaw = np.arctan2(gy - py, gx - px)
        models = meshes_for("ped")
        pick = _assign_models(len(px), len(models), seed + 1)
        for (mesh, color, mi) in models:
            sel = pick == mi
            if not sel.any():
                continue
            out.append(InstanceSet(
                kind="ped", model_index=mi, mesh=mesh,
                transforms=_yaw_transforms(px[sel], py[sel],
                                           np.full(sel.sum(), ground_z,
                                                   np.float32), yaw[sel]),
                color=color))
    if helis is not None:
        hx = helis.px.cpu().numpy()
        hy = helis.py.cpu().numpy()
        hz = helis.pz.cpu().numpy()
        yaw = np.zeros_like(hx)
        models = meshes_for("helicopter")
        pick = _assign_models(len(hx), len(models), seed + 2)
        for (mesh, color, mi) in models:
            sel = pick == mi
            if not sel.any():
                continue
            out.append(InstanceSet(
                kind="helicopter", model_index=mi, mesh=mesh,
                transforms=_yaw_transforms(hx[sel], hy[sel], hz[sel],
                                           yaw[sel]),
                color=color))
    return out


# furniture kind -> object-model name (the OBJ_MODEL_* binding of
# building_obj_model_loader: room objects render as config-driven model
# files; names match the `city <name>_model` rows of config_city.txt)
def _room_model_names():
    from . import room_content as RC
    return {
        RC.F_TOILET: "toilet", RC.F_SINK: "sink", RC.F_TUB: "tub",
        RC.F_FRIDGE: "fridge", RC.F_STOVE: "stove",
        RC.F_COUCH: "couch", RC.F_TV: "tv", RC.F_LAMP: "lamp",
        RC.F_WASHER: "washer", RC.F_DRYER: "dryer",
        RC.F_HANGER: "hanger", RC.F_CLOTHES: "clothing",
        RC.F_HOSPITAL_BED: "hospital_bed",
        RC.F_OPERATING_TABLE: "operating_table",
        RC.F_CURTAIN: "hospital_curtain",
        RC.F_POOL_TABLE: "pool_table",
        RC.F_CEIL_LIGHT: "ceiling_fan",
        RC.F_STOOL: "bar_stool", RC.F_CASH_REG: "cash_register",
        RC.F_FIRE_EXT: "fire_ext", RC.F_PLANT: "plant",
        RC.F_MACHINE: "ex_machine",
    }


def room_object_instances(objs, specs: dict | None = None,
                          base_dir: str = ".", seed: int = 0,
                          offset=(0.0, 0.0, 0.0)) -> list:
    """InstanceSets for furnished room objects whose kinds bind to an
    object model (building_obj_model_loader's OBJ_MODEL_* draw path):
    one set per model name, transforms at each placed object's cube
    with its facing rotation; kinds without a model row (or with no
    parsed specs) keep their cube representation and are skipped here."""
    from . import room_content as RC
    specs = specs or {}
    obj_specs = specs.get("objects", {})
    names = _room_model_names()
    by_name = {}
    for j, kind in enumerate(objs.kinds):
        name = names.get(kind)
        if name is None or name not in obj_specs:
            continue
        by_name.setdefault(name, []).append(j)
    out = []
    rots = {0: 0.0, 1: 0.5 * np.pi, 2: np.pi, 3: 1.5 * np.pi}
    for name, idxs in sorted(by_name.items()):
        sp = obj_specs[name][0]
        mesh = resolve_mesh(sp, base_dir)
        x = np.empty(len(idxs), np.float32)
        y = np.empty(len(idxs), np.float32)
        z = np.empty(len(idxs), np.float32)
        yaw = np.empty(len(idxs), np.float32)
        for k, j in enumerate(idxs):
            (x1, y1, z1, x2, y2, _z2) = objs.cubes[j]
            x[k] = 0.5 * (x1 + x2) + offset[0]
            y[k] = 0.5 * (y1 + y2) + offset[1]
            z[k] = z1 + offset[2]
            yaw[k] = rots.get(int(objs.rot[j]), 0.0)
        out.append(InstanceSet(
            kind=name, model_index=0, mesh=mesh,
            transforms=_yaw_transforms(x, y, z, yaw),
            color=(sp.custom_color if sp.fixed_color_id == -2 else None)))
    return out


def tiled_world_instances(world, specs: dict | None = None,
                          base_dir: str = ".", seed: int = 0) -> list:
    """InstanceSets for a models.world.TiledWorld's current city frame —
    the render_tt_models export point (display_world.cpp:1292)."""
    city = world.city
    if city is None:
        return []
    return city_instances(cars=city.cars, graph=world.road_graph,
                          peds=city.peds, helis=city.helis,
                          specs=specs, base_dir=base_dir, seed=seed)

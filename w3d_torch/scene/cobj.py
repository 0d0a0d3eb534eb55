"""Collision-object (cobj) scene file parser — full DSL (port of
`3dworld_tpu/scene/cobj.py`; host code, then `pack_cobjs` onto a device).

The reference's scene DSL (`read_coll_obj_file`, build_world.cpp:1186-2080)
is a character/token stream, NOT line-based: single-char commands (shapes
B/S/C/k/P/c/z, materials l/r/j/J, transforms t/T/m/M/s/R, platforms Q,
triggers K, lights L/V/U/b, movable d, negative n, teleporter x, ...) plus
long keywords (`movable`, `density`, `metalness`, `damage`, `rand_spheres`,
`transform_array_1d/2d`, ...), with OPTIONAL trailing arguments resolved by
try-read (read_float_reset_pos_on_fail).

The parser reads the whole command set into host-side spec lists
(`SceneParse`), with the JAX package's state across lines and includes
(layer, transform, `st` flags, group ids), so both packages give equal
`SceneParse`s.  `pack_cobjs` applies CSG subtraction of negative cubes
(`scene/csg`) and packs the cobjs into the padded `physics.cobjs.CobjSet`
on a device.  Geometry transforms (geom_xform_t, model3d.h:27-80) are
applied at parse time as the reference does: mirror -> swap -> scale ->
translate.

Commands with no simulation-side meaning (normal maps, texture scale,
draw-edge flags, sounds, popup text) are still parsed with the correct
arity — they land in the spec lists or `ignored` counts, never in
`skipped`.  `skipped` counts unknown or malformed commands.

An `O` model loads through `read_mesh_formats.load_model` in any format
it reads (or from the `.model3d.npz` cache), as in the JAX package; a
missing model file is skipped, and a file that fails to parse leaves the
model unloaded (`loaded` False, no cobjs).
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass, field, replace

import numpy as np
import torch

from ..utils.rng import RandGen
from ..physics.cobjs import (
    CobjSet, COLL_CUBE, COLL_SPHERE, COLL_CYLINDER, COLL_CYLINDER_ROT,
    COLL_POLYGON, COLL_CAPSULE, COLL_TORUS,
)


# ---------------------------------------------------------------------------
# geometry transform state (geom_xform_t, model3d.h:27-80)

@dataclass
class Xform:
    tv: tuple = (0.0, 0.0, 0.0)
    scale: float = 1.0
    mirror: tuple = (False, False, False)
    # swap_dim[i][j] flags, applied as the reference does: for i in 0..2,
    # for j in 0..2: if swap_dim[i][j]: swap(pos[i], pos[j])
    swap_dim: tuple = ((False,) * 3,) * 3

    def copy(self) -> "Xform":
        return Xform(tuple(self.tv), self.scale,
                     tuple(self.mirror),
                     tuple(tuple(r) for r in self.swap_dim))

    def xform_pos_rm(self, p):
        x, y, z = p
        v = [x, y, z]
        for i in range(3):
            if self.mirror[i]:
                v[i] = -v[i]
        for i in range(3):
            for j in range(3):
                if self.swap_dim[i][j]:
                    v[i], v[j] = v[j], v[i]
        return (v[0], v[1], v[2])

    def xform_pos_rms(self, p):
        x, y, z = self.xform_pos_rm(p)
        s = self.scale
        return (x * s, y * s, z * s)

    def xform_pos(self, p):
        x, y, z = self.xform_pos_rms(p)
        return (x + self.tv[0], y + self.tv[1], z + self.tv[2])

    def restore_mirror_and_swap(self):
        self.mirror = (False, False, False)
        self.swap_dim = ((False,) * 3,) * 3


# ---------------------------------------------------------------------------
# material / layer state ('l', 'r', j/J and long property keywords)

@dataclass
class CobjLayer:
    """Current material (cobj_params; 'l' build_world.cpp:1950-1963)."""

    elasticity: float = 0.5
    color: tuple = (1.0, 1.0, 1.0, 1.0)
    tid: int = -1
    tex_name: str = ""
    draw: bool = True
    refract_ix: float = 1.0
    light_atten: float = 0.0
    emissive: bool = False
    specular: float = 0.0           # scalar intensity (spec_color mean)
    spec_color: tuple = (0.0, 0.0, 0.0)
    shininess: float = 1.0
    friction: float = 0.0           # per-surface default, not in 'l'
    density: float = 1.0
    metalness: float = 0.0
    damage: float = 0.0
    destroy_prob: int = 0
    surfs: int = 0                  # 'e' skip-draw edges bitmask
    tscale: float = 1.0             # 'y'
    tdx: float = 0.0                # 'Y'
    tdy: float = 0.0
    swap_txy: bool = False
    normal_map: str = ""            # 'X'
    reflective: int = 0             # 0=none 1=planar 2=cube map
    is_voxel: bool = False          # 'v'


# ---------------------------------------------------------------------------
# parsed entity specs

@dataclass
class RawCobj:
    shape: int
    p1: tuple = (0.0, 0.0, 0.0)
    p2: tuple = (0.0, 0.0, 0.0)
    r1: float = 0.0
    r2: float = 0.0
    pts: tuple = ()
    layer: CobjLayer = field(default_factory=CobjLayer)
    platform_id: int = -1
    group_id: int = -1
    draw_group_id: int = -1
    negative: bool = False
    movable: bool = False
    destroy: int = 0                # 'a' destroyability level
    corner_radius: float = 0.0      # cube optional

    def bounds(self):
        """AABB (lo, hi) of the shape (approximate for round shapes)."""
        if self.shape == COLL_CUBE:
            lo = tuple(min(a, b) for a, b in zip(self.p1, self.p2))
            hi = tuple(max(a, b) for a, b in zip(self.p1, self.p2))
        elif self.shape == COLL_SPHERE:
            lo = tuple(c - self.r1 for c in self.p1)
            hi = tuple(c + self.r1 for c in self.p1)
        elif self.shape == COLL_POLYGON:
            arr = np.asarray(self.pts, np.float32)
            lo = tuple(arr.min(0) - self.r1)
            hi = tuple(arr.max(0) + self.r1)
        else:
            r = max(self.r1, self.r2)
            lo = tuple(min(a, b) - r for a, b in zip(self.p1, self.p2))
            hi = tuple(max(a, b) + r for a, b in zip(self.p1, self.p2))
        return lo, hi


@dataclass
class TriggerSpec:
    """'K' trigger (build_world.cpp:1640-1666)."""

    act_pos: tuple = (0.0, 0.0, 0.0)
    act_dist: float = 0.0
    auto_on_time: float = 0.0
    auto_off_time: float = 0.0
    player_only: bool = False
    requires_action: bool = False
    obj_id: int = -1
    act_region: tuple | None = None   # (x1,x2,y1,y2,z1,z2)


@dataclass
class PlatformSpec:
    """'Q 1' platform (platform_cont::add_from_file, platform.cpp:417-438).
    Speeds are units/sec, delays seconds (converted to ticks by the sim)."""

    fspeed: float = 0.0
    rspeed: float = 0.0
    sdelay: float = 0.0
    rdelay: float = 0.0
    ext_dist: float = 0.0          # travel distance (or rot angle)
    act_dist: float = 0.0          # >0 adds a built-in trigger at origin
    origin: tuple = (0.0, 0.0, 0.0)
    dir: tuple = (0.0, 0.0, 1.0)   # normalized
    cont: bool = False
    is_rot: bool = False
    update_light: bool = False
    destroys: bool = False
    sound: str = ""
    triggers: tuple = ()           # TriggerSpecs active at creation
    cobj_ids: list = field(default_factory=list)
    light_ids: list = field(default_factory=list)


@dataclass
class LightSpec:
    """'L' point/spot/line light (build_world.cpp:1547-1614)."""

    kind: str = "diffuse"          # 'ambient' | 'diffuse'
    size: float = 0.0
    pos: tuple = (0.0, 0.0, 0.0)
    pos2: tuple = (0.0, 0.0, 0.0)  # line light end
    color: tuple = (1.0, 1.0, 1.0, 1.0)
    dir: tuple = (0.0, 0.0, 0.0)
    beamwidth: float = 1.0
    r_inner: float = 0.0
    is_line: bool = False
    use_smap: int = 0
    num_dlight_rays: int = 0
    platform_id: int = -1
    indir_group: str = ""
    triggers: tuple = ()
    bind_pos: tuple | None = None  # 'V'
    rotate_axis: tuple | None = None
    rotate_rate: float = 0.0
    dynamic_indir: bool = False
    outdoor_shadows: bool = False
    is_cube_light: bool = False
    bounds: tuple | None = None    # cube_light volume


@dataclass
class CubeLightSpec:
    """'b' cube volume light for sky/global indirect (build_world.cpp:1676)."""

    bounds: tuple = (0, 0, 0, 0, 0, 0)
    color: tuple = (1.0, 1.0, 1.0)
    intensity: float = 1.0
    num_rays: int = 0
    ltype: int = 0                 # LIGHTING_SKY=0 | LIGHTING_GLOBAL=1
    disabled_edges: int = 0


@dataclass
class TeleporterSpec:
    pos: tuple = (0.0, 0.0, 0.0)
    dest: tuple = (0.0, 0.0, 0.0)
    radius: float = 0.0
    is_portal: bool = False
    is_indoors: bool = False


@dataclass
class JumpPadSpec:
    pos: tuple = (0.0, 0.0, 0.0)
    radius: float = 0.0
    velocity: tuple = (0.0, 0.0, 0.0)


@dataclass
class PlacedItemSpec:
    """'I' items / 'keycard' / 'A' appearance spots / 'p' waypoints share
    the read_or_calc_zval convention: z is optional, else interpolated from
    the mesh at scene build time (build_world.cpp:1008-1020)."""

    kind: str = "item"
    obj_class: int = 0
    subtype: int = 0
    regen_time: float = 0.0
    pos: tuple = (0.0, 0.0, 0.0)
    has_z: bool = True
    color: tuple = (1.0, 1.0, 1.0)


@dataclass
class FireSpec:
    pos: tuple = (0.0, 0.0, 0.0)
    size: float = 0.0
    light_bw: float = 0.0
    intensity: float = 0.0


@dataclass
class WaterSpec:
    kind: str = "spring"           # 'spring' | 'section'
    pos: tuple = (0.0, 0.0, 0.0)
    rate: float = 0.0
    diff: float = 0.1
    vel: tuple = (0.0, 0.0, 0.0)
    has_z: bool = False
    has_vel: bool = False
    bounds: tuple = ()             # section: (x1,y1,x2,y2)
    zval: float = 0.0
    wvol: float = 0.0


@dataclass
class VegSpec:
    kind: str = "tree"             # tree|small_tree|plant|leafy_plant|hedge
    pos: tuple = (0.0, 0.0, 0.0)
    size: float = 1.0
    width: float = 0.0
    vtype: int = 0
    has_z: bool = False
    count: int = 1
    delta: tuple = (0.0, 0.0, 0.0)
    clip_cube: tuple | None = None
    height_scale: float = 1.0
    br_scale: float = 1.0
    nl_scale: float = 1.0
    four_th: bool = False


@dataclass
class ModelSpec:
    """'O' model load + 'Z'/transform_array placements
    (build_world.cpp:1429-1546)."""

    filename: str = ""
    group_cobjs_level: int = 0
    recalc_normals: int = 0
    voxel_spacing: float = 0.0
    loaded: bool = False
    transforms: list = field(default_factory=list)  # (tv, scale, axis, angle)
    cobj_pts: list = field(default_factory=list)    # model-space cobj polys
    fit_to_scene: bool = False
    occlusion_cube: tuple | None = None
    lod_scale: float = 1.0


@dataclass
class PopupTextSpec:
    text: str = ""
    color: tuple = (1, 1, 1)
    size: float = 1.0
    duration: float = 0.0
    pos: tuple = (0.0, 0.0, 0.0)
    dist: float = 0.0
    mode: int = 0


@dataclass
class SceneParse:
    cobjs: list = field(default_factory=list)
    skipped: dict = field(default_factory=dict)   # unknown command -> count
    ignored: dict = field(default_factory=dict)   # consciously render-only
    layers: list = field(default_factory=list)
    platforms: list = field(default_factory=list)
    lights: list = field(default_factory=list)        # ambient + diffuse
    cube_lights: list = field(default_factory=list)
    teleporters: list = field(default_factory=list)
    jump_pads: list = field(default_factory=list)
    app_spots: list = field(default_factory=list)     # PlacedItemSpec
    waypoints: list = field(default_factory=list)
    items: list = field(default_factory=list)
    keycards: list = field(default_factory=list)
    fires: list = field(default_factory=list)
    water: list = field(default_factory=list)
    portals: list = field(default_factory=list)
    vegetation: list = field(default_factory=list)
    popup_texts: list = field(default_factory=list)
    sounds: list = field(default_factory=list)
    placed_sounds: list = field(default_factory=list)
    models: list = field(default_factory=list)
    materials_saved: dict = field(default_factory=dict)
    num_cobj_groups: int = 0
    num_draw_groups: int = 0


# render-only / host-only keywords consumed with correct arity but with no
# spec object (kept out of `skipped`); value = number of following tokens,
# -1 = handled specially
_TOKENS_EOL = object()


class _Tok:
    """Whitespace token stream with try-read semantics (the reference's
    fscanf + read_*_reset_pos_on_fail pattern)."""

    def __init__(self, text: str):
        self.toks: list[str] = []
        i, n = 0, len(text)
        while i < n:
            c = text[i]
            if c in " \t\r\n\f\v":
                i += 1
            elif c == "#":
                while i < n and text[i] != "\n":
                    i += 1
            elif c == "/" and i + 1 < n and text[i + 1] == "*":
                j = text.find("*/", i + 2)
                i = n if j < 0 else j + 2
            elif c == '"':
                j = text.find('"', i + 1)
                if j < 0:
                    j = n
                self.toks.append(text[i + 1:j])
                i = j + 1
            else:
                j = i
                while j < n and text[j] not in " \t\r\n\f\v":
                    j += 1
                tok = text[i:j]
                # strip trailing line comment glued to a token? reference
                # getc-based parse treats '#' only at token start; keep as-is
                self.toks.append(tok)
                i = j
        self.i = 0

    def eof(self) -> bool:
        return self.i >= len(self.toks)

    def next(self) -> str:
        t = self.toks[self.i]
        self.i += 1
        return t

    def next_f(self) -> float:
        return float(self.next())

    def next_i(self) -> int:
        return int(float(self.next()))

    def next_u(self) -> int:
        v = self.next_i()
        if v < 0:
            raise ValueError("expected unsigned")
        return v

    def try_f(self):
        if self.eof():
            return None
        try:
            v = float(self.toks[self.i])
        except ValueError:
            return None
        self.i += 1
        return v

    def try_i(self):
        if self.eof():
            return None
        t = self.toks[self.i]
        try:
            v = int(t)
        except ValueError:
            return None
        self.i += 1
        return v

    def next_vec(self):
        return (self.next_f(), self.next_f(), self.next_f())

    def try_vec(self):
        save = self.i
        vs = []
        for _ in range(3):
            v = self.try_f()
            if v is None:
                self.i = save
                return None
            vs.append(v)
        return tuple(vs)

    def try_cube(self, xf: Xform):
        """read_cube (build_world.cpp:1150-1161): 6 floats x1 x2 y1 y2 z1 z2,
        both corners transformed.  Returns (cube, num_read)."""
        save = self.i
        vals = []
        for _ in range(6):
            v = self.try_f()
            if v is None:
                got = len(vals)
                self.i = save
                return None, got
            vals.append(v)
        p1 = xf.xform_pos((vals[0], vals[2], vals[4]))
        p2 = xf.xform_pos((vals[1], vals[3], vals[5]))
        lo = tuple(min(a, b) for a, b in zip(p1, p2))
        hi = tuple(max(a, b) for a, b in zip(p1, p2))
        return (lo[0], hi[0], lo[1], hi[1], lo[2], hi[2]), 6


def _norm(v):
    l = math.sqrt(v[0] ** 2 + v[1] ** 2 + v[2] ** 2)
    return (v[0] / l, v[1] / l, v[2] / l) if l > 0 else (0.0, 0.0, 1.0)


def _poly_normal(pts):
    a, b, c = (np.asarray(p) for p in pts[:3])
    n = np.cross(b - a, c - a)
    l = np.linalg.norm(n)
    return tuple(n / l) if l > 0 else (0.0, 0.0, 1.0)


def _split_polygon(pts: tuple) -> list[tuple]:
    """split_polygon (csg.cpp): decompose an npts polygon into coplanar
    quads/triangles (the cobj SoA holds <=4 points).  Fan split preserves
    the winding; the reference additionally merges coplanar pairs — shape
    coverage is identical for collision purposes."""
    n = len(pts)
    if n <= 4:
        return [tuple(pts)]
    out = []
    i = 1
    while i + 1 < n:
        if i + 2 < n:
            out.append((pts[0], pts[i], pts[i + 1], pts[i + 2]))
            i += 2
        else:
            out.append((pts[0], pts[i], pts[i + 1]))
            i += 1
    return out


def _read_or_calc_zval(tk: _Tok, pos_xy, xf: Xform):
    """read_or_calc_zval (build_world.cpp:1008-1020): optional z; returns
    (pos, has_z).  When has_z is False the caller interpolates the mesh z
    at scene build time."""
    z = tk.try_f()
    has_z = z is not None
    pos = xf.xform_pos((pos_xy[0], pos_xy[1], z if has_z else 0.0))
    return pos, has_z


def parse_coll_obj_file(path: str, sphere_gen_seed: int = 0,
                        xf: Xform | None = None, sp: SceneParse | None = None,
                        layer: CobjLayer | None = None,
                        sphere_gen: dict | None = None) -> SceneParse:
    """Parse a coll-obj scene file (recursively via 'i' includes).

    Matches read_coll_obj_file (build_world.cpp:1186-2080) command by
    command; transforms/materials propagate INTO includes (pass-by-value in
    the reference) but not back out.
    """
    top = sp is None
    sp = sp or SceneParse()
    xf = (xf or Xform()).copy()
    layer = replace(layer) if layer is not None else CobjLayer()
    if not os.path.exists(path):
        return sp
    with open(path) as f:
        tk = _Tok(f.read())

    # mutable command state
    st = {
        "platform_id": -1, "group_id": -1, "draw_group_id": -1,
        "negative": False, "movable": False, "destroy": 0,
        "remove_tj": False, "reflective": 0,
        "triggers": [], "sensor": None,
        "indir_group": "", "prev_light_start": None,
        "light_axis": (0.0, 0.0, 0.0), "light_rotate": 0.0,
        "dynamic_indir": False, "outdoor_shadows": False,
        "model_lod_scale": 1.0, "fit_to_scene": False,
        "tree_height": 1.0, "tree_br_scale": 1.0, "tree_nl_scale": 1.0,
        "leaf_wind": True, "last_sound": "",
    }
    materials = sp.materials_saved

    def cur_model() -> ModelSpec | None:
        return sp.models[-1] if sp.models else None

    def add_cobj(shape, p1=(0, 0, 0), p2=(0, 0, 0), r1=0.0, r2=0.0, pts=(),
                 corner_radius=0.0):
        c = RawCobj(shape, p1, p2, r1, r2, pts, layer=replace(layer),
                    platform_id=st["platform_id"], group_id=st["group_id"],
                    draw_group_id=st["draw_group_id"],
                    negative=st["negative"], movable=st["movable"],
                    destroy=st["destroy"], corner_radius=corner_radius)
        if st["platform_id"] >= 0:
            sp.platforms[st["platform_id"]].cobj_ids.append(len(sp.cobjs))
        sp.cobjs.append(c)
        return c

    def add_light(ls: LightSpec):
        if ls.kind == "diffuse":
            ls.platform_id = st["platform_id"]
            ls.indir_group = st["indir_group"]
            ls.triggers = tuple(st["triggers"])
            if (st["light_rotate"] != 0.0
                    and st["light_axis"] != (0.0, 0.0, 0.0)
                    and ls.dir != (0.0, 0.0, 0.0)):
                ls.rotate_axis = st["light_axis"]
                ls.rotate_rate = st["light_rotate"]
            ls.dynamic_indir = st["dynamic_indir"]
            ls.outdoor_shadows = st["outdoor_shadows"]
            if st["platform_id"] >= 0:
                sp.platforms[st["platform_id"]].light_ids.append(len(sp.lights))
        sp.lights.append(ls)

    while not tk.eof():
        cmd = tk.next()
        # long-name aliases (build_world.cpp:1228-1242)
        cmd = {
            "cube": "B", "sphere": "S", "cylinder": "C", "capsule": "k",
            "polygon": "P", "torus": "z", "trigger": "K", "platform": "Q",
            "light": "L", "bind_light": "V", "indir_dlight_group": "U",
            "movable": "d", "end": "q", "teleporter": "x",
        }.get(cmd, cmd)
        try:
            if cmd == "q":
                break
            elif cmd == "i":  # include
                sub = os.path.join(os.path.dirname(path), tk.next())
                if not os.path.exists(sub):
                    sub2 = tk.toks[tk.i - 1]  # as-given (absolute/cwd)
                    sub = sub2 if os.path.exists(sub2) else sub
                parse_coll_obj_file(sub, sphere_gen_seed, xf, sp, layer,
                                    sphere_gen)
            # ---- transforms -------------------------------------------
            elif cmd == "t":
                d = tk.next_vec()
                xf.tv = (xf.tv[0] + d[0], xf.tv[1] + d[1], xf.tv[2] + d[2])
            elif cmd == "T":
                xf.tv = tk.next_vec()
            elif cmd == "m":
                # validate BEFORE assigning: the per-command except would
                # otherwise leave a zero/negative scale applied to every
                # later shape
                new_scale = tk.next_f()
                if not new_scale > 0.0:
                    raise ValueError("scale must be positive")
                xf.scale = new_scale
            elif cmd == "M":
                dim = tk.next_i()
                mr = list(xf.mirror)
                mr[dim] = not mr[dim]
                xf.mirror = tuple(mr)
            elif cmd == "s":
                d1, d2 = tk.next_i(), tk.next_i()
                sw = [list(r) for r in xf.swap_dim]
                sw[d1][d2] = not sw[d1][d2]
                xf.swap_dim = tuple(tuple(r) for r in sw)
            elif cmd == "R":
                xf.restore_mirror_and_swap()
            # ---- shapes ------------------------------------------------
            elif cmd == "B":
                cube, nr = tk.try_cube(xf)
                if nr != 6:
                    raise ValueError("cube needs 6 floats")
                cr = tk.try_f()
                add_cobj(COLL_CUBE, (cube[0], cube[2], cube[4]),
                         (cube[1], cube[3], cube[5]),
                         corner_radius=(cr or 0.0) * xf.scale)
            elif cmd == "S":
                x, y, z, r = tk.next_f(), tk.next_f(), tk.next_f(), tk.next_f()
                add_cobj(COLL_SPHERE, xf.xform_pos((x, y, z)),
                         r1=r * xf.scale)
            elif cmd in ("C", "k"):
                p1 = xf.xform_pos(tk.next_vec())
                p2 = xf.xform_pos(tk.next_vec())
                r1 = tk.next_f() * xf.scale
                r2 = tk.next_f() * xf.scale
                if cmd == "k":
                    shape = COLL_CAPSULE
                else:
                    vertical = (abs(p1[0] - p2[0]) < 1e-9
                                and abs(p1[1] - p2[1]) < 1e-9)
                    shape = COLL_CYLINDER if vertical else COLL_CYLINDER_ROT
                add_cobj(shape, p1, p2, r1, r2)
            elif cmd == "z":
                p1 = xf.xform_pos(tk.next_vec())
                d = _norm(xf.xform_pos_rm(tk.next_vec()))
                r1 = tk.next_f() * xf.scale
                r2 = tk.next_f() * xf.scale
                add_cobj(COLL_TORUS, p1, d, r1, r2)
            elif cmd == "P":
                npts = tk.next_u()
                if npts < 3:
                    raise ValueError("polygon needs >= 3 points")
                pts = tuple(xf.xform_pos(tk.next_vec()) for _ in range(npts))
                thick = tk.next_f() * xf.scale
                tk.try_i()  # optional add_as_rotated_cube
                for quad in _split_polygon(pts):
                    add_cobj(COLL_POLYGON, quad[0], r1=thick, pts=quad)
            elif cmd == "c":  # hollow multisided cylinder -> N polygons
                pt0 = xf.xform_pos(tk.next_vec())
                pt1 = xf.xform_pos(tk.next_vec())
                ro, ri = tk.next_f(), tk.next_f()
                nsides = tk.next_u()
                six = tk.try_i()
                eix = tk.try_i()
                six = six or 0
                eix = eix if eix is not None else nsides
                thick = xf.scale * (ro - ri)
                r = 0.5 * xf.scale * (ro + ri)
                step = 2.0 * math.pi / nsides
                edist = 0.5 * thick * math.tan(0.5 * step)
                vc = _norm(tuple(b - a for a, b in zip(pt0, pt1)))
                # min-|component| axis (get_min_dim uses fabs) — raw
                # comparison would pick an axis PARALLEL to a -y/-z
                # cylinder axis and collapse every quad onto the line
                av = tuple(abs(v) for v in vc)
                dmin = (0 if av[0] < av[2] else 2) if av[0] < av[1] else \
                       (1 if av[1] < av[2] else 2)
                vn = [0.0, 0.0, 0.0]
                vn[dmin] = 1.0
                d0 = _norm(np.cross(vc, vn))
                d1 = _norm(np.cross(vc, d0))
                for i in range(six, eix):
                    deltas = []
                    for val in (i - 0.5, i + 0.5):
                        v = step * val
                        deltas.append(tuple(
                            (d0[k] * math.cos(v) + d1[k] * math.sin(v)) * r
                            for k in range(3)))
                    ext = _norm(tuple(b - a for a, b in zip(*deltas)))
                    da = tuple(a - e * edist for a, e in zip(deltas[0], ext))
                    db = tuple(b + e * edist for b, e in zip(deltas[1], ext))
                    quad = (tuple(p + d for p, d in zip(pt0, da)),
                            tuple(p + d for p, d in zip(pt0, db)),
                            tuple(p + d for p, d in zip(pt1, db)),
                            tuple(p + d for p, d in zip(pt1, da)))
                    add_cobj(COLL_POLYGON, quad[0], r1=thick, pts=quad)
            elif cmd == "D":  # step delta: replicate last shape
                if not sp.cobjs:
                    raise ValueError("step delta before any shape")
                dp = tk.next_vec()
                num = tk.next_u()
                dsz = tk.try_vec() or (0.0, 0.0, 0.0)
                dp = xf.xform_pos_rms(dp)
                dsz = xf.xform_pos_rms(dsz)
                base = sp.cobjs[-1]
                cur = base
                for _ in range(num):
                    p1 = tuple(a + b for a, b in zip(cur.p1, dp))
                    p2 = tuple(a + b for a, b in zip(cur.p2, dp))
                    if cur.shape == COLL_CUBE:
                        p2 = tuple(a + b for a, b in zip(p2, dsz))
                    elif cur.shape in (COLL_CYLINDER, COLL_CYLINDER_ROT,
                                       COLL_CAPSULE):
                        p2 = tuple(a + b for a, b in zip(p2, dsz))
                    pts = tuple(tuple(a + b for a, b in zip(p, dp))
                                for p in cur.pts)
                    nc = replace(cur, p1=p1, p2=p2, pts=pts)
                    sp.cobjs.append(nc)
                    cur = nc
            # ---- materials --------------------------------------------
            elif cmd == "l":
                layer.elasticity = tk.next_f()
                layer.color = (tk.next_f(), tk.next_f(), tk.next_f(),
                               tk.next_f())
                layer.tex_name = tk.next()
                try:
                    layer.tid = int(layer.tex_name)
                except ValueError:
                    layer.tid = -2  # named texture (resolved by catalog)
                d = tk.try_i()
                layer.draw = (d != 0) if d is not None else True
                v = tk.try_f()
                layer.refract_ix = v if v is not None else 1.0
                v = tk.try_f()
                layer.light_atten = v if v is not None else 0.0
                v = tk.try_i()
                layer.emissive = bool(v) if v is not None else False
                sp.layers.append(replace(layer))
            elif cmd == "r":
                inten = tk.next_f()
                layer.shininess = tk.next_f()
                rgb = tk.try_vec()
                if rgb is not None:
                    layer.spec_color = tuple(inten * c for c in rgb)
                else:
                    layer.spec_color = (inten, inten, inten)
                layer.specular = sum(layer.spec_color) / 3.0
            elif cmd == "J":
                materials[tk.next()] = replace(layer)
            elif cmd == "j":
                name = tk.next()
                if name not in materials:
                    raise ValueError(f"material '{name}' not defined")
                layer = replace(materials[name])
            elif cmd == "e":
                layer.surfs = tk.next_i()
            elif cmd == "y":
                layer.tscale = tk.next_f()
            elif cmd == "Y":
                layer.tdx, layer.tdy = tk.next_f(), tk.next_f()
                v = tk.try_i()
                layer.swap_txy = bool(v) if v is not None else False
            elif cmd == "X":
                layer.normal_map = tk.next()
                tk.try_i()
                tk.try_i()
            elif cmd == "n":
                st["negative"] = tk.next_i() != 0
            elif cmd == "a":
                st["destroy"] = tk.next_i()
            elif cmd == "d":
                st["movable"] = tk.next_i() != 0
            elif cmd == "v":
                layer.is_voxel = tk.next_i() != 0
            elif cmd == "density":
                layer.density = tk.next_f()
            elif cmd == "metalness":
                layer.metalness = min(1.0, max(0.0, tk.next_f()))
            elif cmd == "damage":
                layer.damage = tk.next_f()
            elif cmd == "destroy_prob":
                layer.destroy_prob = max(0, min(255, tk.next_i()))
            elif cmd == "reflective":
                st["reflective"] = 1 if tk.next_i() else 0
                layer.reflective = st["reflective"]
            elif cmd == "cube_map_ref":
                st["reflective"] = 2 if tk.next_i() else 0
                layer.reflective = st["reflective"]
            elif cmd == "tj":
                st["remove_tj"] = tk.next_i() != 0
            # ---- platforms / triggers ---------------------------------
            elif cmd == "Q":
                if tk.next_i() == 0:
                    st["platform_id"] = -1
                else:
                    # speeds/ext_dist/act_dist deliberately NOT scaled by
                    # xf.scale — the reference doesn't either (platform
                    # add_from_file xforms only origin + dir mirror/swap,
                    # platform.cpp:1130-1148), unlike K triggers which DO
                    # scale act_dist (build_world.cpp:1657)
                    vals = [tk.next_f() for _ in range(6)]
                    origin = xf.xform_pos(tk.next_vec())
                    pdir = xf.xform_pos_rm(tk.next_vec())
                    cont = tk.next_i()
                    is_rot = tk.try_i() or 0
                    upd_l = tk.try_i() or 0
                    destr = tk.try_i() or 0
                    pf = PlatformSpec(
                        fspeed=vals[0], rspeed=vals[1], sdelay=vals[2],
                        rdelay=vals[3], ext_dist=vals[4], act_dist=vals[5],
                        origin=origin, dir=_norm(pdir), cont=cont != 0,
                        is_rot=is_rot != 0, update_light=upd_l != 0,
                        destroys=destr != 0, sound=st["last_sound"],
                        triggers=tuple(st["triggers"]))
                    st["last_sound"] = ""
                    st["platform_id"] = len(sp.platforms)
                    sp.platforms.append(pf)
            elif cmd == "K":
                # bare K (next token not a float) clears trigger state
                save = tk.i
                v = tk.try_f()
                if v is None:
                    st["triggers"] = []
                else:
                    tk.i = save
                    tr = TriggerSpec()
                    pos = tk.next_vec()
                    tr.act_pos = xf.xform_pos(pos)
                    tr.act_dist = tk.next_f() * xf.scale
                    tr.auto_on_time = tk.next_f()
                    tr.auto_off_time = tk.next_f()
                    tr.player_only = tk.next_i() != 0
                    tr.requires_action = tk.next_i() != 0
                    v = tk.try_i()
                    tr.obj_id = v if v is not None else -1
                    cube, nr = tk.try_cube(xf)
                    if nr == 6:
                        tr.act_region = cube
                    st["triggers"].append(tr)
            elif cmd == "sensor":
                # sensor type [x y z [invert [radius [thresh]]]]
                tk.next()
                for _ in range(6):
                    if tk.try_f() is None:
                        break
            # ---- lights -------------------------------------------------
            elif cmd == "L":
                asize, dsize = tk.next_f(), tk.next_f()
                pos = xf.xform_pos(tk.next_vec())
                color = (tk.next_f(), tk.next_f(), tk.next_f(), tk.next_f())
                beamwidth, r_inner, is_line, use_smap, nrays = 1.0, 0.0, 0, 0, 0
                ldir = (0.0, 0.0, 0.0)
                pos2 = pos
                d = tk.try_vec()
                if d is not None:
                    bw = tk.try_f()
                    if bw is not None:
                        beamwidth = bw
                        ri = tk.try_f()
                        if ri is not None:
                            r_inner = ri
                            il = tk.try_i()
                            if il is not None:
                                is_line = il
                                us = tk.try_i()
                                if us is not None:
                                    use_smap = us
                                    nr_ = tk.try_i()
                                    if nr_ is not None:
                                        nrays = nr_
                    if is_line:
                        pos2 = xf.xform_pos(d)
                        ldir = (0.0, 0.0, 0.0)
                        beamwidth = 1.0
                    else:
                        ldir = xf.xform_pos_rm(d)
                st["prev_light_start"] = len(sp.lights)
                for kind, size in (("ambient", asize), ("diffuse", dsize)):
                    if size == 0.0:
                        continue
                    if use_smap == 2 and is_line == 0 and beamwidth == 1.0:
                        # shadowed point light -> 6 cube-face lights
                        for ldim in range(3):
                            for ldirn in (-1.0, 1.0):
                                dvec = [0.0, 0.0, 0.0]
                                dvec[ldim] = ldirn
                                add_light(LightSpec(
                                    kind=kind, size=size, pos=pos, pos2=pos2,
                                    color=color, dir=tuple(dvec),
                                    beamwidth=0.4, r_inner=r_inner,
                                    use_smap=2, num_dlight_rays=nrays))
                    else:
                        add_light(LightSpec(
                            kind=kind, size=size, pos=pos, pos2=pos2,
                            color=color, dir=ldir, beamwidth=beamwidth,
                            r_inner=r_inner, is_line=is_line != 0,
                            use_smap=use_smap, num_dlight_rays=nrays))
                st["light_rotate"] = 0.0
                st["light_axis"] = (0.0, 0.0, 0.0)
            elif cmd == "V":
                pos = xf.xform_pos(tk.next_vec())
                start = st["prev_light_start"]
                if start is None or start >= len(sp.lights):
                    raise ValueError("bind_light: no previous light")
                for i in range(start, len(sp.lights)):
                    sp.lights[i].bind_pos = pos
            elif cmd == "U":
                name = tk.next()
                tk.try_f()  # optional scale
                st["indir_group"] = name
            elif cmd == "b":
                cube, nr = tk.try_cube(xf)
                if nr != 6:
                    raise ValueError("cube volume light needs 6 floats")
                cl = CubeLightSpec(bounds=cube)
                cl.color = (tk.next_f(), tk.next_f(), tk.next_f())
                cl.intensity = tk.next_f()
                cl.num_rays = tk.next_u()
                cl.ltype = tk.next_i()
                v = tk.try_i()
                cl.disabled_edges = v or 0
                sp.cube_lights.append(cl)
            elif cmd == "cube_light":
                cube, nr = tk.try_cube(xf)
                if nr != 6:
                    raise ValueError("cube_light needs 6 floats")
                size = tk.next_f()
                color = (tk.next_f(), tk.next_f(), tk.next_f(), tk.next_f())
                add_light(LightSpec(kind="ambient", size=size * xf.scale,
                                    pos=(cube[0], cube[2], cube[4]),
                                    pos2=(cube[1], cube[3], cube[5]),
                                    color=color, is_cube_light=True,
                                    bounds=cube))
            elif cmd == "light_rotate":
                st["light_axis"] = tk.next_vec()
                st["light_rotate"] = tk.next_f()
            elif cmd == "dynamic_indir":
                st["dynamic_indir"] = tk.next_i() != 0
            elif cmd == "outdoor_shadows":
                st["outdoor_shadows"] = tk.next_i() != 0
            # ---- gameplay objects --------------------------------------
            elif cmd == "x":
                tp = TeleporterSpec()
                tp.pos = tk.next_vec()
                tp.dest = tk.next_vec()
                tp.radius = tk.next_f()
                v = tk.try_i()
                tp.is_portal = bool(v) if v is not None else False
                v = tk.try_i()
                tp.is_indoors = bool(v) if v is not None else False
                tp.pos = xf.xform_pos(tp.pos)
                tp.dest = xf.xform_pos(tp.dest)
                sp.teleporters.append(tp)
            elif cmd == "jump_pad":
                jp = JumpPadSpec()
                jp.pos = xf.xform_pos(tk.next_vec())
                jp.radius = tk.next_f()
                jp.velocity = tk.next_vec()
                sp.jump_pads.append(jp)
            elif cmd == "A":
                x, y = tk.next_f(), tk.next_f()
                pos, has_z = _read_or_calc_zval(tk, (x, y), xf)
                sp.app_spots.append(PlacedItemSpec(kind="app_spot", pos=pos,
                                                   has_z=has_z))
            elif cmd == "p":
                wtype = tk.next_i()
                x, y = tk.next_f(), tk.next_f()
                pos, has_z = _read_or_calc_zval(tk, (x, y), xf)
                sp.waypoints.append(PlacedItemSpec(
                    kind="waypoint", subtype=wtype, pos=pos, has_z=has_z))
            elif cmd == "I":
                oc, sub = tk.next_i(), tk.next_i()
                regen = tk.next_f()
                x, y = tk.next_f(), tk.next_f()
                pos, has_z = _read_or_calc_zval(tk, (x, y), xf)
                sp.items.append(PlacedItemSpec(
                    kind="item", obj_class=oc, subtype=sub,
                    regen_time=regen, pos=pos, has_z=has_z))
            elif cmd == "keycard":
                kid = tk.next_u()
                color = (tk.next_f(), tk.next_f(), tk.next_f())
                x, y = tk.next_f(), tk.next_f()
                pos, has_z = _read_or_calc_zval(tk, (x, y), xf)
                sp.keycards.append(PlacedItemSpec(
                    kind="keycard", subtype=kid, pos=pos, has_z=has_z,
                    color=color))
            elif cmd == "popup_text":
                pt = PopupTextSpec()
                pt.text = tk.next()
                pt.color = (tk.next_f(), tk.next_f(), tk.next_f())
                pt.size = tk.next_f()
                pt.duration = tk.next_f()
                pt.pos = xf.xform_pos(tk.next_vec())
                pt.dist = tk.next_f()
                pt.mode = tk.next_u()
                sp.popup_texts.append(pt)
            elif cmd == "f":
                size, bw, inten = tk.next_f(), tk.next_f(), tk.next_f()
                pos = xf.xform_pos(tk.next_vec())
                sp.fires.append(FireSpec(pos=pos, size=size, light_bw=bw,
                                         intensity=inten))
            elif cmd == "w":
                x, y, rate = tk.next_f(), tk.next_f(), tk.next_f()
                ws = WaterSpec(kind="spring", rate=rate)
                z = tk.try_f()
                ws.has_z = z is not None
                save = tk.i
                vel = tk.try_vec()
                diff = tk.try_f() if vel is not None else None
                if vel is not None and diff is not None:
                    ws.vel = xf.xform_pos_rms(vel)
                    ws.diff = diff
                    ws.has_vel = True
                elif vel is not None:
                    tk.i = save
                ws.pos = xf.xform_pos((x, y, z if ws.has_z else 0.0))
                sp.water.append(ws)
            elif cmd == "W":
                x1, x2, y1, y2 = (tk.next_f() for _ in range(4))
                zval, wvol = tk.next_f(), tk.next_f()
                s, t = xf.scale, xf.tv
                sp.water.append(WaterSpec(
                    kind="section",
                    bounds=(s * x1 + t[0], s * y1 + t[1],
                            s * x2 + t[0], s * y2 + t[1]),
                    zval=s * zval + t[2], wvol=wvol))
            elif cmd == "N":
                pts = tuple(xf.xform_pos(tk.next_vec()) for _ in range(4))
                nrm = tk.try_vec()
                sp.portals.append((pts, nrm))
            # ---- vegetation --------------------------------------------
            elif cmd == "g":
                st["tree_height"] = tk.next_f()
                st["tree_br_scale"] = tk.next_f()
                st["tree_nl_scale"] = tk.next_f()
                st["leaf_wind"] = tk.next_i() != 0
            elif cmd == "E":
                x, y = tk.next_f(), tk.next_f()
                size = tk.next_f()
                ttype = tk.next_i()
                z = tk.try_f()
                four = tk.try_i()
                pos = xf.xform_pos((x, y, z if z is not None else 0.0))
                sp.vegetation.append(VegSpec(
                    kind="tree", pos=pos, size=max(1.0, size * xf.scale),
                    vtype=ttype, has_z=z is not None,
                    height_scale=st["tree_height"],
                    br_scale=st["tree_br_scale"],
                    nl_scale=st["tree_nl_scale"],
                    four_th=bool(four) if four is not None else False))
            elif cmd == "H":
                x, y = tk.next_f(), tk.next_f()
                dx, dy = tk.next_f(), tk.next_f()
                nsteps = tk.next_i()
                size = tk.next_f()
                ttype = tk.next_i()
                cube, nr = tk.try_cube(xf)
                pos = xf.xform_pos((x, y, 0.0))
                delta = xf.xform_pos_rms((dx, dy, 0.0))
                sp.vegetation.append(VegSpec(
                    kind="hedge", pos=pos, size=max(1.0, size * xf.scale),
                    vtype=ttype, count=nsteps, delta=delta,
                    clip_cube=cube if nr == 6 else None,
                    height_scale=st["tree_height"],
                    br_scale=st["tree_br_scale"],
                    nl_scale=st["tree_nl_scale"]))
            elif cmd == "F":
                x, y = tk.next_f(), tk.next_f()
                h, w = tk.next_f(), tk.next_f()
                ttype = tk.next_i()
                z = tk.try_f()
                pos = xf.xform_pos((x, y, z if z is not None else 0.0))
                sp.vegetation.append(VegSpec(
                    kind="small_tree", pos=pos, size=xf.scale * h,
                    width=xf.scale * w, vtype=ttype, has_z=z is not None))
            elif cmd == "G":
                x, y = tk.next_f(), tk.next_f()
                h, r = tk.next_f(), tk.next_f()
                ptype = tk.next_i()
                z = tk.try_f()
                pos = xf.xform_pos((x, y, z if z is not None else 0.0))
                sp.vegetation.append(VegSpec(
                    kind="leafy_plant" if ptype < 0 else "plant", pos=pos,
                    size=xf.scale * h, width=xf.scale * r,
                    vtype=abs(ptype), has_z=z is not None))
            # ---- models -------------------------------------------------
            elif cmd == "O":
                ms = ModelSpec(filename=tk.next())
                ms.group_cobjs_level = tk.next_i()
                ms.recalc_normals = tk.next_i()
                tk.next_i()  # write_file
                v = tk.try_f()
                ms.voxel_spacing = v or 0.0
                ms.fit_to_scene = st["fit_to_scene"]
                ms.lod_scale = st["model_lod_scale"]
                ms.loaded = _try_load_model(ms, sp, path, layer, xf,
                                            add_cobj)
                sp.models.append(ms)
            elif cmd == "Z":
                lvl = tk.next_i()
                tv = tk.next_vec()
                scale = tk.try_f()
                axis, angle, vsp = None, 0.0, 0.0
                if scale is not None:
                    axis = tk.try_vec()
                    if axis is not None:
                        angle = tk.next_f()
                        v = tk.try_f()
                        vsp = v or 0.0
                ms = cur_model()
                tr = (tv, scale if scale is not None else 1.0, axis, angle,
                      lvl, vsp)
                if ms is not None:
                    ms.transforms.append(tr)
                    if ms.loaded:
                        _instance_model_cobjs(ms, tr, sp, layer, xf,
                                              add_cobj)
            elif cmd in ("transform_array_1d", "transform_array_2d"):
                if cmd.endswith("1d"):
                    num1, num2 = tk.next_u(), 1
                    step1 = tk.next_vec()
                    step2 = (0.0, 0.0, 0.0)
                else:
                    num1, num2 = tk.next_u(), tk.next_u()
                    step1 = tk.next_vec()
                    step2 = tk.next_vec()
                ms = cur_model()
                if ms is not None and ms.transforms:
                    base = ms.transforms[-1]
                    for a in range(num1):
                        for b in range(num2):
                            if a == 0 and b == 0:
                                continue
                            tv = tuple(base[0][k] + a * step1[k]
                                       + b * step2[k] for k in range(3))
                            tr = (tv, *base[1:])
                            ms.transforms.append(tr)
                            if ms.loaded:
                                _instance_model_cobjs(ms, tr, sp, layer,
                                                      xf, add_cobj)
            elif cmd == "model3d_fit_to_scene":
                st["fit_to_scene"] = tk.next_i() != 0
            elif cmd == "model_lod_scale":
                st["model_lod_scale"] = tk.next_f()
            elif cmd == "model_occlusion_cube":
                cube, nr = tk.try_cube(Xform())
                ms = cur_model()
                if ms is not None and nr == 6:
                    ms.occlusion_cube = cube
            elif cmd == "lighting_file_sky_model":
                tk.next()
                for _ in range(4):
                    tk.next_f()
                sp.ignored["lighting_file_sky_model"] = \
                    sp.ignored.get("lighting_file_sky_model", 0) + 1
            # ---- groups / misc -----------------------------------------
            elif cmd == "start_cobj_group":
                st["group_id"] = sp.num_cobj_groups
                sp.num_cobj_groups += 1
            elif cmd == "end_cobj_group":
                st["group_id"] = -1
            elif cmd == "start_draw_group":
                st["draw_group_id"] = sp.num_draw_groups
                sp.num_draw_groups += 1
            elif cmd == "end_draw_group":
                st["draw_group_id"] = -1
            elif cmd == "sound_file":
                st["last_sound"] = tk.next()
                sp.sounds.append(st["last_sound"])
            elif cmd == "place_sound":
                name = tk.next()
                pos = xf.xform_pos(tk.next_vec())
                gain = tk.try_f()
                pitch = tk.try_f()
                sp.placed_sounds.append(
                    (name, pos, gain or 1.0, pitch or 1.0))
            elif cmd == "rand_spheres":
                # num cx cy cz place_radius min_r max_r
                # (gen_rand_spheres, sphere_materials.cpp:490-525): uniform
                # radius, xy-disc rejection placement at z=center.z+radius
                num = tk.next_u()
                # honor the active transform like every other placement:
                # center through xform_pos, radii scaled
                cx, cy, cz = xf.xform_pos(tk.next_vec())
                pr, rmin, rmax = (xf.scale * tk.next_f(),
                                  xf.scale * tk.next_f(),
                                  xf.scale * tk.next_f())
                from .sphere_materials import (gen_params_from_config,
                                               gen_random_material)
                gp = gen_params_from_config(sphere_gen)
                rg = RandGen()
                seed = gp.rand_seed or sphere_gen_seed
                if seed != 0:
                    rg.set_state(seed, 123)
                placed = []
                for _ in range(num):
                    r = rg.rand_uniform(rmin, rmax)
                    for _attempt in range(1000):
                        while True:
                            vx = 2.0 * rg.randd() - 1.0
                            vy = 2.0 * rg.randd() - 1.0
                            if vx * vx + vy * vy < 1.0:
                                break
                        pos = (cx + pr * vx, cy + pr * vy, cz + r)
                        if all((pos[0] - q[0]) ** 2 + (pos[1] - q[1]) ** 2
                               + (pos[2] - q[2]) ** 2 >= (r + q[3]) ** 2
                               for q in placed):
                            break
                    placed.append((*pos, r))
                    # per-sphere randomized MATERIAL (gen_rand_spheres,
                    # sphere_materials.cpp:517-551): the cobj carries
                    # hardness->elasticity, density, alpha, light_atten,
                    # refract_ix; emissive spheres register local light
                    # sources for the tracer (light_sources_a push)
                    mat = gen_random_material(rg, gp, r)
                    save = replace(layer)
                    layer.elasticity = mat.hardness
                    layer.color = (*mat.diffuse_color, mat.alpha)
                    layer.density = mat.density
                    layer.metalness = mat.metalness
                    layer.emissive = mat.emissive
                    layer.specular = mat.specular_mag
                    layer.spec_color = mat.specular_color
                    layer.shininess = mat.specular_exp
                    layer.light_atten = (mat.light_atten
                                         if gp.enable_light_atten else 0.0)
                    layer.refract_ix = mat.refract_ix
                    add_cobj(COLL_SPHERE, pos, r1=r)
                    for k in vars(save):
                        setattr(layer, k, getattr(save, k))
                    if mat.light_radius > 1e-5:
                        add_light(LightSpec(
                            kind="diffuse", size=mat.light_radius,
                            pos=pos, color=(*mat.diffuse_color, 1.0),
                            r_inner=1.01 * r))
            else:
                sp.skipped[cmd] = sp.skipped.get(cmd, 0) + 1
        except (ValueError, IndexError):
            sp.skipped[cmd] = sp.skipped.get(cmd, 0) + 1
    if st.get("remove_tj"):
        # 'tj 1': remove T-junctions between same-material cubes
        # (coll_obj_group::subdiv_cubes, csg.cpp:1027-1092)
        from .csg import subdiv_cubes
        sp.cobjs[:] = subdiv_cubes(sp.cobjs)
    return sp


def _try_load_model(ms: ModelSpec, sp: SceneParse, scene_path: str,
                    layer: CobjLayer, xf: Xform, add_cobj) -> bool:
    """'O' model load: resolve the file next to the scene or the reference
    layout; extract polygon cobjs at group_cobjs_level<4.  Missing model
    files are nonfatal (reference prints and skips,
    build_world.cpp:1446-1450), and so is a file that fails to parse: the
    model loads no cobjs and `ms.loaded` is False, as in the JAX package.
    `.model3d.npz` caches load directly; every other format dispatches
    through `read_mesh_formats.load_model`."""
    from .model3d import model_to_cobjs, Model3d
    from .read_mesh_formats import LOAD_ERRORS, load_model

    cands = [ms.filename,
             os.path.join(os.path.dirname(scene_path), ms.filename),
             os.path.join(os.path.dirname(os.path.dirname(scene_path)),
                          ms.filename)]
    fn = next((c for c in cands if os.path.exists(c)), None)
    if fn is None or ms.group_cobjs_level >= 4:
        return fn is not None
    try:
        if fn.lower().endswith((".model3d", ".model3d.npz", ".npz")):
            # binary model cache (model3d.cpp cache path; ours is the
            # Model3d._asdict() npz written by load_obj)
            with np.load(fn) as z:
                model = Model3d(**{k: z[k] for k in Model3d._fields})
        else:
            model = load_model(fn)
        cobjs = model_to_cobjs(model).cobjs
    except LOAD_ERRORS:
        return False
    raw = []
    for rc in cobjs:
        raw.append(tuple(tuple(p) for p in rc.pts))
        pts = tuple(xf.xform_pos(tuple(p)) for p in rc.pts)
        add_cobj(COLL_POLYGON, pts[0], r1=0.0, pts=pts)
    ms.cobj_pts = raw    # model-space pts kept for 'Z' re-instancing
    return True


def _axis_angle_matrix(axis, angle_deg):
    a = np.asarray(axis, np.float64)
    n = np.linalg.norm(a)
    if n < 1e-12 or angle_deg == 0.0:
        return np.eye(3)
    a = a / n
    th = np.radians(angle_deg)
    c, s = np.cos(th), np.sin(th)
    K = np.array([[0, -a[2], a[1]], [a[2], 0, -a[0]], [-a[1], a[0], 0]])
    return np.eye(3) * c + s * K + (1 - c) * np.outer(a, a)


def _instance_model_cobjs(ms: ModelSpec, tr, sp: SceneParse,
                          layer: CobjLayer, xf: Xform, add_cobj) -> None:
    """'Z'/transform_array placements re-instance the model's collision
    polygons under the placement transform (model3d_xform_t semantics,
    build_world.cpp:1468-1546: rotate about axis, scale, translate),
    composed with the active scene transform — without this, physics
    only collides with the 'O' identity copy while every placed instance
    is a ghost."""
    pts_list = getattr(ms, "cobj_pts", None)
    if not pts_list:
        return
    tv, scale, axis, angle, lvl, _vsp = (tuple(tr) + (0, 0.0))[:6]
    if lvl is not None and lvl >= 4:
        return
    R = _axis_angle_matrix(axis or (0.0, 0.0, 1.0), angle or 0.0)
    sc = scale if scale else 1.0
    for pts in pts_list:
        newpts = tuple(
            xf.xform_pos(tuple(R @ np.asarray(p, np.float64) * sc
                               + np.asarray(tv, np.float64)))
            for p in pts)
        add_cobj(COLL_POLYGON, newpts[0], r1=0.0, pts=newpts)


# ---------------------------------------------------------------------------
# packing into the physics SoA

def _resolve_shape_groups(parse: SceneParse) -> list:
    """Apply CSG negative-shape subtraction (csg.cpp semantics) before
    packing: negative cubes carve positive cubes."""
    negatives = [c for c in parse.cobjs if c.negative]
    if not negatives:
        return list(parse.cobjs)
    from .csg import subtract_cube
    out = []
    for c in parse.cobjs:
        if c.negative:
            continue
        pieces = [c]
        for neg in negatives:
            if neg.shape != COLL_CUBE or c.shape != COLL_CUBE:
                continue
            pieces = [q for p in pieces for q in subtract_cube(p, neg)]
        out.extend(pieces)
    return out


def pack_cobjs(parse: SceneParse, capacity: int | None = None,
               apply_csg: bool = True,
               device: torch.device | str = "cuda") -> CobjSet:
    """Pack parsed cobjs into the padded SoA (capacity a multiple of 128,
    as the JAX package pads)."""
    cobj_list = _resolve_shape_groups(parse) if apply_csg else \
        [c for c in parse.cobjs if not c.negative]
    n = len(cobj_list)
    if capacity is None:
        capacity = max(128, -(-n // 128) * 128)
    shape = np.zeros(capacity, np.int32)
    p1 = np.zeros((capacity, 3), np.float32)
    p2 = np.zeros((capacity, 3), np.float32)
    r1 = np.zeros(capacity, np.float32)
    r2 = np.zeros(capacity, np.float32)
    npts = np.zeros(capacity, np.int32)
    pts = np.zeros((capacity, 4, 3), np.float32)
    pnorm = np.zeros((capacity, 3), np.float32)
    elas = np.zeros(capacity, np.float32)
    fric = np.zeros(capacity, np.float32)
    col = np.ones((capacity, 4), np.float32)
    spec = np.zeros(capacity, np.float32)
    shine = np.ones(capacity, np.float32)
    movable = np.zeros(capacity, bool)
    platform_id = np.full(capacity, -1, np.int32)
    density = np.ones(capacity, np.float32)
    metalness = np.zeros(capacity, np.float32)
    damage = np.zeros(capacity, np.float32)
    light_atten = np.zeros(capacity, np.float32)
    refract_ix = np.ones(capacity, np.float32)
    destroy = np.zeros(capacity, np.int32)
    for i, c in enumerate(cobj_list[:capacity]):
        shape[i] = c.shape
        p1[i] = c.p1
        r1[i] = c.r1
        r2[i] = c.r2
        elas[i] = c.layer.elasticity
        fric[i] = c.layer.friction
        col[i] = c.layer.color
        spec[i] = c.layer.specular
        shine[i] = c.layer.shininess
        movable[i] = c.movable
        platform_id[i] = c.platform_id
        density[i] = c.layer.density
        metalness[i] = c.layer.metalness
        damage[i] = c.layer.damage
        light_atten[i] = c.layer.light_atten
        refract_ix[i] = c.layer.refract_ix
        destroy[i] = c.destroy
        if c.shape == COLL_POLYGON:
            npts[i] = len(c.pts)
            for k, p in enumerate(c.pts[:4]):
                pts[i, k] = p
            pnorm[i] = _poly_normal(c.pts)
        elif c.shape == COLL_TORUS:
            d = np.asarray(c.p2)
            l = np.linalg.norm(d)
            p2[i] = d / l if l > 0 else (0.0, 0.0, 1.0)
        else:
            p2[i] = c.p2
    cols = (shape, p1, p2, r1, r2, npts, pts, pnorm, elas, fric, movable,
            col[:, 0].copy(), col[:, 1].copy(), col[:, 2].copy(),
            col[:, 3].copy(), spec, shine, platform_id, density, metalness,
            damage, light_atten, refract_ix, destroy)
    return CobjSet(*(torch.as_tensor(a, device=device) for a in cols))


def load_cobjs(path: str, sphere_gen_seed: int = 0,
               device: torch.device | str = "cuda") -> CobjSet:
    return pack_cobjs(parse_coll_obj_file(path, sphere_gen_seed), device=device)

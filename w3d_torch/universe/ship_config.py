"""Parser for the reference's $-sectioned ship-definition files
(`universe/ship_defs*.txt`), the format read by `ship_config.cpp`
(`ship_defs_file_reader::parse_command` ship_config.cpp:244-720, field
orders `us_class::read_from_ifstream` :856 and
`us_weapon::read_from_ifstream` :952).

Produces structured ship classes (all 40 USC_* ids), weapons (42
UWEAP_* ids incl. beam params), per-class weapon loadouts with firing
points, per-class collision geometry ($SHIP_CYLINDER/CUBE/...), fleets,
ship-add/build specs and the global scene settings — with the
reference's unit conversions applied (÷1000 world scaling,
TICKS_PER_SECOND=40 for times, $SPEED_SCALE folded into accel/decel/
max_speed at read order, ship_config.cpp:869-882).

`ship_class_table` maps the parsed classes onto the 9-column simulation
table consumed by `universe.ships` (accel, max_speed, armor, shields,
weapon range/damage/cooldown, radius, shield regen).  Port of
`3dworld_tpu/universe/ship_config.py`, host code, copied whole.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np

TICKS_PER_SECOND = 40.0  # 3DWorld.h:61

# enum name tables (ship_config.cpp:723-730)
SHIP_IDS = ("USC_FIGHTER USC_X1EXTREME USC_FRIGATE USC_DESTROYER "
            "USC_LCRUISER USC_HCRUISER USC_BCRUISER USC_ENFORCER USC_CARRIER "
            "USC_ARMAGEDDON USC_SHADOW USC_DEFSAT USC_STARBASE USC_BCUBE "
            "USC_BSPHERE USC_BTCUBE USC_BSPH_SM USC_BSHUTTLE USC_TRACTOR "
            "USC_GUNSHIP USC_NIGHTMARE USC_DWCARRIER USC_DWEXTERM USC_WRAITH "
            "USC_ABOMIN USC_REAPER USC_DEATH_ORB USC_SUPPLY USC_ANTI_MISS "
            "USC_JUGGERNAUT USC_SAUCER USC_SAUCER_V2 USC_MOTHERSHIP "
            "USC_HUNTER USC_SEIGE USC_COLONY USC_ARMED_COL USC_HW_COL "
            "USC_STARPORT USC_HW_SPORT").split()
WEAP_IDS = ("UWEAP_NONE UWEAP_TARGET UWEAP_QUERY UWEAP_RENAME UWEAP_DESTROY "
            "UWEAP_PBEAM UWEAP_EBEAM UWEAP_REPULSER UWEAP_TRACTORB "
            "UWEAP_G_HOOK UWEAP_LRCPA UWEAP_ENERGY UWEAP_ATOMIC UWEAP_ROCKET "
            "UWEAP_NUKEDEV UWEAP_TORPEDO UWEAP_EMP UWEAP_PT_DEF UWEAP_DFLARE "
            "UWEAP_CHAFF UWEAP_FIGHTER UWEAP_B_BAY UWEAP_CRU_BAY "
            "UWEAP_SOD_BAY UWEAP_BOARDING UWEAP_NM_BAY UWEAP_RFIRE "
            "UWEAP_FUSCUT UWEAP_SHIELDD UWEAP_THUNDER UWEAP_ESTEAL "
            "UWEAP_WRAI_BAY UWEAP_STAR UWEAP_HUNTER UWEAP_DEATHORB "
            "UWEAP_LITNING UWEAP_INFERNO UWEAP_PARALYZE UWEAP_MIND_C "
            "UWEAP_SAUC_BAY UWEAP_SEIGEC UWEAP_HYPER").split()
EXP_IDS = ("ETYPE_NONE ETYPE_FIRE ETYPE_NUCLEAR ETYPE_ENERGY ETYPE_ATOMIC "
           "ETYPE_PLASMA ETYPE_EMP ETYPE_STARB ETYPE_FUSION ETYPE_EBURST "
           "ETYPE_ESTEAL ETYPE_ANIM_FIRE ETYPE_SIEGE ETYPE_FUSION_ROT "
           "ETYPE_PART_CLOUD ETYPE_PC_ICE ETYPE_PBALL").split()
ALIGN_IDS = "NEUTRAL PLAYER GOV PIRATE RED BLUE ORANGE PURPLE".split()
AI_IDS = ("AI_IGNORE AI_RETREAT AI_ATT_WAIT AI_ATT_ENEMY AI_ATT_ALL "
          "AI_SEEKING AI_NONE").split()
TARGET_IDS = "TARGET_CLOSEST TARGET_ATTACKER TARGET_LAST TARGET_PARENT".split()
AST_IDS = ("AS_MODEL_SPHERE AS_MODEL_ROCK1 AS_MODEL_ROCK2 AS_MODEL_HMAP "
           "AS_MODEL_VOXEL AS_MODEL_SHADER").split()
NUM_US_CLASS = len(SHIP_IDS)
NUM_ALIGNMENT = len(ALIGN_IDS)

_SHIP_M = {n: i for i, n in enumerate(SHIP_IDS)}
_WEAP_M = {n: i for i, n in enumerate(WEAP_IDS)}
_EXP_M = {n: i for i, n in enumerate(EXP_IDS)}
_ALIGN_M = {n: i for i, n in enumerate(ALIGN_IDS)}
_AI_M = {n: i for i, n in enumerate(AI_IDS)}
_TARGET_M = {n: i for i, n in enumerate(TARGET_IDS)}
_AST_M = {n: i for i, n in enumerate(AST_IDS)}

# the 36-name color map of string_to_color_map_t::populate
# (ship_config.cpp:105-116; values 3DWorld.h:1264-1309)
COLORS = {
    "RED": (1, 0, 0, 1), "GREEN": (0, 1, 0, 1), "BLUE": (0, 0, 1, 1),
    "BLACK": (0, 0, 0, 1), "WHITE": (1, 1, 1, 1), "CYAN": (0, 1, 1, 1),
    "MAGENTA": (1, 0, 1, 1), "YELLOW": (1, 1, 0, 1),
    "LT_RED": (1, .58, .58, 1), "DK_RED": (.7, 0, 0, 1),
    "LT_GREEN": (.58, 1, .58, 1), "MED_GREEN": (.2, .7, .2, 1),
    "DK_GREEN": (0, .7, 0, 1), "LT_BLUE": (.58, .58, 1, 1),
    "DK_BLUE": (0, 0, .7, 1), "BROWN": (.6, .25, .1, 1),
    "DK_BROWN": (.3, .15, .08, 1), "LT_BROWN": (.6, .4, .2, 1),
    "GRAY": (.5, .5, .5, 1), "LT_GRAY": (.75, .75, .75, 1),
    "DK_GRAY": (.25, .25, .25, 1), "GRAY_BLACK": (.1, .1, .1, 1),
    "BKGRAY": (.05, .05, .05, 1), "OLIVE": (.3, .4, .2, 1),
    "PURPLE": (.5, 0, .6, 1), "ORANGE": (1, .5, 0, 1),
    "PINK": (1, .5, .5, 1), "GOLD": (.7, .45, .05, 1),
    "BRASS": (.7, .65, .25, 1), "BRONZE": (.52, .23, .17, 1),
    "ALPHA0": (1, 1, 1, 0), "WHITE05": (1, 1, 1, .5),
    "DKER_GRAY": (.18, .18, .18, 1), "GRAY06": (.6, .6, .6, 1),
    "ORG_YEL": (1, .9, 0, 1), "BT_BLUE": (.7, .7, 1, 1),
}

# $SHIP numeric fields, reference read order (ship_config.cpp:859-866)
SHIP_FIELDS = ("kcost ncrew nengines radius cr_scale mass cargo exp_scale "
               "accel decel roll_rate max_speed max_turn stability "
               "max_shields max_armor shield_re armor_re max_t hull_str "
               "damage_abs min_att_dist min_app_dist sensor_dist fire_dist "
               "stray_dist reversible stoppable has_hyper has_fast_speed "
               "mpredict has_cloak regen_fighters regen_ammo regen_crew "
               "parallel_fire symmetric self_shadow cont_frag for_boarding "
               "can_board orbiting_dock dynamic_cobjs uses_tdir emits_light "
               "engine_lights suicides kamikaze no_disable uses_mesh2d "
               "turreted weap_spread shield_sects draw_passes exp_disint "
               "ddelay rdelay").split()

# $WEAP numeric fields (ship_config.cpp:955-959)
WEAP_FIELDS = ("cost ammo_cost radius c_radius bradius damage fire_delay "
               "firing_error regen_time range speed seek_dist def_ammo "
               "nshots lifetime btime max_t mass w_mass a_mass force f_inv "
               "armor preference hit_proj hit_all c2_flag no_coll no_exp_dam "
               "const_dam no_ffire is_beam secondary hyper_fire point_def "
               "is_decoy ignores_shields shield_d_only no_light "
               "parallel_fire turreted auto_orient no_ship_vel det_on_exp "
               "symmetric is_fighter do_regen").split()


@dataclass
class UsClass:
    """~ us_class (ship.h:503) after unit conversion."""
    sclass: int = -1
    name: str = ""
    fields: dict = field(default_factory=dict)
    base_color: tuple = (1, 1, 1, 1)
    engine_color: tuple = (1, 1, 1, 1)
    exp_type: int = 0
    exp_subtype: int = 0
    weapons: list = field(default_factory=list)   # (wclass, num, ammo, pts)
    cobjs: list = field(default_factory=list)     # (kind, params...)
    mesh_params: tuple | None = None
    death_delay: float = 0.0
    regen_delay: float = 0.0

    def __getattr__(self, k):
        try:
            return self.__dict__["fields"][k]
        except KeyError:
            raise AttributeError(k)


@dataclass
class UsWeapon:
    """~ us_weapon (ship.h:562) after unit conversion."""
    wclass: int = -1
    name: str = ""
    fields: dict = field(default_factory=dict)
    ammo_type: int = 0
    exp_type: int = 0
    beam: dict | None = None                      # $WBEAM params

    def __getattr__(self, k):
        try:
            return self.__dict__["fields"][k]
        except KeyError:
            raise AttributeError(k)


@dataclass
class Fleet:
    name: str = ""
    multiplier: int = 0
    align: int = 0
    ai_type: int = 0
    targ_type: int = 0
    rgen_dist: float = 0.0
    pos: tuple = (0.0, 0.0, 0.0)
    counts: tuple = ()
    flagship: tuple | None = None    # (stray_dist, ship_id)


@dataclass
class ShipDefs:
    """Full parse result of a ship_def_file tree."""
    sclasses: dict = field(default_factory=dict)     # id -> UsClass
    weapons: dict = field(default_factory=dict)      # id -> UsWeapon
    fleets: list = field(default_factory=list)
    add_ships: list = field(default_factory=list)    # $ADD_SHIP entries
    build_types: dict = field(default_factory=dict)  # align -> [class ids]
    team_credits: dict = field(default_factory=dict)
    player: tuple | None = None                      # (ship_id, align)
    player_weapons: list = field(default_factory=list)
    ship_names: list = field(default_factory=list)
    asteroids: list = field(default_factory=list)
    comets: list = field(default_factory=list)
    black_holes: list = field(default_factory=list)
    rand_spawns: list = field(default_factory=list)  # ($ALIGN under RAND_SPAWN)
    globals: dict = field(default_factory=dict)


class _Tokens:
    """Whitespace token stream with '#'-to-EOL comments and quoted
    strings (read_string, ship_config.cpp:750-780)."""

    def __init__(self, text: str):
        self.toks: list[str] = []
        for line in text.splitlines():
            i, n, out = 0, len(line), []
            while i < n:
                c = line[i]
                if c in " \t":
                    i += 1
                    continue
                if c == "#":
                    break
                if c == '"':
                    j = line.find('"', i + 1)
                    if j < 0:
                        j = n
                    out.append(line[i:j + 1])
                    i = j + 1
                else:
                    j = i
                    while j < n and line[j] not in " \t":
                        j += 1
                    tok = line[i:j]
                    if "#" in tok:          # glued comment: 0.2#foo
                        tok = tok[:tok.index("#")]
                        if tok:
                            out.append(tok)
                        break
                    out.append(tok)
                    i = j
            self.toks.extend(out)
        self.pos = 0

    def peek(self):
        return self.toks[self.pos] if self.pos < len(self.toks) else None

    def next(self):
        t = self.peek()
        if t is None:
            raise ValueError("unexpected end of ship defs")
        self.pos += 1
        return t

    def number(self):
        return float(self.next())

    def integer(self):
        return int(self.next())

    def try_number(self):
        t = self.peek()
        if t is None:
            return None
        try:
            v = float(t)
        except ValueError:
            return None
        self.pos += 1
        return v

    def string(self):
        t = self.next()
        if not (t.startswith('"')):
            raise ValueError(f"expected quoted string, got {t}")
        return t.strip('"')

    def enum(self, m, what):
        t = self.next()
        if t not in m:
            raise ValueError(f"unknown {what}: {t}")
        return m[t]

    def point(self):
        return (self.number(), self.number(), self.number())

    def color(self):
        """4 floats (RGBA) or a color name (read_color,
        ship_config.cpp:124-135)."""
        v = self.try_number()
        if v is not None:
            return (v, self.number(), self.number(), self.number())
        t = self.next()
        if t not in COLORS:
            raise ValueError(f"color '{t}' not recognized")
        return COLORS[t]


def _read_counts(tk: _Tokens):
    return tuple(tk.integer() for _ in range(NUM_US_CLASS))


def parse_ship_defs(path: str, defs: ShipDefs | None = None) -> ShipDefs:
    """Parse one ship_def_file (recursing into $INCLUDE like
    ship_defs_file_reader::read_file, ship_config.cpp:790-850).  Include
    paths resolve as given first (reference behavior: relative to CWD),
    then relative to the including file's directory."""
    d = defs if defs is not None else ShipDefs()
    with open(path) as f:
        tk = _Tokens(f.read())

    speed_scale = d.globals.get("speed_scale", 1.0)
    cur_ship: UsClass | None = None     # $SHIP_WEAP target
    player_mode = False
    pend_pts: list = []
    add_mode = None                     # SHIP_ADD_INIT/GEN/RAND_SPAWN state

    def conv_ship(f: dict):
        # unit conversions, ship_config.cpp:869-882
        for k in ("accel", "decel", "max_speed"):
            f[k] *= speed_scale
        for k in ("radius", "accel", "decel", "roll_rate", "max_speed",
                  "max_turn", "stray_dist"):
            f[k] /= 1000.0
        for k in ("shield_re", "armor_re"):
            f[k] /= TICKS_PER_SECOND
        f["cost"] = 1000.0 * f.pop("kcost")

    def conv_weap(f: dict):
        # ship_config.cpp:961-971
        for k in ("radius", "bradius", "range", "speed", "force"):
            f[k] /= 1000.0
        for k in ("fire_delay", "lifetime", "regen_time"):
            f[k] *= TICKS_PER_SECOND
        f["btime"] = f["btime"] * TICKS_PER_SECOND
        f["seek_dist"] *= f["radius"]
        f["c_radius"] *= f["radius"]
        if f["range"] == 0.0:
            f["range"] = f["speed"] * f["lifetime"]   # us_weapon::setup

    while True:
        cmd = tk.peek()
        if cmd is None:
            break
        tk.next()
        if cmd == "$END":
            break
        elif cmd == "$INCLUDE":
            inc = tk.next()
            cand = inc if os.path.exists(inc) else \
                os.path.join(os.path.dirname(path), os.path.basename(inc))
            sub_scale = d.globals.get("speed_scale", 1.0)
            parse_ship_defs(cand, d)
            d.globals.setdefault("speed_scale", sub_scale)
        elif cmd == "$SPEED_SCALE":
            speed_scale = tk.number()
            d.globals["speed_scale"] = speed_scale
        elif cmd in ("$GLOBAL_REGEN", "$SHIP_BUILD_DELAY", "$RAND_SEED",
                     "$SPAWN_DIST", "$HYPERSPEED", "$PLAYER_TURN",
                     "$SPAWN_HWORLD", "$PLAYER_ENEMY", "$BUILD_ANY",
                     "$PLAYER_SDIST_SCALE"):
            d.globals[cmd[1:].lower()] = tk.number()
        elif cmd == "$NO_SHIFT_UNIVERSE":
            d.globals["no_shift_universe"] = 1
        elif cmd == "$LAST_PARENT":
            d.globals["last_parent"] = 1
        elif cmd == "$START_POS":
            d.globals["start_pos"] = tk.point()
        elif cmd == "$TEAM_CREDITS":
            a = tk.enum(_ALIGN_M, "alignment")
            d.team_credits[a] = tk.integer()
        elif cmd == "$SHIP":
            sid = tk.enum(_SHIP_M, "ship id")
            c = UsClass(sclass=sid, name=tk.string())
            c.fields = {k: tk.number() for k in SHIP_FIELDS}
            conv_ship(c.fields)
            c.base_color = tk.color()
            c.engine_color = tk.color()
            c.exp_type = tk.enum(_EXP_M, "explosion")
            c.exp_subtype = tk.enum(_EXP_M, "sub_explosion")
            c.death_delay = TICKS_PER_SECOND * c.fields.pop("ddelay")
            rdelay = c.fields.pop("rdelay")
            greg = d.globals.get("global_regen", 0.0)
            c.regen_delay = (c.death_delay + TICKS_PER_SECOND
                             * (rdelay + greg)) if (rdelay > 0 or greg > 0) \
                else 0.0
            d.sclasses[sid] = c
        elif cmd == "$WEAP":
            wid = tk.enum(_WEAP_M, "weapon id")
            w = UsWeapon(wclass=wid, name=tk.string())
            w.fields = {k: tk.number() for k in WEAP_FIELDS}
            conv_weap(w.fields)
            # fighters' ammo is a ship class; others a weapon class
            w.ammo_type = tk.enum(
                _SHIP_M if w.fields["is_fighter"] else _WEAP_M, "ammo")
            w.exp_type = tk.enum(_EXP_M, "explosion")
            d.weapons[wid] = w
        elif cmd == "$WBEAM":
            wid = tk.enum(_WEAP_M, "weapon id")
            beam = {"brc": (tk.color(), tk.color()),
                    "beamc": (tk.color(), tk.color()),
                    "bw_escale": tk.number(),
                    "energy_drain": bool(tk.integer()),
                    "temp_src": bool(tk.integer()),
                    "paralyze": bool(tk.integer()),
                    "mind_control": bool(tk.integer()),
                    "multi_segment": bool(tk.integer())}
            d.weapons[wid].beam = beam
        elif cmd == "$SHIP_WEAP":
            cur_ship = d.sclasses[tk.enum(_SHIP_M, "ship id")]
            player_mode = False
            pend_pts = []
        elif cmd == "$PLAYER_WEAP":
            player_mode = True
            cur_ship = None
            pend_pts = []
        elif cmd == "$WEAP_PT":
            pend_pts = []
            while True:
                v = tk.try_number()
                if v is None:
                    break
                pend_pts.append((v, tk.number(), tk.number()))
        elif cmd == "$ADD":
            wid = tk.enum(_WEAP_M, "weapon id")
            num = tk.try_number()
            ammo = tk.try_number() if num is not None else None
            entry = (wid, int(num) if num is not None else 1,
                     int(ammo) if ammo is not None else None,
                     tuple(pend_pts))
            pend_pts = []
            if player_mode:
                d.player_weapons.append(entry)
            elif cur_ship is not None:
                cur_ship.weapons.append(entry)
            else:
                raise ValueError("$ADD outside $SHIP_WEAP/$PLAYER_WEAP")
        elif cmd == "$MESH_PARAMS":
            sid = tk.enum(_SHIP_M, "ship id")
            d.sclasses[sid].mesh_params = tuple(
                bool(tk.integer()) for _ in range(5))
        elif cmd == "$SHIP_CYLINDER":
            sid = tk.enum(_SHIP_M, "ship id")
            p1, p2 = tk.point(), tk.point()
            r1, r2 = tk.number(), tk.number()
            end_type = tk.integer()
            ds = tk.try_number()
            d.sclasses[sid].cobjs.append(
                ("cylinder", p1, p2, r1, r2, end_type,
                 1.0 if ds is None else ds))
        elif cmd == "$SHIP_CUBE":
            sid = tk.enum(_SHIP_M, "ship id")
            dims = tuple(tk.number() for _ in range(6))
            ds = tk.try_number()
            d.sclasses[sid].cobjs.append(
                ("cube", dims, 1.0 if ds is None else ds))
        elif cmd == "$SHIP_SPHERE":
            sid = tk.enum(_SHIP_M, "ship id")
            c0, r = tk.point(), tk.number()
            ds = tk.try_number()
            d.sclasses[sid].cobjs.append(
                ("sphere", c0, r, 1.0 if ds is None else ds))
        elif cmd == "$SHIP_TORUS":
            sid = tk.enum(_SHIP_M, "ship id")
            c0, ri, ro = tk.point(), tk.number(), tk.number()
            ds = tk.try_number()
            d.sclasses[sid].cobjs.append(
                ("torus", c0, ri, ro, 1.0 if ds is None else ds))
        elif cmd == "$SHIP_BCYLIN":
            sid = tk.enum(_SHIP_M, "ship id")
            p1, p2 = tk.point(), tk.point()
            r1, r2 = tk.number(), tk.number()
            dims = tuple(tk.number() for _ in range(6))
            ds = tk.try_number()
            d.sclasses[sid].cobjs.append(
                ("bcylin", p1, p2, r1, r2, dims, 1.0 if ds is None else ds))
        elif cmd == "$SHIP_BCAPSULE":
            sid = tk.enum(_SHIP_M, "ship id")
            p1, p2, r = tk.point(), tk.point(), tk.number()
            ds = tk.try_number()
            d.sclasses[sid].cobjs.append(
                ("bcapsule", p1, p2, r, 1.0 if ds is None else ds))
        elif cmd == "$SHIP_TRIANGLE":
            sid = tk.enum(_SHIP_M, "ship id")
            d.sclasses[sid].cobjs.append(
                ("triangle", tk.point(), tk.point(), tk.point()))
        elif cmd == "$FLEET":
            fl = Fleet(name=tk.string(), multiplier=tk.integer(),
                       align=tk.enum(_ALIGN_M, "alignment"),
                       ai_type=tk.enum(_AI_M, "ai"),
                       targ_type=tk.enum(_TARGET_M, "target"),
                       rgen_dist=tk.number(), pos=tk.point(),
                       counts=_read_counts(tk))
            stray = tk.try_number()
            if stray is not None:
                fl.flagship = (stray / 1000.0, tk.enum(_SHIP_M, "flagship"))
            for i, cnt in enumerate(fl.counts):
                d.build_types.setdefault(fl.align, []).extend(
                    [i] * (fl.multiplier * cnt))
            d.fleets.append(fl)
        elif cmd == "$SHIP_BUILD":
            t = tk.next()
            aligns = (list(range(NUM_ALIGNMENT)) if t == "ALL"
                      else [_ALIGN_M[t]])
            counts = _read_counts(tk)
            for a in aligns:
                for i, cnt in enumerate(counts):
                    d.build_types.setdefault(a, []).extend([i] * cnt)
        elif cmd in ("$SHIP_ADD_INIT", "$SHIP_ADD_GEN",
                     "$SHIP_ADD_RAND_SPAWN"):
            enabled = bool(tk.integer())
            dmax = tk.number() if cmd == "$SHIP_ADD_RAND_SPAWN" else None
            add_mode = (cmd, enabled, dmax)
            d.globals["allow_add_ship" if cmd == "$SHIP_ADD_GEN"
                      else cmd[1:].lower()] = enabled
        elif cmd == "$ALIGN":
            if add_mode is None:
                raise ValueError("$ALIGN outside ship-add mode")
            a = tk.enum(_ALIGN_M, "alignment")
            num = tk.integer()
            counts = _read_counts(tk)
            d.rand_spawns.append((add_mode[0], add_mode[1], add_mode[2],
                                  a, num, counts))
        elif cmd == "$SHIP_NAMES":
            n = tk.integer()
            d.ship_names = [tk.string() for _ in range(n)]
        elif cmd == "$ADD_SHIP":
            sid = tk.enum(_SHIP_M, "ship id")
            num = tk.integer()
            a = tk.enum(_ALIGN_M, "alignment")
            ai = tk.enum(_AI_M, "ai")
            tg = tk.enum(_TARGET_M, "target")
            guard = bool(tk.integer())
            kam = bool(tk.integer())
            p = tk.try_number()
            pos = (p, tk.number(), tk.number()) if p is not None else None
            d.add_ships.append((sid, num, a, ai, tg, guard, kam, pos))
        elif cmd == "$ADD_ASTEROID":
            num = tk.integer()
            model = tk.enum(_AST_M, "asteroid model")
            rseed, rmin, rmax = tk.number(), tk.number(), tk.number()
            p = tk.try_number()
            pos = (p, tk.number(), tk.number()) if p is not None else None
            d.asteroids.append((num, model, rseed, rmin, rmax, pos))
        elif cmd == "$ADD_COMETS":
            d.comets.append(tuple(tk.number() for _ in range(5)))
        elif cmd == "$BLACK_HOLE":
            d.black_holes.append((tk.point(), tk.number()))
        elif cmd == "$PLAYER":
            d.player = (tk.enum(_SHIP_M, "ship id"),
                        tk.enum(_ALIGN_M, "alignment"))
        else:
            raise ValueError(f"unrecognized command keyword {cmd}")
    return d


def primary_weapon(d: ShipDefs, c: UsClass):
    """Highest-damage non-fighter weapon in the class loadout (the
    simulation's single-weapon abstraction of the full loadout)."""
    best = None
    for (wid, num, ammo, pts) in c.weapons:
        w = d.weapons.get(wid)
        if w is None or w.fields["damage"] <= 0:
            continue
        if best is None or w.fields["damage"] > best.fields["damage"]:
            best = w
    return best


def ship_class_table(d: ShipDefs) -> np.ndarray:
    """[NUM_US_CLASS, 9] simulation table for universe.ships:
    (accel, max_speed, armor, shields, w_range, w_damage,
    w_cooldown_frames, radius, shield_regen)."""
    tbl = np.zeros((NUM_US_CLASS, 9), np.float32)
    for sid, c in d.sclasses.items():
        w = primary_weapon(d, c)
        tbl[sid] = (c.fields["accel"], c.fields["max_speed"],
                    c.fields["max_armor"], c.fields["max_shields"],
                    w.fields["range"] if w else 0.0,
                    w.fields["damage"] if w else 0.0,
                    max(w.fields["fire_delay"], 1.0) if w else 1.0,
                    c.fields["radius"], c.fields["shield_re"])
    return tbl


def ship_part_geometry(d: ShipDefs, max_parts: int = 8):
    """Per-class sphere-approximated part sets from the parsed cobj
    geometry (centers+radii in class-radius units) for the fleet sim's
    multipart collision model (universe.ships PART_OFFSETS)."""
    offs = np.zeros((NUM_US_CLASS, max_parts, 4), np.float32)
    nparts = np.zeros(NUM_US_CLASS, np.int32)
    offs[:, 0] = (0, 0, 0, 1)
    nparts[:] = 1
    for sid, c in d.sclasses.items():
        parts = []
        for g in c.cobjs:
            if g[0] == "sphere":
                (cx, cy, cz), r = g[1], g[2]
                parts.append((cx, cy, cz, r))
            elif g[0] in ("cylinder", "bcapsule"):
                p1, p2 = g[1], g[2]
                r = max(g[3], g[4]) if g[0] == "cylinder" else g[3]
                mid = tuple((a + b) / 2 for a, b in zip(p1, p2))
                parts.append((*mid, r))
            elif g[0] == "cube":
                x1, x2, y1, y2, z1, z2 = g[1]
                parts.append((((x1 + x2) / 2), ((y1 + y2) / 2),
                              ((z1 + z2) / 2),
                              max(x2 - x1, y2 - y1, z2 - z1) / 2))
            elif g[0] == "torus":
                (cx, cy, cz), ri, ro = g[1], g[2], g[3]
                parts.append((cx, cy, cz, ro))
        if parts:
            parts = parts[:max_parts]
            nparts[sid] = len(parts)
            offs[sid, :len(parts)] = parts
    return offs, nparts


def shipped_defs_path(name: str = "ship_defs.txt") -> str:
    """Path to a shipped ship-defs file under the configured asset root
    (W3D_ASSET_ROOT); falls back to a relative path (callers gate on
    os.path.exists when the tree is absent)."""
    from ..utils.assets import asset_path
    return asset_path("universe", name) or os.path.join("universe", name)


def primary_fire_points(d: ShipDefs) -> np.ndarray:
    """[NUM_US_CLASS, 3] firing-point offset of each class's primary
    weapon (first $WEAP_PT of the highest-damage loadout entry), in
    class-radius units, body frame (+x = facing).  Classes without
    explicit points fire from the hull center (zeros)."""
    out = np.zeros((NUM_US_CLASS, 3), np.float32)
    for sid, c in d.sclasses.items():
        best = primary_weapon(d, c)
        if best is None:
            continue
        for (wid, _num, _ammo, pts) in c.weapons:
            if wid == best.wclass and pts:
                out[sid] = pts[0]
                break
    return out

"""Universe combat driven by the FULL parsed ship/weapon tables (port of
`3dworld_tpu/universe/combat.py`).

The reference flies projectiles with travel time and seek
(`u_ship.cpp` fire_weapon -> uobject projectiles; `us_weapon` speed/
seek_dist/lifetime fields, ship.h:562), applies beam weapons as
same-frame ray damage (is_beam + $WBEAM params), launches fighters and
boarding shuttles from bay weapons (UWEAP_FIGHTER/B_BAY/BOARDING...,
is_fighter with a ship-class ammo_type, ship_config.cpp:723-730), shoots
incoming projectiles down with point defense (UWEAP_PT_DEF, point_def
flag), and captures disabled enemies by boarding (`u_ship::board_ship`
u_ship.cpp:2081-2099: shields down + damage >= 0.25 + crew-strength
roll -> `capture_ship` flips alignment).

ONE batched frame over two fixed-capacity SoA pools — the fleet
(universe.ships.FleetState) and a projectile pool — with all weapon
behavior read from gathered table rows:

* per-class weapon SLOTS [C, S]: weapon id / mount count / initial ammo
  / firing point, from the parsed $SHIP_WEAP loadouts;
* hitscan weapons (speed == 0: beams + point defense) resolve the same
  frame; projectile weapons (speed > 0) spawn into the pool with
  velocity, lifetime, seek and blast radius from the weapon row;
* pool slot allocation is a cumsum + searchsorted match (rank of each
  spawner against the running count of free slots) — fixed shapes, no
  host sync;
* fighter bays spawn child ships into dead fleet slots the same way;
* point defense picks each PD ship's nearest interceptable enemy
  projectile (proj_armor > 0) and subtracts its damage until the
  projectile's armor is depleted;
* boarding shuttles (class for_boarding) capture an adjacent disabled
  can_board enemy via the reference's crew-strength roll and flip its
  alignment in place.

The JAX package's scatters with mode="drop" write here into one spare
slot past the end, sliced off after (unique targets otherwise, so the
result does not depend on the write order); a capture that two boarders
make in one frame goes to the boarder of the higher index, the last
write of the JAX CPU scatter.  Every sum over ships or projectiles is a
dense `torch.sum` (no float atomics).  Each frame's four threefry draws
are an input (`CombatDraws`).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from ..ops.fmath import sqrt32
from .ships import FleetState, AI_IGNORE, AI_NONE, AI_ATT_WAIT, AI_RETREAT, \
    AI_ATT_ENEMY, gram_d2, nearest_enemy, fleet_to, _filled

# ---------------------------------------------------------------------------
# weapon-table columns (values from us_weapon after ship_config's unit
# conversions; see ship_config.WEAP_FIELDS for the source field names)
# ---------------------------------------------------------------------------
WF_DAMAGE = 0          # damage per shot (per frame for fire_delay==0 beams)
WF_FIRE_DELAY = 1      # frames between shots (0 = continuous beam)
WF_RANGE = 2
WF_SPEED = 3           # projectile speed per frame (0 = hitscan)
WF_SEEK_DIST = 4       # seek activation distance (0 = unguided)
WF_LIFETIME = 5        # projectile lifetime in frames
WF_BRADIUS = 6         # blast radius
WF_CRADIUS = 7         # projectile collision radius
WF_PT_DEF = 8          # 1 = point-defense weapon (targets projectiles)
WF_IS_FIGHTER = 9      # 1 = bay weapon (ammo_type is a ship class)
WF_NSHOTS = 10         # shots per fire event (burst -> damage multiplier)
WF_FIRING_ERROR = 11   # direction jitter magnitude
WF_IGNORES_SHIELDS = 12
WF_SHIELD_D_ONLY = 13
WF_PROJ_ARMOR = 14     # projectile hit points (0 = not interceptable)
WF_NO_SHIP_VEL = 15    # 1 = don't inherit the firing ship's velocity
WF_AMMO_CLASS = 16     # ship class spawned by bays (-1 otherwise)
WF_REGEN = 17          # frames per regenerated ammo unit (0 = no regen)
NUM_WF = 18

# class-aux columns (us_class fields the 9-column sim table drops)
CA_NCREW = 0
CA_FOR_BOARDING = 1
CA_CAN_BOARD = 2
CA_FIRE_DIST = 3       # all-weapon engagement gate (world units)
CA_MIN_ATT = 4         # standoff distance in class-radius units
NUM_CA = 5

SEEK_BLEND = 0.3       # per-frame steering blend for seeking projectiles
BOARD_REACH = 1.5      # capture reach in summed-radius units (collision)


class CombatTables(NamedTuple):
    """All parsed parameters the combat step reads (tensors on one
    device)."""

    cls_tbl: torch.Tensor    # [C, 9] ship_config.ship_class_table
    cls_aux: torch.Tensor    # [C, NUM_CA]
    w_tbl: torch.Tensor      # [W, NUM_WF]
    slot_wid: torch.Tensor   # [C, S] weapon id per slot (0 = empty)
    slot_num: torch.Tensor   # [C, S] mount count
    slot_ammo0: torch.Tensor  # [C, S] initial ammo (inf = unlimited)
    slot_pt: torch.Tensor    # [C, S, 3] firing point (class-radius units)


class ProjPool(NamedTuple):
    """Fixed-capacity projectile SoA (~ the reference's uobject
    projectiles, us_weapon ammo objects)."""

    px: torch.Tensor
    py: torch.Tensor
    pz: torch.Tensor
    vx: torch.Tensor
    vy: torch.Tensor
    vz: torch.Tensor
    hp: torch.Tensor        # remaining projectile armor (PD intercepts)
    ttl: torch.Tensor       # frames to live
    dmg: torch.Tensor       # damage on impact (damage * nshots * mounts)
    wid: torch.Tensor       # weapon class id
    team: torch.Tensor
    target: torch.Tensor    # seek target (fleet index)
    alive: torch.Tensor


class CombatState(NamedTuple):
    fleet: FleetState
    proj: ProjPool
    cool: torch.Tensor      # [N, S] per-slot cooldown frames
    ammo: torch.Tensor      # [N, S] remaining ammo (inf = unlimited)
    crew: torch.Tensor      # [N] crew count (boarding strength)
    captured: torch.Tensor  # [N] bool: ship was captured this battle


class CombatDraws(NamedTuple):
    """One frame's draws (a leading [K] axis for K chained frames): the
    JAX step's `jax.random` calls on its four keys."""

    err: torch.Tensor       # [n, S, 3] standard normal: firing error
    spawn: torch.Tensor     # [n*S, 3] standard normal: bay launch offsets
    board1: torch.Tensor    # [n] int in [0, 100): boarder's roll
    board2: torch.Tensor    # [n] int in [0, 100): defender's roll


def draw_combat(frames: int, n: int, slots: int, gen: torch.Generator) -> CombatDraws:
    """`CombatDraws` for `frames` chained frames of `n` ships with `slots`
    weapon slots, from a CPU generator (on the CPU)."""
    i = lambda: torch.randint(0, 100, (frames, n), generator=gen, dtype=torch.int32)
    return CombatDraws(err=torch.randn(frames, n, slots, 3, generator=gen),
                       spawn=torch.randn(frames, n * slots, 3, generator=gen),
                       board1=i(), board2=i())


# ---------------------------------------------------------------------------
# host-side table construction from parsed ShipDefs
# ---------------------------------------------------------------------------

def build_combat_tables(defs, max_slots: int = 8,
                        device: torch.device | str = "cuda") -> CombatTables:
    """ShipDefs -> CombatTables, built on the host and put on `device`."""
    from . import ship_config as SC

    cls_tbl = SC.ship_class_table(defs)
    C = cls_tbl.shape[0]
    W = len(SC.WEAP_IDS)

    w = np.zeros((W, NUM_WF), np.float32)
    w[:, WF_AMMO_CLASS] = -1.0
    for wid, uw in defs.weapons.items():
        f = uw.fields
        w[wid, WF_DAMAGE] = f["damage"]
        w[wid, WF_FIRE_DELAY] = f["fire_delay"]
        w[wid, WF_RANGE] = f["range"]
        w[wid, WF_SPEED] = f["speed"]
        w[wid, WF_SEEK_DIST] = f["seek_dist"]
        w[wid, WF_LIFETIME] = f["lifetime"]
        w[wid, WF_BRADIUS] = f["bradius"]
        w[wid, WF_CRADIUS] = max(f["c_radius"], f["radius"])
        w[wid, WF_PT_DEF] = f["point_def"]
        w[wid, WF_IS_FIGHTER] = f["is_fighter"]
        w[wid, WF_NSHOTS] = max(f["nshots"], 1.0)
        w[wid, WF_FIRING_ERROR] = f["firing_error"]
        w[wid, WF_IGNORES_SHIELDS] = f["ignores_shields"]
        w[wid, WF_SHIELD_D_ONLY] = f["shield_d_only"]
        w[wid, WF_PROJ_ARMOR] = f["armor"]
        w[wid, WF_NO_SHIP_VEL] = f["no_ship_vel"]
        if f["is_fighter"]:
            w[wid, WF_AMMO_CLASS] = float(uw.ammo_type)
        # regen_time is already in frames (parser multiplies by
        # TICKS_PER_SECOND); 0 disables regeneration
        w[wid, WF_REGEN] = (f["regen_time"]
                            if f["do_regen"] and f["regen_time"] > 0 else 0.0)

    aux = np.zeros((C, NUM_CA), np.float32)
    for sid, c in defs.sclasses.items():
        # boarding shuttles ram their target (min_dist=0, u_ship.cpp:1012)
        boarding = c.fields.get("for_boarding", 0.0)
        aux[sid] = (max(c.fields.get("ncrew", 1.0), 1.0),
                    boarding,
                    c.fields.get("can_board", 0.0),
                    c.fields.get("fire_dist", 0.0),
                    0.0 if boarding else c.fields.get("min_att_dist", 0.0))

    S = max_slots
    slot_wid = np.zeros((C, S), np.int32)
    slot_num = np.zeros((C, S), np.float32)
    slot_ammo0 = np.full((C, S), np.inf, np.float32)
    slot_pt = np.zeros((C, S, 3), np.float32)
    for sid, c in defs.sclasses.items():
        # slots in loadout order; overflow drops the lowest-damage extras
        entries = list(c.weapons)
        if len(entries) > S:
            entries.sort(key=lambda e: -w[e[0], WF_DAMAGE])
            entries = entries[:S]
        for s, (wid, num, ammo, pts) in enumerate(entries):
            slot_wid[sid, s] = wid
            slot_num[sid, s] = max(num, 1)
            # explicit $ADD ammo, else num * def_ammo; 0 = unlimited
            init = ammo if ammo is not None else \
                int(max(num, 1) * defs.weapons[wid].fields["def_ammo"]) \
                if wid in defs.weapons else 0
            slot_ammo0[sid, s] = init if init and init > 0 else np.inf
            if pts:
                slot_pt[sid, s] = pts[0]
    t = lambda a: torch.as_tensor(a, device=device)
    return CombatTables(cls_tbl=t(cls_tbl), cls_aux=t(aux), w_tbl=t(w),
                        slot_wid=t(slot_wid), slot_num=t(slot_num),
                        slot_ammo0=t(slot_ammo0), slot_pt=t(slot_pt))


def _host(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def make_combat_state(fleet: FleetState, ct: CombatTables,
                      pool_size: int = 1024) -> CombatState:
    """Wrap a fleet (numpy arrays or tensors) with the combat pools
    (cooldowns, ammo, crew), on the tables' device.  Optional FleetState
    fields are materialized so step_combat never sees None."""
    dev = ct.cls_tbl.device
    fleet = _filled(fleet_to(fleet, dev))
    n = fleet.px.shape[0]
    S = ct.slot_wid.shape[1]
    c = fleet.cls.long()
    P = pool_size
    z = lambda: torch.zeros(P, device=dev)
    zi = lambda: torch.zeros(P, dtype=torch.int32, device=dev)
    proj = ProjPool(px=z(), py=z(), pz=z(), vx=z(), vy=z(), vz=z(), hp=z(), ttl=z(),
                    dmg=z(), wid=zi(), team=zi(), target=zi(),
                    alive=torch.zeros(P, dtype=torch.bool, device=dev))
    return CombatState(fleet=fleet, proj=proj,
                       cool=torch.zeros((n, S), device=dev),
                       ammo=ct.slot_ammo0[c],
                       crew=ct.cls_aux[c, CA_NCREW],
                       captured=torch.zeros(n, dtype=torch.bool, device=dev))


def pad_fleet(f: FleetState, total: int) -> FleetState:
    """Grow a fleet to `total` slots with dead padding ships (host-side,
    numpy out) so fighter bays have room to launch into (the reference
    allocates new u_ship objects; fixed shapes need reserve capacity)."""
    n = len(_host(f.px))
    add = total - n
    if add <= 0:
        return f
    zf = np.zeros(add, np.float32)
    zi = np.zeros(add, np.int32)

    def cat(a, pad):
        return np.concatenate([_host(a), pad])

    return FleetState(
        px=cat(f.px, zf), py=cat(f.py, zf), pz=cat(f.pz, zf),
        vx=cat(f.vx, zf), vy=cat(f.vy, zf), vz=cat(f.vz, zf),
        cls=cat(f.cls, zi), align=cat(f.align, zi),
        armor=cat(f.armor, zf), shields=cat(f.shields, zf),
        cooldown=cat(f.cooldown, zf),
        alive=cat(f.alive, np.zeros(add, bool)),
        ai=cat(f.ai, zi) if f.ai is not None else None,
        attacked=(cat(f.attacked, np.zeros(add, bool))
                  if f.attacked is not None else None),
        dx=cat(f.dx, zf + 1) if f.dx is not None else None,
        dy=cat(f.dy, zf) if f.dy is not None else None,
        dz=cat(f.dz, zf) if f.dz is not None else None,
        state_val=(cat(f.state_val, zf)
                   if f.state_val is not None else None))


def _alloc_slots(want_flat: torch.Tensor, free: torch.Tensor):
    """Match spawners to free pool slots: the r-th spawner (by cumsum
    rank) gets the r-th free slot (searchsorted over the running free
    count, first index at or above the rank).  Returns (slot index per
    spawner, valid mask) with invalid spawners pointed past the end."""
    P = free.shape[0]
    rank = torch.cumsum(want_flat.to(torch.int64), 0)      # 1-indexed
    free_cum = torch.cumsum(free.to(torch.int64), 0)
    slot = torch.searchsorted(free_cum, rank, side="left")
    ok = want_flat & (rank <= free_cum[-1])
    return torch.where(ok, slot, P), ok


def _put(arr: torch.Tensor, idx: torch.Tensor, val: torch.Tensor) -> torch.Tensor:
    """arr with arr[idx[j]] = val[j] for each idx[j] < len(arr); indices
    at len(arr) are dropped (a mode="drop" scatter whose kept indices are
    distinct): they land in one spare row, sliced off."""
    ext = torch.cat([arr, arr[:1]])
    ext[idx] = val.to(arr.dtype)
    return ext[:-1]


class Motion(NamedTuple):
    """A ship's targeting and motion this frame (`step_combat`'s first
    stage), per ship."""

    dd: torch.Tensor         # distance to the target (+1e-9)
    fleeing: torch.Tensor
    has_tgt: torch.Tensor    # a live enemy and willing to engage
    vx: torch.Tensor         # new velocity
    vy: torch.Tensor
    vz: torch.Tensor
    px: torch.Tensor         # new position
    py: torch.Tensor
    pz: torch.Tensor
    ndx: torch.Tensor        # new facing
    ndy: torch.Tensor
    ndz: torch.Tensor


class Fire(NamedTuple):
    """Each weapon slot's parameters and fire decisions this frame, [n, S]
    (and the beams' damage summed per shooter, [n])."""

    wid: torch.Tensor
    wp: torch.Tensor         # [n, S, NUM_WF] weapon rows
    is_bay: torch.Tensor
    is_pd: torch.Tensor
    mxx: torch.Tensor        # muzzle point
    myy: torch.Tensor
    mzz: torch.Tensor
    d_sl: torch.Tensor       # muzzle-to-target distance (+1e-9)
    dmg_slot: torch.Tensor
    beam_fire: torch.Tensor
    pj_fire: torch.Tensor
    bay_fire: torch.Tensor
    beam_norm: torch.Tensor  # [n] per shooter, by damage channel
    beam_arm: torch.Tensor
    beam_sh: torch.Tensor


# the projectile fields a spawn writes, in `proj_spawn`'s order
SPAWN_FIELDS = ("px", "py", "pz", "vx", "vy", "vz", "hp", "ttl", "dmg", "wid", "team",
                "target")


def ship_motion(f: FleetState, ai, attacked, tx, ty, tz, has_tgt, ct: CombatTables) -> Motion:
    """Target approach, standoff and flight of the ships of `f` towards
    their targets at (tx, ty, tz) (u_ship::ai_action target select and
    thrust); per ship."""
    c = f.cls.long()
    accel = ct.cls_tbl[c, 0]
    vmax = ct.cls_tbl[c, 1]
    sh_max = ct.cls_tbl[c, 3]
    rad = ct.cls_tbl[c, 7]
    aux = ct.cls_aux[c]
    f32 = torch.float32
    passive = (ai == AI_IGNORE) | (ai == AI_NONE)
    waiting = (ai == AI_ATT_WAIT) & ~attacked
    has_tgt = has_tgt & ~passive & ~waiting
    dx, dy, dz = tx - f.px, ty - f.py, tz - f.pz
    dd = sqrt32(dx * dx + dy * dy + dz * dz) + 1e-9
    fleeing = (ai == AI_RETREAT) & (f.shields < 0.25 * sh_max + 1e-6)
    # standoff controller: close to min_att_dist (radius units,
    # u_ship.cpp:1943 `radius*specs().min_att_dist`) and hold — ships
    # slow on approach instead of ramming/orbiting at vmax
    # (u_ship.cpp:1156-1158), which is what lets slower-than-ship
    # projectiles (torpedo speed < ship max_speed) connect at all
    min_att = rad * aux[:, CA_MIN_ATT]
    # arrival law: approach speed bounded by what accel can brake over
    # the remaining distance (sqrt(2 a s)), else overshoot oscillation
    gap = dd - min_att
    appr = torch.sign(gap) * torch.minimum(vmax, sqrt32(2.0 * accel * torch.abs(gap)))
    goal = torch.where(fleeing, -vmax, appr) * has_tgt.to(f32)
    gvx = goal * dx / dd
    gvy = goal * dy / dd
    gvz = goal * dz / dd
    a = torch.where(f.alive, accel, 0.0)
    exv, eyv, ezv = gvx - f.vx, gvy - f.vy, gvz - f.vz
    emag = sqrt32(exv * exv + eyv * eyv + ezv * ezv) + 1e-9
    astep = torch.clamp(a / emag, max=1.0)
    vx = f.vx + astep * exv
    vy = f.vy + astep * eyv
    vz = f.vz + astep * ezv
    sp = sqrt32(vx * vx + vy * vy + vz * vz) + 1e-9
    scl = torch.clamp(vmax / sp, max=1.0)
    vx, vy, vz = vx * scl, vy * scl, vz * scl
    px, py, pz = f.px + vx, f.py + vy, f.pz + vz
    ndx = torch.where(has_tgt, dx / dd, f.dx)
    ndy = torch.where(has_tgt, dy / dd, f.dy)
    ndz = torch.where(has_tgt, dz / dd, f.dz)
    return Motion(dd, fleeing, has_tgt, vx, vy, vz, px, py, pz, ndx, ndy, ndz)


def muzzle(ct: CombatTables, c, s, rad, px, py, pz, ndx, ndy, ndz, tx, ty, tz):
    """Slot `s`'s transformed firing point ($WEAP_PT) on ships of class `c`
    and radius `rad` at (px, py, pz) facing (ndx, ndy, ndz), and its
    distance to the target point; `s` is a slot index per row, or a full
    slice for [n, S] (every argument but `c` and `s` then [n, 1])."""
    fwd = ct.slot_pt[c, s, 0] * rad
    mxx = px + fwd * ndx
    myy = py + fwd * ndy
    mzz = pz + fwd * ndz
    d_sl = sqrt32((tx - mxx) ** 2 + (ty - myy) ** 2 + (tz - mzz) ** 2) + 1e-9
    return mxx, myy, mzz, d_sl


def weapon_fire(f: FleetState, m: Motion, cool, ammo, tx, ty, tz, ct: CombatTables) -> Fire:
    """Every slot's readiness, range and fire decision for the ships of
    `f` after `ship_motion`, and the hitscan beams' damage per shooter."""
    c = f.cls.long()
    rad = ct.cls_tbl[c, 7]
    aux = ct.cls_aux[c]
    wid = ct.slot_wid[c]                         # [N, S]
    wp = ct.w_tbl[wid.long()]                    # [N, S, NUM_WF]
    mounts = ct.slot_num[c]
    is_bay = wp[..., WF_IS_FIGHTER] > 0.5
    is_pd = wp[..., WF_PT_DEF] > 0.5
    speed = wp[..., WF_SPEED]
    # distance from the slot's transformed muzzle point ($WEAP_PT)
    col = lambda v: v[:, None]
    mxx, myy, mzz, d_sl = muzzle(ct, c, slice(None), col(rad), col(m.px), col(m.py),
                                 col(m.pz), col(m.ndx), col(m.ndy), col(m.ndz), col(tx),
                                 col(ty), col(tz))
    armed = wid > 0
    ready = armed & f.alive[:, None] & m.has_tgt[:, None] \
        & ~m.fleeing[:, None] & (cool <= 0.0) & (ammo > 0.0)
    # the class fire_dist gates ALL weapon fire (u_ship.cpp:1320:
    # `target_dist > specs().fire_dist -> return`); bay weapons have no
    # range row of their own, so the gate is their entire range check
    fire_gate = torch.where(aux[:, CA_FIRE_DIST] > 0.0, m.dd < aux[:, CA_FIRE_DIST], True)
    in_rng = fire_gate[:, None] & (is_bay | (d_sl < wp[..., WF_RANGE]))
    dmg_slot = wp[..., WF_DAMAGE] * wp[..., WF_NSHOTS] * mounts

    # ---- beams + any hitscan ship weapon (speed == 0) ----
    beam_fire = ready & in_rng & (speed <= 0.0) & ~is_bay & ~is_pd & (dmg_slot > 0.0)
    ig_sh = wp[..., WF_IGNORES_SHIELDS] > 0.5
    sh_only = wp[..., WF_SHIELD_D_ONLY] > 0.5
    b = torch.where(beam_fire, dmg_slot, 0.0)
    beam_norm = torch.sum(torch.where(~ig_sh & ~sh_only, b, 0.0), dim=1)
    beam_arm = torch.sum(torch.where(ig_sh, b, 0.0), dim=1)
    beam_sh = torch.sum(torch.where(sh_only & ~ig_sh, b, 0.0), dim=1)
    pj_fire = ready & in_rng & (speed > 0.0) & ~is_bay
    bay_fire = ready & in_rng & is_bay
    return Fire(wid, wp, is_bay, is_pd, mxx, myy, mzz, d_sl, dmg_slot, beam_fire, pj_fire,
                bay_fire, beam_norm, beam_arm, beam_sh)


def proj_spawn(wp, wid, mxx, myy, mzz, tx, ty, tz, d_sl, err, vx, vy, vz, dmg_slot,
               team, target):
    """The new projectiles' fields (`SPAWN_FIELDS`) from their weapon rows,
    muzzles, targets, firing-error draws `err` [..., 3] and shooters'
    velocities; elementwise over any broadcastable shapes."""
    speed = wp[..., WF_SPEED]
    # direction to target with firing error jitter (us_weapon
    # firing_error; rocket 0.25, torpedo 0.10)
    noise = wp[..., WF_FIRING_ERROR][..., None] * err * 0.2
    ddx = (tx - mxx) / d_sl + noise[..., 0]
    ddy = (ty - myy) / d_sl + noise[..., 1]
    ddz = (tz - mzz) / d_sl + noise[..., 2]
    dn = sqrt32(ddx * ddx + ddy * ddy + ddz * ddz) + 1e-9
    keep_v = 1.0 - wp[..., WF_NO_SHIP_VEL]
    pvx = speed * ddx / dn + keep_v * vx
    pvy = speed * ddy / dn + keep_v * vy
    pvz = speed * ddz / dn + keep_v * vz
    hp = torch.where(wp[..., WF_PROJ_ARMOR] > 0.0, wp[..., WF_PROJ_ARMOR], 1e9)
    ttl = torch.clamp(wp[..., WF_LIFETIME], min=1.0)
    return (mxx, myy, mzz, pvx, pvy, pvz, hp, ttl, dmg_slot, wid, team, target)


def bay_child(ct: CombatTables, child_cls, px, py, pz, vx, vy, vz, rad, align,
              ndx, ndy, ndz, spawn):
    """The fleet fields of fighters launched from parents at (px, py, pz)
    with the launch-offset draws `spawn` [m, 3], per launch, and their
    [m, S] cooldowns, ammo, crew and captured flags."""
    cc = child_cls.long()
    m = child_cls.shape[0]
    dev = child_cls.device
    launch_off = 1.5 * rad[:, None] * spawn
    ones = torch.ones(m, dtype=torch.bool, device=dev)
    fields = dict(px=px + launch_off[:, 0], py=py + launch_off[:, 1], pz=pz + launch_off[:, 2],
                  vx=vx, vy=vy, vz=vz, cls=child_cls, align=align,
                  armor=ct.cls_tbl[cc, 2], shields=ct.cls_tbl[cc, 3], alive=ones,
                  ai=torch.full((m,), AI_ATT_ENEMY, dtype=torch.int32, device=dev),
                  attacked=~ones, dx=ndx, dy=ndy, dz=ndz,
                  state_val=torch.zeros(m, device=dev))
    return (fields, torch.zeros((m, ct.slot_wid.shape[1]), device=dev),
            ct.slot_ammo0[cc], ct.cls_aux[cc, CA_NCREW], ~ones)


def pd_targets(pxn, pyn, pzn, align, alive, cool, fi: Fire, pr: ProjPool):
    """Point defence: each PD-ready ship's nearest interceptable enemy
    projectile of `pr` in range (a row per ship, a column per
    projectile).  Returns (target column, has one, damage dealt)."""
    f32 = torch.float32
    pd_rangev = torch.where(fi.is_pd, fi.wp[..., WF_RANGE], 0.0).amax(dim=1)   # [N]
    pd_dmg = torch.where(fi.is_pd, fi.dmg_slot, 0.0).amax(dim=1)
    pd_ready = (fi.is_pd & (cool <= 0.0)).any(dim=1) & alive
    exp = pxn[:, None] - pr.px[None, :]
    eyp = pyn[:, None] - pr.py[None, :]
    ezp = pzn[:, None] - pr.pz[None, :]
    d2p = exp * exp + eyp * eyp + ezp * ezp      # [N, P]
    interceptable = pr.alive[None, :] & (pr.hp[None, :] < 1e8) \
        & (pr.team[None, :] != align[:, None]) \
        & (d2p < (pd_rangev ** 2)[:, None]) & pd_ready[:, None]
    d2pi = torch.where(interceptable, d2p, float("inf"))
    pd_min, pd_tgt = torch.min(d2pi, dim=1)
    pd_has = torch.isfinite(pd_min)
    return pd_tgt, pd_has, pd_has.to(f32) * pd_dmg


def proj_flight(pr: ProjPool, proj_hp, tpx, tpy, tpz, t_alive, ct: CombatTables):
    """Seek towards each projectile's target at (tpx, tpy, tpz) and
    integrate; per projectile.  Returns (weapon rows, new velocity, new
    position, ttl, alive)."""
    pw = ct.w_tbl[pr.wid.long()]                 # [P, NUM_WF]
    sdx, sdy, sdz = tpx - pr.px, tpy - pr.py, tpz - pr.pz
    sd = sqrt32(sdx * sdx + sdy * sdy + sdz * sdz) + 1e-9
    seeking = (pw[:, WF_SEEK_DIST] > 0.0) & (sd < pw[:, WF_SEEK_DIST]) & t_alive & pr.alive
    pspeed = sqrt32(pr.vx ** 2 + pr.vy ** 2 + pr.vz ** 2) + 1e-9
    bvx = pr.vx / pspeed * (1 - SEEK_BLEND) + SEEK_BLEND * sdx / sd
    bvy = pr.vy / pspeed * (1 - SEEK_BLEND) + SEEK_BLEND * sdy / sd
    bvz = pr.vz / pspeed * (1 - SEEK_BLEND) + SEEK_BLEND * sdz / sd
    bn = sqrt32(bvx * bvx + bvy * bvy + bvz * bvz) + 1e-9
    nvx = torch.where(seeking, pspeed * bvx / bn, pr.vx)
    nvy = torch.where(seeking, pspeed * bvy / bn, pr.vy)
    nvz = torch.where(seeking, pspeed * bvz / bn, pr.vz)
    npx, npy, npz = pr.px + nvx, pr.py + nvy, pr.pz + nvz
    nttl = pr.ttl - 1.0
    p_alive = pr.alive & (nttl > 0.0) & (proj_hp > 0.0)
    return pw, (nvx, nvy, nvz), (npx, npy, npz), nttl, p_alive


def contacts(pxn, pyn, pzn, rad, alive, align, ppx, ppy, ppz, nvx, nvy, nvz, p_alive,
             team, pw):
    """Ship-to-swept-segment distances (a row per ship, a column per
    projectile: nearest point of the old->new segment) and which pairs
    may hit.  Returns (distance, contact & may hit, may hit)."""
    wx = pxn[:, None] - ppx[None, :]             # [N, P] ship - seg start
    wy = pyn[:, None] - ppy[None, :]
    wz = pzn[:, None] - ppz[None, :]
    seg_len2 = nvx * nvx + nvy * nvy + nvz * nvz + 1e-18
    tseg = torch.clamp((wx * nvx[None, :] + wy * nvy[None, :] + wz * nvz[None, :])
                       / seg_len2[None, :], 0.0, 1.0)
    hx = wx - tseg * nvx[None, :]
    hy = wy - tseg * nvy[None, :]
    hz = wz - tseg * nvz[None, :]
    hd = sqrt32(hx * hx + hy * hy + hz * hz)
    contact = hd < (rad[:, None] + pw[None, :, WF_CRADIUS])
    can_hit = alive[:, None] & p_alive[None, :] & (team[None, :] != align[:, None])
    return hd, contact & can_hit, can_hit


def impact_damage(direct_oh, hd, can_hit, hit_any, dmg, pw):
    """Damage from the projectiles' impacts onto the ships of the rows,
    by channel (normal, armor only, shields only): direct damage to the
    contact ship (`direct_oh`, a one-hot row per ship) and blast falloff
    around the detonation point (bradius; enemies only — the reference
    also splashes friendlies, simplified here); each row summed over all
    projectiles."""
    f32 = torch.float32
    direct = direct_oh * (hit_any.to(f32) * dmg)[None, :]   # [N, P]
    br = pw[:, WF_BRADIUS]
    blast = torch.where((br[None, :] > 0.0) & hit_any[None, :] & can_hit
                        & (hd < br[None, :]),
                        dmg[None, :] * (1.0 - hd / (br[None, :] + 1e-9)), 0.0)
    dmat = torch.maximum(direct, blast)          # [N, P]
    pig = pw[:, WF_IGNORES_SHIELDS] > 0.5
    psh = pw[:, WF_SHIELD_D_ONLY] > 0.5
    return (torch.sum(torch.where((~pig & ~psh)[None, :], dmat, 0.0), dim=1),
            torch.sum(torch.where(pig[None, :], dmat, 0.0), dim=1),
            torch.sum(torch.where((psh & ~pig)[None, :], dmat, 0.0), dim=1))


def boarding(ct: CombatTables, c, alive, has_tgt, dd, crew, t_cls, t_shields, t_armor,
             t_captured, t_crew, board1, board2):
    """Boarding shuttles against their targets (board_ship
    u_ship.cpp:2081: shields down, damage >= 0.25, crew-strength roll),
    per shooter; `t_*` are the targets' values.  Returns (attempt, win)."""
    f32 = torch.float32
    tc = t_cls.long()
    rad, trad = ct.cls_tbl[c, 7], ct.cls_tbl[tc, 7]
    shuttle = (ct.cls_aux[c, CA_FOR_BOARDING] > 0.5) & alive & has_tgt
    board_ok = shuttle & (ct.cls_aux[tc, CA_CAN_BOARD] > 0.5) & (t_shields <= 1e-3) \
        & (t_armor < 0.75 * ct.cls_tbl[tc, 2]) & ~t_captured \
        & (dd < BOARD_REACH * (rad + trad) + 1e-6)
    u1 = board1.to(f32)
    u2 = board2.to(f32)
    win = board_ok & (crew * (u1 + 10.0) > t_crew * (u2 + 10.0))
    return board_ok, win


def damage_and_reload(ct: CombatTables, c, shields, armor, alive, dmg_norm, dmg_arm, dmg_sh,
                      attacked, fi: Fire, pd_has, cool0, cool, ammo, new_cls):
    """Damage application (shields first, then armor, then regeneration)
    and the slots' cooldowns, ammo and regen; per ship.  Returns (shields,
    armor, alive, attacked, cooldowns, ammo)."""
    f32 = torch.float32
    sh_max = ct.cls_tbl[c, 3]
    sh_re = ct.cls_tbl[c, 8]
    shd = torch.clamp(shields - dmg_sh, min=0.0)     # shield-only damage
    over = torch.clamp(dmg_norm - shd, min=0.0)
    shd = torch.clamp(shd - dmg_norm, min=0.0)
    armor3 = armor - over - dmg_arm
    alive3 = alive & (armor3 > 0.0)
    attacked = attacked | (dmg_norm + dmg_arm + dmg_sh > 0.0)
    shd = torch.minimum(shd + sh_re * alive3.to(f32), sh_max)

    fired = fi.beam_fire | fi.pj_fire | fi.bay_fire \
        | (fi.is_pd & pd_has[:, None] & (cool0 <= 0.0))
    cool3 = torch.where(fired, torch.clamp(fi.wp[..., WF_FIRE_DELAY], min=1.0),
                        torch.clamp(cool - 1.0, min=0.0))
    ammo0 = ct.slot_ammo0[new_cls.long()]
    ammo3 = torch.where(fired, ammo - 1.0, ammo)
    regen = fi.wp[..., WF_REGEN]
    ammo3 = torch.where((regen > 0.0) & torch.isfinite(ammo0),
                        torch.minimum(ammo3 + 1.0 / torch.clamp(regen, min=1.0), ammo0),
                        ammo3)
    return shd, armor3, alive3, attacked, cool3, ammo3


class Slabs(NamedTuple):
    """How a frame's ships and pool slots are split over ranks: this rank
    holds the `rank`-th of `size` equal contiguous slabs of each, and
    `gather(leaves)` returns each leaf's whole tensor (every rank's slab,
    in rank order).  `WHOLE` is one rank holding everything."""

    rank: int
    size: int
    gather: Callable[[list], list]


WHOLE = Slabs(0, 1, list)

# the events a frame counts (`combat_frames_chained(..., counts=)`) in this
# rank's slots: all of them, and those whose other end (the spawner of a
# projectile or fighter, the PD shot's projectile, the ship a projectile
# hit, the boarder of a captured ship) lies on another rank
COUNTS = ("spawned", "spawned_cross_rank", "launched", "launched_cross_rank", "pd_shots",
          "pd_shots_cross_rank", "impacts", "impacts_cross_rank", "captures",
          "captures_cross_rank")


def _columns(idx_all, amount_all, cols):
    """sum_i [idx_all[i] == col] * amount_all[i] for each of `cols`: the
    columns `cols` of the one-hot product, each summed over all rows in
    row order.  The running sum down the rows (a scan over the outer
    dimension, one column at a time) rounds alike for any set of columns,
    where `torch.sum` splits a column's rows by the number of columns."""
    oh = (idx_all.long()[:, None] == cols[None, :]).to(torch.float32)
    return torch.cumsum(oh * amount_all[:, None], dim=0)[-1]


def _owned_spawns(slot, total: int, lo: int, k: int, S: int):
    """For the slots lo .. lo+k-1 of a pool of `total`: whether a spawn
    lands there, and its spawner's ship, weapon slot and flat index (the
    allocation `slot` gives each of the N*S spawners a slot, or `total`)."""
    src = _put(torch.full((total,), -1, dtype=torch.int64, device=slot.device), slot,
               torch.arange(slot.shape[0], device=slot.device))[lo:lo + k]
    j = src.clamp(min=0)
    return src >= 0, j // S, j % S, j


def step_combat(cs: CombatState, d: CombatDraws, ct: CombatTables, slabs: Slabs = WHOLE,
                tally: dict | None = None) -> CombatState:
    """One combat frame honoring the full parsed tables.  Order matches
    the reference's process_ships: ship AI/motion -> weapon fire (beams
    resolve now; projectiles/fighters spawn) -> point defense ->
    projectile flight + impacts -> damage/capture bookkeeping.

    `cs` holds this rank's slab of the ships (every [N, ...] leaf) and of
    the pool (every [P] leaf) under `slabs`; `d` is the whole frame's
    draws.  Wherever a stage reads other ships or projectiles, the frame
    gathers what it reads (five `slabs.gather` calls) and computes only
    the rank's rows or columns of each pairwise block:

      1. the previous fleet and the pool's live flags: targeting takes
         the rank's [k, N] rows of the distances, boarding reads its
         targets, every rank allocates the pool and fleet slots;
      2. each ship's motion, target, fire masks, beam damage and boarding
         result: the rank sums the beams onto its own victims (its
         [N, k] columns of the one-hot), writes the projectiles and
         fighters that land in its own slots (the spawner's values
         recomputed from what it sent) and picks each ship's winning
         boarder;
      3. the post-spawn fleet and pool: point defence of the rank's ships
         against the whole pool;
      4. each ship's PD target and damage: the rank subtracts them from
         its own projectiles, flies them and finds each one's impact ship
         over all N ships;
      5. the projectiles' flight and impacts: the rank sums the direct
         and blast damage onto its own ships over all P projectiles.

    Only integer work repeats on every rank (the slot allocation, the
    boarding winners).  With one rank the gathers return their leaves.
    `tally` (`COUNTS` keys), when given, adds up the frame's events."""
    R, r, gather = slabs.size, slabs.rank, slabs.gather
    f = _filled(cs.fleet)
    k, S = cs.cool.shape
    pk = cs.proj.px.shape[0]
    N, P = k * R, pk * R
    dev = f.px.device
    f32, i32 = torch.float32, torch.int32
    own = r * k + torch.arange(k, device=dev)
    own_p = r * pk + torch.arange(pk, device=dev)
    c = f.cls.long()
    rad = ct.cls_tbl[c, 7]

    def count(key, events, other_rank):
        if tally is not None:
            tally[key] += events.sum()
            tally[key + "_cross_rank"] += (events & other_rank).sum()

    # ---- targeting + motion (u_ship::ai_action target select/thrust) ----
    (gpx, gpy, gpz, galign, gcls, gsh, garm, gcrew, galive, gcap, gpalive) = gather(
        [f.px, f.py, f.pz, f.align, f.cls, f.shields, f.armor, cs.crew, f.alive, cs.captured,
         cs.proj.alive])
    d2 = gram_d2(f.px, f.py, f.pz, gpx, gpy, gpz)
    tgt, has_tgt = nearest_enemy(f, d2, galign, galive)
    tx, ty, tz = gpx[tgt], gpy[tgt], gpz[tgt]
    m = ship_motion(f, f.ai, f.attacked, tx, ty, tz, has_tgt, ct)
    fi = weapon_fire(f, m, cs.cool, cs.ammo, tx, ty, tz, ct)
    # boarding shuttles against their targets (capture_ship flips
    # alignment below).  A shuttle with a target is alive, and so is its
    # target, so neither is a spawn slot: their post-spawn values are these
    board_ok, win = boarding(ct, c, f.alive, m.has_tgt, m.dd, cs.crew, gcls[tgt], gsh[tgt],
                             garm[tgt], gcap[tgt], gcrew[tgt], d.board1[r * k:(r + 1) * k],
                             d.board2[r * k:(r + 1) * k])

    # ---- beams resolve onto their victims now ----
    (mpx, mpy, mpz, mvx, mvy, mvz, mdx, mdy, mdz, gtgt, gpj, gbay, gbn, gba, gbs, gbok,
     gwin) = gather([m.px, m.py, m.pz, m.vx, m.vy, m.vz, m.ndx, m.ndy, m.ndz, tgt.to(i32),
                     fi.pj_fire, fi.bay_fire, fi.beam_norm, fi.beam_arm, fi.beam_sh, board_ok,
                     win])
    gtgt = gtgt.long()
    dmg_norm = _columns(gtgt, gbn, own)
    dmg_arm = _columns(gtgt, gba, own)
    dmg_sh = _columns(gtgt, gbs, own)

    # ---- projectile spawns (speed > 0) into the rank's pool slots ----
    slot_idx, _ok = _alloc_slots(gpj.reshape(-1), ~gpalive)
    got, i, s, _j = _owned_spawns(slot_idx, P, r * pk, pk, S)
    ci = gcls[i].long()
    wid = ct.slot_wid[ci, s]
    wp = ct.w_tbl[wid.long()]
    ti = gtgt[i]
    mxx, myy, mzz, d_sl = muzzle(ct, ci, s, ct.cls_tbl[ci, 7], mpx[i], mpy[i], mpz[i],
                                 mdx[i], mdy[i], mdz[i], gpx[ti], gpy[ti], gpz[ti])
    dmg_slot = wp[..., WF_DAMAGE] * wp[..., WF_NSHOTS] * ct.slot_num[ci, s]
    vals = proj_spawn(wp, wid, mxx, myy, mzz, gpx[ti], gpy[ti], gpz[ti], d_sl, d.err[i, s],
                      mvx[i], mvy[i], mvz[i], dmg_slot, galign[i], ti.to(i32))
    pr = cs.proj
    pr = pr._replace(**{name: torch.where(got, v.to(getattr(pr, name).dtype),
                                          getattr(pr, name))
                        for name, v in zip(SPAWN_FIELDS, vals)},
                     alive=pr.alive | got)
    count("spawned", got, i // k != r)

    # ---- fighter/boarding bays spawn child ships into dead slots ----
    ship_slot, _bok = _alloc_slots(gbay.reshape(-1), ~galive)
    bgot, bi, bs, bj = _owned_spawns(ship_slot, N, r * k, k, S)
    bci = gcls[bi].long()
    child_cls = torch.clamp(ct.w_tbl[ct.slot_wid[bci, bs].long(), WF_AMMO_CLASS].to(i32),
                            min=0)
    kid, kcool, kammo, kcrew, kcap = bay_child(
        ct, child_cls, mpx[bi], mpy[bi], mpz[bi], mvx[bi], mvy[bi], mvz[bi],
        ct.cls_tbl[bci, 7], galign[bi], mdx[bi], mdy[bi], mdz[bi], d.spawn[bj])
    moved = dict(px=m.px, py=m.py, pz=m.pz, vx=m.vx, vy=m.vy, vz=m.vz, dx=m.ndx, dy=m.ndy,
                 dz=m.ndz)
    f2 = f._replace(**{name: torch.where(bgot, v.to(getattr(f, name).dtype),
                                         moved.get(name, getattr(f, name)))
                       for name, v in kid.items()})
    cool2 = torch.where(bgot[:, None], kcool, cs.cool)
    ammo2 = torch.where(bgot[:, None], kammo, cs.ammo)
    crew2 = torch.where(bgot, kcrew, cs.crew)
    cap2 = torch.where(bgot, kcap, cs.captured)
    count("launched", bgot, bi // k != r)
    # the motion/targeting values computed above remain those of the
    # PRE-SPAWN fleet; spawned ships act from next frame

    # ---- point defense: PD-armed ships intercept enemy projectiles ----
    (fpx, fpy, fpz, falign, falive, ppx, ppy, ppz, php, pteam, pdmg, pwid, palive) = gather(
        [f2.px, f2.py, f2.pz, f2.align, f2.alive, pr.px, pr.py, pr.pz, pr.hp, pr.team,
         pr.dmg, pr.wid, pr.alive])
    pool = pr._replace(px=ppx, py=ppy, pz=ppz, hp=php, team=pteam, alive=palive)
    pd_tgt, pd_has, pd_amt = pd_targets(f2.px, f2.py, f2.pz, f.align, f.alive, cs.cool, fi,
                                        pool)
    gpd_tgt, gpd_amt = gather([pd_tgt.to(i32), pd_amt])
    proj_hp = pr.hp - _columns(gpd_tgt, gpd_amt, own_p)
    count("pd_shots", pd_has, pd_tgt // pk != r)

    # ---- projectile flight: seek + integrate ----
    pt = pr.target.long()
    pw, (nvx, nvy, nvz), (npx, npy, npz), nttl, p_alive = proj_flight(
        pr, proj_hp, fpx[pt], fpy[pt], fpz[pt], falive[pt], ct)

    # ---- impacts: nearest enemy ship within contact distance of the
    # SWEPT segment old->new (projectiles move ~their own contact radius
    # per frame, so an endpoint test tunnels straight through ships); the
    # rank's projectiles against all N ships ----
    hd, hit_mat, can_hit = contacts(fpx, fpy, fpz, ct.cls_tbl[gcls.long(), 7], falive,
                                    falign, pr.px, pr.py, pr.pz, nvx, nvy, nvz, p_alive,
                                    pr.team, pw)
    hit_any = hit_mat.any(dim=0)                 # [pk]
    hdm = torch.where(hit_mat, hd, float("inf"))
    hit_ship = torch.argmin(hdm, dim=0)          # [pk]
    count("impacts", hit_any, hit_ship // k != r)
    # the damage onto the rank's ships from all P projectiles
    gnvx, gnvy, gnvz, gpal, ghit, gship = gather([nvx, nvy, nvz, p_alive, hit_any,
                                                  hit_ship.to(i32)])
    if R > 1:
        hd, _hit, can_hit = contacts(f2.px, f2.py, f2.pz, rad, f2.alive, f2.align, ppx, ppy,
                                     ppz, gnvx, gnvy, gnvz, gpal, pteam, ct.w_tbl[pwid.long()])
    direct = (gship.long()[:, None] == own[None, :]).to(f32).T     # [k, P]
    i_norm, i_arm, i_sh = impact_damage(direct, hd, can_hit, ghit, pdmg,
                                        ct.w_tbl[pwid.long()])
    dmg_norm = dmg_norm + i_norm
    dmg_arm = dmg_arm + i_arm
    dmg_sh = dmg_sh + i_sh
    p_alive = p_alive & ~hit_any

    # ---- boarding: the winning boarder of each captured ship, the last
    # (highest index) of those that board it this frame, as the JAX CPU
    # scatter's last write ----
    boarder = torch.full((N + 1,), -1, dtype=torch.int64, device=dev).scatter_reduce(
        0, torch.where(gwin, gtgt, N), torch.arange(N, device=dev),
        reduce="amax")[r * k:(r + 1) * k]
    took = boarder >= 0
    align3 = torch.where(took, galign[boarder.clamp(min=0)], f2.align)
    cap3 = cap2 | took
    crew3 = torch.where(win, torch.clamp(crew2 * 0.5, min=1.0), crew2)
    # a boarding attempt (successful or not) registers as an attack
    attacked2 = f.attacked | (_columns(gtgt, gbok.to(f32), own) > 0.5)
    count("captures", took, boarder // k != r)

    # ---- damage application: shields first, then armor; cooldowns, ammo ----
    shd, armor3, alive3, attacked2, cool3, ammo3 = damage_and_reload(
        ct, c, f2.shields, f2.armor, f2.alive, dmg_norm, dmg_arm, dmg_sh, attacked2, fi,
        pd_has, cs.cool, cool2, ammo2, f2.cls)

    fleet3 = f2._replace(align=align3, armor=armor3, shields=shd, alive=alive3,
                         attacked=attacked2)
    proj3 = pr._replace(px=npx, py=npy, pz=npz, vx=nvx, vy=nvy, vz=nvz,
                        hp=proj_hp, ttl=nttl, alive=p_alive)
    return CombatState(fleet=fleet3, proj=proj3, cool=cool3, ammo=ammo3,
                       crew=crew3, captured=cap3)


def combat_frames_chained(cs: CombatState, draws: CombatDraws, frames: int,
                          ct: CombatTables, slabs: Slabs = WHOLE,
                          counts: dict | None = None) -> CombatState:
    """`frames` combat frames (the single step in a Python loop that never
    reads a device value back); `draws` carry a leading [frames] axis and
    are the whole frames' draws whatever `slabs` holds.  `counts`, when
    given, adds up the chunk's events (`COUNTS`), read back once after
    the chunk."""
    if cs.fleet.px.shape[0] * slabs.size != draws.board1.shape[1]:
        raise ValueError(f"combat: draws for {draws.board1.shape[1]} ships, the fleet has "
                         f"{cs.fleet.px.shape[0] * slabs.size}")
    tally = None if counts is None else {key: 0 for key in COUNTS}
    for i in range(frames):
        cs = step_combat(cs, CombatDraws(*(t[i] for t in draws)), ct, slabs, tally)
    if counts is not None:
        for key, v in tally.items():
            counts[key] = counts.get(key, 0) + int(v)
    return cs

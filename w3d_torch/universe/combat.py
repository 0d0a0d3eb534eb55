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

from typing import NamedTuple

import numpy as np
import torch

from .ships import FleetState, AI_IGNORE, AI_NONE, AI_ATT_WAIT, AI_RETREAT, \
    AI_ATT_ENEMY, gram_d2, nearest_enemy, sqrt32, fleet_to, _filled

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


def step_combat(cs: CombatState, d: CombatDraws, ct: CombatTables) -> CombatState:
    """One combat frame honoring the full parsed tables.  Order matches
    the reference's process_ships: ship AI/motion -> weapon fire (beams
    resolve now; projectiles/fighters spawn) -> point defense ->
    projectile flight + impacts -> damage/capture bookkeeping."""
    f = cs.fleet
    n = f.px.shape[0]
    S = cs.cool.shape[1]
    P = cs.proj.px.shape[0]
    dev = f.px.device
    f32 = torch.float32
    onehot = lambda i, k: torch.nn.functional.one_hot(i.long(), k).to(f32)

    cls_tbl = ct.cls_tbl
    c = f.cls.long()
    accel = cls_tbl[c, 0]
    vmax = cls_tbl[c, 1]
    sh_max = cls_tbl[c, 3]
    rad = cls_tbl[c, 7]
    sh_re = cls_tbl[c, 8]
    aux = ct.cls_aux[c]                          # [N, NUM_CA]

    ai = f.ai if f.ai is not None else torch.full((n,), AI_ATT_ENEMY, dtype=torch.int32,
                                                  device=dev)
    attacked = f.attacked if f.attacked is not None else torch.zeros(
        n, dtype=torch.bool, device=dev)

    # ---- targeting + motion (u_ship::ai_action target select/thrust) ----
    d2 = gram_d2(f.px, f.py, f.pz)
    tgt, has_tgt = nearest_enemy(f, d2)
    passive = (ai == AI_IGNORE) | (ai == AI_NONE)
    waiting = (ai == AI_ATT_WAIT) & ~attacked
    has_tgt = has_tgt & ~passive & ~waiting
    toh = onehot(tgt, n)                         # [N, N]: row i, target column
    tx, ty, tz = f.px[tgt], f.py[tgt], f.pz[tgt]
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

    # ---- per-slot weapon parameters ----
    wid = ct.slot_wid[c]                         # [N, S]
    wp = ct.w_tbl[wid.long()]                    # [N, S, NUM_WF]
    mounts = ct.slot_num[c]
    is_bay = wp[..., WF_IS_FIGHTER] > 0.5
    is_pd = wp[..., WF_PT_DEF] > 0.5
    speed = wp[..., WF_SPEED]
    # distance from the slot's transformed muzzle point ($WEAP_PT)
    fwd = ct.slot_pt[c][..., 0] * rad[:, None]   # [N, S]
    mxx = px[:, None] + fwd * ndx[:, None]
    myy = py[:, None] + fwd * ndy[:, None]
    mzz = pz[:, None] + fwd * ndz[:, None]
    d_sl = sqrt32((tx[:, None] - mxx) ** 2 + (ty[:, None] - myy) ** 2
                      + (tz[:, None] - mzz) ** 2) + 1e-9
    armed = wid > 0
    ready = armed & f.alive[:, None] & has_tgt[:, None] \
        & ~fleeing[:, None] & (cs.cool <= 0.0) & (cs.ammo > 0.0)
    # the class fire_dist gates ALL weapon fire (u_ship.cpp:1320:
    # `target_dist > specs().fire_dist -> return`); bay weapons have no
    # range row of their own, so the gate is their entire range check
    fire_gate = torch.where(aux[:, CA_FIRE_DIST] > 0.0, dd < aux[:, CA_FIRE_DIST], True)
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
    to_victims = lambda v: torch.sum(toh * v[:, None], dim=0)    # [N] victim channels
    dmg_norm = to_victims(beam_norm)
    dmg_arm = to_victims(beam_arm)
    dmg_sh = to_victims(beam_sh)

    # ---- projectile spawns (speed > 0) ----
    pj_fire = ready & in_rng & (speed > 0.0) & ~is_bay
    slot_idx, ok = _alloc_slots(pj_fire.reshape(-1), ~cs.proj.alive)
    # direction to target with firing error jitter (us_weapon
    # firing_error; rocket 0.25, torpedo 0.10)
    err = wp[..., WF_FIRING_ERROR]
    noise = err[..., None] * d.err * 0.2
    ddx = (tx[:, None] - mxx) / d_sl + noise[..., 0]
    ddy = (ty[:, None] - myy) / d_sl + noise[..., 1]
    ddz = (tz[:, None] - mzz) / d_sl + noise[..., 2]
    dn = sqrt32(ddx * ddx + ddy * ddy + ddz * ddz) + 1e-9
    keep_v = 1.0 - wp[..., WF_NO_SHIP_VEL]
    pvx = speed * ddx / dn + keep_v * vx[:, None]
    pvy = speed * ddy / dn + keep_v * vy[:, None]
    pvz = speed * ddz / dn + keep_v * vz[:, None]

    pr = cs.proj
    put = lambda arr, val: _put(arr, slot_idx, val.expand(n, S).reshape(-1))
    pr = pr._replace(
        px=put(pr.px, mxx), py=put(pr.py, myy), pz=put(pr.pz, mzz),
        vx=put(pr.vx, pvx), vy=put(pr.vy, pvy), vz=put(pr.vz, pvz),
        hp=put(pr.hp, torch.where(wp[..., WF_PROJ_ARMOR] > 0.0,
                                  wp[..., WF_PROJ_ARMOR], 1e9)),
        ttl=put(pr.ttl, torch.clamp(wp[..., WF_LIFETIME], min=1.0)),
        dmg=put(pr.dmg, dmg_slot),
        wid=put(pr.wid, wid),
        team=put(pr.team, f.align[:, None]),
        target=put(pr.target, tgt.to(torch.int32)[:, None]),
        alive=_put(pr.alive, slot_idx, ok),
    )

    # ---- fighter/boarding bays spawn child ships into dead slots ----
    bay_fire = ready & in_rng & is_bay
    ship_slot, _bok = _alloc_slots(bay_fire.reshape(-1), ~f.alive)
    child_cls = torch.clamp(wp[..., WF_AMMO_CLASS].to(torch.int32).reshape(-1), min=0)
    cc = child_cls.long()
    rep = lambda v: v[:, None].expand(n, S).reshape(-1)     # each ship's value per slot
    launch_off = 1.5 * rep(rad)[:, None] * d.spawn
    sput = lambda arr, val: _put(arr, ship_slot, val)
    ones = torch.ones(n * S, dtype=torch.bool, device=dev)
    f2 = f._replace(
        px=sput(px, rep(px) + launch_off[:, 0]),
        py=sput(py, rep(py) + launch_off[:, 1]),
        pz=sput(pz, rep(pz) + launch_off[:, 2]),
        vx=sput(vx, rep(vx)), vy=sput(vy, rep(vy)), vz=sput(vz, rep(vz)),
        cls=sput(f.cls, child_cls),
        align=sput(f.align, rep(f.align)),
        armor=sput(f.armor, cls_tbl[cc, 2]),
        shields=sput(f.shields, cls_tbl[cc, 3]),
        alive=sput(f.alive, ones),
        ai=sput(ai, torch.full((n * S,), AI_ATT_ENEMY, dtype=torch.int32, device=dev)),
        attacked=sput(attacked, ~ones),
        dx=sput(ndx, rep(ndx)), dy=sput(ndy, rep(ndy)), dz=sput(ndz, rep(ndz)),
        state_val=sput(f.state_val, torch.zeros(n * S, device=dev)),
        cooldown=f.cooldown,
    )
    cool2 = sput(cs.cool, torch.zeros((n * S, S), device=dev))
    ammo2 = sput(cs.ammo, ct.slot_ammo0[cc])
    crew2 = sput(cs.crew, ct.cls_aux[cc, CA_NCREW])
    cap2 = sput(cs.captured, ~ones)
    # the motion/targeting values computed above remain those of the
    # PRE-SPAWN fleet; spawned ships act from next frame
    pxn, pyn, pzn = f2.px, f2.py, f2.pz

    # ---- point defense: PD-armed ships intercept enemy projectiles ----
    pd_rangev = torch.where(is_pd, wp[..., WF_RANGE], 0.0).amax(dim=1)   # [N]
    pd_dmg = torch.where(is_pd, dmg_slot, 0.0).amax(dim=1)
    pd_ready = (is_pd & (cs.cool <= 0.0)).any(dim=1) & f.alive
    exp = pxn[:, None] - pr.px[None, :]
    eyp = pyn[:, None] - pr.py[None, :]
    ezp = pzn[:, None] - pr.pz[None, :]
    d2p = exp * exp + eyp * eyp + ezp * ezp      # [N, P]
    interceptable = pr.alive[None, :] & (pr.hp[None, :] < 1e8) \
        & (pr.team[None, :] != f.align[:, None]) \
        & (d2p < (pd_rangev ** 2)[:, None]) & pd_ready[:, None]
    d2pi = torch.where(interceptable, d2p, float("inf"))
    pd_min, pd_tgt = torch.min(d2pi, dim=1)
    pd_has = torch.isfinite(pd_min)
    pd_hit = onehot(pd_tgt, P) * (pd_has.to(f32) * pd_dmg)[:, None]
    proj_hp = pr.hp - torch.sum(pd_hit, dim=0)

    # ---- projectile flight: seek + integrate ----
    pw = ct.w_tbl[pr.wid.long()]                 # [P, NUM_WF]
    pt = pr.target.long()
    tpx, tpy, tpz = pxn[pt], pyn[pt], pzn[pt]
    t_alive = f2.alive[pt]
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

    # ---- impacts: nearest enemy ship within contact distance of the
    # SWEPT segment old->new (projectiles move ~their own contact radius
    # per frame, so an endpoint test tunnels straight through ships) ----
    wx = pxn[:, None] - pr.px[None, :]           # [N, P] ship - seg start
    wy = pyn[:, None] - pr.py[None, :]
    wz = pzn[:, None] - pr.pz[None, :]
    seg_len2 = nvx * nvx + nvy * nvy + nvz * nvz + 1e-18
    tseg = torch.clamp((wx * nvx[None, :] + wy * nvy[None, :] + wz * nvz[None, :])
                       / seg_len2[None, :], 0.0, 1.0)
    hx = wx - tseg * nvx[None, :]
    hy = wy - tseg * nvy[None, :]
    hz = wz - tseg * nvz[None, :]
    hd = sqrt32(hx * hx + hy * hy + hz * hz)
    contact = hd < (rad[:, None] + pw[None, :, WF_CRADIUS])
    can_hit = f2.alive[:, None] & p_alive[None, :] & (pr.team[None, :] != f2.align[:, None])
    hit_mat = contact & can_hit
    hit_any = hit_mat.any(dim=0)                 # [P]
    hdm = torch.where(hit_mat, hd, float("inf"))
    hit_ship = torch.argmin(hdm, dim=0)          # [P]
    # direct damage to the contact ship + blast falloff around the
    # detonation point (bradius; enemies only — the reference also
    # splashes friendlies, simplified here)
    direct = onehot(hit_ship, n).T * (hit_any.to(f32) * pr.dmg)[None, :]   # [N, P]
    br = pw[:, WF_BRADIUS]
    blast = torch.where((br[None, :] > 0.0) & hit_any[None, :] & can_hit
                        & (hd < br[None, :]),
                        pr.dmg[None, :] * (1.0 - hd / (br[None, :] + 1e-9)), 0.0)
    dmat = torch.maximum(direct, blast)          # [N, P]
    pig = pw[:, WF_IGNORES_SHIELDS] > 0.5
    psh = pw[:, WF_SHIELD_D_ONLY] > 0.5
    dmg_norm = dmg_norm + torch.sum(torch.where((~pig & ~psh)[None, :], dmat, 0.0), dim=1)
    dmg_arm = dmg_arm + torch.sum(torch.where(pig[None, :], dmat, 0.0), dim=1)
    dmg_sh = dmg_sh + torch.sum(torch.where((psh & ~pig)[None, :], dmat, 0.0), dim=1)
    p_alive = p_alive & ~hit_any

    # ---- boarding: shuttles capture adjacent disabled enemies ----
    # (board_ship u_ship.cpp:2081: shields down, damage >= 0.25,
    # crew-strength roll; capture_ship flips alignment)
    amax = cls_tbl[c, 2]
    shuttle = (aux[:, CA_FOR_BOARDING] > 0.5) & f2.alive & has_tgt
    board_ok = shuttle & (aux[tgt, CA_CAN_BOARD] > 0.5) & (f.shields[tgt] <= 1e-3) \
        & (f.armor[tgt] < 0.75 * amax[tgt]) & ~cs.captured[tgt] \
        & (dd < BOARD_REACH * (rad + rad[tgt]) + 1e-6)
    u1 = d.board1.to(f32)
    u2 = d.board2.to(f32)
    win = board_ok & (crew2 * (u1 + 10.0) > crew2[tgt] * (u2 + 10.0))
    # the winning boarder of each captured ship: the last (highest index)
    # of those that board it this frame, as the JAX CPU scatter's last write
    boarder = torch.full((n + 1,), -1, dtype=torch.int64, device=dev).scatter_reduce(
        0, torch.where(win, tgt, n), torch.arange(n, device=dev), reduce="amax")[:n]
    took = boarder >= 0
    align3 = torch.where(took, f2.align[boarder.clamp(min=0)], f2.align)
    cap3 = cap2 | took
    crew3 = torch.where(win, torch.clamp(crew2 * 0.5, min=1.0), crew2)
    # a boarding attempt (successful or not) registers as an attack
    attacked2 = attacked | (to_victims(board_ok.to(f32)) > 0.5)

    # ---- damage application: shields first, then armor ----
    shd = f2.shields
    shd = torch.clamp(shd - dmg_sh, min=0.0)     # shield-only damage
    over = torch.clamp(dmg_norm - shd, min=0.0)
    shd = torch.clamp(shd - dmg_norm, min=0.0)
    armor3 = f2.armor - over - dmg_arm
    alive3 = f2.alive & (armor3 > 0.0)
    attacked2 = attacked2 | (dmg_norm + dmg_arm + dmg_sh > 0.0)
    shd = torch.minimum(shd + sh_re * alive3.to(f32), sh_max)

    # ---- cooldowns, ammo, regen ----
    fired = beam_fire | pj_fire | bay_fire | (is_pd & pd_has[:, None] & (cs.cool <= 0.0))
    cool3 = torch.where(fired, torch.clamp(wp[..., WF_FIRE_DELAY], min=1.0),
                        torch.clamp(cool2 - 1.0, min=0.0))
    ammo0 = ct.slot_ammo0[f2.cls.long()]
    ammo3 = torch.where(fired, ammo2 - 1.0, ammo2)
    regen = wp[..., WF_REGEN]
    ammo3 = torch.where((regen > 0.0) & torch.isfinite(ammo0),
                        torch.minimum(ammo3 + 1.0 / torch.clamp(regen, min=1.0), ammo0),
                        ammo3)

    fleet3 = f2._replace(align=align3, armor=armor3, shields=shd, alive=alive3,
                         attacked=attacked2)
    proj3 = pr._replace(px=npx, py=npy, pz=npz, vx=nvx, vy=nvy, vz=nvz,
                        hp=proj_hp, ttl=nttl, alive=p_alive)
    return CombatState(fleet=fleet3, proj=proj3, cool=cool3, ammo=ammo3,
                       crew=crew3, captured=cap3)


def combat_frames_chained(cs: CombatState, draws: CombatDraws, frames: int,
                          ct: CombatTables) -> CombatState:
    """`frames` combat frames (the single step in a Python loop that never
    reads a device value back); `draws` carry a leading [frames] axis."""
    for i in range(frames):
        cs = step_combat(cs, CombatDraws(*(t[i] for t in draws)), ct)
    return cs

"""Ships & space combat: class table, batched physics + AI step (port of
`3dworld_tpu/universe/ships.py`).

The reference defines config-driven ship classes and weapons (`us_class`
ship.h:503, `us_weapon` :562, parsed from ship_def_file by
ship_config.cpp), with per-ship AI (target selection, thrust control,
firing: `u_ship::ai_action` u_ship.cpp:954) updated on its own OMP thread
(Universe_control.cpp:292-300).

The whole fleet is SoA tensors advanced by ONE batched step: thrust toward
the target with max accel/speed clamps, alignment-masked nearest-enemy
targeting via the masked pairwise distance argmin (the Gram form of the
JAX package, whose rounding the argmin and the reaper's alignment
threshold follow), ranged weapon fire with cooldowns (damage is
deterministic; the JAX step's key is unused, so the port's step takes no
draws).  The JAX package's one-hot products that read one row (class
parameters, the target's position) are gathers here; the damage column
sum stays a dense sum (no float atomics).  Chained frames are a Python
loop over the single step that never reads a device value back.

The JAX package draws fleets and belts from threefry keys; here the draws
are inputs (`FleetDraws`, `BeltDraws`, and `fleet_from_defs`' position
draw).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops.fmath import sqrt32

# ship class subset (us_class: accel, max_speed, turn_r, armor, shields,
# weapon range/damage/cooldown) — config-overridable like ship_def_file
SHIP_CLASSES = np.array([
    # accel  vmax   armor shield w_range w_dam w_cool radius shield_re
    (0.002, 0.02, 100.0, 50.0, 0.5, 5.0, 20.0, 0.01, 0.2),   # fighter
    (0.001, 0.012, 400.0, 200.0, 0.8, 15.0, 40.0, 0.03, 0.5),  # cruiser
    (0.0005, 0.008, 1200.0, 600.0, 1.2, 40.0, 80.0, 0.08, 1.0),  # dreadnought
    (0.0015, 0.015, 200.0, 100.0, 0.6, 8.0, 30.0, 0.02, 0.3),  # corvette
    (0.0004, 0.006, 2000.0, 800.0, 1.0, 60.0, 60.0, 0.10, 0.8),  # abomination
    (0.0006, 0.009, 1500.0, 500.0, 1.1, 50.0, 70.0, 0.09, 0.6),  # reaper
    (0.0008, 0.010, 600.0, 300.0, 0.0, 0.0, 1.0, 0.05, 0.5),   # colony ship
], np.float32)
NUM_SHIP_CLASSES = len(SHIP_CLASSES)
CLS_FIGHTER, CLS_CRUISER, CLS_DREADNOUGHT, CLS_CORVETTE, \
    CLS_ABOMINATION, CLS_REAPER, CLS_COLONY = range(NUM_SHIP_CLASSES)

# multipart collision geometry (multipart_ship, u_ship.cpp:2880-2931):
# per-class body-frame part offsets (along +dir) + radii, in class-radius
# units; single-part classes use one part at the origin.  The
# abomination is a head + tail-sphere chain; the reaper is a main sphere
# + the blocking shield lobe aimed at the threat (USC_REAPER cobjs).
MAX_PARTS = 4
PART_OFFSETS = np.zeros((NUM_SHIP_CLASSES, MAX_PARTS, 4), np.float32)
PART_OFFSETS[:, 0] = (0.0, 0.0, 0.0, 1.0)          # main body everywhere
PART_OFFSETS[CLS_ABOMINATION] = [(0.0, 0.0, 0.0, 1.0),     # head/eye
                                 (-1.4, 0.0, 0.0, 0.6),    # tail spheres
                                 (-2.4, 0.0, 0.0, 0.45),
                                 (-3.2, 0.0, 0.0, 0.3)]
PART_OFFSETS[CLS_REAPER, 0] = (0.0, 0.0, 0.0, 1.0)
PART_OFFSETS[CLS_REAPER, 1] = (0.8, 0.0, 0.0, 0.45)        # shield lobe
NUM_PARTS = np.array([1, 1, 1, 1, 4, 2, 1], np.int32)
REAPER_BLOCK = 0.8         # damage fraction blocked by the shield lobe
ABOMIN_EYE_RATE = 0.01     # eye open/close speed (state_val units/frame)


# ship AI types (ship_config.cpp ai_strs order; u_ship::ai_action
# behavior selection, u_ship.cpp:954)
AI_IGNORE, AI_RETREAT, AI_ATT_WAIT, AI_ATT_ENEMY, AI_ATT_ALL, \
    AI_SEEKING, AI_NONE = range(7)

# reference special-class enum ids (ship_config.cpp ship_strs order)
USC_ABOMIN_ID = 24
USC_REAPER_ID = 25


class FleetState(NamedTuple):
    """SoA ships (~ free_obj/u_ship state)."""

    px: torch.Tensor
    py: torch.Tensor
    pz: torch.Tensor
    vx: torch.Tensor
    vy: torch.Tensor
    vz: torch.Tensor
    cls: torch.Tensor       # class id (int32)
    align: torch.Tensor     # alignment/team id (int32)
    armor: torch.Tensor
    shields: torch.Tensor
    cooldown: torch.Tensor
    alive: torch.Tensor
    ai: torch.Tensor = None        # [N] AI_* behavior (default ATT_ENEMY)
    attacked: torch.Tensor = None  # [N] bool: has taken damage (ATT_WAIT)
    # multipart state: facing dir (part placement + reaper shield aim)
    # and the per-class animation value (abomination eye open fraction,
    # multipart_ship state_val)
    dx: torch.Tensor = None
    dy: torch.Tensor = None
    dz: torch.Tensor = None
    state_val: torch.Tensor = None


_TABLES: dict = {}


def _const(name: str, arr: np.ndarray, device) -> torch.Tensor:
    """A module table on `device`, made once per device."""
    key = (name, str(device))
    if key not in _TABLES:
        _TABLES[key] = torch.as_tensor(arr, device=device)
    return _TABLES[key]


def _table(tbl, device) -> torch.Tensor:
    """The class table on `device`: the built-in 7 classes when `tbl` is
    None."""
    if tbl is None:
        return _const("classes", SHIP_CLASSES, device)
    return torch.as_tensor(tbl, dtype=torch.float32, device=device)


def _filled(f: FleetState) -> FleetState:
    """The fleet with its optional fields materialized (step_fleet's
    defaults)."""
    n = f.px.shape[0]
    dev = f.px.device
    if f.ai is None:
        f = f._replace(ai=torch.full((n,), AI_ATT_ENEMY, dtype=torch.int32, device=dev))
    if f.attacked is None:
        f = f._replace(attacked=torch.zeros(n, dtype=torch.bool, device=dev))
    if f.dx is None:
        f = f._replace(dx=torch.ones(n, device=dev), dy=torch.zeros(n, device=dev),
                       dz=torch.zeros(n, device=dev))
    if f.state_val is None:
        f = f._replace(state_val=torch.zeros(n, device=dev))
    return f


class FleetDraws(NamedTuple):
    """The draws of `make_fleet`, as the JAX function's `jax.random`
    calls return them (`spread` applied)."""

    cls: torch.Tensor      # [N] int32 in [0, 4): the combat classes
    ux: torch.Tensor       # [N] uniform [-spread, spread)
    uy: torch.Tensor
    uz: torch.Tensor
    align: torch.Tensor    # [N] int32 in [0, num_teams)
    state_val: torch.Tensor  # [N] uniform [0, 1)


def draw_fleet(n: int, gen: torch.Generator, num_teams: int = 2, spread: float = 2.0,
               device: torch.device | str = "cuda") -> FleetDraws:
    """`FleetDraws` for `n` ships from a CPU generator, on `device`."""
    u = lambda: -spread + 2.0 * spread * torch.rand(n, generator=gen)
    i = lambda hi: torch.randint(0, hi, (n,), generator=gen, dtype=torch.int32)
    d = FleetDraws(cls=i(4), ux=u(), uy=u(), uz=u(), align=i(num_teams),
                   state_val=torch.rand(n, generator=gen))
    return FleetDraws(*(t.to(device) for t in d))


def make_fleet(d: FleetDraws, classes=None, tbl=None, aligns=None,
               center=(0.0, 0.0, 0.0)) -> FleetState:
    """A fleet of len(d.ux) ships at rest on the draws' device: classes
    and teams from the draws unless given."""
    n = d.ux.shape[0]
    dev = d.ux.device
    cls = d.cls if classes is None else torch.as_tensor(classes, dtype=torch.int32, device=dev)
    tbl = _table(tbl, dev)
    z = lambda: torch.zeros(n, device=dev)
    return FleetState(
        px=center[0] + d.ux, py=center[1] + d.uy, pz=center[2] + d.uz,
        vx=z(), vy=z(), vz=z(),
        cls=cls,
        align=(d.align if aligns is None
               else torch.as_tensor(aligns, dtype=torch.int32, device=dev)),
        armor=tbl[cls.long(), 2],
        shields=tbl[cls.long(), 3],
        cooldown=z(),
        alive=torch.ones(n, dtype=torch.bool, device=dev),
        dx=torch.ones(n, device=dev), dy=z(), dz=z(),
        state_val=d.state_val,
    )


def ship_parts(f: FleetState, tbl=None, part_offsets=None, num_parts=None):
    """[N, K] part positions + radii in world space (multipart_ship
    collision geometry): parts lie along the facing direction, scaled by
    the class radius with static per-part radii from the class table
    (the reference also animates the abomination's tail sphere sizes
    with its state value, u_ship.cpp:2880 — not modeled here)."""
    dev = f.px.device
    tbl = _table(tbl, dev)
    po = torch.as_tensor(PART_OFFSETS if part_offsets is None else part_offsets,
                         dtype=torch.float32, device=dev)
    nparr = torch.as_tensor(NUM_PARTS if num_parts is None else num_parts, device=dev)
    c = f.cls.long()
    rad = tbl[c, 7]
    off = po[c]                                    # [N, K, 4]
    npart = nparr[c]
    valid = torch.arange(po.shape[1], device=dev)[None, :] < npart[:, None]
    pxk = f.px[:, None] + off[:, :, 0] * rad[:, None] * f.dx[:, None]
    pyk = f.py[:, None] + off[:, :, 0] * rad[:, None] * f.dy[:, None]
    pzk = f.pz[:, None] + off[:, :, 0] * rad[:, None] * f.dz[:, None]
    prk = torch.where(valid, off[:, :, 3] * rad[:, None], 0.0)
    return pxk, pyk, pzk, prk, valid


def gram_d2(px, py, pz, qx=None, qy=None, qz=None) -> torch.Tensor:
    """[N, M] squared distances from the points p to the points q (default
    p) in the JAX package's Gram form |p|^2 + |q|^2 - 2 p.q (outer
    products, no matmul), whose rounding the targeting argmin and
    thresholds follow."""
    if qx is None:
        qx, qy, qz = px, py, pz
    p_sq = px ** 2 + py ** 2 + pz ** 2
    q_sq = qx ** 2 + qy ** 2 + qz ** 2
    G = px[:, None] * qx[None, :] + py[:, None] * qy[None, :] + pz[:, None] * qz[None, :]
    return p_sq[:, None] + q_sq[None, :] - 2.0 * G


def nearest_enemy(f: FleetState, d2: torch.Tensor, align=None, alive=None):
    """(target index, has a live enemy) per ship of `f`: the argmin over
    live enemies' masked distances `d2` (a row per ship of `f`, a column
    per candidate, whose alignment and alive flags `align` and `alive`
    default to those of `f`), the first index on ties (as jnp.argmin)."""
    if align is None:
        align, alive = f.align, f.alive
    enemy = (f.align[:, None] != align[None, :]) & alive[None, :] & f.alive[:, None]
    d2m = torch.where(enemy, d2, float("inf"))
    mn, tgt = torch.min(d2m, dim=1)
    return tgt, torch.isfinite(mn)


def step_fleet(f: FleetState, tbl=None, abomin_id: int = CLS_ABOMINATION,
               reaper_id: int = CLS_REAPER, fire_pts=None) -> FleetState:
    """One combat frame: target -> thrust -> move -> fire -> damage.
    `tbl` defaults to the built-in 7-class table; pass
    ship_config.ship_class_table(defs) for the full 40-class reference
    parameter set (abomin_id/reaper_id select the special-behavior
    classes: USC_ABOMIN=24, USC_REAPER=25 in the reference enum)."""
    n = f.px.shape[0]
    dev = f.px.device
    tbl = _table(tbl, dev)
    c = f.cls.long()
    accel = tbl[c, 0]
    vmax = tbl[c, 1]
    w_range = tbl[c, 4]
    w_dam = tbl[c, 5]
    w_cool = tbl[c, 6]

    ai = (f.ai if f.ai is not None
          else torch.full((n,), AI_ATT_ENEMY, dtype=torch.int32, device=dev))
    attacked = (f.attacked if f.attacked is not None
                else torch.zeros(n, dtype=torch.bool, device=dev))

    # nearest enemy via masked pairwise distances (ai_action target select)
    d2 = gram_d2(f.px, f.py, f.pz)
    tgt, has_tgt = nearest_enemy(f, d2)
    # behavior gating (u_ship::ai_action, u_ship.cpp:954): passive AIs
    # never engage; ATT_WAIT engages only once attacked; RETREAT ships
    # flee instead of closing when their shields are low
    passive = (ai == AI_IGNORE) | (ai == AI_NONE)
    waiting = (ai == AI_ATT_WAIT) & ~attacked
    has_tgt = has_tgt & ~passive & ~waiting
    tx, ty, tz = f.px[tgt], f.py[tgt], f.pz[tgt]

    # thrust toward target (u_ship::thrust), clamp speed; retreating
    # damaged ships thrust AWAY (ai_action retreat branch)
    dx = tx - f.px
    dy = ty - f.py
    dz = tz - f.pz
    d = sqrt32(dx * dx + dy * dy + dz * dz) + 1e-9
    sh_max = tbl[c, 3]
    fleeing = (ai == AI_RETREAT) & (f.shields < 0.25 * sh_max + 1e-6)
    a = torch.where(has_tgt & f.alive, accel, 0.0)
    adir = torch.where(fleeing, -1.0, 1.0)
    vx = f.vx + a * adir * dx / d
    vy = f.vy + a * adir * dy / d
    vz = f.vz + a * adir * dz / d
    sp = sqrt32(vx * vx + vy * vy + vz * vz) + 1e-9
    scale = torch.clamp(vmax / sp, max=1.0)
    vx, vy, vz = vx * scale, vy * scale, vz * scale
    px = f.px + vx
    py = f.py + vy
    pz = f.pz + vz

    # facing tracks the target direction (part placement + shield aim);
    # ships without a target keep their heading
    ndx = torch.where(has_tgt, dx / d, f.dx)
    ndy = torch.where(has_tgt, dy / d, f.dy)
    ndz = torch.where(has_tgt, dz / d, f.dz)

    # abomination eye animation (multipart_ship USC_ABOMIN state_val,
    # u_ship.cpp:2880-2899): opens toward 1 in combat, drifts shut
    # otherwise; a mostly-closed eye cannot fire (ai_action :2905)
    is_abomin = f.cls == abomin_id
    sv = torch.clamp(f.state_val + torch.where(has_tgt, ABOMIN_EYE_RATE, -ABOMIN_EYE_RATE),
                     0.0, 1.0)
    eye_ok = ~is_abomin | (sv > 0.1)

    # fire: in range + cooldown ready; damage applies shields-then-armor.
    # With per-class firing points ($WEAP_PT, parsed by ship_config),
    # range is measured from the TRANSFORMED muzzle point (body-frame
    # offset scaled by class radius, rotated to the facing dir) instead
    # of the hull center — weapons mounted forward out-range rear mounts.
    if fire_pts is not None:
        fp = torch.as_tensor(fire_pts, dtype=torch.float32, device=dev)[c]
        # body +x maps to the facing dir; lateral offsets stay small and
        # are dropped (no roll state) — forward offset is what matters
        fwd = fp[:, 0] * tbl[c, 7]
        mx_ = f.px + fwd * ndx
        my_ = f.py + fwd * ndy
        mz_ = f.pz + fwd * ndz
        d_fire = sqrt32((tx - mx_) ** 2 + (ty - my_) ** 2 + (tz - mz_) ** 2) + 1e-9
    else:
        d_fire = d
    in_range = has_tgt & ~fleeing & (d_fire < w_range) & (f.cooldown <= 0) \
        & f.alive & eye_ok
    dmg_dealt = torch.where(in_range, w_dam, 0.0)
    # reaper shield lobe blocks most damage arriving from its aim
    # direction (USC_REAPER blocking shield, u_ship.cpp:2931-2960): the
    # Gram-form distances and the alignment numerator as outer products,
    # as the JAX step writes them
    el = sqrt32(torch.clamp(d2, min=0.0)) + 1e-9
    num = (f.px[:, None] * ndx[None, :] - (f.px * ndx)[None, :]
           + f.py[:, None] * ndy[None, :] - (f.py * ndy)[None, :]
           + f.pz[:, None] * ndz[None, :] - (f.pz * ndz)[None, :])
    aligned = num / el > 0.5
    is_reaper_j = (f.cls == reaper_id)[None, :]
    block = torch.where(aligned & is_reaper_j, 1.0 - REAPER_BLOCK, 1.0)
    toh = torch.nn.functional.one_hot(tgt, n).to(torch.float32)
    dmg_in = torch.sum(dmg_dealt[:, None] * toh * block, dim=0)
    sh = torch.clamp(f.shields - dmg_in, min=0.0)
    overflow = torch.clamp(dmg_in - f.shields, min=0.0)
    armor = f.armor - overflow
    alive = f.alive & (armor > 0)
    cooldown = torch.where(in_range, w_cool, torch.clamp(f.cooldown - 1.0, min=0.0))
    attacked = attacked | (dmg_in > 0.0)
    # shield regeneration up to the class max (us_class shield_re,
    # ship.h:507; ship_base.cpp regen path) — armor does not regen here
    sh = torch.minimum(sh + tbl[c, 8] * alive.to(torch.float32), sh_max)
    return f._replace(px=px, py=py, pz=pz, vx=vx, vy=vy, vz=vz,
                      armor=armor, shields=sh, cooldown=cooldown, alive=alive,
                      ai=ai, attacked=attacked,
                      dx=ndx, dy=ndy, dz=ndz, state_val=sv)


def fleet_frames_chained(f: FleetState, frames: int, tbl=None,
                         abomin_id: int = CLS_ABOMINATION,
                         reaper_id: int = CLS_REAPER, fire_pts=None) -> FleetState:
    """`frames` combat frames: the single step in a Python loop, queued
    without a host sync (the JAX package scans them in one dispatch)."""
    f = _filled(f)
    tbl = _table(tbl, f.px.device)
    for _ in range(frames):
        f = step_fleet(f, tbl=tbl, abomin_id=abomin_id, reaper_id=reaper_id,
                       fire_pts=fire_pts)
    return f


class BeltDraws(NamedTuple):
    """The draws of `gen_asteroid_belt` (standard forms: the belt's
    scales are applied by the function)."""

    ang: torch.Tensor      # [N] uniform [0, 2 pi)
    rad: torch.Tensor      # [N] standard normal
    zoff: torch.Tensor     # [N] standard normal
    size: torch.Tensor     # [N] uniform [0.3, 3)


def gen_asteroid_belt(d: BeltDraws, system_radius: float):
    """Asteroid belt: torus distribution around the star (asteroid.cpp
    belt gen); returns (x, y, z, radius) SoA."""
    rad = system_radius * (0.6 + 0.1 * d.rad)
    zoff = 0.02 * system_radius * d.zoff
    size = 0.001 * system_radius * d.size
    return rad * torch.cos(d.ang), rad * torch.sin(d.ang), zoff, size


def fleet_explosions(prev: FleetState, cur: FleetState, tbl=None) -> np.ndarray:
    """Ships that died this step -> [K<=N] host explosion records (x, y,
    z, blast radius ~ 3x ship radius; the reference spawns an explosion
    uobject per destroyed ship)."""
    h = lambda t: t.cpu().numpy()
    died = h(prev.alive) & ~h(cur.alive)
    idx = np.where(died)[0]
    tbl = SHIP_CLASSES if tbl is None else (h(tbl) if isinstance(tbl, torch.Tensor)
                                            else np.asarray(tbl))
    rad = tbl[h(cur.cls)[idx], 7] * 3.0
    return np.stack([h(cur.px)[idx], h(cur.py)[idx], h(cur.pz)[idx], rad], -1) \
        if len(idx) else np.zeros((0, 4), np.float32)


def orbit_step(f: FleetState, center, orbit_r, orbit_speed: float = 0.01,
               blend: float = 0.1) -> FleetState:
    """Orbit-keeping for ships assigned to guard a body (u_ship
    orbiting behavior): steer velocity toward the tangential direction
    at `orbit_speed` plus a radial correction toward `orbit_r`."""
    f32 = lambda v: torch.as_tensor(v, dtype=torch.float32, device=f.px.device)
    cx, cy, cz = (f32(center[k]) for k in range(3))
    orbit_r = f32(orbit_r)
    rx = f.px - cx
    ry = f.py - cy
    r = sqrt32(rx * rx + ry * ry) + 1e-9
    tx = -ry / r
    ty = rx / r
    err = orbit_r - r
    vdx = tx * orbit_speed + (rx / r) * err * 0.05
    vdy = ty * orbit_speed + (ry / r) * err * 0.05
    vdz = (cz - f.pz) * 0.05
    vx = f.vx * (1 - blend) + vdx * blend
    vy = f.vy * (1 - blend) + vdy * blend
    vz = f.vz * (1 - blend) + vdz * blend
    return f._replace(px=f.px + vx, py=f.py + vy, pz=f.pz + vz, vx=vx, vy=vy, vz=vz)


# ---------------------------------------------------------------------------
# colonization + orbital docks (u_ship::claim_world u_ship.cpp:808-830,
# orbiting_ship::ai_action :2974, try_orbital_regen :860)
# ---------------------------------------------------------------------------

class PlanetClaims(NamedTuple):
    """Ownership of a system's colonizable planets."""

    owner: torch.Tensor         # [P] int32 team (-1 unclaimed)
    homeworld_of: torch.Tensor  # [P] int32 claiming ship index (-1)


def make_claims(num_planets: int, device: torch.device | str = "cuda") -> PlanetClaims:
    full = lambda: torch.full((num_planets,), -1, dtype=torch.int32, device=device)
    return PlanetClaims(owner=full(), homeworld_of=full())


def colonize_step(f: FleetState, planet_pos: torch.Tensor, claims: PlanetClaims,
                  claim_radius: float = 0.08):
    """One colonization frame: colony ships head for the nearest
    unclaimed planet and claim it on arrival (claim_world semantics: a
    claimed planet becomes the claimer's homeworld; first arrival wins
    a contested claim).  Returns (fleet', claims')."""
    colonizer = (f.cls == CLS_COLONY) & f.alive
    unclaimed = claims.owner < 0
    # nearest unclaimed planet per ship
    ex = f.px[:, None] - planet_pos[None, :, 0]
    ey = f.py[:, None] - planet_pos[None, :, 1]
    ez = f.pz[:, None] - planet_pos[None, :, 2]
    d2 = ex * ex + ey * ey + ez * ez
    d2m = torch.where(unclaimed[None, :], d2, float("inf"))
    mn, tgt = torch.min(d2m, dim=1)
    has = torch.isfinite(mn) & colonizer
    tx, ty, tz = planet_pos[tgt, 0], planet_pos[tgt, 1], planet_pos[tgt, 2]
    dx = tx - f.px
    dy = ty - f.py
    dz = tz - f.pz
    d = sqrt32(dx * dx + dy * dy + dz * dz) + 1e-9
    tbl = _table(None, f.px.device)
    c = f.cls.long()
    a = torch.where(has, tbl[c, 0], 0.0)
    vx = f.vx + a * dx / d
    vy = f.vy + a * dy / d
    vz = f.vz + a * dz / d
    sp = sqrt32(vx * vx + vy * vy + vz * vz) + 1e-9
    s = torch.clamp(tbl[c, 1] / sp, max=1.0)
    vx, vy, vz = vx * s, vy * s, vz * s

    # claims: for each planet, the nearest in-radius colonizer wins
    P = planet_pos.shape[0]
    toh = torch.arange(P, device=f.px.device)[None, :] == tgt[:, None]
    close = has[:, None] & toh & (d[:, None] < claim_radius)
    d2c = torch.where(close, d2, float("inf"))
    mnc, winner = torch.min(d2c, dim=0)
    any_claim = torch.isfinite(mnc) & unclaimed
    owner = torch.where(any_claim, f.align[winner], claims.owner)
    home = torch.where(any_claim, winner.to(torch.int32), claims.homeworld_of)
    return (f._replace(px=f.px + vx, py=f.py + vy, pz=f.pz + vz, vx=vx, vy=vy, vz=vz),
            PlanetClaims(owner=owner, homeworld_of=home))


def orbital_regen(f: FleetState, dock_pos: torch.Tensor, dock_align: torch.Tensor,
                  rate: float = 2.0, dock_range: float = 0.3) -> FleetState:
    """Friendly ships near an orbiting dock regenerate armor
    (try_orbital_regen / orbiting docks, u_ship.cpp:860-900)."""
    ex = f.px[:, None] - dock_pos[None, :, 0]
    ey = f.py[:, None] - dock_pos[None, :, 1]
    ez = f.pz[:, None] - dock_pos[None, :, 2]
    d2 = ex * ex + ey * ey + ez * ez
    friendly = f.align[:, None] == dock_align[None, :]
    near = torch.any(friendly & (d2 < dock_range * dock_range), dim=1)
    amax = _table(None, f.px.device)[f.cls.long(), 2]
    armor = torch.where(near & f.alive, torch.minimum(f.armor + rate, amax), f.armor)
    return f._replace(armor=armor)


# ---------------------------------------------------------------------------
# player ship control (u_ship::thrust, u_ship.cpp:282-340; player turn /
# hyperspeed semantics)
# ---------------------------------------------------------------------------

MOVE_FRONT, MOVE_BACK, MOVE_LEFT, MOVE_RIGHT, MOVE_STOP = range(5)
HYPERSPEED_MULT = 20.0     # hyperspeed_mult default
PLAYER_TURN_RATE = 0.08


class PlayerShip(NamedTuple):
    """The player-controlled ship (pos/vel/facing + hyperspeed latch), 0-d
    tensors; steered by thrust() commands per frame like the reference's
    player_controlled path."""

    px: torch.Tensor
    py: torch.Tensor
    pz: torch.Tensor
    vx: torch.Tensor
    vy: torch.Tensor
    vz: torch.Tensor
    dx: torch.Tensor       # facing
    dy: torch.Tensor
    dz: torch.Tensor
    cls: torch.Tensor
    hyper: torch.Tensor    # bool latch (lhyper)


def make_player_ship(cls: int = 1, pos=(0.0, 0.0, 0.0),
                     device: torch.device | str = "cuda") -> PlayerShip:
    f = lambda v: torch.tensor(v, dtype=torch.float32, device=device)
    return PlayerShip(px=f(pos[0]), py=f(pos[1]), pz=f(pos[2]),
                      vx=f(0.0), vy=f(0.0), vz=f(0.0), dx=f(1.0), dy=f(0.0), dz=f(0.0),
                      cls=torch.tensor(cls, dtype=torch.int32, device=device),
                      hyper=torch.tensor(False, device=device))


def player_thrust(s: PlayerShip, tdir: int, speed: float = 1.0,
                  hyperspeed: bool = False) -> PlayerShip:
    """One thrust command (u_ship::thrust): FRONT accelerates along the
    facing up to max_speed (x HYPERSPEED_MULT in hyperspeed, latched
    until slow — lhyper), BACK reverses, STOP brakes toward zero,
    LEFT/RIGHT yaw the facing at the player turn rate."""
    dev = s.px.device
    tbl = _table(None, dev)
    accel = tbl[s.cls.long(), 0]
    vmax = tbl[s.cls.long(), 1]
    if tdir in (MOVE_LEFT, MOVE_RIGHT):
        ang = torch.tensor((-1.0 if tdir == MOVE_LEFT else 1.0) * PLAYER_TURN_RATE * speed,
                           dtype=torch.float32, device=dev)
        ca, sa = torch.cos(ang), torch.sin(ang)
        return s._replace(dx=s.dx * ca - s.dy * sa, dy=s.dx * sa + s.dy * ca)
    sp = sqrt32(s.vx ** 2 + s.vy ** 2 + s.vz ** 2)
    # hyperspeed latch: stays on until speed drops below normal max
    hyper = torch.ones_like(s.hyper) if hyperspeed else s.hyper & (sp > vmax)
    cap = torch.where(hyper, HYPERSPEED_MULT * vmax, vmax)
    if tdir == MOVE_FRONT:
        a = accel * speed * torch.where(hyper, HYPERSPEED_MULT, 1.0)
        vx = s.vx + a * s.dx
        vy = s.vy + a * s.dy
        vz = s.vz + a * s.dz
    elif tdir == MOVE_BACK:
        vx = s.vx - accel * speed * s.dx
        vy = s.vy - accel * speed * s.dy
        vz = s.vz - accel * speed * s.dz
    else:   # MOVE_STOP: brake toward zero (stoppable classes)
        brake = torch.clamp(1.0 - accel * speed * 50.0, min=0.0)
        vx, vy, vz = s.vx * brake, s.vy * brake, s.vz * brake
    nsp = sqrt32(vx * vx + vy * vy + vz * vz) + 1e-12
    scl = torch.clamp(cap / nsp, max=1.0)
    return s._replace(vx=vx * scl, vy=vy * scl, vz=vz * scl, hyper=hyper)


def player_ship_frame(s: PlayerShip) -> PlayerShip:
    """Advance the player ship one frame (free_obj::advance_time core)."""
    return s._replace(px=s.px + s.vx, py=s.py + s.vy, pz=s.pz + s.vz)


def avoid_hazards(f: FleetState, star_pos: torch.Tensor, star_radius: torch.Tensor,
                  bhole_mask: torch.Tensor, heat_mult: float = 6.0,
                  gmax_dist: float = 0.5, tbl=None) -> FleetState:
    """Hazard avoidance (u_ship::ai_action, u_ship.cpp:995-1012): ships
    too close to a hot star fly a tangent veering away; near a black
    hole with excessive gravity they thrust directly away.  Applied
    after step_fleet; overrides the combat velocity for endangered
    ships."""
    ex = f.px[:, None] - star_pos[None, :, 0]
    ey = f.py[:, None] - star_pos[None, :, 1]
    ez = f.pz[:, None] - star_pos[None, :, 2]
    d2 = ex * ex + ey * ey + ez * ez
    near = torch.argmin(d2, dim=1)
    row = lambda m: m.gather(1, near[:, None])[:, 0]
    dx, dy, dz = row(ex), row(ey), row(ez)
    dist = sqrt32(dx * dx + dy * dy + dz * dz) + 1e-9
    srad = star_radius[near]
    is_bh = bhole_mask[near]
    hot = ~is_bh & (dist < heat_mult * srad)
    danger_bh = is_bh & (dist < gmax_dist)
    # hot: tangent + slight outward veer (orthogonalize dir against the
    # safe dir, then add 0.1 * safe)
    sx, sy, sz = dx / dist, dy / dist, dz / dist
    dp = f.dx * sx + f.dy * sy + f.dz * sz
    tx = f.dx - dp * sx + 0.1 * sx
    ty = f.dy - dp * sy + 0.1 * sy
    tz = f.dz - dp * sz + 0.1 * sz
    tl = sqrt32(tx * tx + ty * ty + tz * tz) + 1e-9
    vmax = _table(tbl, f.px.device)[f.cls.long(), 1]
    nvx = torch.where(danger_bh, vmax * sx, torch.where(hot, vmax * tx / tl, f.vx))
    nvy = torch.where(danger_bh, vmax * sy, torch.where(hot, vmax * ty / tl, f.vy))
    nvz = torch.where(danger_bh, vmax * sz, torch.where(hot, vmax * tz / tl, f.vz))
    # override the VELOCITY only: step_fleet has already integrated this
    # frame's motion, so adding another position step here would move
    # escaping ships at up to 2x their class vmax (double integration)
    return f._replace(vx=nvx, vy=nvy, vz=nvz)


# ---------------------------------------------------------------------------
# reference-config fleets (ship_defs.txt -> sim)
# ---------------------------------------------------------------------------

def fleet_from_defs(defs, draw, fleets=None):
    """Build ONE host FleetState (numpy arrays) from parsed $FLEET specs
    (us_fleet::spawn, ship_config.cpp:473-505): per-class counts x
    multiplier, alignment from the spec, positions within rgen_dist of the
    fleet pos (offset by $START_POS like the reference's `ustart_pos +
    pos`).  `draw(n)` gives the [n, 3] uniform [-1, 1) position draw (a
    threefry draw in the JAX package).

    Returns (state, tbl, part_offsets, num_parts) — pass tbl/parts into
    step_fleet/ship_parts so all 40 reference classes drive the sim."""
    from . import ship_config as SC
    tbl = SC.ship_class_table(defs)
    offs, nparts = SC.ship_part_geometry(defs, max_parts=MAX_PARTS)
    start = defs.globals.get("start_pos", (0.0, 0.0, 0.0))
    cls_list, align_list, pos_list, spread_list, ai_list = [], [], [], [], []
    use = defs.fleets if fleets is None else fleets
    for fl in use:
        total = fl.multiplier * sum(fl.counts)
        if total == 0:
            continue
        for cid, cnt in enumerate(fl.counts):
            k = fl.multiplier * cnt
            cls_list.extend([cid] * k)
            align_list.extend([fl.align] * k)
            ai_list.extend([fl.ai_type] * k)
        center = tuple(s + p for s, p in zip(start, fl.pos))
        pos_list.extend([center] * total)
        spread_list.extend([fl.rgen_dist] * total)
    if not cls_list:
        # $SHIP_ADD_INIT + $ALIGN rows (ship_config.cpp:525-560): spawn
        # `num` instances of each alignment's counts distribution near
        # the start position (the fight/colonize configs populate this
        # way instead of $FLEET)
        spawn_d = float(defs.globals.get("spawn_dist", 0.5)) or 0.5
        for (mode, enabled, _dmax, a, num, counts) in defs.rand_spawns:
            if mode != "$SHIP_ADD_INIT" or not enabled:
                continue
            for _rep in range(max(num, 1)):
                for cid, cnt in enumerate(counts):
                    cls_list.extend([cid] * cnt)
                    align_list.extend([a] * cnt)
                    ai_list.extend([3] * cnt)      # AI_ATT_ENEMY
                    pos_list.extend([start] * cnt)
                    spread_list.extend([4.0 * spawn_d] * cnt)
    if not cls_list:
        raise ValueError("no fleets with ships in defs")
    n = len(cls_list)
    cls = np.asarray(cls_list, np.int32)
    tbl_np = np.asarray(tbl, np.float32)
    centers = np.asarray(pos_list, np.float32)
    spread = np.asarray(spread_list, np.float32)[:, None]
    u = np.asarray(draw(n), np.float32)
    pos = centers + u * spread
    z = np.zeros(n, np.float32)
    state = FleetState(
        px=pos[:, 0], py=pos[:, 1], pz=pos[:, 2],
        vx=z, vy=z, vz=z,
        cls=cls, align=np.asarray(align_list, np.int32),
        armor=tbl_np[cls, 2], shields=tbl_np[cls, 3],
        cooldown=z, alive=np.ones(n, bool),
        ai=np.asarray(ai_list, np.int32),
        attacked=np.zeros(n, bool),
        dx=np.ones(n, np.float32), dy=z, dz=z,
        state_val=z,
    )
    return state, tbl, offs, nparts


def fleet_to(f: FleetState, device) -> FleetState:
    """A FleetState of numpy arrays or tensors as tensors on `device`
    (None fields stay None)."""
    t = lambda v: v.to(device) if isinstance(v, torch.Tensor) \
        else torch.as_tensor(np.array(v), device=device)
    return FleetState(*(None if v is None else t(v) for v in f))

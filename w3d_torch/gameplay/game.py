"""Gameplay: weapons, explosions/blast damage, smileys, scores (port of
`3dworld_tpu/gameplay/game.py`).

The reference's FPS layer: weapon table with per-weapon projectile
parameters (Gameplay.cpp:2884, weapon spawn in process_groups), blast
radius damage with cobj destruction (explosion.cpp:460,
`destroy_coll_objs`), and smiley AI seeking/attacking/fleeing over the
waypoint graph (`advance_smiley`, ai.cpp:1579).

As in the JAX package, the firing-error jitter comes from numpy: the
module-level fire stream seeds `np.random.default_rng` once per shot
(`reset_fire_stream` rewinds it), so both packages draw the same jitter.
Projectiles are written slot by slot into the object SoA; hitscan rays
test the cobjs (`ops/ray`) and the object spheres, and add their hits per
object with `index_add_`.  The one-hot matmuls of the JAX package are
gathers here, and `make_smileys` takes its spawn draws as inputs.  Blast
parameters enter as float32 0-d tensors (`physics/destroy.as_f32`), as
the JAX package's jitted functions take them.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..physics import types as PT
from ..physics.destroy import as_f32
from ..physics.step import ObjectState

# full weapon table transcription (weapons[NUM_TOT_WEAPONS],
# Gameplay.cpp:71-93): obj_type None = hitscan/melee (UNDEF obj_id).
# (name, obj_type, v_mult, v_add, fire_delay, nshots, nfragments,
#  blast_damage, blast_radius, firing_error, range, recoil,
#  def_ammo, max_ammo, self_damage, use_underwater, need_ammo)
CBFD = 60
CBLADE_EXT = 0.5 * 0.04 * CBFD
WEAPONS = (
    ("unarmed",        None,        0.0, 0.0, 0,    0,  0,   0.0,    0.0,  0.0,   0.0,  0.00, 0,   0,   0, 1, 0),
    ("bbbat",          None,        0.0, 0.0, 23,   1,  1,   500.0,  0.25, 0.0,   0.25, 0.00, 0,   0,   0, 1, 0),
    ("ball",           "BALL",      1.5, 3.0, 25,   1,  1,   0.0,    0.0,  0.0,   3.0,  0.08, 1,   3,   0, 0, 1),
    ("sball",          "S_BALL",    1.3, 3.3, 18,   1,  1,   0.0,    0.0,  0.0,   1.5,  0.02, 30,  500, 0, 0, 1),
    ("rocket",         "ROCKET",    0.7, 3.1, 32,   1,  1,   1000.0, 0.42, 0.003, 0.0,  0.05, 10,  100, 3, 0, 1),
    ("landmine",       "LANDMINE",  0.0, 2.0, 30,   1,  1,   4000.0, 0.39, 0.0,   6.0,  0.00, 5,   50,  0, 0, 1),
    ("seek_d",         "SEEK_D",    0.5, 2.5, 60,   1,  1,   2300.0, 0.50, 0.0,   0.0,  0.10, 5,   50,  3, 0, 1),
    ("star5",          "STAR5",     1.1, 3.0, 10,   1,  1,   0.0,    0.0,  0.015, 2.0,  0.00, 25,  500, 0, 1, 1),
    ("m16",            None,        0.0, 0.0, 2,    1,  1,   70.0,   0.0,  0.020, 2.8,  0.01, 100, 600, 0, 1, 1),
    ("shotgun",        None,        0.0, 0.0, 27,   24, 1,   50.0,   0.0,  0.080, 2.5,  0.03, 12,  100, 0, 1, 1),
    ("grenade",        "GRENADE",   1.0, 1.2, 22,   1,  140, 700.0,  0.44, 0.010, 1.6,  0.02, 12,  60,  3, 0, 1),
    ("laser",          None,        0.0, 0.0, 1,    1,  1,   16.0,   0.0,  0.0,   0.0,  0.00, 200, 800, 0, 1, 1),
    ("plasma",         "PLASMA",    1.4, 3.5, 13,   1,  1,   200.0,  0.43, 0.0,   4.5,  0.00, 20,  200, 3, 0, 1),
    ("cblade",         None,        1.5, 4.0, CBFD, 1,  1,   40.0,   0.2,  0.0,   CBLADE_EXT, 0.00, 1, 10, 0, 1, 0),
    ("gasser",         "GASSED",    1.2, 2.8, 4,    1,  1,   100.0,  0.07, 0.1,   2.8,  0.00, 60,  250, 0, 0, 1),
    ("raptor",         "RAPT_PROJ", 1.2, 3.2, 14,   1,  1,   220.0,  0.35, 0.025, 6.0,  0.05, 25,  400, 1, 0, 1),
    ("translocator",   "XLOCATOR",  2.0, 4.0, 20,   1,  1,   0.0,    0.0,  0.0,   0.0,  0.03, 1,   1,   0, 1, 1),
    ("cgrenade",       "CGRENADE",  0.9, 1.1, 80,   1,  8,   800.0,  0.45, 0.02,  1.6,  0.04, 3,   20,  1, 0, 1),
    ("sawblade",       "SAWBLADE",  2.0, 4.0, CBFD, 1,  1,   0.0,    0.0,  0.01,  0.0,  0.03, 1,   10,  0, 1, 1),
    ("teleporter",     "TELEPORTER", 0.7, 1.5, 50,  1,  1,   0.0,    0.0,  0.0,   0.0,  0.00, 1,   10,  1, 0, 1),
)
WEAPON_INDEX = {w[0]: i for i, w in enumerate(WEAPONS)}


class WeaponState(NamedTuple):
    """Per-player weapon bookkeeping (player_state wweapon/ammo/cooldown,
    gameplay.h): selection, per-weapon ammo, fire cooldown."""

    sel: torch.Tensor        # [P] int32 selected weapon
    ammo: torch.Tensor       # [P, W] int32
    cooldown: torch.Tensor   # [P] int32 frames until can fire


def make_weapon_states(num_players: int,
                       device: torch.device | str = "cuda") -> WeaponState:
    ammo = np.tile(np.asarray([w[12] for w in WEAPONS], np.int32), (num_players, 1))
    return WeaponState(
        sel=torch.full((num_players,), WEAPON_INDEX["ball"], dtype=torch.int32,
                       device=device),
        ammo=torch.as_tensor(ammo, device=device),
        cooldown=torch.zeros((num_players,), dtype=torch.int32, device=device))


def can_fire(ws: WeaponState, player: int) -> bool:
    """Host check (reads the player's row back)."""
    sel = int(ws.sel[player])
    if int(ws.cooldown[player]) > 0:
        return False
    if WEAPONS[sel][16] and int(ws.ammo[player, sel]) <= 0:
        return False
    return True


# global firing-error stream: the reference advances one global rgen per
# shot (deterministic per run, but successive shots differ)
_FIRE_SEQ = [0]


def _next_fire_seed() -> int:
    _FIRE_SEQ[0] += 1
    return _FIRE_SEQ[0]


def reset_fire_stream(seed: int = 0) -> None:
    """Rewind the firing-error stream (rand_gen set_state analog), for
    deterministic replays."""
    _FIRE_SEQ[0] = seed


def fire_weapon(state: ObjectState, free_slots, weapon_idx: int,
                origin, direction, table, key=None,
                shooter_vel=(0.0, 0.0, 0.0)) -> ObjectState:
    """Spawn the weapon's projectile(s) into free object slots
    (fire_projectile spawn path): nshots pellets with firing_error
    direction jitter, launch speed v_add + v_mult * shooter speed
    (weapon_t::get_fire_vel).  `key` is an integer seed for the jitter
    (default: the next fire-stream seed)."""
    (_name, otype, v_mult, v_add, _fd, nshots, _nf, _bd, _br, f_err,
     *_rest) = WEAPONS[weapon_idx]
    if otype is None:
        return state     # hitscan weapons use fire_hitscan
    tid = PT.type_id(otype)
    d = np.asarray(direction, np.float32)
    d = d / max(np.linalg.norm(d), 1e-9)
    sv = np.asarray(shooter_vel, np.float32)
    vel = v_add + v_mult * float(np.linalg.norm(sv))
    rng = np.random.default_rng(_next_fire_seed() if key is None else int(key))
    n = min(nshots, len(free_slots))
    if n == 0:
        return state
    cols = {f: getattr(state, f).clone() for f in
            ("px", "py", "pz", "vx", "vy", "vz", "otype", "status", "time", "health")}
    for k in range(n):
        slot = int(free_slots[k])
        dk = d + f_err * rng.standard_normal(3).astype(np.float32)
        dk = dk / max(np.linalg.norm(dk), 1e-9)
        for f, v in (("px", origin[0]), ("py", origin[1]), ("pz", origin[2]),
                     ("vx", vel * dk[0]), ("vy", vel * dk[1]), ("vz", vel * dk[2]),
                     ("otype", tid), ("status", 1), ("time", 0)):
            cols[f][slot] = v.item() if isinstance(v, np.generic) else v
        cols["health"][slot] = table.health[tid]
    return state._replace(**cols)


def fire_hitscan(state: ObjectState, cobjs, origin, direction, weapon_idx: int,
                 table, key=None):
    """Instant-hit weapons (M16/shotgun/laser: obj_id UNDEF in the table;
    fire_projectile's projectile_test ray path): per-pellet jittered rays,
    nearest object sphere hit unless a cobj blocks first, damage applied
    at the hit.  Returns (state', hit_mask [N], n_wall_hits)."""
    from ..ops import ray as R
    w = WEAPONS[weapon_idx]
    nshots, dam, f_err, rng_lim = w[5], w[7], w[9], w[10]
    rng = np.random.default_rng(_next_fire_seed() if key is None else int(key))
    d = np.asarray(direction, np.float32)
    d = d / max(np.linalg.norm(d), 1e-9)
    dirs = d[None, :] + f_err * rng.standard_normal((nshots, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    dev = state.px.device
    full = lambda v: torch.full((nshots,), float(v), dtype=torch.float32, device=dev)
    ox, oy, oz = full(origin[0]), full(origin[1]), full(origin[2])
    reach = rng_lim if rng_lim > 0 else 100.0
    tmax = full(reach)
    dt = torch.as_tensor(dirs, device=dev)
    chit, ct, *_ = R.ray_cobjs_nearest(ox, oy, oz, dt[:, 0], dt[:, 1], dt[:, 2],
                                       tmax, cobjs)
    # ray-vs-object-sphere: nearest alive object per pellet
    rad = table.radius[state.otype.long()]
    exo = state.px[None, :] - ox[:, None]
    eyo = state.py[None, :] - oy[:, None]
    ezo = state.pz[None, :] - oz[:, None]
    tproj = exo * dt[:, 0:1] + eyo * dt[:, 1:2] + ezo * dt[:, 2:3]
    perp2 = exo * exo + eyo * eyo + ezo * ezo - tproj * tproj
    okhit = (state.status[None, :] > 0) & (tproj > 0.0) & \
        (perp2 < (rad * rad)[None, :]) & (tproj < tmax[:, None]) & \
        (tproj < torch.where(chit, ct, torch.inf)[:, None])
    t_obj = torch.where(okhit, tproj, torch.inf)
    best = torch.argmin(t_obj, dim=1)
    has = torch.isfinite(torch.min(t_obj, dim=1).values)
    hit_counts = torch.zeros(state.px.shape[0], dtype=torch.float32, device=dev) \
        .index_add_(0, best, has.to(torch.float32))
    hp = state.health - dam * hit_counts
    killed = (state.status > 0) & (hp <= 0) & (hit_counts > 0)
    state = state._replace(health=torch.where(hit_counts > 0, hp, state.health),
                           status=torch.where(killed, 0, state.status))
    return state, hit_counts > 0, torch.sum(chit & ~has)


def blast_params(otype_name: str):
    """Blast damage/radius for a projectile's detonation, from the weapon
    that fires that object type (blast_radius/blast_damage columns)."""
    for w in WEAPONS:
        if w[1] == otype_name:
            return w[7], w[8]
    return 0.0, 0.0


def apply_blast(state: ObjectState, cx, cy, cz, radius, damage) -> ObjectState:
    """Blast damage + impulse to all objects in range (explosion.cpp
    blast: falloff with distance, radial knockback)."""
    cx, cy, cz, radius, damage = (as_f32(v, state.px) for v in (cx, cy, cz, radius, damage))
    dx = state.px - cx
    dy = state.py - cy
    dz = state.pz - cz
    d = torch.sqrt(dx * dx + dy * dy + dz * dz) + 1e-9
    f = torch.clamp(1.0 - d / radius, min=0.0)
    hp = state.health - damage * f
    imp = 0.5 * damage * f / d * 0.01
    alive = state.status > 0
    killed = alive & (hp <= 0)
    return state._replace(
        health=torch.where(alive, hp, state.health),
        vx=torch.where(alive, state.vx + imp * dx, state.vx),
        vy=torch.where(alive, state.vy + imp * dy, state.vy),
        vz=torch.where(alive, state.vz + imp * dz, state.vz),
        status=torch.where(killed, 0, state.status))


class SmileyState(NamedTuple):
    """FPS AI agents (player_state + smiley fields, SoA)."""

    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor
    health: torch.Tensor
    team: torch.Tensor
    tx: torch.Tensor       # move target
    ty: torch.Tensor
    cooldown: torch.Tensor


def make_smileys(x, y, team, device: torch.device | str = "cuda") -> SmileyState:
    """Smileys at (x, y) [n] of `team` [n]: the spawn draws the JAX
    package takes from threefry (uniform in [-spread, spread), teams in
    [0, num_teams)) are inputs."""
    x = torch.as_tensor(x, dtype=torch.float32, device=device)
    z = lambda: torch.zeros_like(x)
    return SmileyState(
        x=x, y=torch.as_tensor(y, dtype=torch.float32, device=device), z=z(),
        health=torch.full_like(x, 100.0),
        team=torch.as_tensor(team, dtype=torch.int32, device=device),
        tx=z(), ty=z(), cooldown=z())


def step_smileys(s: SmileyState, speed: float = 0.01):
    """advance_smiley core decisions: seek the nearest enemy, flee when
    weak; fire when close.  Returns (state, fire mask)."""
    alive = s.health > 0
    ex = s.x[:, None] - s.x[None, :]
    ey = s.y[:, None] - s.y[None, :]
    d2 = ex * ex + ey * ey
    enemy = (s.team[:, None] != s.team[None, :]) & alive[None, :] & alive[:, None]
    d2m = torch.where(enemy, d2, torch.inf)
    # a smiley with no live enemy stands down (argmin of an all-inf row
    # is 0, which would chase smiley 0)
    has_enemy = torch.any(enemy, dim=1)
    tgt, dmin = torch.argmin(d2m, dim=1), torch.min(d2m, dim=1).values
    tx = torch.where(has_enemy, s.x[tgt], s.tx)
    ty = torch.where(has_enemy, s.y[tgt], s.ty)
    dist = torch.sqrt(dmin)
    flee = s.health < 25.0
    dirx = torch.where(flee, s.x - tx, tx - s.x)
    diry = torch.where(flee, s.y - ty, ty - s.y)
    dl = torch.sqrt(dirx * dirx + diry * diry) + 1e-9
    move = alive & has_enemy
    x = s.x + torch.where(move, speed * dirx / dl, 0.0)
    y = s.y + torch.where(move, speed * diry / dl, 0.0)
    fire = alive & has_enemy & ~flee & (dist < 1.0) & (s.cooldown <= 0)
    cooldown = torch.where(fire, 20.0, torch.clamp(s.cooldown - 1.0, min=0.0))
    return s._replace(x=x, y=y, tx=tx, ty=ty, cooldown=cooldown), fire


# ---------------------------------------------------------------------------
# scoring + blood decals (Gameplay.cpp kill credit / blood splatter)
# ---------------------------------------------------------------------------

class GameScore(NamedTuple):
    """Per-player match stats (kills/deaths/score, Gameplay.cpp)."""

    kills: torch.Tensor     # [P] int32
    deaths: torch.Tensor
    score: torch.Tensor     # f32 (weapon damage dealt + kill bonuses)


def make_scores(num_players: int, device: torch.device | str = "cuda") -> GameScore:
    z = torch.zeros((num_players,), dtype=torch.int32, device=device)
    return GameScore(kills=z, deaths=z.clone(),
                     score=torch.zeros((num_players,), dtype=torch.float32, device=device))


KILL_BONUS = 100.0


def credit_damage(sc: GameScore, attacker, damage, killed) -> GameScore:
    """Batched damage/kill credit: attacker [K] player ids, damage [K],
    killed [K] bool."""
    attacker = attacker.long()
    score = sc.score.index_add(0, attacker, damage + KILL_BONUS * killed.to(torch.float32))
    kills = sc.kills.index_add(0, attacker, killed.to(torch.int32))
    return sc._replace(score=score, kills=kills)


def credit_death(sc: GameScore, victim) -> GameScore:
    victim = torch.as_tensor(victim, device=sc.deaths.device).long().reshape(-1)
    return sc._replace(deaths=sc.deaths.index_add(
        0, victim, torch.ones_like(victim, dtype=torch.int32)))


def spawn_blood_decals(decals, state: ObjectState, hit_mask,
                       radius: float = 0.02, lifetime: int = 300,
                       max_spawn: int = 16):
    """Blood splatter where objects took damage: decals at the first
    `max_spawn` hit positions (the blood decal path in Gameplay.cpp),
    facing up.  (The JAX function's unused `key` is left out.)"""
    from ..physics import particles as PTC
    idx = torch.nonzero(hit_mask).reshape(-1)[:max_spawn]
    n = int(idx.shape[0])
    if n == 0:
        return decals
    dev = state.px.device
    f = lambda v: torch.full((n,), v, dtype=torch.float32, device=dev)
    i = lambda v: torch.full((n,), v, dtype=torch.int32, device=dev)
    return PTC.spawn_decals(decals, state.px[idx], state.py[idx], state.pz[idx],
                            f(0.0), f(0.0), f(1.0), f(radius), f(1.0), i(-1),
                            i(lifetime))


# ---------------------------------------------------------------------------
# smiley waypoint navigation (ai.cpp: run_a_star + per-smiley path following)
# ---------------------------------------------------------------------------

def route_smileys(s, graph, max_path: int = 16):
    """Host: A* route each smiley from its nearest waypoint to the
    waypoint nearest its current target; returns padded path tensors
    (wx, wy [N, max_path], plen [N]) for `follow_paths`."""
    from .waypoints import run_a_star
    sx, sy, tx, ty = (a.cpu().numpy() for a in (s.x, s.y, s.tx, s.ty))
    gx, gy = np.asarray(graph.x), np.asarray(graph.y)
    n = len(sx)
    wx = np.zeros((n, max_path), np.float32)
    wy = np.zeros((n, max_path), np.float32)
    plen = np.zeros(n, np.int32)
    for i in range(n):
        start = int(np.argmin((gx - sx[i]) ** 2 + (gy - sy[i]) ** 2))
        goal = int(np.argmin((gx - tx[i]) ** 2 + (gy - ty[i]) ** 2))
        path = run_a_star(graph, start, goal)[:max_path]
        for k, w in enumerate(path):
            wx[i, k] = gx[w]
            wy[i, k] = gy[w]
        plen[i] = len(path)
    dev = s.x.device
    return (torch.as_tensor(wx, device=dev), torch.as_tensor(wy, device=dev),
            torch.as_tensor(plen, device=dev))


def follow_paths(s, wx, wy, plen, pos, speed: float = 0.01):
    """Advance each smiley toward its current path waypoint; returns (new
    state, new pos index [N]): waypoint reached -> next."""
    W = wx.shape[1]
    col = torch.clamp(pos, max=W - 1).long()[:, None]
    cx = wx.gather(1, col)[:, 0]
    cy = wy.gather(1, col)[:, 0]
    dx = cx - s.x
    dy = cy - s.y
    d = torch.sqrt(dx * dx + dy * dy) + 1e-9
    step = torch.minimum(torch.full_like(d, speed), d) * (s.health > 0)
    x = s.x + step * dx / d
    y = s.y + step * dy / d
    reached = d < 0.02
    pos2 = torch.where(reached & (pos < plen - 1), pos + 1, pos)
    return s._replace(x=x, y=y), pos2

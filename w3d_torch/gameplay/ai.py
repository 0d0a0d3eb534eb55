"""Deep smiley AI: target selection with LOS + memory, per-situation
weapon choice, range prediction, and island hopping (port of
`3dworld_tpu/gameplay/ai.py`).

Reference behaviors (ai.cpp):
  * `smiley_select_target` (ai.cpp:674): prefer the nearest visible
    enemy (line of sight against cobjs); remember the last-seen position
    and pursue it when sight is lost; stand down when nothing is seen.
  * `check_switch_weapon` (ai.cpp:1238): score every owned weapon with a
    random weight plus situation terms (ranged weapons -0.2 when the
    target is in range, +0.8 when not; +0.5 for non-underwater weapons
    while submerged; bat x1.5, small ball x1.2) and pick the argmin;
    out-of-ammo weapons are excluded.
  * `target_in_range` (ai.cpp:1290): projectile speed vs the enemy's
    relative velocity, and a gravity-weighted z cost shooting upward.
  * `smiley_action` (ai.cpp:1315): fire when in range; re-roll the weapon
    every ~50 frames when outranged, every ~500 otherwise.
  * island hopping (ai.cpp:880-930): a smiley that stays put while it has
    a target is `stuck`, and gets flagged for waypoint routing.

One step over the whole population: P x P pairwise masks, P^2 line of
sight rays through `ops/ray` (every shape family, no host sync), P x W
weapon scores.  The JAX package draws four threefry streams a step; here
they are an `AIDraws` input (`draw_ai` makes them from a generator), and
the spawn of `make_ai_smileys` is an input too (`draw_spawn`).  The
one-hot matmuls are gathers and the ammo update an indexed add.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops import ray as R
from ..physics import types as PT
from . import game as GG

NUM_W = len(GG.WEAPONS)

# static per-weapon columns (Gameplay.cpp:71-93 via game.WEAPONS)
_W_RANGE = np.asarray([w[10] for w in GG.WEAPONS], np.float32)
_W_DELAY = np.asarray([w[4] for w in GG.WEAPONS], np.float32)
_W_VADD = np.asarray([w[3] for w in GG.WEAPONS], np.float32)
_W_UW = np.asarray([w[15] for w in GG.WEAPONS], np.float32)   # usable underwater
_W_NEED_AMMO = np.asarray([w[16] for w in GG.WEAPONS], bool)
_W_DEF_AMMO = np.asarray([w[12] for w in GG.WEAPONS], np.int32)
# per-weapon projectile gravity factor (object_types[obj_id].gravity;
# hitscan weapons fly flat)
_W_GRAV = np.asarray(
    [PT._TABLE.get(w[1], {}).get("grav", 1.0) if w[1] else 0.0 for w in GG.WEAPONS],
    np.float32)
# weapon preference multipliers (check_switch_weapon, ai.cpp:1261-1262)
_W_MULT = np.ones(NUM_W, np.float32)
_W_MULT[GG.WEAPON_INDEX["bbbat"]] = 1.5
_W_MULT[GG.WEAPON_INDEX["sball"]] = 1.2

LOW_HEALTH = 25.0
STUCK_EPS = 1e-3          # displacement below this counts as stuck
STUCK_FRAMES = 30         # frames stuck before flagging for routing
MEM_FRAMES = 240          # give up pursuing a lost target after this


_COLS = {"range": _W_RANGE, "delay": _W_DELAY, "vadd": _W_VADD, "grav": _W_GRAV,
         "need_ammo": _W_NEED_AMMO, "mult": _W_MULT, "dry_only": ~_W_UW.astype(bool),
         "ranged": _W_RANGE > 0.0}
_ON_DEVICE: dict = {}


def _col(name: str, like: torch.Tensor) -> torch.Tensor:
    """A per-weapon column on `like`'s device, copied there once (so an AI
    step copies nothing from the host and a CUDA graph can hold it)."""
    key = (name, like.device)
    if key not in _ON_DEVICE:
        _ON_DEVICE[key] = torch.as_tensor(_COLS[name], device=like.device)
    return _ON_DEVICE[key]


class SmileyAI(NamedTuple):
    """Per-smiley state, a superset of game.SmileyState (same leading
    fields, so route_smileys/follow_paths take it too)."""

    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor
    health: torch.Tensor
    team: torch.Tensor
    tx: torch.Tensor        # current movement target
    ty: torch.Tensor
    cooldown: torch.Tensor
    vx: torch.Tensor        # velocity estimate (for range prediction)
    vy: torch.Tensor
    weapon: torch.Tensor    # [P] int32 selected weapon id
    ammo: torch.Tensor      # [P, W] int32
    ltx: torch.Tensor       # last-seen enemy position (target memory)
    lty: torch.Tensor
    ltz: torch.Tensor
    tvis: torch.Tensor      # 0 = no target, 1 = enemy visible, 2 = pursuing memory
    tmem: torch.Tensor      # frames since the target was last seen
    stuck: torch.Tensor     # consecutive low-displacement frames


class AIDraws(NamedTuple):
    """One AI step's draws: `switch` [P, W] uniform [0, 1) weapon weights,
    `cadence` [P] uniform [0, 1) re-roll draws, `wander_x`, `wander_y`
    [P] standard normals (idle direction)."""

    switch: torch.Tensor
    cadence: torch.Tensor
    wander_x: torch.Tensor
    wander_y: torch.Tensor


def draw_ai(n: int, generator: torch.Generator,
            device: torch.device | str = "cuda") -> AIDraws:
    """AIDraws for `n` smileys from `generator` (on its device), moved to
    `device`."""
    g, gd = generator, generator.device
    u = torch.rand((n, NUM_W + 1), generator=g, dtype=torch.float32, device=gd)
    w = torch.randn((2, n), generator=g, dtype=torch.float32, device=gd)
    u, w = u.to(device), w.to(device)
    return AIDraws(u[:, :NUM_W], u[:, NUM_W], w[0], w[1])


def draw_spawn(n: int, generator: torch.Generator, num_teams: int = 2,
               spread: float = 3.0):
    """Spawn draws (x, y uniform in [-spread, spread), team in [0,
    num_teams)) from `generator`, on its device."""
    g, gd = generator, generator.device
    xy = torch.rand((2, n), generator=g, dtype=torch.float32, device=gd)
    xy = -spread + (2.0 * spread) * xy
    team = torch.randint(0, num_teams, (n,), generator=g, device=gd, dtype=torch.int32)
    return xy[0], xy[1], team


def make_ai_smileys(x, y, team, device: torch.device | str = "cuda") -> SmileyAI:
    """Smileys at (x, y) [n] of `team` [n] (the spawn draws, as inputs)
    with full health, small balls selected and the default ammo."""
    x = torch.as_tensor(x, dtype=torch.float32, device=device)
    n = x.shape[0]
    z = lambda: torch.zeros_like(x)
    zi = lambda: torch.zeros((n,), dtype=torch.int32, device=device)
    return SmileyAI(
        x=x, y=torch.as_tensor(y, dtype=torch.float32, device=device), z=z(),
        health=torch.full_like(x, 100.0),
        team=torch.as_tensor(team, dtype=torch.int32, device=device),
        tx=z(), ty=z(), cooldown=z(), vx=z(), vy=z(),
        weapon=torch.full((n,), GG.WEAPON_INDEX["sball"], dtype=torch.int32, device=device),
        ammo=torch.as_tensor(np.tile(_W_DEF_AMMO[None, :], (n, 1)), device=device),
        ltx=z(), lty=z(), ltz=z(), tvis=zi(), tmem=zi(), stuck=zi())


def los_visible(cobjs, ax, ay, az, bx, by, bz):
    """Segment a->b unobstructed by any cobj (sphere_visible /
    line_intersect inside find_nearest_enemy, ai.cpp:304-343)."""
    dx = bx - ax
    dy = by - ay
    dz = bz - az
    d = torch.sqrt(dx * dx + dy * dy + dz * dz) + 1e-9
    tmax = d * (1.0 - 1e-3)
    hit, t, *_ = R.ray_cobjs_nearest(ax, ay, az, dx / d, dy / d, dz / d, tmax, cobjs)
    return ~(hit & (t < tmax))


def check_switch_weapon(s: SmileyAI, switch_draws, in_range, underwater):
    """check_switch_weapon (ai.cpp:1238-1274): the new [P] weapon choice
    from the [P, W] uniform draws; in_range/underwater are [P] bools."""
    wt = switch_draws
    uw_pen = _col("dry_only", wt)[None, :] & underwater[:, None]
    wt = wt + torch.where(uw_pen, 0.5, 0.0)
    ranged = _col("ranged", wt)[None, :]
    wt = wt + torch.where(ranged, torch.where(in_range[:, None], -0.2, 0.8), 0.0)
    wt = wt * _col("mult", wt)[None, :]
    ok = ~_col("need_ammo", wt)[None, :] | (s.ammo > 0)
    ok = ok & (torch.arange(NUM_W, device=wt.device) >= 1)[None, :]   # never unarmed
    wt = torch.where(ok, wt, torch.inf)
    return torch.argmin(wt, dim=1).to(torch.int32)


def target_in_range(s: SmileyAI, tpx, tpy, tpz, tvx, tvy, has_tgt):
    """target_in_range (ai.cpp:1290-1313): 0 = unreachable (the enemy
    outruns the projectile), 1 = in range, 2 = no target."""
    w = s.weapon.long()
    rng_w = _col("range", s.x)[w]
    wvel = torch.clamp(_col("vadd", s.x)[w], min=1e-3)
    grav = _col("grav", s.x)[w]
    dx = tpx - s.x
    dy = tpy - s.y
    dz = tpz - s.z
    dist = torch.sqrt(dx * dx + dy * dy + dz * dz) + 1e-9
    # enemy velocity component away from us (get_rel_enemy_vel)
    rel_vel = (tvx * dx + tvy * dy) / dist
    outrun = rel_vel > wvel
    eff_rng = rng_w * torch.clamp((wvel - rel_vel) / wvel, 0.0, 1.0)
    xy2 = dx * dx + dy * dy
    # gravity z-cost only when shooting upward (ai.cpp:1309-1312)
    eff_dz = torch.where(dz > 0, (1.0 + grav) * dz, 0.0)
    in_r = (rng_w <= 0.0) | ((xy2 + eff_dz * eff_dz) < eff_rng * eff_rng)
    code = torch.where(outrun, 0, torch.where(in_r, 1, 0))
    return torch.where(has_tgt, code, 2)


def step_smileys_ai(s: SmileyAI, draws: AIDraws, cobjs, speed: float = 0.01,
                    water_z: float = -1.0e9, view_dist: float = 8.0,
                    eye_height: float = 0.05):
    """One AI frame (advance_smiley + smiley_action).

    Returns (s', fire [P] bool, needs_route [P] bool).  `fire` smileys
    shoot their current weapon at (ltx, lty, ltz); ammo is spent here.
    `needs_route` smileys have a live target they cannot walk straight
    toward (island hopping): callers run game.route_smileys/follow_paths
    on them.  Nothing is read back to the host."""
    P = s.x.shape[0]
    alive = s.health > 0

    # ---- pairwise targeting: nearest visible enemy (ai.cpp:674) ----
    ex = s.x[:, None] - s.x[None, :]
    ey = s.y[:, None] - s.y[None, :]
    d2 = ex * ex + ey * ey
    enemy = (s.team[:, None] != s.team[None, :]) & alive[None, :] & alive[:, None]
    # LOS for all pairs in one batched ray call (P^2 rays; P is small)
    eyez = s.z + eye_height
    rows = lambda v: v[:, None].expand(P, P).reshape(-1)
    cols = lambda v: v[None, :].expand(P, P).reshape(-1)
    vis = los_visible(cobjs, rows(s.x), rows(s.y), rows(eyez),
                      cols(s.x), cols(s.y), cols(eyez)).reshape(P, P)
    cand = enemy & vis & (d2 < view_dist * view_dist)
    d2m = torch.where(cand, d2, torch.inf)
    sees_enemy = torch.any(cand, dim=1)
    tgt = torch.argmin(d2m, dim=1)
    vtx, vty, vtz, vtvx, vtvy = (v[tgt] for v in (s.x, s.y, s.z, s.vx, s.vy))

    # ---- target memory (last_target_visible pursuit, ai.cpp:682-698) ----
    tmem = torch.where(sees_enemy, 0, s.tmem + 1)
    pursuing = ~sees_enemy & (s.tvis > 0) & (tmem < MEM_FRAMES)
    reached_mem = pursuing & ((s.ltx - s.x) ** 2 + (s.lty - s.y) ** 2 < 0.01)
    pursuing = pursuing & ~reached_mem
    tvis = torch.where(sees_enemy, 1, torch.where(pursuing, 2, 0)).to(torch.int32)
    ltx = torch.where(sees_enemy, vtx, s.ltx)
    lty = torch.where(sees_enemy, vty, s.lty)
    ltz = torch.where(sees_enemy, vtz, s.ltz)
    has_tgt = tvis > 0

    # ---- range + weapon cadence (smiley_action, ai.cpp:1315-1323) ----
    in_r = target_in_range(s, ltx, lty, ltz, torch.where(sees_enemy, vtvx, 0.0),
                           torch.where(sees_enemy, vtvy, 0.0), sees_enemy)
    underwater = s.z < water_z
    # re-roll every ~50 frames when outranged, ~500 otherwise; always when
    # the current weapon is out of ammo
    w = s.weapon.long()
    need_ammo = _col("need_ammo", s.x)
    no_ammo = (s.ammo.gather(1, w[:, None])[:, 0] <= 0) & need_ammo[w]
    reroll = (draws.cadence < torch.where(in_r == 0, 1.0 / 50.0, 1.0 / 500.0)) | no_ammo
    # ai.cpp:1261: the ranged bonus applies when target_in_range != 0
    new_w = check_switch_weapon(s, draws.switch, in_r != 0, underwater)
    weapon = torch.where(reroll, new_w, s.weapon)

    # ---- movement: seek / pursue / flee / wander ----
    flee = alive & (s.health < LOW_HEALTH) & sees_enemy
    seek = has_tgt & ~flee
    dirx = torch.where(flee, s.x - ltx, ltx - s.x)
    diry = torch.where(flee, s.y - lty, lty - s.y)
    # idle smileys wander (goal mode, ai.cpp:416-424)
    dirx = torch.where(has_tgt | flee, dirx, draws.wander_x)
    diry = torch.where(has_tgt | flee, diry, draws.wander_y)
    dl = torch.sqrt(dirx * dirx + diry * diry) + 1e-9
    move = alive & (seek | flee | ~has_tgt)
    stepx = torch.where(move, speed * dirx / dl, 0.0)
    stepy = torch.where(move, speed * diry / dl, 0.0)
    # don't walk through walls: cancel a step whose path is blocked
    clear = los_visible(cobjs, s.x, s.y, eyez, s.x + stepx * 4.0, s.y + stepy * 4.0, eyez)
    stepx = torch.where(clear, stepx, 0.0)
    stepy = torch.where(clear, stepy, 0.0)
    x = s.x + stepx
    y = s.y + stepy

    # ---- stuck detection -> island hop via waypoints ----
    moved2 = stepx * stepx + stepy * stepy
    stuck = torch.where(has_tgt & (moved2 < STUCK_EPS * STUCK_EPS), s.stuck + 1, 0) \
        .to(torch.int32)
    needs_route = stuck >= STUCK_FRAMES

    # ---- fire (smiley_action: in_range == 1 fires) ----
    fire = alive & (in_r == 1) & sees_enemy & (s.cooldown <= 0)
    wl = weapon.long()
    cooldown = torch.where(fire, _col("delay", s.x)[wl],
                           torch.clamp(s.cooldown - 1.0, min=0.0))
    spend = (fire & need_ammo[wl]).to(torch.int32)
    ammo = s.ammo.clone()
    ammo[torch.arange(P, device=ammo.device), wl] -= spend
    ammo = torch.clamp(ammo, min=0)

    s2 = s._replace(
        x=x, y=y, tx=torch.where(has_tgt, ltx, s.tx),
        ty=torch.where(has_tgt, lty, s.ty),
        cooldown=cooldown, vx=stepx, vy=stepy, weapon=weapon, ammo=ammo,
        ltx=ltx, lty=lty, ltz=ltz, tvis=tvis, tmem=tmem.to(torch.int32), stuck=stuck)
    return s2, fire, needs_route

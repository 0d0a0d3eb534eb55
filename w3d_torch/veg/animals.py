"""Tiled-terrain fauna: flocking birds, fish, butterflies (port of the
tiled half of `3dworld_tpu/veg/animals.py`, `:25-424`).

The reference simulates birds/fish/butterflies in tiled terrain with
flocking behaviors (animals.cpp:689).  Boids take masked neighbor sums
over the population (dense [N,N] pair terms); fish stay below the water
plane, butterflies in an altitude band over the mesh, which they sample
through `ops/cuda/sample_kernel` (kernel B on the card).

The JAX steps draw threefry values; here they are inputs: `draw_*` make
them from a CPU generator, `FaunaDraws` carries a chunk's per-frame
draws, and the spawners take their uniform values ([k, n], each row
already in its range).  The building animals (`:425-605`: spiders,
snakes, flies, tank fish) follow the same rule: their spawners take
uniform rows (`draw_spiders`, `draw_snakes`) and their steps a tick's
rows of `BuildingAnimalDraws`; their sines, cosines and square roots go
through `ops/fmath`.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..ops.cuda import sample_kernel as SK
from ..ops.fmath import cos32, sin32, sqrt32

A_BIRD, A_FISH, A_BUTTERFLY, A_RAT, A_SPIDER, A_SNAKE, A_FLY = range(7)


class AnimalState(NamedTuple):
    px: torch.Tensor
    py: torch.Tensor
    pz: torch.Tensor
    vx: torch.Tensor
    vy: torch.Tensor
    vz: torch.Tensor
    kind: torch.Tensor


def _uniform(g: torch.Generator, shape, lo: float, hi: float) -> torch.Tensor:
    """Uniform float32 in [lo, hi): u * (hi - lo) + lo, at least lo."""
    u = torch.rand(shape, generator=g, dtype=torch.float32)
    return torch.clamp(u * (hi - lo) + lo, min=lo)


def draw_animals(n: int, g: torch.Generator, spread: float = 1.0) -> torch.Tensor:
    """`make_animals`' six [n] uniform rows: x, y, z offsets and x, y, z
    velocities, each in its range."""
    r = ((-spread, spread), (-spread, spread), (-0.2 * spread, 0.2 * spread),
         (-0.01, 0.01), (-0.01, 0.01), (-0.002, 0.002))
    return torch.stack([_uniform(g, (n,), lo, hi) for lo, hi in r])


def make_animals(u6: torch.Tensor, kind: int = A_BIRD,
                 center=(0.0, 0.0, 1.0)) -> AnimalState:
    """A flock around `center` from `draw_animals`' rows (on their device)."""
    n = u6.shape[1]
    return AnimalState(px=center[0] + u6[0], py=center[1] + u6[1], pz=center[2] + u6[2],
                       vx=u6[3], vy=u6[4], vz=u6[5],
                       kind=torch.full((n,), kind, dtype=torch.int32, device=u6.device))


def step_flock(a: AnimalState, zmin, zmax, sep_r: float = 0.08, coh_r: float = 0.5,
               max_speed: float = 0.02, home=(0.0, 0.0)) -> AnimalState:
    """One boids step: separation + alignment + cohesion + homing, with
    altitude clamped to [zmin, zmax] (birds above terrain / fish below
    water)."""
    n = a.px.shape[0]
    ex = a.px[:, None] - a.px[None, :]
    ey = a.py[:, None] - a.py[None, :]
    ez = a.pz[:, None] - a.pz[None, :]
    d2 = ex * ex + ey * ey + ez * ez
    not_self = ~torch.eye(n, dtype=torch.bool, device=a.px.device)
    near = (d2 < coh_r ** 2) & not_self
    nn = torch.clamp(near.sum(1), min=1).to(torch.float32)
    # neighbour sums in float64, rounded once: the card's and the CPU's
    # matmul orders then give the same float32 sums
    w = near.to(torch.float64)
    nsum = lambda m, v: (m @ v.to(torch.float64)).to(torch.float32)
    # cohesion: toward local center
    cx = nsum(w, a.px) / nn - a.px
    cy = nsum(w, a.py) / nn - a.py
    cz = nsum(w, a.pz) / nn - a.pz
    # alignment: toward local mean velocity
    ax_ = nsum(w, a.vx) / nn - a.vx
    ay_ = nsum(w, a.vy) / nn - a.vy
    az_ = nsum(w, a.vz) / nn - a.vz
    # separation: away from too-close neighbors
    close = (d2 < sep_r ** 2) & not_self
    cw = torch.where(close, 1.0 / torch.clamp(d2, min=1e-5), 0.0).to(torch.float64)
    cw_sum = cw.sum(1).to(torch.float32)
    sx = cw_sum * a.px - nsum(cw, a.px)
    sy = cw_sum * a.py - nsum(cw, a.py)
    sz = cw_sum * a.pz - nsum(cw, a.pz)
    # homing: weak pull toward the flock's home region
    hx = home[0] - a.px
    hy = home[1] - a.py
    vx = a.vx + 0.02 * cx + 0.05 * ax_ + 0.002 * sx + 0.001 * hx
    vy = a.vy + 0.02 * cy + 0.05 * ay_ + 0.002 * sy + 0.001 * hy
    vz = a.vz + 0.01 * cz + 0.05 * az_ + 0.002 * sz
    sp = sqrt32(vx * vx + vy * vy + vz * vz) + 1e-9
    lim = torch.clamp(max_speed / sp, max=1.0)
    vx, vy, vz = vx * lim, vy * lim, vz * lim
    px = a.px + vx
    py = a.py + vy
    pz = torch.clamp(a.pz + vz, zmin, zmax)
    vz = torch.where((pz <= zmin) | (pz >= zmax), -vz * 0.5, vz)
    return a._replace(px=px, py=py, pz=pz, vx=vx, vy=vy, vz=vz)


# ---------------------------------------------------------------------------
# tiled-terrain birds (animals.cpp bird_t::update :259 + vect_bird_t::flock
# :297): straight flight with random small turns, plus the reference's
# three xy flocking forces applied at CONSTANT speed
# (apply_force_xy_const_vel :277 — force turns the bird, never slows it)
# ---------------------------------------------------------------------------

BIRD_SPEED = 0.05      # animals.h BIRD_SPEED-equivalent in scene units


def step_birds(a: AnimalState, turn: torch.Tensor, jx: torch.Tensor, jy: torch.Tensor,
               neighbor_dist: float = 0.5, fticks: float = 1.0) -> AnimalState:
    """One bird frame, vectorized over the population.

    bird_t::update: a bird whose `turn` draw (uniform [0, 1)) is below 1/2
    jitters its direction by 5% of the `jx`, `jy` draws (uniform [-1, 1))
    and renormalizes (speed preserved).  Then vect_bird_t::flock applies
    separation (0.05/d^2 within 0.2 nd^2), cohesion (0.05 toward the
    neighborhood mean within 0.3 nd^2) and alignment (0.5 x mean velocity
    within 0.25 nd^2), divided by mass 100, as an xy force that TURNS the
    constant-speed velocity."""
    n = a.px.shape[0]
    speed = torch.sqrt(a.vx ** 2 + a.vy ** 2 + a.vz ** 2) + 1e-12
    do_turn = turn < 0.5
    vx = a.vx + torch.where(do_turn, (0.05 * jx) * speed, 0.0)
    vy = a.vy + torch.where(do_turn, (0.05 * jy) * speed, 0.0)
    vm = torch.sqrt(vx * vx + vy * vy + a.vz ** 2) + 1e-12
    vx, vy, vz = vx * speed / vm, vy * speed / vm, a.vz * speed / vm

    # flock forces (xy distances only, like the reference)
    nd_sq = neighbor_dist * neighbor_dist
    ex = a.px[:, None] - a.px[None, :]
    ey = a.py[:, None] - a.py[None, :]
    dxy_sq = ex * ex + ey * ey
    not_self = ~torch.eye(n, dtype=torch.bool, device=a.px.device)
    sep = not_self & (dxy_sq < 0.2 * nd_sq)
    coh = not_self & (dxy_sq < 0.3 * nd_sq)
    ali = not_self & (dxy_sq < 0.25 * nd_sq)
    inv_d2 = torch.where(sep, 1.0 / torch.clamp(dxy_sq, min=1e-8), 0.0)
    fx = 0.05 * torch.sum(ex * inv_d2, dim=1)
    fy = 0.05 * torch.sum(ey * inv_d2, dim=1)
    pc = torch.clamp(coh.sum(1), min=1).to(torch.float32)
    cw = coh.to(torch.float32)
    has_coh = coh.any(1).to(torch.float32)
    fx = fx + 0.05 * ((cw @ a.px) / pc - a.px) * has_coh
    fy = fy + 0.05 * ((cw @ a.py) / pc - a.py) * has_coh
    vc = torch.clamp(ali.sum(1), min=1).to(torch.float32)
    aw = ali.to(torch.float32)
    has_ali = ali.any(1).to(torch.float32)
    fx = fx + 0.5 * (aw @ a.vx) / vc * has_ali
    fy = fy + 0.5 * (aw @ a.vy) / vc * has_ali
    # apply_force_xy_const_vel: add xy force/mass, renormalize to speed
    vx2 = vx + fx / 100.0
    vy2 = vy + fy / 100.0
    vm2 = torch.sqrt(vx2 * vx2 + vy2 * vy2 + vz * vz) + 1e-12
    vx, vy, vz = vx2 * speed / vm2, vy2 * speed / vm2, vz * speed / vm2
    return a._replace(px=a.px + vx * fticks, py=a.py + vy * fticks,
                      pz=a.pz + vz * fticks, vx=vx, vy=vy, vz=vz)


# ---------------------------------------------------------------------------
# tiled-terrain fish (animals.cpp fish_t::update :219): scatter from the
# player, drag back to cruise speed, random heading updates, shallow-water
# revert
# ---------------------------------------------------------------------------

FISH_SPEED = 0.002


def draw_fish(n: int, world, g: torch.Generator) -> torch.Tensor:
    """`gen_fish`' four [n] uniform rows: x, y over the scene, the depth
    fraction in [0, 1) and the heading in [0, 2 pi)."""
    return torch.stack([_uniform(g, (n,), -world.x_scene, world.x_scene),
                        _uniform(g, (n,), -world.y_scene, world.y_scene),
                        _uniform(g, (n,), 0.0, 1.0),
                        _uniform(g, (n,), 0.0, 2 * math.pi)])


def gen_fish(u4: torch.Tensor, mesh: torch.Tensor, water_z: float, world,
             half_height: float = 0.01) -> AnimalState:
    """fish_t::gen: xy from `draw_fish`' rows, kept only where the water
    depth over the mesh exceeds 0.1; z between mesh + 1.6 hh and water_z -
    2 hh (disabled fish get kind -1)."""
    n = u4.shape[1]
    px, py, u, ang = u4.unbind(0)
    h = SK.sample_mesh(mesh, px.contiguous(), py.contiguous(), world)[0]
    depth = water_z - h
    fzmin = h + 1.6 * half_height
    fzmax = water_z - 2.0 * half_height
    ok = (depth > 0.1) & (fzmin < fzmax)
    pz = fzmin + u * torch.clamp(fzmax - fzmin, min=0.0)
    sp = FISH_SPEED
    return AnimalState(px=px, py=py, pz=pz, vx=sp * torch.cos(ang), vy=sp * torch.sin(ang),
                       vz=torch.zeros((n,), dtype=torch.float32, device=px.device),
                       kind=torch.where(ok, A_FISH, -1).to(torch.int32))


def step_fish(a: AnimalState, rnd: torch.Tensor, jx: torch.Tensor, jy: torch.Tensor,
              ang: torch.Tensor, mesh: torch.Tensor, world, player_pos,
              half_height: float = 0.01, fticks: float = 1.0) -> AnimalState:
    """fish_t::update, vectorized: within 15 r of the player swim
    directly AWAY at 10x cruise speed (xy only); when fast, drag by
    0.96^fticks; else a heading jitter of +-25% (`jx`, `jy` uniform
    [-1, 1)) where the `rnd` draw (int in [0, 128)) is 0.  A move into
    water shallower than 1.5 half-heights reverts and re-rolls the
    heading to `ang` (uniform [0, 2 pi)), or freezes when chased."""
    alive = a.kind >= 0
    dx = a.px - player_pos[0]
    dy = a.py - player_pos[1]
    dz = a.pz - player_pos[2]
    d = torch.sqrt(dx * dx + dy * dy + dz * dz) + 1e-9
    radius = 2.0 * half_height
    chased = d < 15.0 * radius
    away = torch.sqrt(dx * dx + dy * dy) + 1e-9
    vx = torch.where(chased, 10.0 * FISH_SPEED * dx / away, a.vx)
    vy = torch.where(chased, 10.0 * FISH_SPEED * dy / away, a.vy)
    vz = torch.where(chased, 0.0, a.vz)
    speed = torch.sqrt(vx * vx + vy * vy + vz * vz)
    far = d > 20.0 * radius
    drag = far & (speed > FISH_SPEED)
    scale = torch.where(drag, 0.96 ** fticks, 1.0)
    vx, vy, vz = vx * scale, vy * scale, vz * scale
    jit = far & ~drag & (rnd == 0)
    vm = torch.sqrt(vx * vx + vy * vy) + 1e-12
    nvx = vx / vm + 0.25 * jx
    nvy = vy / vm + 0.25 * jy
    nvm = torch.sqrt(nvx * nvx + nvy * nvy) + 1e-12
    vx = torch.where(jit, speed * nvx / nvm, vx)
    vy = torch.where(jit, speed * nvy / nvm, vy)
    # try the move; revert where the water is too shallow
    px = a.px + vx * fticks
    py = a.py + vy * fticks
    pz = a.pz + vz * fticks
    h = SK.sample_mesh(mesh, px, py, world)[0]
    too_shallow = (pz - 1.5 * half_height) < h
    vx = torch.where(too_shallow, torch.where(chased, 0.0, FISH_SPEED * torch.cos(ang)), vx)
    vy = torch.where(too_shallow, torch.where(chased, 0.0, FISH_SPEED * torch.sin(ang)), vy)
    px = torch.where(too_shallow, a.px, px)
    py = torch.where(too_shallow, a.py, py)
    pz = torch.where(too_shallow, a.pz, pz)
    return a._replace(px=torch.where(alive, px, a.px), py=torch.where(alive, py, a.py),
                      pz=torch.where(alive, pz, a.pz), vx=torch.where(alive, vx, 0.0),
                      vy=torch.where(alive, vy, 0.0), vz=torch.where(alive, vz, 0.0))


# ---------------------------------------------------------------------------
# butterflies (animals.cpp butterfly_t::update :335): acceleration random
# walks, xy heading rotation, altitude band over mesh/water, destination
# seek with rest at arrival and explore phases (update_dest :436)
# ---------------------------------------------------------------------------

class ButterflyState(NamedTuple):
    px: torch.Tensor
    py: torch.Tensor
    pz: torch.Tensor
    dirx: torch.Tensor      # unit xy heading
    diry: torch.Tensor
    speed: torch.Tensor     # nominal forward speed
    fwd_accel: torch.Tensor     # the three [-1,1] accel random walks
    rot_accel: torch.Tensor
    alt_accel: torch.Tensor
    speed_factor: torch.Tensor  # [0.5, 1.5]
    rot_rate: torch.Tensor      # [-1, 1]
    alt_change: torch.Tensor    # [-1, 1]
    rest_time: torch.Tensor     # frames left resting at a flower
    explore_time: torch.Tensor  # frames of free roam before seeking a dest
    dest_x: torch.Tensor
    dest_y: torch.Tensor
    dest_z: torch.Tensor
    dest_valid: torch.Tensor    # bool


BFLY_RADIUS = 0.02
BFLY_SPEED = 0.004


def draw_butterflies(n: int, world, g: torch.Generator) -> torch.Tensor:
    """`make_butterflies`' four [n] uniform rows: x, y over the scene, the
    heading in [0, 2 pi) and the altitude in [0.2, 0.8)."""
    return torch.stack([_uniform(g, (n,), -world.x_scene, world.x_scene),
                        _uniform(g, (n,), -world.y_scene, world.y_scene),
                        _uniform(g, (n,), 0.0, 2 * math.pi),
                        _uniform(g, (n,), 0.2, 0.8)])


def make_butterflies(u4: torch.Tensor) -> ButterflyState:
    """Butterflies from `draw_butterflies`' rows (on their device)."""
    px, py, ang, alt = u4.unbind(0)
    z = lambda v=0.0: torch.full_like(px, v)
    return ButterflyState(
        px=px, py=py, pz=alt, dirx=torch.cos(ang), diry=torch.sin(ang),
        speed=z(BFLY_SPEED), fwd_accel=z(), rot_accel=z(), alt_accel=z(),
        speed_factor=z(1.0), rot_rate=z(), alt_change=z(),
        rest_time=z(), explore_time=z(60.0),
        dest_x=px, dest_y=py, dest_z=alt,
        dest_valid=torch.zeros(px.shape, dtype=torch.bool, device=px.device))


def step_butterflies(b: ButterflyState, u_explore: torch.Tensor, u_fwd: torch.Tensor,
                     u_rot: torch.Tensor, u_alt: torch.Tensor, u_rest: torch.Tensor,
                     mesh: torch.Tensor, world, water_z: float = -1.0e9,
                     fticks: float = 1.0) -> ButterflyState:
    """One butterfly frame (butterfly_t::update).  Draws: `u_explore`
    and `u_rest` uniform [0, 1) (the explore and rest times), `u_fwd`,
    `u_rot`, `u_alt` uniform [-1, 1) (the three accel random walks).
    The JAX step's optional flower destinations are not ported (the
    tiled path passes none)."""
    resting = b.rest_time > 0.0
    rest_time = torch.clamp(b.rest_time - fticks, min=0.0)
    lift_off = resting & (rest_time <= 0.0)
    explore_time = torch.where(lift_off, 15.0 + 15.0 * u_explore,
                               torch.clamp(b.explore_time - fticks, min=0.0))
    alt_change0 = torch.where(lift_off, 0.5, b.alt_change)

    # the three accel random walks (update_accel: +-0.25 fticks clip pm1)
    upd = lambda acc, u: torch.clamp(acc + 0.25 * fticks * u, -1.0, 1.0)
    fwd = upd(b.fwd_accel, u_fwd)
    rot = upd(b.rot_accel, u_rot)
    alt = upd(b.alt_accel, u_alt)
    uf = 0.01 * fticks
    speed_factor = torch.clamp(b.speed_factor + uf * fwd, 0.5, 1.5)
    rot_rate = torch.clamp(b.rot_rate + uf * rot, -1.0, 1.0)
    alt_change = torch.clamp(alt_change0 + uf * alt, -1.0, 1.0)
    delta_t = speed_factor * fticks
    rot_angle = 0.0005 * 2 * math.pi * delta_t * rot_rate * 100.0
    ca, sa = torch.cos(rot_angle), torch.sin(rot_angle)
    dirx = b.dirx * ca - b.diry * sa
    diry = b.dirx * sa + b.diry * ca

    # destination bias (dest_valid branch): blend heading toward dest
    ddx = b.dest_x - b.px
    ddy = b.dest_y - b.py
    rel_xy = torch.sqrt(ddx * ddx + ddy * ddy) / BFLY_RADIUS
    alignment = torch.where(b.dest_valid, 1.0 - torch.clamp(0.005 * rel_xy, max=1.0), 0.0)
    dl = torch.sqrt(ddx * ddx + ddy * ddy) + 1e-9
    blend = 0.3 * alignment + 0.1
    bx = torch.where(b.dest_valid, (1 - blend) * dirx + blend * ddx / dl, dirx)
    by = torch.where(b.dest_valid, (1 - blend) * diry + blend * ddy / dl, diry)
    bl = torch.sqrt(bx * bx + by * by) + 1e-9
    dirx, diry = bx / bl, by / bl
    # altitude toward dest when aligned (alt_change += 2 v^2 sign(dz))
    v = torch.clamp(alignment - 0.5, min=0.0)
    dz = b.dest_z - b.pz
    alt_change = torch.clamp(
        alt_change + 2.0 * v * v * torch.sign(dz)
        * torch.clamp(torch.abs(dz) / BFLY_RADIUS, max=1.0), -1.0, 1.0)

    move = ~resting | lift_off
    px = b.px + torch.where(move, b.speed * dirx * delta_t * 10.0, 0.0)
    py = b.py + torch.where(move, b.speed * diry * delta_t * 10.0, 0.0)
    pz = b.pz + torch.where(move, 0.4 * alt_change * delta_t * BFLY_RADIUS, 0.0)

    # altitude band over terrain/water (get_butterfly_min/max_alt)
    h = SK.sample_mesh(mesh, px, py, world)[0]
    zmin_val = torch.clamp(h, min=water_z) + 2.0 * BFLY_RADIUS
    max_alt = 0.10 * (world.x_scene + world.y_scene)
    pz = torch.minimum(torch.maximum(pz, zmin_val), zmin_val + max_alt)

    # arrival: rest 5-10 s (at flowers), clear dest
    at_dest = b.dest_valid & (dl < 4.0 * BFLY_RADIUS)
    rest_time = torch.where(at_dest, 5.0 + 5.0 * u_rest, rest_time)
    dest_valid = b.dest_valid & ~at_dest
    return b._replace(px=px, py=py, pz=pz, dirx=dirx, diry=diry,
                      fwd_accel=fwd, rot_accel=rot, alt_accel=alt,
                      speed_factor=speed_factor, rot_rate=rot_rate,
                      alt_change=alt_change, rest_time=rest_time,
                      explore_time=explore_time, dest_valid=dest_valid)


class FaunaDraws(NamedTuple):
    """A chunk's fauna draws, [K, n] per frame: the birds' (`turn`
    uniform [0, 1), `jx`, `jy` uniform [-1, 1)), the butterflies'
    (`explore`, `rest` uniform [0, 1); `fwd`, `rot`, `alt` uniform
    [-1, 1)) and the fish's (`rnd` int32 in [0, 128); `jx`, `jy` uniform
    [-1, 1); `ang` uniform [0, 2 pi))."""

    bird_turn: torch.Tensor
    bird_jx: torch.Tensor
    bird_jy: torch.Tensor
    bfly_explore: torch.Tensor
    bfly_fwd: torch.Tensor
    bfly_rot: torch.Tensor
    bfly_alt: torch.Tensor
    bfly_rest: torch.Tensor
    fish_rnd: torch.Tensor
    fish_jx: torch.Tensor
    fish_jy: torch.Tensor
    fish_ang: torch.Tensor


def draw_fauna(frames: int, n_birds: int, n_bfly: int, n_fish: int,
               g: torch.Generator, device: torch.device | str = "cuda") -> FaunaDraws:
    """A chunk's `FaunaDraws` from a CPU generator, copied to `device`."""
    u = lambda n, lo=0.0, hi=1.0: _uniform(g, (frames, n), lo, hi)
    d = FaunaDraws(
        bird_turn=u(n_birds), bird_jx=u(n_birds, -1.0, 1.0), bird_jy=u(n_birds, -1.0, 1.0),
        bfly_explore=u(n_bfly), bfly_fwd=u(n_bfly, -1.0, 1.0), bfly_rot=u(n_bfly, -1.0, 1.0),
        bfly_alt=u(n_bfly, -1.0, 1.0), bfly_rest=u(n_bfly),
        fish_rnd=torch.randint(0, 128, (frames, n_fish), generator=g, dtype=torch.int32),
        fish_jx=u(n_fish, -1.0, 1.0), fish_jy=u(n_fish, -1.0, 1.0),
        fish_ang=u(n_fish, 0.0, 2 * math.pi))
    return FaunaDraws(*(v.to(device) for v in d))


def step_tiled_fauna(birds: AnimalState, bfly: ButterflyState, fish: AnimalState,
                     draws: FaunaDraws, mesh: torch.Tensor, world, water_z: float,
                     player_x: float, player_y: float, frames: int = 1):
    """`frames` frames of the tiled-terrain fauna — birds (flock),
    butterflies (accel walks + altitude band), fish (scatter/cruise) —
    queued without a host sync (the per-tile update loop of
    tile_draw_t::update_animals, animals.cpp); frame k reads row k of
    `draws`.  Two mesh samples a frame (butterflies, fish)."""
    for k in range(frames):
        birds = step_birds(birds, draws.bird_turn[k], draws.bird_jx[k], draws.bird_jy[k])
        bfly = step_butterflies(bfly, draws.bfly_explore[k], draws.bfly_fwd[k],
                                draws.bfly_rot[k], draws.bfly_alt[k], draws.bfly_rest[k],
                                mesh, world, water_z=water_z)
        fish = step_fish(fish, draws.fish_rnd[k], draws.fish_jx[k], draws.fish_jy[k],
                         draws.fish_ang[k], mesh, world, (player_x, player_y, water_z))
    return birds, bfly, fish


# ---------------------------------------------------------------------------
# building spiders (building_animals.cpp:1005-1140 update_spiders)
# ---------------------------------------------------------------------------

class SpiderState(NamedTuple):
    """Wall/floor walkers: xy position + heading, z climbs toward a target
    height on walls; squished spiders stop moving."""

    px: torch.Tensor
    py: torch.Tensor
    pz: torch.Tensor
    hx: torch.Tensor       # unit heading (xy)
    hy: torch.Tensor
    tz: torch.Tensor       # climb target height
    speed: torch.Tensor
    squished: torch.Tensor  # bool


def draw_spiders(n: int, bounds, g: torch.Generator, size_range=(0.5, 1.0)) -> torch.Tensor:
    """`make_spiders`' five [n] uniform rows: heading angle, x, y, climb
    target and speed factor, each in its range."""
    x1, y1, x2, y2 = bounds
    r = ((0.0, 2.0 * math.pi), (x1, x2), (y1, y2), (0.0, 0.5), tuple(size_range))
    return torch.stack([_uniform(g, (n,), lo, hi) for lo, hi in r])


def make_spiders(u5: torch.Tensor, base_speed: float = 0.004) -> SpiderState:
    """add_animals_on_floor + set_spider_speed (speed = base * U(0.5,1)),
    from `draw_spiders`' rows (on their device)."""
    n = u5.shape[1]
    z = torch.zeros((n,), dtype=torch.float32, device=u5.device)
    return SpiderState(px=u5[1], py=u5[2], pz=z, hx=cos32(u5[0]), hy=sin32(u5[0]),
                       tz=u5[3], speed=base_speed * u5[4],
                       squished=torch.zeros((n,), dtype=torch.bool, device=u5.device))


def step_spiders(s: SpiderState, turn_u: torch.Tensor, ang: torch.Tensor,
                 new_tz: torch.Tensor, bounds, turn_prob: float = 0.02) -> SpiderState:
    """One spider tick: walk the heading, bounce off the room bounds,
    occasionally retarget heading and climb height (update_spider's
    direction-change logic, batched).  Draws, [n] each: `turn_u` uniform
    [0, 1), `ang` uniform [0, 2 pi), `new_tz` uniform [0, ceil_z)."""
    x1, y1, x2, y2 = bounds
    alive = ~s.squished
    mv = s.speed * alive
    near_wall = (s.px - x1 < 0.05) | (x2 - s.px < 0.05) | \
                (s.py - y1 < 0.05) | (y2 - s.py < 0.05)
    climbing = near_wall & (s.pz < s.tz - 0.01)
    # wall climbers hold xy and ascend; others walk the heading
    px = s.px + torch.where(climbing, 0.0, mv * s.hx)
    py = s.py + torch.where(climbing, 0.0, mv * s.hy)
    # wall bounce (reflect heading) only when not climbing
    hx = torch.where(((px < x1) | (px > x2)) & ~climbing, -s.hx, s.hx)
    hy = torch.where(((py < y1) | (py > y2)) & ~climbing, -s.hy, s.hy)
    px = torch.clamp(px, x1, x2)
    py = torch.clamp(py, y1, y2)
    pz = torch.where(climbing, s.pz + mv,
                     torch.where(near_wall, s.pz, torch.clamp(s.pz - mv, min=0.0)))
    # random retarget
    turn = turn_u < turn_prob
    hx = torch.where(turn, cos32(ang), hx)
    hy = torch.where(turn, sin32(ang), hy)
    tz = torch.where(turn, new_tz, s.tz)
    return s._replace(px=px, py=py, pz=pz, hx=hx, hy=hy, tz=tz)


def squish_spiders(s: SpiderState, x, y, radius: float = 0.05) -> SpiderState:
    """Player steps at (x, y): nearby floor spiders squish (they stop
    being updated, as the reference's `squished` flag)."""
    d2 = (s.px - x) ** 2 + (s.py - y) ** 2
    hit = (d2 < radius * radius) & (s.pz < 0.02)
    return s._replace(squished=s.squished | hit)


# ---------------------------------------------------------------------------
# building snakes (building_animals.cpp:1653-1900 update_snakes)
# ---------------------------------------------------------------------------

class SnakeState(NamedTuple):
    """Segmented bodies: the head wanders; each segment follows the one
    ahead of it (the reference stores per-snake segment chains)."""

    sx: torch.Tensor       # [N, S] segment x (segment 0 = head)
    sy: torch.Tensor
    hx: torch.Tensor       # [N] head heading
    hy: torch.Tensor
    speed: torch.Tensor


def draw_snakes(n: int, bounds, g: torch.Generator) -> torch.Tensor:
    """`make_snakes`' four [n] uniform rows: heading angle, head x, head y
    and speed factor, each in its range."""
    x1, y1, x2, y2 = bounds
    r = ((0.0, 2.0 * math.pi), (x1, x2), (y1, y2), (0.5, 1.0))
    return torch.stack([_uniform(g, (n,), lo, hi) for lo, hi in r])


def make_snakes(u4: torch.Tensor, num_segs: int = 10, base_speed: float = 0.003,
                seg_gap: float = 0.02) -> SnakeState:
    hx, hy = cos32(u4[0]), sin32(u4[0])
    offs = torch.arange(num_segs, dtype=torch.float32, device=u4.device) * seg_gap
    return SnakeState(sx=u4[1][:, None] - hx[:, None] * offs[None, :],
                      sy=u4[2][:, None] - hy[:, None] * offs[None, :],
                      hx=hx, hy=hy, speed=base_speed * u4[3])


def step_snakes(s: SnakeState, turn_u: torch.Tensor, dth_u: torch.Tensor, bounds,
                seg_gap: float = 0.02, turn_prob: float = 0.03) -> SnakeState:
    """Head wanders with bounded turns; body segments chase the segment
    ahead, keeping `seg_gap` spacing (the follow constraint the reference
    enforces per segment pair).  Draws, [n] each: `turn_u` uniform
    [0, 1), `dth_u` uniform [-0.8, 0.8)."""
    x1, y1, x2, y2 = bounds
    # head move + bounce + random small turns
    hx = torch.where((s.sx[:, 0] < x1) | (s.sx[:, 0] > x2), -s.hx, s.hx)
    hy = torch.where((s.sy[:, 0] < y1) | (s.sy[:, 0] > y2), -s.hy, s.hy)
    turn = turn_u < turn_prob
    dth = dth_u * turn
    ca, sa = cos32(dth), sin32(dth)
    hx, hy = hx * ca - hy * sa, hx * sa + hy * ca
    head_x = torch.clamp(s.sx[:, 0] + s.speed * hx, x1, x2)
    head_y = torch.clamp(s.sy[:, 0] + s.speed * hy, y1, y2)
    # segments follow: seg i moves toward seg i-1 to seg_gap spacing
    prev_x = torch.cat([head_x[:, None], s.sx[:, :-1]], dim=1)
    prev_y = torch.cat([head_y[:, None], s.sy[:, :-1]], dim=1)
    dx = prev_x - s.sx
    dy = prev_y - s.sy
    d = sqrt32(dx * dx + dy * dy) + 1e-9
    pull = torch.clamp(d - seg_gap, min=0.0) / d
    sx = torch.cat([head_x[:, None], (s.sx + dx * pull)[:, 1:]], dim=1)
    sy = torch.cat([head_y[:, None], (s.sy + dy * pull)[:, 1:]], dim=1)
    return s._replace(sx=sx, sy=sy, hx=hx, hy=hy)


# ---------------------------------------------------------------------------
# flies + tank fish (building_animals.cpp flies; building_fish.cpp fish
# constrained to tanks / flooded rooms) — thin bounded-flock wrappers
# ---------------------------------------------------------------------------

def make_flies(u6: torch.Tensor, center) -> AnimalState:
    """A fly swarm buzzing around an attractor (trash/food): tiny
    erratic boids homed on `center`, from `draw_animals(n, g, spread)`'s
    rows."""
    a = make_animals(u6, A_FLY, center=center)
    return a._replace(vx=a.vx * 3.0, vy=a.vy * 3.0, vz=a.vz * 5.0)


def step_flies(a: AnimalState, jn: torch.Tensor, center) -> AnimalState:
    """Erratic jitter + strong homing; flies never wander far from the
    attractor (register_fly_attract semantics).  `jn` [3, n] standard
    normal draws (x, y, z jitter)."""
    jx, jy, jz = 0.004 * jn[0], 0.004 * jn[1], 0.004 * jn[2]
    hx = (center[0] - a.px) * 0.02
    hy = (center[1] - a.py) * 0.02
    hz = (center[2] - a.pz) * 0.02
    vx = torch.clamp(0.9 * a.vx + jx + hx, -0.02, 0.02)
    vy = torch.clamp(0.9 * a.vy + jy + hy, -0.02, 0.02)
    vz = torch.clamp(0.9 * a.vz + jz + hz, -0.02, 0.02)
    return a._replace(px=a.px + vx, py=a.py + vy, pz=a.pz + vz, vx=vx, vy=vy, vz=vz)


def step_tank_fish(a: AnimalState, bounds, sep_r: float = 0.02,
                   max_speed: float = 0.005) -> AnimalState:
    """Fish schooling inside a box (pet-store tanks / flooded rooms,
    building_fish.cpp): the flock step plus hard wall reflection."""
    x1, y1, z1, x2, y2, z2 = bounds
    a = step_flock(a, z1, z2, sep_r=sep_r, coh_r=0.2, max_speed=max_speed,
                   home=(0.5 * (x1 + x2), 0.5 * (y1 + y2)))
    vx = torch.where((a.px < x1) | (a.px > x2), -a.vx, a.vx)
    vy = torch.where((a.py < y1) | (a.py > y2), -a.vy, a.vy)
    vz = torch.where((a.pz < z1) | (a.pz > z2), -a.vz, a.vz)
    return a._replace(px=torch.clamp(a.px, x1, x2), py=torch.clamp(a.py, y1, y2),
                      pz=torch.clamp(a.pz, z1, z2), vx=vx, vy=vy, vz=vz)


class BuildingAnimalDraws(NamedTuple):
    """K ticks of the building animals' draws, [K, n] per tick: the
    spiders' (`turn` and `tz` uniform [0, 1) and [0, ceil_z), `ang`
    uniform [0, 2 pi)), the snakes' (`turn` uniform [0, 1), `dth`
    uniform [-0.8, 0.8)) and the flies' jitter ([K, 3, n] normal)."""

    spider_turn: torch.Tensor
    spider_ang: torch.Tensor
    spider_tz: torch.Tensor
    snake_turn: torch.Tensor
    snake_dth: torch.Tensor
    fly_jitter: torch.Tensor


def draw_building_animals(ticks: int, n_spiders: int, n_snakes: int, n_flies: int,
                          g: torch.Generator, ceil_z: float = 0.5,
                          device: torch.device | str = "cuda") -> BuildingAnimalDraws:
    """K ticks' `BuildingAnimalDraws` from a CPU generator, copied to
    `device`."""
    u = lambda n, lo=0.0, hi=1.0: _uniform(g, (ticks, n), lo, hi)
    d = BuildingAnimalDraws(
        spider_turn=u(n_spiders), spider_ang=u(n_spiders, 0.0, 2 * math.pi),
        spider_tz=u(n_spiders, 0.0, ceil_z), snake_turn=u(n_snakes),
        snake_dth=u(n_snakes, -0.8, 0.8),
        fly_jitter=torch.randn((ticks, 3, n_flies), generator=g, dtype=torch.float32))
    return BuildingAnimalDraws(*(v.to(device) for v in d))


def step_building_animals(spiders: SpiderState, snakes: SnakeState, flies: AnimalState,
                          fish: AnimalState, draws: BuildingAnimalDraws, room_bounds,
                          fly_center, tank_bounds, ticks: int):
    """`ticks` ticks of a room's spiders and snakes (within the xy
    `room_bounds`), a fly swarm around `fly_center` and tank fish in
    `tank_bounds`, queued without a host sync; tick k reads row k of
    `draws`."""
    for k in range(ticks):
        spiders = step_spiders(spiders, draws.spider_turn[k], draws.spider_ang[k],
                               draws.spider_tz[k], room_bounds)
        snakes = step_snakes(snakes, draws.snake_turn[k], draws.snake_dth[k], room_bounds)
        flies = step_flies(flies, draws.fly_jitter[k], fly_center)
        fish = step_tank_fish(fish, tank_bounds)
    return spiders, snakes, flies, fish

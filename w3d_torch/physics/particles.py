"""Secondary particle pools: bubbles, particle clouds (smoke puffs),
fires, decals (port of `3dworld_tpu/physics/particles.py`).

The reference keeps these in dedicated fixed pools (`obj_vector_t`,
physics_objects.h) updated by `X::apply_physics` (Physics.cpp:1412-1590):

* bubble: rises at its velocity, pops at the water surface, dies
  outside the mesh or frozen (Physics.cpp:1412-1431);
* particle_cloud: drifts with wind*0.5 + init_vel (z-wind halved),
  density *= 0.97^dt, darkness *= 0.98^dt, radius *= 1.03^dt, dies
  above the cloud ceiling / past max radius / underwater
  (Physics.cpp:1434-1475);
* fire: velocity decays 0.95^dt plus wind + jitter, radius random-walks
  with updraft coupling, heat relaxes toward U(0.25,1.2)/(0.9+2r),
  extinguishes on timeout / tiny radius / underwater, deposits surface
  damage 20*r*heat near the mesh (Physics.cpp:1497-1574);
* decal: ages out at `lifetime`; alpha holds 1 for the first half then
  fades linearly (Physics.cpp:1582-1590).

Every pool is a fixed-capacity SoA; a spawn fills the free slots in slot
order (a stable sort of the status) and each update is one elementwise
pass.  The fire jitter, which the JAX package draws from threefry, is a
`FireDraws` input; the surface damage deposit is an indexed add.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

W_FREEZE_POINT = 0.0
MAX_PART_CLOUD_RAD = 0.25
CLOUD_CEILING = 0.5
MAX_FIRE_TIME = 10000
FIRE_TOL = 1e-4


def alloc_slots(status, n_new: int):
    """Indices of up to min(n_new, capacity) dead slots (status == 0),
    lowest index first; `ok` masks the slots that are really free (spawns
    beyond capacity are dropped)."""
    order = torch.argsort(status, stable=True)   # dead (0) sort first
    idx = order[:min(n_new, status.shape[0])]
    return idx, status[idx] == 0


def _putter(idx, ok):
    """set() that tolerates spawn batches larger than the pool."""
    k = idx.shape[0]

    def put(a, v):
        v = torch.as_tensor(v, dtype=a.dtype, device=a.device)
        out = a.clone()
        out[idx] = torch.where(ok, v[:k], a[idx])
        return out

    return put


def _zeros(capacity, n, device, int_tail=2):
    z = lambda dt: torch.zeros((capacity,), dtype=dt, device=device)
    return [z(torch.float32) for _ in range(n - int_tail)] + \
        [z(torch.int32) for _ in range(int_tail)]


class BubblePool(NamedTuple):
    px: torch.Tensor
    py: torch.Tensor
    pz: torch.Tensor
    vel: torch.Tensor      # vertical rise speed
    radius: torch.Tensor
    time: torch.Tensor
    status: torch.Tensor   # int32: 0 dead, 1 live


def make_bubbles(capacity: int, device: torch.device | str = "cuda") -> BubblePool:
    return BubblePool(*_zeros(capacity, 7, device))


def spawn_bubbles(p: BubblePool, x, y, z, vel, radius) -> BubblePool:
    """Add a batch of bubbles ([K] tensors) into free slots."""
    idx, ok = alloc_slots(p.status, x.shape[0])
    put = _putter(idx, ok)
    return p._replace(
        px=put(p.px, x), py=put(p.py, y), pz=put(p.pz, z),
        vel=put(p.vel, vel), radius=put(p.radius, radius),
        time=put(p.time, torch.zeros_like(x, dtype=torch.int32)),
        status=put(p.status, ok.to(torch.int32)))


def step_bubbles(p: BubblePool, tstep, water_z, temperature,
                 mesh_xy_bound) -> tuple[BubblePool, torch.Tensor]:
    """One tick; returns (pool, popped mask): popped bubbles are where the
    caller draws splashes (draw_splash, Physics.cpp:1428)."""
    live = p.status > 0
    frozen = torch.as_tensor(temperature) <= W_FREEZE_POINT
    pz = p.pz + tstep * p.vel
    outside = (torch.abs(p.px) > mesh_xy_bound) | (torch.abs(p.py) > mesh_xy_bound)
    popped = live & ~frozen.to(p.pz.device) & ~outside & (pz >= water_z)
    status = torch.where(live & (frozen.to(p.pz.device) | outside | popped), 0, p.status)
    return p._replace(pz=torch.where(live, pz, p.pz), time=p.time + live.to(torch.int32),
                      status=status), popped


class CloudPool(NamedTuple):
    px: torch.Tensor
    py: torch.Tensor
    pz: torch.Tensor
    ivx: torch.Tensor      # init_vel
    ivy: torch.Tensor
    ivz: torch.Tensor
    radius: torch.Tensor
    density: torch.Tensor
    darkness: torch.Tensor
    damage: torch.Tensor
    time: torch.Tensor
    status: torch.Tensor


def make_clouds(capacity: int, device: torch.device | str = "cuda") -> CloudPool:
    return CloudPool(*_zeros(capacity, 12, device))


def spawn_clouds(p: CloudPool, x, y, z, ivx, ivy, ivz, radius, density,
                 darkness, damage) -> CloudPool:
    idx, ok = alloc_slots(p.status, x.shape[0])
    put = _putter(idx, ok)
    return p._replace(
        px=put(p.px, x), py=put(p.py, y), pz=put(p.pz, z),
        ivx=put(p.ivx, ivx), ivy=put(p.ivy, ivy), ivz=put(p.ivz, ivz),
        radius=put(p.radius, radius), density=put(p.density, density),
        darkness=put(p.darkness, darkness), damage=put(p.damage, damage),
        time=put(p.time, torch.zeros_like(x, dtype=torch.int32)),
        status=put(p.status, ok.to(torch.int32)))


def _pow(base: float, e):
    """base ** e for a float32 exponent tensor (jnp.power(base, e))."""
    return torch.pow(torch.as_tensor(base, dtype=torch.float32, device=e.device), e)


def _ticks(tstep, device):
    """fticks = tstep / 0.025 (ticks of 1/TICKS_PER_SECOND = 40 s) as a
    float32 tensor."""
    return torch.as_tensor(tstep, dtype=torch.float32, device=device) / \
        torch.tensor(0.025, dtype=torch.float32, device=device)


def step_clouds(p: CloudPool, tstep, wind, water_z, zmax_est) -> CloudPool:
    live = p.status > 0
    dead = (p.pz >= (CLOUD_CEILING + zmax_est)) \
        | (p.radius > MAX_PART_CLOUD_RAD) | (p.pz < water_z)
    status = torch.where(live & dead, 0, p.status)
    vx = 0.5 * wind[0] + p.ivx
    vy = 0.5 * wind[1] + p.ivy
    vz = 0.25 * wind[2] + p.ivz        # z-wind halved then averaged
    ts = _ticks(tstep, p.px.device)
    upd = live & ~dead
    density = torch.where(upd, p.density * _pow(0.97, ts), p.density)
    darkness = torch.where(upd, p.darkness * _pow(0.98, ts), p.darkness)
    density = torch.where(density < 1e-4, 0.0, density)
    darkness = torch.where(darkness < 1e-4, 0.0, darkness)
    return p._replace(
        px=torch.where(upd, p.px + tstep * vx, p.px),
        py=torch.where(upd, p.py + tstep * vy, p.py),
        pz=torch.where(upd, p.pz + tstep * vz, p.pz),
        radius=torch.where(upd, p.radius * _pow(1.03, ts), p.radius),
        density=density, darkness=darkness,
        time=p.time + upd.to(torch.int32), status=status)


class FirePool(NamedTuple):
    px: torch.Tensor
    py: torch.Tensor
    pz: torch.Tensor
    vx: torch.Tensor
    vy: torch.Tensor
    vz: torch.Tensor
    radius: torch.Tensor
    heat: torch.Tensor
    time: torch.Tensor
    status: torch.Tensor   # 0 dead, 1 animated, 2 resting on object


class FireDraws(NamedTuple):
    """One fire tick's draws per slot, in their ranges: `jx`, `jy` in
    [-1.5, 1.5), `jz` in [-0.05, 0.0585) (wind jitter), `rj` in [-0.02,
    0.02) (radius walk), `hr` in [0.25, 1.2) (heat target)."""

    jx: torch.Tensor
    jy: torch.Tensor
    jz: torch.Tensor
    rj: torch.Tensor
    hr: torch.Tensor


FIRE_RANGES = ((-1.5, 1.5), (-1.5, 1.5), (-0.05, 0.0585), (-0.02, 0.02), (0.25, 1.2))


def draw_fires(n: int, generator: torch.Generator,
               device: torch.device | str = "cuda") -> FireDraws:
    """FireDraws for `n` slots from `generator`, moved to `device`."""
    u = torch.rand((5, n), generator=generator, dtype=torch.float32,
                   device=generator.device).to(device)
    return FireDraws(*(lo + (hi - lo) * u[k] for k, (lo, hi) in enumerate(FIRE_RANGES)))


def make_fires(capacity: int, device: torch.device | str = "cuda") -> FirePool:
    return FirePool(*_zeros(capacity, 10, device))


def spawn_fires(p: FirePool, x, y, z, radius) -> FirePool:
    idx, ok = alloc_slots(p.status, x.shape[0])
    put = _putter(idx, ok)
    zs = torch.zeros_like(x)
    return p._replace(
        px=put(p.px, x), py=put(p.py, y), pz=put(p.pz, z),
        vx=put(p.vx, zs), vy=put(p.vy, zs), vz=put(p.vz, zs),
        radius=put(p.radius, radius),
        heat=put(p.heat, torch.full_like(x, 0.5)),
        time=put(p.time, torch.zeros_like(x, dtype=torch.int32)),
        status=put(p.status, ok.to(torch.int32)))


def step_fires(p: FirePool, draws: FireDraws, tstep, wind, water_z,
               surface_damage=None, world=None):
    """One fire tick; returns (pool, surface_damage, smoke_mask).
    smoke_mask marks fires that went out this tick (they emit one smoke
    puff, fire::extinguish)."""
    live = p.status > 0
    moving = p.status == 1
    jx, jy, jz, rj, hr = draws
    ts = _ticks(tstep, p.px.device)
    decay = _pow(0.95, ts)
    vx = torch.where(moving, p.vx * decay + (wind[0] + jx) * 0.005 * tstep, 0.0)
    vy = torch.where(moving, p.vy * decay + (wind[1] + jy) * 0.005 * tstep, 0.0)
    vz = torch.where(moving, p.vz * decay + jz * 0.005 * tstep, 0.0)
    # pos += fticks*velocity (Physics.cpp:1547): the drift per simulated
    # second does not depend on the caller's tstep
    px = p.px + torch.where(moving, vx * ts, 0.0)
    py = p.py + torch.where(moving, vy * ts, 0.0)
    radius = torch.where(live, p.radius + (0.02 + p.radius) * (rj + 250.0 * vz),
                         p.radius)
    heat = torch.where(live, 0.8 * p.heat + 0.2 * hr / (0.9 + 2.0 * radius), p.heat)
    underwater = (p.pz - radius) < water_z
    # the age timeout applies to status 1 and 2 (the reference guards on
    # is_static, a flag this pool does not hold; Physics.cpp:1519)
    timeout = live & (p.time > MAX_FIRE_TIME)
    out = live & (timeout | (radius < FIRE_TOL) | underwater)
    status = torch.where(out, 0, p.status)
    if surface_damage is not None and world is not None:
        gx = torch.clamp((px * world.dx_inv + world.mesh_x // 2).to(torch.int32),
                         0, world.mesh_x - 1)
        gy = torch.clamp((py * world.dy_inv + world.mesh_y // 2).to(torch.int32),
                         0, world.mesh_y - 1)
        dmg = torch.where(live & ~out & moving, 20.0 * radius * heat, 0.0)
        surface_damage = surface_damage.clone()
        surface_damage.index_put_((gy.long(), gx.long()), dmg, accumulate=True)
    return p._replace(px=px, py=py, vx=vx, vy=vy, vz=vz, radius=radius,
                      heat=heat, time=p.time + live.to(torch.int32),
                      status=status), surface_damage, out


class DecalPool(NamedTuple):
    px: torch.Tensor
    py: torch.Tensor
    pz: torch.Tensor
    nx: torch.Tensor       # surface normal
    ny: torch.Tensor
    nz: torch.Tensor
    radius: torch.Tensor
    alpha0: torch.Tensor
    cobj_id: torch.Tensor  # attached cobj (-1 = mesh)
    lifetime: torch.Tensor
    time: torch.Tensor
    status: torch.Tensor


def make_decals(capacity: int, device: torch.device | str = "cuda") -> DecalPool:
    return DecalPool(*_zeros(capacity, 12, device, int_tail=4))


def spawn_decals(p: DecalPool, x, y, z, nx, ny, nz, radius, alpha,
                 cobj_id, lifetime) -> DecalPool:
    idx, ok = alloc_slots(p.status, x.shape[0])
    put = _putter(idx, ok)
    return p._replace(
        px=put(p.px, x), py=put(p.py, y), pz=put(p.pz, z),
        nx=put(p.nx, nx), ny=put(p.ny, ny), nz=put(p.nz, nz),
        radius=put(p.radius, radius), alpha0=put(p.alpha0, alpha),
        cobj_id=put(p.cobj_id, cobj_id), lifetime=put(p.lifetime, lifetime),
        time=put(p.time, torch.zeros_like(x, dtype=torch.int32)),
        status=put(p.status, ok.to(torch.int32)))


def step_decals(p: DecalPool) -> DecalPool:
    live = p.status > 0
    time = p.time + live.to(torch.int32)
    return p._replace(time=time,
                      status=torch.where(live & (time > p.lifetime), 0, p.status))


def decal_alpha(p: DecalPool) -> torch.Tensor:
    """First half full alpha, second half linear fade
    (decal_obj::get_alpha, Physics.cpp:1588-1590)."""
    frac = p.time.to(torch.float32) / torch.clamp(p.lifetime.to(torch.float32), min=1.0)
    return p.alpha0 * torch.clamp(2.0 - 2.0 * frac, 0.0, 1.0) * (p.status > 0)

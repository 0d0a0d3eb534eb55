"""Asteroid fields and procedural asteroid models (port of
`3dworld_tpu/universe/asteroids.py`).

uasteroid_field (asteroid.cpp:940-1140): a spherical field of drifting,
rotating asteroids with asteroid-asteroid elastic collisions resolved
through a uniform grid; models are noise-displaced spheres
(AS_MODEL_HMAP, asteroid.cpp:508 — the heightmap-displaced model is the
field default).

The field is SoA ([N] component tensors); the collision broad phase is the
physics engine's banded pair pass over the Morton-sorted field instead of
the reference's 3-D bucket grid: on the card kernel D
(`ops/cuda/pairs_kernel.banded_pairs`, window 32), on the CPU its plain
version.  Models displace a lat-long sphere mesh with fbm3d sampled at the
vertices (one batched call).

The JAX package draws the field from threefry keys; here the draws are an
input (`AsteroidDraws`, from `draw_asteroid_field` or a test).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops import noise as NZ
from ..ops.cuda import pairs_kernel as PK
from ..physics.step import morton_key
from ..ops.fmath import sqrt32

AST_VEL_SCALE = 0.002
AST_ROT_MAX = 0.02


class AsteroidField(NamedTuple):
    px: torch.Tensor
    py: torch.Tensor
    pz: torch.Tensor
    vx: torch.Tensor
    vy: torch.Tensor
    vz: torch.Tensor
    radius: torch.Tensor
    rot: torch.Tensor       # accumulated rotation angle
    rot_rate: torch.Tensor
    rseed: torch.Tensor     # per-asteroid model seed (int32)


class AsteroidDraws(NamedTuple):
    """The draws of one field of N asteroids, as the JAX function's
    `jax.random` calls return them."""

    u: torch.Tensor         # [N] uniform [0, 1): radius fraction (cubed)
    cth: torch.Tensor       # [N] uniform [-1, 1): cos(theta)
    phi: torch.Tensor       # [N] uniform [0, 2 pi)
    vel: torch.Tensor       # [3, N] standard normal
    size: torch.Tensor      # [N] uniform [-1.2, 0.8): log size
    rot: torch.Tensor       # [N] uniform [-1, 1): spin rate fraction
    rseed: torch.Tensor     # [N] int32 uniform in [0, 2^30)


def draw_asteroid_field(n: int, gen: torch.Generator,
                        device: torch.device | str = "cuda") -> AsteroidDraws:
    """`AsteroidDraws` for `n` asteroids from a CPU generator, on
    `device`."""
    u = lambda lo, hi: lo + (hi - lo) * torch.rand(n, generator=gen)
    d = AsteroidDraws(u=u(0.0, 1.0), cth=u(-1.0, 1.0), phi=u(0.0, 2 * np.pi),
                      vel=torch.randn(3, n, generator=gen), size=u(-1.2, 0.8),
                      rot=u(-1.0, 1.0),
                      rseed=torch.randint(0, 1 << 30, (n,), generator=gen,
                                          dtype=torch.int32))
    return AsteroidDraws(*(t.to(device) for t in d))


def gen_asteroid_field(d: AsteroidDraws, field_radius: float) -> AsteroidField:
    """gen_asteroid_placements: uniform sphere interior, random velocity
    and rotation rates, log-distributed sizes."""
    r = field_radius * torch.pow(d.u, 1.0 / 3.0)      # uniform in the ball
    sth = sqrt32(1.0 - d.cth * d.cth)
    vel = AST_VEL_SCALE * field_radius * d.vel
    return AsteroidField(
        px=r * sth * torch.cos(d.phi), py=r * sth * torch.sin(d.phi), pz=r * d.cth,
        vx=vel[0], vy=vel[1], vz=vel[2],
        radius=field_radius * 0.01 * torch.exp(d.size),
        rot=torch.zeros_like(d.u),
        rot_rate=AST_ROT_MAX * d.rot,
        rseed=d.rseed.to(torch.int32))


def step_asteroid_field(f: AsteroidField, field_radius: float, dt: float,
                        window: int = 32) -> AsteroidField:
    """apply_physics: drift + spin, reflect at the field boundary,
    elastic pair collisions (Morton-banded instead of the 3-D grid; kernel
    D on the card, one launch a step)."""
    px = f.px + dt * f.vx
    py = f.py + dt * f.vy
    pz = f.pz + dt * f.vz
    # boundary: reflect radially (the reference wraps/clamps to field)
    r = sqrt32(px * px + py * py + pz * pz)
    out = r > field_radius
    inv = 1.0 / torch.clamp(r, min=1e-9)
    rd = (f.vx * px + f.vy * py + f.vz * pz) * inv
    vx = torch.where(out, f.vx - 2.0 * rd * px * inv, f.vx)
    vy = torch.where(out, f.vy - 2.0 * rd * py * inv, f.vy)
    vz = torch.where(out, f.vz - 2.0 * rd * pz * inv, f.vz)
    scale = torch.where(out, field_radius * inv, 1.0)
    px, py, pz = px * scale, py * scale, pz * scale

    # Morton co-sort of the whole field (stable: the JAX CPU sort keeps
    # the input order of equal keys), then the banded pair pass.  The
    # model seeds ride through the sort as float32, as in the JAX step,
    # which rounds seeds above 2^24 to float32's spacing
    order = torch.sort(morton_key(px, py, 0.05 * field_radius, 2.0 * field_radius),
                       stable=True).indices
    cols = [px, py, pz, vx, vy, vz, f.radius, f.rot, f.rot_rate,
            f.rseed.to(torch.float32)]
    px, py, pz, vx, vy, vz, rad, rot, rr, rs = (c[order] for c in cols)
    mass = rad ** 3
    act = torch.ones_like(px, dtype=torch.bool)
    dpx, dpy, dpz, dvx, dvy, dvz = PK.banded_pairs(
        px, py, pz, vx, vy, vz, rad, mass, torch.ones_like(px), act, window=window)
    return AsteroidField(
        px=px + dpx, py=py + dpy, pz=pz + dpz,
        vx=vx + dvx, vy=vy + dvy, vz=vz + dvz,
        radius=rad, rot=rot + dt * rr, rot_rate=rr,
        rseed=rs.to(torch.int32))


# ---------------------------------------------------------------------------
# procedural asteroid model (AS_MODEL_HMAP)
# ---------------------------------------------------------------------------

def asteroid_rock_mesh(seed: int, radius: float = 1.0, n_lat: int = 16,
                       n_lon: int = 32, rough: float = 0.35,
                       device: torch.device | str = "cuda"):
    """Noise-displaced sphere (uobj_asteroid_rock3d / hmap model):
    vertices of a lat-long sphere pushed along their normals by fbm3d
    (evaluated on `device`).  Returns host arrays (positions [V, 3],
    faces [F, 3])."""
    th = np.linspace(0.0, np.pi, n_lat)
    ph = np.linspace(0.0, 2 * np.pi, n_lon, endpoint=False)
    T, P = np.meshgrid(th, ph, indexing="ij")
    nx = np.sin(T) * np.cos(P)
    ny = np.sin(T) * np.sin(P)
    nz = np.cos(T)
    off = 13.7 * (seed & 0xFFFF) / 65536.0
    f32 = lambda a: torch.as_tensor((2.5 * a.ravel()).astype(np.float32), device=device)
    disp = NZ.fbm3d(f32(nx), f32(ny), f32(nz), rx=off, ry=0.37 * off + 1.1,
                    octaves=4, seed=seed & 0x7FFFFFFF).cpu().numpy().reshape(n_lat, n_lon)
    rr = radius * (1.0 + rough * disp)
    pos = np.stack([rr * nx, rr * ny, rr * nz], -1).reshape(-1, 3)
    faces = []
    for i in range(n_lat - 1):
        for j in range(n_lon):
            a = i * n_lon + j
            b = i * n_lon + (j + 1) % n_lon
            c = a + n_lon
            d = b + n_lon
            faces.append((a, b, c))
            faces.append((b, d, c))
    return pos.astype(np.float32), np.asarray(faces, np.int32)

"""Static collision objects (cobjs) as padded SoA tensors + the
shape-grouped sphere-vs-scene narrow phase (port of the grouped path of
`3dworld_tpu/physics/cobjs.py`).

The reference's `coll_obj` supports cube / cylinder / sphere / rotated
cylinder / extruded polygon / capsule / torus (collision_detect.h:14,
class at :130) with per-shape sphere push-out in
`vert_coll_detector::check_cobj_intersect` (collision_detect.cpp:1027-1599).

Two narrow phases, as in the JAX package:

- ungrouped: `sphere_cobj_test` evaluates every shape's formula for every
  (object, cobj) pair and selects by shape id, and `deepest_hits` reduces
  to each object's deepest penetrating cobj (first index on ties).  Scenes
  loaded from files and `empty_cobjs` are plain `CobjSet`s.  The JAX
  package evaluates this one with XLA, not with a Pallas kernel, so its
  port is plain PyTorch on every device;
- grouped: `group_cobjs` sorts a scene by shape class on the host and pads
  each group to a multiple of 8; `sphere_cobj_test_grouped` then runs each
  shape's formula only on its own slice, and `deepest_hits_grouped` is the
  plain version of the narrow-phase kernel
  (`ops/cuda/narrow_kernel.deepest_hits`).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

# collision_detect.h:14
COLL_NULL = 0
COLL_CUBE = 1
COLL_CYLINDER = 2       # axis-aligned vertical (p1.xy == p2.xy)
COLL_SPHERE = 3
COLL_CYLINDER_ROT = 4   # arbitrary axis
COLL_POLYGON = 5        # thickness-extruded planar polygon (tri/quad)
COLL_CAPSULE = 6
COLL_TORUS = 7

_EPS = 1e-12


class CobjSet(NamedTuple):
    """Padded SoA cobj scene; dead slots have shape COLL_NULL."""

    shape: torch.Tensor    # [M] int32 shape id (COLL_NULL = dead slot)
    p1: torch.Tensor       # [M,3] cube lo corner / cylinder-capsule end 1 / sphere center / polygon centroid
    p2: torch.Tensor       # [M,3] cube hi corner / cylinder-capsule end 2 / torus axis
    r1: torch.Tensor       # [M] sphere/cylinder/capsule radius 1 / torus ring radius / polygon thickness
    r2: torch.Tensor       # [M] cylinder radius 2 / torus tube radius
    npts: torch.Tensor     # [M] int32 number of polygon points (0 for non-polys)
    pts: torch.Tensor      # [M,4,3]
    pnorm: torch.Tensor    # [M,3] polygon plane normal
    elasticity: torch.Tensor  # [M] cp.elastic
    friction: torch.Tensor    # [M] surface friction factor
    is_movable: torch.Tensor  # [M] bool
    # material / lighting properties (cobj_params: color, specular, shine)
    color_r: torch.Tensor
    color_g: torch.Tensor
    color_b: torch.Tensor
    alpha: torch.Tensor
    specular: torch.Tensor
    shine: torch.Tensor
    # scene-DSL properties (platforms, density/metalness/damage keywords,
    # light_atten/refract_ix, destroyability)
    platform_id: torch.Tensor  # [M] int32, -1 = not on a platform
    density: torch.Tensor
    metalness: torch.Tensor
    damage: torch.Tensor
    light_atten: torch.Tensor
    refract_ix: torch.Tensor
    destroy: torch.Tensor      # [M] int32

    @property
    def size(self) -> int:
        return self.shape.shape[0]


def empty_cobjs(capacity: int, device: torch.device | str = "cuda") -> CobjSet:
    """A CobjSet of `capacity` dead slots (the scene loader's default)."""
    f32 = dict(dtype=torch.float32, device=device)
    i32 = dict(dtype=torch.int32, device=device)
    z3 = torch.zeros((capacity, 3), **f32)
    z = torch.zeros((capacity,), **f32)
    one = torch.ones((capacity,), **f32)
    return CobjSet(
        shape=torch.zeros((capacity,), **i32),
        p1=z3, p2=z3, r1=z, r2=z,
        npts=torch.zeros((capacity,), **i32),
        pts=torch.zeros((capacity, 4, 3), **f32),
        pnorm=z3,
        elasticity=z, friction=z,
        is_movable=torch.zeros((capacity,), dtype=torch.bool, device=device),
        color_r=one, color_g=one, color_b=one, alpha=one,
        specular=z, shine=one,
        platform_id=torch.full((capacity,), -1, **i32),
        density=one, metalness=z, damage=z,
        light_atten=z, refract_ix=one,
        destroy=torch.zeros((capacity,), **i32),
    )


class GroupedCobjs:
    """CobjSet sorted by shape with per-shape extents.

    `bounds` holds the live (start, stop) of each SHAPE_ORDER group in the
    packed order; each group is padded with dead slots to a multiple of 8.
    Grouping changes only the slot order, which can flip exact argmax ties
    between coincident cobjs.
    """

    #      cube, sphere, cyl, capsule, poly, torus, rot-cylinder
    SHAPE_ORDER = (COLL_CUBE, COLL_SPHERE, COLL_CYLINDER, COLL_CAPSULE,
                   COLL_POLYGON, COLL_TORUS, COLL_CYLINDER_ROT)

    def __init__(self, cobjs: CobjSet, bounds: tuple):
        self.cobjs = cobjs
        self.bounds = tuple(tuple(int(v) for v in b) for b in bounds)

    @property
    def size(self) -> int:
        return self.cobjs.size

    @property
    def padded_starts(self) -> tuple:
        """Start of each group's padded slice, plus M: group g covers rows
        [starts[g], starts[g+1]) including its dead padding slots."""
        return tuple(lo for lo, _ in self.bounds) + (self.size,)


def group_cobjs(c: CobjSet, pad_to: int = 8) -> GroupedCobjs:
    """Host-side: sort by shape class, pad each group to `pad_to`."""
    shape = c.shape.cpu().numpy()
    cls_of = {s: k for k, s in enumerate(GroupedCobjs.SHAPE_ORDER)}
    groups = [[] for _ in range(7)]
    for i, s in enumerate(shape):
        if int(s) in cls_of:
            groups[cls_of[int(s)]].append(i)
    # index list with dead padding rows appended per group; bounds track
    # each group's live extent in the packed order
    idx = []
    bounds = []
    for g in groups:
        bounds.append((len(idx), len(idx) + len(g)))
        idx.extend(g)
        npad = (-len(g)) % pad_to if g else 0
        idx.extend([len(shape)] * npad)   # map to an appended dead slot
    if not idx:
        idx = [len(shape)] * pad_to
        bounds = [(0, 0)] * 7
    sel = torch.as_tensor(idx, dtype=torch.long)

    def take(a: torch.Tensor) -> torch.Tensor:
        a = a.cpu()
        dead = torch.zeros((1,) + tuple(a.shape[1:]), dtype=a.dtype)
        return torch.cat([a, dead])[sel].to(c.shape.device)

    # dead pads keep shape COLL_NULL (zeros) -> pen forced to -1
    return GroupedCobjs(CobjSet(*(take(f) for f in c)), tuple(bounds))


def _norm3(ax, ay, az):
    d = torch.sqrt(ax * ax + ay * ay + az * az)
    inv = 1.0 / torch.clamp(d, min=_EPS)
    return d, ax * inv, ay * inv, az * inv


def _sign(v):
    return torch.where(v > 0, 1.0, torch.where(v < 0, -1.0, 0.0))


# ---------------------------------------------------------------------------
# per-shape sphere tests: (X, Y, Z, r) [N, 1] against the rows `s` of `c`,
# each -> (pen, nx, ny, nz) [N, rows]
# ---------------------------------------------------------------------------

def _cube(X, Y, Z, r, c: CobjSet, s: slice):
    """Sphere-cube push-out; inside, through the nearest slab face."""
    p1x, p1y, p1z = (c.p1[s, k] for k in range(3))
    p2x, p2y, p2z = (c.p2[s, k] for k in range(3))
    lox, hix = torch.minimum(p1x, p2x), torch.maximum(p1x, p2x)
    loy, hiy = torch.minimum(p1y, p2y), torch.maximum(p1y, p2y)
    loz, hiz = torch.minimum(p1z, p2z), torch.maximum(p1z, p2z)
    cx = torch.minimum(torch.maximum(X, lox), hix)
    cy = torch.minimum(torch.maximum(Y, loy), hiy)
    cz = torch.minimum(torch.maximum(Z, loz), hiz)
    dist_out, ox, oy, oz = _norm3(X - cx, Y - cy, Z - cz)
    outside = dist_out > 1e-9
    dxl, dxh = X - lox, hix - X
    dyl, dyh = Y - loy, hiy - Y
    dzl, dzh = Z - loz, hiz - Z
    dx_m = torch.minimum(dxl, dxh)
    dy_m = torch.minimum(dyl, dyh)
    dz_m = torch.minimum(dzl, dzh)
    din = torch.minimum(dx_m, torch.minimum(dy_m, dz_m))
    use_x = din == dx_m
    use_y = (din == dy_m) & ~use_x
    use_z = ~use_x & ~use_y
    unit = lambda lo_, hi_: torch.where(lo_ < hi_, -1.0, 1.0)
    return (torch.where(outside, r - dist_out, r + din),
            torch.where(outside, ox, torch.where(use_x, unit(dxl, dxh), 0.0)),
            torch.where(outside, oy, torch.where(use_y, unit(dyl, dyh), 0.0)),
            torch.where(outside, oz, torch.where(use_z, unit(dzl, dzh), 0.0)))


def _sphere(X, Y, Z, r, c: CobjSet, s: slice):
    dist, sx, sy, sz = _norm3(X - c.p1[s, 0], Y - c.p1[s, 1], Z - c.p1[s, 2])
    return (r + c.r1[s]) - dist, sx, sy, sz


def _cylinder(X, Y, Z, r, c: CobjSet, s: slice):
    """Vertical cylinder (p1 bottom, p2 top): side or flat cap."""
    zlo = torch.minimum(c.p1[s, 2], c.p2[s, 2])
    zhi = torch.maximum(c.p1[s, 2], c.p2[s, 2])
    rxy = torch.maximum(c.r1[s], c.r2[s])
    ddx = X - c.p1[s, 0]
    ddy = Y - c.p1[s, 1]
    dist_xy = torch.sqrt(ddx * ddx + ddy * ddy)
    inv_xy = 1.0 / torch.clamp(dist_xy, min=_EPS)
    in_z = (Z > zlo - r) & (Z < zhi + r)
    pen_side = (r + rxy) - dist_xy
    top_pen = (zhi + r) - Z
    bot_pen = Z - (zlo - r)
    cap_is_top = top_pen < bot_pen
    pen_cap = torch.minimum(top_pen, bot_pen)
    use_cap = (dist_xy < rxy) & (pen_cap < pen_side)
    return (torch.where(in_z & (dist_xy < rxy + r),
                        torch.where(use_cap, pen_cap, pen_side), -1.0),
            torch.where(use_cap, 0.0, ddx * inv_xy),
            torch.where(use_cap, 0.0, ddy * inv_xy),
            torch.where(use_cap, torch.where(cap_is_top, 1.0, -1.0), 0.0))


def _capsule(X, Y, Z, r, c: CobjSet, s: slice):
    """Sphere-vs-segment with the per-t interpolated radius
    (collision_detect.cpp:1384-1388 + Math3d.cpp:736)."""
    p1x_, p1y_, p1z_ = (c.p1[s, k] for k in range(3))
    abx = c.p2[s, 0] - p1x_
    aby = c.p2[s, 1] - p1y_
    abz = c.p2[s, 2] - p1z_
    ab2 = torch.clamp(abx * abx + aby * aby + abz * abz, min=_EPS)
    t = torch.clamp(((X - p1x_) * abx + (Y - p1y_) * aby
                     + (Z - p1z_) * abz) / ab2, 0.0, 1.0)
    dist_seg, sx, sy, sz = _norm3(X - (p1x_ + t * abx),
                                  Y - (p1y_ + t * aby),
                                  Z - (p1z_ + t * abz))
    rad_t = c.r1[s] + t * (c.r2[s] - c.r1[s])
    return (r + rad_t) - dist_seg, sx, sy, sz


def _polygon(X, Y, Z, r, c: CobjSet, s: slice):
    """Thin extruded polygon: plane distance + inside test."""
    pnx, pny, pnz = (c.pnorm[s, k] for k in range(3))
    npts = c.npts[s]
    pts = c.pts[s]
    dp = ((X - pts[:, 0, 0]) * pnx + (Y - pts[:, 0, 1]) * pny
          + (Z - pts[:, 0, 2]) * pnz)
    side = _sign(dp)
    prx = X - dp * pnx
    pry = Y - dp * pny
    prz = Z - dp * pnz
    inside = torch.ones_like(dp, dtype=torch.bool)
    for k in range(4):
        ax_, ay_, az_ = pts[:, k, 0], pts[:, k, 1], pts[:, k, 2]
        kn = (k + 1) % 4
        nxt_ok = kn < npts
        bx_ = torch.where(nxt_ok, pts[:, kn, 0], pts[:, 0, 0])
        by_ = torch.where(nxt_ok, pts[:, kn, 1], pts[:, 0, 1])
        bz_ = torch.where(nxt_ok, pts[:, kn, 2], pts[:, 0, 2])
        ex, ey, ez = bx_ - ax_, by_ - ay_, bz_ - az_
        vx_, vy_, vz_ = prx - ax_, pry - ay_, prz - az_
        crx = ey * vz_ - ez * vy_
        cry = ez * vx_ - ex * vz_
        crz = ex * vy_ - ey * vx_
        ok = (crx * pnx + cry * pny + crz * pnz) >= -1e-7
        inside = inside & torch.where(k < npts, ok, True)
    return (torch.where(inside, (r + 0.5 * c.r1[s]) - torch.abs(dp), -1.0),
            pnx * side, pny * side, pnz * side)


def _torus(X, Y, Z, r, c: CobjSet, s: slice):
    """Ring centre p1, unit axis p2."""
    tx = X - c.p1[s, 0]
    ty = Y - c.p1[s, 1]
    tz = Z - c.p1[s, 2]
    axx, axy, axz = (c.p2[s, k] for k in range(3))
    axial = tx * axx + ty * axy + tz * axz
    rvx = tx - axial * axx
    rvy = ty - axial * axy
    rvz = tz - axial * axz
    radial = torch.sqrt(rvx * rvx + rvy * rvy + rvz * rvz)
    rinv = c.r1[s] / torch.clamp(radial, min=_EPS)
    dist_ring, sx, sy, sz = _norm3(tx - rvx * rinv, ty - rvy * rinv,
                                   tz - rvz * rinv)
    return (r + c.r2[s]) - dist_ring, sx, sy, sz


def _rotated_cylinder(X, Y, Z, r, c: CobjSet, s: slice):
    """Exact taper + flat end caps (sphere_intersect_cylinder_ipt,
    Math3d.cpp:731-830): a side candidate at rad = r1 + t*(r2-r1) + sr
    with a radial normal, an end candidate pushing along the axis, the
    nearer displacement wins."""
    p1x_, p1y_, p1z_ = (c.p1[s, k] for k in range(3))
    abx = c.p2[s, 0] - p1x_
    aby = c.p2[s, 1] - p1y_
    abz = c.p2[s, 2] - p1z_
    ab2 = torch.clamp(abx * abx + aby * aby + abz * abz, min=_EPS)
    leninv = torch.rsqrt(ab2)
    length = ab2 * leninv
    r1_, r2_ = c.r1[s], c.r2[s]
    t_un = ((X - p1x_) * abx + (Y - p1y_) * aby + (Z - p1z_) * abz) / ab2
    t_cl = torch.clamp(t_un, 0.0, 1.0)
    rdist, rnx, rny, rnz = _norm3(X - (p1x_ + t_un * abx),
                                  Y - (p1y_ + t_un * aby),
                                  Z - (p1z_ + t_un * abz))
    rad_tc = r1_ + t_cl * (r2_ - r1_)
    in_t = (t_un >= 0.0) & (t_un <= 1.0)
    pen_s = (rad_tc + r) - rdist
    side_ok = in_t & (pen_s > 0.0)
    d_end = t_un > 0.5
    end_r = torch.where(d_end, r2_, r1_)
    axial_out = torch.clamp(torch.maximum(-t_un, t_un - 1.0), min=0.0) * length
    tv_cl = torch.where(d_end, 1.0 - t_cl, t_cl) * length
    pen_e = r - axial_out
    # cap gate is the reference's exact condition (Math3d.cpp:803)
    end_ok = (end_r > 0.0) & (tv_cl < torch.minimum(r.expand_as(rdist), rdist)) \
        & (rdist <= rad_tc + r) & (pen_e > 0.0)
    sgn = torch.where(d_end, 1.0, -1.0)
    use_end = end_ok & (~side_ok | (pen_e < pen_s))
    return (torch.where(use_end, pen_e, torch.where(side_ok, pen_s, -1.0)),
            torch.where(use_end, sgn * abx * leninv, rnx),
            torch.where(use_end, sgn * aby * leninv, rny),
            torch.where(use_end, sgn * abz * leninv, rnz))


_SHAPE_TESTS = {COLL_CUBE: _cube, COLL_SPHERE: _sphere, COLL_CYLINDER: _cylinder,
                COLL_CAPSULE: _capsule, COLL_POLYGON: _polygon,
                COLL_TORUS: _torus, COLL_CYLINDER_ROT: _rotated_cylinder}


def _spheres(px, py, pz, radius):
    return px[:, None], py[:, None], pz[:, None], radius[:, None]


def _blank(n: int, m: int, device):
    """(pen -1, nx, ny, nz 0), each [n, m]: every slot missed."""
    kw = dict(dtype=torch.float32, device=device)
    return [torch.full((n, m), -1.0, **kw)] + [torch.zeros((n, m), **kw)
                                                for _ in range(3)]


def sphere_cobj_test_grouped(px, py, pz, radius, g: GroupedCobjs):
    """(pen, nx, ny, nz), each [N, M]: signed penetration depth (>0 =
    intersecting) and outward contact normal of every object against
    every slot, each slot by its own shape's formula."""
    c = g.cobjs
    sph = _spheres(px, py, pz, radius)
    out = _blank(px.shape[0], c.size, px.device)
    for shape, (lo, hi) in zip(GroupedCobjs.SHAPE_ORDER, g.bounds):
        if hi > lo:
            for o, v in zip(out, _SHAPE_TESTS[shape](*sph, c, slice(lo, hi))):
                o[:, lo:hi] = v
    live = c.shape[None, :] != COLL_NULL
    return (torch.where(live, out[0], -1.0),) + tuple(out[1:])


def deepest_hits_grouped(px, py, pz, radius, g: GroupedCobjs):
    """(hit, pen, nx, ny, nz, elas, fric), each [N]: every object's deepest
    penetrating cobj (first index on ties, as jnp.argmax and
    torch.argmax)."""
    return _deepest(sphere_cobj_test_grouped(px, py, pz, radius, g), g.cobjs)


def sphere_cobj_test(px, py, pz, radius, c: CobjSet):
    """(pen, nx, ny, nz), each [N, M]: signed penetration depth (>0 =
    intersecting) and outward contact normal of every object against every
    slot of a plain CobjSet.  Branchless, as the JAX package's: every
    shape's formula is evaluated on every slot, then selected by shape
    id (pen -1 and a zero normal on dead slots)."""
    sph = _spheres(px, py, pz, radius)
    out = _blank(px.shape[0], c.size, px.device)
    for shape, test in _SHAPE_TESTS.items():
        mask = c.shape == shape
        out = [torch.where(mask, v, o) for o, v in zip(out, test(*sph, c, slice(None)))]
    return tuple(out)


def deepest_hits(px, py, pz, radius, c: CobjSet):
    """(hit, pen, nx, ny, nz, elas, fric), each [N]: every object's deepest
    penetrating slot of a plain CobjSet (first index on ties).  The JAX
    package reads the winner's fields through one-hot sums, which add
    zeros to the one value; the gather here reads the same value."""
    return _deepest(sphere_cobj_test(px, py, pz, radius, c), c)


def _deepest(planes, c: CobjSet):
    """Reduce (pen, nx, ny, nz) [N, M] to each row's deepest slot."""
    pen, nx, ny, nz = planes
    i = torch.argmax(pen, dim=-1, keepdim=True)
    pick = lambda a: torch.gather(a, 1, i)[:, 0]
    best = pick(pen)
    return (best > 0.0, best, pick(nx), pick(ny), pick(nz),
            c.elasticity[i[:, 0]], c.friction[i[:, 0]])

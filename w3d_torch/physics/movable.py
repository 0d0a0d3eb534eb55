"""Movable cobjs: quasi-rigid pushing with blocking checks, tipping and
rotate-to-rest (port of `3dworld_tpu/physics/movable.py`).

The reference's movable cobjs support push/pull with stacking support
checks, tipping via convex-hull-over-contacts, and binary-search
penetration resolution (movable_cobj.cpp:25,189,408,599,715).

The batched parts (`push_movable_cobjs`, `settle_movable_cobjs`,
`object_pushes`) are tensor code on the cobjs' device; the bisection the
JAX package runs in a `fori_loop` is a Python loop with the same count
and operation order.  The per-cobj decisions (support regions, hulls,
tipping, rotation, `binary_search_drop`) run on the host in float64
numpy, as in the JAX package, and write the changed slot back.
"""

from __future__ import annotations

import numpy as np
import torch

from .cobjs import CobjSet, COLL_NULL, COLL_CUBE, COLL_POLYGON


def _cube_overlap(lo_a, hi_a, lo_b, hi_b):
    """[M] vs [M] pairwise cube overlap -> [M, M] bool."""
    sep = (hi_a[:, None, 0] <= lo_b[None, :, 0]) | (hi_b[None, :, 0] <= lo_a[:, None, 0]) | \
          (hi_a[:, None, 1] <= lo_b[None, :, 1]) | (hi_b[None, :, 1] <= lo_a[:, None, 1]) | \
          (hi_a[:, None, 2] <= lo_b[None, :, 2]) | (hi_b[None, :, 2] <= lo_a[:, None, 2])
    return ~sep


def _xy_overlap(lo, hi):
    return (hi[:, None, 0] > lo[None, :, 0]) & (lo[:, None, 0] < hi[None, :, 0]) & \
           (hi[:, None, 1] > lo[None, :, 1]) & (lo[:, None, 1] < hi[None, :, 1])


def push_movable_cobjs(cobjs: CobjSet, push_x, push_y,
                       max_step: float = 0.05,
                       bisect_iters: int = 6) -> CobjSet:
    """Apply accumulated per-cobj horizontal pushes (push_cobj).

    push_x/push_y: [M] desired motion.  The largest collision-free
    fraction of each cobj's delta is found by bisection (the reference's
    binary_step_moving_cobj_delta, movable_cobj.cpp:715-737) in lockstep:
    test the full move, then bisect t in [0, 1] against the blocking set.
    Obstacles resting on top of the moving cobj (stacked movables) are
    ignored, as in the reference's flat-top skip; obstacles that move in
    this call are tested as their swept box."""
    lo = torch.minimum(cobjs.p1, cobjs.p2)
    hi = torch.maximum(cobjs.p1, cobjs.p2)
    live = cobjs.shape != COLL_NULL
    mv = cobjs.is_movable & live & (cobjs.shape == COLL_CUBE)
    mvf = mv.to(torch.float32)
    dx = torch.clamp(push_x, -max_step, max_step) * mvf
    dy = torch.clamp(push_y, -max_step, max_step) * mvf
    d = torch.stack([dx, dy, torch.zeros_like(dx)], -1)
    M = cobjs.size
    ii = torch.arange(M, device=lo.device)
    other = (ii[:, None] != ii[None, :]) & live[None, :]
    # stacked-movable skip: the obstacle rests on this cobj (xy overlap and
    # its bottom at/above our top)
    riding = cobjs.is_movable[None, :] & _xy_overlap(lo, hi) \
        & (lo[None, :, 2] >= hi[:, 2][:, None] - 1e-3)
    obst = other & ~riding
    lo_sw = lo + torch.clamp(d, max=0.0)
    hi_sw = hi + torch.clamp(d, min=0.0)

    def free_at(t):
        lo2 = lo + t[:, None] * d
        hi2 = hi + t[:, None] * d
        return ~torch.any(_cube_overlap(lo2, hi2, lo_sw, hi_sw) & obst, dim=1)

    one = torch.ones(M, dtype=torch.float32, device=lo.device)
    full_ok = free_at(one)
    # bisect between t_lo (known free: 0) and t_hi (known blocked: 1)
    t_lo, t_hi = torch.zeros_like(one), one
    for _ in range(bisect_iters):
        tm = 0.5 * (t_lo + t_hi)
        ok = free_at(tm)
        t_lo, t_hi = torch.where(ok, tm, t_lo), torch.where(ok, t_hi, tm)
    t = torch.where(full_ok, 1.0, t_lo)
    delta = d * (t * mvf)[:, None]
    return cobjs._replace(p1=cobjs.p1 + delta, p2=cobjs.p2 + delta)


def settle_movable_cobjs(cobjs: CobjSet, mesh_min_z, fall_step: float = 0.02):
    """Unsupported movable cubes fall (check_cobj_fall): supported if
    another cobj's top touches the bottom, or resting at mesh_min_z.  The
    step is clamped to land exactly on the highest cobj top below."""
    lo = torch.minimum(cobjs.p1, cobjs.p2)
    hi = torch.maximum(cobjs.p1, cobjs.p2)
    live = cobjs.shape != COLL_NULL
    mv = cobjs.is_movable & live & (cobjs.shape == COLL_CUBE)
    xy_ov = _xy_overlap(lo, hi)
    touch = torch.abs(lo[:, None, 2] - hi[None, :, 2]) < 1e-3
    M = cobjs.size
    ii = torch.arange(M, device=lo.device)
    others = ii[:, None] != ii[None, :]
    supported = torch.any(xy_ov & touch & live[None, :] & others, dim=1)
    mesh_min = torch.as_tensor(mesh_min_z, dtype=lo.dtype, device=lo.device)
    on_ground = lo[:, 2] <= mesh_min + 1e-3
    fall = mv & ~supported & ~on_ground
    below_top = torch.where(
        xy_ov & live[None, :] & others & (hi[None, :, 2] <= lo[:, None, 2] + 1e-6),
        hi[None, :, 2], -torch.inf)
    support_z = torch.maximum(torch.max(below_top, dim=1).values, mesh_min)
    dz = -torch.clamp(lo[:, 2] - support_z, max=fall_step) * fall.to(torch.float32)
    delta = torch.stack([torch.zeros_like(dz), torch.zeros_like(dz), dz], -1)
    return cobjs._replace(p1=cobjs.p1 + delta, p2=cobjs.p2 + delta)


def object_pushes(cobjs: CobjSet, px, py, pz, vx, vy, rad, mass,
                  strength: float = 0.02):
    """Per-cobj push accumulated from objects intersecting movable cubes
    (momentum-weighted, horizontal): ([M], [M])."""
    lo = torch.minimum(cobjs.p1, cobjs.p2)
    hi = torch.maximum(cobjs.p1, cobjs.p2)
    X, Y, Z, R = px[:, None], py[:, None], pz[:, None], rad[:, None]
    inside = ((X > lo[None, :, 0] - R) & (X < hi[None, :, 0] + R)
              & (Y > lo[None, :, 1] - R) & (Y < hi[None, :, 1] + R)
              & (Z > lo[None, :, 2]) & (Z < hi[None, :, 2] + R))
    ins = inside.to(torch.float32)
    return (vx * mass) @ ins * strength, (vy * mass) @ ins * strength


# ---------------------------------------------------------------------------
# host-side per-cobj decisions (float64 numpy, as in the JAX package)
# ---------------------------------------------------------------------------

def _bounds(cobjs: CobjSet):
    p1, p2 = cobjs.p1.cpu().numpy(), cobjs.p2.cpu().numpy()
    return np.minimum(p1, p2), np.maximum(p1, p2)


def support_region(cobjs: CobjSet, i: int, mesh_min_z: float):
    """XY extent of what holds cube `i` up: the union bounds of all
    overlapping tops touching its bottom (or its own footprint on the
    ground).  Returns (x1, y1, x2, y2) or None if unsupported."""
    lo, hi = _bounds(cobjs)
    live = cobjs.shape.cpu().numpy() != COLL_NULL
    if lo[i, 2] <= mesh_min_z + 1e-3:
        return (lo[i, 0], lo[i, 1], hi[i, 0], hi[i, 1])
    sup = None
    for j in range(cobjs.size):
        if j == i or not live[j] or abs(lo[i, 2] - hi[j, 2]) > 1e-3:
            continue
        x1 = max(lo[i, 0], lo[j, 0]); x2 = min(hi[i, 0], hi[j, 0])
        y1 = max(lo[i, 1], lo[j, 1]); y2 = min(hi[i, 1], hi[j, 1])
        if x2 <= x1 or y2 <= y1:
            continue
        sup = ((x1, y1, x2, y2) if sup is None else
               (min(sup[0], x1), min(sup[1], y1), max(sup[2], x2), max(sup[3], y2)))
    return sup


def check_unstable(cobjs: CobjSet, i: int, mesh_min_z: float):
    """Center-of-mass-over-support test: the tip direction (+/-1, dim) if
    the COM hangs past a support edge, else None."""
    lo, hi = _bounds(cobjs)
    sup = support_region(cobjs, i, mesh_min_z)
    if sup is None:
        return None  # free fall, not a tip
    cx = 0.5 * (lo[i, 0] + hi[i, 0])
    cy = 0.5 * (lo[i, 1] + hi[i, 1])
    if cx < sup[0]:
        return (-1, 0)
    if cx > sup[2]:
        return (+1, 0)
    if cy < sup[1]:
        return (-1, 1)
    if cy > sup[3]:
        return (+1, 1)
    return None


def _set_polygon(cobjs: CobjSet, i: int, quad, nr, r1, p1=None, p2=None) -> CobjSet:
    """cobj `i` as an extruded COLL_POLYGON (the reference's rotate_about
    converts rotated cubes to polygon cobjs, coll_obj::was_a_cube)."""
    dev = cobjs.pts.device

    def put(a, v):
        a = a.clone()
        a[i] = torch.as_tensor(np.asarray(v), dtype=a.dtype, device=dev)
        return a

    pts = cobjs.pts.clone()
    pts[i, :4] = torch.as_tensor(np.asarray(quad, np.float32), device=dev)
    out = cobjs._replace(shape=put(cobjs.shape, COLL_POLYGON), pts=pts,
                         pnorm=put(cobjs.pnorm, np.asarray(nr, np.float32)),
                         npts=put(cobjs.npts, 4), r1=put(cobjs.r1, np.float32(r1)))
    if p1 is not None:
        out = out._replace(p1=put(out.p1, np.asarray(p1, np.float32)),
                           p2=put(out.p2, np.asarray(p2, np.float32)))
    return out


def tip_cube(cobjs: CobjSet, i: int, direction, mesh_min_z: float = None,
             angle_deg: float = 90.0) -> CobjSet:
    """Tip cube `i` about its bottom support edge: it becomes an extruded
    COLL_POLYGON.  direction: (+/-1, dim) from `check_unstable`;
    angle_deg=90 lands it flat on the adjacent face."""
    sgn, dim = direction
    p1, p2 = cobjs.p1[i].cpu().numpy(), cobjs.p2[i].cpu().numpy()
    lo, hi = np.minimum(p1, p2), np.maximum(p1, p2)
    piv = hi[dim] if sgn > 0 else lo[dim]
    pz = lo[2]
    # tipping toward +dim rotates d' = d cos(th) - z sin(th),
    # z' = d sin(th) + z cos(th) with th = -90 deg, so the point above the
    # pivot lands beyond it
    th = -np.radians(angle_deg) * sgn
    c, s = np.cos(th), np.sin(th)
    odim = 1 - dim

    def rot(p):
        d, z = p[dim] - piv, p[2] - pz
        return np.array([
            piv + (d * c - z * s) if k == dim else
            (pz + (d * s + z * c) if k == 2 else p[k])
            for k in range(3)])

    depth = hi[dim] - lo[dim]
    far = lo[dim] if sgn > 0 else hi[dim]
    quad = []
    for (a, b) in ((lo[odim], lo[2]), (hi[odim], lo[2]),
                   (hi[odim], hi[2]), (lo[odim], hi[2])):
        p = np.zeros(3)
        p[dim], p[odim], p[2] = far, a, b
        quad.append(rot(p))
    quad = np.stack(quad)
    # outward normal of the far face, rotated in the (dim, z) plane
    nr = np.zeros(3)
    nr[dim] = -sgn * c
    nr[2] = -sgn * s
    nr = nr / max(np.linalg.norm(nr), 1e-12)
    # the polygon plane is the slab center: shift half the depth inward
    return _set_polygon(cobjs, i, quad - 0.5 * depth * nr, nr, float(depth))


def apply_tipping(cobjs: CobjSet, mesh_min_z: float) -> CobjSet:
    """Tip every unstable movable cube (one settle pass)."""
    mv = cobjs.is_movable.cpu().numpy() & (cobjs.shape.cpu().numpy() == COLL_CUBE)
    for i in np.where(mv)[0]:
        d = check_unstable(cobjs, int(i), mesh_min_z)
        if d is not None:
            cobjs = tip_cube(cobjs, int(i), d, mesh_min_z)
    return cobjs


def support_points(cobjs: CobjSet, i: int, mesh_min_z: float):
    """Support contact points under cobj i: corners of each
    supporting-top overlap region (and the footprint on the ground), xy."""
    lo, hi = _bounds(cobjs)
    live = cobjs.shape.cpu().numpy() != COLL_NULL
    pts = []
    if lo[i, 2] <= mesh_min_z + 1e-3:       # resting on the ground
        pts += [(lo[i, 0], lo[i, 1]), (hi[i, 0], lo[i, 1]),
                (hi[i, 0], hi[i, 1]), (lo[i, 0], hi[i, 1])]
    for j in range(cobjs.size):
        if j == i or not live[j] or abs(lo[i, 2] - hi[j, 2]) > 1e-3:
            continue
        x1 = max(lo[i, 0], lo[j, 0]); x2 = min(hi[i, 0], hi[j, 0])
        y1 = max(lo[i, 1], lo[j, 1]); y2 = min(hi[i, 1], hi[j, 1])
        if x2 <= x1 or y2 <= y1:
            continue
        pts += [(x1, y1), (x2, y1), (x2, y2), (x1, y2)]
    return np.asarray(pts, np.float64).reshape(-1, 2)


def convex_hull_2d(pts):
    """Monotone-chain hull (convex_hull in the reference), CCW."""
    P = sorted(map(tuple, pts))
    if len(P) <= 2:
        return np.asarray(P, np.float64)

    def half(seq):
        out = []
        for p in seq:
            while len(out) >= 2 and (
                (out[-1][0] - out[-2][0]) * (p[1] - out[-2][1])
                    - (out[-1][1] - out[-2][1]) * (p[0] - out[-2][0])) <= 0:
                out.pop()
            out.append(p)
        return out[:-1]
    return np.asarray(half(P) + half(P[::-1]), np.float64)


def _closest_on_segment(a, b, p):
    ab = b - a
    t = float(np.clip(np.dot(p - a, ab) / max(np.dot(ab, ab), 1e-18), 0, 1))
    return a + t * ab


def get_cobj_rot_axis(cobjs: CobjSet, i: int, mesh_min_z: float):
    """The rotate-to-rest decision (get_cobj_rot_axis,
    movable_cobj.cpp:599): convex hull of the support points; COM inside
    the hull -> stable (None); else (pivot_point_xy, axis_xy), the axis
    horizontal and perpendicular to the lever (gravity x lever)."""
    sp = support_points(cobjs, i, mesh_min_z)
    if len(sp) == 0:
        return None                      # free fall, not a tip
    p1, p2 = cobjs.p1[i].cpu().numpy(), cobjs.p2[i].cpu().numpy()
    lo, hi = np.minimum(p1, p2), np.maximum(p1, p2)
    com = 0.5 * (lo[:2] + hi[:2])
    if len(sp) == 1:
        closest = sp[0]
    elif len(sp) == 2:
        closest = _closest_on_segment(sp[0], sp[1], com)
    else:
        hull = convex_hull_2d(sp)
        if len(hull) >= 3:
            inside = True
            for k in range(len(hull)):
                a = hull[k]
                b = hull[(k + 1) % len(hull)]
                cr = (b[0] - a[0]) * (com[1] - a[1]) - (b[1] - a[1]) * (com[0] - a[0])
                if cr < -1e-12:
                    inside = False
                    break
            if inside:
                return None              # COM over the support hull
            closest = min((_closest_on_segment(hull[k], hull[(k + 1) % len(hull)], com)
                           for k in range(len(hull))),
                          key=lambda q: float(np.hypot(*(com - q))))
        else:
            closest = _closest_on_segment(hull[0], hull[-1], com)
    lever = com - closest
    ll = float(np.hypot(*lever))
    if ll < 1e-9:
        return None                      # perfect balance
    return (closest, np.array([-lever[1], lever[0]]) / ll)


def _rodrigues(pts, pivot, axis, angle):
    """Rotate points about (pivot, axis) by angle (rotate_point,
    movable_cobj.cpp:538-543)."""
    ax = np.asarray(axis, np.float64)
    ax = ax / max(np.linalg.norm(ax), 1e-12)
    p = np.asarray(pts, np.float64) - pivot
    c, s = np.cos(angle), np.sin(angle)
    return (p * c + np.cross(ax, p) * s + ax * (p @ ax)[:, None] * (1 - c)) + pivot


def _cube_corners(lo, hi):
    return np.array([(x, y, z) for z in (lo[2], hi[2])
                     for y in (lo[1], hi[1]) for x in (lo[0], hi[0])])


def _box_to_polygon(cobjs: CobjSet, i: int, corners):
    """cobj i as the extruded polygon of a rotated box: center-plane quad,
    rotated z normal, height thickness, new bounds."""
    bot = corners[:4][[0, 1, 3, 2]]     # cycle order
    top = corners[4:][[0, 1, 3, 2]]
    quad = 0.5 * (bot + top)
    nr = np.cross(quad[1] - quad[0], quad[3] - quad[0])
    nr = nr / max(np.linalg.norm(nr), 1e-12)
    height = float(np.linalg.norm(top[0] - bot[0]))
    return _set_polygon(cobjs, i, quad, nr, height, corners.min(0), corners.max(0))


def _corners_blocked(corners, cobjs: CobjSet, i: int, mesh_min_z: float,
                     tol: float = 1e-4):
    """Any rotated corner below the ground or inside another cube cobj."""
    if (corners[:, 2] < mesh_min_z - tol).any():
        return True
    lo, hi = _bounds(cobjs)
    for j in np.where(cobjs.shape.cpu().numpy() == COLL_CUBE)[0]:
        if j == i:
            continue
        inside = (corners > lo[j] + tol) & (corners < hi[j] - tol)
        if inside.all(axis=1).any():
            return True
    return False


def rotate_cube_to_rest(cobjs: CobjSet, i: int, mesh_min_z: float,
                        bisect_iters: int = 20):
    """Tip an unstable cube about its support-hull pivot until a new
    contact stops it, the contact angle found by binary search
    (movable_cobj.cpp:599-735).  Returns (cobjs', rotated_bool)."""
    rv = get_cobj_rot_axis(cobjs, i, mesh_min_z)
    if rv is None:
        return cobjs, False
    pivot_xy, axis_xy = rv
    p1, p2 = cobjs.p1[i].cpu().numpy(), cobjs.p2[i].cpu().numpy()
    lo, hi = np.minimum(p1, p2), np.maximum(p1, p2)
    pivot = np.array([pivot_xy[0], pivot_xy[1], lo[2]])
    axis = np.array([axis_xy[0], axis_xy[1], 0.0])
    corners = _cube_corners(lo, hi).astype(np.float64)
    com = corners.mean(0)
    # rotation sign: the COM must move down
    if _rodrigues(com[None], pivot, axis, 1e-3)[0, 2] > com[2]:
        axis = -axis
    a_lo, a_hi = 0.0, np.pi / 2
    if not _corners_blocked(_rodrigues(corners, pivot, axis, a_hi), cobjs, i, mesh_min_z):
        a_lo = a_hi                      # quarter-turn lands flat
    else:
        for _ in range(bisect_iters):
            mid = 0.5 * (a_lo + a_hi)
            if _corners_blocked(_rodrigues(corners, pivot, axis, mid), cobjs, i,
                                mesh_min_z):
                a_hi = mid
            else:
                a_lo = mid
    if a_lo < 1e-4:
        return cobjs, False              # already in contact
    return _box_to_polygon(cobjs, i, _rodrigues(corners, pivot, axis, a_lo)), True


def mesh_normal_at(mesh, world, x: float, y: float):
    """Mesh normal from central height differences (get_mesh_normal_at,
    movable_cobj.cpp:484-495)."""
    m = mesh.cpu().numpy() if isinstance(mesh, torch.Tensor) else np.asarray(mesh)
    my, mx = m.shape
    dx = 2.0 * world.x_scene / max(mx - 1, 1)
    dy = 2.0 * world.y_scene / max(my - 1, 1)
    fx = np.clip((x + world.x_scene) / dx, 1, mx - 2)
    fy = np.clip((y + world.y_scene) / dy, 1, my - 2)
    ix, iy = int(fx), int(fy)
    gx = (m[iy, ix + 1] - m[iy, ix - 1]) / (2 * dx)
    gy = (m[iy + 1, ix] - m[iy - 1, ix]) / (2 * dy)
    n = np.array([-gx, -gy, 1.0])
    return n / np.linalg.norm(n)


def rotate_to_align_with_mesh(cobjs: CobjSet, i: int, mesh, world):
    """Rotate a grounded cube about its COM so its resting normal matches
    the local mesh normal (rotate_to_align_with_mesh,
    movable_cobj.cpp:495-509).  Returns (cobjs', rotated_bool)."""
    p1, p2 = cobjs.p1[i].cpu().numpy(), cobjs.p2[i].cpu().numpy()
    lo, hi = np.minimum(p1, p2), np.maximum(p1, p2)
    com = 0.5 * (lo + hi)
    supp = mesh_normal_at(mesh, world, com[0], com[1])
    rest = np.array([0.0, 0.0, 1.0])
    if supp @ rest > 0.999:
        return cobjs, False             # already aligned
    axis = np.cross(supp, rest)
    axis = axis / max(np.linalg.norm(axis), 1e-12)
    angle = float(np.arccos(np.clip(supp @ rest, -1.0, 1.0)))
    corners = _cube_corners(lo, hi).astype(np.float64)
    return _box_to_polygon(cobjs, i, _rodrigues(corners, com, axis, -angle)), True


def binary_search_drop(cobjs: CobjSet, i: int, mesh_min_z: float,
                       max_drop: float, iters: int = 20) -> float:
    """Largest downward translation of cube i that stays penetration-free
    against the ground and other cubes (get_max_cobj_move_delta's binary
    split, movable_cobj.cpp:699-713, along the drop vector)."""
    p1, p2 = cobjs.p1[i].cpu().numpy(), cobjs.p2[i].cpu().numpy()
    corners = _cube_corners(np.minimum(p1, p2), np.maximum(p1, p2)).astype(np.float64)

    def free(t):
        return not _corners_blocked(corners - np.array([0.0, 0.0, t * max_drop]),
                                    cobjs, i, mesh_min_z)

    if free(1.0):
        return max_drop
    t_lo, t_hi = 0.0, 1.0
    for _ in range(iters):
        mid = 0.5 * (t_lo + t_hi)
        if free(mid):
            t_lo = mid
        else:
            t_hi = mid
    return t_lo * max_drop


def check_unstable_hull(cobjs: CobjSet, i: int, mesh_min_z: float):
    """Axis-aligned projection of the hull decision, for tip_cube: the
    dominant (+-1, dim) tip direction of the lever."""
    rv = get_cobj_rot_axis(cobjs, i, mesh_min_z)
    if rv is None:
        return None
    _closest, axis = rv
    lever = np.array([axis[1], -axis[0]])   # inverse of axis = g x lever
    dim = 0 if abs(lever[0]) >= abs(lever[1]) else 1
    return (1 if lever[dim] > 0 else -1, dim)

"""Batched ray-vs-scene intersection (port of `3dworld_tpu/ops/ray.py`).

The reference walks a BVH per ray (`check_coll_line_exact`,
cobj_bsp_tree.cpp) plus a hierarchical mesh intersector
(mesh_intersect.cpp:248).  As in the JAX package, scenes use the dense
formulation: every ray tests every cobj slot ([N, M] planes, branchless
per-shape t, min-reduce), and the heightfield is intersected by
fixed-count stepped sampling (through the mesh sampler, kernel B on the
card) or an exact cell walk.

Shapes follow physics/cobjs.py: cube (slab test), sphere (quadratic),
vertical cylinder (xy-quadratic + caps), polygon (plane + inside test);
capsule / rotated (tapered) cylinder / torus intersect exactly (cone
quadratic + end discs/spheres; torus via Newton refinement of the
quartic from the bounding-sphere entry).

`ray_cobjs_nearest` keeps every shape family unless the caller names the
families present (`present_types`, which reads the shapes on the host:
one sync, so a caller works it out once per scene).  The select over the
families is a `torch.where` chain, and the nearest slot a gather at
`argmin` (first index on ties), where the JAX package sums one-hot rows;
the index replaces the JAX one-hot output.  The JAX scans over ray steps
become a Python loop (the cell walk) or one [N, S] sample (the stepped
intersector); the threefry draws of `cosine_hemisphere_dirs` become
inputs.  Square roots, sines, cosines and divisions by a number round as
`ops/fmath`'s, the same on the card and the CPU, so a ray takes the same
path on both.
"""

from __future__ import annotations

import math

import torch

from .cuda import sample_kernel as SK
from .fmath import cos32, div32, sin32, sqrt32
from ..physics.cobjs import (
    CobjSet, COLL_NULL, COLL_CUBE, COLL_SPHERE, COLL_CYLINDER,
    COLL_CYLINDER_ROT, COLL_POLYGON, COLL_CAPSULE, COLL_TORUS,
)
from ..utils.constants import WorldConst

_EPS = 1e-9
_BIG = 1e30
ALL_TYPES = (COLL_CUBE, COLL_SPHERE, COLL_CYLINDER, COLL_CYLINDER_ROT,
             COLL_POLYGON, COLL_CAPSULE, COLL_TORUS)


def _where_big(ok, t):
    return torch.where(ok, t, _BIG)


def _isect_cube(c, OX, OY, OZ, DX, DY, DZ, ix, iy, iz):
    """Slab test.  Returns (t, (nx, ny, nz), t_exit)."""
    lo = torch.minimum(c.p1, c.p2)
    hi = torch.maximum(c.p1, c.p2)
    t1x = (lo[:, 0] - OX) * ix
    t2x = (hi[:, 0] - OX) * ix
    t1y = (lo[:, 1] - OY) * iy
    t2y = (hi[:, 1] - OY) * iy
    t1z = (lo[:, 2] - OZ) * iz
    t2z = (hi[:, 2] - OZ) * iz
    tnx = torch.minimum(t1x, t2x)
    tfx = torch.maximum(t1x, t2x)
    tny = torch.minimum(t1y, t2y)
    tfy = torch.maximum(t1y, t2y)
    tnz = torch.minimum(t1z, t2z)
    tfz = torch.maximum(t1z, t2z)
    tn = torch.maximum(torch.maximum(tnx, tny), tnz)
    tf = torch.minimum(torch.minimum(tfx, tfy), tfz)
    cube_hit = (tn <= tf) & (tf > _EPS) & (tn > _EPS)
    t_cube = _where_big(cube_hit, tn)
    # entry face normal: the axis achieving tn, sign opposite ray dir
    use_x = tn == tnx
    use_y = (tn == tny) & ~use_x
    use_z = ~use_x & ~use_y
    ncx = torch.where(use_x, -torch.sign(DX), 0.0)
    ncy = torch.where(use_y, -torch.sign(DY), 0.0)
    ncz = torch.where(use_z, -torch.sign(DZ), 0.0)
    tx_cube = torch.where(cube_hit, tf, t_cube)
    return t_cube, (ncx, ncy, ncz), tx_cube


def _isect_sphere(c, OX, OY, OZ, DX, DY, DZ, a):
    """True spheres: center p1, radius r1."""
    LX = OX - c.p1[:, 0]
    LY = OY - c.p1[:, 1]
    LZ = OZ - c.p1[:, 2]
    b = 2.0 * (LX * DX + LY * DY + LZ * DZ)
    cc = LX * LX + LY * LY + LZ * LZ - c.r1 * c.r1
    disc = b * b - 4.0 * a * cc
    sq = sqrt32(torch.clamp(disc, min=0.0))
    t_s = (-b - sq) / (2.0 * a)
    t_sph = _where_big((disc > 0.0) & (t_s > _EPS), t_s)
    hx = OX + t_s * DX - c.p1[:, 0]
    hy = OY + t_s * DY - c.p1[:, 1]
    hz = OZ + t_s * DZ - c.p1[:, 2]
    hl = torch.clamp(sqrt32(hx * hx + hy * hy + hz * hz), min=_EPS)
    # exit: the far root whenever it lies ahead (an origin inside the
    # sphere still needs an exit for transmission)
    t_s2 = (-b + sq) / (2.0 * a)
    tx_sph = torch.where((disc > 0.0) & (t_s2 > _EPS), t_s2, t_sph)
    return t_sph, (hx / hl, hy / hl, hz / hl), tx_sph


def _isect_tapered(c, OX, OY, OZ, DX, DY, DZ, a, want_caps, want_rcyl):
    """Capsule / rotated (tapered) cylinder: exact cone quadratic.

    Axis A=p1, B=p2, unit u, length L; radius r(s) = r1 + (s/L)(r2-r1).
    Side surface: |P-A|^2 - s^2 = r(s)^2 with s = (P-A).u, a quadratic in
    ray t (line_intersect_cylinder, Math3d.cpp).  Rot-cylinders add flat
    end discs; capsules add end spheres of radius r1/r2.  Returns a dict
    of the requested families' (t, normals, exits) keyed 'caps', 'rcyl'.
    """
    ux_ = c.p2[:, 0] - c.p1[:, 0]
    uy_ = c.p2[:, 1] - c.p1[:, 1]
    uz_ = c.p2[:, 2] - c.p1[:, 2]
    Lax = sqrt32(torch.clamp(ux_ * ux_ + uy_ * uy_ + uz_ * uz_, min=_EPS))
    ux_, uy_, uz_ = ux_ / Lax, uy_ / Lax, uz_ / Lax
    kslope = (c.r2 - c.r1) / Lax
    wx_ = OX - c.p1[:, 0]
    wy_ = OY - c.p1[:, 1]
    wz_ = OZ - c.p1[:, 2]
    s_w = wx_ * ux_ + wy_ * uy_ + wz_ * uz_
    s_d = DX * ux_ + DY * uy_ + DZ * uz_
    one_k2 = 1.0 + kslope * kslope
    Ac = a - s_d * s_d * one_k2
    Bc = 2.0 * ((wx_ * DX + wy_ * DY + wz_ * DZ)
                - s_w * s_d * one_k2 - c.r1 * kslope * s_d)
    Cc = (wx_ * wx_ + wy_ * wy_ + wz_ * wz_) - s_w * s_w * one_k2 \
        - 2.0 * c.r1 * kslope * s_w - c.r1 * c.r1
    discc = Bc * Bc - 4.0 * Ac * Cc
    sqc = sqrt32(torch.clamp(discc, min=0.0))
    Ac_s = torch.where(torch.abs(Ac) < _EPS, _EPS, Ac)
    tc1 = (-Bc - sqc) / (2.0 * Ac_s)
    tc2 = (-Bc + sqc) / (2.0 * Ac_s)

    def side_t(tcand):
        s_at = s_w + tcand * s_d
        ok = (discc > 0.0) & (tcand > _EPS) & (s_at >= 0.0) & (s_at <= Lax)
        return _where_big(ok, tcand)

    t_side_rc = torch.minimum(side_t(torch.minimum(tc1, tc2)),
                              side_t(torch.maximum(tc1, tc2)))
    t_side_far = side_t(torch.maximum(tc1, tc2))
    s_d_s = torch.where(torch.abs(s_d) < _EPS, _EPS, s_d)

    def cone_normal(tbest):
        px_ = wx_ + tbest * DX
        py_ = wy_ + tbest * DY
        pz_ = wz_ + tbest * DZ
        s_at = px_ * ux_ + py_ * uy_ + pz_ * uz_
        rad_at = c.r1 + kslope * s_at
        coef = s_at + kslope * rad_at     # grad of the cone implicit
        gx = px_ - coef * ux_
        gy = py_ - coef * uy_
        gz = pz_ - coef * uz_
        gl = torch.clamp(sqrt32(gx * gx + gy * gy + gz * gz), min=_EPS)
        return gx / gl, gy / gl, gz / gl

    out = {}
    if want_rcyl:
        # flat end discs (rot-cylinder check_ends)
        t_d0 = -s_w / s_d_s
        t_dL = (Lax - s_w) / s_d_s

        def disc_t(tcand, rad_end):
            px_ = wx_ + tcand * DX
            py_ = wy_ + tcand * DY
            pz_ = wz_ + tcand * DZ
            s_at = px_ * ux_ + py_ * uy_ + pz_ * uz_
            r2d = px_ * px_ + py_ * py_ + pz_ * pz_ - s_at * s_at
            return _where_big((tcand > _EPS) & (r2d <= rad_end * rad_end), tcand)

        disc0, discL = disc_t(t_d0, c.r1), disc_t(t_dL, c.r2)
        t_rcyl = torch.minimum(t_side_rc, torch.minimum(disc0, discL))

        def rc_normal(tbest):
            # side -> cone gradient; ends -> +-axis
            on_side = torch.abs(tbest - t_side_rc) < 1e-6
            gx, gy, gz = cone_normal(tbest)
            s_at = s_w + tbest * s_d
            sgn = torch.where(s_at > 0.5 * Lax, 1.0, -1.0)
            return (torch.where(on_side, gx, sgn * ux_),
                    torch.where(on_side, gy, sgn * uy_),
                    torch.where(on_side, gz, sgn * uz_))

        tx_rcyl = torch.maximum(
            torch.where(t_side_far < _BIG, t_side_far, -_BIG),
            torch.maximum(torch.where(disc0 < _BIG, t_d0, -_BIG),
                          torch.where(discL < _BIG, t_dL, -_BIG)))
        tx_rcyl = torch.where(tx_rcyl > -_BIG, tx_rcyl, t_rcyl)
        out["rcyl"] = (t_rcyl, rc_normal(t_rcyl), tx_rcyl)

    if want_caps:
        # capsule: side + end spheres (r1 at A, r2 at B)
        def end_sphere(ex0, ey0, ez0, rr, far):
            lx = OX - ex0
            ly = OY - ey0
            lz = OZ - ez0
            bb = 2.0 * (lx * DX + ly * DY + lz * DZ)
            cc2 = lx * lx + ly * ly + lz * lz - rr * rr
            dd = bb * bb - 4.0 * a * cc2
            sq = sqrt32(torch.clamp(dd, min=0.0))
            tt = ((-bb + sq) if far else (-bb - sq)) / (2.0 * a)
            return torch.where((dd > 0.0) & (tt > _EPS), tt, -_BIG if far else _BIG)

        ends = ((c.p1[:, 0], c.p1[:, 1], c.p1[:, 2], c.r1),
                (c.p2[:, 0], c.p2[:, 1], c.p2[:, 2], c.r2))
        t_caps = torch.minimum(t_side_rc, torch.minimum(end_sphere(*ends[0], False),
                                                        end_sphere(*ends[1], False)))

        def caps_normal(tbest):
            on_side = torch.abs(tbest - t_side_rc) < 1e-6
            gx, gy, gz = cone_normal(tbest)
            # end-sphere normal from the nearer end center
            s_at = s_w + tbest * s_d
            near_b = s_at > 0.5 * Lax
            exc = torch.where(near_b, c.p2[:, 0], c.p1[:, 0])
            eyc = torch.where(near_b, c.p2[:, 1], c.p1[:, 1])
            ezc = torch.where(near_b, c.p2[:, 2], c.p1[:, 2])
            sx_ = OX + tbest * DX - exc
            sy_ = OY + tbest * DY - eyc
            sz_ = OZ + tbest * DZ - ezc
            sl_ = torch.clamp(sqrt32(sx_ * sx_ + sy_ * sy_ + sz_ * sz_), min=_EPS)
            return (torch.where(on_side, gx, sx_ / sl_),
                    torch.where(on_side, gy, sy_ / sl_),
                    torch.where(on_side, gz, sz_ / sl_))

        # capsule exit: max over the far cone-side root and the far roots
        # of both end spheres
        tx_caps = torch.maximum(
            torch.where(t_side_far < _BIG, t_side_far, -_BIG),
            torch.maximum(end_sphere(*ends[0], True), end_sphere(*ends[1], True)))
        tx_caps = torch.where(tx_caps > -_BIG, tx_caps, t_caps)
        out["caps"] = (t_caps, caps_normal(t_caps), tx_caps)
    return out


def _isect_torus(c, OX, OY, OZ, DX, DY, DZ, a):
    """Newton refinement of the quartic from the bounding-sphere entry
    (line_torus_intersect, Math3d.cpp:835+); axis = unit c.p2, ring
    center c.p1, ring radius r1, tube radius r2.  Six iterations in the
    JAX package's operation order."""
    rs = c.r1 + c.r2
    LX = OX - c.p1[:, 0]
    LY = OY - c.p1[:, 1]
    LZ = OZ - c.p1[:, 2]
    b = 2.0 * (LX * DX + LY * DY + LZ * DZ)
    cc = LX * LX + LY * LY + LZ * LZ - rs * rs
    disc = b * b - 4.0 * a * cc
    sq = sqrt32(torch.clamp(disc, min=0.0))
    t_s = (-b - sq) / (2.0 * a)
    au, av, aw = c.p2[:, 0], c.p2[:, 1], c.p2[:, 2]

    def torus_F_dF(tt):
        qx_ = OX + tt * DX - c.p1[:, 0]
        qy_ = OY + tt * DY - c.p1[:, 1]
        qz_ = OZ + tt * DZ - c.p1[:, 2]
        q2 = qx_ * qx_ + qy_ * qy_ + qz_ * qz_
        qu = qx_ * au + qy_ * av + qz_ * aw
        qd = qx_ * DX + qy_ * DY + qz_ * DZ
        du = DX * au + DY * av + DZ * aw
        K = q2 + c.r1 * c.r1 - c.r2 * c.r2
        F = K * K - 4.0 * c.r1 * c.r1 * (q2 - qu * qu)
        dF = 4.0 * K * qd - 4.0 * c.r1 * c.r1 * (2.0 * qd - 2.0 * qu * du)
        return F, dF

    t_n = torch.clamp(t_s, min=_EPS)          # seed at bounding-sphere entry
    # gate on the bounding sphere being ahead at all (far root > eps), so
    # a ray starting inside the r1+r2 sphere can still hit
    t_s2 = (-b + sq) / (2.0 * a)
    sph_ahead = (disc > 0.0) & (t_s2 > _EPS)
    for _ in range(6):
        Fv, dFv = torus_F_dF(t_n)
        t_n = t_n - Fv / torch.where(torch.abs(dFv) < _EPS, _EPS, dFv)
    Fv, _ = torus_F_dF(t_n)
    r1s = torch.clamp(c.r1, min=_EPS)
    scale4 = (r1s * r1s) * (r1s * r1s)      # x**4 as XLA lowers it
    tor_ok = sph_ahead & (torch.abs(Fv) < 1e-3 * scale4) & (t_n > _EPS)
    t_torus = _where_big(tor_ok, t_n)

    def torus_normal(tt):
        qx_ = OX + tt * DX - c.p1[:, 0]
        qy_ = OY + tt * DY - c.p1[:, 1]
        qz_ = OZ + tt * DZ - c.p1[:, 2]
        q2 = qx_ * qx_ + qy_ * qy_ + qz_ * qz_
        qu = qx_ * au + qy_ * av + qz_ * aw
        K = q2 + c.r1 * c.r1 - c.r2 * c.r2
        gx = 4.0 * K * qx_ - 8.0 * c.r1 * c.r1 * (qx_ - qu * au)
        gy = 4.0 * K * qy_ - 8.0 * c.r1 * c.r1 * (qy_ - qu * av)
        gz = 4.0 * K * qz_ - 8.0 * c.r1 * c.r1 * (qz_ - qu * aw)
        gl = torch.clamp(sqrt32(gx * gx + gy * gy + gz * gz), min=_EPS)
        return gx / gl, gy / gl, gz / gl

    # torus exit: the bounding-sphere far root as a chord upper bound
    tx_tor = torch.where(sph_ahead, t_s2, t_torus)
    return t_torus, torus_normal(t_torus), tx_tor


def _isect_vcyl(c, OX, OY, OZ, DX, DY, DZ, iz):
    """Vertical cylinder: xy quadratic + z clip + caps."""
    rc = torch.maximum(c.r1, c.r2)
    zlo = torch.minimum(c.p1[:, 2], c.p2[:, 2])
    zhi = torch.maximum(c.p1[:, 2], c.p2[:, 2])
    LXc = OX - c.p1[:, 0]
    LYc = OY - c.p1[:, 1]
    a2 = DX * DX + DY * DY
    b2 = 2.0 * (LXc * DX + LYc * DY)
    c2 = LXc * LXc + LYc * LYc - rc * rc
    disc2 = b2 * b2 - 4.0 * a2 * c2
    sq2 = sqrt32(torch.clamp(disc2, min=0.0))
    den = torch.clamp(2.0 * a2, min=_EPS)
    t_side = (-b2 - sq2) / den
    z_at = OZ + t_side * DZ
    side_ok = (disc2 > 0.0) & (t_side > _EPS) & (z_at >= zlo) & (z_at <= zhi)
    t_top = (zhi - OZ) * iz
    t_bot = (zlo - OZ) * iz

    def cap_ok(t_c):
        xx = OX + t_c * DX - c.p1[:, 0]
        yy = OY + t_c * DY - c.p1[:, 1]
        return (t_c > _EPS) & (xx * xx + yy * yy <= rc * rc)

    top_ok = cap_ok(t_top)
    bot_ok = cap_ok(t_bot)
    side_t = _where_big(side_ok, t_side)
    t_cyl = torch.minimum(side_t, _where_big(top_ok, t_top))
    t_cyl = torch.minimum(t_cyl, _where_big(bot_ok, t_bot))
    cyl_hit = t_cyl < _BIG
    from_side = cyl_hit & (t_cyl == side_t)
    hxc = OX + t_cyl * DX - c.p1[:, 0]
    hyc = OY + t_cyl * DY - c.p1[:, 1]
    hlc = torch.clamp(sqrt32(hxc * hxc + hyc * hyc), min=_EPS)
    ncyx = torch.where(from_side, hxc / hlc, 0.0)
    ncyy = torch.where(from_side, hyc / hlc, 0.0)
    ncyz = torch.where(from_side, 0.0, -torch.sign(DZ))
    # exit: max valid side/cap t
    t_side2 = (-b2 + sq2) / den
    z_at2 = OZ + t_side2 * DZ
    side2_ok = (disc2 > 0.0) & (t_side2 > _EPS) & (z_at2 >= zlo) & (z_at2 <= zhi)
    tx_cyl = torch.maximum(torch.where(side2_ok, t_side2, -_BIG),
                           torch.maximum(torch.where(top_ok, t_top, -_BIG),
                                         torch.where(bot_ok, t_bot, -_BIG)))
    tx_cyl = torch.where(cyl_hit & (tx_cyl > -_BIG), tx_cyl, t_cyl)
    return t_cyl, (ncyx, ncyy, ncyz), tx_cyl


def _isect_polygon(c, OX, OY, OZ, DX, DY, DZ):
    """Plane + inside test; thickness r1 feeds the exit chord."""
    pnx, pny, pnz = c.pnorm[:, 0], c.pnorm[:, 1], c.pnorm[:, 2]
    denom = DX * pnx + DY * pny + DZ * pnz
    t_pl = (((c.pts[:, 0, 0] - OX) * pnx + (c.pts[:, 0, 1] - OY) * pny
             + (c.pts[:, 0, 2] - OZ) * pnz)
            / torch.where(torch.abs(denom) < _EPS, _EPS, denom))
    qx = OX + t_pl * DX
    qy = OY + t_pl * DY
    qz = OZ + t_pl * DZ
    inside = torch.ones_like(t_pl, dtype=torch.bool)
    for k in range(4):
        ax_, ay_, az_ = c.pts[:, k, 0], c.pts[:, k, 1], c.pts[:, k, 2]
        nk = (k + 1) % 4
        ok_next = nk < c.npts
        bx_ = torch.where(ok_next, c.pts[:, nk, 0], c.pts[:, 0, 0])
        by_ = torch.where(ok_next, c.pts[:, nk, 1], c.pts[:, 0, 1])
        bz_ = torch.where(ok_next, c.pts[:, nk, 2], c.pts[:, 0, 2])
        ex, ey, ez = bx_ - ax_, by_ - ay_, bz_ - az_
        vx_, vy_, vz_ = qx - ax_, qy - ay_, qz - az_
        crx = ey * vz_ - ez * vy_
        cry = ez * vx_ - ex * vz_
        crz = ex * vy_ - ey * vx_
        okk = (crx * pnx + cry * pny + crz * pnz) >= -1e-7
        inside = inside & (okk | ~(k < c.npts))
    t_poly = _where_big(inside & (t_pl > _EPS), t_pl)
    side_sign = -torch.sign(denom)
    tx_poly = t_poly + torch.clamp(c.r1, min=0.0) / torch.clamp(torch.abs(denom), min=0.1)
    return t_poly, (pnx * side_sign, pny * side_sign, pnz * side_sign), tx_poly


def present_types(c: CobjSet) -> tuple:
    """Host-side: the sorted tuple of shape types present in `c` (reads
    the shapes back: one sync).  Pass it as `ray_cobjs_nearest(...,
    present=...)` so absent families are skipped."""
    sh = c.shape.cpu()
    return tuple(t for t in ALL_TYPES if bool((sh == t).any()))


def ray_cobjs_nearest(ox, oy, oz, dx, dy, dz, tmax, c: CobjSet,
                      with_exit: bool = False, present=None):
    """Nearest intersection of N rays against all cobjs.

    Inputs [N] each (directions need not be normalized: t is in direction
    units).  Returns (hit [N], t [N], nx, ny, nz [N], idx [N] int64: the
    nearest slot, the first on ties and 0 where nothing is hit); with
    `with_exit` a 7th element `t_exit` [N], the far intersection of the
    same cobj (the lighting tracer's transmission chord,
    ray_trace.cpp:418-456).  `present` (from `present_types`) names the
    shape families to test; None tests every family, without a sync.
    """
    n, M = ox.shape[0], c.size
    if present is None:
        present = ALL_TYPES
    if M == 0 or not present:
        big = torch.full((n,), _BIG, dtype=ox.dtype, device=ox.device)
        zero = torch.zeros_like(big)
        out = (torch.zeros(n, dtype=torch.bool, device=ox.device), big, zero,
               zero, zero, torch.zeros(n, dtype=torch.int64, device=ox.device))
        return out + (big,) if with_exit else out
    OX, OY, OZ = ox[:, None], oy[:, None], oz[:, None]       # [N,1]
    DX, DY, DZ = dx[:, None], dy[:, None], dz[:, None]

    def inv(d):
        return 1.0 / torch.where(torch.abs(d) < _EPS,
                                 torch.where(d < 0, -_EPS, _EPS), d)

    a = DX * DX + DY * DY + DZ * DZ
    # (pred [M], t [N,M], (nx, ny, nz), t_exit [N,M]) per present family
    cands = []
    if COLL_CUBE in present or COLL_CYLINDER in present:
        iz = inv(DZ)
    if COLL_CUBE in present:
        t_k, n_k, tx_k = _isect_cube(c, OX, OY, OZ, DX, DY, DZ, inv(DX), inv(DY), iz)
        cands.append((c.shape == COLL_CUBE, t_k, n_k, tx_k))
    if COLL_CYLINDER in present:
        t_k, n_k, tx_k = _isect_vcyl(c, OX, OY, OZ, DX, DY, DZ, iz)
        cands.append((c.shape == COLL_CYLINDER, t_k, n_k, tx_k))
    if COLL_POLYGON in present:
        t_k, n_k, tx_k = _isect_polygon(c, OX, OY, OZ, DX, DY, DZ)
        cands.append((c.shape == COLL_POLYGON, t_k, n_k, tx_k))
    has_caps, has_rcyl = COLL_CAPSULE in present, COLL_CYLINDER_ROT in present
    if has_caps or has_rcyl:
        fam = _isect_tapered(c, OX, OY, OZ, DX, DY, DZ, a,
                             want_caps=has_caps, want_rcyl=has_rcyl)
        if has_caps:
            cands.append((c.shape == COLL_CAPSULE, *fam["caps"]))
        if has_rcyl:
            cands.append((c.shape == COLL_CYLINDER_ROT, *fam["rcyl"]))
    if COLL_TORUS in present:
        t_k, n_k, tx_k = _isect_torus(c, OX, OY, OZ, DX, DY, DZ, a)
        cands.append((c.shape == COLL_TORUS, t_k, n_k, tx_k))
    if COLL_SPHERE in present:
        t_k, n_k, tx_k = _isect_sphere(c, OX, OY, OZ, DX, DY, DZ, a)
        cands.append((c.shape == COLL_SPHERE, t_k, n_k, tx_k))

    def select(vals, default):
        """The family of each slot (the families' masks are disjoint)."""
        out = torch.full((n, M), default, dtype=ox.dtype, device=ox.device)
        for (pred, *_), v in zip(cands, vals):
            out = torch.where(pred, v, out)
        return out

    t_all = select([t for (_, t, _, _) in cands], _BIG)
    t_all = torch.where(c.shape == COLL_NULL, _BIG, t_all)
    t_all = torch.where(t_all <= tmax[:, None], t_all, _BIG)
    i = torch.argmin(t_all, dim=-1)

    def at(v):
        return v.gather(1, i[:, None])[:, 0]

    t_best = at(t_all)
    out = (t_best < _BIG, t_best,
           at(select([nk[0] for (_, _, nk, _) in cands], 0.0)),
           at(select([nk[1] for (_, _, nk, _) in cands], 0.0)),
           at(select([nk[2] for (_, _, nk, _) in cands], 1.0)), i)
    if not with_exit:
        return out
    tx_all = select([tx for (_, _, _, tx) in cands], _BIG)
    return out + (at(torch.maximum(tx_all, t_all)),)


def ray_heightfield(ox, oy, oz, dx, dy, dz, tmax, mesh, world: WorldConst,
                    num_steps: int = 64):
    """Stepped ray-vs-heightfield intersection (line_intersect_mesh,
    mesh_intersect.cpp:248): sample the mesh height at `num_steps` points
    along each ray; the first sample below the surface wins.  Returns
    (hit [N], t [N]).  Samples lie on the part of [0, tmax] over the
    mesh's XY footprint; a ray that never crosses it cannot hit.  All
    [N, S] samples go through the mesh sampler at once (kernel B on the
    card; the JAX package scans the steps)."""
    my, mx = mesh.shape
    hx = 0.5 * mx * world.dx
    hy = 0.5 * my * world.dy

    def axis_range(o, d, lo, hi):
        dsafe = torch.where(torch.abs(d) < 1e-12, 1e-12, d)
        ta = (lo - o) / dsafe
        tb = (hi - o) / dsafe
        return torch.minimum(ta, tb), torch.maximum(ta, tb)

    t0x, t1x = axis_range(ox, dx, -hx, hx)
    t0y, t1y = axis_range(oy, dy, -hy, hy)
    t0m = torch.clamp(torch.maximum(t0x, t0y), min=0.0)
    t1m = torch.minimum(torch.minimum(t1x, t1y), tmax)
    span = torch.clamp(t1m - t0m, min=0.0)
    ts = div32(torch.arange(1, num_steps + 1, dtype=torch.float32, device=ox.device),
               num_steps)
    t_grid = t0m[:, None] + ts[None, :] * span[:, None]                # [N,S]
    z = oz[:, None] + t_grid * dz[:, None]
    h = SK.sample_mesh(mesh, (ox[:, None] + t_grid * dx[:, None]).reshape(-1),
                       (oy[:, None] + t_grid * dy[:, None]).reshape(-1),
                       world)[0].view(t_grid.shape)
    below = z < h
    found = below.any(dim=1)
    first = torch.argmax(below.to(torch.int8), dim=1)
    t_hit = torch.where(found, t_grid.gather(1, first[:, None])[:, 0], _BIG)
    # a ray that never crosses the footprint cannot hit
    crosses = span > 0.0
    return found & crosses, torch.where(crosses, t_hit, _BIG)


def cosine_hemisphere_dirs(u, v, nx, ny, nz):
    """Cosine-weighted scatter directions (normalize(n + random_unit),
    ray_trace.cpp:482).  The random unit vector comes from the
    cylinder-area map of two uniform draws `u`, `v` in [0, 1) (z = 2u-1,
    angle = 2 pi v), which the JAX package draws from a threefry key."""
    z = 2.0 * u - 1.0
    ang = (2.0 * math.pi) * v
    r = sqrt32(torch.clamp(1.0 - z * z, min=0.0))
    vx = nx + r * cos32(ang)
    vy = ny + r * sin32(ang)
    vz = nz + z
    vl = sqrt32(vx * vx + vy * vy + vz * vz) + _EPS
    return vx / vl, vy / vl, vz / vl


def ray_heightfield_dda(ox, oy, oz, dx, dy, dz, tmax, mesh,
                        world: WorldConst, max_cells: int = 64):
    """Exact cell-walking ray-vs-heightfield intersection (the reference's
    `mesh_intersector`, mesh_intersect.cpp:248-256) as a fixed-count walk:
    per step, read the cell's four corners, solve z(t) = h_bilinear(t) on
    [t_entry, t_exit], else advance to the next cell boundary.  Exact for
    rays crossing at most `max_cells` cells.  Returns (hit [N], t [N])."""
    my, mx = mesh.shape
    n = ox.shape[0]
    gx0 = ox * world.dx_inv + mx // 2
    gy0 = oy * world.dy_inv + my // 2
    gdx = dx * world.dx_inv
    gdy = dy * world.dy_inv
    eps = 1e-5

    def safe(d):
        return torch.where(d == 0, 1.0, d)

    t = torch.zeros(n, dtype=torch.float32, device=ox.device)
    found = torch.zeros(n, dtype=torch.bool, device=ox.device)
    t_hit = torch.full((n,), _BIG, dtype=torch.float32, device=ox.device)
    for _ in range(max_cells):
        px = gx0 + t * gdx
        py = gy0 + t * gdy
        cx = torch.floor(px)
        cy = torch.floor(py)
        inside = (cx >= 0) & (cx < mx - 1) & (cy >= 0) & (cy < my - 1)
        cxc = torch.clamp(cx, 0, mx - 2)
        cyc = torch.clamp(cy, 0, my - 2)
        ix, iy = cxc.long(), cyc.long()
        h00, h10 = mesh[iy, ix], mesh[iy, ix + 1]
        h01, h11 = mesh[iy + 1, ix], mesh[iy + 1, ix + 1]
        # exit t: next x / y cell boundary
        tx = torch.where(gdx > eps, (cx + 1 - gx0) / safe(gdx),
                         torch.where(gdx < -eps, (cx - gx0) / safe(gdx), math.inf))
        ty = torch.where(gdy > eps, (cy + 1 - gy0) / safe(gdy),
                         torch.where(gdy < -eps, (cy - gy0) / safe(gdy), math.inf))
        t_exit = torch.minimum(torch.minimum(tx, ty), tmax)
        # f(s) = z(t+s) - h(u0 + s gdx, v0 + s gdy), quadratic in s
        u0 = px - cxc
        v0 = py - cyc
        a_h = h00 - h10 - h01 + h11
        c0 = (oz + t * dz) - (h00 + (h10 - h00) * u0 + (h01 - h00) * v0
                              + a_h * u0 * v0)
        c1 = dz - ((h10 - h00) * gdx + (h01 - h00) * gdy
                   + a_h * (u0 * gdy + v0 * gdx))
        c2 = -a_h * gdx * gdy
        smax = torch.clamp(t_exit - t, min=0.0)
        disc = c1 * c1 - 4.0 * c2 * c0
        sq = sqrt32(torch.clamp(disc, min=0.0))
        is_quad = torch.abs(c2) > 1e-12
        s_lin = torch.where(torch.abs(c1) > 1e-12, -c0 / safe(c1), math.inf)
        q = -0.5 * (c1 + torch.sign(c1) * sq)
        r1_ = torch.where(is_quad, q / safe(c2), s_lin)
        r2_ = torch.where(is_quad & (torch.abs(q) > 1e-20), c0 / safe(q), math.inf)
        ok1 = (disc >= 0) & (r1_ >= 0) & (r1_ <= smax)
        ok2 = (disc >= 0) & (r2_ >= 0) & (r2_ <= smax)
        s_hit = torch.where(ok1 & ok2, torch.minimum(r1_, r2_),
                            torch.where(ok1, r1_, torch.where(ok2, r2_, math.inf)))
        # an origin already below the surface counts as an immediate hit
        s_hit = torch.where(c0 < 0.0, 0.0, s_hit)
        new_hit = inside & ~found & torch.isfinite(s_hit) & (t + s_hit <= tmax)
        t_hit = torch.where(new_hit, t + s_hit, t_hit)
        found = found | new_hit
        # monotonic advance: a boundary time rounded to just behind t would
        # otherwise hold t in place
        t = torch.where(found, t, torch.maximum(t + eps, t_exit + eps))
    return found, t_hit

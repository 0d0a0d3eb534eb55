"""Plain PyTorch version of the fused physics substep (kernel G).

A straight transcription of the Pallas `_substep_kernel`
(`3dworld_tpu/ops/pallas/physics_kernel.py:84-510`), op for op, on the
same [M, N] narrow-phase planes (cobjs down, objects across).  The CUDA
kernel `csrc/substep.cu` computes the same per object; its wrapper
`ops/cuda/physics_kernel.substep` takes this function for CPU tensors.

One substep per object: integrate (gravity, terminal velocity, wind
drag) -> mesh sample from the [3*my, mx] map stack -> water skip, float
or sink -> all-shape narrow phase over the packed [M, 32] cobj table ->
cobj bounce or stick -> mesh bounce -> on-ground rolling.

Where the fused kernel departs from `step._substep`, this follows the
kernel: there is no Z_STOPPED "unstop" clause and no `vz_old`, no ice
branch, the water branch is the simple skip/float/sink, mesh contact sets
FL_COLLIDED, bounces use the water-adjusted air factor, and penetration
ties across cobjs average their normals, elasticities and frictions
instead of taking the first index.  The mesh sample contracts x first,
then y, as the kernel's `maps @ XW` product does.
"""

from __future__ import annotations

import math

import torch

from . import types as T
from .cobjs import (COLL_NULL, COLL_CUBE, COLL_CYLINDER, COLL_SPHERE,
                    COLL_CYLINDER_ROT, COLL_POLYGON, COLL_CAPSULE, COLL_TORUS)
from .cobj_table import CF_INDEX as _C

_EPS = 1e-12


def _norm3(ax, ay, az):
    d = torch.sqrt(ax * ax + ay * ay + az * az)
    inv = 1.0 / torch.clamp(d, min=_EPS)
    return d, ax * inv, ay * inv, az * inv


def _sample_maps(maps3: torch.Tensor, gx, gy):
    """(height, dz/dx, dz/dy) at grid coordinates (gx, gy) from the
    [3*my, mx] stack: weights clamp to the border, x contracts first."""
    my, mx = maps3.shape[0] // 3, maps3.shape[1]
    x0 = torch.clamp(torch.floor(gx), 0.0, mx - 2.0)
    y0 = torch.clamp(torch.floor(gy), 0.0, my - 2.0)
    fx = torch.clamp(gx - x0, 0.0, 1.0)
    fy = torch.clamp(gy - y0, 0.0, 1.0)
    ix, iy = x0.long(), y0.long()
    wx0, wy0 = 1.0 - fx, 1.0 - fy

    def tap(base):
        a0 = maps3[base + iy, ix] * wx0 + maps3[base + iy, ix + 1] * fx
        a1 = maps3[base + iy + 1, ix] * wx0 + maps3[base + iy + 1, ix + 1] * fx
        return a0 * wy0 + a1 * fy

    return tap(0), tap(my), tap(2 * my)


def _narrow(cf: torch.Tensor, X, Y, Z, r):
    """[M, N] penetration and normal planes of every object against every
    cobj row, each shape's formula selected by the row's shape id."""
    col = lambda name: cf[:, _C[name]:_C[name] + 1]        # [M, 1]
    shape = col("shape")
    p1x, p1y, p1z = col("p1x"), col("p1y"), col("p1z")
    p2x, p2y, p2z = col("p2x"), col("p2y"), col("p2z")
    r1, r2 = col("r1"), col("r2")
    npts = col("npts")
    pnx, pny, pnz = col("pnx"), col("pny"), col("pnz")
    where = torch.where

    # cube
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
    sxi = where(dxl < dxh, -1.0, 1.0)
    syi = where(dyl < dyh, -1.0, 1.0)
    szi = where(dzl < dzh, -1.0, 1.0)
    use_x = din == dx_m
    use_y = (din == dy_m) & ~use_x
    use_z = ~use_x & ~use_y
    pen_cube = where(outside, r - dist_out, r + din)
    nx_cube = where(outside, ox, where(use_x, sxi, 0.0))
    ny_cube = where(outside, oy, where(use_y, syi, 0.0))
    nz_cube = where(outside, oz, where(use_z, szi, 0.0))

    # sphere
    dist, nx_sph, ny_sph, nz_sph = _norm3(X - p1x, Y - p1y, Z - p1z)
    pen_sph = (r + r1) - dist

    # vertical cylinder
    zlo = torch.minimum(p1z, p2z)
    zhi = torch.maximum(p1z, p2z)
    rxy = torch.maximum(r1, r2)
    ddx, ddy = X - p1x, Y - p1y
    dist_xy = torch.sqrt(ddx * ddx + ddy * ddy)
    inv_xy = 1.0 / torch.clamp(dist_xy, min=_EPS)
    in_z = (Z > zlo - r) & (Z < zhi + r)
    pen_side = (r + rxy) - dist_xy
    top_pen = (zhi + r) - Z
    bot_pen = Z - (zlo - r)
    cap_is_top = top_pen < bot_pen
    pen_cap = torch.minimum(top_pen, bot_pen)
    use_cap = (dist_xy < rxy) & (pen_cap < pen_side)
    pen_cyl = where(in_z & (dist_xy < rxy + r), where(use_cap, pen_cap, pen_side), -1.0)
    nx_cyl = where(use_cap, 0.0, ddx * inv_xy)
    ny_cyl = where(use_cap, 0.0, ddy * inv_xy)
    nz_cyl = where(use_cap, where(cap_is_top, 1.0, -1.0), 0.0)

    # capsule: per-t interpolated radius
    abx, aby, abz = p2x - p1x, p2y - p1y, p2z - p1z
    ab2 = torch.clamp(abx * abx + aby * aby + abz * abz, min=_EPS)
    t = torch.clamp(((X - p1x) * abx + (Y - p1y) * aby + (Z - p1z) * abz) / ab2,
                    0.0, 1.0)
    dist_seg, nx_cap, ny_cap, nz_cap = _norm3(
        X - (p1x + t * abx), Y - (p1y + t * aby), Z - (p1z + t * abz))
    pen_caps = (r + (r1 + t * (r2 - r1))) - dist_seg

    # rotated cylinder: exact taper + flat end caps (Math3d.cpp:731-830)
    leninv = 1.0 / torch.sqrt(ab2)
    length = ab2 * leninv
    t_un = ((X - p1x) * abx + (Y - p1y) * aby + (Z - p1z) * abz) / ab2
    t_cl = torch.clamp(t_un, 0.0, 1.0)
    rdist, rnx, rny, rnz = _norm3(X - (p1x + t_un * abx), Y - (p1y + t_un * aby),
                                  Z - (p1z + t_un * abz))
    rad_tc = r1 + t_cl * (r2 - r1)
    in_t = (t_un >= 0.0) & (t_un <= 1.0)
    pen_s = (rad_tc + r) - rdist
    side_ok = in_t & (pen_s > 0.0)
    d_end = t_un > 0.5
    end_r = where(d_end, r2, r1)
    axial_out = torch.clamp(torch.maximum(-t_un, t_un - 1.0), min=0.0) * length
    tv_cl = where(d_end, 1.0 - t_cl, t_cl) * length
    pen_e = r - axial_out
    end_ok = (end_r > 0.0) & (tv_cl < torch.minimum(r, rdist)) \
        & (rdist <= rad_tc + r) & (pen_e > 0.0)
    sgn = where(d_end, 1.0, -1.0)
    use_end = end_ok & (~side_ok | (pen_e < pen_s))
    pen_rcyl = where(use_end, pen_e, where(side_ok, pen_s, -1.0))
    nx_rcyl = where(use_end, sgn * abx * leninv, rnx)
    ny_rcyl = where(use_end, sgn * aby * leninv, rny)
    nz_rcyl = where(use_end, sgn * abz * leninv, rnz)

    # polygon
    ptx = [col(f"pt{k}x") for k in range(4)]
    pty = [col(f"pt{k}y") for k in range(4)]
    ptz = [col(f"pt{k}z") for k in range(4)]
    dp = (X - ptx[0]) * pnx + (Y - pty[0]) * pny + (Z - ptz[0]) * pnz
    side = torch.sign(dp)
    prx = X - dp * pnx
    pry = Y - dp * pny
    prz = Z - dp * pnz
    inside = torch.ones_like(dp, dtype=torch.bool)
    for k in range(4):
        nxt_ok = (k + 1) % 4 < npts
        bx = where(nxt_ok, ptx[(k + 1) % 4], ptx[0])
        by = where(nxt_ok, pty[(k + 1) % 4], pty[0])
        bz = where(nxt_ok, ptz[(k + 1) % 4], ptz[0])
        ex, ey, ez = bx - ptx[k], by - pty[k], bz - ptz[k]
        wvx, wvy, wvz = prx - ptx[k], pry - pty[k], prz - ptz[k]
        crx = ey * wvz - ez * wvy
        cry = ez * wvx - ex * wvz
        crz = ex * wvy - ey * wvx
        ok = (crx * pnx + cry * pny + crz * pnz) >= -1e-7
        inside = inside & (ok | ~(k < npts))
    pen_poly = where(inside, (r + 0.5 * r1) - torch.abs(dp), -1.0)
    nx_pol, ny_pol, nz_pol = pnx * side, pny * side, pnz * side

    # torus
    tx, ty, tz = X - p1x, Y - p1y, Z - p1z
    axial = tx * p2x + ty * p2y + tz * p2z
    rvx = tx - axial * p2x
    rvy = ty - axial * p2y
    rvz = tz - axial * p2z
    radial = torch.sqrt(rvx * rvx + rvy * rvy + rvz * rvz)
    rinv = r1 / torch.clamp(radial, min=_EPS)
    dist_ring, nx_tor, ny_tor, nz_tor = _norm3(tx - rvx * rinv, ty - rvy * rinv,
                                               tz - rvz * rinv)
    pen_torus = (r + r2) - dist_ring

    masks = [shape == s for s in (COLL_CUBE, COLL_SPHERE, COLL_CYLINDER,
                                  COLL_CAPSULE, COLL_CYLINDER_ROT,
                                  COLL_POLYGON, COLL_TORUS)]
    full = torch.broadcast_shapes(shape.shape, X.shape)

    def sel(vals, default):
        out = torch.full(full, default, dtype=X.dtype, device=X.device)
        for m, v in zip(masks, vals):
            out = where(m, v, out)
        return out

    pen = sel([pen_cube, pen_sph, pen_cyl, pen_caps, pen_rcyl, pen_poly,
               pen_torus], -1.0)
    pen = where(shape != COLL_NULL, pen, -1.0)
    cnx = sel([nx_cube, nx_sph, nx_cyl, nx_cap, nx_rcyl, nx_pol, nx_tor], 0.0)
    cny = sel([ny_cube, ny_sph, ny_cyl, ny_cap, ny_rcyl, ny_pol, ny_tor], 0.0)
    cnz = sel([nz_cube, nz_sph, nz_cyl, nz_cap, nz_rcyl, nz_pol, nz_tor], 0.0)
    return pen, cnx, cny, cnz


def substep_plain(px, py, pz, vx, vy, vz, status, flags,
                  rad, air, fric, grav, elas, dens, tv,
                  maps3: torch.Tensor, cf: torch.Tensor, env: torch.Tensor):
    """One fused substep over the whole population.

    State and per-object params are [N] (status and flags int32); `maps3`
    is the [3*my, mx] stack of `ops/cuda/physics_kernel.mesh_maps`; `cf`
    the [M, 32] table of `ops/cuda/narrow_kernel.pack_cobj_fields`; `env`
    12 floats: (tstep, base_gravity, wind xyz, water_plane_z, dx_inv,
    dy_inv, x_scene, dx, dy, unused).  Returns the new
    (px, py, pz, vx, vy, vz, status, flags)."""
    where = torch.where
    (tstep, base_gravity, wx, wy, wz, water_plane_z, dx_inv, dy_inv, x_scene,
     dx_val, dy_val) = env[:11]
    my, mx = maps3.shape[0] // 3, maps3.shape[1]

    alive = status > 0
    # capture + clear last-substep collision (Physics.cpp:720-721)
    coll_last = (flags & T.FL_COLLIDED) != 0
    flags = flags & ~T.FL_COLLIDED
    floating = (flags & T.FL_FLOATING) != 0
    z_stop = (flags & T.FL_Z_STOPPED) != 0
    xy_stop = (flags & T.FL_XY_STOPPED) != 0
    underwater = (flags & T.FL_UNDERWATER) != 0
    in_water = (flags & T.FL_IN_WATER) != 0
    moving = alive & (status == 1)
    grounded = alive & ((status == 2) | (status == 3))

    # ---- integrate (Physics.cpp:760-833) ----
    air_eff = where(underwater, 0.0,
                    where(floating, (1.0 - T.WATER_SURF_FRICTION) * air, air))
    gscale = where(in_water & (dens > T.WATER_DENSITY),
                   (dens - T.WATER_DENSITY) / dens, 1.0)
    can_fall = moving & ~z_stop
    vz_new = where(-vz < tv,
                   torch.maximum(vz - base_gravity * gscale * T.GRAVITY
                                 * tstep * grav, -tv),
                   vz)
    vz = where(can_fall, vz_new, where(z_stop & moving, 0.0, vz))
    vz = where(can_fall & ((torch.abs(air_eff * wz) > torch.abs(vz))
                           | ((wz < 0) != (vz < 0))),
               vz + air_eff * wz, vz)
    move_xy = moving & ~xy_stop
    collided = coll_last | (torch.abs(vz) < 1.0e-6)

    def drag(v, w):
        vtot = v + where(collided, 0.0, w)
        c = (torch.abs(air_eff * vtot) > torch.abs(v)) | ((vtot < 0) != (v < 0))
        return where(c & move_xy, (1.0 - air_eff) * v + air_eff * vtot, v)

    vx = drag(vx, wx)
    vy = drag(vy, wy)
    px = px + where(move_xy, tstep * vx, 0.0)
    py = py + where(move_xy, tstep * vy, 0.0)
    pz = pz + where(moving, tstep * vz, 0.0)

    # ---- mesh sample ----
    gx = px * dx_inv + float(mx // 2)
    gy = py * dy_inv + float(my // 2)
    mh, sx, sy = _sample_maps(maps3, gx, gy)
    ninv = 1.0 / torch.sqrt(sx * sx + sy * sy + 1.0)
    mnx, mny, mnz = -sx * ninv, -sy * ninv, ninv
    off_mesh = (gx < 0) | (gx >= float(mx)) | (gy < 0) | (gy >= float(my))
    on_mesh = ~off_mesh & ((pz - rad) <= mh)

    # ---- water (Physics.cpp:1082-1180) ----
    wpz = water_plane_z
    over_water = ~off_mesh & (wpz > mh)
    touches_water = over_water & ((pz - rad) < wpz) & alive
    v_sq = vx * vx + vy * vy + vz * vz
    fast = v_sq >= T.BOUNCE_CUTOFF
    den_ratio = T.WATER_DENSITY / (dens + T.WATER_DENSITY)
    damp = 1.0 - T.WATER_DAMPING * den_ratio
    floats = dens < T.WATER_DENSITY
    w_fast = touches_water & fast
    w_slow = touches_water & ~fast
    # surface skip (Physics.cpp:1154-1163), compared in the cos domain:
    # arccos(x) >= thresh  <=>  x <= cos(thresh) for thresh in [0, pi]
    v_mag = torch.sqrt(torch.clamp(v_sq, min=1e-12))
    cos_v = torch.clamp(-vz / v_mag, -1.0, 1.0)
    zpos_w = torch.maximum(wpz + rad * (1.0 - 2.0 * dens), mh + rad)
    surf_coll = (pz > wpz - rad - T.MAX_SPLASH_DEPTH) & ~underwater & ~z_stop
    e_w = T.WATER_ELASTIC   # in [0, 1], so the kernel's clip keeps it
    exy_w = e_w * (1.0 - air_eff)
    sbx = vx * exy_w
    sby = vy * exy_w
    sbz = -vz * e_w
    s_did = (sbx * sbx + sby * sby + sbz * sbz) >= T.BOUNCE_CUTOFF
    thresh = T.CRITICAL_ANGLE / den_ratio
    angle_ok = (thresh <= math.pi) & \
        (cos_v <= torch.cos(torch.clamp(thresh, max=math.pi)))
    skip = (w_fast & surf_coll & angle_ok
            & ((zpos_w - pz) <= 6.0 * rad) & s_did)
    w_fast = w_fast & ~skip
    vx = where(skip, sbx, where(w_fast, vx * damp, where(w_slow, 0.0, vx)))
    vy = where(skip, sby, where(w_fast, vy * damp, where(w_slow, 0.0, vy)))
    vz = where(skip, sbz, where(w_fast, where(floats, 0.0, vz * damp),
                                where(w_slow, 0.0, vz)))
    touches_water = touches_water & ~skip
    ground_z = mh + rad
    slow_pos_z = where(floats,
                       torch.maximum(wpz + rad * (1.0 - 2.0 * dens), ground_z),
                       ground_z)
    pz = where(w_slow, slow_pos_z, pz)
    flags = where(w_fast & ~floats, flags | (T.FL_IN_WATER | T.FL_UNDERWATER), flags)
    flags = where(w_slow & floats, flags | (T.FL_FLOATING | T.FL_IN_WATER), flags)
    status = where(w_slow, where(floats, 1, 3).to(status.dtype), status)
    hit_bottom = touches_water & (pz <= ground_z + 1e-5)
    pz = where(hit_bottom, ground_z, pz)
    vx = where(hit_bottom, 0.0, vx)
    vy = where(hit_bottom, 0.0, vy)
    vz = where(hit_bottom, 0.0, vz)
    status = where(hit_bottom, 3, status)

    # ---- cobj narrow phase: deepest hit, ties averaged ----
    X, Y, Z, r = px[None, :], py[None, :], pz[None, :], rad[None, :]
    pen, cnx, cny, cnz = _narrow(cf, X, Y, Z, r)
    pmax = torch.max(pen, dim=0, keepdim=True).values
    wsel = (pen == pmax).to(pen.dtype)
    wnorm = wsel / torch.clamp(torch.sum(wsel, 0, keepdim=True), min=1.0)
    best = pmax[0]
    bnx = torch.sum(cnx * wnorm, 0)
    bny = torch.sum(cny * wnorm, 0)
    bnz = torch.sum(cnz * wnorm, 0)
    celas = torch.sum(cf[:, _C["elas"], None] * wnorm, 0)
    cfric = torch.sum(cf[:, _C["fric"], None] * wnorm, 0)

    hit = (best > 0.0) & alive & ~touches_water
    px = px + where(hit, best * bnx, 0.0)
    py = py + where(hit, best * bny, 0.0)
    pz = pz + where(hit, best * bnz, 0.0)

    def bounce(nx_, ny_, nz_, e):
        # step.bounce_velocity (Physics.cpp:1349-1409) with the
        # water-adjusted air factor
        e = torch.clamp(e, 0.0, 1.0)
        vdn = vx * nx_ + vy * ny_ + vz * nz_
        bx = vx - 2.0 * vdn * nx_
        by = vy - 2.0 * vdn * ny_
        bz = vz - 2.0 * vdn * nz_
        exy = e * (1.0 - air_eff)
        bx, by, bz = bx * exy, by * exy, bz * e
        did = (bx * bx + by * by + bz * bz) >= T.BOUNCE_CUTOFF
        return where(did, bx, vx), where(did, by, vy), where(did, bz, vz), did

    bx, by, bz, did = bounce(bnx, bny, bnz, elas * celas)
    stop = hit & ~did & ((torch.maximum(fric, cfric) >= T.STICK_THRESHOLD)
                         | (v_sq < T.BOUNCE_CUTOFF))
    hd = hit & did
    vx = where(hd, bx, where(stop, 0.0, vx))
    vy = where(hd, by, where(stop, 0.0, vy))
    vz = where(hd, bz, where(stop, 0.0, vz))
    status = where(stop, 4, where(hd, 1, status))
    flags = where(hit, flags | (T.FL_STATIC_COBJ_COLL | T.FL_COLLIDED), flags)

    # ---- mesh bounce (airborne only, Physics.cpp:868-882) ----
    mesh_coll = on_mesh & moving & ~touches_water & ~hit
    pz = where(mesh_coll, torch.maximum(pz, mh + rad), pz)
    mbx, mby, mbz, did_m = bounce(mnx, mny, mnz, elas * T.LAND_ELASTICITY)
    v_sq2 = vx * vx + vy * vy + vz * vz
    stopped_m = mesh_coll & ~did_m & ((fric >= T.STICK_THRESHOLD) | xy_stop
                                      | (v_sq2 < T.BOUNCE_CUTOFF))
    md = mesh_coll & did_m
    damp_m = where(stopped_m, 0.0, 0.95)
    vx = where(md, mbx, where(mesh_coll, vx * damp_m, vx))
    vy = where(md, mby, where(mesh_coll, vy * damp_m, vy))
    vz = where(md, mbz, where(mesh_coll, vz * damp_m, vz))
    status = where(md, 1, where(mesh_coll, 2, status))
    flags = where(mesh_coll, flags | T.FL_COLLIDED, flags)

    # ---- on-ground rolling (surface_advance, Physics.cpp:980-1037) ----
    roll_ok = grounded & ~hit & ~touches_water
    stick_g = (fric >= T.STICK_THRESHOLD) | xy_stop
    killed_g = roll_ok & (pz < mh - T.KILL_DEPTH * rad)
    pz = where(roll_ok & (pz < mh - T.RECOVER_DEPTH * rad), mh, pz)
    dzn = torch.sqrt(torch.clamp(mnx * mnx + mny * mny, min=1.0e-20))
    vel_m = ((T.SURF_ADV_STEP / x_scene) * dzn
             * (1.0 - 0.5 * fric) / T.DEF_TIMESTEP)
    vel_m = where(in_water & (dens >= T.WATER_DENSITY),
                  vel_m * (dens - T.WATER_DENSITY) / torch.clamp(dens, min=_EPS),
                  vel_m)
    moved_g = (dzn > 1.0e-12) & (dzn > fric) & (vel_m > 1.0e-12)
    mvx = where(moved_g, vel_m * dx_val * mnx / dzn, 0.0)
    mvy = where(moved_g, vel_m * dy_val * mny / dzn, 0.0)
    vmult = torch.clamp(1.0 - fric, min=0.0)
    gvx = mvx * (1.0 - vmult) + vx * vmult
    gvy = mvy * (1.0 - vmult) + vy * vmult
    rolling = roll_ok & ~stick_g
    vx = where(rolling, gvx, where(roll_ok & stick_g, 0.0, vx))
    vy = where(rolling, gvy, where(roll_ok & stick_g, 0.0, vy))
    vz = where(roll_ok, 0.0, vz)
    px = px + where(rolling, gvx * tstep, 0.0)
    py = py + where(rolling, gvy * tstep, 0.0)
    pz = where(roll_ok, mh + rad, pz)
    settled = roll_ok & (stick_g | ~moved_g)
    vx = where(settled, 0.0, vx)
    vy = where(settled, 0.0, vy)
    status = where(settled, 4, where(rolling & moved_g, 3, status))
    status = where(killed_g, 0, status)
    return px, py, pz, vx, vy, vz, status, flags

"""Plain reference of the `spheres_10k` frame: N balls over the spheres
scene (a ground cube and 100 LCG spheres) and a flat mesh, water off.

Plain PyTorch, written from the engine's documented behaviour and the
port's plain paths (mesh sample, shape-grouped narrow phase restricted to
the scene's two shapes, the exact banded pair pass), and independent of
the port: it imports nothing of it and rebuilds every table it needs (the
ball's type row, the scene, the mesh maps) from the configuration.

A frame: sort the population on x (dead balls last), then `substeps`
substeps of length tstep / substeps, each integrating gravity, wind and
drag, sampling the mesh, pushing out of the deepest cobj with a bounce or
a stop, bouncing off or rolling on the mesh, and on every
`pair_every`-th substep the banded pair pass over the sorted order; then
ageing.  `dtype` runs the arithmetic in a lower precision (the control);
the sort stays in float32, since it only orders the rows.
"""

from __future__ import annotations

import math

import numpy as np
import torch

# engine constants (3DWorld.h, Physics.cpp)
LARGE_OBJ_RAD = 0.01
DEF_TIMESTEP = 0.007
GRAVITY = 300.0
STICK_THRESHOLD = 1.0
BOUNCE_CUTOFF = 2.0 * 2.0
WATER_DENSITY = 1.0
WATER_SURF_FRICTION = 0.95
LAND_ELASTICITY = 0.8
KILL_DEPTH = 12.0
RECOVER_DEPTH = 1.0
SURF_ADV_STEP = 2.0
FL_COLLIDED = 1 << 0
FL_STATIC_COBJ_COLL = 1 << 1
FL_Z_STOPPED = 1 << 2
FL_XY_STOPPED = 1 << 3
FL_IN_WATER = 1 << 4
FL_FLOATING = 1 << 5
FL_UNDERWATER = 1 << 6
BALL_TYPE_ID = 4          # the BALL entry of the engine's object type enum

FIELDS = ("px", "py", "pz", "vx", "vy", "vz", "status", "flags", "otype",
          "time", "health")
FLOATS = ("px", "py", "pz", "vx", "vy", "vz", "health")


class Grid:
    """Scene-grid constants: mesh_x x mesh_y nodes over [-x_scene, x_scene]."""

    def __init__(self, mesh_x: int, mesh_y: int, x_scene: float, y_scene: float):
        self.mesh_x, self.mesh_y = mesh_x, mesh_y
        self.x_scene = x_scene
        self.dx = 2.0 * x_scene / mesh_x
        self.dy = 2.0 * y_scene / mesh_y
        self.dx_inv = 1.0 / self.dx
        self.dy_inv = 1.0 / self.dy


def ball_params(timestep: float = DEF_TIMESTEP) -> dict:
    """The BALL row of the engine's type table (Physics.cpp:95-585):
    float32 values, terminal velocity 1/air, mass fixed at 1, lifetime in
    frames scaled by 0.01/timestep."""
    f = np.float32
    air = f(0.05)
    return dict(radius=f(0.042), air=air, friction=f(0.02), gravity=f(0.3),
                elasticity=f(0.92), density=f(0.7),
                terminal_vel=f(1.0 / max(1e-6, float(air))), mass=f(1.0),
                lifetime=f(int((0.01 / timestep) * 1600)), health=f(20000.0))


class RandGen:
    """The engine's two-seed combined LCG (rand_gen.h:19-34)."""

    def __init__(self, s1: int, s2: int):
        self.s1, self.s2 = s1, s2

    def randd(self) -> float:
        s1 = 40014 * (self.s1 % 53668) - 12211 * (self.s1 // 53668)
        s1 += 2147483563 if s1 < 0 else 0
        s2 = 40692 * (self.s2 % 52774) - 3791 * (self.s2 // 52774)
        s2 += 2147483399 if s2 < 0 else 0
        self.s1, self.s2 = s1, s2
        r = s1 - s2
        r += 2147483562 if r < 1 else 0
        return r / 2147483563

    def rand_uniform(self, lo: float, hi: float) -> float:
        return lo + (hi - lo) * self.randd()


def scene(num_spheres: int = 100, seed=(7, 3), elasticity: float = 0.9,
          device="cpu") -> dict:
    """coll_objs/spheres.txt: the ground cube [-4,4]^2 x [-0.7,0] and
    `num_spheres` spheres resting on it (radius, x, y drawn in that order
    from the LCG), all of elasticity 0.9 and friction 0."""
    rg = RandGen(*seed)
    sph = []
    for _ in range(num_spheres):
        r = rg.rand_uniform(0.1, 0.25)
        x = rg.rand_uniform(-2.5, 2.5)
        y = rg.rand_uniform(-2.5, 2.5)
        sph.append((x, y, r, r))
    f32 = dict(dtype=torch.float32, device=device)
    s = torch.tensor(np.asarray(sph, np.float32), **f32)
    return dict(cube_lo=torch.tensor([-4.0, -4.0, -0.7], **f32),
                cube_hi=torch.tensor([4.0, 4.0, 0.0], **f32),
                sph_c=s[:, :3], sph_r=s[:, 3],
                elasticity=torch.full((1 + num_spheres,), elasticity, **f32),
                friction=torch.zeros((1 + num_spheres,), **f32))


def initial_state(pos: torch.Tensor, vel: torch.Tensor) -> dict:
    """Balls at pos/vel [N, 3], airborne, unflagged, aged 0."""
    n = pos.shape[0]
    i32 = dict(dtype=torch.int32, device=pos.device)
    p = ball_params()
    return dict(px=pos[:, 0].contiguous(), py=pos[:, 1].contiguous(),
                pz=pos[:, 2].contiguous(), vx=vel[:, 0].contiguous(),
                vy=vel[:, 1].contiguous(), vz=vel[:, 2].contiguous(),
                status=torch.ones(n, **i32), flags=torch.zeros(n, **i32),
                otype=torch.full((n,), BALL_TYPE_ID, **i32),
                time=torch.zeros(n, **i32),
                health=torch.full((n,), float(p["health"]), dtype=torch.float32,
                                  device=pos.device))


# ---------------------------------------------------------------------------
# mesh
# ---------------------------------------------------------------------------

def mesh_maps(mesh: torch.Tensor, g: Grid):
    """(height, dz/dx, dz/dy): periodic central differences."""
    dzdx = (torch.roll(mesh, -1, 1) - torch.roll(mesh, 1, 1)) * (0.5 * g.dx_inv)
    dzdy = (torch.roll(mesh, -1, 0) - torch.roll(mesh, 1, 0)) * (0.5 * g.dy_inv)
    return mesh, dzdx, dzdy


def sample_mesh(maps, x, y, g: Grid):
    """Bilinear (height, normal) at (x, y): floor clamped to [0, n-2],
    fraction to [0, 1], y contracted first."""
    my, mx = maps[0].shape
    gx = x * g.dx_inv + mx // 2
    gy = y * g.dy_inv + my // 2
    x0 = torch.clamp(torch.floor(gx).long(), 0, mx - 2)
    y0 = torch.clamp(torch.floor(gy).long(), 0, my - 2)
    fx = torch.clamp(gx - x0.to(gx.dtype), 0.0, 1.0)
    fy = torch.clamp(gy - y0.to(gy.dtype), 0.0, 1.0)
    wx0, wy0 = 1.0 - fx, 1.0 - fy

    def interp(m):
        c0 = m[y0, x0] * wy0 + m[y0 + 1, x0] * fy
        c1 = m[y0, x0 + 1] * wy0 + m[y0 + 1, x0 + 1] * fy
        return c0 * wx0 + c1 * fx

    h, sx, sy = (interp(m) for m in maps)
    inv = torch.rsqrt(sx * sx + sy * sy + 1.0)
    return h, -sx * inv, -sy * inv, inv


def outside_mesh(x, y, g: Grid):
    gx = x * g.dx_inv + g.mesh_x // 2
    gy = y * g.dy_inv + g.mesh_y // 2
    return (gx < 0) | (gx >= g.mesh_x) | (gy < 0) | (gy >= g.mesh_y)


# ---------------------------------------------------------------------------
# narrow phase: the deepest penetrating cobj (cube first, then the spheres
# in scene order; first index on ties)
# ---------------------------------------------------------------------------

def _norm3(ax, ay, az):
    d = torch.sqrt(ax * ax + ay * ay + az * az)
    inv = 1.0 / torch.clamp(d, min=1e-12)
    return d, ax * inv, ay * inv, az * inv


def _cube(X, Y, Z, r, lo, hi):
    lox, loy, loz = (torch.minimum(lo[k], hi[k]) for k in range(3))
    hix, hiy, hiz = (torch.maximum(lo[k], hi[k]) for k in range(3))
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
    unit = lambda a, b: torch.where(a < b, -1.0, 1.0)
    return (torch.where(outside, r - dist_out, r + din),
            torch.where(outside, ox, torch.where(use_x, unit(dxl, dxh), 0.0)),
            torch.where(outside, oy, torch.where(use_y, unit(dyl, dyh), 0.0)),
            torch.where(outside, oz, torch.where(use_z, unit(dzl, dzh), 0.0)))


def deepest_hits(px, py, pz, radius, sc: dict):
    """(hit, pen, nx, ny, nz, elasticity, friction), each [N]."""
    X, Y, Z, r = px[:, None], py[:, None], pz[:, None], radius[:, None]
    cube = _cube(X, Y, Z, r, sc["cube_lo"], sc["cube_hi"])
    c = sc["sph_c"]
    dist, sx, sy, sz = _norm3(X - c[:, 0], Y - c[:, 1], Z - c[:, 2])
    sphere = ((r + sc["sph_r"]) - dist, sx, sy, sz)
    pen, nx, ny, nz = (torch.cat([a, b], dim=1) for a, b in zip(cube, sphere))
    i = torch.argmax(pen, dim=1, keepdim=True)
    pick = lambda a: torch.gather(a, 1, i)[:, 0]
    best = pick(pen)
    return (best > 0.0, best, pick(nx), pick(ny), pick(nz),
            sc["elasticity"][i[:, 0]], sc["friction"][i[:, 0]])


# ---------------------------------------------------------------------------
# bounce, pairs, substep, frame
# ---------------------------------------------------------------------------

def bounce_velocity(vx, vy, vz, nx, ny, nz, elasticity, air_factor):
    """Reflect about the normal; xy scaled by e*(1-air), z by e; the
    bounce holds only if the result's |v|^2 reaches BOUNCE_CUTOFF."""
    e = torch.clamp(elasticity, 0.0, 1.0)
    vdotn = vx * nx + vy * ny + vz * nz
    bx = vx - 2.0 * vdotn * nx
    by = vy - 2.0 * vdotn * ny
    bz = vz - 2.0 * vdotn * nz
    exy = e * (1.0 - air_factor)
    bx, by, bz = bx * exy, by * exy, bz * e
    did = (bx * bx + by * by + bz * bz) >= BOUNCE_CUTOFF
    return (torch.where(did, bx, vx), torch.where(did, by, vy),
            torch.where(did, bz, vz), did)


def banded_pairs(px, py, pz, vx, vy, vz, radius, mass, elas, active,
                 window: int, work: list | None = None):
    """Each row against its `window` successors in the sorted order:
    mass-weighted push-out of overlapping pairs plus a restitution impulse
    at min(elasticity) when they approach, summed by offset, i side
    first.  `work` receives (rows, pair tests, contacts) of the pass."""
    n = px.shape[0]
    act = active.to(px.dtype)
    idx = torch.arange(n, device=px.device)
    dpx, dpy, dpz, dvx, dvy, dvz = (torch.zeros_like(px) for _ in range(6))
    n_valid = torch.zeros((), dtype=torch.int64, device=px.device)
    n_hit = torch.zeros_like(n_valid)
    for d in range(1, window + 1):
        sh = lambda a: torch.roll(a, -d, 0)
        ex = px - sh(px)
        ey = py - sh(py)
        ez = pz - sh(pz)
        d2 = torch.clamp(ex * ex + ey * ey + ez * ez, min=1e-12)
        dist = torch.sqrt(d2)
        rsum = radius + sh(radius)
        valid = (idx < n - d) & (act > 0) & (sh(act) > 0)
        hit = valid & (dist < rsum)
        if work is not None:
            n_valid += valid.sum()
            n_hit += hit.sum()
        pen = torch.where(hit, rsum - dist, 0.0)
        m_i, m_j = mass, sh(mass)
        mw_i = m_j / (m_i + m_j)
        mw_j = m_i / (m_i + m_j)
        push_i = pen * mw_i / dist
        push_j = pen * mw_j / dist
        relv = ((vx - sh(vx)) * ex + (vy - sh(vy)) * ey + (vz - sh(vz)) * ez) / d2
        eij = torch.minimum(elas, sh(elas))
        a = torch.where(hit & (relv < 0), -(1.0 + eij) * relv, 0.0)
        ai = a * mw_i
        aj = a * mw_j
        unsh = lambda v: torch.roll(v, d, 0)
        dpx = dpx + push_i * ex - unsh(push_j * ex)
        dpy = dpy + push_i * ey - unsh(push_j * ey)
        dpz = dpz + push_i * ez - unsh(push_j * ez)
        dvx = dvx + ai * ex - unsh(aj * ex)
        dvy = dvy + ai * ey - unsh(aj * ey)
        dvz = dvz + ai * ez - unsh(aj * ez)
    if work is not None:
        work.append((n, n_valid, n_hit))
    return dpx, dpy, dpz, dvx, dvy, dvz


def _substep(s: dict, p: dict, sc: dict, maps, g: Grid, tstep: float,
             run_pairs: bool, window: int, env: dict, work) -> dict:
    """One substep with water off (`disable_water 1`)."""
    rad, air, fric, grav = p["radius"], p["air"], p["friction"], p["gravity"]
    elas, dens, tv, mass = p["elasticity"], p["density"], p["terminal_vel"], p["mass"]
    alive = s["status"] > 0
    coll_last = (s["flags"] & FL_COLLIDED) != 0
    flags = s["flags"] & ~FL_COLLIDED
    floating = (flags & FL_FLOATING) != 0
    z_stop = (flags & FL_Z_STOPPED) != 0
    xy_stop = (flags & FL_XY_STOPPED) != 0
    underwater = (flags & FL_UNDERWATER) != 0
    in_water = (flags & FL_IN_WATER) != 0
    moving = alive & (s["status"] == 1)
    grounded = alive & ((s["status"] == 2) | (s["status"] == 3))
    px, py, pz = s["px"], s["py"], s["pz"]
    vx, vy, vz = s["vx"], s["vy"], s["vz"]

    air_eff = torch.where(underwater, 0.0,
                          torch.where(floating, (1.0 - WATER_SURF_FRICTION) * air, air))
    unstop = z_stop & moving & ((pz - rad) > env["water_plane_z"]) \
        & (fric < 2.0 * STICK_THRESHOLD)
    z_stop = z_stop & ~unstop
    flags = torch.where(unstop, flags & ~FL_Z_STOPPED, flags)
    vz = torch.where(z_stop & moving, 0.0, vz)
    collided = coll_last | (torch.abs(vz) < 1.0e-6)

    gscale = torch.where(in_water & (dens > WATER_DENSITY),
                         (dens - WATER_DENSITY) / dens, 1.0)
    can_fall = moving & ~z_stop
    vz_new = torch.where(-vz < tv,
                         torch.maximum(vz - env["gravity"] * gscale * GRAVITY
                                       * tstep * grav, -tv),
                         vz)
    vz = torch.where(can_fall, vz_new, vz)
    wx, wy, wz = env["wind"]
    vz = torch.where(can_fall & ((torch.abs(air_eff * wz) > torch.abs(vz))
                                 | ((wz < 0) != (vz < 0))),
                     vz + air_eff * wz, vz)
    move_xy = moving & ~xy_stop

    def drag(v, w):
        vtot = v + torch.where(collided, 0.0, w)
        c = (torch.abs(air_eff * vtot) > torch.abs(v)) | ((vtot < 0) != (v < 0))
        return torch.where(c & move_xy, (1.0 - air_eff) * v + air_eff * vtot, v)

    vx = drag(vx, wx)
    vy = drag(vy, wy)
    px = px + torch.where(move_xy, tstep * vx, 0.0)
    py = py + torch.where(move_xy, tstep * vy, 0.0)
    pz = pz + torch.where(moving, tstep * vz, 0.0)

    mh, mnx, mny, mnz = sample_mesh(maps, px, py, g)
    off_mesh = outside_mesh(px, py, g)
    on_mesh = ~off_mesh & ((pz - rad) <= mh)
    status = s["status"]

    hit, pen, cnx, cny, cnz, celas, cfric = deepest_hits(px, py, pz, rad, sc)
    hit = hit & alive
    px = px + torch.where(hit, pen * cnx, 0.0)
    py = py + torch.where(hit, pen * cny, 0.0)
    pz = pz + torch.where(hit, pen * cnz, 0.0)
    bx, by, bz, did = bounce_velocity(vx, vy, vz, cnx, cny, cnz, elas * celas, air)
    v_sq_c = vx * vx + vy * vy + vz * vz
    stop = hit & ~did & ((torch.maximum(fric, cfric) >= STICK_THRESHOLD)
                         | (v_sq_c < BOUNCE_CUTOFF))
    hd = hit & did
    vx = torch.where(hd, bx, torch.where(stop, 0.0, vx))
    vy = torch.where(hd, by, torch.where(stop, 0.0, vy))
    vz = torch.where(hd, bz, torch.where(stop, 0.0, vz))
    status = torch.where(stop, 4, torch.where(hd, 1, status))
    flags = torch.where(hit, flags | (FL_STATIC_COBJ_COLL | FL_COLLIDED), flags)
    cobj_hit = hit

    mesh_coll = on_mesh & moving & ~cobj_hit
    pz = torch.where(mesh_coll, torch.maximum(pz, mh + rad), pz)
    bx, by, bz, did_m = bounce_velocity(vx, vy, vz, mnx, mny, mnz,
                                        elas * LAND_ELASTICITY, air)
    v_sq2 = vx * vx + vy * vy + vz * vz
    stopped_m = mesh_coll & ~did_m & ((fric >= STICK_THRESHOLD) | xy_stop
                                      | (v_sq2 < BOUNCE_CUTOFF))
    md = mesh_coll & did_m
    damp_m = torch.where(stopped_m, 0.0, 0.95)
    vx = torch.where(md, bx, torch.where(mesh_coll, vx * damp_m, vx))
    vy = torch.where(md, by, torch.where(mesh_coll, vy * damp_m, vy))
    vz = torch.where(md, bz, torch.where(mesh_coll, vz * damp_m, vz))
    status = torch.where(md, 1, torch.where(mesh_coll, 2, status))

    roll_ok = grounded & ~cobj_hit
    stick_g = (fric >= STICK_THRESHOLD) | xy_stop
    killed_g = roll_ok & (pz < mh - KILL_DEPTH * rad)
    pz = torch.where(roll_ok & (pz < mh - RECOVER_DEPTH * rad), mh, pz)
    dzn = torch.sqrt(torch.clamp(mnx * mnx + mny * mny, min=1.0e-20))
    vel_m = ((SURF_ADV_STEP / g.x_scene) * dzn * (1.0 - 0.5 * fric) / DEF_TIMESTEP)
    vel_m = torch.where(in_water & (dens >= WATER_DENSITY),
                        vel_m * (dens - WATER_DENSITY) / torch.clamp(dens, min=1e-9),
                        vel_m)
    moved_g = (dzn > 1.0e-12) & (dzn > fric) & (vel_m > 1.0e-12)
    mvx = torch.where(moved_g, vel_m * g.dx * mnx / dzn, 0.0)
    mvy = torch.where(moved_g, vel_m * g.dy * mny / dzn, 0.0)
    vmult = torch.clamp(1.0 - fric, min=0.0)
    gvx = mvx * (1.0 - vmult) + vx * vmult
    gvy = mvy * (1.0 - vmult) + vy * vmult
    rolling = roll_ok & ~stick_g
    vx = torch.where(rolling, gvx, torch.where(roll_ok & stick_g, 0.0, vx))
    vy = torch.where(rolling, gvy, torch.where(roll_ok & stick_g, 0.0, vy))
    vz = torch.where(roll_ok, 0.0, vz)
    px = px + torch.where(rolling, gvx * tstep, 0.0)
    py = py + torch.where(rolling, gvy * tstep, 0.0)
    pz = torch.where(roll_ok, mh + rad, pz)
    settled = roll_ok & (stick_g | ~moved_g)
    vx = torch.where(settled, 0.0, vx)
    vy = torch.where(settled, 0.0, vy)
    status = torch.where(settled, 4, torch.where(rolling & moved_g, 3, status))
    status = torch.where(killed_g, 0, status)

    if run_pairs:
        act = alive & (rad >= LARGE_OBJ_RAD)
        dpx, dpy, dpz, dvx, dvy, dvz = banded_pairs(
            px, py, pz, vx, vy, vz, rad, mass, elas, act, window, work)
        px = px + torch.where(act, dpx, 0.0)
        py = py + torch.where(act, dpy, 0.0)
        pz = pz + torch.where(act, dpz, 0.0)
        vx = vx + torch.where(act, dvx, 0.0)
        vy = vy + torch.where(act, dvy, 0.0)
        vz = vz + torch.where(act, dvz, 0.0)
        woke = act & ((dvx * dvx + dvy * dvy + dvz * dvz) > 1e-10)
        status = torch.where(woke & (status == 4), 1, status)

    status = torch.where(pz < env["zmin"], 0, status)
    status = torch.where(off_mesh & alive, 0, status)
    return dict(s, px=px, py=py, pz=pz, vx=vx, vy=vy, vz=vz, status=status,
                flags=flags)


class Frame:
    """The reference frame of one configuration, its tables rebuilt here."""

    def __init__(self, cfg: dict, device):
        sc = cfg["scene"]
        self.grid = Grid(cfg["mesh_x"], cfg["mesh_y"], cfg["x_scene"], cfg["y_scene"])
        self.substeps = cfg["substeps"]
        self.pair_every = cfg["pair_every"]
        self.window = cfg["pair_window"]
        self.scene = scene(sc["num_spheres"], tuple(sc["lcg_seed"]),
                           sc["elasticity"], device)
        self.mesh = torch.full((cfg["mesh_y"], cfg["mesh_x"]), cfg["mesh_z"],
                               dtype=torch.float32, device=device)
        self.params = ball_params()
        self.env = dict(water_plane_z=cfg["water_plane_z"],
                        gravity=cfg["base_gravity"], wind=tuple(cfg["wind"]),
                        zmin=-cfg["z_scene"])
        self.device = device

    def __call__(self, state: dict, dtype=torch.float32,
                 work: list | None = None) -> dict:
        """The frame after `state` (a dict of FIELDS, x-sorted or not),
        in float32 or in `dtype`; returns float32 fields."""
        if not bool((state["otype"] == BALL_TYPE_ID).all()):
            raise ValueError("the reference frame holds BALLs only")
        # constants that `torch.where` makes into tensors take the default
        # dtype, so the control sets it to its own
        before = torch.get_default_dtype()
        torch.set_default_dtype(dtype)
        try:
            return self._frame(state, dtype, work)
        finally:
            torch.set_default_dtype(before)

    def _frame(self, state: dict, dtype, work) -> dict:
        k = torch.where(state["status"] > 0, state["px"], math.inf)
        idx = torch.sort(k, stable=True).indices
        s = {f: state[f][idx].to(dtype) if f in FLOATS else state[f][idx]
             for f in FIELDS}
        n = s["px"].shape[0]
        p = {k: torch.full((n,), float(v), dtype=dtype, device=self.device)
             for k, v in self.params.items()}
        sc = {k: v.to(dtype) for k, v in self.scene.items()}
        maps = mesh_maps(self.mesh.to(dtype), self.grid)
        tstep = float(torch.tensor(DEF_TIMESTEP / self.substeps, dtype=torch.float32))
        for k in range(self.substeps):
            run_pairs = self.pair_every <= 1 or k % self.pair_every == 0
            s = _substep(s, p, sc, maps, self.grid, tstep, run_pairs, self.window,
                         self.env, work)
        time = s["time"] + 1
        status = torch.where((p["lifetime"] > 0) & (time.to(dtype) > p["lifetime"]),
                             0, s["status"])
        s = dict(s, time=time, status=status)
        return {f: s[f].float() if f in FLOATS else s[f] for f in FIELDS}


def readings(cand: dict, ref: dict) -> dict:
    """The numbers by which a frame's result `cand` is held against the
    reference's `ref` (both dicts of FIELDS, rows in the same order):
    the largest position and velocity error of any ball, the 99th
    percentile of the position errors, the balls whose position is off by
    more than 1e-5, and the balls whose integer fields or health differ."""
    def err(keys):
        d = torch.stack([(cand[k].float() - ref[k].float()).abs() for k in keys])
        return torch.nan_to_num(d, nan=math.inf).amax(0)
    pos = err(("px", "py", "pz"))
    vel = err(("vx", "vy", "vz"))
    fields = torch.zeros_like(cand["status"], dtype=torch.bool)
    for k in ("status", "flags", "otype", "time", "health"):
        fields |= cand[k] != ref[k]
    return {"pos_err_max": float(pos.max()), "vel_err_max": float(vel.max()),
            "pos_err_p99": float(torch.quantile(pos.double(), 0.99)),
            "balls_pos_off": float((pos > 1e-5).sum()),
            "balls_fields_off": float(fields.sum())}

"""Plain reference of the sky part of the lighting bake over the spheres
scene (`spheres_lighting`): a ground cube, 100 LCG spheres and a flat
mesh under them, lit from the sky dome into the light grid.

Plain PyTorch in float32, written from the engine's documented behaviour
(`cast_light_ray` and `trace_ray_block_sky`, ray_trace.cpp:256-490 and
:830) as the port's docstrings restate it, and independent of the port:
it imports nothing of it, rebuilds the scene from the configuration
(`reference/spheres.scene`), tests each ray against the cobjs one at a
time, marches the mesh by plain bilinear sampling, and sums the deposits
by `index_add_` in float64, rounded to float32 at the end.  TF32 plays no
part (no matrix product).  Square roots, sines and cosines are taken in
float64 and rounded once to float32, and divisions by a constant divide
by a float32 tensor, so every rounding is the IEEE one on every device.

A block is a list of batches, each traced to its end on its own draws,
which the caller records from the program (the dome point and target
uniforms, each bounce's scatter pair, each compaction's survivor keys).
Per ray and bounce: the nearest hit of the cube (slab test), the spheres
(quadratic) and the mesh (`mesh_steps` samples along the part of the
segment over the mesh, the first below it), a miss ending the ray at
`line_length`; a lit hit deposits its segment as S samples spread evenly
over the part inside the grid's box, each of weight w x (part length /
hit distance) / S (S = 8 at bounce 0, 4 after); the weight takes the
albedo's luminance and the diffuse reflectance 0.9; a ray dies when it
misses or its weight falls under 0.01 of its start; it leaves along a
cosine-weighted direction around the normal, 1e-4 off the surface.

Departures from `cast_light_ray` that the port makes and this reference
shares: the rays of a batch bounce in lockstep, a fixed number of
bounces; each slot follows one branch (no transmission or specular in
this scene, so only the diffuse one); the segment's deposit is sampled,
not walked cell by cell; and the population is compacted after bounce b
to n >> (b + 2) slots (n >> 5 at least from bounce 3 on, never under
1,024): the alive rays with the smallest draws survive, the dead fill any
slot left, and where more were alive than kept each survivor's weight
(and start weight) is multiplied by alive / kept.

`dtype` bfloat16 rounds each deposit value to bfloat16 before the sum
(the control).
"""

from __future__ import annotations

import math

import torch

from benchmark.reference import spheres as RS

BIG = 1e30
EPS = 1e-9
DIFFUSE_REFL = 0.9
WEIGHT_THRESH = 0.01
MESH_ALBEDO = (0.55, 0.45, 0.30)
SURFACE_EPS = 1e-4


def _sqrt(x):
    return torch.sqrt(x.double()).to(x.dtype)


def _cos(x):
    return torch.cos(x.double()).to(x.dtype)


def _sin(x):
    return torch.sin(x.double()).to(x.dtype)


def _div(a, s: float):
    return a / torch.full((), s, dtype=a.dtype, device=a.device)


class Scene:
    """The configuration's scene and grid on `device`."""

    def __init__(self, cfg: dict, device):
        sc = cfg["scene"]
        s = RS.scene(sc["num_spheres"], tuple(sc["lcg_seed"]), device=device)
        self.cube_lo, self.cube_hi = s["cube_lo"], s["cube_hi"]
        self.sph_c, self.sph_r = s["sph_c"], s["sph_r"]
        self.albedo = tuple(float(v) for v in cfg["cobj_color"][:3])
        self.mx, self.my, self.nz = cfg["mesh_x"], cfg["mesh_y"], cfg["light_layers"]
        self.dx = 2.0 * cfg["x_scene"] / self.mx
        self.dy = 2.0 * cfg["y_scene"] / self.my
        self.dx_inv, self.dy_inv = 1.0 / self.dx, 1.0 / self.dy
        self.x_scene, self.y_scene, self.z_scene = cfg["x_scene"], cfg["y_scene"], cfg["z_scene"]
        f32 = dict(dtype=torch.float32, device=device)
        self.z0 = torch.tensor(-self.z_scene, **f32)
        self.dz = torch.tensor(2.0 * self.z_scene / self.nz, **f32)
        self.mesh = torch.full((self.my, self.mx), cfg["mesh_z"], **f32)
        # periodic central differences of the mesh (its normals)
        m = self.mesh
        self.sx = (torch.roll(m, -1, 1) - torch.roll(m, 1, 1)) * (0.5 * self.dx_inv)
        self.sy = (torch.roll(m, -1, 0) - torch.roll(m, 1, 0)) * (0.5 * self.dy_inv)
        t = cfg["trace"]
        self.bounces, self.s0, self.s1 = t["max_bounces"], t["samples_per_segment"], t["samples_later"]
        self.line, self.steps, self.shift = t["line_length"], t["mesh_steps"], t["compact_shift"]
        self.sky = tuple(float(v) for v in t["sky_color"])
        self.cells = self.nz * self.my * self.mx
        self.device = device


def _bilinear(sc: Scene, m, x, y):
    """The mesh map `m` at world (x, y): the corner weights clamped to the
    border, contracted over y, then over x."""
    gx = x * sc.dx_inv + sc.mx // 2
    gy = y * sc.dy_inv + sc.my // 2
    x0 = torch.clamp(torch.floor(gx).long(), 0, sc.mx - 2)
    y0 = torch.clamp(torch.floor(gy).long(), 0, sc.my - 2)
    fx = torch.clamp(gx - x0.float(), 0.0, 1.0)
    fy = torch.clamp(gy - y0.float(), 0.0, 1.0)
    c0 = m[y0, x0] * (1.0 - fy) + m[y0 + 1, x0] * fy
    c1 = m[y0, x0 + 1] * (1.0 - fy) + m[y0 + 1, x0 + 1] * fy
    return c0 * (1.0 - fx) + c1 * fx


def _span(o, d, lo, hi):
    dsafe = torch.where(torch.abs(d) < 1e-12, 1e-12, d)
    ta = (lo - o) / dsafe
    tb = (hi - o) / dsafe
    return torch.minimum(ta, tb), torch.maximum(ta, tb)


def _mesh_hit(sc: Scene, ox, oy, oz, dx, dy, dz):
    """(hit, t) of the first of `steps` samples below the mesh, spread over
    the part of [0, line_length] above the mesh's footprint."""
    hx, hy = 0.5 * sc.mx * sc.dx, 0.5 * sc.my * sc.dy
    t0x, t1x = _span(ox, dx, -hx, hx)
    t0y, t1y = _span(oy, dy, -hy, hy)
    t0 = torch.clamp(torch.maximum(t0x, t0y), min=0.0)
    t1 = torch.minimum(torch.minimum(t1x, t1y), torch.full_like(ox, sc.line))
    span = torch.clamp(t1 - t0, min=0.0)
    fr = _div(torch.arange(1, sc.steps + 1, dtype=torch.float32, device=ox.device), sc.steps)
    tg = t0[:, None] + fr[None, :] * span[:, None]
    z = oz[:, None] + tg * dz[:, None]
    h = _bilinear(sc, sc.mesh, (ox[:, None] + tg * dx[:, None]).reshape(-1),
                  (oy[:, None] + tg * dy[:, None]).reshape(-1)).view(tg.shape)
    below = z < h
    k = torch.argmax(below.to(torch.int8), dim=1)
    found = below.any(dim=1) & (span > 0.0)
    return found, torch.where(found, tg.gather(1, k[:, None])[:, 0], BIG)


def _nearest_cobj(sc: Scene, ox, oy, oz, dx, dy, dz):
    """(hit, t, nx, ny, nz) of the nearest cobj within line_length: the
    cube, then each sphere, a later one taking over only when strictly
    nearer."""
    def inv(d):
        return 1.0 / torch.where(torch.abs(d) < EPS, torch.where(d < 0, -EPS, EPS), d)

    ix, iy, iz = inv(dx), inv(dy), inv(dz)
    lo, hi = sc.cube_lo, sc.cube_hi
    tn3, tf3 = [], []
    for a, (o, i) in enumerate(((ox, ix), (oy, iy), (oz, iz))):
        t1, t2 = (lo[a] - o) * i, (hi[a] - o) * i
        tn3.append(torch.minimum(t1, t2))
        tf3.append(torch.maximum(t1, t2))
    tn = torch.maximum(torch.maximum(tn3[0], tn3[1]), tn3[2])
    tf = torch.minimum(torch.minimum(tf3[0], tf3[1]), tf3[2])
    hit = (tn <= tf) & (tf > EPS) & (tn > EPS)
    best = torch.where(hit & (tn <= sc.line), tn, BIG)
    use_x = tn == tn3[0]
    use_y = (tn == tn3[1]) & ~use_x
    use_z = ~use_x & ~use_y
    nx = torch.where(use_x, -torch.sign(dx), 0.0)
    ny = torch.where(use_y, -torch.sign(dy), 0.0)
    nz = torch.where(use_z, -torch.sign(dz), 0.0)
    a2 = dx * dx + dy * dy + dz * dz
    for j in range(sc.sph_r.shape[0]):
        c, r = sc.sph_c[j], sc.sph_r[j]
        lx, ly, lz = ox - c[0], oy - c[1], oz - c[2]
        b = 2.0 * (lx * dx + ly * dy + lz * dz)
        cc = lx * lx + ly * ly + lz * lz - r * r
        disc = b * b - 4.0 * a2 * cc
        t = (-b - _sqrt(torch.clamp(disc, min=0.0))) / (2.0 * a2)
        t = torch.where((disc > 0.0) & (t > EPS) & (t <= sc.line), t, BIG)
        near = t < best
        px, py, pz = ox + t * dx - c[0], oy + t * dy - c[1], oz + t * dz - c[2]
        pl = torch.clamp(_sqrt(px * px + py * py + pz * pz), min=EPS)
        best = torch.where(near, t, best)
        nx = torch.where(near, px / pl, nx)
        ny = torch.where(near, py / pl, ny)
        nz = torch.where(near, pz / pl, nz)
    return best < BIG, best, nx, ny, nz


def _deposit(sc: Scene, acc, ox, oy, oz, dx, dy, dz, t, w, r, g, b, S: int, dtype):
    """Add the segments' S samples (r, g, b times the weight, and the
    weight) to `acc` [cells + 1, 4] float64; samples outside the box go to
    the last row."""
    hx, hy = 0.5 * sc.mx * sc.dx, 0.5 * sc.my * sc.dy
    t0x, t1x = _span(ox, dx, -hx, hx)
    t0y, t1y = _span(oy, dy, -hy, hy)
    t0z, t1z = _span(oz, dz, sc.z0, sc.z0 + sc.nz * sc.dz)
    t0 = torch.maximum(torch.maximum(t0x, t0y), torch.clamp(t0z, min=0.0))
    t1 = torch.minimum(torch.minimum(t1x, t1y), torch.minimum(t1z, t))
    span = torch.clamp(t1 - t0, min=0.0)
    fr = _div(torch.arange(S, dtype=torch.float32, device=ox.device)[None, :] + 0.5, S)
    ts = t0[:, None] + fr * span[:, None]
    px = (ox[:, None] + ts * dx[:, None]).reshape(-1)
    py = (oy[:, None] + ts * dy[:, None]).reshape(-1)
    pz = (oz[:, None] + ts * dz[:, None]).reshape(-1)
    gx = torch.floor(px * sc.dx_inv + sc.mx // 2).long()
    gy = torch.floor(py * sc.dy_inv + sc.my // 2).long()
    gz = torch.floor((pz - sc.z0) / sc.dz).long()
    ok = (gx >= 0) & (gx < sc.mx) & (gy >= 0) & (gy < sc.my) & (gz >= 0) & (gz < sc.nz)
    cell = torch.where(ok, (gz * sc.my + gy) * sc.mx + gx, sc.cells)
    wv = _div(w * (span / torch.clamp(t, min=1e-12)), S)
    vals = torch.stack([r * wv, g * wv, b * wv, wv], 1)
    vals = vals[:, None, :].expand(-1, S, -1).reshape(-1, 4)
    acc.index_add_(0, cell, vals.to(dtype).double())


def _batch(sc: Scene, acc, draws: dict, dtype) -> None:
    u, phi, tx, ty, tz = draws["rays"]
    n = u.shape[0]
    dome = 2.5 * max(sc.x_scene, sc.y_scene)
    cos_t, sin_t = _sqrt(u), _sqrt(1.0 - u)
    ox = dome * sin_t * _cos(phi)
    oy = dome * sin_t * _sin(phi)
    oz = dome * cos_t + 0.1
    dx, dy, dz = tx - ox, ty - oy, tz - oz
    dl = _sqrt(dx * dx + dy * dy + dz * dz)
    dx, dy, dz = dx / dl, dy / dl, dz / dl
    ones = torch.ones(n, dtype=torch.float32, device=u.device)
    w, w0 = ones, ones
    r, g, b = (ones * c for c in sc.sky)
    alive = torch.ones(n, dtype=torch.bool, device=u.device)
    for k in range(sc.bounces):
        chit, ct, cnx, cny, cnz = _nearest_cobj(sc, ox, oy, oz, dx, dy, dz)
        mhit, mt = _mesh_hit(sc, ox, oy, oz, dx, dy, dz)
        on_mesh = mhit & (~chit | (mt < ct))
        hit = chit | mhit
        t = torch.where(hit, torch.where(on_mesh, mt, ct), sc.line)
        lit = alive & hit
        _deposit(sc, acc, ox, oy, oz, dx, dy, dz, t, w * lit.to(torch.float32), r, g, b,
                 sc.s0 if k == 0 else sc.s1, dtype)
        hx, hy, hz = ox + t * dx, oy + t * dy, oz + t * dz
        inv = 1.0 / _sqrt(_bilinear(sc, sc.sx, hx, hy) ** 2 + _bilinear(sc, sc.sy, hx, hy) ** 2
                          + 1.0)
        nx = torch.where(on_mesh, -_bilinear(sc, sc.sx, hx, hy) * inv, cnx)
        ny = torch.where(on_mesh, -_bilinear(sc, sc.sy, hx, hy) * inv, cny)
        nz = torch.where(on_mesh, inv, cnz)
        ar, ag, ab = (torch.where(on_mesh, m, c) for m, c in zip(MESH_ALBEDO, sc.albedo))
        lum = 0.299 * ar + 0.587 * ag + 0.114 * ab
        w = w * lum * DIFFUSE_REFL
        r, g, b = r * ar, g * ag, b * ab
        alive = lit & (torch.abs(w) >= WEIGHT_THRESH * torch.abs(w0))
        # cosine-weighted: normalize(n + a random unit vector)
        su, sv = draws["bounce"][k]
        z = 2.0 * su - 1.0
        ang = (2.0 * math.pi) * sv
        rr = _sqrt(torch.clamp(1.0 - z * z, min=0.0))
        vx, vy, vz = nx + rr * _cos(ang), ny + rr * _sin(ang), nz + z
        vl = _sqrt(vx * vx + vy * vy + vz * vz) + EPS
        ox, oy, oz = hx + SURFACE_EPS * nx, hy + SURFACE_EPS * ny, hz + SURFACE_EPS * nz
        dx, dy, dz = vx / vl, vy / vl, vz / vl
        keep = max(min(n >> min(k + 1 + sc.shift, 4 + sc.shift), ox.shape[0]), 1024)
        if keep < ox.shape[0]:
            key = torch.where(alive, draws["compact"][k], 2.0)
            pick = torch.argsort(key, stable=True)[:keep]
            scale = torch.clamp(_div(alive.sum().to(torch.float32), keep), min=1.0)
            ox, oy, oz, dx, dy, dz, w, w0, r, g, b, alive = (
                v[pick] for v in (ox, oy, oz, dx, dy, dz, w, w0, r, g, b, alive))
            boost = torch.where(alive, scale, 1.0)
            w, w0 = w * boost, w0 * boost


def trace_block(sc: Scene, batches: list, dtype=torch.float32) -> torch.Tensor:
    """The sky deposits [4, nz, my, mx] (colour r, g, b times weight, and
    weight) of the block's `batches` from zero, each a dict of its draws:
    `rays` (u, phi, tx, ty, tz), `bounce` [(u, v)] a bounce, `compact`
    {bounce: keys}."""
    acc = torch.zeros((sc.cells + 1, 4), dtype=torch.float64, device=sc.device)
    for d in batches:
        _batch(sc, acc, d, dtype)
    return acc[:-1].to(torch.float32).t().reshape(4, sc.nz, sc.my, sc.mx)


def readings(delta: torch.Tensor, ref: torch.Tensor, after: torch.Tensor, batches: int,
             rtol: float, atol: float) -> dict:
    """The block's sky deposits as the program's grid moved (`delta`, the
    grid after less the grid before, in float64) against the reference's
    (`ref`): the share of lit cells where a channel differs by more than
    rtol x |ref| + atol + the rounding of `batches` additions into a grid
    that reads `after` (half an ulp each); the relative gap of the weight
    totals; the largest relative error of a colour channel among the cells
    above the median weight."""
    ref = ref.double()
    tol = rtol * ref.abs() + atol + batches * 2.0 ** -24 * after.double().abs()
    off = ((delta - ref).abs() > tol).any(0)
    lit = (ref != 0).any(0) | (delta != 0).any(0)
    cells_off = float(off.sum()) / max(int(lit.sum()), 1)
    total = float(ref[3].sum())
    gap = abs(float(delta[3].sum()) - total) / max(total, 1e-30)
    wref = ref[3][ref[3] > 0]
    color = 0.0
    if wref.numel():
        heavy = ref[3] > torch.median(wref)
        if bool(heavy.any()):
            e = (delta[:3] - ref[:3]).abs() / ref[:3].abs().clamp(min=1e-30)
            color = float(e[:, heavy].max())
    return {"sky_cells_off": cells_off, "sky_weight_gap": gap, "sky_color_err_max": color}

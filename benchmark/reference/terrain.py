"""Plain reference of the `tiled_terrain_128` tile: sine-table noise,
glaciation and droplet erosion with a roam ring, for a batch of tiles.

Plain PyTorch, written from the engine's documented generator (the
90-entry random sine table of mesh_gen.cpp:219-254 evaluated separably,
the glaciation curve of mesh_gen.cpp:380-385, ranmantaru's droplet walk of
erosion.cpp:14-165 in lockstep batches) and the port's plain paths,
independent of the port: it imports nothing of it and rebuilds the sine
table, the rock threshold, the droplet starts and the walk's parameters
from the configuration.

The walk sums each step's deposits and erosion in 64-bit fixed point, so
its result does not depend on the order of the writes.  `tf32` rounds
the noise's matrix operands to TF32 (the control); otherwise the product
runs in full float32.
"""

from __future__ import annotations

import numpy as np
import torch

# erosion.cpp:24 and the walk's fixed point
KQ, KW, KR, KD, KI = 10.0, 0.001, 0.9, 0.02, 0.1
MIN_SLOPE = 0.05
KG = 2.0 * 20.0
ERODE_STENCIL_NORM = 0.1591549430918953   # 1/(2*pi), erosion.cpp:141
FLT_EPSILON = float(np.float32(1.1920929e-07))
FIXED_BITS = 40
# mesh_gen.cpp:14-34, 20-28, 42-44
NUM_FREQ_COMP, N_RAND_SIN2, MIN_FREQS = 9, 10, 3
W_PLANE_Z = 0.42
MESH_RH_DIRT = (0.40, 0.44, 0.60, 0.75, 1.0)


class RandGen:
    """The engine's two-seed combined LCG (rand_gen.h:19-34)."""

    def __init__(self, s1: int = 1, s2: int = 1):
        self.s1, self.s2 = s1, s2

    def rand(self) -> int:
        s1 = 40014 * (self.s1 % 53668) - 12211 * (self.s1 // 53668)
        s1 += 2147483563 if s1 < 0 else 0
        s2 = 40692 * (self.s2 % 52774) - 3791 * (self.s2 // 52774)
        s2 += 2147483399 if s2 < 0 else 0
        self.s1, self.s2 = s1, s2
        r = s1 - s2
        return r + 2147483562 if r < 1 else r

    def randd(self) -> float:
        return self.rand() / 2147483563

    def rand_float(self) -> float:
        return 1.0e-6 * (self.rand() % 1000000)


def sine_table(cfg: dict) -> np.ndarray:
    """[90, 5] float32 (magnitude, y phase, x phase, y frequency, x
    frequency), drawn 5 per entry, octave-major, each product rounded in
    float32 (mesh_gen.cpp:219-254)."""
    F = np.float32
    mx, my = cfg["mesh_x"], cfg["mesh_y"]
    rgen = RandGen()
    if cfg["mesh_seed"] != 0:
        rgen = RandGen(cfg["mesh_seed"], 12345)
    xf_scale = F(my) / F(mx)
    yf_scale = F(1.0) / xf_scale
    mags = [F(0.02)]
    freqs = [F(240.0)]
    for _ in range(1, NUM_FREQ_COMP):
        freqs.append(freqs[-1] * F(0.5))
        mags.append(mags[-1] * F(2.0))
    scaled_height = 0.10 * cfg["z_scene"] * cfg["mesh_height_scale"]
    mesh_h = F(scaled_height / np.sqrt(0.1 * N_RAND_SIN2))
    two_pi = F(2.0 * np.pi)
    ru = lambda lo, hi: F(lo) + F(hi - lo) * F(rgen.randd())
    out = np.zeros((NUM_FREQ_COMP * N_RAND_SIN2, 5), np.float32)
    for level in range(NUM_FREQ_COMP):
        x_freq = freqs[level] / F(mx)
        y_freq = freqs[level] / F(my)
        mheight = mags[level] * mesh_h
        for i in range(N_RAND_SIN2):
            row = out[level * N_RAND_SIN2 + i]
            row[0] = ru(0.2, 1.0) * mheight
            row[1] = F(rgen.rand_float()) * two_pi
            row[2] = F(rgen.rand_float()) * two_pi
            row[3] = ru(0.1, 1.0) * x_freq * yf_scale
            row[4] = ru(0.1, 1.0) * y_freq * xf_scale
    return out


def rock_threshold(cfg: dict) -> float:
    """The rock-vs-dirt relative height (Textures.cpp:1757-1761) from the
    water-adjusted texture bands (mesh_gen.cpp:407-431)."""
    rel_wpz = float(np.clip(W_PLANE_Z + cfg["water_h_off_rel"], 0.0, 1.0))
    zv = []
    for def_h in MESH_RH_DIRT[:2]:
        zv.append(def_h * rel_wpz / W_PLANE_Z if def_h < W_PLANE_Z
                  else rel_wpz + (def_h - W_PLANE_Z) / (1.0 - W_PLANE_Z) * (1.0 - rel_wpz))
    e = cfg["glaciate_exp"]
    return 0.90 * zv[1] ** e + 0.10 * zv[0] ** e


def raw_heights(table: torch.Tensor, x0: torch.Tensor, y0: torch.Tensor,
                cfg: dict, tf32: bool = False) -> torch.Tensor:
    """[T, n, n] sine-table heights of tiles at grid origins x0, y0 [T]:
    per-axis term tables, then one matrix product per tile."""
    n = cfg["tile_size"]
    dx = 2.0 * cfg["x_scene"] / cfg["mesh_x"]
    dy = 2.0 * cfg["y_scene"] / cfg["mesh_y"]
    scale = cfg["mesh_scale"]
    iscale = int(np.log2(scale)) if scale > 0 else 0
    start = N_RAND_SIN2 * max(0, min(NUM_FREQ_COMP - MIN_FREQS,
                                     iscale + cfg["mesh_freq_filter"]))
    mag, phase_y, phase_x, freq_y, freq_x = table.unbind(1)
    dev = table.device
    x0 = x0.to(torch.float32)[:, None]
    y0 = y0.to(torch.float32)[:, None]
    x_mult = scale * (1.0 / dx) * freq_x
    y_mult = scale * (1.0 / dy) * freq_y
    y_scale = (1.0 / cfg["mesh_scale_z"]) * mag
    x_const = 0.5 * scale * freq_x + phase_x + x_mult * (dx * x0)
    y_const = 0.5 * scale * freq_y + phase_y + y_mult * (dy * y0)
    i = torch.arange(n, dtype=torch.float32, device=dev)[:, None]
    xt = torch.sin(x_mult * dx * i + x_const[:, None, :])
    yt = y_scale * torch.sin(y_mult * dy * i + y_const[:, None, :])
    if start > 0:
        xt = xt * (torch.arange(table.shape[0], device=dev) >= start).to(xt.dtype)
    if tf32:
        xt, yt = to_tf32(xt), to_tf32(yt)
    return torch.einsum("...xk,...yk->...yx", xt, yt)


def to_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32's 10 mantissa bits (to nearest, ties away),
    as a TF32 matrix product rounds its operands; the same on every
    device."""
    i = x.contiguous().view(torch.int32)
    return ((i + 0x1000) & ~0x1FFF).view(torch.float32)


def glaciate(z: torch.Tensor, zmax_est: torch.Tensor, exp: float) -> torch.Tensor:
    """Relative-height power curve (mesh_gen.cpp:380-385)."""
    zmax2 = 2.0 * zmax_est
    relh = torch.clamp((z + zmax_est) / zmax2, min=0.0)
    g = relh * relh * relh if exp == 3.0 else torch.pow(relh, exp)
    return g * zmax2 - zmax_est


# ---------------------------------------------------------------------------
# erosion
# ---------------------------------------------------------------------------

def _lcg_step(s, a: int, q: int, r: int, m: int):
    s = a * (s % q) - r * (s // q)
    return s + (s < 0).to(s.dtype) * m


def droplet_starts(num: int, xs: int, ys: int, pad: int, device):
    """Start cells (erosion.cpp:68-71): droplet i seeds the LCG with
    (i + 11, 79 i + 121) and draws x then z."""
    it = torch.arange(num, dtype=torch.int32, device=device)
    s1, s2 = it + 11, 79 * it + 121
    out = []
    for _ in range(2):
        s1 = _lcg_step(s1, 40014, 53668, 12211, 2147483563)
        s2 = _lcg_step(s2, 40692, 52774, 3791, 2147483399)
        r = s1 - s2
        out.append(r + (r < 1).to(r.dtype) * 2147483562)
    return pad + out[0] % xs, pad + out[1] % ys


def _sqrt(x):
    # the card's float32 sqrt is correctly rounded; the CPU's vectorised
    # one is not, so there it goes through float64
    return torch.sqrt(x) if x.device.type != "cpu" else torch.sqrt(x.double()).to(x.dtype)


def _gather4(flat, nx: int, ny: int, xi, zi):
    xc0, xc1 = xi.clamp(0, nx - 1), (xi + 1).clamp(0, nx - 1)
    zc0, zc1 = zi.clamp(0, ny - 1), (zi + 1).clamp(0, ny - 1)
    g = lambda z, x: torch.gather(flat, 1, z * nx + x)
    return g(zc0, xc0), g(zc0, xc1), g(zc1, xc0), g(zc1, xc1)


def _fixed(v):
    return torch.round(v * 2.0 ** FIXED_BITS).to(torch.int64)


def _deposit(net, nx: int, ny: int, xi, zi, xf, zf, amount):
    for oz, wz in ((0, 1.0 - zf), (1, zf)):
        for ox, wx in ((0, 1.0 - xf), (1, xf)):
            z, x = zi + oz, xi + ox
            inb = (z >= 0) & (z < ny) & (x >= 0) & (x < nx)
            val = torch.where(inb, (wz * amount) * wx, 0.0)
            net.scatter_add_(1, torch.where(inb, z * nx + x, 0), _fixed(val))


def _apply(delta, net):
    return delta + net.to(torch.float32) * 2.0 ** -FIXED_BITS


def walk(hm, xi0, zi0, angles, p6, stats: dict | None = None):
    """One lockstep batch of droplets on every tile: hm [T, ny, nx]; xi0,
    zi0 [T, B] start cells; angles [steps, B] flat-spot directions; p6 the
    six walk parameters.  Returns the delta maps.  Each step reads the
    snapshot plus the batch's delta so far.  `stats` receives the
    droplet-steps walked ("live"), bilinear deposits and erosion stencils."""
    T, ny, nx = hm.shape
    B = xi0.shape[1]
    ea, water_cut, zmin, zr_inv, rock_thresh, relh_adj = p6.unbind()
    flat = hm.reshape(T, ny * nx)
    xi, zi = xi0.long(), zi0.long()
    xp, zp = xi.float(), zi.float()
    zero = torch.zeros((T, B), dtype=torch.float32, device=hm.device)
    xf = zf = dx = dz = s = v = zero
    w = zero + 1.0
    h00, h10, h01, h11 = _gather4(flat, nx, ny, xi, zi)
    h = h00
    alive = torch.ones((T, B), dtype=torch.bool, device=hm.device)
    delta = torch.zeros_like(flat)
    for t in range(angles.shape[0]):
        gx = h00 + h01 - h10 - h11
        gz = h00 + h10 - h01 - h11
        ndx = (dx - gx) * KI + gx
        ndz = (dz - gz) * KI + gz
        dl = _sqrt(ndx * ndx + ndz * ndz)
        ang = angles[t].double()
        small = dl <= FLT_EPSILON
        inv = torch.where(small, 1.0, 1.0 / torch.clamp(dl, min=FLT_EPSILON))
        ndx = torch.where(small, torch.cos(ang).float(), ndx * inv)
        ndz = torch.where(small, torch.sin(ang).float(), ndz * inv)
        nxp, nzp = xp + ndx, zp + ndz
        nxi, nzi = torch.floor(nxp).long(), torch.floor(nzp).long()
        nxf, nzf = nxp - nxi.float(), nzp - nzi.float()
        nh00, nh10, nh01, nh11 = _gather4(flat + delta, nx, ny, nxi, nzi)
        nh = (nh00 * (1 - nxf) + nh10 * nxf) * (1 - nzf) \
            + (nh01 * (1 - nxf) + nh11 * nxf) * nzf
        nmax = torch.maximum(torch.maximum(nh00, nh10), torch.maximum(nh01, nh11))
        ocean = nmax < water_cut
        outside = (xi < 0) | (zi < 0) | (xi >= nx) | (zi >= ny)
        uphill = (nh >= h) | outside
        ds_fill = (nh - h) + 0.001
        full = (ds_fill >= s) | outside
        dep_pit = torch.where(uphill, torch.where(full, s, ds_fill), 0.0)
        die_pit = uphill & full
        ns = s - dep_pit
        fill = uphill & ~full
        nhh = h + torch.where(fill, ds_fill, 0.0)
        nv = torch.where(fill, 0.0, v)
        dh = nhh - nh
        q = torch.clamp(dh, min=MIN_SLOPE) * nv * w * KQ
        ds2 = ns - q
        go_on = alive & ~ocean & ~die_pit
        deposit_branch = ds2 >= 0
        dep_cap = torch.where(go_on & deposit_branch, ds2 * KD, 0.0)
        ns = ns - dep_cap
        dh = dh + dep_cap
        relh = relh_adj + (nh - zmin) * zr_inv
        rockf = torch.where(relh > rock_thresh, 0.5, 2.0)
        e_amt = torch.minimum(-KR * ds2, dh * 0.99) * rockf
        e_amt = torch.where(go_on & ~deposit_branch, e_amt, 0.0)
        dh = dh - e_amt
        ns = ns + e_amt
        depv = torch.where(alive & ~ocean, dep_pit + dep_cap, 0.0) * ea
        ev = e_amt * ea
        if stats is not None:
            for key, m in (("live", alive), ("deposit", depv != 0), ("erode", ev != 0)):
                stats[key] = stats.get(key, 0) + m.sum()
        net = torch.zeros_like(flat, dtype=torch.int64)
        _deposit(net, nx, ny, xi, zi, xf, zf, depv)
        for kz in (-1.0, 0.0, 1.0, 2.0):
            zo = kz - zf
            zz = (zi + int(kz)).clamp(0, ny - 1)
            for kx in (-1.0, 0.0, 1.0, 2.0):
                xo = kx - xf
                wgt = torch.clamp(1.0 - (xo * xo + zo * zo) * 0.25, min=0.0) \
                    * ERODE_STENCIL_NORM
                xx = (xi + int(kx)).clamp(0, nx - 1)
                net.scatter_add_(1, zz * nx + xx, -_fixed(wgt * ev))
        delta = _apply(delta, net)
        nv = _sqrt(torch.clamp(nv * nv + KG * dh, min=0.0))
        nw = w * (1.0 - KW)
        keep = ~go_on
        sel = lambda new, old: torch.where(keep, old, new)
        xi, zi = sel(nxi, xi), sel(nzi, zi)
        xp, zp = sel(nxp, xp), sel(nzp, zp)
        xf, zf = sel(nxf, xf), sel(nzf, zf)
        dx, dz = sel(ndx, dx), sel(ndz, dz)
        s, v, w = sel(ns, s), sel(nv, v), sel(nw, w)
        h = sel(nh, h)
        h00, h10 = sel(nh00, h00), sel(nh10, h10)
        h01, h11 = sel(nh01, h01), sel(nh11, h11)
        alive = go_on
    net = torch.zeros_like(flat, dtype=torch.int64)
    last = torch.where(alive, s, 0.0) * ea
    if stats is not None:
        stats["deposit"] = stats.get("deposit", 0) + (last != 0).sum()
    _deposit(net, nx, ny, xi, zi, xf, zf, last)
    return _apply(delta, net).reshape(T, ny, nx)


class Tiles:
    """The reference tile batch of one configuration."""

    def __init__(self, cfg: dict, device):
        self.cfg = cfg
        self.device = device
        self.table = torch.as_tensor(sine_table(cfg), device=device)
        self.rock = rock_threshold(cfg)

    def params(self, zmax_est: float, water_plane_z: float) -> torch.Tensor:
        """The walk's six float32 scalars: erode amount, water cut, zmin,
        1/(zmax - zmin), rock threshold, relative-height offset."""
        f = lambda v: torch.full((), v, dtype=torch.float32, device=self.device)
        zmax = f(zmax_est)
        zmin = -zmax
        half_dxy = 0.5 * (2.0 * self.cfg["x_scene"] / self.cfg["mesh_x"]
                          + 2.0 * self.cfg["y_scene"] / self.cfg["mesh_y"])
        return torch.stack([f(self.cfg["erode_amount"]), f(water_plane_z) - half_dxy,
                            zmin, 1.0 / torch.clamp(zmax - zmin, min=1e-12),
                            f(self.rock), f(self.cfg["relh_adj_tex"])])

    def __call__(self, x0, y0, angles, zmax_est: float, water_plane_z: float,
                 tf32: bool = False, stats: dict | None = None, pre: list | None = None):
        """Heights [T, n, n] of the tiles at x0, y0 [T], eroded with
        `angles` [batches, steps, batch].  `pre` receives the heights
        before erosion."""
        cfg = self.cfg
        n = cfg["tile_size"]
        pad = cfg["erosion_pad"]
        ze = torch.full((), zmax_est, dtype=torch.float32, device=self.device)
        z = raw_heights(self.table, x0, y0, cfg, tf32)
        if cfg["glaciate"]:
            z = glaciate(z, ze, cfg["glaciate_exp"])
        if pre is not None:
            pre.append(z)
        hm = torch.nn.functional.pad(z[:, None], (pad,) * 4, mode="replicate")[:, 0]
        hm = hm.contiguous()
        iters, batch = cfg["erosion_iters_tt"], cfg["erosion_batch"]
        xi, zi = droplet_starts(iters, n, n, pad, self.device)
        nb = -(-iters // batch)
        fill = nb * batch - iters
        if fill:
            dead = torch.full((fill,), -10, dtype=torch.int32, device=self.device)
            xi, zi = torch.cat([xi, dead]), torch.cat([zi, dead])
        p6 = self.params(zmax_est, water_plane_z)
        T = hm.shape[0]
        for b in range(nb):
            xb = xi[b * batch:(b + 1) * batch].expand(T, batch).contiguous()
            zb = zi[b * batch:(b + 1) * batch].expand(T, batch).contiguous()
            hm = hm + walk(hm, xb, zb, angles[b].contiguous(), p6, stats)
        return torch.clamp(hm[:, pad:pad + n, pad:pad + n], min=-1.0e9)


def readings(cand: torch.Tensor, ref: torch.Tensor, pre: torch.Tensor) -> dict:
    """The numbers by which tiles `cand` [T, n, n] are held against the
    reference's `ref`, whose heights before erosion are `pre`: per tile
    the median of the cells' height errors, the share of cells off by
    more than 1e-4 and the mean error, each at the worst tile, and the
    largest error of any cell; and the erosion's gap: the height the
    erosion moved (the sum of |height - pre| over all cells of the
    batch) on the two sides, their difference over the reference's."""
    T = cand.shape[0]
    c = torch.nan_to_num(cand.double(), nan=float("inf")).reshape(T, -1)
    r, p = ref.double().reshape(T, -1), pre.double().reshape(T, -1)
    a = (c - r).abs()
    moved_c, moved_r = float((c - p).abs().sum()), float((r - p).abs().sum())
    return {"tile_median_err": float(a.median(dim=1).values.max()),
            "erosion_gap": abs(moved_c - moved_r) / max(moved_r, 1e-30),
            "tile_share_off": float((a > 1e-4).double().mean(dim=1).max()),
            "tile_mean_err": float((c - r).mean(dim=1).abs().max()),
            "cell_err_max": float(a.max())}

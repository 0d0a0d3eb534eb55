"""Hydraulic (droplet) erosion (port of `3dworld_tpu/ops/erosion.py`).

The reference implements ranmantaru's droplet erosion (erosion.cpp:14-165):
each droplet starts at an LCG-seeded cell, walks downhill with direction
inertia, picks up sediment in proportion to carry capacity, deposits in
pits and dies at the ocean.

Batched droplets in lockstep: a batch of B droplets advances together for
a fixed step budget.  Every step reads the LIVE map — the batch's snapshot
plus the delta written so far — so concurrent droplets see each other's
carving as the sequential reference's in-place updates do
(docs/DESIGN.md:167-180).  Batches run one after another; each batch's
delta is added to the map before the next starts.

`_walk_batch` is the plain PyTorch version of one batch walk, for a batch
of tiles at once: gathers for the corner reads, scatter-adds for the
bilinear deposit and the 4x4 erosion stencil.  Each step's writes are
summed in 64-bit fixed point (FIXED_BITS) and added to the float delta
once, so the sum does not depend on the order of the writes: the walk is
deterministic, and the kernel's atomics reproduce it bit for bit.  (The
JAX package sums in float32 in matmul order; the two agree to rounding.)
Its square roots and the flat-spot cosines and sines go through
`ops/fmath`, so the CPU walks the card's paths too.  It is the CPU path of
`ops/cuda/erosion_kernel.erosion_walk`, whose CUDA kernel runs the same
walk per tile in shared memory.  `erode` is the batch driver, the
counterpart of the JAX `erode`: with `pad` (PAD = 4 by default) the maps
get a roam ring of edge-replicated cells, which droplets may walk into
before they die (the reference's mh_padded), and are cropped back after
the walk; with pad=0 droplets die at the map's border, as in the JAX
kernel path `erode_tiles_pallas`.

The flat-spot random directions are inputs (`angles`): the JAX package
draws them with threefry, which torch cannot reproduce, so parity tests
feed the JAX draws in and `draw_angles` draws fresh ones from a
`torch.Generator`.

Constants Kq=10, Kw=0.001, Kr=0.9, Kd=0.02, Ki=0.1, minSlope=0.05, g=20
(erosion.cpp:24); 4x4 erosion stencil with weights
w = max(0, 1-(dx^2+dz^2)/4) / (2*pi) (erosion.cpp:134-144); rock (relative
height above `rock_thresh`) erodes 0.5x, dirt 2x (erosion.cpp:132,
Textures.cpp:1284-1287).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..utils import rng as w3d_rng
from ..utils.profiler import span
from .cuda import erosion_kernel as EK
from .fmath import cos32, sin32, sqrt32

# erosion.cpp:24
KQ = 10.0
KW = 0.001
KR = 0.9
KD = 0.02
KI = 0.1
MIN_SLOPE = 0.05
GRAV = 20.0
KG = 2.0 * GRAV
PAD = 4   # roam ring beyond the map's border, in cells (the JAX package's PAD)
ERODE_STENCIL_NORM = 0.1591549430918953  # 1/(2*pi), erosion.cpp:141
FLT_EPSILON = float(np.float32(1.1920929e-07))
# Each step's deposits and erosion are summed in 64-bit fixed point with
# this many fraction bits, then added to the float delta once.  Integer
# sums do not depend on order, so the walk is deterministic on any device
# and the CUDA kernel's atomics give the same bits as this version.
FIXED_BITS = 40


class ErosionParams(NamedTuple):
    erode_amount: float = 1.0
    water_plane_z: float | torch.Tensor = -1.0e9   # ocean cutoff (disabled by default)
    half_dxy: float = 0.0           # river-depth offset (erosion.cpp:98)
    zmin: float | torch.Tensor = 0.0   # for relative-height rock test
    zmax: float | torch.Tensor = 1.0
    rock_thresh: float = 2.0        # clip_hd1; >1 disables rock hardening
    relh_adj_tex: float = 0.0


def pack_params(p: ErosionParams, device) -> torch.Tensor:
    """The six float32 scalars one batch walk reads: erode_amount,
    water cut (water_plane_z - half_dxy), zmin, 1/(zmax-zmin), rock
    threshold, relative-height offset.  A device tensor, so `wpz` and
    `zmax_est` may stay on the device; host floats are filled on the
    device, so packing never waits for it."""
    def f(v):   # a host float fills on the device: no copy, no wait
        if isinstance(v, torch.Tensor):
            return v.to(device=device, dtype=torch.float32)
        return torch.full((), v, dtype=torch.float32, device=device)
    zmin = f(p.zmin)
    return torch.stack([
        f(p.erode_amount),
        f(p.water_plane_z) - p.half_dxy,
        zmin,
        1.0 / torch.clamp(f(p.zmax) - zmin, min=1e-12),
        f(p.rock_thresh),
        f(p.relh_adj_tex)])


def droplet_starts(num_iters: int, xsize: int, ysize: int, pad: int = 0,
                   device: torch.device | str = "cuda"):
    """Reference seeding (erosion.cpp:68-71):
    rgen.set_state(iter+11, 79*iter+121); xi=rand()%xs, zi=rand()%ys,
    offset by `pad` (the roam ring around the map)."""
    it = torch.arange(num_iters, dtype=torch.int32, device=device)
    state = w3d_rng.lcg_init(it + 11, 79 * it + 121)
    state, r1 = w3d_rng.lcg_next(state)
    state, r2 = w3d_rng.lcg_next(state)
    return pad + r1 % xsize, pad + r2 % ysize


def draw_angles(num_iters: int, batch_size: int, max_steps: int,
                generator: torch.Generator,
                device: torch.device | str = "cuda") -> torch.Tensor:
    """Flat-spot directions, uniform in [0, 2*pi):
    [num_batches, max_steps, batch_size]."""
    nb = -(-num_iters // batch_size)
    u = torch.rand((nb, max_steps, batch_size), generator=generator,
                   dtype=torch.float32, device=device)
    return u * (2.0 * math.pi)


def _gather4(flat, nx: int, ny: int, xi, zi):
    """Clamped corner reads (HMAP macro, erosion.cpp:39-40).
    flat [T, ny*nx]; xi/zi [T, B] int64."""
    xc0 = xi.clamp(0, nx - 1)
    xc1 = (xi + 1).clamp(0, nx - 1)
    zc0 = zi.clamp(0, ny - 1)
    zc1 = (zi + 1).clamp(0, ny - 1)
    g = lambda z, x: torch.gather(flat, 1, z * nx + x)
    return g(zc0, xc0), g(zc0, xc1), g(zc1, xc0), g(zc1, xc1)


def _fixed(v: torch.Tensor) -> torch.Tensor:
    """float32 -> int64 fixed point with FIXED_BITS fraction bits (round
    to nearest even)."""
    return torch.round(v * 2.0 ** FIXED_BITS).to(torch.int64)


def _deposit(net, nx: int, ny: int, xi, zi, xf, zf, amount):
    """Bilinear deposit (DEPOSIT macro, erosion.cpp:49-54) of `amount` at
    (xi+xf, zi+zf) into the fixed-point map net [T, ny*nx]; writes that fall
    outside the map are dropped, as the reference's bounds check does."""
    for oz, wz in ((0, 1.0 - zf), (1, zf)):
        for ox, wx in ((0, 1.0 - xf), (1, xf)):
            z, x = zi + oz, xi + ox
            inb = (z >= 0) & (z < ny) & (x >= 0) & (x < nx)
            val = torch.where(inb, (wz * amount) * wx, 0.0)
            net.scatter_add_(1, torch.where(inb, z * nx + x, 0), _fixed(val))


def _apply(delta, net):
    """delta + the fixed-point step sum, rounded to float32 once."""
    return delta + net.to(torch.float32) * 2.0 ** -FIXED_BITS


def _walk_batch(hm: torch.Tensor, xi0: torch.Tensor, zi0: torch.Tensor,
                angles: torch.Tensor, params6: torch.Tensor,
                stats: dict | None = None) -> torch.Tensor:
    """Plain version of one lockstep batch walk on a batch of tiles.

    hm [T, ny, nx] snapshot; xi0/zi0 [T, B] start cells; angles [steps, B]
    flat-spot directions (shared by the tiles); params6 from
    `pack_params`.  Returns the delta map [T, ny, nx].  A `stats` dict
    receives the walk's work as device scalars: droplet-steps walked
    ("live"), bilinear deposits ("deposit") and erosion stencils ("erode").
    """
    T, ny, nx = hm.shape
    B = xi0.shape[1]
    steps = angles.shape[0]
    ea, water_cut, zmin, zr_inv, rock_thresh, relh_adj = params6.unbind()
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
    koffs = (-1.0, 0.0, 1.0, 2.0)

    for t in range(steps):
        # gradient from carried corners (erosion.cpp:78)
        gx = h00 + h01 - h10 - h11
        gz = h00 + h10 - h01 - h11
        ndx = (dx - gx) * KI + gx
        ndz = (dz - gz) * KI + gz
        dl = sqrt32(ndx * ndx + ndz * ndz)
        ang = angles[t]
        small = dl <= FLT_EPSILON
        inv = torch.where(small, 1.0, 1.0 / torch.clamp(dl, min=FLT_EPSILON))
        ndx = torch.where(small, cos32(ang), ndx * inv)
        ndz = torch.where(small, sin32(ang), ndz * inv)
        nxp = xp + ndx
        nzp = zp + ndz
        nxi = torch.floor(nxp).long()
        nzi = torch.floor(nzp).long()
        nxf = nxp - nxi.float()
        nzf = nzp - nzi.float()
        # LIVE read: snapshot + the batch's delta so far
        nh00, nh10, nh01, nh11 = _gather4(flat + delta, nx, ny, nxi, nzi)
        nh = (nh00 * (1 - nxf) + nh10 * nxf) * (1 - nzf) \
            + (nh01 * (1 - nxf) + nh11 * nxf) * nzf
        # ocean cutoff (erosion.cpp:98): die, drop sediment
        nmax = torch.maximum(torch.maximum(nh00, nh10), torch.maximum(nh01, nh11))
        ocean = nmax < water_cut

        outside = (xi < 0) | (zi < 0) | (xi >= nx) | (zi >= ny)
        # pit / uphill handling (erosion.cpp:100-114)
        uphill = (nh >= h) | outside
        ds_fill = (nh - h) + 0.001
        full = (ds_fill >= s) | outside
        dep_pit = torch.where(uphill, torch.where(full, s, ds_fill), 0.0)
        die_pit = uphill & full
        ns = s - dep_pit
        fill = uphill & ~full
        nhh = h + torch.where(fill, ds_fill, 0.0)
        nv = torch.where(fill, 0.0, v)

        # transport capacity (erosion.cpp:116-119); dh uses updated h
        dh = nhh - nh
        q = torch.clamp(dh, min=MIN_SLOPE) * nv * w * KQ
        ds2 = ns - q
        go_on = alive & ~ocean & ~die_pit
        deposit_branch = ds2 >= 0
        dep_cap = torch.where(go_on & deposit_branch, ds2 * KD, 0.0)
        ns = ns - dep_cap
        dh = dh + dep_cap
        # erosion branch (erosion.cpp:129-147)
        relh = relh_adj + (nh - zmin) * zr_inv
        rockf = torch.where(relh > rock_thresh, 0.5, 2.0)
        e_amt = torch.minimum(-KR * ds2, dh * 0.99) * rockf
        e_amt = torch.where(go_on & ~deposit_branch, e_amt, 0.0)
        dh = dh - e_amt
        ns = ns + e_amt

        # writes at the cell the droplet stood on at the start of the step
        depv = torch.where(alive & ~ocean, dep_pit + dep_cap, 0.0) * ea
        ev = e_amt * ea
        if stats is not None:
            for key, m in (("live", alive), ("deposit", depv != 0),
                           ("erode", ev != 0)):
                stats[key] = stats.get(key, 0) + m.sum()
        net = torch.zeros_like(flat, dtype=torch.int64)
        _deposit(net, nx, ny, xi, zi, xf, zf, depv)
        for kz in koffs:
            zo = kz - zf
            zz = (zi + int(kz)).clamp(0, ny - 1)
            for kx in koffs:
                xo = kx - xf
                wgt = torch.clamp(1.0 - (xo * xo + zo * zo) * 0.25, min=0.0) \
                    * ERODE_STENCIL_NORM
                xx = (xi + int(kx)).clamp(0, nx - 1)
                net.scatter_add_(1, zz * nx + xx, -_fixed(wgt * ev))
        delta = _apply(delta, net)

        # velocity update (erosion.cpp:149, sqrt guarded)
        nv = sqrt32(torch.clamp(nv * nv + KG * dh, min=0.0))
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

    # droplets still alive at the step cap drop their sediment where they
    # stand (keeps mass conserved where paths outlive the cap)
    net = torch.zeros_like(flat, dtype=torch.int64)
    last = torch.where(alive, s, 0.0) * ea
    if stats is not None:
        stats["deposit"] = stats.get("deposit", 0) + (last != 0).sum()
    _deposit(net, nx, ny, xi, zi, xf, zf, last)
    return _apply(delta, net).reshape(T, ny, nx)


def erode(
    heightmaps: torch.Tensor,
    num_iters: int,
    params: ErosionParams,
    angles: torch.Tensor,
    min_zval: float | torch.Tensor = -1.0e9,
    batch_size: int = 1024,
    max_steps: int = 256,
    pad: int = PAD,
) -> torch.Tensor:
    """apply_erosion for a batch of tiles (erosion.cpp:14-165).

    heightmaps [T, ys, xs]; angles [num_batches, max_steps, batch_size]
    (`draw_angles`).  Every tile walks the same droplet starts.  Returns
    the eroded [T, ys, xs] maps, clamped below by `min_zval`
    (erosion.cpp:158-162).  `pad` is the roam ring beyond the border (the
    reference's mh_padded, the JAX `erode`'s `pad`): the maps are padded by
    `pad` cells with their edge values, the droplets start `pad` cells in,
    and the walk's result is cropped back to [ys, xs]; pad=0 kills droplets
    at the border, as the JAX kernel path does.  Each batch walks through
    `erosion_kernel.erosion_walk`: the plain version on the CPU, the CUDA
    kernel on the GPU.
    """
    T, ys, xs = heightmaps.shape
    dev = heightmaps.device
    hm = heightmaps.to(torch.float32)
    if pad:
        hm = torch.nn.functional.pad(hm[:, None], (pad,) * 4, mode="replicate")[:, 0]
    hm = hm.contiguous()

    xi_all, zi_all = droplet_starts(num_iters, xs, ys, pad=pad, device=dev)
    num_batches = -(-num_iters // batch_size)
    if tuple(angles.shape) != (num_batches, max_steps, batch_size):
        raise ValueError(f"angles: shape {tuple(angles.shape)}, expected "
                         f"{(num_batches, max_steps, batch_size)}")
    pad_n = num_batches * batch_size - num_iters
    if pad_n:  # dead padding droplets: start outside -> die at once, deposit 0
        fill = torch.full((pad_n,), -10, dtype=torch.int32, device=dev)
        xi_all = torch.cat([xi_all, fill])
        zi_all = torch.cat([zi_all, fill])
    xi_all = xi_all.reshape(num_batches, batch_size)
    zi_all = zi_all.reshape(num_batches, batch_size)
    p6 = pack_params(params, dev)

    with span("kernel.erosion"):
        for b in range(num_batches):
            xi = xi_all[b].expand(T, batch_size).contiguous()
            zi = zi_all[b].expand(T, batch_size).contiguous()
            hm = hm + EK.erosion_walk(hm, xi, zi, angles[b].contiguous(), p6)
    with span("sync.min_zval"):     # a host float copied to the card: waits for it
        lo = torch.as_tensor(min_zval, dtype=torch.float32, device=dev)
    return torch.clamp(hm[:, pad:pad + ys, pad:pad + xs], min=lo)

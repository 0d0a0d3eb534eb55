"""Dense directional-sweep sky lighting (port of
`3dworld_tpu/lighting/sweep.py`).

The reference (and `lighting/trace`) estimates the sky term by Monte
Carlo: millions of rays deposited into the lmap volume
(ray_trace.cpp:300+).  This module computes the same integral densely:
voxelize the scene once, then for D cosine-weighted sky directions run a
sheared transmittance scan over the whole volume, layer by layer (dense
[ny, nx] layer ops, no gathers, no scatters).  A second pass gathers one
diffuse bounce from lit surfaces (full-sphere directions,
emission-weighted).  The result is an exact D-direction quadrature of
direct sky visibility plus an approximate single diffuse bounce,
deterministic, with no Monte Carlo noise.

The JAX `lax.scan` over layers is a Python loop here; the carry
(transmittance and, when gathering, the three emission channels) shifts
as one [C, ny, nx] stack.  The shear per layer is a host float.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.constants import WorldConst, DEFAULT_WORLD
from ..physics.cobjs import CobjSet, sphere_cobj_test
from . import lmap as L


def voxelize_scene(cobjs: CobjSet, mesh, grid_z0, grid_dz, shape: tuple,
                   world: WorldConst = DEFAULT_WORLD, land_color=(0.45, 0.42, 0.38)):
    """Scene -> per-cell occupancy + surface albedo, each [nz, ny, nx].

    Cell centers are tested against every cobj with the narrow-phase
    formulas (a [ny*nx, M] pass per z layer); cells below the mesh surface
    are solid with the landscape albedo."""
    nz, ny, nx = shape
    dev = cobjs.shape.device
    ar = lambda n: torch.arange(n, dtype=torch.float32, device=dev)
    xs = (ar(nx) - nx // 2 + 0.5) * world.dx
    ys = (ar(ny) - ny // 2 + 0.5) * world.dy
    X, Y = torch.meshgrid(xs, ys, indexing="xy")     # [ny, nx]
    px, py = X.reshape(-1), Y.reshape(-1)
    mh = None
    if mesh is not None:
        my, mx = mesh.shape
        gx = torch.clamp(X * world.dx_inv + mx // 2, 0, mx - 1.001)
        gy = torch.clamp(Y * world.dy_inv + my // 2, 0, my - 1.001)
        x0 = torch.floor(gx).to(torch.int64)
        y0 = torch.floor(gy).to(torch.int64)
        fx = gx - x0.to(torch.float32)
        fy = gy - y0.to(torch.float32)
        mh = ((mesh[y0, x0] * (1 - fx) + mesh[y0, x0 + 1] * fx) * (1 - fy)
              + (mesh[y0 + 1, x0] * (1 - fx) + mesh[y0 + 1, x0 + 1] * fx) * fy).reshape(-1)
    zero = torch.zeros_like(px)
    out = []
    for zi in range(nz):
        z = grid_z0 + (float(zi) + 0.5) * grid_dz
        pen = sphere_cobj_test(px, py, zero + z, zero, cobjs)[0]
        hit = pen > 0.0                              # [C, M]
        occ = hit.any(dim=1)
        deep = torch.argmax(torch.where(hit, pen, -torch.inf), dim=1)
        cols = [torch.where(occ, c[deep], 0.0)
                for c in (cobjs.color_r, cobjs.color_g, cobjs.color_b)]
        if mh is not None:
            below = z < mh
            cols = [torch.where(below & ~occ, lc, c) for c, lc in zip(cols, land_color)]
            occ = occ | below
        out.append(torch.stack([occ.to(torch.float32)] + cols).view(4, ny, nx))
    occ, ar_, ag, ab = torch.stack(out, 1)
    return occ, ar_, ag, ab


def _ishift(p: torch.Tensor, k: int, axis: int, fill: torch.Tensor) -> torch.Tensor:
    """Integer shift along `axis` of a [C, ny, nx] stack that FILLS the
    vacated edge (channel c with fill[c]) instead of wrapping — a periodic
    roll would carry a building's shadow (or its open-sky transmittance)
    across the scene to the opposite edge on oblique directions."""
    if k == 0:
        return p
    rolled = torch.roll(p, k, dims=axis)
    n = p.shape[axis]
    idx = torch.arange(n, device=p.device)
    mask = (idx < k) if k > 0 else (idx >= n + k)
    shape = [1, 1, 1]
    shape[axis] = n
    return torch.where(mask.view(shape), fill, rolled)


def _shift2(planes: torch.Tensor, sx: float, sy: float, fill: torch.Tensor):
    """Fractional 2-D shift (bilinear) of a [C, ny, nx] stack, matching
    ops/shadows' shear.  Cells shifted in from outside the volume take
    `fill` [C, 1, 1] (1 for transmittance — the sides see open sky; 0 for
    emission)."""
    def sh(p, s, axis):
        si = int(np.floor(s))
        f = s - si
        return _ishift(p, si, axis, fill) * (1.0 - f) + _ishift(p, si + 1, axis, fill) * f
    return sh(sh(planes, sx, 2), sy, 1)


def hemisphere_dirs(n: int):
    """Cosine-weighted fixed quadrature over the upper hemisphere
    (Fibonacci spiral in sqrt-cos space); returns unit dirs + weights
    summing to 1 (the tracer's cosine-weighted sky_rays density)."""
    k = np.arange(n) + 0.5
    phi = 2.0 * np.pi * k * 0.6180339887498949
    cos2 = 1.0 - k / n                 # cos^2(theta) uniform -> cosine pdf
    ct = np.sqrt(cos2)
    st = np.sqrt(1.0 - cos2)
    d = np.stack([st * np.cos(phi), st * np.sin(phi), ct], 1)
    w = np.full(n, 1.0 / n)
    return d.astype(np.float32), w.astype(np.float32)


def _sweep_dir(occ, emis, d, world, dz_cell: float):
    """One direction's transmittance (and, with `emis` [3, nz, ny, nx],
    emission-gather) scan.  Layers scan from the sky down (d points
    TOWARD the sky): the carry on the current layer's xy grid is sheared
    by the direction's horizontal run per layer and attenuated by the
    layer passed through (L_below = L_above * (1 - occ) + emis).  Returns
    (T, Lr, Lg, Lb), each [nz, ny, nx] (the L's None without `emis`)."""
    nz, ny, nx = occ.shape
    dzc = max(abs(float(d[2])), 1e-3)
    sx = -float(d[0]) / dzc * float(dz_cell) * float(world.dx_inv)
    sy = -float(d[1]) / dzc * float(dz_cell) * float(world.dy_inv)
    downward = float(d[2]) < 0.0       # source below: scan bottom-up
    c = 1 if emis is None else 4
    fill = torch.zeros((c, 1, 1), dtype=torch.float32, device=occ.device)
    fill[0] = 1.0                      # sides: open sky
    carry = torch.zeros((c, ny, nx), dtype=torch.float32, device=occ.device)
    carry[0] = 1.0
    order = range(nz) if downward else range(nz - 1, -1, -1)
    outs = [None] * nz
    for zi in order:
        carry = _shift2(carry, sx, sy, fill) * (1.0 - occ[zi])
        if emis is not None:
            carry = carry + torch.cat([torch.zeros_like(carry[:1]), emis[:, zi]])
        outs[zi] = carry
    out = torch.stack(outs, 1)
    return (out[0], None, None, None) if emis is None else tuple(out)


def voxelize_for_grid(grid: L.LightGrid, cobjs: CobjSet, mesh,
                      world: WorldConst = DEFAULT_WORLD):
    """Precompute the (occ, ar, ag, ab) voxelization once for a scene; pass
    it as `vox=` to BOTH sweep solvers."""
    return voxelize_scene(cobjs, mesh, grid.z0, grid.dz, grid.shape, world)


def _bounce_gather(occ, emis, dirs, w, world, dzf):
    """One diffuse bounce: surfaces radiate into the full sphere, so the
    emission gathers along each direction both up and down."""
    b = torch.zeros_like(emis)
    for k in range(len(w)):
        for sgn in (1.0, -1.0):
            d = dirs[k] * np.float32(sgn)
            if abs(float(d[2])) < 1e-3:
                continue
            _, lr, lg, lb = _sweep_dir(occ, emis, d, world, dzf)
            b = b + float(0.5 * w[k]) * torch.stack([lr, lg, lb])
    return b


def compute_sky_lighting_sweep(grid: L.LightGrid, cobjs: CobjSet, mesh,
                               ndirs: int = 32, sky_color=(0.7, 0.8, 1.0),
                               world: WorldConst = DEFAULT_WORLD,
                               bounce: bool = True, vox=None) -> L.LightGrid:
    """Dense replacement for `compute_sky_lighting` (direct + one diffuse
    bounce): fills the sky channels so `final_color` reads identically
    (sv = visibility weight, sc = mean arriving color).  `vox`: optional
    precomputed `voxelize_for_grid` result shared with the global sweep."""
    dzf = float(grid.dz)
    occ, ar, ag, ab = vox if vox is not None else voxelize_for_grid(grid, cobjs, mesh, world)
    dirs, w = hemisphere_dirs(ndirs)
    air = 1.0 - occ
    V = torch.zeros_like(occ)
    Varr = torch.zeros_like(occ)        # irradiance ARRIVING at a cell
    # (transmittance before the cell's own layer attenuates it) — what a
    # solid cell's surface receives and re-emits
    for k in range(ndirs):
        T = _sweep_dir(occ, None, dirs[k], world, dzf)[0]
        V = V + float(w[k]) * T
        Varr = Varr + float(w[k]) * torch.cat([T[1:], torch.ones_like(T[:1])], 0)
    s = [V * sky_color[0], V * sky_color[1], V * sky_color[2]]
    sv = V
    if bounce:
        emis = torch.stack([ar * Varr * sky_color[0], ag * Varr * sky_color[1],
                            ab * Varr * sky_color[2]])
        b = _bounce_gather(occ, emis, dirs, w, world, dzf)
        s = [s[c] + b[c] for c in range(3)]
        sv = sv + torch.maximum(torch.maximum(b[0], b[1]), b[2])
    # air cells only (the lmap stores lighting for open cells)
    return grid._replace(sc_r=grid.sc_r + air * s[0], sc_g=grid.sc_g + air * s[1],
                         sc_b=grid.sc_b + air * s[2], sv=grid.sv + air * sv)


def compute_global_lighting_sweep(grid: L.LightGrid, cobjs: CobjSet, mesh,
                                  sun_dir, sun_color=(1.0, 0.95, 0.85),
                                  world: WorldConst = DEFAULT_WORLD,
                                  bounce: bool = True, vox=None) -> L.LightGrid:
    """Dense replacement for `compute_global_lighting` (the sun/moon term,
    trace_ray_block_global): the directional transmittance is ONE exact
    sweep, plus the optional diffuse bounce gather (8 directions).  Fills
    the global channels (gv weight, gc mean color).  A sun within 0.02 of
    the horizon has no vertical path through the volume and adds
    nothing."""
    dzf = float(grid.dz)
    sd = np.asarray(sun_dir, np.float64)
    sd = (sd / np.linalg.norm(sd)).astype(np.float32)  # sun -> scene
    d = -sd                                           # cell -> sun
    if abs(float(d[2])) < 0.02:
        return grid
    occ, ar, ag, ab = vox if vox is not None else voxelize_for_grid(grid, cobjs, mesh, world)
    air = 1.0 - occ
    T = _sweep_dir(occ, None, d, world, dzf)[0]
    one = torch.ones_like(T[:1])
    Tarr = torch.cat([T[1:], one], 0) if d[2] >= 0 else torch.cat([one, T[:-1]], 0)
    gc = [T * sun_color[0], T * sun_color[1], T * sun_color[2]]
    gv = T
    if bounce:
        emis = torch.stack([ar * Tarr * sun_color[0], ag * Tarr * sun_color[1],
                            ab * Tarr * sun_color[2]])
        dirs, w = hemisphere_dirs(8)
        b = _bounce_gather(occ, emis, dirs, w, world, dzf)
        gc = [gc[c] + b[c] for c in range(3)]
        gv = gv + torch.maximum(torch.maximum(b[0], b[1]), b[2])
    return grid._replace(gc_r=grid.gc_r + air * gc[0], gc_g=grid.gc_g + air * gc[1],
                         gc_b=grid.gc_b + air * gc[2], gv=grid.gv + air * gv)

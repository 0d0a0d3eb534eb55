"""Terrain noise (port of the 2-D generators of `3dworld_tpu/ops/noise.py`).

The reference's default heightmap generator (MGEN_SINE, mesh_gen.cpp:219-254)
sums 9 frequency octaves x 10 random 2D sine products.  The evaluation is
separable (mesh_gen.cpp:604-626, :754): per-axis term tables X[nx,90],
Y[ny,90] and height(x,y) = sum_k X[x,k]*Y[y,k], i.e. one (nx,90)@(90,ny)
product per tile, batched over tiles as one einsum.

`tile_noise` is the plain version of the fused tile-noise kernel (kernel
E, `ops/cuda/noise_kernel.tile_noise`): the same heights computed by the
Pallas `_tile_noise_kernel`'s formula, tile by tile.

The fBm modes (simplex, perlin, domain warp; mesh_gen.cpp:706-760):
9 octaves, lacunarity 1.92, gain 0.5, per-octave offset drift x1.5,
shapes linear/billowy/ridged.  Gradients are picked by the JAX package's
own integer hash of the lattice point (the port's `xxhash_u32`, uint32
carried in int64), from a table of the 8 float32 (cos, sin) pairs that
its `jnp.cos`/`jnp.sin` give.  Every constant and operation order is the
JAX package's, so the values agree to float32 rounding.

The 3-D generators (noise_gen_3d, upsurface.cpp:16-72; voxels.cpp:355-365)
serve the universe's planet surfaces and asteroid models: the separable 3-D
sine table (`gen_sine_table_3d`, bitwise with the JAX package's), its grid
evaluation as one `(nz*ny, K) @ (K, nx)` product, and 3-D simplex noise and
its fBm, hashed like the 2-D ones.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..utils.rng import RandGen, xxhash_u32, _mul_u32, _U32
from ..utils.constants import WorldConst, DEFAULT_WORLD
from .fmath import sin32

# mesh_gen.cpp:14-34
NUM_FREQ_COMP = 9
N_RAND_SIN2 = 10
F_TABLE_SIZE = NUM_FREQ_COMP * N_RAND_SIN2
FREQ_FILTER = 2
MIN_FREQS = 3
MESH_SCALE_FACTOR = 0.0007
TWO_PI = 2.0 * np.pi

# Generator modes (3DWorld.h:1399)
MGEN_SINE = 0
MGEN_SIMPLEX = 1
MGEN_PERLIN = 2
MGEN_SIMPLEX_GPU = 3
MGEN_DWARP_GPU = 4

SHAPE_LINEAR = 0
SHAPE_BILLOWY = 1
SHAPE_RIDGED = 2


class SineTable(NamedTuple):
    """The 90-entry random sine table (mesh_gen.cpp sinTable[90][5])."""

    mag: torch.Tensor      # [F] magnitude
    phase_y: torch.Tensor  # [F] y phase
    phase_x: torch.Tensor  # [F] x phase
    freq_y: torch.Tensor   # [F] y frequency
    freq_x: torch.Tensor   # [F] x frequency


def gen_sine_table(
    world: WorldConst = DEFAULT_WORLD,
    mesh_seed: int = 0,
    scaled_height: float | None = None,
    rgen: RandGen | None = None,
    device: torch.device | str = "cuda",
) -> SineTable:
    """Generate the random sine table on the host (mesh_gen.cpp:219-254).

    The draw sequence matches `gen_rand_sine_table_entries` (5 draws per
    entry, octave-major) and every product rounds per multiply in float32,
    in the reference's op order, so a `mesh_seed` gives the same table as
    the JAX package bit for bit.
    """
    if scaled_height is None:
        scaled_height = world.mesh_height  # MESH_HEIGHT * mesh_height_scale(=1)
    if rgen is None:
        rgen = RandGen()
        if mesh_seed != 0:
            rgen.set_state(mesh_seed, 12345)  # apply_mesh_rand_seed (mesh_gen.cpp:213-216)

    F = np.float32
    xf_scale = F(world.mesh_y) / F(world.mesh_x)
    yf_scale = F(1.0) / xf_scale
    if world.x_scene > world.y_scene:
        yf_scale = F(yf_scale * (F(world.y_scene) / F(world.x_scene)))
    if world.y_scene > world.x_scene:
        xf_scale = F(xf_scale * (F(world.x_scene) / F(world.y_scene)))

    mags = np.empty(NUM_FREQ_COMP, np.float32)
    freqs = np.empty(NUM_FREQ_COMP, np.float32)
    mags[0] = F(0.02)            # MESH_START_MAG
    freqs[0] = F(240.0)          # MESH_START_FREQ
    for i in range(1, NUM_FREQ_COMP):
        freqs[i] = freqs[i - 1] * F(0.5)   # MESH_FREQ_MULT
        mags[i] = mags[i - 1] * F(2.0)     # MESH_MAG_MULT
    mesh_h = F(scaled_height / np.sqrt(0.1 * N_RAND_SIN2))
    two_pi_f = F(TWO_PI)

    def ru(lo, hi):              # rand_uniform (rand_gen.h:90), f32 lerp
        return F(lo) + F(hi - lo) * F(rgen.randd())

    out = np.zeros((F_TABLE_SIZE, 5), dtype=np.float32)
    for l in range(NUM_FREQ_COMP):
        x_freq = freqs[l] / F(world.mesh_x)
        y_freq = freqs[l] / F(world.mesh_y)
        mheight = mags[l] * mesh_h
        for i in range(N_RAND_SIN2):
            idx = l * N_RAND_SIN2 + i
            out[idx, 0] = ru(0.2, 1.0) * mheight
            out[idx, 1] = F(rgen.rand_float()) * two_pi_f
            out[idx, 2] = F(rgen.rand_float()) * two_pi_f
            out[idx, 3] = ru(0.1, 1.0) * x_freq * yf_scale
            out[idx, 4] = ru(0.1, 1.0) * y_freq * xf_scale
    return SineTable(*(torch.as_tensor(out[:, k].copy(), device=device)
                       for k in range(5)))


def start_eval_sin(mesh_scale: float, mesh_freq_filter: int = FREQ_FILTER) -> int:
    """compute_scale() (mesh_gen.cpp:543-546): drop high-freq octaves when
    zoomed out.  Returns the first sine term that is evaluated."""
    iscale = int(np.log2(mesh_scale)) if mesh_scale > 0 else 0
    return N_RAND_SIN2 * max(0, min(NUM_FREQ_COMP - MIN_FREQS, iscale + mesh_freq_filter))


def sine_term_tables(
    table: SineTable,
    x0: torch.Tensor,
    y0: torch.Tensor,
    dx: float,
    dy: float,
    nx: int,
    ny: int,
    world: WorldConst = DEFAULT_WORLD,
    mesh_scale: float = 1.0,
    mesh_scale_z_inv: float = 1.0,
    start_sin: int = 0,
    exact: bool = False,
):
    """Per-axis sine term tables (mesh_xy_grid_cache_t::build_arrays,
    mesh_gen.cpp:604-626).

    Returns (xterms[..., nx, F], yterms[..., ny, F]); `x0`, `y0` may carry
    leading batch dims, so one call builds the tables for a tile batch.
    With `exact` the sines go through `fmath.sin32`, which rounds the same
    on every device.
    """
    dev = table.mag.device
    msx = mesh_scale * world.dx_inv
    msy = mesh_scale * world.dy_inv
    ms2 = 0.5 * mesh_scale
    x0 = torch.as_tensor(x0, dtype=torch.float32, device=dev)[..., None]
    y0 = torch.as_tensor(y0, dtype=torch.float32, device=dev)[..., None]
    mx0 = dx * x0
    my0 = dy * y0

    x_mult = msx * table.freq_x  # [F]
    y_mult = msy * table.freq_y
    y_scale = mesh_scale_z_inv * table.mag
    x_const = ms2 * table.freq_x + table.phase_x + x_mult * mx0  # [..., F]
    y_const = ms2 * table.freq_y + table.phase_y + y_mult * my0

    xi = torch.arange(nx, dtype=torch.float32, device=dev)[:, None]  # [nx, 1]
    yi = torch.arange(ny, dtype=torch.float32, device=dev)[:, None]
    sin = sin32 if exact else torch.sin
    xterms = sin(x_mult * dx * xi + x_const[..., None, :])            # [..., nx, F]
    yterms = y_scale * sin(y_mult * dy * yi + y_const[..., None, :])
    if start_sin > 0:
        mask = (torch.arange(F_TABLE_SIZE, device=dev) >= start_sin).to(xterms.dtype)
        xterms = xterms * mask
    return xterms, yterms


def eval_sine_grid(xterms: torch.Tensor, yterms: torch.Tensor,
                   exact: bool = False) -> torch.Tensor:
    """height[..., y, x] = sum_k X[x,k] * Y[y,k] — one float32 matrix
    product per tile (the hot loop of mesh_gen.cpp:754-770).  Callers keep
    TF32 off, so the product runs in full float32.

    With `exact` the products (exact in float64) are summed in float64 in
    term order and rounded once: the card and the CPU then give the same
    bits, where their matrix products sum in other orders."""
    if not exact:
        return torch.einsum("...xk,...yk->...yx", xterms, yterms)
    x, y = xterms.double(), yterms.double()
    z = y[..., :, None, 0] * x[..., None, :, 0]
    for k in range(1, x.shape[-1]):
        z = z + y[..., :, None, k] * x[..., None, :, k]
    return z.float()


def tile_noise(table: SineTable, x0: torch.Tensor, y0: torch.Tensor, n: int,
               dx: float, dy: float, mesh_scale: float = 1.0,
               mesh_scale_z_inv: float = 1.0, start_sin: int = 0) -> torch.Tensor:
    """[T] tile origins (grid units) -> [T, n, n] raw sine-mode heights.

    Transcribes the Pallas `_tile_noise_kernel`
    (`3dworld_tpu/ops/pallas/noise_kernel.py:28-53`): per tile the term
    tables X[n, K] (terms below `start_sin` zeroed) and Y[n, K] (scaled by
    mesh_scale_z_inv * mag), then height[y, x] = sum_k Y[y, k] X[x, k].
    Scalars round to float32 where the kernel's static arguments do."""
    msx = mesh_scale / dx
    msy = mesh_scale / dy
    ms2 = 0.5 * mesh_scale
    dev = table.mag.device
    x0 = torch.as_tensor(x0, dtype=torch.float32, device=dev)[:, None]   # [T, 1]
    y0 = torch.as_tensor(y0, dtype=torch.float32, device=dev)[:, None]
    mask = (torch.arange(F_TABLE_SIZE, device=dev) >= start_sin).to(torch.float32)
    x_mult = msx * table.freq_x                                          # [K]
    y_mult = msy * table.freq_y
    x_const = ms2 * table.freq_x + table.phase_x + x_mult * (dx * x0)    # [T, K]
    y_const = ms2 * table.freq_y + table.phase_y + y_mult * (dy * y0)
    xi = torch.arange(n, dtype=torch.float32, device=dev)[:, None]       # [n, 1]
    xt = torch.sin(x_mult * dx * xi + x_const[:, None, :]) * mask         # [T, n, K]
    yt = (mesh_scale_z_inv * table.mag) * torch.sin(y_mult * dy * xi + y_const[:, None, :])
    return torch.einsum("tyk,txk->tyx", yt, xt)


def apply_noise_shape_final(z: torch.Tensor, shape: int) -> torch.Tensor:
    """Shapes for sine mode (mesh_gen.cpp:564-571)."""
    if shape == SHAPE_BILLOWY:
        return torch.abs(z) - 2.0
    if shape == SHAPE_RIDGED:
        return 3.5 - torch.abs(z)
    return z


# ---------------------------------------------------------------------------
# fBm generators (simplex / perlin / domain warp)
# ---------------------------------------------------------------------------

_F2 = float(0.5 * (np.sqrt(3.0) - 1.0))
_G2 = float((3.0 - np.sqrt(3.0)) / 6.0)

# gradient k of 8: angle k * (2 pi / 8) in float32, its cosine and sine
# rounded to float32 (the values jnp.cos and jnp.sin give for those angles)
_GRAD_ANGLES = np.arange(8, dtype=np.float32) * np.float32(TWO_PI / 8.0)
_GRAD_CS = np.stack([np.cos(_GRAD_ANGLES.astype(np.float64)),
                     np.sin(_GRAD_ANGLES.astype(np.float64))]).astype(np.float32)
_GRAD_TABLES: dict = {}


def _grad_table(device) -> torch.Tensor:
    """[2, 8] (cos, sin) table on `device`, made once per device."""
    key = str(device)
    if key not in _GRAD_TABLES:
        _GRAD_TABLES[key] = torch.as_tensor(_GRAD_CS, device=device)
    return _GRAD_TABLES[key]


def _grad_hash(ix: torch.Tensor, iy: torch.Tensor, seed: int) -> torch.Tensor:
    """Hash integer lattice point -> uint32 in int64 (xxHash chain,
    rand_gen.h:127); negative indices wrap as an int32 -> uint32 cast."""
    ux = ix.to(torch.int64) & _U32
    uy = iy.to(torch.int64) & _U32
    return xxhash_u32(ux ^ _mul_u32(uy, 2654435761), seed)


def _grad_dot(h: torch.Tensor, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Dot with one of 8 unit gradients selected by hash bits."""
    cs = _grad_table(x.device)
    k = h & 7
    return cs[0][k] * x + cs[1][k] * y


def simplex2d(x: torch.Tensor, y: torch.Tensor, seed: int = 0) -> torch.Tensor:
    """2D simplex noise in approx [-1, 1] (Gustavson's construction)."""
    s = (x + y) * _F2
    i = torch.floor(x + s)
    j = torch.floor(y + s)
    t = (i + j) * _G2
    x0 = x - (i - t)
    y0 = y - (j - t)
    gt = x0 > y0
    i1 = torch.where(gt, 1.0, 0.0)
    j1 = torch.where(gt, 0.0, 1.0)
    x1 = x0 - i1 + _G2
    y1 = y0 - j1 + _G2
    x2 = x0 - 1.0 + 2.0 * _G2
    y2 = y0 - 1.0 + 2.0 * _G2
    ii = i.to(torch.int64)
    jj = j.to(torch.int64)

    def corner(cx, cy, ci, cj):
        t_ = 0.5 - cx * cx - cy * cy
        t_ = torch.clamp(t_, min=0.0)
        t2 = t_ * t_
        g = _grad_dot(_grad_hash(ci, cj, seed), cx, cy)
        return t2 * t2 * g

    n = (
        corner(x0, y0, ii, jj)
        + corner(x1, y1, ii + gt.to(torch.int64), jj + (~gt).to(torch.int64))
        + corner(x2, y2, ii + 1, jj + 1)
    )
    return 70.0 * n


def _fade(t: torch.Tensor) -> torch.Tensor:
    return t * t * t * (t * (t * 6.0 - 15.0) + 10.0)


def perlin2d(x: torch.Tensor, y: torch.Tensor, seed: int = 0) -> torch.Tensor:
    """Classic 2D Perlin noise in approx [-1, 1]."""
    xi = torch.floor(x)
    yi = torch.floor(y)
    xf = x - xi
    yf = y - yi
    ii = xi.to(torch.int64)
    jj = yi.to(torch.int64)
    u = _fade(xf)
    v = _fade(yf)

    def g(di, dj, dx_, dy_):
        return _grad_dot(_grad_hash(ii + di, jj + dj, seed), dx_, dy_)

    n00 = g(0, 0, xf, yf)
    n10 = g(1, 0, xf - 1.0, yf)
    n01 = g(0, 1, xf, yf - 1.0)
    n11 = g(1, 1, xf - 1.0, yf - 1.0)
    nx0 = n00 + u * (n10 - n00)
    nx1 = n01 + u * (n11 - n01)
    return (nx0 + v * (nx1 - nx0)) * 1.4142135


def fbm2d(x: torch.Tensor, y: torch.Tensor, rx: float, ry: float,
          mode: int = MGEN_SIMPLEX, shape: int = SHAPE_LINEAR,
          octaves: int = NUM_FREQ_COMP, seed: int = 0) -> torch.Tensor:
    """fBm over simplex/perlin (gen_noise, mesh_gen.cpp:706-728):
    lacunarity 1.92, gain 0.5, per-octave offset drift x1.5.  The octave
    constants are Python floats, rounded to float32 where they meet a
    tensor, as in the JAX package."""
    lacunarity, gain = 1.92, 0.5
    zval = torch.zeros_like(x)
    mag, freq = 1.0, 1.0
    crx, cry = rx, ry
    use_simplex = mode in (MGEN_SIMPLEX, MGEN_SIMPLEX_GPU, MGEN_DWARP_GPU)
    for _ in range(octaves):
        px = freq * x + crx
        py = freq * y + cry
        n = simplex2d(px, py, seed) if use_simplex else perlin2d(px, py, seed)
        if shape == SHAPE_BILLOWY:
            n = torch.abs(n) - 0.40
        elif shape == SHAPE_RIDGED:
            n = 0.45 - torch.abs(n)
        zval = zval + mag * n
        mag *= gain
        freq *= lacunarity
        crx *= 1.5
        cry *= 1.5
    return zval


def domain_warp2d(x: torch.Tensor, y: torch.Tensor, rx: float, ry: float,
                  shape: int = SHAPE_LINEAR, octaves: int = NUM_FREQ_COMP,
                  seed: int = 0):
    """2-level domain warp (get_noise_zval, mesh_gen.cpp:736-747): scale
    0.2, fixed offsets (5.2,1.3), (1.7,9.2), (8.3,2.8)."""
    scale = 0.2
    kw = dict(mode=MGEN_SIMPLEX, shape=shape, octaves=octaves, seed=seed)
    dx1 = fbm2d(x, y, rx, ry, **kw)
    dy1 = fbm2d(x + 5.2, y + 1.3, rx, ry, **kw)
    dx2 = fbm2d(x + scale * dx1 + 1.7, y + scale * dy1 + 9.2, rx, ry, **kw)
    dy2 = fbm2d(x + scale * dx1 + 8.3, y + scale * dy1 + 2.8, rx, ry, **kw)
    return x + scale * dx2, y + scale * dy2


def gen_rx_ry(mesh_seed: int = 0, mesh_rgen_index: int = 0,
              mode: int = MGEN_SIMPLEX):
    """Random fBm offsets in [1, 2) (gen_rx_ry, mesh_gen.cpp:581-587)."""
    rgen = RandGen()
    if mesh_seed != 0:
        rgen.set_state(mesh_seed, 12345)
    elif mode != MGEN_SINE:
        rgen.set_state(mesh_rgen_index + 1, 12345)
    return rgen.rand_float() + 1.0, rgen.rand_float() + 1.0


def get_hmap_scale(mode: int, mesh_height: float, mesh_height_scale: float = 1.0,
                   mesh_scale_z_inv: float = 1.0) -> float:
    """mesh_gen.cpp:550-553: simplex 16x vs perlin 32x height scale."""
    scale = 16.0 if mode in (MGEN_SIMPLEX, MGEN_SIMPLEX_GPU, MGEN_DWARP_GPU) else 32.0
    return scale * mesh_height * mesh_height_scale * mesh_scale_z_inv


def noise_zval_grid(xval: torch.Tensor, yval: torch.Tensor, mode: int,
                    shape: int = SHAPE_LINEAR, mesh_scale: float = 1.0,
                    mesh_seed: int = 0, mesh_rgen_index: int = 0,
                    world: WorldConst = DEFAULT_WORLD,
                    octaves: int | None = None, seed: int = 0,
                    postproc=None) -> torch.Tensor:
    """get_noise_zval (mesh_gen.cpp:733-751) on a whole grid of mesh coords.

    `xval`/`yval` are in mesh-index units (world-x / DX_VAL); any shape.
    `postproc`, if given, is applied to the raw fBm value *before* the
    height scale (matching mesh_gen.cpp:749-750).
    """
    if octaves is None:
        octaves = NUM_FREQ_COMP - start_eval_sin(mesh_scale) // N_RAND_SIN2
    xy_scale = MESH_SCALE_FACTOR * mesh_scale
    xv = xy_scale * xval
    yv = xy_scale * yval
    rx, ry = gen_rx_ry(mesh_seed, mesh_rgen_index, mode)
    if mode == MGEN_DWARP_GPU:
        xv, yv = domain_warp2d(xv, yv, rx, ry, shape=shape, octaves=octaves, seed=seed)
    z = fbm2d(xv, yv, rx, ry, mode=mode, shape=shape, octaves=octaves, seed=seed)
    if postproc is not None:
        z = postproc(z)
    return z * get_hmap_scale(mode, world.mesh_height)


# ---------------------------------------------------------------------------
# 3-D separable sine noise and 3-D simplex / fBm
# ---------------------------------------------------------------------------

# noise_gen_3d (upsurface.cpp:16-72)
SINES_PER_FREQ = 12
MAX_FREQ_BINS = 5
TOT_NUM_SINES = SINES_PER_FREQ * MAX_FREQ_BINS
M_ATTEN_FACTOR = 0.5
F_ATTEN_FACTOR = 0.4


class SineTable3D(NamedTuple):
    """The 60-entry 3-D sine table: magnitude, then per axis frequency and
    phase, each [K]."""

    mag: torch.Tensor
    fx: torch.Tensor
    px: torch.Tensor
    fy: torch.Tensor
    py: torch.Tensor
    fz: torch.Tensor
    pz: torch.Tensor


def gen_sine_table_3d(mag: float = 1.0, freq: float = 1.0, rseed1: int = 1,
                      rseed2: int = 1, device: torch.device | str = "cuda") -> SineTable3D:
    """noise_gen_3d::gen_sines (upsurface.cpp:16-38) on the host: 5
    frequency bins x 12 sines; per bin mag *= 0.5, freq /= 0.4.  float32
    arithmetic in the reference's op order (rand_uniform's f32 lerp, f32
    mag/freq iteration, phases as double randd * f32 TWO_PI narrowed on
    store), so a seed pair gives the JAX package's table bit for bit."""
    rg = RandGen(rseed1, rseed2)
    out = np.zeros((TOT_NUM_SINES, 7), np.float32)
    F = np.float32
    two_pi_f = F(TWO_PI)

    def ru(lo, hi):
        return F(lo) + F(hi - lo) * F(rg.randd())

    m, f = F(mag), F(freq)
    for i in range(MAX_FREQ_BINS):
        for j in range(SINES_PER_FREQ):
            k = SINES_PER_FREQ * i + j
            out[k, 0] = ru(0.2, 1.0) * m
            out[k, 1] = ru(0.1, 1.0) * f
            out[k, 2] = F(rg.randd() * np.float64(two_pi_f))
            out[k, 3] = ru(0.1, 1.0) * f
            out[k, 4] = F(rg.randd() * np.float64(two_pi_f))
            out[k, 5] = ru(0.1, 1.0) * f
            out[k, 6] = F(rg.randd() * np.float64(two_pi_f))
        m = m * F(M_ATTEN_FACTOR)
        f = f / F(F_ATTEN_FACTOR)
    return SineTable3D(*(torch.as_tensor(out[:, i].copy(), device=device)
                         for i in range(7)))


def eval_sine3d_grid(table: SineTable3D, start, step, nx: int, ny: int, nz: int,
                     num_sines: int | None = None) -> torch.Tensor:
    """Separable 3-D sine sum on a regular grid -> [nz, ny, nx]
    (gen_xyz_vals + get_val, upsurface.cpp:41-72): per-axis term tables,
    val = sum_k mag_k * sin_x * sin_y * sin_z, the (z, y) pair table
    contracted against the x table as one (nz*ny, K) @ (K, nx) product (a
    plain float32 matmul: set TF32 off on the card)."""
    sx, sy, sz = start
    dx, dy, dz = step
    dev = table.mag.device
    ar = lambda n: torch.arange(n, dtype=torch.float32, device=dev)
    xi, yi, zi = sx + dx * ar(nx), sy + dy * ar(ny), sz + dz * ar(nz)
    mag = table.mag
    if num_sines is not None and num_sines < TOT_NUM_SINES:
        mag = mag * (torch.arange(TOT_NUM_SINES, device=dev) < num_sines).to(torch.float32)
    xv = torch.sin(table.fx[None, :] * xi[:, None] + table.px[None, :]) * mag[None, :]
    yv = torch.sin(table.fy[None, :] * yi[:, None] + table.py[None, :])      # [ny, K]
    zv = torch.sin(table.fz[None, :] * zi[:, None] + table.pz[None, :])      # [nz, K]
    zy = (zv[:, None, :] * yv[None, :, :]).reshape(nz * ny, -1)             # [nz*ny, K]
    return (zy @ xv.T).reshape(nz, ny, nx)


_F3 = 1.0 / 3.0
_G3 = 1.0 / 6.0


def _grad_hash3(ix: torch.Tensor, iy: torch.Tensor, iz: torch.Tensor,
                seed: int) -> torch.Tensor:
    """Hash an integer lattice point -> uint32 in int64: the x, y and z
    indices wrap as int32 -> uint32 casts, y and z multiplied by odd
    constants mod 2^32, xor-ed, then the xxHash chain."""
    ux = ix.to(torch.int64) & _U32
    uy = iy.to(torch.int64) & _U32
    uz = iz.to(torch.int64) & _U32
    return xxhash_u32(ux ^ _mul_u32(uy, 2654435761) ^ _mul_u32(uz, 0x9E3779B1), seed)


def _grad_dot3(h: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
               z: torch.Tensor) -> torch.Tensor:
    """Dot with one of 12 edge-vector gradients selected by hash bits."""
    hb = h & 15
    u = torch.where(hb < 8, x, y)
    v = torch.where(hb < 4, y, torch.where((hb == 12) | (hb == 14), x, z))
    return torch.where((hb & 1) == 0, u, -u) + torch.where((hb & 2) == 0, v, -v)


def simplex3d(x: torch.Tensor, y: torch.Tensor, z: torch.Tensor,
              seed: int = 0) -> torch.Tensor:
    """3-D simplex noise in approx [-1, 1] (Gustavson's construction; the
    reference evaluates glm::simplex / gen_voxel_weights.comp)."""
    s = (x + y + z) * _F3
    i = torch.floor(x + s)
    j = torch.floor(y + s)
    k = torch.floor(z + s)
    t = (i + j + k) * _G3
    x0 = x - (i - t)
    y0 = y - (j - t)
    z0 = z - (k - t)
    # the simplex's traversal order from the component ranking (the
    # branch-free form of the 6-case decision tree)
    c1 = x0 >= y0
    c2 = y0 >= z0
    c3 = x0 >= z0
    f = lambda b: b.to(torch.float32)
    i1 = f(c1 & (c2 | c3))
    j1 = f(~c1 & c2)
    k1 = 1.0 - i1 - j1
    i2 = f(c1 | (c2 & c3))
    j2 = f(~c1 | c2)
    k2 = f(~c2 | (~c1 & ~c3))
    x1 = x0 - i1 + _G3
    y1 = y0 - j1 + _G3
    z1 = z0 - k1 + _G3
    x2 = x0 - i2 + 2.0 * _G3
    y2 = y0 - j2 + 2.0 * _G3
    z2 = z0 - k2 + 2.0 * _G3
    x3 = x0 - 1.0 + 3.0 * _G3
    y3 = y0 - 1.0 + 3.0 * _G3
    z3 = z0 - 1.0 + 3.0 * _G3
    ii = i.to(torch.int64)
    jj = j.to(torch.int64)
    kk = k.to(torch.int64)
    n_ = lambda v: v.to(torch.int64)

    def corner(cx, cy, cz, di, dj, dk):
        t_ = torch.clamp(0.6 - cx * cx - cy * cy - cz * cz, min=0.0)
        t2 = t_ * t_
        g = _grad_dot3(_grad_hash3(ii + di, jj + dj, kk + dk, seed), cx, cy, cz)
        return t2 * t2 * g

    n = (corner(x0, y0, z0, 0, 0, 0)
         + corner(x1, y1, z1, n_(i1), n_(j1), n_(k1))
         + corner(x2, y2, z2, n_(i2), n_(j2), n_(k2))
         + corner(x3, y3, z3, 1, 1, 1))
    return 32.0 * n


def fbm3d(x: torch.Tensor, y: torch.Tensor, z: torch.Tensor, rx: float, ry: float,
          octaves: int = 5, mag: float = 1.0, freq: float = 1.0,
          seed: int = 0) -> torch.Tensor:
    """3-D fBm over simplex noise (voxels.cpp:355-365 /
    gen_voxel_weights.comp): lacunarity 1.92, gain 0.5, fixed offset
    (rx, ry, rx - ry).  (The JAX function's `mode` argument selects
    nothing, so the port has none.)"""
    lacunarity, gain = 1.92, 0.5
    val = torch.zeros_like(x)
    m, f = mag, 0.25 * freq
    for _ in range(octaves):
        val = val + m * simplex3d(f * x + rx, f * y + ry, f * z + (rx - ry), seed)
        m *= gain
        f *= lacunarity
    return val

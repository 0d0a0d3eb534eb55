"""Sine-table terrain noise (port of the sine-mode half of
`3dworld_tpu/ops/noise.py`).

The reference's default heightmap generator (MGEN_SINE, mesh_gen.cpp:219-254)
sums 9 frequency octaves x 10 random 2D sine products.  The evaluation is
separable (mesh_gen.cpp:604-626, :754): per-axis term tables X[nx,90],
Y[ny,90] and height(x,y) = sum_k X[x,k]*Y[y,k], i.e. one (nx,90)@(90,ny)
product per tile, batched over tiles as one einsum.

`tile_noise` is the plain version of the fused tile-noise kernel (kernel
E, `ops/cuda/noise_kernel.tile_noise`): the same heights computed by the
Pallas `_tile_noise_kernel`'s formula, tile by tile.

The fBm simplex/perlin modes are not ported yet.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..utils.rng import RandGen
from ..utils.constants import WorldConst, DEFAULT_WORLD

# mesh_gen.cpp:14-34
NUM_FREQ_COMP = 9
N_RAND_SIN2 = 10
F_TABLE_SIZE = NUM_FREQ_COMP * N_RAND_SIN2
FREQ_FILTER = 2
MIN_FREQS = 3
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
):
    """Per-axis sine term tables (mesh_xy_grid_cache_t::build_arrays,
    mesh_gen.cpp:604-626).

    Returns (xterms[..., nx, F], yterms[..., ny, F]); `x0`, `y0` may carry
    leading batch dims, so one call builds the tables for a tile batch.
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
    xterms = torch.sin(x_mult * dx * xi + x_const[..., None, :])      # [..., nx, F]
    yterms = y_scale * torch.sin(y_mult * dy * yi + y_const[..., None, :])
    if start_sin > 0:
        mask = (torch.arange(F_TABLE_SIZE, device=dev) >= start_sin).to(xterms.dtype)
        xterms = xterms * mask
    return xterms, yterms


def eval_sine_grid(xterms: torch.Tensor, yterms: torch.Tensor) -> torch.Tensor:
    """height[..., y, x] = sum_k X[x,k] * Y[y,k] — one float32 matrix
    product per tile (the hot loop of mesh_gen.cpp:754-770).  Callers keep
    TF32 off, so the product runs in full float32."""
    return torch.einsum("...xk,...yk->...yx", xterms, yterms)


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

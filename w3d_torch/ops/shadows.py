"""Directional mesh shadows: sheared running-max scan (port of
`3dworld_tpu/ops/shadows.py`).

The reference casts Bresenham scanlines from the light's upstream edge
(`mesh_shadow_gen`, visibility.cpp:400-505), tracking the current highest
blocker; tiles chain via per-edge `sh_in`/`sh_out` height vectors
(tiled_mesh.cpp:664-692).

Closed form for a directional light: a point i along a light ray is
shadowed iff max over upstream k of (z_k - m*dist(k, i)) > z_i, with m the
light's descent per unit horizontal travel.  With the "shadow potential"
p = z + m*u (u = distance along the light's horizontal direction), the
test is runmax_upstream(p) > p + eps, a prefix maximum along the light.

The JAX package scans the columns with `lax.scan`; here the scan is a
Python loop over the dominant axis's columns (`stride` of them), each
column running the same op sequence as the JAX step (compare, max, the
two rolls and the interpolation), since the mask is a compare.  Between
columns the running-max row shifts laterally by the slope in [-1, 1]
(linear interpolation = the Bresenham shear).  The final carry is the
reference's `sh_out` edge vector, so tiles chain as they do there.
"""

from __future__ import annotations

import numpy as np
import torch

MESH_MIN_Z = -1.0e30


def _fractional_roll(row: torch.Tensor, shift: float) -> torch.Tensor:
    """Shift a row by a fractional number of cells (linear interp,
    wrapping as `jnp.roll` does)."""
    if shift == 0.0:
        return row
    s = int(np.floor(shift))
    f = shift - s
    a = torch.roll(row, s, dims=-1)
    b = torch.roll(row, s + 1, dims=-1)
    return a * (1.0 - f) + b * f


def _light_frame(light_dir: tuple, cell_w: float):
    """(m, x_major, flip, slope) of a light that is not straight down."""
    lx, ly, lz = light_dir
    hmag = float(np.hypot(lx, ly))
    m = lz / hmag * cell_w        # light descent per cell of horizontal travel
    x_major = abs(lx) >= abs(ly)
    major = lx if x_major else ly
    lat = ly if x_major else lx
    # the ray travels away from the light: lateral drift is -lat/|major|
    # cells per scan step regardless of the scan flip
    return m, x_major, major > 0, -lat / abs(major)


def mesh_shadows(zvals: torch.Tensor, light_dir: tuple,
                 sh_in: torch.Tensor | None = None, cell_w: float = 1.0):
    """Shadow mask for a directional light.

    zvals [..., ny, nx]; light_dir (lx, ly, lz) pointing TOWARD the light
    (lz > 0 above horizon).  Returns (shadowed [..., ny, nx] bool,
    sh_out [..., edge] running-max potentials for chaining downstream
    tiles; feed as `sh_in` of the next tile along the light direction).
    Scans along the dominant horizontal axis of the light; `cell_w` is the
    world size of one cell.
    """
    lx, ly, _lz = light_dir
    if float(np.hypot(lx, ly)) < 1e-9:  # straight down (visibility.cpp:516)
        return (torch.zeros(zvals.shape, dtype=torch.bool, device=zvals.device),
                torch.full(zvals.shape[:-1], MESH_MIN_Z, device=zvals.device))
    m, x_major, flip, slope = _light_frame(light_dir, cell_w)
    # work array with scan axis last and scan direction increasing
    z = zvals if x_major else zvals.transpose(-1, -2)
    if flip:   # light from +axis => scan from +edge downward
        z = torch.flip(z, (-1,))
    n = z.shape[-1]
    steps = torch.arange(n, dtype=z.dtype, device=z.device)
    p = z + m * steps                 # potential p[..., j, i] = z + m * i
    carry = (torch.full(z.shape[:-1], MESH_MIN_Z, dtype=z.dtype, device=z.device)
             if sh_in is None else sh_in)
    cols = []
    for i in range(n):
        col = p[..., i]
        cols.append(carry > col + 1e-6)
        carry = _fractional_roll(torch.maximum(carry, col), slope)
    # the outgoing carry in the NEXT tile's local frame (its scan index
    # restarts at 0, n cells further downstream): p' = p - m*n
    sh_out = carry - m * n
    shadowed = torch.stack(cols, -1)             # [..., lat, n]
    if flip:
        shadowed = torch.flip(shadowed, (-1,))
    if not x_major:
        shadowed = shadowed.transpose(-1, -2)
    return shadowed, sh_out


def carry_transform(carry: torch.Tensor, total_cols: int, light_dir: tuple,
                    cell_w: float = 1.0) -> torch.Tensor:
    """What a block of `total_cols` scan columns does to a PURE incoming
    carry (no local maxima): `total_cols` per-step fractional lateral
    rolls, then the downstream-frame potential shift -m*total_cols —
    mesh_shadows' carry path with z = -inf."""
    lx, ly, _lz = light_dir
    if float(np.hypot(lx, ly)) < 1e-9:
        return carry
    m, _x_major, _flip, slope = _light_frame(light_dir, cell_w)
    if slope == 0.0:
        return carry - m * total_cols
    for _ in range(total_cols):
        carry = _fractional_roll(carry, slope)
    return carry - m * total_cols

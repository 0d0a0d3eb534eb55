"""Voxel density grids: procedural generation and boundary post-processing
(port of `3dworld_tpu/voxel/grid.py`).

Re-expresses `voxel_manager` generation (voxels.cpp:278-470, voxels.h:14-37):
the density field is one [nz, ny, nx] tensor from a separable 3-D sine
contraction (one matmul) or 3-D simplex fBm, then edge attenuation and a
z gradient, then flood fills that classify the air reachable from the
boundary and remove solid blobs not anchored to the bottom.

The JAX package's flood fills are `lax.while_loop`s that test for a change
after every dilation step.  On the card that test is a host read, so here
the fill runs `CHECK_EVERY` steps between reads: a step after the fixpoint
changes nothing, so the result is the same fixpoint.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from ..ops import noise as N
from ..ops.fmath import div32, sqrt32
from ..utils.constants import WorldConst, DEFAULT_WORLD

# atten_at_edges modes (voxels.h:23)
ATTEN_NONE = 0
ATTEN_TOP = 1
ATTEN_EDGES = 2       # all 5 edges excluding bottom
ATTEN_SPHERE_OUTER = 3
ATTEN_SPHERE_INNER_OUTER = 4

CHECK_EVERY = 8       # flood-fill steps between convergence reads


class VoxelParams(NamedTuple):
    """Generation parameters (voxel_params_t, voxels.h:14-37). Hashable."""

    xsize: int = 64
    ysize: int = 64
    zsize: int = 32
    num_blocks: int = 12
    isolevel: float = 0.0
    elasticity: float = 0.5
    mag: float = 1.0
    freq: float = 1.0
    atten_thresh: float = 1.0
    z_gradient: float = 0.0
    radius_val: float = 0.5
    invert: bool = False
    normalize_to_1: bool = True
    make_closed_surface: bool = True
    remove_unconnected: int = 1
    atten_at_edges: int = 0
    atten_top_mode: int = 0
    geom_rseed: int = 123
    gen_mode: int = N.MGEN_SINE
    mesh_freq_filter: int = 2


class VoxelGrid(NamedTuple):
    """Density field + geometry mapping (voxel_grid, voxels.h:106-153)."""

    values: torch.Tensor   # [nz, ny, nx] density
    lo_pos: tuple          # world position of voxel (0,0,0)
    vsz: tuple             # voxel cell size (x, y, z)

    @property
    def shape(self):
        return self.values.shape


def default_grid_geometry(params: VoxelParams, world: WorldConst = DEFAULT_WORLD):
    """Scene-box voxel geometry (gen_voxels_from_params / voxel init)."""
    nx, ny, nz = params.xsize, params.ysize, params.zsize
    vsz = (2.0 * world.x_scene / nx, 2.0 * world.y_scene / ny,
           2.0 * world.z_scene / nz)
    lo = (-world.x_scene, -world.y_scene, -world.z_scene * 0.5)
    return lo, vsz


def _ar(n: int, device) -> torch.Tensor:
    return torch.arange(n, dtype=torch.float32, device=device)


def create_procedural(params: VoxelParams, lo_pos, vsz, offset=(0.0, 0.0, 0.0),
                      device: torch.device | str = "cuda") -> torch.Tensor:
    """voxel_manager::create_procedural (voxels.cpp:278-346) -> [nz,ny,nx].

    MGEN_SINE: separable 60-term sine contraction (one matmul; set TF32
    off on the card).  Other modes: 3-D simplex fBm, octaves =
    MAX_FREQ_BINS - mesh_freq_filter, freq scaled by 0.25
    (voxels.cpp:355-365)."""
    nx, ny, nz = params.xsize, params.ysize, params.zsize
    if params.gen_mode == N.MGEN_SINE:
        table = N.gen_sine_table_3d(params.mag, params.freq, params.geom_rseed,
                                    12345, device=device)
        start = tuple(float(np.float32(lo_pos[d]) + np.float32(offset[d]))
                      for d in range(3))
        val = N.eval_sine3d_grid(table, start, vsz, nx, ny, nz)
    else:
        rx, ry = N.gen_rx_ry(params.geom_rseed, 0, params.gen_mode)
        o = [float(np.float32(lo_pos[d]) + np.float32(offset[d])) for d in range(3)]
        xi = o[0] + vsz[0] * _ar(nx, device)
        yi = o[1] + vsz[1] * _ar(ny, device)
        zi = o[2] + vsz[2] * _ar(nz, device)
        octaves = max(1, N.MAX_FREQ_BINS - params.mesh_freq_filter)
        val = N.fbm3d(xi[None, None, :].expand(nz, ny, nx),
                      yi[None, :, None].expand(nz, ny, nx),
                      zi[:, None, None].expand(nz, ny, nx),
                      rx, ry, octaves=octaves, mag=params.mag, freq=params.freq)
    # z gradient (voxels.cpp:284,340)
    zscale = (-1.0 if params.invert else 1.0) * params.z_gradient / max(nz - 1, 1)
    val = val + zscale * _ar(nz, val.device)[:, None, None]
    if params.normalize_to_1:
        val = torch.clamp(val, -1.0, 1.0)
    return val


def atten_edges(val: torch.Tensor, params: VoxelParams) -> torch.Tensor:
    """Edge attenuation (voxels.cpp:405-470): push density toward "air" at
    grid boundaries so the isosurface closes."""
    nz, ny, nx = val.shape
    a = params.atten_thresh
    dev = val.device
    if params.atten_at_edges == ATTEN_NONE:
        return val
    if params.atten_at_edges == ATTEN_TOP:
        # atten_at_top_only: attenuate in the top ATTEN_THRESH fraction
        vz = div32(_ar(nz, dev)[:, None, None] - 0.75 * nz, 0.25 * nz)
        return val + torch.clamp(vz, min=0.0) * 2.0 * a
    if params.atten_at_edges == ATTEN_EDGES:
        # atten_at_edges: v = 0.25 - vx*vy*vz, add 8*a*v where v>0
        # (voxels.cpp:405-421); vx/vy/vz are 0 at edges, 1 at center
        vx = 1.0 - div32(2.0 * torch.abs(_ar(nx, dev)[None, None, :] - 0.5 * nx), nx)
        vy = 1.0 - div32(2.0 * torch.abs(_ar(ny, dev)[None, :, None] - 0.5 * ny), ny)
        vz = 1.0 - div32(2.0 * torch.abs(_ar(nz, dev)[:, None, None] - 0.5 * nz), nz)
        v = 0.25 - vx * vy * vz
        return val + torch.where(v > 0.0, 8.0 * a * v, 0.0)
    # spherical attenuation (outer / inner+outer): radial distance from the
    # grid center in normalized coords (atten_to_sphere, voxels.cpp)
    xi = (div32(_ar(nx, dev)[None, None, :], nx) - 0.5) * 2.0
    yi = (div32(_ar(ny, dev)[None, :, None], ny) - 0.5) * 2.0
    zi = (div32(_ar(nz, dev)[:, None, None], nz) - 0.5) * 2.0
    r = sqrt32(xi * xi + yi * yi + zi * zi)
    val = val + a * torch.clamp(r - params.radius_val, min=0.0) * 4.0
    if params.atten_at_edges == ATTEN_SPHERE_INNER_OUTER:
        val = val + a * torch.clamp(0.5 * params.radius_val - r, min=0.0) * 4.0
    return val


def dilate26(mask: torch.Tensor) -> torch.Tensor:
    """26-neighbourhood binary dilation of a bool [nz, ny, nx] mask (a
    3x3x3 max pool; cells outside the grid count as empty)."""
    m = mask.to(torch.float32)[None, None]
    return F.max_pool3d(m, 3, stride=1, padding=1)[0, 0] > 0.0


def flood(seed: torch.Tensor, allowed: torch.Tensor, dilate) -> torch.Tensor:
    """Grow `seed` into `allowed` cells by `dilate` steps to the fixpoint,
    reading for a change every CHECK_EVERY steps."""
    conn = seed
    while True:
        prev = conn
        for _ in range(CHECK_EVERY):
            conn = dilate(conn) & allowed | conn
        if torch.equal(conn, prev):
            return conn


def classify_outside(val: torch.Tensor, isolevel: float) -> torch.Tensor:
    """Flood-fill `outside` classification (voxels.cpp flood_fill_range /
    make_voxels_outside): air cells (val >= isolevel) connected through
    air to the grid boundary.  Returns bool [nz,ny,nx]."""
    air = val >= isolevel  # solid convention: val < isolevel is inside
    seed = torch.zeros_like(air)
    for ax, idx in ((0, 0), (0, -1), (1, 0), (1, -1), (2, 0), (2, -1)):
        sl = [slice(None)] * 3
        sl[ax] = idx
        seed[tuple(sl)] = air[tuple(sl)]
    return flood(seed, air, dilate26)


def remove_unconnected(val: torch.Tensor, isolevel: float, air_val: float = 1.0):
    """Remove solid blobs not connected to the grid bottom
    (voxels.h:201-210 remove_unconnected semantics): flood solid from the
    bottom quarter; unconnected solid cells become air (+air_val pushes
    them past the isolevel)."""
    solid = val < isolevel
    # anchor region: any solid in the bottom quarter of the grid (edge
    # attenuation may open the z=0 layer itself, so a single-layer anchor
    # would wipe valid grounded terrain)
    anchor = max(1, val.shape[0] // 4)
    seed = torch.zeros_like(solid)
    seed[:anchor] = solid[:anchor]
    conn = flood(seed, solid, dilate26)
    return torch.where(solid & ~conn, isolevel + air_val, val)


def make_voxel_grid(params: VoxelParams, world: WorldConst = DEFAULT_WORLD,
                    offset=(0.0, 0.0, 0.0),
                    device: torch.device | str = "cuda") -> VoxelGrid:
    """Full voxel generation pipeline: procedural field -> edge atten ->
    (optional) unconnected-region removal."""
    lo, vsz = default_grid_geometry(params, world)
    val = create_procedural(params, lo, vsz, offset, device=device)
    val = atten_edges(val, params)
    if params.remove_unconnected:
        val = remove_unconnected(val, params.isolevel)
    return VoxelGrid(values=val, lo_pos=lo, vsz=vsz)


def top_surface(grid: VoxelGrid, isolevel: float,
                out_shape: tuple | None = None) -> torch.Tensor:
    """Per-column top height of the solid region (solid = value <
    isolevel).  Returns [ny, nx] world-z heights (-inf where a column has
    no solid voxel); with `out_shape` the surface is resampled to (my, mx)
    by nearest column, which is what fuses the voxel landscape into the
    physics heightfield."""
    val = grid.values
    nz = val.shape[0]
    solid = val < isolevel
    any_solid = solid.any(dim=0)
    # highest solid layer per column (argmax takes the first maximum)
    top_k = nz - 1 - torch.argmax(solid.flip(0).to(torch.uint8), dim=0)
    h = grid.lo_pos[2] + (top_k.to(torch.float32) + 1.0) * grid.vsz[2]
    surf = torch.where(any_solid, h, -torch.inf)
    if out_shape is not None and tuple(out_shape) != tuple(surf.shape):
        my, mx = out_shape
        ny, nx = surf.shape
        idx = lambda m, n: torch.clamp((div32((_ar(m, val.device) + 0.5) * n, m) - 0.5)
                                       .to(torch.int64), 0, n - 1)
        surf = surf[idx(my, ny)][:, idx(mx, nx)]
    return surf

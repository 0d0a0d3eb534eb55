"""Indirect-lighting volume (port of `3dworld_tpu/lighting/lmap.py`).

The reference's `lmcell` grid stores {sky RGB + weight, global RGB +
weight, local RGB, smoke, flow} per (x, y, z) cell over
MESH_X x MESH_Y x MESH_SIZE[2] (lightmap.h:31-44), managed by
`lmap_manager_t` with file I/O (ray_trace.cpp:1120-1170).  Here one
[nz, ny, nx] float32 tensor per channel; the default world's grid is
[32, 128, 128], twelve volumes, 25 MB.

Deposits are fixed-order sums, never float atomics (`cell_sums`): the
samples are sorted by cell id (stable), each cell's run is summed by a
segmented doubling scan (element i adds element i - d of its own run for
d = 1, 2, 4, ...: the same additions in the same order on every run),
and each cell's total is added to its volume once.  So a deposit gives
the same volume bit for bit run to run, on every device, and a deposit
of negated weights is the exact negation of the deposit.  The JAX
package's CPU scatter adds the samples one by one in sample order; the
sums agree to float rounding (rtol 2e-5).  Its `shards` and
`sorted_deposit` options schedule the TPU scatter and leave the sums
unchanged; the port accepts them and they change nothing.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..utils.constants import WorldConst, DEFAULT_WORLD

# lighting types (3DWorld.h LIGHTING_*)
LIGHTING_SKY = 0
LIGHTING_GLOBAL = 1
LIGHTING_LOCAL = 2
LIGHTING_COBJ_ACCUM = 3
LIGHTING_DYNAMIC = 4

# the volumes each lighting type deposits into: color channels, then the
# signed weight channel (sky and global only)
CHANNELS = {LIGHTING_SKY: ("sc_r", "sc_g", "sc_b", "sv"),
            LIGHTING_GLOBAL: ("gc_r", "gc_g", "gc_b", "gv"),
            LIGHTING_LOCAL: ("lc_r", "lc_g", "lc_b")}


class LightGrid(NamedTuple):
    """lmcell SoA: per-channel [nz, ny, nx] volumes."""

    sc_r: torch.Tensor
    sc_g: torch.Tensor
    sc_b: torch.Tensor
    sv: torch.Tensor       # sky weight
    gc_r: torch.Tensor
    gc_g: torch.Tensor
    gc_b: torch.Tensor
    gv: torch.Tensor       # global weight
    lc_r: torch.Tensor
    lc_g: torch.Tensor
    lc_b: torch.Tensor
    smoke: torch.Tensor
    z0: torch.Tensor       # scalar: world z of cell layer 0
    dz: torch.Tensor       # scalar: cell height

    @property
    def shape(self):
        return self.sc_r.shape


def make_light_grid(world: WorldConst = DEFAULT_WORLD, nz: int | None = None,
                    z0: float | None = None, dz: float | None = None,
                    device: torch.device | str = "cuda") -> LightGrid:
    nz = nz if nz is not None else max(world.mesh_z, 1)
    z0 = z0 if z0 is not None else -world.z_scene
    dz = dz if dz is not None else (2.0 * world.z_scene) / nz
    sh = (nz, world.mesh_y, world.mesh_x)
    z = lambda: torch.zeros(sh, dtype=torch.float32, device=device)
    f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=device)
    return LightGrid(sc_r=z(), sc_g=z(), sc_b=z(), sv=z(),
                     gc_r=z(), gc_g=z(), gc_b=z(), gv=z(),
                     lc_r=z(), lc_g=z(), lc_b=z(), smoke=z(),
                     z0=f32(z0), dz=f32(dz))


def cell_index(grid: LightGrid, x, y, z, world: WorldConst):
    """World position -> flat cell id (int64, + validity mask)."""
    nz, ny, nx = grid.shape
    gx = torch.floor(x * world.dx_inv + nx // 2).to(torch.int64)
    gy = torch.floor(y * world.dy_inv + ny // 2).to(torch.int64)
    gz = torch.floor((z - grid.z0) / grid.dz).to(torch.int64)
    ok = (gx >= 0) & (gx < nx) & (gy >= 0) & (gy < ny) & (gz >= 0) & (gz < nz)
    flat = (torch.clamp(gz, 0, nz - 1) * ny + torch.clamp(gy, 0, ny - 1)) * nx \
        + torch.clamp(gx, 0, nx - 1)
    return flat, ok


def cell_sums(idx: torch.Tensor, vals: torch.Tensor, n_cells: int) -> torch.Tensor:
    """Per-cell sums [n_cells, K] of the samples `vals` [M, K] at flat cell
    ids `idx` [M] (ids outside [0, n_cells) are dropped), in a fixed order
    and without atomics: a stable sort by id, each sample's place in its
    id's run (a binary search for the run's start), a segmented doubling
    scan over the runs, and each run's last partial sum written to its
    cell (cells with no sample get 0)."""
    m, k = vals.shape
    dev = vals.device
    idx = torch.where((idx >= 0) & (idx < n_cells), idx, n_cells)
    sid, order = torch.sort(idx, stable=True)
    v = vals[order]
    rank = torch.arange(m, device=dev) - torch.searchsorted(sid, sid)  # place in its run
    d = 1
    while d < m:
        add = torch.where((rank[d:] >= d)[:, None], v[:-d], 0.0)
        v = torch.cat([v[:d], v[d:] + add])
        d *= 2
    run_end = torch.ones(m, dtype=torch.bool, device=dev)
    run_end[:-1] = sid[1:] != sid[:-1]
    out = torch.zeros((n_cells + 1, k), dtype=vals.dtype, device=dev)
    out[torch.where(run_end, sid, n_cells)] = v   # other rows land on the dump row
    return out[:n_cells]


def channels(ltype: int) -> tuple:
    """The volumes a deposit of `ltype` adds to (every other type deposits
    into the local channels, as in the JAX package)."""
    return CHANNELS.get(ltype, CHANNELS[LIGHTING_LOCAL])


def add_sums(grid: LightGrid, ltype: int, sums: torch.Tensor) -> LightGrid:
    """`grid` with per-cell sums [n_cells, K] added to the ltype's
    channels (K = 4 for sky/global, 3 for local)."""
    sh = grid.shape
    return grid._replace(**{f: getattr(grid, f) + sums[:, c].reshape(sh)
                            for c, f in enumerate(channels(ltype))})


def deposit_values(ltype: int, r, g, b, w) -> torch.Tensor:
    """The [M, K] sample values a deposit of ltype sums: color x weight,
    then the signed weight for sky and global."""
    cols = [r * w, g * w, b * w, w]
    return torch.stack(cols[:len(channels(ltype))], 1)


def accumulate(grid: LightGrid, ltype: int, flat_idx, ok, r, g, b, w,
               shards: int = 1, sorted_deposit: bool = False) -> LightGrid:
    """Add one batch of weighted color samples to the volume
    (`add_path_to_lmcs`'s per-cell accumulation, ray_trace.cpp:222-253):
    color*weight into the ltype's RGB channels, SIGNED weight into the
    weight channel (sky/global) — cobj-accum delta rays carry negative
    weight and must subtract exactly what the positive bake added.
    `shards` and `sorted_deposit` are accepted and change nothing (see
    the module docstring)."""
    del shards, sorted_deposit
    n_cells = int(np.prod(grid.shape))
    idx = torch.where(ok, flat_idx, n_cells)
    return add_sums(grid, ltype, cell_sums(idx, deposit_values(ltype, r, g, b, w),
                                           n_cells))


def normalize_sky(grid: LightGrid) -> LightGrid:
    """Convert accumulated sky sums to mean color (lmcell final combine)."""
    inv = 1.0 / torch.clamp(grid.sv, min=1e-6)
    return grid._replace(sc_r=grid.sc_r * inv, sc_g=grid.sc_g * inv,
                         sc_b=grid.sc_b * inv)


def final_color(grid: LightGrid, indir_scale: float = 1.0,
                sky_scale: float = 1.0, global_scale: float = 1.0,
                local_scale: float = 1.0, ambient=(1.0, 1.0, 1.0),
                diffuse=(1.0, 1.0, 1.0)):
    """lmcell::get_final_color (lightmap.cpp:181-193): brightness comes
    from the weight channel (sv/gv), hue from the max-normalized color.
    The hue ratio is scale-invariant, so this works on raw accumulated
    sums and on `normalize_sky` mean colors alike."""
    def term(cr, cg, cb, v, scale, mod):
        mx = torch.maximum(torch.maximum(cr, cg), cb)
        vs = torch.where((mx > 0) & (v > 0),
                         torch.clamp(v * scale, max=1.0) / torch.clamp(mx, min=1e-9), 0.0)
        return vs * cr * mod[0], vs * cg * mod[1], vs * cb * mod[2]

    sr, sg, sb = term(grid.sc_r, grid.sc_g, grid.sc_b, grid.sv, sky_scale, ambient)
    gr, gg, gb = term(grid.gc_r, grid.gc_g, grid.gc_b, grid.gv, global_scale, diffuse)
    r = indir_scale * (sr + gr) + torch.clamp(grid.lc_r * local_scale, max=1.0)
    g = indir_scale * (sg + gg) + torch.clamp(grid.lc_g * local_scale, max=1.0)
    b = indir_scale * (sb + gb) + torch.clamp(grid.lc_b * local_scale, max=1.0)
    return r, g, b


def save_npz(grid: LightGrid, path: str):
    """Lighting-file cache (~ ray_trace.cpp:1120-1170 read/write), with the
    JAX package's keys (one array per field)."""
    np.savez_compressed(path, **{k: v.cpu().numpy() for k, v in grid._asdict().items()})


def load_npz(path: str, device: torch.device | str = "cuda") -> LightGrid:
    z = np.load(path)
    return LightGrid(**{k: torch.as_tensor(z[k], device=device) for k in z.files})

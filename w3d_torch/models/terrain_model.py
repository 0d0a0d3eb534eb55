"""Flagship "terrain tile" model (port of
`3dworld_tpu/models/terrain_model.py`): batched tile generation
(noise -> glaciate -> erosion) for a batch of tile origins.

This is the re-expression of the tiled-terrain hot path
(`tile_t::create_zvals` + `apply_erosion`, tiled_mesh.cpp:467-546): a whole
batch of tiles at once — sine-mode noise as a (T, n, 90) x (90, n) einsum
(the fBm modes elementwise over the [T, n, n] grid), erosion as lockstep
droplet batches walked by the erosion kernel, one CTA per tile.

Both of the JAX package's erosion paths are ported, and both walk through
the erosion kernel on the card: `use_pallas_erosion=False` (the default,
the JAX XLA path) gives each tile a roam ring of `ops/erosion.PAD` cells,
and `use_pallas_erosion=True` (the JAX TPU kernel path) walks the tile
maps without one (border droplets die at the edge).
`make_sharded_tile_step` splits the tile batch over the ranks of a
`parallel.mesh.Mesh` (each tile's droplets stay on its rank).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..utils.constants import WorldConst, DEFAULT_WORLD
from ..utils.profiler import span
from ..ops import noise as N
from ..ops import erosion as E
from ..terrain import mesh as TM
from ..parallel.mesh import Mesh, local_block


class TileModelConfig(NamedTuple):
    """Static config for the tile model (hashable)."""

    tile_size: int = 128          # zvals per tile edge (get_tile_size, tiled_mesh.cpp:142)
    cfg: TM.TerrainConfig = TM.TerrainConfig()
    erosion_iters_tt: int = 0     # per-tile droplets (erosion_iters_tt config)
    erosion_batch: int = 256
    erosion_steps: int = 128
    # True: erode without the roam ring, as the JAX package's Pallas TPU
    # path does; False: the padded walk of its XLA path (`erode(pad=PAD)`)
    use_pallas_erosion: bool = False


def _raw_heights(table: N.SineTable | None, x0, y0, mcfg: TileModelConfig,
                 world: WorldConst) -> torch.Tensor:
    """Raw noise heights for a batch of tiles. x0,y0: [T] tile origins in
    grid units; `table` is read in sine mode only."""
    cfg = mcfg.cfg
    n = mcfg.tile_size
    if cfg.mode == N.MGEN_SINE:
        start = N.start_eval_sin(cfg.mesh_scale, cfg.mesh_freq_filter)
        xt, yt = N.sine_term_tables(
            table, x0, y0, world.dx, world.dy, n, n,
            world=world, mesh_scale=cfg.mesh_scale,
            mesh_scale_z_inv=1.0 / cfg.mesh_scale_z, start_sin=start,
        )
        z = N.eval_sine_grid(xt, yt)                      # [T, n, n]
        z = N.apply_noise_shape_final(z, cfg.shape)
        z = TM.postproc_noise_zval(z, cfg.hmap)
    else:
        ar = torch.arange(n, dtype=torch.float32, device=x0.device)
        xi = ar[None, None, :] + x0[:, None, None]
        yi = ar[None, :, None] + y0[:, None, None]
        xv = torch.broadcast_to(xi, (x0.shape[0], n, n))
        yv = torch.broadcast_to(yi, (x0.shape[0], n, n))
        z = N.noise_zval_grid(xv, yv, cfg.mode, shape=cfg.shape,
                              mesh_scale=cfg.mesh_scale, mesh_seed=cfg.mesh_seed,
                              world=world,
                              postproc=lambda v: TM.postproc_noise_zval(v, cfg.hmap))
    return z


def _tile_heights(table: N.SineTable | None, x0, y0, mcfg: TileModelConfig,
                  world: WorldConst, zmax_est) -> torch.Tensor:
    """Raw+glaciated heights for a batch of tiles (`_raw_heights`)."""
    with span("tiles.noise", device=x0.is_cuda):
        z = _raw_heights(table, x0, y0, mcfg, world)
    with span("tiles.glaciate", device=x0.is_cuda):
        return TM.apply_glaciate(z, zmax_est, mcfg.cfg)


def tile_batch_step(table: N.SineTable, x0, y0, zmax_est, wpz,
                    angles: torch.Tensor | None,
                    mcfg: TileModelConfig = TileModelConfig(),
                    world: WorldConst = DEFAULT_WORLD) -> torch.Tensor:
    """Generate a batch of terrain tiles: [T] origins -> [T, n, n] heights.

    `angles` [num_batches, erosion_steps, erosion_batch] are the erosion
    flat-spot directions (`ops/erosion.draw_angles`); None when
    `erosion_iters_tt` is 0."""
    with span("tiles"):
        z = _tile_heights(table, x0, y0, mcfg, world, zmax_est)
        if mcfg.erosion_iters_tt > 0:
            with span("tiles.erode", device=z.is_cuda):
                cfg = mcfg.cfg
                eparams = E.ErosionParams(
                    erode_amount=cfg.erode_amount, water_plane_z=wpz,
                    half_dxy=world.half_dxy, zmin=-zmax_est, zmax=zmax_est,
                    rock_thresh=TM.clip_hd1(cfg), relh_adj_tex=cfg.relh_adj_tex,
                )
                z = E.erode(z, mcfg.erosion_iters_tt, eparams, angles,
                            min_zval=-1.0e9, batch_size=mcfg.erosion_batch,
                            max_steps=mcfg.erosion_steps,
                            pad=0 if mcfg.use_pallas_erosion else E.PAD)
    return z


def make_sharded_tile_step(mesh: Mesh, mcfg: TileModelConfig,
                           world: WorldConst = DEFAULT_WORLD):
    """The tile batch split over the mesh's ranks (data parallel over
    tiles).  Returns ``step(table, x0, y0, zmax_est, wpz, angles)``: the
    whole [T] origins on every rank in, the rank's [T / n, n, n] block of
    the tiles out.  The erosion `angles` are replicated: every tile walks
    the same droplets."""
    def step(table, x0, y0, zmax_est, wpz, angles):
        return tile_batch_step(table, local_block(x0, mesh), local_block(y0, mesh),
                               zmax_est, wpz, angles, mcfg, world)
    return step


def example_inputs(mcfg: TileModelConfig, world: WorldConst,
                   generator: torch.Generator, num_tiles: int = 8,
                   device: torch.device | str = "cuda"):
    """(table, x0, y0, zmax_est, wpz, angles) example inputs for the model."""
    table = TM.gen_table_for(mcfg.cfg, world, device=device)
    x0 = torch.arange(num_tiles, dtype=torch.float32, device=device) * mcfg.tile_size
    y0 = torch.zeros((num_tiles,), dtype=torch.float32, device=device)
    zmax_est = torch.tensor(10.0, dtype=torch.float32, device=device)
    wpz = torch.tensor(-8.0, dtype=torch.float32, device=device)
    angles = None
    if mcfg.erosion_iters_tt > 0:
        angles = E.draw_angles(mcfg.erosion_iters_tt, mcfg.erosion_batch,
                               mcfg.erosion_steps, generator, device=device)
    return table, x0, y0, zmax_est, wpz, angles

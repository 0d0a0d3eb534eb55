"""Infinite tiled-terrain streaming (port of `3dworld_tpu/terrain/tiles.py`).

Re-expresses `tile_draw_t::update` + `tile_t` (tiled_mesh.cpp:142,
2311-2417, tiled_mesh.h:156,406): an unordered map of tiles keyed by
(tx, ty), created within CREATE_DIST of the camera and deleted beyond
DELETE_DIST; per tile: zvals generation -> erosion -> AO -> shadows ->
biome weights.

Every update's whole set of new tiles is one batched call (padded to a
multiple of 8 tiles), generating the AO-halo context directly.  The host
manager only tracks keys and owns the result tensors.  `_generate` never
waits for the card: the tile origins go up through pinned memory, every
scalar lives on the device, and the results stay there, so the card's
work for one batch overlaps the host bookkeeping of the next (the
deferred batch of `update(max_tiles_per_frame=...)`).

Erosion (`erosion_iters_tt > 0`) follows the JAX package's non-TPU branch
on every device: `ops/erosion.erode` with its roam ring (`pad=PAD`),
batches of 256 droplets, 96 steps and each tile's own minimum as
`min_zval`; on the card it walks through the erosion kernel.  The JAX TPU
branch (`erode_tiles_pallas`, no roam ring, the clamp after) gives another
result and is not ported.  The flat-spot angles are inputs: one
[ceil(iters / 256), 96, 256] tensor per manager (`angles`), drawn from a
CPU generator seeded with 0 unless given (the JAX `erode`
draws them from key 0, so every tile of every batch walks the same
angles there too).

`grass_for_tile` and `flowers_for_tile` hash a resident tile's blades and
flowers (`veg/grass`) on the tile's device; `height_at` reads the height
under the camera from its resident tile.

`gen_tile_batch` runs a batch as five phases (`phases`): context,
erosion, AO, shadows, biome weights.  The manager's batches go through
its `ops/cuda/graphs.GraphCache` (`graphs`), keyed by
`terrain/tile_graphs.batch_key`: on a card, once a batch's shape repeats,
each phase is captured into a CUDA graph and replayed in place of its
launches.

Spans: `tiles.update` around `update`, `tiles.generate` around a batch's
enqueue, and inside it the phases `tiles.context`, `tiles.erode`,
`tiles.ao`, `tiles.shadows` and `tiles.biomes`, each with CUDA events on
a card (inside `tiles.graph` where the batch replays; `tiles.capture`
around a capture).  `TileManager.counts` counts the tiles created,
deleted and deferred (left by the budget for a later call), the batches
generated, and holds the number resident; `graph_captures`,
`graph_replays`, `graph_eager` and `graph_failed` count the batches by
how they ran and the captures that raised.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field
from typing import NamedTuple

import numpy as np
import torch

from ..utils.constants import WorldConst, DEFAULT_WORLD
from ..utils.profiler import span
from ..ops import noise as N
from ..ops import erosion as E
from ..ops import ao as AO
from ..ops import shadows as SH
from ..ops.cuda import graphs as CG
from . import mesh as TM
from . import tile_graphs as TG
from . import biomes as B

CREATE_DIST_TILES = 1.5   # in tile units (~ get_tile_radius scaling)
DELETE_DIST_TILES = 2.0
EROSION_BATCH = 256       # droplets per lockstep batch (tiles.py:241-243)
EROSION_STEPS = 96
COUNTS = ("created", "deleted", "deferred", "batches", "resident") + CG.COUNTS


@dataclass
class Tile:
    """One resident tile's generated data (device tensors)."""

    tx: int
    ty: int
    zvals: torch.Tensor       # [stride, stride]
    ao: torch.Tensor          # [stride, stride]
    smask_sun: torch.Tensor   # [stride, stride] bool
    weights: torch.Tensor     # [5, stride, stride]


def upload(a: np.ndarray, device) -> torch.Tensor:
    """A host array on `device` without waiting for the device: through
    pinned memory to a CUDA device."""
    t = torch.from_numpy(a)
    if torch.device(device).type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


@dataclass
class TileManager:
    cfg: TM.TerrainConfig = TM.TerrainConfig()
    world: WorldConst = DEFAULT_WORLD
    tile_size: int = 128
    erosion_iters_tt: int = 0
    sun_dir: tuple = (0.4, 0.3, 0.8)
    tiles: dict = field(default_factory=dict)
    zmax_est: float = 10.0
    device: torch.device | str = "cuda"
    angles: torch.Tensor | None = None   # [nb, EROSION_STEPS, EROSION_BATCH]
    _batch_pad: int = 8
    _pending: tuple | None = None   # (keys, device tensors) in-flight batch
    counts: dict = field(default_factory=lambda: dict.fromkeys(COUNTS, 0))

    def __post_init__(self):
        self.graphs = CG.GraphCache("tiles", self.counts)
        ts = TM.gen_terrain(self.cfg._replace(erosion_iters=0),
                            WorldConst(mesh_x=64, mesh_y=64,
                                       x_scene=self.world.x_scene,
                                       y_scene=self.world.y_scene,
                                       z_scene=self.world.z_scene),
                            device=self.device)
        self.set_height_range(float(ts.zmax_est), float(ts.water_plane_z))
        self.table = TM.gen_table_for(self.cfg, self.world, device=self.device) \
            if self.cfg.mode == N.MGEN_SINE else None
        if self.erosion_iters_tt > 0:
            if self.angles is None:
                gen = torch.Generator().manual_seed(0)
                self.angles = E.draw_angles(self.erosion_iters_tt, EROSION_BATCH,
                                            EROSION_STEPS, gen, device="cpu")
            self.angles = self.angles.to(self.device)

    def set_height_range(self, zmax_est: float, water_plane_z: float):
        """The height range every tile is generated against: `zmax_est`
        (glaciation, erosion's relative height, biome bands) and the water
        plane (erosion's ocean cutoff), as host floats and as device
        scalars."""
        self.zmax_est, self.water_plane_z = zmax_est, water_plane_z
        f32 = lambda v: torch.full((), v, dtype=torch.float32, device=self.device)
        self._zmax_t, self._wpz_t = f32(zmax_est), f32(water_plane_z)

    # -- streaming bookkeeping (tile_draw_t::update) --

    def camera_tile(self, cam_x: float, cam_y: float):
        tw = self.tile_size * self.world.dx
        th = self.tile_size * self.world.dy
        return int(np.floor(cam_x / tw)), int(np.floor(cam_y / th))

    def wanted_tiles(self, cam_x: float, cam_y: float,
                     radius: float = CREATE_DIST_TILES):
        ctx, cty = self.camera_tile(cam_x, cam_y)
        r = int(np.ceil(radius))
        out = []
        for dy in range(-r, r + 1):
            for dx in range(-r, r + 1):
                if dx * dx + dy * dy <= radius * radius + 1e-6:
                    out.append((ctx + dx, cty + dy))
        return out

    def update(self, cam_x: float, cam_y: float,
               max_tiles_per_frame: int | None = None):
        """Create missing in-range tiles (one batched call), delete
        out-of-range ones.  Returns (created, deleted) key lists.

        Missing tiles are created nearest-camera-first, at most
        `max_tiles_per_frame` per call (None = all), as the reference's
        priority queue with a per-frame budget (tile_draw_t::update,
        tiled_mesh.cpp:2349-2417).  With a budget the batch is deferred:
        its results are adopted at the start of the NEXT call, so the
        card's work for batch N overlaps the host bookkeeping of batch
        N+1."""
        with span("tiles.update"):
            if self._pending is not None:
                self._adopt_pending()
            want = self.wanted_tiles(cam_x, cam_y)
            ctx, cty = self.camera_tile(cam_x, cam_y)
            deleted = []
            for key in list(self.tiles):
                ddx = key[0] - ctx
                ddy = key[1] - cty
                if ddx * ddx + ddy * ddy > DELETE_DIST_TILES ** 2:
                    del self.tiles[key]
                    deleted.append(key)
            new = [k for k in want if k not in self.tiles]
            # nearest-first priority (the reference sorts by tile priority)
            new.sort(key=lambda k: (k[0] - ctx) ** 2 + (k[1] - cty) ** 2)
            if max_tiles_per_frame is not None:
                self.counts["deferred"] += max(len(new) - max_tiles_per_frame, 0)
                new = new[:max_tiles_per_frame]
                if new:
                    self._generate(new, defer=True)
            elif new:
                self._generate(new)
            self.counts["deleted"] += len(deleted)
            self.counts["resident"] = len(self.tiles)
        return new, deleted

    def _adopt(self, keys, out):
        zv, ao, sm, wts = out
        for i, k in enumerate(keys):
            self.tiles[k] = Tile(tx=k[0], ty=k[1], zvals=zv[i], ao=ao[i],
                                 smask_sun=sm[i], weights=wts[i])

    def _adopt_pending(self):
        keys, out = self._pending
        self._pending = None
        self._adopt(keys, out)

    def flush(self):
        """Force-adopt any in-flight batch (end-of-frame sync point)."""
        if self._pending is not None:
            self._adopt_pending()
            self.counts["resident"] = len(self.tiles)

    def height_at(self, x: float, y: float) -> torch.Tensor:
        """The terrain height at world (x, y), a 0-d tensor on the tiles'
        device, read without waiting for the device: the bilinear read of
        the resident tile under (x, y), contracting y first, then x, each
        product and sum rounded on its own, with the cell clamped into the
        tile and the weights to [0, 1], as `physics/step.sample_mesh`
        reads the ground mesh (so a tile's last row and column read flat).
        The player's collision reads it every frame
        (check_player_tiled_terrain_collision, tiled_mesh.cpp:1234).
        Raises KeyError where no resident tile holds (x, y)."""
        key = self.camera_tile(x, y)
        zv = self.tiles[key].zvals
        n = self.tile_size
        gx = x * self.world.dx_inv - key[0] * n
        gy = y * self.world.dy_inv - key[1] * n
        x0 = min(max(int(np.floor(gx)), 0), n - 2)
        y0 = min(max(int(np.floor(gy)), 0), n - 2)
        fx = np.float32(min(max(gx - x0, 0.0), 1.0))
        fy = np.float32(min(max(gy - y0, 0.0), 1.0))
        wx0, wy0 = float(np.float32(1.0) - fx), float(np.float32(1.0) - fy)
        c = zv[y0, x0:x0 + 2] * wy0 + zv[y0 + 1, x0:x0 + 2] * float(fy)
        return c[0] * wx0 + c[1] * float(fx)

    # -- per-tile vegetation (grass_tile_manager_t, grass.cpp:58) --

    def grass_for_tile(self, key, blades_per_cell: int = 4):
        """Per-blade grass block for a resident tile, density-gated by
        its GRASS biome weight (the reference generates per-tile grass
        blocks on demand from the tile's weight texture)."""
        from ..veg import grass as VG
        t = self.tiles[key]
        seed = (t.tx * 73856093) ^ (t.ty * 19349663) ^ 0x9A55
        return VG.gen_grass_block(
            seed & 0x7FFFFFFF, float(t.tx * self.tile_size),
            float(t.ty * self.tile_size), t.zvals,
            t.weights[B.GRASS], self.world,
            blades_per_cell=blades_per_cell)

    def flowers_for_tile(self, key, flower_density: float = 1.0):
        """Per-tile flowers where the grass is dense
        (flower_tile_manager_t::gen_flowers, grass.cpp:859)."""
        from ..veg import grass as VG
        t = self.tiles[key]
        seed = (t.tx * 83492791) ^ (t.ty * 2654435761) ^ 0xF10E
        return VG.gen_flowers(
            seed & 0x7FFFFFFF, float(t.tx * self.tile_size),
            float(t.ty * self.tile_size), t.zvals,
            t.weights[B.GRASS], self.world,
            flower_density=flower_density)

    # -- batched generation --

    def _generate(self, keys, defer: bool = False):
        n = len(keys)
        pad = -(-n // self._batch_pad) * self._batch_pad
        txs = np.array([k[0] for k in keys] + [keys[-1][0]] * (pad - n), np.float32)
        tys = np.array([k[1] for k in keys] + [keys[-1][1]] * (pad - n), np.float32)
        spec = BatchSpec(self.table, self.cfg, self.world, self.tile_size,
                         self.erosion_iters_tt, self.sun_dir, self.angles)
        with span("tiles.generate"):
            b = dict(zip(TG.INPUTS, (upload(txs, self.device), upload(tys, self.device),
                                     self._zmax_t, self._wpz_t)))
            out = self.graphs.run(TG.batch_key(spec, b["txs"]), phases(spec), b, OUTPUTS,
                                  spec)
        self.counts["created"] += n
        self.counts["batches"] += 1
        if defer:   # adopted on the NEXT update
            self._pending = (list(keys), out)
            return
        self._adopt(keys, out)


def tile_context(table, txs, tys, zmax_est, cfg: TM.TerrainConfig,
                 world: WorldConst, tile_size: int) -> torch.Tensor:
    """The glaciated context heights [T, C, C] (C = tile + 2 AO halos) of
    tiles at [T] tile indices: sine-table or fBm noise, then glaciation."""
    stride = tile_size
    halo = AO.AO_RAY_LEN
    csz = stride + 2 * halo
    x0 = txs * stride - halo
    y0 = tys * stride - halo
    if cfg.mode == N.MGEN_SINE:
        start = N.start_eval_sin(cfg.mesh_scale, cfg.mesh_freq_filter)
        xt, yt = N.sine_term_tables(
            table, x0, y0, world.dx, world.dy, csz, csz, world=world,
            mesh_scale=cfg.mesh_scale, mesh_scale_z_inv=1.0 / cfg.mesh_scale_z,
            start_sin=start)
        ctx = N.eval_sine_grid(xt, yt)
        ctx = N.apply_noise_shape_final(ctx, cfg.shape)
        ctx = TM.postproc_noise_zval(ctx, cfg.hmap)
    else:
        ar = torch.arange(csz, dtype=torch.float32, device=txs.device)
        T = txs.shape[0]
        xi = torch.broadcast_to(ar[None, None, :] + x0[:, None, None], (T, csz, csz))
        yi = torch.broadcast_to(ar[None, :, None] + y0[:, None, None], (T, csz, csz))
        ctx = N.noise_zval_grid(xi, yi, cfg.mode, shape=cfg.shape,
                                mesh_scale=cfg.mesh_scale,
                                mesh_seed=cfg.mesh_seed, world=world)
    return TM.apply_glaciate(ctx, zmax_est, cfg)


def erode_tiles(zv: torch.Tensor, zmax_est, wpz, cfg: TM.TerrainConfig,
                world: WorldConst, erosion_iters: int,
                angles: torch.Tensor) -> torch.Tensor:
    """The JAX package's non-TPU tile erosion: the padded `erode` of each
    tile with batches of 256 droplets, 96 steps, clamped below at the
    tile's own minimum."""
    eparams = E.ErosionParams(
        erode_amount=cfg.erode_amount, water_plane_z=wpz,
        half_dxy=world.half_dxy, zmin=-zmax_est, zmax=zmax_est,
        rock_thresh=TM.clip_hd1(cfg), relh_adj_tex=cfg.relh_adj_tex)
    zmin_t = torch.amin(zv, dim=(-1, -2))
    return E.erode(zv, erosion_iters, eparams, angles,
                   min_zval=zmin_t[:, None, None], batch_size=EROSION_BATCH,
                   max_steps=EROSION_STEPS, pad=E.PAD)


class BatchSpec(NamedTuple):
    """What a batch of tiles is made with, besides its origins and height
    range: the arguments of `gen_tile_batch` that a CUDA graph of the
    batch bakes in (`terrain/tile_graphs`)."""

    table: N.SineTable | None
    cfg: TM.TerrainConfig
    world: WorldConst
    tile_size: int
    erosion_iters: int
    sun_dir: tuple
    angles: torch.Tensor | None


def _interior(tile_size: int) -> tuple:
    halo = AO.AO_RAY_LEN
    return (slice(None), slice(halo, halo + tile_size), slice(halo, halo + tile_size))


# The phases of a batch.  Each reads the batch's tensors so far from `b`,
# a dict that starts with "txs", "tys", "zmax_est" and "wpz", and adds or
# replaces its own.

def context_phase(b: dict, s: BatchSpec) -> None:
    """The glaciated context heights "ctx" and the tiles' interior "zvals"
    (a view of it)."""
    ctx = tile_context(s.table, b["txs"], b["tys"], b["zmax_est"], s.cfg, s.world,
                       s.tile_size)
    b["ctx"], b["zvals"] = ctx, ctx[_interior(s.tile_size)]


def erode_phase(b: dict, s: BatchSpec) -> None:
    """The eroded "zvals", written back into a copy of "ctx"."""
    zv = erode_tiles(b["zvals"], b["zmax_est"], b["wpz"], s.cfg, s.world,
                     s.erosion_iters, s.angles)
    ctx = b["ctx"].clone()
    ctx[_interior(s.tile_size)] = zv
    b["ctx"], b["zvals"] = ctx, zv


def ao_phase(b: dict, s: BatchSpec) -> None:
    b["ao"] = AO.tile_ao(b["ctx"], s.tile_size, dz=0.5 * s.world.half_dxy)


def shadows_phase(b: dict, s: BatchSpec) -> None:
    b["smask"], _ = SH.mesh_shadows(b["zvals"], s.sun_dir, cell_w=s.world.dx)


def biomes_phase(b: dict, s: BatchSpec) -> None:
    """Biome "weights"; the normal's z for slope-based texturing comes from
    centered differences over the halo-padded context, so borders use true
    neighbor heights."""
    stride, halo, world, ctx = s.tile_size, AO.AO_RAY_LEN, s.world, b["ctx"]
    c = slice(halo, halo + stride)
    dzdx = (ctx[:, c, halo + 1:halo + stride + 1]
            - ctx[:, c, halo - 1:halo + stride - 1]) * (0.5 * world.dx_inv)
    dzdy = (ctx[:, halo + 1:halo + stride + 1, c]
            - ctx[:, halo - 1:halo + stride - 1, c]) * (0.5 * world.dy_inv)
    norm_z = torch.rsqrt(dzdx ** 2 + dzdy ** 2 + 1.0)
    b["weights"] = B.biome_weights(b["zvals"], norm_z, -b["zmax_est"], b["zmax_est"],
                                   s.cfg)


PHASES = (("tiles.context", context_phase), ("tiles.erode", erode_phase),
          ("tiles.ao", ao_phase), ("tiles.shadows", shadows_phase),
          ("tiles.biomes", biomes_phase))
OUTPUTS = ("zvals", "ao", "smask", "weights")


def phases(s: BatchSpec) -> list:
    """The batch's phases in order, as (span name, phase of `b` alone):
    erosion only with `erosion_iters > 0`."""
    return [(name, functools.partial(f, s=s)) for name, f in PHASES
            if f is not erode_phase or s.erosion_iters > 0]


def gen_tile_batch(table, txs, tys, zmax_est, wpz, cfg: TM.TerrainConfig,
                   world: WorldConst, tile_size: int, erosion_iters: int,
                   sun_dir: tuple, angles: torch.Tensor | None = None):
    """Generate a padded batch of tiles: context zvals (with AO halo) ->
    glaciate -> [erode interior] -> AO -> shadows -> biome weights, each
    phase in its span.

    `txs`, `tys` [T] float32 tile indices; `zmax_est`, `wpz` 0-d float32
    tensors on the same device; `angles` as `TileManager.angles` when
    `erosion_iters > 0`.  Returns (zvals [T, n, n], ao [T, n, n], shadow
    mask [T, n, n] bool, weights [T, 5, n, n])."""
    s = BatchSpec(table, cfg, world, tile_size, erosion_iters, sun_dir, angles)
    return CG.eager(phases(s), dict(zip(TG.INPUTS, (txs, tys, zmax_est, wpz))), OUTPUTS)

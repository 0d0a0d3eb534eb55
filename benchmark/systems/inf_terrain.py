"""Driver of the live tiled-terrain configurations (`inf_terrain_128`): the
program's `models/world.TiledWorld` with no city, its tile manager
`terrain/tiles.TileManager` held to `tile_budget` new tiles a frame, and
the height read under the camera (`TileManager.height_at`) that the
player's collision makes each frame.

A step is one frame: `TiledWorld.step` at the camera, then `height_at`
there; it ends in the host read of that height.  The camera flies the
traffic's boustrophedon at `frames_per_tile` frames a tile: rows of
`row_tiles` tiles along +x, then back along -x, each next row
`row_gap_tiles` further along +y, reached by a move along +y at the same
speed, `sweep_rows` rows to a sweep; a run that outlasts a sweep flies it
back in reverse.  The sweep's corner is drawn from the seed within
`region_jitter_tiles` tiles of the origin, and the camera starts at the
centre of the corner's tile.  So each frame whose camera enters a new
tile makes the row or column of tiles that came within reach, as one
padded batch, and the other frames adopt that batch, delete, and read
the height.  Set-up fills the first tiles (`settle_steps` frames at the
start; the budget makes them two batches), which also runs every shape
of the window once.  The erosion's flat-spot angles are drawn from the
seed.

The check holds the run against `reference/inf_terrain.py`: the resident
keys after every frame of the window, exactly; the height read in the
frames drawn from the seed; and every tile of the first batch made at or
after each drawn frame, and of the last batch adopted, which is set-up's
where the window adopts none.
"""

from __future__ import annotations

import math
import random

import torch

from w3d_torch.models import world as W
from w3d_torch.ops import ao as AO
from w3d_torch.ops import erosion as E
from w3d_torch.ops.cuda import build
from w3d_torch.ops.cuda import erosion_kernel as EK
from w3d_torch.terrain import mesh as TM
from w3d_torch.terrain import tiles as TL
from w3d_torch.utils.constants import WorldConst

from benchmark.reference import inf_terrain as RI


def _require(cfg: dict) -> None:
    """The configuration's settings that the program holds as constants."""
    have = {"erosion_batch": TL.EROSION_BATCH, "erosion_steps": TL.EROSION_STEPS,
            "erosion_pad": E.PAD, "ao_halo": AO.AO_RAY_LEN, "ao_steps": AO.NUM_AO_STEPS,
            "create_radius_tiles": TL.CREATE_DIST_TILES,
            "delete_radius_tiles": TL.DELETE_DIST_TILES}
    off = {k: (cfg[k], v) for k, v in have.items() if cfg[k] != v}
    if off:
        raise ValueError(f"the program runs other settings (configuration, program): {off}")


class Path:
    """The camera's boustrophedon, in world units, frame by frame."""

    def __init__(self, cfg: dict, traffic: dict, seed: int):
        self.tw = cfg["tile_size"] * (2.0 * cfg["x_scene"] / cfg["mesh_x"])
        self.th = cfg["tile_size"] * (2.0 * cfg["y_scene"] / cfg["mesh_y"])
        self.f = traffic["frames_per_tile"]
        self.row = traffic["row_tiles"] * self.f
        self.join = traffic["row_gap_tiles"] * self.f
        self.gap = traffic["row_gap_tiles"]
        self.rows = traffic["sweep_rows"]
        self.sweep = self.rows * self.row + (self.rows - 1) * self.join
        jitter = traffic["region_jitter_tiles"]
        rng = random.Random(seed)
        self.corner = tuple(rng.randrange(-jitter, jitter) for _ in range(2))

    def __call__(self, i: int) -> tuple:
        k = i % (2 * self.sweep)
        k = k if k <= self.sweep else 2 * self.sweep - k
        r, o = divmod(k, self.row + self.join)
        if o <= self.row:
            u = o / self.f
            x, y = (u if r % 2 == 0 else self.row / self.f - u), r * self.gap
        else:
            x = self.row / self.f if r % 2 == 0 else 0.0
            y = r * self.gap + (o - self.row) / self.f
        return ((self.corner[0] + 0.5 + x) * self.tw, (self.corner[1] + 0.5 + y) * self.th)


class Stream:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device: torch.device):
        self.cfg, self.device = cfg, device
        _require(cfg)
        if device.type == "cuda":
            # the configuration states float32 matrix products without TF32
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        self.path = Path(cfg, traffic, seed)
        gen = torch.Generator(device=device).manual_seed(seed)
        nb = -(-cfg["erosion_iters_tt"] // cfg["erosion_batch"])
        self.angles = torch.rand((nb, cfg["erosion_steps"], cfg["erosion_batch"]),
                                 generator=gen, dtype=torch.float32,
                                 device=device) * (2.0 * math.pi)
        world = WorldConst(mesh_x=cfg["mesh_x"], mesh_y=cfg["mesh_y"],
                           x_scene=cfg["x_scene"], y_scene=cfg["y_scene"],
                           z_scene=cfg["z_scene"])
        tcfg = TM.TerrainConfig(
            mesh_seed=cfg["mesh_seed"], mesh_scale=cfg["mesh_scale"],
            mesh_scale_z=cfg["mesh_scale_z"], mesh_height_scale=cfg["mesh_height_scale"],
            glaciate=cfg["glaciate"], glaciate_exp=cfg["glaciate_exp"],
            erode_amount=cfg["erode_amount"], water_h_off_rel=cfg["water_h_off_rel"],
            relh_adj_tex=cfg["relh_adj_tex"], mesh_freq_filter=cfg["mesh_freq_filter"])
        mgr = TL.TileManager(cfg=tcfg, world=world, tile_size=cfg["tile_size"],
                             erosion_iters_tt=cfg["erosion_iters_tt"],
                             sun_dir=tuple(cfg["sun_dir"]), device=device,
                             angles=self.angles)
        self.world = W.TiledWorld(tile_mgr=mgr, tile_budget=cfg["tile_budget"])
        if device.type == "cuda":
            build.library()          # builds the kernels once per checkout
        self.mgr = mgr
        self.settle = traffic["settle_steps"]
        made, self.last = None, None  # the last adopted batch: (frame made, {key: Tile})
        for j in range(self.settle):         # the first tiles: 8, then 1
            created, _ = self.world.step(*self.path(0))
            if made:                         # adopted in this frame's update
                self.last = (j - 1 - self.settle, {k: mgr.tiles[k] for k in made if k in mgr.tiles})
            made = list(created) if created else None
        if len(mgr.tiles) != 9:
            raise RuntimeError(f"set-up left {len(mgr.tiles)} tiles resident, not 9")
        self.read(mgr.height_at(*self.path(0)))
        self.keys = [(-1, frozenset(mgr.tiles))]     # (frame, resident keys) on change
        self.made: dict = {}        # frame -> keys of the batch it made
        self.want: set = set()      # frames whose next batch the check holds
        self.batches: dict = {}     # frame made -> {key: Tile} once adopted
        self.heights: dict = {}     # drawn frame -> (x, y, key, height)
        self.frames = 0
        self.items_per_step = 1

    def call(self, i: int):
        x, y = self.path(i)
        created, _ = self.world.step(x, y)
        if created:
            self.made[i] = list(created)
        return self.mgr.height_at(x, y)

    def read(self, out) -> float:
        return float(out)

    def keep(self, i: int, out, sampled: bool) -> None:
        self.frames = i + 1
        tiles = self.mgr.tiles
        if sampled:
            x, y = self.path(i)
            self.heights[i] = (x, y, RI.camera_tile(self.cfg, x, y), out)
            self.want.add(i)
        made = self.made.pop(i - 1, None)
        if made:                         # adopted in this frame's update
            batch = {k: tiles[k] for k in made if k in tiles}
            self.last = (i - 1, batch)
            if any(w < i for w in self.want):
                self.batches[i - 1] = batch
                self.want = {w for w in self.want if w >= i}
        keys = frozenset(tiles)
        if keys != self.keys[-1][1]:
            self.keys.append((i, keys))

    def counters(self) -> dict:
        return {**self.mgr.counts, "erosion": EK.KERNEL.launches}

    def close(self) -> None:
        self.world = self.mgr = None

    def check(self, judge: str, work: bool) -> dict:
        """Readings of the program ("program") or of the control (the
        reference with TF32 noise, "control") against the reference: the
        frames whose resident keys differ, the worst height read of the
        drawn frames, and the worst tile of the batches checked."""
        cfg = self.cfg
        limits = cfg["check"]["limits"]
        cams = [self.path(0)] * self.settle + [self.path(i) for i in range(self.frames)]
        expect = RI.bookkeeping(cfg, cams)[self.settle:]
        resident_off = 0
        if judge == "program":
            got = self.keys[0][1]
            changes = dict(self.keys[1:])
            for i, (want, _) in enumerate(expect):
                got = changes.get(i, got)
                resident_off += got != want
        batches = dict(self.batches)
        if self.last is not None:
            batches.setdefault(*self.last)
        need = sorted({k for b in batches.values() for k in b}
                      | {h[2] for h in self.heights.values()})
        ref = RI.Tiles(cfg, self.device, self.angles)
        expect_t = ref(need)
        at = {k: j for j, k in enumerate(need)}
        cand_t = ref(need, tf32=True) if judge == "control" else None
        worst: dict = {"resident_off": float(resident_off)}
        failed = resident_off
        for made, batch in sorted(batches.items()):
            keys = sorted(batch)
            idx = torch.tensor([at[k] for k in keys], device=self.device)
            pick = {f: v[idx] for f, v in expect_t.items()}
            if judge == "program":
                cand = {"zvals": torch.stack([batch[k].zvals for k in keys]),
                        "ao": torch.stack([batch[k].ao for k in keys]),
                        "shadow": torch.stack([batch[k].smask_sun for k in keys]),
                        "weights": torch.stack([batch[k].weights for k in keys])}
            else:
                cand = {f: v[idx] for f, v in cand_t.items()}
            r = RI.tile_readings(cand, pick)
            failed += any(r.get(k, 0.0) > lim for k, lim in limits.items())
            for k, v in r.items():
                worst[k] = max(worst.get(k, 0.0), v)
        h_err = 0.0
        for i, (x, y, key, h) in sorted(self.heights.items()):
            want = RI.height(expect_t["zvals"][at[key]], key, x, y, cfg)
            got = h if judge == "program" else RI.height(cand_t["zvals"][at[key]], key, x, y, cfg)
            e = abs(float(got) - float(want))
            e = e if e == e else math.inf
            failed += e > limits.get("height_err_max", math.inf)
            h_err = max(h_err, e)
        worst["height_err_max"] = h_err
        return {"readings": worst, "failed": int(failed)}


def setup(cfg: dict, traffic: dict, seed: int, device: torch.device) -> Stream:
    return Stream(cfg, traffic, seed, device)

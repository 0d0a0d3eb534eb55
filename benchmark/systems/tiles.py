"""Driver of the terrain-tile configurations (`tiled_terrain_128`): the
program's `models/terrain_model.tile_batch_step`, one batch of tiles a
call.

Set-up makes every input from the seed: a pool of flat-spot direction
draws on the device, and the tile origins of every call.  Call c makes
`tiles_per_call` tiles as a square block of the region's
`region_blocks`^2 blocks, the region's corner drawn from the seed; each
pass over the region shifts every origin by a further fraction of a cell
(the golden ratio's), so no two calls of a run make the same tiles, while
every origin stays inside the region and the noise's sine arguments stay
as small as they are in the first pass.  A step ends in the host read of
the sum of all of its tiles' heights.

The check holds whole calls against `reference/terrain.py`: every tile of
the calls drawn from the seed and of the last call.
"""

from __future__ import annotations

import math
import random

import torch

from w3d_torch.models import terrain_model as TMOD
from w3d_torch.ops.cuda import build
from w3d_torch.ops.cuda import erosion_kernel as EK
from w3d_torch.terrain import mesh as TM
from w3d_torch.utils.constants import WorldConst

from benchmark.reference import terrain as R

GOLDEN = (math.sqrt(5.0) - 1.0) / 2.0


def origins(cfg: dict, traffic: dict, seed: int, device) -> tuple:
    """(x0, y0), each [origin_pool, tiles_per_call] grid units: call c's
    tile origins, worked out in float64 a slice of calls at a time."""
    side = traffic["block_tiles"]
    rb = traffic["region_blocks"]
    n = cfg["tile_size"]
    rng = random.Random(seed)
    jitter = traffic["region_jitter_tiles"]
    cx, cy = (rng.randrange(-jitter, jitter) * n for _ in range(2))
    t = torch.arange(side * side, dtype=torch.float64, device=device)
    pool = traffic["origin_pool"]
    x0 = torch.empty((pool, side * side), dtype=torch.float32, device=device)
    y0 = torch.empty_like(x0)
    for lo in range(0, pool, 256):
        c = torch.arange(lo, min(lo + 256, pool), dtype=torch.float64, device=device)
        block = c.remainder(rb * rb)
        shift = torch.remainder(torch.floor(c / (rb * rb)) * GOLDEN, 1.0)
        bx = (block.remainder(rb) * side)[:, None] + t.remainder(side)[None, :]
        by = (torch.floor(block / rb) * side)[:, None] + torch.floor(t / side)[None, :]
        x0[lo:lo + len(c)] = cx + bx * n + shift[:, None]
        y0[lo:lo + len(c)] = cy + by * n + shift[:, None]
    return x0, y0


class Tiles:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device: torch.device):
        self.cfg, self.traffic, self.device = cfg, traffic, device
        if device.type == "cuda":
            build.library()          # builds the kernels once per checkout
            # the configuration states float32 matrix products without TF32
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        if traffic["block_tiles"] ** 2 != traffic["tiles_per_call"]:
            raise ValueError("tiles_per_call must be block_tiles squared")
        self.x0, self.y0 = origins(cfg, traffic, seed, device)
        gen = torch.Generator(device=device).manual_seed(seed)
        nb = -(-cfg["erosion_iters_tt"] // cfg["erosion_batch"])
        self.angles = torch.rand((traffic["angle_pool"], nb, cfg["erosion_steps"],
                                  cfg["erosion_batch"]), generator=gen,
                                 dtype=torch.float32, device=device) * (2.0 * math.pi)
        self.world = WorldConst(mesh_x=cfg["mesh_x"], mesh_y=cfg["mesh_y"],
                                x_scene=cfg["x_scene"], y_scene=cfg["y_scene"],
                                z_scene=cfg["z_scene"])
        tcfg = TM.TerrainConfig(
            mesh_seed=cfg["mesh_seed"], mesh_scale=cfg["mesh_scale"],
            mesh_scale_z=cfg["mesh_scale_z"], mesh_height_scale=cfg["mesh_height_scale"],
            glaciate=cfg["glaciate"], glaciate_exp=cfg["glaciate_exp"],
            erode_amount=cfg["erode_amount"], water_h_off_rel=cfg["water_h_off_rel"],
            relh_adj_tex=cfg["relh_adj_tex"], mesh_freq_filter=cfg["mesh_freq_filter"])
        self.mcfg = TMOD.TileModelConfig(
            tile_size=cfg["tile_size"], cfg=tcfg, erosion_iters_tt=cfg["erosion_iters_tt"],
            erosion_batch=cfg["erosion_batch"], erosion_steps=cfg["erosion_steps"],
            use_pallas_erosion=False)
        self.table = TM.gen_table_for(tcfg, self.world, device=device)
        f32 = lambda v: torch.full((), v, dtype=torch.float32, device=device)
        self.zmax_est, self.wpz = f32(cfg["zmax_est"]), f32(cfg["water_plane_z"])
        pool = traffic["origin_pool"]
        for k in range(traffic["warm_steps"]):   # the last origins: not the window's
            self.read(self._call(pool - 1 - k))
        self.kept: dict = {}
        self.last = None
        self.items_per_step = traffic["tiles_per_call"]

    def _call(self, c: int):
        c %= self.traffic["origin_pool"]
        return TMOD.tile_batch_step(self.table, self.x0[c], self.y0[c], self.zmax_est,
                                    self.wpz, self.angles[c % self.traffic["angle_pool"]],
                                    self.mcfg, self.world)

    def call(self, i: int):
        return self._call(i)

    def read(self, out) -> float:
        return float(out.sum())

    def keep(self, i: int, out, sampled: bool) -> None:
        if sampled:
            self.kept[i] = out
        self.last = (i, out)

    def counters(self) -> dict:
        return {"erosion": EK.KERNEL.launches}

    def close(self) -> None:
        self.table = None

    def check(self, judge: str, work: bool) -> dict:
        """Readings of the program ("program") or of the control (the
        reference with TF32 noise, "control") against the reference, at
        the worst tile of the calls checked; with `work`, the erosion work
        of the kept calls."""
        cfg, pool = self.cfg, self.traffic["origin_pool"]
        ref = R.Tiles(cfg, self.device)
        calls = dict(self.kept)
        calls.setdefault(*self.last)
        worst: dict = {}
        failed = 0
        walks = []
        limits = cfg["check"]["limits"]
        for i, out in sorted(calls.items()):
            c = i % pool
            ang = self.angles[c % self.traffic["angle_pool"]]
            stats: dict | None = {} if (work and i in self.kept) else None
            args = (self.x0[c], self.y0[c], ang, cfg["zmax_est"], cfg["water_plane_z"])
            pre: list = []
            expect = ref(*args, stats=stats, pre=pre)
            cand = out if judge == "program" else ref(*args, tf32=True)
            r = R.readings(cand, expect, pre[0])
            del cand, expect, pre
            failed += any(r.get(k, 0.0) > lim for k, lim in limits.items())
            for k, v in r.items():
                worst[k] = max(worst.get(k, 0.0), v)
            if stats is not None:     # one launch per droplet batch
                side = cfg["tile_size"] + 2 * cfg["erosion_pad"]
                nb, t = ang.shape[0], out.shape[0]
                walks.append((nb * t * side * side, nb * t * cfg["erosion_batch"],
                              ang.numel(), {k: int(v) for k, v in stats.items()}))
        result = {"readings": worst, "failed": failed}
        if work:
            result["work"] = {"erosion_walk": walks}
        return result


def setup(cfg: dict, traffic: dict, seed: int, device: torch.device) -> Tiles:
    return Tiles(cfg, traffic, seed, device)

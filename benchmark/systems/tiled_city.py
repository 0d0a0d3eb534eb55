"""The system that runs the live tiled-city configurations (`tiled_city_128`): the
program's `models/world.TiledWorld` with a city from
`city/assemble.build_city` and a furnished tower of building people, its
tile manager held to `tile_budget` new tiles a frame, and the height read
under the camera.

A step is one frame: `TiledWorld.step` at the camera (the tile update,
one city frame through `city/city_step.city_frames_chained`, the people
probe's fetch and the host's reroute of the building people), then
`height_at` there; it ends in the host read of that height.  The camera
walks the stream's boustrophedon (`systems/inf_terrain.Path`) at the
traffic's `frames_per_tile`.  Set-up fills the first 3 x 3 tiles and
settles the city for `settle_steps` frames at the path's start, which
runs every shape of the window once.  The city's layout, cars,
pedestrians and tower come from the seed; each frame's draws come from
the reference's `frame_draws` of the seed and the world's frame.

The check holds the run against `reference/city.py` and
`reference/inf_terrain.py`: for the end of set-up and for each frame
drawn from the seed (the traced run: its first traced frame), copies of
the city state at that frame and `WINDOW` frames later, taken between
calls, with the paths each reroute in between applied; the reference runs
the window's frames from the first copy and is held against the second.
Windows still open when the run ends are finished after it, outside the
measured window.  Besides: the resident tile keys after every frame,
exactly, and the height read in the drawn frames.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from w3d_torch.city import assemble as CA
from w3d_torch.city import city_step as CS
from w3d_torch.city import floorplan as CF
from w3d_torch.city import room_content as CRC
from w3d_torch.models import world as W
from w3d_torch.ops.cuda import build
from w3d_torch.ops.cuda import erosion_kernel as EK
from w3d_torch.terrain import mesh as TM
from w3d_torch.terrain import tiles as TL
from w3d_torch.utils.constants import WorldConst

from benchmark.reference import city as RC
from benchmark.reference import inf_terrain as RI
from benchmark.systems import inf_terrain as SI

WINDOW = 16         # city frames the reference runs from each copy


def _copy(part) -> dict | None:
    return None if part is None else {k: v.clone() if isinstance(v, torch.Tensor) else v
                                      for k, v in part._asdict().items()}


def city_state(cs: CS.CityState) -> dict:
    """The city state as the reference takes it: dicts of copied tensors."""
    out = {k: _copy(getattr(cs, k)) for k in
           ("cars", "peds", "people", "elev", "helis", "birds", "trains")}
    out["lights"] = {"state": cs.stoplights.state.clone(), "ticks": cs.stoplights.ticks.clone()}
    return out


def layout(w: W.TiledWorld) -> dict:
    """The city's layout as the reference takes it (the tensors shared)."""
    sl = w.city.stoplights
    return {"graph": w.road_graph._asdict(), "nav": w.ped_nav._asdict(),
            "lights": {"next_state": sl.next_state, "state_time": sl.state_time,
                       "num_conn": sl.num_conn},
            "pads": w.pads, "perches": w.perches,
            "rail": None if w.rail is None else w.rail._asdict()}


class Draws:
    """The city's draws for `TiledWorld`: frame f's are the reference's
    `frame_draws(seed, f, ...)`, copied to the city's device."""

    def __init__(self, seed: int):
        self.seed = seed
        self.counts = None

    def sizes(self, w: W.TiledWorld) -> dict:
        if self.counts is None:
            cs = w.city
            n = lambda v: 0 if v is None else int(v.shape[0])
            self.counts = {"n_peds": n(cs.peds.x), "n_helis": n(cs.helis and cs.helis.px),
                           "n_pads": n(w.pads), "n_birds": n(cs.birds and cs.birds.px),
                           "n_perches": n(w.perches)}
        return self.counts

    def city(self, frame: int, frames: int, w: W.TiledWorld) -> CS.CityDraws:
        rows = [RC.frame_draws(self.seed, frame + j, **self.sizes(w)) for j in range(frames)]
        dev = w.city.peds.x.device
        return CS.CityDraws(*(torch.stack([r[f] for r in rows]).to(dev)
                              for f in CS.CityDraws._fields))


class Window:
    """City frames `first` .. `first + WINDOW - 1` of the run: the state
    before them, the reroutes after each, and the state after the last."""

    def __init__(self, first: int, start: dict):
        self.first, self.start = first, start
        self.applied: dict = {}
        self.end = None

    def covers(self, i: int) -> bool:
        return self.first <= i < self.first + WINDOW


class Walk:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device: torch.device):
        self.cfg, self.device = cfg, device
        SI._require(cfg)
        if device.type == "cuda":
            # the configuration states float32 matrix products without TF32
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        lseed = seed % 2 ** 31          # the layout's seed
        # the city first: a program that cannot build it stops before the tiles
        side = cfg["city_map"]
        cw = CA.build_city(np.zeros((side, side), np.float32), water_z=cfg["water_z"],
                           num_cities=cfg["num_cities"], num_cars=cfg["num_cars"],
                           num_peds=cfg["num_peds"], num_helis=cfg["num_helis"],
                           seed=lseed, city_size=cfg["city_size"], device=device)
        cities = len({b[4] for b in cw.net.blocks})
        if cities != cfg["num_cities"]:
            raise RuntimeError(f"the map holds {cities} cities, not {cfg['num_cities']}")
        tower = CF.gen_interior(tuple(cfg["tower_part"]), cfg["tower_floors"],
                                cfg["floor_height"], seed=lseed)
        objs = CRC.furnish_rooms(tower, cfg["floor_height"], seed=lseed)
        self.path = SI.Path(cfg, traffic, seed)
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
        self.draws = Draws(seed)
        self.world = W.make_tiled_world(mgr, cw, builders=[(tower, cfg["tower_people"], objs)],
                                        seed=lseed, chunk=1, num_birds=cfg["num_birds"],
                                        num_trains=cfg["num_trains"], draws=self.draws,
                                        device=device)
        self.world.tile_budget = cfg["tile_budget"]
        if device.type == "cuda":
            build.library()          # builds the kernels once per checkout
        self.mgr = mgr
        self.layout = layout(self.world)
        self.settle = traffic["settle_steps"]
        for _ in range(self.settle):         # the first tiles: 8, then 1
            self.world.step(*self.path(0))
        if len(mgr.tiles) != 9:
            raise RuntimeError(f"set-up left {len(mgr.tiles)} tiles resident, not 9")
        self.read(mgr.height_at(*self.path(0)))
        self.windows = [Window(0, city_state(self.world.city))]
        self.keys = [(-1, frozenset(mgr.tiles))]     # (frame, resident keys) on change
        self.heights: dict = {}     # drawn frame -> (x, y, key, height)
        self.frames = 0
        self.items_per_step = 1

    def call(self, i: int):
        x, y = self.path(i)
        self.world.step(x, y)
        return self.mgr.height_at(x, y)

    def read(self, out) -> float:
        return float(out)

    def keep(self, i: int, out, sampled: bool) -> None:
        self.frames = i + 1
        for w in self.windows:
            if w.covers(i):
                w.applied[i] = self.world.bldg.applied
                if i == w.first + WINDOW - 1:
                    w.end = city_state(self.world.city)
        if sampled:
            x, y = self.path(i)
            self.heights[i] = (x, y, RI.camera_tile(self.cfg, x, y), out)
            if not any(w.covers(i + 1) for w in self.windows):
                self.windows.append(Window(i + 1, city_state(self.world.city)))
        keys = frozenset(self.mgr.tiles)
        if keys != self.keys[-1][1]:
            self.keys.append((i, keys))

    def counters(self) -> dict:
        w = self.world
        return {**self.mgr.counts, **w.counts, **w.bldg.counts, "erosion": EK.KERNEL.launches,
                **{"city_" + k: v for k, v in CS.FRAMES.counts.items()}}

    def close(self) -> None:
        """Finish the windows still open, then let the world go."""
        while any(w.end is None for w in self.windows):
            i = self.frames
            out = self.call(i)
            self.read(out)
            self.keep(i, out, False)
        self.world = self.mgr = None

    def check(self, judge: str, work: bool) -> dict:
        """Readings of the program ("program") or of the control (the city
        reference with the cars', crowds' and movers' float state in
        bfloat16, and TF32 noise under the heights: "control") against the
        reference: the city readings of the worst window, the frames whose
        resident keys differ, and the worst height read of the drawn
        frames."""
        cfg = self.cfg
        limits = cfg["check"]["limits"]
        worst: dict = {}
        failed = 0
        for w in self.windows:
            frames = [(self._draws(self.settle + i), w.applied.get(i))
                      for i in range(w.first, w.first + WINDOW)]
            want = RC.run(self.layout, w.start, frames)
            cand = w.end if judge == "program" else RC.run(self.layout, w.start, frames,
                                                           lowp=True)
            r = RC.readings(cand, want)
            failed += any(r.get(k, 0.0) > lim for k, lim in limits.items())
            for k, v in r.items():
                worst[k] = max(worst.get(k, 0), v)
        cams = [self.path(0)] * self.settle + [self.path(i) for i in range(self.frames)]
        expect = RI.bookkeeping(cfg, cams)[self.settle:]
        resident_off = 0
        if judge == "program":
            got = self.keys[0][1]
            changes = dict(self.keys[1:])
            for i, (want, _) in enumerate(expect):
                got = changes.get(i, got)
                resident_off += got != want
        worst["resident_off"] = float(resident_off)
        failed += resident_off
        need = sorted({h[2] for h in self.heights.values()})
        h_err = 0.0
        if need:
            ref = RI.Tiles(cfg, self.device, self.angles)
            at = {k: j for j, k in enumerate(need)}
            expect_z = ref(need)["zvals"]
            cand_z = ref(need, tf32=True)["zvals"] if judge == "control" else None
            for i, (x, y, key, h) in sorted(self.heights.items()):
                want = RI.height(expect_z[at[key]], key, x, y, cfg)
                got = h if judge == "program" else RI.height(cand_z[at[key]], key, x, y, cfg)
                e = abs(float(got) - float(want))
                e = e if e == e else math.inf
                failed += e > limits.get("height_err_max", math.inf)
                h_err = max(h_err, e)
        worst["height_err_max"] = h_err
        return {"readings": worst, "failed": int(failed)}

    def _draws(self, f: int) -> dict:
        return {k: v.to(self.device) for k, v in
                RC.frame_draws(self.draws.seed, f, **self.draws.counts).items()}


def setup(cfg: dict, traffic: dict, seed: int, device: torch.device) -> Walk:
    return Walk(cfg, traffic, seed, device)

"""End-to-end world build: the whole port composed in one run (the port's
counterpart of the JAX package's `examples/full_world.py`).

Generates eroded terrain, founds cities (plots -> roads with bridges and
tunnels -> shaped buildings with interiors, furniture, people and a
basement tunnel network), runs traffic (cars, trains, helicopters) and a
chained live city frame with instanced models, plants trees, steps a
physics world, bakes a small indirect-lighting volume and a sweep, names
a star system, and exports a heightmap PNG plus an overhead map view —
the reference's startup path (3DWorld.cpp init -> gen scene -> display
loop) as one script.

    python -m w3d_torch.full_world [out_dir [city_models_config]]

prints one JSON line with the example's keys (plus `section_seconds`);
the PNGs land in out_dir (default: the system's temporary directory).
It runs on the card; `W3D_PLATFORM=cpu` asks for the CPU.  A config
file's `city *_model` rows give the instanced models (none: procedural
meshes).

Each section is a function, so a caller can feed it another section's
output (a test feeds the JAX heightmap).  The JAX example draws from
threefry keys; here every draw comes from a `WorldDraws`, whose streams
are CPU generators seeded with their numbers, so the card and the CPU
see the same values and a test's subclass can replay the JAX keys.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import time
from typing import NamedTuple

import numpy as np
import torch

from .utils.constants import WorldConst
from .terrain import mesh as TM
from .ops import erosion as E
from .city import plots as CP, roads as CR, buildings as CB
from .city import floorplan as CF, room_content as RC, people as CPE
from .city import traffic as TF
from .city import tunnels as TN
from .city import city_step as CS
from .city import model_instances as MIN
from .terrain import biomes as B
from .veg.trees import place_trees_on_tile
from .models import physics_model as PM
from .lighting import lmap as L, trace as TR, sweep as SW
from .universe import gen as UG
from .utils.rng import RandGen
from .export import heightmap_io as HIO, map_view as MV

EROSION_BATCH = 1024    # gen_terrain's droplet batch and steps
EROSION_STEPS = 256


class WorldSizes(NamedTuple):
    """The build's sizes; the defaults are the JAX example's."""

    mesh: int = 128             # world mesh_x = mesh_y
    erosion_iters: int = 20000
    num_cities: int = 2
    city_size: int = 20
    cars: int = 32
    car_steps: int = 30
    trains: int = 2
    helis: int = 4
    city_frames: int = 16
    balls: int = 2000
    phys_frames: int = 5
    substeps: int = 4
    bake_rays: int = 512
    bounces: int = 2
    sweep_dirs: int = 8
    sweep_nz: int = 16


# the example's fixed counts
PEOPLE, PEOPLE_STEPS = 8, 30        # walkers in the first building
TRAIN_STEPS, HELI_STEPS = 40, 60
PEDS = 64                           # pedestrians in the chained city frame
TREE_TILE = 64                      # trees on the map's first 64^2 cells


class WorldDraws:
    """The build's draws, which the JAX example takes from threefry keys
    (key 0 for the erosion, `fold_in(key(0), 100 + i)` for helicopter step
    i, the city state's key(4), the spheres world's key(1), key(0) for the
    bake).  Each stream here is a CPU generator seeded with its number,
    its draws copied to the device.  A caller (a test) replaces the
    methods to inject other draws."""

    EROSION, HELIS, CITY, SPAWN, BAKE = range(5)

    def _gen(self, stream: int) -> torch.Generator:
        return torch.Generator().manual_seed(stream)

    def erosion_angles(self, iters: int, device) -> torch.Tensor:
        """`gen_terrain`'s flat-spot angles [ceil(iters / 1024), 256, 1024]."""
        return E.draw_angles(iters, EROSION_BATCH, EROSION_STEPS,
                             self._gen(self.EROSION), device="cpu").to(device)

    def helis(self, steps: int, n_helis: int, n_pads: int, device):
        """Each step's new pads [steps, H] in [0, P) and waits in [30, 120)."""
        g = self._gen(self.HELIS)
        pad = torch.randint(0, max(n_pads, 1), (steps, n_helis), generator=g,
                            dtype=torch.int32)
        wait = torch.randint(30, 120, (steps, n_helis), generator=g, dtype=torch.int32)
        return pad.to(device), wait.to(device)

    def city(self, frames: int, n_peds: int, device) -> CS.CityDraws:
        return CS.draw_city(frames, n_peds, 0, 0, 0, 0, self._gen(self.CITY),
                            device=device)

    def spawn(self, n: int, device):
        """The physics world's ball positions and velocities [n, 3]."""
        pos, vel = PM.spawn(n, self._gen(self.SPAWN), device="cpu")
        return pos.to(device), vel.to(device)

    def trace(self, device) -> TR.TraceDraws:
        """The bake's ray generation and trace draws."""
        return TR.TraceDraws(self.BAKE, device, "cpu")

    def bake_rays(self, td: TR.TraceDraws, n: int, world: WorldConst) -> tuple:
        """The bake's n sky rays, made from its trace draws."""
        return TR.sky_rays(td, n, world)


def _r3(v) -> float:
    return round(float(v), 3)


def terrain_section(sizes: WorldSizes, draws: WorldDraws, world: WorldConst,
                    device: torch.device | str = "cuda") -> tuple:
    """Eroded terrain (mesh seed 7).  Returns (TerrainState, stats)."""
    cfg = TM.TerrainConfig(mesh_seed=7, erosion_iters=sizes.erosion_iters)
    ang = draws.erosion_angles(sizes.erosion_iters, device) if sizes.erosion_iters else None
    ts = TM.gen_terrain(cfg, world, angles=ang, device=device)
    hm = ts.mesh_height
    return ts, {"z_range": [_r3(hm.min()), _r3(hm.max())],
                "water_z": _r3(ts.water_plane_z)}


class CityBuild(NamedTuple):
    hm: torch.Tensor        # the heightmap after city flattening and road carving
    plots: list
    net: object
    routes: list
    bridges: list
    tunnels: list
    buildings: list
    bsegs: list             # the basement tunnel network's segments
    people: object          # the first building's walkers (CPE.PeopleState)


def city_section(hm, water_z, sizes: WorldSizes, world: WorldConst,
                 device: torch.device | str = "cuda") -> tuple:
    """Plots -> flatten -> roads (+bridges/tunnels) -> buildings, the
    first building's interior, furniture, labels and walkers, and a
    basement tunnel network.  Returns (CityBuild, {"city": ...,
    "first_building": ...})."""
    hm, plots = CP.gen_cities(hm, water_z, num_cities=sizes.num_cities,
                              city_size=sizes.city_size)
    net = CR.gen_city_roads(plots)
    routes = CR.gen_connector_roads(plots, net)
    hm, bridges, tunnels = CR.carve_roads_with_structures(hm, routes, plots)
    blocks = [(p.x1 + 2, p.y1 + 2, p.x2 - 2, p.y2 - 2, i)
              for i, p in enumerate(plots)]
    hm_np = hm.cpu().numpy()

    def elev(x, y):
        return float(hm_np[min(int(y), world.mesh_y - 1),
                           min(int(x), world.mesh_x - 1)])

    bl = CB.place_buildings_in_blocks(blocks, elev, CB.BuildingParams(),
                                      seed=3, cell_w=1.0)
    n_round = sum(b.is_round for b in bl)
    stats = {}
    # interiors + furniture + people for the first building
    interiors = 0
    people = None
    for b in bl:
        (x1, y1, z1, x2, y2, z2) = b.parts[0]
        if x2 - x1 < 3 or y2 - y1 < 3:
            continue
        i = CF.gen_interior((x1, y1, z1, x2, y2, z2), 3, 0.8, seed=11,
                            has_basement=(people is None))
        b.interior = i
        interiors += 1
        if people is None and i.rooms:
            ro = RC.furnish_rooms(i, 0.8, 11)
            g = CPE.build_nav_graph(i)
            people = CPE.make_people(g, PEOPLE, seed=4, device=device)
            for _ in range(PEOPLE_STEPS):
                people = CPE.step_people(people)
            labels, signs = RC.label_objects(i, ro, seed=4)
            stats["first_building"] = {
                "rooms": len(i.rooms), "furniture": len(ro.cubes),
                "people_walking": PEOPLE,
                "name": RC.building_name(RC.BT_OFFICE, 4),
                "door_signs": len(signs), "book_titles": len(labels)}
    # basement tunnel network under the first (basement) building
    # (building_tunnels.cpp) + clocks placed by the furnishing pass
    bsegs = []
    for b in bl:
        inter = getattr(b, "interior", None)
        if inter is not None and any(r.floor < 0 for r in inter.rooms):
            bsegs = TN.gen_tunnels(b, bl, 0.8, seed=11)
            if bsegs:
                p0 = b.parts[0]
                TN.add_tunnel_objects(bsegs, (p0[0], p0[1], p0[3], p0[4]),
                                      seed=11, ground_z=p0[2])
                break
    stats["city"] = {"plots": len(plots), "road_segs": len(net.segs),
                     "bridges": len(bridges), "tunnels": len(tunnels),
                     "buildings": len(bl), "round_buildings": int(n_round),
                     "interiors": interiors,
                     "basement_tunnel_segs": len(bsegs),
                     "basement_tunnel_gates": sum(1 for s in bsegs if s.has_gate)}
    return CityBuild(hm, plots, net, routes, bridges, tunnels, bl, bsegs, people), stats


class Traffic(NamedTuple):
    graph: object
    cars: object
    trains: object
    rail: object
    helis: object
    pads: object


def traffic_section(cb: CityBuild, sizes: WorldSizes, draws: WorldDraws,
                    device: torch.device | str = "cuda") -> tuple:
    """Cars, trains on the first connector route, helicopters between the
    roof pads.  Returns (Traffic, stats)."""
    graph = TF.build_road_graph(cb.net, device=device)
    cars = TF.make_cars(sizes.cars, graph, seed=5)
    for _ in range(sizes.car_steps):
        cars = TF.step_cars(cars, graph)
    trains = rail = None
    n_trains = 0
    if cb.routes:
        r0 = cb.routes[0]
        rail = TF.gen_railroad([(r0[0], r0[1]), (r0[2], r0[3])], device=device)
        trains = TF.make_trains(sizes.trains, 1, seed=6, device=device)
        for _ in range(TRAIN_STEPS):
            trains = TF.step_trains(trains, rail)
        n_trains = sizes.trains
    pads_np = TF.make_helipads(cb.buildings)
    helis = pads = None
    if len(pads_np):
        pads = torch.as_tensor(pads_np, device=device)
        helis = TF.make_helis(sizes.helis, pads_np, seed=2, device=device)
        new_pad, new_wait = draws.helis(HELI_STEPS, sizes.helis, len(pads_np), device)
        for i in range(HELI_STEPS):
            helis = TF.step_helis(helis, pads, new_pad[i], new_wait[i])
    return Traffic(graph, cars, trains, rail, helis, pads), \
        {"cars": sizes.cars, "trains": n_trains, "helipads": int(len(pads_np))}


def city_frame_section(cb: CityBuild, tr: Traffic, sizes: WorldSizes,
                       draws: WorldDraws, specs: dict,
                       device: torch.device | str = "cuda") -> tuple:
    """The chained live city frame (stoplights, cars, pedestrians, one
    elevator car) and the instanced models it drives.  Returns
    (CityState, instances, stats)."""
    sl = TF.build_stoplights(cb.net, seed=5, device=device)
    nav = TF.build_ped_nav(cb.net, device=device)
    peds = TF.make_peds(PEDS, cb.net.blocks, seed=7, device=device)
    cstate = CS.CityState(stoplights=sl, cars=tr.cars, peds=peds, people=None,
                          elev=CS.make_elevator_bank(1, device=device),
                          helis=None, birds=None)
    cstate = CS.city_frames_chained(cstate, tr.graph, nav, None, None, sizes.city_frames,
                                    draws.city(sizes.city_frames, PEDS, device))
    inst = MIN.city_instances(cars=cstate.cars, graph=tr.graph, peds=cstate.peds,
                              specs=specs, seed=4)
    return cstate, inst, {
        "chained": sizes.city_frames, "instanced_models": len(inst),
        "instances": int(sum(s.transforms.shape[0] for s in inst))}


def vegetation_section(hm: torch.Tensor, world: WorldConst) -> tuple:
    """Trees on the map's first tile, the biomes banded over this
    terrain's own relief (the absolute bands put low-lying beach terrain
    all in sand, which is correct but treeless).  Returns ((x, y, z,
    type, valid), stats)."""
    tile_z = hm[:TREE_TILE, :TREE_TILE]
    ones = torch.ones_like(tile_z)
    wts = B.biome_weights(tile_z, ones, float(hm.min()), float(hm.max()))
    trees = place_trees_on_tile(9, -2.0, -2.0, tile_z, ones, wts, world)
    return trees, {"trees": int(trees[4].sum())}


def physics_section(sizes: WorldSizes, draws: WorldDraws, world: WorldConst,
                    device: torch.device | str = "cuda") -> tuple:
    """The spheres world's balls for a few frames.  Returns (SpheresWorld
    after the frames, stats)."""
    pos, vel = draws.spawn(sizes.balls, device)
    sw = PM.build_spheres_world(pos, vel, world=world, device=device)
    for _ in range(sizes.phys_frames):
        sw = PM.frame_step(sw, substeps=sizes.substeps, world=world)
    return sw, {"objects": sizes.balls, "live": int((sw.state.status > 0).sum())}


def lighting_section(sw, hm: torch.Tensor, sizes: WorldSizes, draws: WorldDraws,
                     world: WorldConst, device: torch.device | str = "cuda") -> tuple:
    """A small sky bake over the carved heightmap.  Returns (LightGrid,
    stats)."""
    grid = L.make_light_grid(world, device=device)
    td = draws.trace(device)
    rays = draws.bake_rays(td, sizes.bake_rays, world)
    grid = TR.trace_batch(grid, sw.cobjs.cobjs, hm.to(torch.float32), *rays, td,
                          params=TR.TraceParams(max_bounces=sizes.bounces,
                                                samples_per_segment=4, mesh_steps=8),
                          world=world)
    return grid, {"sky_energy": round(float(grid.sc_r.sum()), 4)}


def sweep_section(sw, hm: torch.Tensor, sizes: WorldSizes, world: WorldConst,
                  device: torch.device | str = "cuda") -> tuple:
    """The dense sweep solver's sky visibility.  Returns (LightGrid, stats)."""
    sgrid = L.make_light_grid(world, nz=sizes.sweep_nz, device=device)
    sgrid = SW.compute_sky_lighting_sweep(sgrid, sw.cobjs.cobjs, hm.to(torch.float32),
                                          ndirs=sizes.sweep_dirs, world=world, bounce=False)
    return sgrid, {"mean_visibility": round(float(sgrid.sv.mean()), 3)}


def universe_section() -> tuple:
    """A named star system.  Returns (System, stats)."""
    sy = UG.gen_system(RandGen(3, 5), (1.0, 2.0, 3.0))
    return sy, {"system": UG.system_name(sy),
                "planets": [UG.planet_name(p) for p in sy.planets]}


def map_image(hm: torch.Tensor, water_z, net, buildings, world: WorldConst) -> np.ndarray:
    """The overhead map [my, mx, 3] uint8: terrain bands with the roads
    and buildings stamped on."""
    img = MV.terrain_map(hm, water_z, float(hm.min()), float(hm.max()))
    img = MV.overlay_roads_buildings(img, net.seg_array(),
                                     CB.building_part_array(buildings), world)
    return np.transpose(np.clip(img * 255, 0, 255).astype(np.uint8), (1, 2, 0))


def export_section(out_dir: str, hm: torch.Tensor, water_z, net, buildings,
                   world: WorldConst) -> tuple:
    """world_height.png (16-bit) and world_map.png in `out_dir`.  Returns
    (the file names, the map image)."""
    os.makedirs(out_dir, exist_ok=True)
    hm16 = HIO.heights_to_pixels(hm.cpu().numpy(), bit_depth=16)
    HIO.write_png_gray(os.path.join(out_dir, "world_height.png"), hm16)
    rgb = map_image(hm, water_z, net, buildings, world)
    HIO.write_png_rgb(os.path.join(out_dir, "world_map.png"), rgb)
    return ["world_height.png", "world_map.png"], rgb


class World(NamedTuple):
    """What `main` built, section by section."""

    terrain: object         # TM.TerrainState
    city: CityBuild
    traffic: Traffic
    city_state: object      # CS.CityState after the chained frames
    instances: list         # MIN.InstanceSet per instanced model
    trees: tuple            # (x, y, z, type, valid)
    spheres: object         # PM.SpheresWorld after the frames
    bake: object            # L.LightGrid of the sky bake
    sweep: object           # L.LightGrid of the sweep
    system: object          # UG.System
    map_rgb: np.ndarray     # the exported map image


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def main(out_dir: str | None = None, sizes: WorldSizes = WorldSizes(),
         draws: WorldDraws | None = None, specs_path: str | None = None,
         device: torch.device | str = "cuda", after_section=None) -> tuple:
    """Build the whole world on `device`; print the stats and return
    (stats, World).  `specs_path`: a config file with `city *_model` rows
    (None: no specs, procedural meshes).  `after_section(name)`, if given,
    runs after each section, once its work on the device has finished."""
    t0 = time.time()
    out_dir = out_dir if out_dir is not None else tempfile.gettempdir()
    draws = draws if draws is not None else WorldDraws()
    world = WorldConst(mesh_x=sizes.mesh, mesh_y=sizes.mesh)
    stats = {}
    secs = {}

    def timed(name, fn):
        _sync(device)
        t = time.perf_counter()
        r = fn()
        _sync(device)
        secs[name] = time.perf_counter() - t
        if after_section is not None:
            after_section(name)
        return r

    ts, stats["terrain"] = timed("terrain", lambda: terrain_section(sizes, draws, world, device))
    cb, cstats = timed("city", lambda: city_section(ts.mesh_height, ts.water_plane_z, sizes,
                                                    world, device))
    stats.update(cstats)
    tr, stats["traffic"] = timed("traffic", lambda: traffic_section(cb, sizes, draws, device))
    specs = (MIN.parse_city_models(specs_path)
             if specs_path is not None and os.path.exists(specs_path) else {})
    cs, inst, stats["city_frame"] = timed("city_frame", lambda: city_frame_section(
        cb, tr, sizes, draws, specs, device))
    trees, stats["vegetation"] = timed("vegetation", lambda: vegetation_section(cb.hm, world))
    sw, stats["physics"] = timed("physics", lambda: physics_section(sizes, draws, world, device))
    grid, stats["lighting"] = timed("lighting", lambda: lighting_section(
        sw, cb.hm, sizes, draws, world, device))
    sgrid, stats["sweep_lighting"] = timed("sweep", lambda: sweep_section(
        sw, cb.hm, sizes, world, device))
    sy, stats["universe"] = timed("universe", universe_section)
    stats["artifacts"], rgb = timed("export", lambda: export_section(
        out_dir, cb.hm, ts.water_plane_z, cb.net, cb.buildings, world))
    stats["seconds"] = round(time.time() - t0, 1)
    stats["section_seconds"] = {k: round(v, 4) for k, v in secs.items()}
    print(json.dumps(stats), flush=True)
    return stats, World(ts, cb, tr, cs, inst, trees, sw, grid, sgrid, sy, rgb)


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else None,
         specs_path=sys.argv[2] if len(sys.argv) > 2 else None,
         device="cpu" if os.environ.get("W3D_PLATFORM") == "cpu" else "cuda")

"""Build one full live city from a heightmap (port of
`3dworld_tpu/city/assemble.py`): plots -> roads -> graph -> stoplights ->
cars/peds/trains/helis (gen_cities + car_manager_t::init +
ped_manager_t::init, city_gen.cpp).

`city_frame` advances everything one frame — the reference's
next_city_frame 3-thread OMP split (cars / peds / birds+details,
display_world.cpp:1295-1309) as sequential steps.  With
`interiors=True` every building gets its floorplan and the buildings
with basements grow tunnel networks with street manholes
(`city/tunnels`, host code).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from . import plots as CP, roads as CR, traffic as CT, buildings as CB
from . import structures as CS
from . import floorplan as CF
from . import tunnels as TN


@dataclass
class CityWorld:
    net: object
    graph: object
    stoplights: object
    cars: object
    peds: object
    ped_nav: object
    buildings: list = field(default_factory=list)
    helis: object = None
    helipads: object = None
    skyways: list = field(default_factory=list)   # structures.Skyway
    power: object = None                          # structures.PowerLines
    ug_elevators: list = field(default_factory=list)
    tunnels: list = field(default_factory=list)   # (building_ix, [TunnelSeg])
    manholes: list = field(default_factory=list)  # (x, y, radius)
    frame: int = 0


def build_city(heightmap, water_z: float = -0.5, num_cities: int = 2,
               num_cars: int = 256, num_peds: int = 512,
               num_helis: int = 4, seed: int = 0,
               interiors: bool = False, city_size: int = 24,
               device: torch.device | str = "cuda") -> CityWorld:
    """The city's host layout (plots, roads, buildings, structures; with
    `interiors`, floorplans, basement tunnels and manholes) and its device
    state (graph, stoplights, cars, peds, helicopters) on `device`.  Each
    city is a `city_size`-cell square plot (`plots.gen_cities`)."""
    _hm, plots = CP.gen_cities(heightmap, water_z, num_cities=num_cities,
                               city_size=city_size, seed=seed)
    net = CR.gen_city_roads(plots)
    graph = CT.build_road_graph(net, device=device)
    sl = CT.build_stoplights(net, seed=seed, device=device)
    spots = CT.gen_parking_spots(net.blocks)
    cars = CT.make_cars(num_cars, graph, seed=seed, spots=spots, parked_frac=0.3)
    nav = CT.build_ped_nav(net, device=device)
    peds = CT.make_peds(num_peds, net.blocks, seed=seed + 1, device=device)
    params = CB.BuildingParams()
    bl = CB.place_buildings_in_blocks(net.blocks, lambda x, y: 0.0, params,
                                      seed=seed)
    if interiors and bl:
        CF.gen_building_interiors(bl, params, seed=seed)
    helis = None
    pads = None
    if bl and num_helis > 0:
        pads_np = CT.make_helipads(bl)
        pads = torch.as_tensor(pads_np, device=device)
        if pads_np.shape[0] > 0:
            helis = CT.make_helis(num_helis, pads_np, seed=seed, device=device)
    # plot-spanning structures: skyways between tall buildings, power
    # poles + wires along roads, underground parking elevators
    # (city_obj_placer.cpp skyway/power/ug_elevator placement)
    skyways = CS.place_skyways(bl)
    power = CS.place_power_lines(net)
    ug = CS.place_ug_elevators(net.blocks, seed=seed)
    # basement tunnel networks under buildings with basements
    # (building_tunnels.cpp; grown off the basement room's end wall)
    tunnels, manholes = [], []
    if interiors:
        for bi, b in enumerate(bl):
            segs = TN.gen_tunnels(b, bl, params.floor_height, seed=seed + bi)
            if segs:
                p0 = b.parts[0]
                _, mh = TN.add_tunnel_objects(
                    segs, (p0[0], p0[1], p0[3], p0[4]), seed=seed + bi,
                    ground_z=p0[2])
                tunnels.append((bi, segs))
                manholes.extend(mh)
    return CityWorld(net=net, graph=graph, stoplights=sl, cars=cars,
                     peds=peds, ped_nav=nav, buildings=bl,
                     helis=helis, helipads=pads,
                     skyways=skyways, power=power, ug_elevators=ug,
                     tunnels=tunnels, manholes=manholes)


def city_frame(cw: CityWorld, ped_draws: CT.PedDraws,
               heli_draws=None) -> CityWorld:
    """One city frame: stoplights + cars + peds (+ helicopters, with
    `heli_draws` = (new_pad, new_wait)).  The JAX frame draws from keys
    folded with the frame count; here the draws are inputs."""
    cw.stoplights = CT.step_stoplights(cw.stoplights)
    cw.cars = CT.step_cars(cw.cars, cw.graph, stoplights=cw.stoplights)
    cw.peds = CT.step_peds(cw.peds, ped_draws, nav=cw.ped_nav,
                           stoplights=cw.stoplights)
    if cw.helis is not None:
        cw.helis = CT.step_helis(cw.helis, cw.helipads, *heli_draws)
    cw.frame += 1
    return cw

"""City street objects: the detail-object catalog + placer (port of
`3dworld_tpu/city/objects.py`, host numpy code copied whole).

The reference places ~40 detail object types in city plots, along
sidewalks and on the road surface (`city_obj_placer.cpp` 3586 LoC,
city_objects.h:92-493) with per-type spacing/orientation rules and
blocker-based rejection (`check_pt_and_place_blocker`,
city_obj_placer.cpp:525-537).

Here: a seeded placer emitting a typed SoA set over a kind catalog that
mirrors the reference's object breadth — roadside objects spaced along
segments, road-surface objects on the centerline, plot objects
scattered with blocker rejection, residential-yard objects, and plot
dividers along block edges.  Each kind carries a footprint radius +
height for collision/export.  `objects_to_cobjs` packs them as the
port's `CobjSet` on a device.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..utils.rng import RandGen

# kind catalog (city_objects.h structs); (name, radius, height, category)
# categories: road = sidewalk edge, surf = road surface, plot = public
# block, yard = residential block, edge = along plot boundary
KIND_TABLE = (
    ("bench",         0.25, 0.30, "plot"),    # bench_t
    ("trashcan",      0.15, 0.40, "plot"),    # trashcan_t
    ("fountain",      0.60, 0.80, "plot"),    # fountain_t
    ("planter",       0.30, 0.25, "plot"),    # tree_planter_t
    ("streetlight",   0.08, 1.60, "road"),
    ("hydrant",       0.10, 0.35, "road"),    # fire_hydrant_t
    ("sign",          0.06, 1.00, "road"),
    ("power_pole",    0.10, 2.00, "road"),    # power_pole_t
    ("mailbox",       0.10, 0.45, "road"),    # mailbox_t
    ("manhole",       0.20, 0.01, "surf"),    # manhole_t
    ("street_sewer",  0.20, 0.02, "surf"),    # street_sewer_t
    ("traffic_cone",  0.08, 0.20, "surf"),    # traffic_cone_t
    ("substation",    0.50, 0.60, "plot"),    # substation_t
    ("statue",        0.40, 1.00, "plot"),    # statue_t
    ("sculpture",     0.40, 1.20, "plot"),    # sculpture_t
    ("wfountain",     0.12, 0.35, "plot"),    # drinking wfountain_t
    ("bicycle",       0.15, 0.30, "road"),    # bicycle_t
    ("dumpster",      0.45, 0.50, "plot"),    # dumpster_t
    ("picnic_table",  0.45, 0.30, "plot"),    # picnic_t
    ("bb_hoop",       0.15, 1.20, "yard"),    # bb_hoop_t
    ("swingset",      0.60, 0.90, "yard"),    # swingset_t
    ("trampoline",    0.55, 0.30, "yard"),    # trampoline_t
    ("swimming_pool", 0.90, 0.15, "yard"),    # swimming_pool_t
    ("deck_chair",    0.25, 0.20, "yard"),    # deck_chair_t
    ("beach_ball",    0.10, 0.10, "yard"),    # beach_ball_t
    ("umbrella",      0.35, 0.80, "yard"),    # umbrella_t
    ("potted_plant",  0.12, 0.30, "yard"),    # potted_plant_t
    ("flower_bed",    0.25, 0.10, "yard"),    # flower_t
    ("pond",          0.80, 0.05, "plot"),    # pond_t
    ("divider",       0.06, 0.40, "edge"),    # divider_t (fence/hedge/wall)
    ("pillar",        0.12, 1.50, "plot"),    # pillar_t (walkway support)
    ("parking_solar", 0.70, 0.70, "plot"),    # parking_solar_t canopy
    ("flag",          0.06, 1.80, "plot"),    # city_flag_t (pole + flag)
    ("clothesline",   0.40, 0.80, "yard"),    # clothesline_t (poles + line)
    ("stopsign",      0.06, 0.90, "isec"),    # stopsign_t
    ("newsrack",      0.12, 0.40, "isec"),    # newsrack_t (clustered)
    ("gas_canopy",    0.25, 1.00, "gas"),     # gas_station_t support column
    ("gas_pump",      0.12, 0.50, "gas"),     # gas_pump_t
    ("parking_gate",  0.35, 0.40, "lot"),     # parking_gate_t (lot entry)
    ("park_path",     0.20, 0.02, "park"),    # park_path_t stepping stones
    ("park_rock",     0.30, 0.25, "park"),    # park_rock_t
    ("park_fountain", 0.15, 0.40, "park"),    # park_water_fountain_t
    ("pool_ladder",   0.08, 0.25, "pool"),    # pool_ladder_t
    ("pool_float",    0.15, 0.08, "pool"),    # pool_float_t
    ("pool_deck",     0.50, 0.10, "pool"),    # pool_deck_t
    ("wind_turbine",  0.25, 2.50, "rare"),    # wind_turbine_t
)
KIND_NAMES = tuple(k[0] for k in KIND_TABLE)
KIND_INDEX = {k[0]: i for i, k in enumerate(KIND_TABLE)}
NUM_KINDS = len(KIND_TABLE)
KIND_RADIUS = np.asarray([k[1] for k in KIND_TABLE], np.float32)
KIND_HEIGHT = np.asarray([k[2] for k in KIND_TABLE], np.float32)

# backwards-compatible aliases for the original 8-kind API
(OBJ_BENCH, OBJ_TRASHCAN, OBJ_FOUNTAIN, OBJ_PLANTER) = (
    KIND_INDEX["bench"], KIND_INDEX["trashcan"], KIND_INDEX["fountain"],
    KIND_INDEX["planter"])
(OBJ_STREETLIGHT, OBJ_HYDRANT, OBJ_SIGN, OBJ_POWER_POLE) = (
    KIND_INDEX["streetlight"], KIND_INDEX["hydrant"], KIND_INDEX["sign"],
    KIND_INDEX["power_pole"])

_ROAD = tuple(i for i, k in enumerate(KIND_TABLE) if k[3] == "road")
_SURF = tuple(i for i, k in enumerate(KIND_TABLE) if k[3] == "surf")
_PLOT = tuple(i for i, k in enumerate(KIND_TABLE) if k[3] == "plot")
_YARD = tuple(i for i, k in enumerate(KIND_TABLE) if k[3] == "yard")


class CityObjects(NamedTuple):
    x: np.ndarray
    y: np.ndarray
    kind: np.ndarray
    rot: np.ndarray

    @property
    def radius(self):
        return KIND_RADIUS[self.kind]

    @property
    def height(self):
        return KIND_HEIGHT[self.kind]


def place_city_objects(net, buildings, seed: int = 1,
                       roadside_spacing: float = 6.0,
                       per_block: int = 6,
                       residential_frac: float = 0.4,
                       park_frac: float = 0.25) -> CityObjects:
    """Place detail objects: roadside kinds spaced along segments
    (alternating sides), road-surface kinds sparsely on centerlines,
    plot/yard kinds inside blocks with blocker rejection against
    buildings and each other, dividers along residential block edges
    (city_obj_placer::place_detail_objects semantics).

    Structured rules beyond the uniform pools (city_obj_placer.cpp):
    stop signs at non-stoplight intersection corners (place_stopsigns),
    newsrack clusters near intersections (add_objs_on_building_sides
    analog), one gas station per city (canopy columns + pump row,
    gas_station_t / gas_pump_t), park blocks with stepping-stone paths,
    rocks and drinking fountains (park_path_t/park_rock_t), swimming
    pools gain adjacent ladder/float/deck accessories (pool_ladder_t,
    pool_float_t, pool_deck_t), parking-lot entry gates
    (parking_gate_t) and rare wind turbines on commercial blocks."""
    rg = RandGen(seed + 21, 2 * seed + 5)
    xs, ys, kinds, rots = [], [], [], []
    bparts = [b.parts[0] for b in buildings] if buildings else []
    blockers = []

    def hits_building(x, y, r):
        return any(p[0] - r <= x <= p[3] + r and p[1] - r <= y <= p[4] + r
                   for p in bparts)

    def blocked(x, y, r):
        # check_pt_and_place_blocker: keep objects apart
        return any((x - bx) ** 2 + (y - by) ** 2 < (r + br) ** 2
                   for (bx, by, br) in blockers)

    def try_place(x, y, kind):
        r = float(KIND_RADIUS[kind])
        if hits_building(x, y, r) or blocked(x, y, r):
            return False
        xs.append(x)
        ys.append(y)
        kinds.append(kind)
        rots.append(2 * np.pi * rg.randd())
        blockers.append((x, y, r))
        return True

    for s in net.segs:
        length = max(abs(s.x2 - s.x1), abs(s.y2 - s.y1))
        n = int(length // roadside_spacing)
        for i in range(n):
            t = (i + 0.5) / max(n, 1)
            x = s.x1 + t * (s.x2 - s.x1)
            y = s.y1 + t * (s.y2 - s.y1)
            side = 1.0 if (i % 2 == 0) else -1.0   # alternate sides
            kind = _ROAD[rg.rand() % len(_ROAD)]
            if s.dim == 0:
                yy, xx = y + side * (s.width * 0.8), x
            else:
                xx, yy = x + side * (s.width * 0.8), y
            if try_place(xx, yy, kind):
                rots[-1] = 0.0 if s.dim == 0 else np.pi / 2
            # occasional road-surface object on the centerline
            if rg.rand() % 5 == 0:
                try_place(x, y, _SURF[rg.rand() % len(_SURF)])

    # intersections: stop signs on the diagonal corners of non-stoplight
    # crossings (stopsign_t), newsrack clusters of 1-3 beside every 3rd
    # intersection (newsrack_t)
    ss, nr = KIND_INDEX["stopsign"], KIND_INDEX["newsrack"]
    for j, isec in enumerate(getattr(net, "isecs", ())):
        off = 0.9
        if not isec.has_stoplight:
            try_place(isec.x + off, isec.y + off, ss)
            try_place(isec.x - off, isec.y - off, ss)
        if j % 3 == 0:
            n = 1 + rg.rand() % 3
            for i in range(n):
                try_place(isec.x + off + 0.30 * i, isec.y - off, nr)

    gas_done = set()        # one gas station per city
    turbine_done = set()
    for (x1, y1, x2, y2, city) in net.blocks:
        residential = rg.randd() < residential_frac
        park = (not residential) and rg.randd() < park_frac
        cx, cy = 0.5 * (x1 + x2), 0.5 * (y1 + y2)
        if park:
            # park block: stepping-stone path along the diagonal, rocks,
            # a drinking fountain, benches (park_path_t/park_rock_t/
            # park_water_fountain_t placement in place_residential_plot)
            diag = np.hypot(x2 - x1, y2 - y1)
            n = max(int(diag / 0.55), 2)
            for i in range(n):
                t = (i + 0.5) / n
                try_place(x1 + t * (x2 - x1), y1 + t * (y2 - y1),
                          KIND_INDEX["park_path"])
            for _ in range(2):
                try_place(x1 + rg.randd() * (x2 - x1),
                          y1 + rg.randd() * (y2 - y1),
                          KIND_INDEX["park_rock"])
            try_place(cx + 0.8, cy, KIND_INDEX["park_fountain"])
            try_place(cx - 0.9, cy + 0.6, KIND_INDEX["bench"])
            continue
        if not residential and city not in gas_done:
            # gas station claims the first commercial block with room: a
            # row of 4 pumps with canopy support columns at both ends
            # (gas_station_t); the row hugs the block's -y edge so it
            # coexists with a building deeper in the plot
            gy = y1 + 0.45
            placed = sum(try_place(cx - 0.55 + 0.36 * i, gy,
                                   KIND_INDEX["gas_pump"]) for i in range(4))
            if placed >= 2:
                gas_done.add(city)
                try_place(cx - 1.1, gy, KIND_INDEX["gas_canopy"])
                try_place(cx + 1.1, gy, KIND_INDEX["gas_canopy"])
                try_place(x1 + 0.5, cy, KIND_INDEX["parking_gate"])
                continue
        pool = _YARD if residential else _PLOT
        for _ in range(per_block):
            x = x1 + rg.randd() * max(x2 - x1, 0.1)
            y = y1 + rg.randd() * max(y2 - y1, 0.1)
            kind = pool[rg.rand() % len(pool)]
            if try_place(x, y, kind) and kind == KIND_INDEX["swimming_pool"]:
                # pool accessories hug the pool footprint (pool_ladder_t
                # at the edge, pool_float_t beside, pool_deck_t alongside)
                rp = float(KIND_RADIUS[kind])
                try_place(x + rp + 0.10, y, KIND_INDEX["pool_ladder"])
                try_place(x, y + rp + 0.17, KIND_INDEX["pool_float"])
                try_place(x - rp - 0.52, y, KIND_INDEX["pool_deck"])
        if residential:
            # dividers (fence/hedge) along the block's -y edge
            n = max(int((x2 - x1) / 1.0), 1)
            for i in range(n):
                try_place(x1 + (i + 0.5) * (x2 - x1) / n, y1 + 0.2,
                          KIND_INDEX["divider"])
        elif city not in turbine_done and rg.rand() % 4 == 0:
            # rare wind turbine on a commercial block corner
            turbine_done.add(city)
            try_place(x2 - 0.6, y2 - 0.6, KIND_INDEX["wind_turbine"])
    return CityObjects(
        x=np.asarray(xs, np.float32), y=np.asarray(ys, np.float32),
        kind=np.asarray(kinds, np.int32), rot=np.asarray(rots, np.float32))


def objects_to_cobjs(objs: CityObjects, ground_z: float = 0.0,
                     device: torch.device | str = "cuda"):
    """Register objects as collision cylinders (the reference adds each
    placed object to `colliders`), packed on `device`."""
    from ..scene import cobj as SC
    from ..physics.cobjs import COLL_CYLINDER
    sp = SC.SceneParse()
    for i in range(len(objs.x)):
        r = float(KIND_RADIUS[objs.kind[i]])
        h = float(KIND_HEIGHT[objs.kind[i]])
        sp.cobjs.append(SC.RawCobj(
            COLL_CYLINDER,
            (float(objs.x[i]), float(objs.y[i]), ground_z),
            (float(objs.x[i]), float(objs.y[i]), ground_z + h),
            r1=r, r2=r))
    return SC.pack_cobjs(sp, device=device)

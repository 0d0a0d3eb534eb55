"""Road networks: city grid roads, connector roads, intersections (port of
`3dworld_tpu/city/roads.py`, host code; the carving runs on the
heightmap's device).

The reference builds per-city grid road networks plus global connector
roads with legal-grade search, bridges/tunnels and stoplight
intersections (`road_network_t`, city_gen.cpp:440-1099, roads.cpp).

Here: grid roads subdivide each city plot into blocks; intersections are
the grid crossings with 2-phase stoplight cycles; connector roads join
city pairs with an L-shaped path (grade-legalized by flattening along the
route).  Everything is emitted as SoA arrays usable by the traffic sim
and heightmap carving.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import NamedTuple

import numpy as np
import torch

from .plots import CityPlot


def _np_map(heightmap) -> np.ndarray:
    """A heightmap (numpy or tensor) as a host array."""
    if isinstance(heightmap, torch.Tensor):
        return heightmap.cpu().numpy()
    return np.asarray(heightmap)


def _as_map(heightmap) -> torch.Tensor:
    """A heightmap (numpy or tensor) as a float32 tensor."""
    if isinstance(heightmap, torch.Tensor):
        return heightmap.to(torch.float32)
    return torch.as_tensor(np.asarray(heightmap, np.float32))


class RoadSeg(NamedTuple):
    x1: float
    y1: float
    x2: float
    y2: float
    width: float
    city: int       # -1 for connector roads
    dim: int        # 0 = x-aligned, 1 = y-aligned


class Intersection(NamedTuple):
    x: float
    y: float
    city: int
    roads: tuple    # road segment indices meeting here
    has_stoplight: bool


@dataclass
class RoadNetwork:
    segs: list = field(default_factory=list)
    isecs: list = field(default_factory=list)
    blocks: list = field(default_factory=list)  # (x1,y1,x2,y2,city) building plots

    def seg_array(self):
        if not self.segs:
            return np.zeros((0, 5), np.float32)
        return np.array([(s.x1, s.y1, s.x2, s.y2, s.width) for s in self.segs],
                        np.float32)


def gen_city_roads(plots: list[CityPlot], block_size: int = 8,
                   road_width: float = 1.0) -> RoadNetwork:
    """Grid roads inside each city plot; blocks between roads become
    building plots (road_network_t::gen_roads semantics)."""
    net = RoadNetwork()
    for ci, p in enumerate(plots):
        xs = list(range(p.x1, p.x2 + 1, block_size)) + [p.x2]
        ys = list(range(p.y1, p.y2 + 1, block_size)) + [p.y2]
        xs = sorted(set(xs))
        ys = sorted(set(ys))
        for y in ys:  # x-aligned roads
            net.segs.append(RoadSeg(p.x1, y, p.x2, y, road_width, ci, 0))
        for x in xs:  # y-aligned roads
            net.segs.append(RoadSeg(x, p.y1, x, p.y2, road_width, ci, 1))
        base = len(net.segs) - len(xs) - len(ys)
        for yi_, y in enumerate(ys):
            for xi_, x in enumerate(xs):
                net.isecs.append(Intersection(
                    float(x), float(y), ci,
                    (base + yi_, base + len(ys) + xi_),
                    has_stoplight=(0 < yi_ < len(ys) - 1 and 0 < xi_ < len(xs) - 1)))
        for yi_ in range(len(ys) - 1):
            for xi_ in range(len(xs) - 1):
                net.blocks.append((xs[xi_] + 1, ys[yi_] + 1,
                                   xs[xi_ + 1] - 1, ys[yi_ + 1] - 1, ci))
    return net


def _route_cost(heightmap, x1, y1, x2, y2, water_z=None):
    """Connector legality/cost along a straight leg: total height
    adjustment the road grading would need (the reference's connector
    cost = terrain delta smoothed to road grade), illegal (inf) when the
    leg leaves the map or runs through deep water."""
    hm = _np_map(heightmap)
    my, mx = hm.shape
    if not (0 <= x1 < mx and 0 <= x2 < mx and 0 <= y1 < my and 0 <= y2 < my):
        return float("inf")
    n = max(int(abs(x2 - x1) + abs(y2 - y1)), 1)
    ts = np.linspace(0.0, 1.0, n + 1)
    xs = np.clip(np.round(x1 + ts * (x2 - x1)).astype(int), 0, mx - 1)
    ys = np.clip(np.round(y1 + ts * (y2 - y1)).astype(int), 0, my - 1)
    prof = hm[ys, xs]
    grade = np.linspace(prof[0], prof[-1], n + 1)
    cost = float(np.abs(prof - grade).sum())
    if water_z is not None and (prof < water_z - 0.2).any():
        return float("inf")     # deep water: no legal surface road
    return cost


def gen_connector_roads(plots: list[CityPlot], net: RoadNetwork,
                        road_width: float = 1.0, heightmap=None,
                        num_tries: int = 8, water_z=None,
                        seed: int = 0) -> list[tuple]:
    """Connector between each consecutive city pair.  With a heightmap,
    this is the reference's legal-grade search
    (create_connector_road, city_gen.cpp:2712-2726): `num_tries`
    candidate connection positions are costed by the terrain adjustment
    their route needs (illegal routes — off-map, deep water — are
    rejected) and the cheapest wins.  Returns flatten routes
    [(x1,y1,x2,y2), ...] for heightmap carving."""
    from ..utils.rng import RandGen
    rg = RandGen(seed + 51, 2 * seed + 9)
    routes = []
    for i in range(len(plots) - 1):
        a, b = plots[i], plots[i + 1]
        best = None
        best_cost = float("inf")
        tries = max(num_tries, 1) if heightmap is not None else 1
        for t in range(tries):
            if heightmap is None or t == 0:
                ax = (a.x1 + a.x2) // 2
                ay = (a.y1 + a.y2) // 2
                bx = (b.x1 + b.x2) // 2
                by = (b.y1 + b.y2) // 2
            else:
                ax = a.x1 + rg.rand() % max(a.x2 - a.x1, 1)
                ay = a.y1 + rg.rand() % max(a.y2 - a.y1, 1)
                bx = b.x1 + rg.rand() % max(b.x2 - b.x1, 1)
                by = b.y1 + rg.rand() % max(b.y2 - b.y1, 1)
            legs = ((min(ax, bx), ay, max(ax, bx), ay, 0),
                    (bx, min(ay, by), bx, max(ay, by), 1))
            if heightmap is None:
                cost = 0.0
            else:
                cost = sum(_route_cost(heightmap, lx1, ly1, lx2, ly2,
                                       water_z) for (lx1, ly1, lx2, ly2, _d)
                           in legs)
            if cost < best_cost:
                best_cost = cost
                best = legs
        if best is None or best_cost == float("inf"):
            continue            # no legal connector (the reference skips too)
        for (lx1, ly1, lx2, ly2, d) in best:
            net.segs.append(RoadSeg(lx1, ly1, lx2, ly2, road_width, -1, d))
            routes.append((lx1, ly1, lx2, ly2))
    return routes


def carve_roads(heightmap, routes, plots, width: int = 1):
    """Flatten connector routes into the heightmap (road grading along the
    path; bridges/tunnels are a later round)."""
    from .plots import flatten_region

    hm = _as_map(heightmap)
    for (x1, y1, x2, y2) in routes:
        elev = 0.5 * (float(hm[int(y1), int(x1)]) + float(hm[int(y2), int(x2)]))
        hm = flatten_region(hm, min(x1, x2) - width, min(y1, y2) - width,
                            max(x1, x2) + width, max(y1, y2) + width, elev,
                            slope_width=3)
    return hm


# ---------------------------------------------------------------------------
# bridges & tunnels (roads.cpp:118-150,993-1060 bridge_t/tunnel_t;
# connector roads get a bridge where the terrain drops well below road
# grade and a tunnel where it rises well above)
# ---------------------------------------------------------------------------

class Bridge(NamedTuple):
    x1: int
    y1: int
    x2: int
    y2: int
    zval: float      # deck height
    dim: int         # 0 = runs along x


class Tunnel(NamedTuple):
    x1: int
    y1: int
    x2: int
    y2: int
    zval: float      # road height inside
    radius: float    # bore radius (tunnel_t::init)
    dim: int


def plan_bridges_tunnels(heightmap, routes, bridge_depth: float = 0.3,
                         tunnel_height: float = 0.4, min_len: int = 3):
    """Walk each connector route's terrain profile: maximal runs where the
    ground sits > bridge_depth below road grade become bridges; runs
    > tunnel_height above become tunnels.  Returns (bridges, tunnels).
    """
    hm = _np_map(heightmap)
    bridges, tunnels = [], []
    for (x1, y1, x2, y2) in routes:
        dim = 0 if y1 == y2 else 1
        road_z = 0.5 * (hm[int(y1), int(x1)] + hm[int(y2), int(x2)])
        if dim == 0:
            lo, hi = int(min(x1, x2)), int(max(x1, x2))
            prof = hm[int(y1), lo:hi + 1]
        else:
            lo, hi = int(min(y1, y2)), int(max(y1, y2))
            prof = hm[lo:hi + 1, int(x1)]
        below = prof < road_z - bridge_depth
        above = prof > road_z + tunnel_height

        def runs(mask):
            out = []
            s = None
            for i, m in enumerate(mask):
                if m and s is None:
                    s = i
                elif not m and s is not None:
                    out.append((s, i - 1))
                    s = None
            if s is not None:
                out.append((s, len(mask) - 1))
            return [(a, b) for a, b in out if b - a + 1 >= min_len]

        for (a, b) in runs(below):
            if dim == 0:
                bridges.append(Bridge(lo + a, int(y1), lo + b, int(y1),
                                      float(road_z), 0))
            else:
                bridges.append(Bridge(int(x1), lo + a, int(x1), lo + b,
                                      float(road_z), 1))
        for (a, b) in runs(above):
            if dim == 0:
                tunnels.append(Tunnel(lo + a, int(y1), lo + b, int(y1),
                                      float(road_z), 1.0, 0))
            else:
                tunnels.append(Tunnel(int(x1), lo + a, int(x1), lo + b,
                                      float(road_z), 1.0, 1))
    return bridges, tunnels


def carve_roads_with_structures(heightmap, routes, plots, width: int = 1,
                                bridge_depth: float = 0.3,
                                tunnel_height: float = 0.4):
    """carve_roads that leaves terrain untouched under bridges and above
    tunnels (the road passes over/through instead of regrading).
    Returns (heightmap, bridges, tunnels)."""
    from .plots import flatten_region

    hm = _as_map(heightmap)
    bridges, tunnels = plan_bridges_tunnels(hm.cpu().numpy(), routes,
                                            bridge_depth, tunnel_height)
    skip = np.zeros(tuple(hm.shape), bool)
    for s in bridges + tunnels:
        skip[min(s.y1, s.y2):max(s.y1, s.y2) + 1,
             min(s.x1, s.x2):max(s.x1, s.x2) + 1] = True
    skip_t = torch.as_tensor(skip, device=hm.device)
    for (x1, y1, x2, y2) in routes:
        elev = 0.5 * (float(hm[int(y1), int(x1)]) + float(hm[int(y2), int(x2)]))
        lo_x, hi_x = min(x1, x2) - width, max(x1, x2) + width
        lo_y, hi_y = min(y1, y2) - width, max(y1, y2) + width
        flat = flatten_region(hm, lo_x, lo_y, hi_x, hi_y, elev, slope_width=3)
        hm = torch.where(skip_t, hm, flat)
    return hm, bridges, tunnels


def bridge_sphere_coll(b: Bridge, cx, cy, cz, radius):
    """bridge_t::proc_sphere_coll (roads.cpp:993-1007): a sphere over the
    deck within the span lands on it; returns (hit, new_cz)."""
    inx = (min(b.x1, b.x2) <= cx <= max(b.x1, b.x2) + 1)
    iny = (min(b.y1, b.y2) <= cy <= max(b.y1, b.y2) + 1)
    over = inx and iny and (cz - radius <= b.zval + 0.05) and (cz + radius >= b.zval)
    return (True, b.zval + radius) if over else (False, cz)

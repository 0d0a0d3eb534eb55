"""Waypoint graph + A* pathfinding (port of
`3dworld_tpu/gameplay/waypoints.py`).

The reference auto-places waypoints over cobjs/mesh plus user waypoints
and runs A* over the graph (`waypoint_builder` waypoints.cpp:174,
`run_a_star` :618) for smiley AI navigation.  Here, as in the JAX
package, waypoints sample walkable mesh cells (slope + water gates) in
the order of a cell hash, connect to their k nearest neighbours, and A*
runs on the host over the small graph (a heapq).
"""

from __future__ import annotations

import heapq
from typing import NamedTuple

import numpy as np
import torch

from ..utils import rng as w3d_rng


class WaypointGraph(NamedTuple):
    x: np.ndarray        # [W]
    y: np.ndarray
    z: np.ndarray
    edges: np.ndarray    # [W, K] neighbour ids (-1 pad)
    costs: np.ndarray    # [W, K]


def build_waypoints(zvals, norm_z, water_z, world, seed: int = 0,
                    max_points: int = 128, k: int = 6,
                    slope_thresh: float = 0.7) -> WaypointGraph:
    """Auto-place waypoints on walkable cells and k-NN connect them (host;
    `zvals` and `norm_z` [my, mx], tensors or arrays)."""
    host = lambda a: a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    zn = host(zvals)
    nzm = host(norm_z)
    my, mx = zn.shape
    cell = torch.arange(my * mx, dtype=torch.int64)
    h = w3d_rng.xxhash_u32(cell, seed=seed).numpy().astype(np.uint32)
    ok = (nzm.reshape(-1) > slope_thresh) & (zn.reshape(-1) > water_z)
    score = np.where(ok, h, 0xFFFFFFFF)
    order = np.argsort(score)[:max_points]
    order = order[ok[order]]
    cy, cx = np.divmod(order, mx)
    x = (cx - mx // 2) * world.dx
    y = (cy - my // 2) * world.dy
    z = zn.reshape(-1)[order]
    W = len(order)
    edges = -np.ones((W, k), np.int32)
    costs = np.zeros((W, k), np.float32)
    if W > 1:
        d2 = ((x[:, None] - x[None, :]) ** 2 + (y[:, None] - y[None, :]) ** 2
              + (z[:, None] - z[None, :]) ** 2)
        np.fill_diagonal(d2, np.inf)
        nn = np.argsort(d2, axis=1)[:, :k]
        for i in range(W):
            for j_, j in enumerate(nn[i]):
                if np.isfinite(d2[i, j]):
                    edges[i, j_] = j
                    costs[i, j_] = np.sqrt(d2[i, j])
    return WaypointGraph(x=x, y=y, z=z, edges=edges, costs=costs)


def run_a_star(g: WaypointGraph, start: int, goal: int) -> list[int]:
    """A* over the waypoint graph (run_a_star, waypoints.cpp:618)."""
    W = len(g.x)
    if start == goal:
        return [start]

    def h(i):
        return float(np.sqrt((g.x[i] - g.x[goal]) ** 2 + (g.y[i] - g.y[goal]) ** 2
                             + (g.z[i] - g.z[goal]) ** 2))

    dist = np.full(W, np.inf)
    dist[start] = 0.0
    prev = -np.ones(W, np.int32)
    pq = [(h(start), start)]
    seen = np.zeros(W, bool)
    while pq:
        _, u = heapq.heappop(pq)
        if seen[u]:
            continue
        seen[u] = True
        if u == goal:
            path = [goal]
            while path[-1] != start:
                path.append(int(prev[path[-1]]))
            return path[::-1]
        for j_, v in enumerate(g.edges[u]):
            if v < 0:
                continue
            nd = dist[u] + g.costs[u, j_]
            if nd < dist[v]:
                dist[v] = nd
                prev[v] = u
                heapq.heappush(pq, (nd + h(int(v)), int(v)))
    return [start]  # unreachable

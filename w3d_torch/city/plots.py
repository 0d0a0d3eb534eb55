"""City site selection + heightmap carving (port of
`3dworld_tpu/city/plots.py`).

The reference samples random rects and keeps the one with minimum RMS
height difference (`find_best_city_location`, city_gen.cpp:372-396),
skipping underwater/overlapping candidates, then flattens the plot with a
blended border (`flatten_region_to`, city_gen.cpp:397-401); invoked during
heightmap load (heightmap.cpp:189 -> gen_cities).

The RMS flatness of every candidate rectangle comes at once from sum and
sum-of-squares integral images (two cumsums + O(1) per rect), so site
selection is an argmin over a validity-masked score map.  Host-side
set-up work: it runs on the heightmap's device (the CPU for a numpy map).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops.fmath import div32, sqrt32


class CityPlot(NamedTuple):
    x1: int
    y1: int
    x2: int
    y2: int
    elevation: float


def _integral(img: torch.Tensor) -> torch.Tensor:
    s = torch.cumsum(torch.cumsum(img, 0), 1)
    return torch.nn.functional.pad(s, (1, 0, 1, 0))


def _box_sum(ii, w, h):
    """Sum of every (h, w) window from an integral image: [my-h+1, mx-w+1]."""
    return ii[h:, w:] - ii[:-h, w:] - ii[h:, :-w] + ii[:-h, :-w]


def city_score_map(heightmap: torch.Tensor, w: int, h: int, water_z,
                   used: torch.Tensor, border: int = 0) -> torch.Tensor:
    """Score (RMS height deviation) of every (h, w) placement; invalid
    (underwater or overlapping `used`) positions = +inf.  Returns
    [my-h+1, mx-w+1] float64 scores: the integral images sum in float64,
    so the card's and the CPU's summation orders pick the same placement."""
    hm = heightmap.to(torch.float64)
    n = float(w * h)
    s1 = _box_sum(_integral(hm), w, h)
    s2 = _box_sum(_integral(hm * hm), w, h)
    rms = torch.sqrt(torch.clamp(s2 / n - (s1 / n) ** 2, min=0.0))
    # validity: no underwater cell, no used cell in the window
    has_wet = _box_sum(_integral((hm < water_z).to(torch.float64)), w, h) > 0.5
    has_used = _box_sum(_integral(used.to(torch.float64)), w, h) > 0.5
    score = torch.where(has_wet | has_used, torch.inf, rms)
    if border > 0:
        my, mx = score.shape
        bmask = torch.zeros_like(score, dtype=torch.bool)
        bmask[border:my - border, border:mx - border] = True
        score = torch.where(bmask, score, torch.inf)
    return score


def flatten_region(heightmap: torch.Tensor, x1, y1, x2, y2, elevation,
                   slope_width: int = 4) -> torch.Tensor:
    """flatten_region_to: interior set to elevation; a slope_width border
    band blends linearly back to the original terrain."""
    my, mx = heightmap.shape
    dev = heightmap.device
    yi, xi = torch.meshgrid(torch.arange(my, device=dev), torch.arange(mx, device=dev),
                            indexing="ij")
    # distance outside the rect (0 inside)
    dx = torch.clamp(torch.maximum(x1 - xi, xi - x2), min=0)
    dy = torch.clamp(torch.maximum(y1 - yi, yi - y2), min=0)
    d = sqrt32((dx ** 2 + dy ** 2).to(torch.float32))
    t = torch.clamp(1.0 - div32(d, max(slope_width, 1)), 0.0, 1.0)  # 1 inside -> 0 far
    return heightmap * (1.0 - t) + elevation * t


def gen_cities(heightmap, water_z, num_cities: int = 2, city_size: int = 24,
               border: int = 4, slope_width: int = 4, seed: int = 0):
    """Find + carve city plots (gen_cities equivalent).

    Returns (new_heightmap, [CityPlot...]).  Selection is deterministic:
    the best-scoring location each round (the reference approximates this
    with N random samples)."""
    hm = torch.as_tensor(np.asarray(heightmap, np.float32)) \
        if not isinstance(heightmap, torch.Tensor) else heightmap.to(torch.float32)
    my, mx = hm.shape
    used = torch.zeros((my, mx), dtype=torch.bool, device=hm.device)
    plots = []
    for _ in range(num_cities):
        score = city_score_map(hm, city_size, city_size, water_z, used, border)
        idx = int(torch.argmin(score))
        sy, sx = divmod(idx, score.shape[1])
        if not np.isfinite(float(score[sy, sx])):
            break
        x1, y1 = sx, sy
        x2, y2 = sx + city_size - 1, sy + city_size - 1
        # the region's mean on the host in float64: one value on every device
        elev = float(hm[y1:y2 + 1, x1:x2 + 1].to("cpu", torch.float64).mean())
        hm = flatten_region(hm, x1, y1, x2, y2, elev, slope_width)
        pad = slope_width + city_size // 2  # keep cities apart
        used[max(0, y1 - pad):y2 + pad, max(0, x1 - pad):x2 + pad] = True
        plots.append(CityPlot(x1, y1, x2, y2, elev))
    return hm, plots


def assign_parks(blocks, plots_to_parks_ratio: int = 20, seed: int = 0):
    """Mark ~1 in `ratio` city blocks as parks (plots_to_parks_ratio,
    city_building_params.cpp): parks get trees/benches instead of
    buildings.  Returns (building_blocks, park_blocks), deterministic."""
    from ..utils.rng import RandGen
    rg = RandGen(seed + 41, 3 * seed + 13)
    builds, parks = [], []
    for b in blocks:
        if plots_to_parks_ratio > 0 and rg.rand() % plots_to_parks_ratio == 0:
            parks.append(b)
        else:
            builds.append(b)
    return builds, parks


def furnish_park(block, seed: int = 0, cell_w: float = 1.0):
    """Park content: hashed tree positions + perimeter benches (the
    reference places park trees/benches via city_obj_placer).  Returns
    (tree_xy [T, 2], bench_xy [B, 2])."""
    from ..utils.rng import RandGen
    x1, y1, x2, y2, _city = block
    rg = RandGen(seed + 7, seed * 11 + 3)
    n_trees = max(2, int((x2 - x1) * (y2 - y1) // 40))
    trees = np.asarray(
        [(x1 + 1 + rg.randd() * (x2 - x1 - 2),
          y1 + 1 + rg.randd() * (y2 - y1 - 2)) for _ in range(n_trees)],
        np.float32) * cell_w
    benches = np.asarray(
        [(x1 + 1, y1 + 1), (x2 - 1, y1 + 1), (x1 + 1, y2 - 1),
         (x2 - 1, y2 - 1)], np.float32) * cell_w
    return trees, benches

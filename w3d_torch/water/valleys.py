"""Valley flooding: watershed labeling + basin water levels (port of
`3dworld_tpu/water/valleys.py`).

The reference precomputes a watershed matrix (every mesh cell assigned to
the local-minimum "valley" its steepest-descent path reaches,
`calc_watershed` Water.cpp:1272) and per frame merges/fills valleys to
equal water levels via a spill graph (spillover.cpp,
`update_valleys_and_draw_spillover`).

* flow directions = the lowest of the 8 neighbours (one stencil);
* watershed labels = pointer jumping (label <- flow[label]) for
  ceil(log2(cells)) steps, on exact integer labels;
* basin fill levels: given per-basin water volume, solve
  sum(max(0, z - h)) * dxdy = V by bisection over all basins at once;
* spillover: `update_valleys` union-finds over the saddle graph on the
  host and refills merged basins to a common level.

The bisection compares per-basin float sums against the volumes, so one
sum rounded otherwise can flip a step.  The JAX package sums with an XLA
`segment_sum`; on the card a float `index_add_` sums in atomic order.
Here every per-basin sum is a `SegmentSum`: the cells sorted by label
(stably), laid out in rows of 32 per basin, each row summed by a fixed
pairwise tree, and the row sums again, until one row is left per basin.
The same elementwise adds in the same order run on every device, so the
card and the CPU agree bit for bit; against the JAX package the sums
differ in order, and the levels agree within rounding.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.constants import WorldConst, DEFAULT_WORLD

_INF = 1e30
ROW = 32          # cells per row of a basin in `SegmentSum`


def flow_directions(mesh: torch.Tensor) -> torch.Tensor:
    """Steepest-descent neighbour (flat index, int64) per cell; self at
    strict minima.  Flat cells (no strictly lower neighbour but an equal
    one) flow to their +x/+y neighbour, the reference's "default flow is
    NE" rule (matrix_ops.cpp:371-373)."""
    my, mx = mesh.shape
    dev = mesh.device
    yi, xi = torch.meshgrid(torch.arange(my, device=dev), torch.arange(mx, device=dev),
                            indexing="ij")
    best = mesh
    self_idx = yi * mx + xi
    best_idx = self_idx
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy == 0 and dx == 0:
                continue
            n = torch.roll(mesh, (-dy, -dx), (0, 1)).clone()
            # invalidate wrapped borders
            if dy == 1:
                n[-1, :] = _INF
            elif dy == -1:
                n[0, :] = _INF
            if dx == 1:
                n[:, -1] = _INF
            elif dx == -1:
                n[:, 0] = _INF
            nidx = (torch.clamp(yi + dy, 0, my - 1) * mx + torch.clamp(xi + dx, 0, mx - 1))
            better = n < best
            best = torch.where(better, n, best)
            best_idx = torch.where(better, nidx, best_idx)
    ne = torch.roll(mesh, (-1, -1), (0, 1)).clone()
    ne[-1, :] = _INF
    ne[:, -1] = _INF
    is_flat = (best_idx == self_idx) & (ne == mesh)
    ne_idx = torch.clamp(yi + 1, 0, my - 1) * mx + torch.clamp(xi + 1, 0, mx - 1)
    return torch.where(is_flat, ne_idx, best_idx).reshape(-1)


def watershed_labels(mesh: torch.Tensor) -> torch.Tensor:
    """Basin id (flat index of the basin's minimum, int64) per cell
    (~ watershed_matrix.wsi, Water.cpp:1272)."""
    lab = flow_directions(mesh)
    for _ in range(int(np.ceil(np.log2(max(lab.shape[0], 2))))):
        lab = lab[lab]  # pointer jumping
    return lab


class SegmentSum:
    """Sums of values per label in a fixed order on every device.

    Built once per label map (a few host reads of the basin sizes); each
    call then runs only gathers, adds and one scatter of whole sums, with
    no host sync.  Call with [K] values (aligned with `labels`) to get the
    [n] per-label sums (0 for empty labels)."""

    def __init__(self, labels: torch.Tensor, n: int, row: int = ROW):
        self.n = n
        seg = labels.reshape(-1).long()
        self.order = torch.argsort(seg, stable=True)
        seg = seg[self.order]
        self.levels = []          # per level: [R, row] gather index, -1 padding
        while True:
            k = seg.shape[0]
            counts = torch.bincount(seg, minlength=n)
            starts = torch.cumsum(counts, 0) - counts
            pos = torch.arange(k, device=seg.device) - starts[seg]
            rows = (counts + row - 1) // row
            row_start = torch.cumsum(rows, 0) - rows
            r = int(rows.sum())
            idx = torch.full((r, row), -1, dtype=torch.int64, device=seg.device)
            idx[row_start[seg] + pos // row, pos % row] = torch.arange(k, device=seg.device)
            self.levels.append(idx)
            seg = torch.repeat_interleave(torch.arange(n, device=seg.device), rows)
            if int(rows.max()) <= 1:
                break
        self.out_seg = seg        # the label of each final row

    def __call__(self, values: torch.Tensor) -> torch.Tensor:
        v = values.reshape(-1)[self.order]
        for idx in self.levels:
            x = torch.where(idx >= 0, v[idx.clamp(min=0)], 0.0)
            w = x.shape[1]
            while w > 1:                 # pairwise tree over the row
                w //= 2
                x = x[:, :w] + x[:, w:2 * w]
            v = x[:, 0]
        out = torch.zeros(self.n, dtype=values.dtype, device=values.device)
        return out.index_put((self.out_seg,), v)


def basin_fill_levels(mesh: torch.Tensor, labels: torch.Tensor, volumes: torch.Tensor,
                      world: WorldConst = DEFAULT_WORLD, iters: int = 24,
                      segsum: SegmentSum | None = None):
    """Water level per basin from per-basin volume.

    volumes: [n_cells], nonzero at basin-minimum indices.  Returns (zval
    [n_cells], the level at each basin id slot, water_matrix [my, mx]).
    `segsum` is the `SegmentSum` of `labels` when the caller has it."""
    my, mx = mesh.shape
    n = my * mx
    h = mesh.reshape(-1)
    labels = labels.reshape(-1).long()
    if segsum is None:
        segsum = SegmentSum(labels, n)
    h_min = torch.full((n,), torch.inf, dtype=h.dtype, device=h.device) \
        .scatter_reduce(0, labels, h, "amin")
    lo = torch.where(torch.isfinite(h_min), h_min, 0.0)
    hi = lo + (torch.max(mesh) - torch.min(mesh)) + 1.0
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        vol = segsum(torch.clamp(mid[labels] - h, min=0.0)) * world.dxdy
        too_much = vol > volumes
        lo, hi = torch.where(too_much, lo, mid), torch.where(too_much, mid, hi)
    zval = 0.5 * (lo + hi)
    return zval, zval[labels].reshape(my, mx)


def fill_valleys(mesh: torch.Tensor, volumes_per_basin: torch.Tensor,
                 world: WorldConst = DEFAULT_WORLD):
    """Labels + fill in one call.  Returns (labels, zval, water_matrix,
    wet_mask)."""
    labels = watershed_labels(mesh)
    zval, water = basin_fill_levels(mesh, labels, volumes_per_basin, world)
    return labels, zval, water, water > mesh


def add_rain_volume(volumes: torch.Tensor, labels: torch.Tensor, my, mx,
                    rain_per_cell: float, world: WorldConst = DEFAULT_WORLD):
    """Accumulate rainfall: every cell adds rain volume to its basin
    (~ RAIN_VOLUME accumulation into valleys, Water.cpp)."""
    contrib = torch.full((my * mx,), rain_per_cell * world.dxdy, dtype=torch.float32,
                         device=volumes.device)
    return volumes + SegmentSum(labels, my * mx)(contrib)


def _np(a):
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def basin_saddles(mesh, labels):
    """Saddle heights between adjacent basins (the spill graph,
    spillover.cpp): for each basin pair sharing a boundary, the lowest
    crossing height min over boundary cells of max(h_a, h_b).  Host."""
    h = _np(mesh)
    lab = _np(labels).reshape(h.shape)
    saddles = {}
    for dy, dx in ((0, 1), (1, 0), (1, 1), (1, -1)):
        a_sl = (slice(max(0, -dy), lab.shape[0] - dy or None),
                slice(max(0, -dx), lab.shape[1] - dx or None))
        b_sl = (slice(max(0, dy), lab.shape[0] + min(0, dy) or None),
                slice(max(0, dx), lab.shape[1] + min(0, dx) or None))
        a_lab, b_lab = lab[a_sl], lab[b_sl]
        diff = a_lab != b_lab
        cross = np.maximum(h[a_sl], h[b_sl])[diff]
        for pa, pb, ch in zip(a_lab[diff].ravel(), b_lab[diff].ravel(), cross.ravel()):
            key = (min(pa, pb), max(pa, pb))
            if key not in saddles or ch < saddles[key]:
                saddles[key] = float(ch)
    return saddles


def update_valleys(mesh, labels, volumes, world=DEFAULT_WORLD,
                   max_merge_iters: int = 8):
    """Fill + spillover equalization (update_valleys_and_draw_spillover):
    overflowing basins merge with their spill neighbour (union-find over
    the saddle graph on the host) and refill to a common level.

    Returns (zval_per_slot, water_matrix, wet_mask, merged_labels)."""
    my, mx = mesh.shape
    dev = mesh.device
    labels_np = _np(labels).astype(np.int64)
    saddles = basin_saddles(mesh, labels_np)
    parent = {}

    def find(a):
        while parent.get(a, a) != a:
            parent[a] = parent.get(parent[a], parent[a])
            a = parent[a]
        return a

    merged = torch.as_tensor(labels_np, device=dev)
    vols = torch.as_tensor(volumes, device=dev)
    for _ in range(max_merge_iters):
        zval, water = basin_fill_levels(mesh, merged, vols, world)
        zn = zval.cpu().numpy()
        merged_np = merged.cpu().numpy()
        changed = False
        for (a, b), s in saddles.items():
            ra, rb = find(a), find(b)
            if ra == rb:
                continue
            # overflow: either side's level exceeds the saddle
            if zn[ra] > s + 1e-6 or zn[rb] > s + 1e-6:
                parent[max(ra, rb)] = min(ra, rb)
                changed = True
        if not changed:
            break
        # relabel to union roots and pool volumes at the root slot
        root_of = np.arange(my * mx, dtype=np.int64)
        for lab in np.unique(merged_np):
            root_of[lab] = find(int(lab))
        vols_np = np.zeros(my * mx, np.float32)
        np.add.at(vols_np, root_of, vols.cpu().numpy())
        merged = torch.as_tensor(root_of[merged_np], device=dev)
        vols = torch.as_tensor(vols_np, device=dev)
    zval, water = basin_fill_levels(mesh, merged, vols, world)
    return zval, water, water > mesh, merged


def basin_spill_points(mesh, labels):
    """Per-basin spill point + saddle height (valley::spill_func): the
    lowest boundary saddle of each basin and its cell position, over the
    8-neighbourhood.  Host build, for `float_downstream`."""
    m = _np(mesh)
    my, mx = m.shape
    lab = _np(labels).reshape(my, mx)
    best = {}
    for (dy, dx) in ((0, 1), (1, 0), (1, 1), (1, -1)):
        xs0 = max(0, -dx)
        xs1 = mx - max(0, dx)
        a = lab[:my - dy, xs0:xs1]
        b = lab[dy:, xs0 + dx:xs1 + dx]
        h = np.maximum(m[:my - dy, xs0:xs1], m[dy:, xs0 + dx:xs1 + dx])
        ys, xs = np.nonzero(a != b)
        for y, x in zip(ys, xs):
            for basin in (a[y, x], b[y, x]):
                if basin not in best or h[y, x] < best[basin][0]:
                    best[basin] = (float(h[y, x]), x + xs0 + dx * 0.5, y + dy * 0.5)
    nb = int(lab.max()) + 1
    sx = np.zeros(nb, np.float32)
    sy = np.zeros(nb, np.float32)
    sz = np.full(nb, np.inf, np.float32)
    for basin, (h, x, y) in best.items():
        if 0 <= basin < nb:
            sz[basin] = h
            sx[basin] = x
            sy[basin] = y
    return sx, sy, sz


def float_downstream(px, py, pz, rad, labels, water, mesh,
                     spill_x, spill_y, spill_z, spill_flow,
                     world=DEFAULT_WORLD):
    """Batched float_downstream (Water.cpp:1245-1260): floating objects in
    a spilling basin drift toward its spill point with velocity ~ spill
    flow / distance (capped at 0.005/frame).  Returns (dx, dy)."""
    my, mx = mesh.shape
    dev = px.device
    t = lambda a: torch.as_tensor(a, device=dev)
    gx = torch.clamp(torch.floor(px * world.dx_inv + mx // 2), 0, mx - 1).long()
    gy = torch.clamp(torch.floor(py * world.dy_inv + my // 2), 0, my - 1).long()
    lab = t(labels).reshape(my, mx)[gy, gx].long()
    wl = t(water)[gy, gx]
    mh = t(mesh)[gy, gx]
    spx, spy, spz, flow = (t(a)[lab] for a in (spill_x, spill_y, spill_z, spill_flow))
    # world coords of the spill cell
    tx = (spx - mx // 2) * world.dx
    ty = (spy - my // 2) * world.dy
    # spilling = water over the saddle; floating = above the bottom
    active = (wl > mh) & (wl > spz) & torch.isfinite(spz) & (flow > 0.0) \
        & ((pz - rad) > (mh + 0.5 * rad))
    ex = tx - px
    ey = ty - py
    dist = torch.sqrt(ex * ex + ey * ey) + 1e-9
    vel = torch.clamp(5.0e-5 * flow / (world.dx + world.dy + dist), max=0.005)
    s = torch.where(active, vel / dist, 0.0)
    return s * ex, s * ey

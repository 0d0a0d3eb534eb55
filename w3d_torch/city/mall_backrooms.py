"""Backrooms mazes and shopping malls — the two big special-case
interiors of the reference's extended basements.

Backrooms (building_backrooms.cpp:112-420 `add_backrooms_objs`): a
basement floor becomes a procedural maze — random min-gap walls, extra
walls breaking long sightlines, a pillar grid, and walled sub-rooms with
doors.  Mall (building_mall.cpp `setup_mall_concourse` /
`add_mall_stores`): a multi-floor concourse with an atrium opening,
stores along both sides per floor with storefront openings onto the
concourse, and escalator/stair connections between floors.

Host-side geometry as a pure function of seed (like the rest of
city/floorplan.py); outputs reuse the `Interior` containers so the nav
graph, room content, and people AI work unchanged on top.

Port of `3dworld_tpu/city/mall_backrooms.py` (host code, copied whole).
"""

from __future__ import annotations

import numpy as np

from ..utils.rng import RandGen
from .floorplan import Interior, Room

# backrooms tuning (building_backrooms.cpp:115-176)
WALL_THICK_F = 0.144          # 1.2x the regular wall thickness factor
DOOR_WIDTH_F = 0.8
WALL_DENSITY_RANGE = (1.6, 2.0)
MAX_SIGHT_FACTOR = 0.5        # max open span relative to room size
PILLAR_GRID_F = 2.5           # pillar spacing in floor heights
SUB_ROOM_TRIES = 4


def _min_gap_ok(w, walls_same_dim, min_gap, dim):
    """Reject walls closer than min_gap to a parallel wall they overlap
    laterally (try_place_wall's spacing rule)."""
    x1, y1, x2, y2 = w
    for (ox1, oy1, ox2, oy2) in walls_same_dim:
        if dim == 0:  # wall runs along x; parallel walls compared in y
            if x2 < ox1 or x1 > ox2:
                continue
            if abs(y1 - oy1) < min_gap:
                return False
        else:
            if y2 < oy1 or y1 > oy2:
                continue
            if abs(x1 - ox1) < min_gap:
                return False
    return True


def gen_backrooms(bounds, floor_height: float, seed: int,
                  floor_ix: int = 0) -> Interior:
    """One backrooms floor: (x1, y1, x2, y2) bounds -> maze Interior.

    Wall counts and length ranges follow the reference: len in
    [1.0, max(0.25*min_side, 1.5)] floor-spacings, count ~
    U(1.6, 2.0) * area / avg_len^2, 10 placement tries per wall, then a
    sightline pass adds central crossing walls to any open span longer
    than half the room.
    """
    x1, y1, x2, y2 = (float(v) for v in bounds)
    rg = RandGen(seed + 123 * floor_ix, 79 * seed + 1)
    sx, sy = x2 - x1, y2 - y1
    fs = floor_height
    wall_half = 0.5 * WALL_THICK_F * fs
    doorway = DOOR_WIDTH_F * fs
    min_gap = 1.2 * doorway
    min_side = min(sx, sy)
    if min_side < 2.0 * fs:  # room too small for a maze (backrooms :170)
        out = Interior(num_floors=1)
        out.rooms.append(Room(x1, y1, x2, y2, floor_ix))
        return out
    wl_min = 1.0 * fs
    wl_max = max(0.25 * min_side, 1.5 * wl_min)
    wl_avg = 0.5 * (wl_min + wl_max)
    num_walls = int(round(rg.rand_uniform(*WALL_DENSITY_RANGE)
                          * (sx * sy) / (wl_avg * wl_avg)))

    walls_dim = ([], [])          # axis-aligned segments per run-dim
    edge = min_gap + 2 * wall_half

    def try_place(dim, span_lo, span_hi, lat_lo, lat_hi):
        hi_len = min(wl_max, span_hi - span_lo)
        if hi_len <= wl_min or lat_hi <= lat_lo:
            return False            # room too small for a maze wall here
        ln = rg.rand_uniform(wl_min, hi_len)
        s0 = rg.rand_uniform(span_lo, span_hi - ln)
        lat = rg.rand_uniform(lat_lo, lat_hi)
        w = ((s0, lat, s0 + ln, lat) if dim == 0 else (lat, s0, lat, s0 + ln))
        if not _min_gap_ok(w, walls_dim[dim], min_gap, dim):
            return False
        walls_dim[dim].append(w)
        return True

    for _ in range(num_walls):
        for _try in range(10):
            dim = rg.rand() & 1
            if dim == 0:
                ok = try_place(0, x1 + edge, x2 - edge, y1 + edge, y2 - edge)
            else:
                ok = try_place(1, y1 + edge, y2 - edge, x1 + edge, x2 - edge)
            if ok:
                break

    # sightline pass: sample lanes; block open spans > half the room
    for dim in range(2):
        size = sx if dim == 0 else sy
        max_space = MAX_SIGHT_FACTOR * size
        lanes = np.linspace((y1 if dim == 0 else x1) + edge,
                            (y2 if dim == 0 else x2) - edge, 9)
        for lat in lanes:
            # collect blocking walls crossing this lane
            blocks = []
            for (wx1, wy1, wx2, wy2) in walls_dim[1 - dim]:
                lo, hi = (wy1, wy2) if dim == 0 else (wx1, wx2)
                c = wx1 if dim == 0 else wy1
                if lo - min_gap <= lat <= hi + min_gap:
                    blocks.append(c)
            lo_edge = x1 if dim == 0 else y1
            hi_edge = x2 if dim == 0 else y2
            pts = sorted([lo_edge] + blocks + [hi_edge])
            for a, b in zip(pts[:-1], pts[1:]):
                if b - a < max_space:
                    continue
                mid = 0.5 * (a + b)     # central 25% restriction
                c0 = mid + rg.rand_uniform(-0.125, 0.125) * (b - a)
                ln = rg.rand_uniform(wl_min, wl_max)
                w = ((c0, lat, c0, lat + ln) if dim == 0
                     else (lat, c0, lat + ln, c0))
                if _min_gap_ok(w, walls_dim[1 - dim], min_gap, 1 - dim):
                    walls_dim[1 - dim].append(w)

    out = Interior(num_floors=1)
    out.rooms.append(Room(x1, y1, x2, y2, floor_ix))
    z1 = floor_ix * fs
    for dim in range(2):
        for (wx1, wy1, wx2, wy2) in walls_dim[dim]:
            out.walls.append((wx1 - wall_half, wy1 - wall_half, z1,
                              wx2 + wall_half, wy2 + wall_half, z1 + fs))

    # pillar grid avoiding walls (backrooms pillars)
    step = PILLAR_GRID_F * fs
    px = np.arange(x1 + step, x2 - 0.5 * step, step)
    py = np.arange(y1 + step, y2 - 0.5 * step, step)
    pr = 0.6 * wall_half
    for cx in px:
        for cy in py:
            clear = all(not (wx1 - min_gap < cx < wx2 + min_gap
                             and wy1 - min_gap < cy < wy2 + min_gap)
                        for (wx1, wy1, _z, wx2, wy2, _z2) in out.walls)
            if clear:
                out.walls.append((cx - pr, cy - pr, z1,
                                  cx + pr, cy + pr, z1 + fs))

    # a few walled sub-rooms with a door (setup_multi_floor_room);
    # the doored wall segment is split around the doorway like
    # floorplan.py's door cutouts, so the room is enterable
    for _ in range(SUB_ROOM_TRIES):
        w = rg.rand_uniform(1.5, 2.5) * fs
        h = rg.rand_uniform(1.5, 2.5) * fs
        if x2 - edge - w <= x1 + edge or y2 - edge - h <= y1 + edge:
            continue                # backrooms footprint too small
        rx = rg.rand_uniform(x1 + edge, x2 - edge - w)
        ry = rg.rand_uniform(y1 + edge, y2 - edge - h)
        out.rooms.append(Room(rx, ry, rx + w, ry + h, floor_ix))
        dside = rg.rand() & 1       # 1 -> door in the bottom (y1) wall
        dw = 0.45 * fs
        segs = [((rx, ry + h), (rx + w, ry + h)),
                ((rx + w, ry), (rx + w, ry + h))]
        if dside:
            dx, dy = rx + 0.5 * w, ry
            out.doors.append((dx, dy, z1, 0))   # crossed along y
            segs += [((rx, ry), (dx - 0.5 * dw, ry)),
                     ((dx + 0.5 * dw, ry), (rx + w, ry)),
                     ((rx, ry), (rx, ry + h))]
        else:
            dx, dy = rx, ry + 0.5 * h
            out.doors.append((dx, dy, z1, 1))   # crossed along x
            segs += [((rx, ry), (rx + w, ry)),
                     ((rx, ry), (rx, dy - 0.5 * dw)),
                     ((rx, dy + 0.5 * dw), (rx, ry + h))]
        for (ax, ay), (bx, by) in segs:
            out.walls.append((ax - wall_half, ay - wall_half, z1,
                              bx + wall_half, by + wall_half, z1 + fs))
    return out


# ---------------------------------------------------------------------------
# mall
# ---------------------------------------------------------------------------

CONCOURSE_FRACT = 0.4         # central concourse width fraction
STORE_W_RANGE_F = (1.8, 3.2)  # store width in floor heights
ATRIUM_FRACT = 0.55           # opening fraction of the concourse (U-shape)


def gen_mall(bounds, num_floors: int, floor_height: float,
             seed: int) -> Interior:
    """Multi-floor mall: concourse + stores both sides + escalators.

    building_mall.cpp structure: the concourse runs down the long axis;
    each floor has stores on both sides with storefront openings onto the
    concourse; upper floors have a central atrium opening (modeled as a
    room flagged by zero-area walls around the cut); escalators at both
    ends connect adjacent floors (entered in `stairs`).
    """
    x1, y1, x2, y2 = (float(v) for v in bounds)
    rg = RandGen(seed + 7, 3 * seed + 11)
    fs = floor_height
    long_x = (x2 - x1) >= (y2 - y1)
    if not long_x:  # normalize: concourse along x, transpose at the end
        x1, y1, x2, y2 = y1, x1, y2, x2
    W = y2 - y1
    conc_half = 0.5 * CONCOURSE_FRACT * W
    cy = 0.5 * (y1 + y2)
    out = Interior(num_floors=num_floors)
    store_rows = ((y1, cy - conc_half), (cy + conc_half, y2))

    def TR(ax, ay, bx, by):
        """un-transpose when the long axis was y"""
        return (ax, ay, bx, by) if long_x else (ay, ax, by, bx)

    for fl in range(num_floors):
        z1 = fl * fs
        # concourse room (atrium opening above ground floor)
        ca, cb, cc, cd = TR(x1, cy - conc_half, x2, cy + conc_half)
        conc = Room(ca, cb, cc, cd, fl, is_hallway=True)
        out.rooms.append(conc)
        # stores along both sides
        for (ry1, ry2) in store_rows:
            cx = x1
            while cx < x2 - 0.5 * fs:
                w = rg.rand_uniform(*STORE_W_RANGE_F) * fs
                sx2 = min(cx + w, x2)
                ra, rb, rc, rd = TR(cx, ry1, sx2, ry2)
                out.rooms.append(Room(ra, rb, rc, rd, fl))
                # storefront opening onto the concourse
                front_y = ry2 if ry2 <= cy else ry1
                da, db, _dc, _dd = TR(0.5 * (cx + sx2), front_y,
                                      0.5 * (cx + sx2), front_y)
                # dim 0 = door crossed along y (wall runs along x), the
                # floorplan/people nav convention (floorplan.py:186-192)
                out.doors.append((da, db, z1, 0 if long_x else 1))
                # dividing wall to the next store
                if sx2 < x2:
                    wa, wb, wc, wd = TR(sx2, ry1, sx2, ry2)
                    out.walls.append((min(wa, wc), min(wb, wd), z1,
                                      max(wa, wc), max(wb, wd), z1 + fs))
                cx = sx2
        # escalators at both ends of the concourse (to the floor above)
        if fl + 1 < num_floors:
            esc_w = 0.8 * fs
            for end_x in (x1 + 0.5 * fs, x2 - 0.5 * fs - esc_w):
                ea, eb, ec, ed = TR(end_x, cy - 0.3 * conc_half,
                                    end_x + esc_w, cy + 0.3 * conc_half)
                out.stairs.append((min(ea, ec), min(eb, ed),
                                   max(ea, ec), max(eb, ed), fl))
    return out


def mall_atrium_opening(bounds, floor_height: float):
    """The central floor cut of upper mall floors (concourse opening):
    returns (x1, y1, x2, y2) of the opening for floor-geometry masking."""
    x1, y1, x2, y2 = (float(v) for v in bounds)
    long_x = (x2 - x1) >= (y2 - y1)
    cx, cy = 0.5 * (x1 + x2), 0.5 * (y1 + y2)
    if long_x:
        hw = 0.5 * ATRIUM_FRACT * (x2 - x1)
        hh = 0.5 * CONCOURSE_FRACT * (y2 - y1) * 0.8
    else:
        hw = 0.5 * CONCOURSE_FRACT * (x2 - x1) * 0.8
        hh = 0.5 * ATRIUM_FRACT * (y2 - y1)
    return (cx - hw, cy - hh, cx + hw, cy + hh)


# reference store types cycled per mall store (building_names_signs.cpp
# store_type_strs: clothing/food/book/retail/furniture)
STORE_TYPES = ("clothing", "food", "book", "retail", "furniture")


def store_names(interior, seed: int):
    """Per-store (category, sign name) for every mall store room, drawn
    from the shipped text_data/store_names.txt categories
    (building_names_signs.cpp choose_store_name)."""
    from ..utils.names import choose_store_name
    rg = RandGen(seed + 19, 2 * seed + 5)
    out = []
    for r in interior.rooms:
        if r.is_hallway:
            out.append(None)
            continue
        cat = STORE_TYPES[rg.rand() % len(STORE_TYPES)]
        out.append((cat, choose_store_name(cat, rg)))
    return out


def furnish_mall(interior, floor_height: float, seed: int):
    """Category-specific store furnishing (building_mall.cpp
    add_mall_store_objs by store type): clothing stores get garment
    racks with hung clothes, bookstores get bookcase aisles, food-court
    stores get counters + booths + vending, retail stores get stocked
    gondola shelf racks, furniture stores get display beds/couches/
    tables.  The concourse gets benches and planters."""
    from . import room_content as RC
    names = store_names(interior, seed)
    rg = RandGen(seed + 3, 2 * seed + 31)
    out = RC.RoomObjects()
    out.room_types = [RC.R_HALL if r.is_hallway else RC.R_RETAIL
                      for r in interior.rooms]
    fh = floor_height
    for ri, r in enumerate(interior.rooms):
        z0 = r.floor * fh
        pl = RC._Placer(rg, r, [], 0.4 * fh)
        if r.is_hallway:                # concourse: benches + planters
            for _ in range(4):
                p = pl.try_place(0.6 * fh, 0.25 * fh, False)
                if p:
                    x, y, rot = p
                    out.add(ri, RC.F_COUCH, x, y, z0, x + 0.6 * fh,
                            y + 0.25 * fh, z0 + 0.3 * fh, rot=rot)
            for _ in range(3):
                p = pl.try_place(0.25 * fh, 0.25 * fh, False)
                if p:
                    x, y, _ = p
                    out.add(ri, RC.F_PLANT, x, y, z0, x + 0.25 * fh,
                            y + 0.25 * fh, z0 + 0.5 * fh)
            continue
        cat = names[ri][0]
        if cat == "clothing":
            for _ in range(4):
                p = pl.try_place(0.8 * fh, 0.3 * fh, False)
                if p:
                    x, y, rot = p
                    rk = out.add(ri, RC.F_RACK, x, y, z0, x + 0.8 * fh,
                                 y + 0.3 * fh, z0 + 0.55 * fh, rot=rot)
                    for ci in range(4):
                        cxp = x + (0.08 + 0.18 * ci) * fh
                        out.add(ri, RC.F_CLOTHES, cxp, y + 0.05 * fh,
                                z0 + 0.25 * fh, cxp + 0.12 * fh,
                                y + 0.25 * fh, z0 + 0.52 * fh, parent=rk)
        elif cat == "book":
            for _ in range(4):
                p = pl.try_place(0.9 * fh, 0.25 * fh, False)
                if p:
                    x, y, rot = p
                    bi = out.add(ri, RC.F_BOOKCASE, x, y, z0,
                                 x + 0.9 * fh, y + 0.25 * fh,
                                 z0 + 0.8 * fh, rot=rot)
                    for bx in range(6):
                        out.add(ri, RC.F_BOOK, x + (0.05 + 0.14 * bx) * fh,
                                y + 0.05 * fh, z0 + 0.4 * fh,
                                x + (0.15 + 0.14 * bx) * fh,
                                y + 0.2 * fh, z0 + 0.6 * fh, parent=bi)
        elif cat == "food":
            p = pl.try_place(1.2 * fh, 0.4 * fh, True)
            if p:
                x, y, rot = p
                out.add(ri, RC.F_COUNTER, x, y, z0, x + 1.2 * fh,
                        y + 0.4 * fh, z0 + 0.35 * fh, rot=rot)
            for _ in range(3):
                p = pl.try_place(0.55 * fh, 0.55 * fh, False)
                if p:
                    x, y, rot = p
                    out.add(ri, RC.F_BOOTH, x, y, z0, x + 0.55 * fh,
                            y + 0.55 * fh, z0 + 0.45 * fh, rot=rot)
            p = pl.try_place(0.5 * fh, 0.35 * fh, True)
            if p:
                x, y, rot = p
                out.add(ri, RC.F_VENDING, x, y, z0, x + 0.5 * fh,
                        y + 0.35 * fh, z0 + 0.8 * fh, rot=rot)
        elif cat == "furniture":
            for kind, w, d, hgt in ((RC.F_BED, 0.55, 1.0, 0.3),
                                    (RC.F_COUCH, 0.8, 0.35, 0.35),
                                    (RC.F_TABLE, 0.6, 0.4, 0.3),
                                    (RC.F_WARDROBE, 0.5, 0.3, 0.85)):
                p = pl.try_place(w * fh, d * fh, False)
                if p:
                    x, y, rot = p
                    out.add(ri, kind, x, y, z0, x + w * fh, y + d * fh,
                            z0 + hgt * fh, rot=rot)
        else:                           # general retail: gondola racks
            for _ in range(4):
                p = pl.try_place(0.9 * fh, 0.3 * fh, False)
                if p:
                    x, y, rot = p
                    rk = out.add(ri, RC.F_RACK, x, y, z0, x + 0.9 * fh,
                                 y + 0.3 * fh, z0 + 0.6 * fh, rot=rot)
                    RC._surface_items(out, pl, rg, ri, RC.F_RACK, rk,
                                      x, y, z0 + 0.6 * fh, 0.9 * fh,
                                      0.3 * fh, fh / 0.2)
        # every store gets a checkout counter near its storefront
        p = pl.try_place(0.5 * fh, 0.25 * fh, True)
        if p:
            x, y, rot = p
            out.add(ri, RC.F_COUNTER, x, y, z0, x + 0.5 * fh,
                    y + 0.25 * fh, z0 + 0.35 * fh, rot=rot)
    return out, names

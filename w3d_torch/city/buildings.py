"""Building placement + exterior generation (port of
`3dworld_tpu/city/buildings.py`, host numpy code).

The reference places buildings from config-driven material/size parameter
sets using a spatial-hash grid with overlap rejection
(`building_creator_t::gen`, gen_buildings.cpp:3504+, grid :3233-3270),
then generates cube/multi-part exteriors with roof details
(buildings.h:1678, gen_buildings.cpp).

Here: seeded rejection placement inside city blocks (and noise-gated
wilderness placement for secondary buildings), multi-part cube exteriors
(1-3 stacked parts with setbacks), per-building material index; SoA
output consumable by floorplanning, physics cobjs and export.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import NamedTuple

import numpy as np

from ..utils.rng import RandGen


class BuildingParams(NamedTuple):
    """Subset of building_params_t (city_building_params.cpp)."""

    min_sz: float = 2.0       # footprint cells
    max_sz: float = 6.0
    min_floors: int = 1
    max_floors: int = 8
    floor_height: float = 0.08
    num_materials: int = 4
    max_parts: int = 3
    setback: float = 0.15
    round_prob: float = 0.15   # fraction of round (cylinder) buildings
    rotate_prob: float = 0.2   # fraction of rotated cube buildings
    max_rot_angle: float = 0.5 # radians


@dataclass
class Building:
    x: float
    y: float
    z: float                   # ground elevation
    parts: list                # [(x1,y1,z1,x2,y2,z2), ...] world cubes
    mat: int = 0
    roof_type: int = 0         # 0 flat, 1 peaked
    interior: object = None    # filled by floorplan.py
    # shape (building_geom_t, buildings.h:98-106): 4 = cube; >8 = round
    # (cylinder collision); rotation is about the building center z-axis
    num_sides: int = 4
    rot_angle: float = 0.0

    @property
    def is_round(self):
        return self.num_sides > 8

    @property
    def is_rotated(self):
        return self.rot_angle != 0.0

    def footprint(self):
        """Ground-plane corner points of the base part (rotated cube ->
        4 rotated corners; round -> num_sides polygon)."""
        x1, y1, _z1, x2, y2, _z2 = self.parts[0]
        cx, cy = 0.5 * (x1 + x2), 0.5 * (y1 + y2)
        if self.is_round:
            a = np.linspace(0, 2 * np.pi, self.num_sides, endpoint=False)
            rx, ry = 0.5 * (x2 - x1), 0.5 * (y2 - y1)
            return np.stack([cx + rx * np.cos(a + self.rot_angle),
                             cy + ry * np.sin(a + self.rot_angle)], -1)
        c, s = np.cos(self.rot_angle), np.sin(self.rot_angle)
        pts = np.array([[x1, y1], [x2, y1], [x2, y2], [x1, y2]]) - (cx, cy)
        return pts @ np.array([[c, s], [-s, c]]) + (cx, cy)


def place_buildings_in_blocks(blocks, elevation_of, params: BuildingParams,
                              seed: int = 1, per_block: int = 4,
                              cell_w: float = 1.0):
    """Place buildings in city blocks with overlap rejection
    (grid-free variant of the reference's spatial hash; block capacity
    caps like per-plot capacity)."""
    rg = RandGen(seed + 1, seed * 7 + 3)
    out = []
    for (x1, y1, x2, y2, city) in blocks:
        bw = x2 - x1
        bh = y2 - y1
        if bw < params.min_sz or bh < params.min_sz:
            continue
        placed = []
        for _ in range(per_block * 4):  # rejection attempts
            if len(placed) >= per_block:
                break
            w = rg.rand_uniform(params.min_sz, min(params.max_sz, bw))
            h = rg.rand_uniform(params.min_sz, min(params.max_sz, bh))
            bx = x1 + rg.randd() * (bw - w)
            by = y1 + rg.randd() * (bh - h)
            if any(bx < px + pw and bx + w > px and by < py + ph and by + h > py
                   for (px, py, pw, ph) in placed):
                continue
            placed.append((bx, by, w, h))
            floors = rg.rand_int(params.min_floors, params.max_floors)
            z0 = elevation_of(bx + 0.5 * w, by + 0.5 * h)
            # multi-part: stacked cubes with setbacks
            nparts = rg.rand_int(1, params.max_parts)
            parts = []
            cw, ch = w, h
            pz = z0
            fl_per = max(1, floors // nparts)
            for pi in range(nparts):
                hgt = fl_per * params.floor_height
                parts.append((bx * cell_w, by * cell_w, pz,
                              (bx + cw) * cell_w, (by + ch) * cell_w, pz + hgt))
                pz += hgt
                cw *= (1.0 - params.setback)
                ch *= (1.0 - params.setback)
                bx += 0.5 * params.setback * cw
                by += 0.5 * params.setback * ch
                if cw < 0.5 or ch < 0.5:
                    break
            # shape roll (building_geom_t): some buildings are round
            # (num_sides > 8) or rotated about their center
            shape_roll = rg.randd()
            num_sides = 4
            rot = 0.0
            if shape_roll < params.round_prob:
                num_sides = 12 + 2 * rg.rand_int(0, 12)   # 12..36
            elif shape_roll < params.round_prob + params.rotate_prob:
                rot = (2.0 * rg.randd() - 1.0) * params.max_rot_angle
            out.append(Building(
                x=(placed[-1][0] + 0.5 * w) * cell_w,
                y=(placed[-1][1] + 0.5 * h) * cell_w,
                z=z0, parts=parts,
                mat=rg.rand_int(0, params.num_materials - 1),
                roof_type=int(rg.rand_bool() and floors <= 3),
                num_sides=num_sides, rot_angle=rot,
            ))
    return out


def buildings_to_cobjs(buildings):
    """Register building parts as COLL_CUBE cobjs (the reference adds
    buildings to the tiled-terrain collision path)."""
    from ..scene import cobj as SC

    sp = SC.SceneParse()
    lay = SC.CobjLayer(elasticity=0.3, color=(0.7, 0.7, 0.7, 1.0))
    for b in buildings:
        for (x1, y1, z1, x2, y2, z2) in b.parts:
            if b.is_round:
                # cylinder collision for round buildings
                # (building_geom_t::use_cylinder_coll, buildings.h:106)
                cx, cy = 0.5 * (x1 + x2), 0.5 * (y1 + y2)
                r = 0.5 * min(x2 - x1, y2 - y1)
                sp.cobjs.append(SC.RawCobj(SC.COLL_CYLINDER,
                                           (cx, cy, z1), (cx, cy, z2),
                                           r1=r, r2=r, layer=lay))
            elif b.is_rotated:
                # rotated cube -> thickness-extruded polygon cobj
                cx, cy = 0.5 * (x1 + x2), 0.5 * (y1 + y2)
                cz = 0.5 * (z1 + z2)
                c, sn = np.cos(b.rot_angle), np.sin(b.rot_angle)
                R = np.array([[c, sn], [-sn, c]])
                base = np.array([[x1, y1], [x2, y1], [x2, y2], [x1, y2]]) \
                    - (cx, cy)
                rp = base @ R + (cx, cy)
                pts = tuple((float(px), float(py), cz) for px, py in rp)
                sp.cobjs.append(SC.RawCobj(SC.COLL_POLYGON,
                                           r1=(z2 - z1), pts=pts, layer=lay))
            else:
                sp.cobjs.append(SC.RawCobj(SC.COLL_CUBE, (x1, y1, z1),
                                           (x2, y2, z2), layer=lay))
    return sp


def building_part_array(buildings) -> np.ndarray:
    """[P, 6] x1 y1 z1 x2 y2 z2 of all parts (export / device upload)."""
    rows = [p for b in buildings for p in b.parts]
    return np.asarray(rows, np.float32).reshape(-1, 6)


# ---------------------------------------------------------------------------
# exterior detail: window grids, roof objects, peaked-roof geometry
# (building_geom.cpp:1330-1530; window spacing = get_window_vspace)
# ---------------------------------------------------------------------------

(ROOF_AC, ROOF_ANTENNA, ROOF_SAT_DISH, ROOF_SOLAR, ROOF_WATER_TOWER,
 ROOF_SKYLIGHT, ROOF_WALL, ROOF_DUCT) = range(8)


def gen_windows(b, params: BuildingParams, win_frac: float = 0.55):
    """Per-part per-wall window grids: one row per floor (vspace =
    floor_height), columns spaced ~0.6 fh with `win_frac` glass fill
    (get_window_vspace / window drawing semantics).  Returns
    [(x1,y1,z1,x2,y2,z2,dim,dir)] wall-plane rects."""
    fh = params.floor_height
    wins = []
    for pi, (x1, y1, z1, x2, y2, z2) in enumerate(b.parts):
        nf = max(1, int(round((z2 - z1) / fh)))
        for dim in (0, 1):
            span = (y2 - y1) if dim == 0 else (x2 - x1)
            ncols = max(int(span / (0.6 * fh)), 1)
            cw = span / ncols
            for dr in (0, 1):
                # skip faces flush against the part above (setbacks nest,
                # so only same-coordinate faces occlude)
                for fl in range(nf):
                    wz1 = z1 + (fl + 0.3) * fh
                    wz2 = z1 + (fl + 0.8) * fh
                    for c in range(ncols):
                        lo = (y1 if dim == 0 else x1) + (c + 0.5 * (1 - win_frac)) * cw
                        hi = lo + win_frac * cw
                        if dim == 0:
                            wx = x2 if dr else x1
                            wins.append((wx, lo, wz1, wx, hi, wz2, 0, dr))
                        else:
                            wy = y2 if dr else y1
                            wins.append((lo, wy, wz1, hi, wy, wz2, 1, dr))
    return wins


def gen_roof_objects(b, seed: int = 0):
    """Rooftop details (building_t::gen_details, building_geom.cpp:
    1330-1360): solar panels 50%, satellite dish 1/8, TV antenna 1/8,
    AC units, water tower on tall flat-roofed buildings, skylight on
    peaked houses.  Returns [(x1,y1,z1,x2,y2,z2,kind)] cubes."""
    rg = RandGen(seed + 41, 3 * seed + 13)
    (x1, y1, z1t, x2, y2, z2) = b.parts[-1]
    w = x2 - x1
    h = y2 - y1
    out = []

    def put(kind, fx, fy, fw, fd, fz):
        cx = x1 + fx * w
        cy = y1 + fy * h
        out.append((cx, cy, z2, min(cx + fw * w, x2), min(cy + fd * h, y2),
                    z2 + fz, kind))

    roll = rg.rand() & 7
    if b.roof_type == 1:
        if roll == 3:
            put(ROOF_SKYLIGHT, 0.35, 0.35, 0.3, 0.2, 0.02)
    else:
        n_ac = 1 + rg.rand() % 3
        for _ in range(n_ac):
            put(ROOF_AC, 0.1 + 0.7 * rg.randd(), 0.1 + 0.7 * rg.randd(),
                0.12, 0.1, 0.06)
        if roll & 1:
            put(ROOF_SOLAR, 0.1, 0.1, 0.35, 0.3, 0.02)
        if roll == 0:
            put(ROOF_SAT_DISH, 0.7, 0.2, 0.1, 0.1, 0.1)
        if roll == 2:
            put(ROOF_ANTENNA, 0.5, 0.5, 0.02, 0.02, 0.3)
        if len(b.parts) >= 3:   # tall tower: water tower + parapet walls
            put(ROOF_WATER_TOWER, 0.6, 0.6, 0.2, 0.2, 0.25)
            out.append((x1, y1, z2, x2, y1 + 0.02 * h, z2 + 0.04, ROOF_WALL))
            out.append((x1, y2 - 0.02 * h, z2, x2, y2, z2 + 0.04, ROOF_WALL))
        if rg.rand_bool():
            put(ROOF_DUCT, 0.3, 0.8, 0.3, 0.06, 0.05)
    return out


def peaked_roof_polys(b):
    """Peaked (gable) roof geometry for roof_type 1: ridge along the
    long axis, two slanted quads + two gable triangles (house roof,
    building_geom.cpp add_roof)."""
    (x1, y1, z1t, x2, y2, z2) = b.parts[-1]
    w = x2 - x1
    h = y2 - y1
    peak = z2 + 0.25 * min(w, h)
    if w >= h:
        ym = 0.5 * (y1 + y2)
        return [
            ((x1, y1, z2), (x2, y1, z2), (x2, ym, peak), (x1, ym, peak)),
            ((x1, ym, peak), (x2, ym, peak), (x2, y2, z2), (x1, y2, z2)),
            ((x1, y1, z2), (x1, ym, peak), (x1, y2, z2)),
            ((x2, y1, z2), (x2, ym, peak), (x2, y2, z2)),
        ]
    xm = 0.5 * (x1 + x2)
    return [
        ((x1, y1, z2), (xm, y1, peak), (xm, y2, peak), (x1, y2, z2)),
        ((xm, y1, peak), (x2, y1, z2), (x2, y2, z2), (xm, y2, peak)),
        ((x1, y1, z2), (xm, y1, peak), (x2, y1, z2)),
        ((x1, y2, z2), (xm, y2, peak), (x2, y2, z2)),
    ]

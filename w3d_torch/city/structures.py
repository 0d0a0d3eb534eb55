"""City structures spanning plots (port of `3dworld_tpu/city/structures.py`,
host numpy code): skyways/elevated walkways between
buildings, power poles with catenary wires along roads, and underground
parking elevators.

The reference places these in `city_obj_placer.cpp` (skyway_t /
walkway_t placement, power pole + wire runs `connect_power_to_point`,
ug_elevator_t shafts into underground parking, city_objects.cpp:3521).
Here each structure is a typed host-side record set with collision
export (cobjs) and overhead-map overlay; elevator cabs become physics
platforms (platform_cont analog) so they actually move.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from ..utils.rng import RandGen


class Skyway(NamedTuple):
    """Enclosed bridge between two buildings (skyway_t)."""

    x1: float
    y1: float
    x2: float
    y2: float
    z_bot: float
    z_top: float
    width: float


class PowerLines(NamedTuple):
    """Poles + sagging conductor polylines (power_pole_t wires)."""

    poles: np.ndarray     # [P, 2] xy
    pole_h: float
    wires: np.ndarray     # [W, 3, 3] start / sagged midpoint / end


class UgElevator(NamedTuple):
    """Underground parking elevator shaft (ug_elevator_t)."""

    x: float
    y: float
    ground_z: float
    depth: float
    cab: float            # cab half-size


def _bparts(buildings):
    return [b.parts[0] for b in buildings] if buildings else []


def place_skyways(buildings, max_dist: float = 1.2,
                  min_height: float = 0.5, width: float = 0.18,
                  limit: int = 16) -> list[Skyway]:
    """Bridge pairs of tall buildings whose footprints face each other
    within `max_dist`: the deck spans wall to wall at ~2/3 of the
    shorter building's height (city skyway placement)."""
    parts = _bparts(buildings)
    out = []
    for i in range(len(parts)):
        x1a, y1a, z1a, x2a, y2a, z2a = parts[i]
        if z2a - z1a < min_height:
            continue
        for j in range(i + 1, len(parts)):
            x1b, y1b, z1b, x2b, y2b, z2b = parts[j]
            if z2b - z1b < min_height:
                continue
            z_deck = z1a + 0.65 * min(z2a - z1a, z2b - z1b)
            # facing in x: y-intervals overlap, x gap small
            ylo, yhi = max(y1a, y1b), min(y2a, y2b)
            xlo, xhi = max(x1a, x1b), min(x2a, x2b)
            if yhi - ylo > width:
                gap = max(x1b - x2a, x1a - x2b)
                if 0.0 < gap <= max_dist:
                    ym = 0.5 * (ylo + yhi)
                    xs = (x2a, x1b) if x1b > x2a else (x2b, x1a)
                    out.append(Skyway(xs[0], ym - width / 2, xs[1],
                                      ym + width / 2, z_deck,
                                      z_deck + width, width))
            elif xhi - xlo > width:
                gap = max(y1b - y2a, y1a - y2b)
                if 0.0 < gap <= max_dist:
                    xm = 0.5 * (xlo + xhi)
                    ys = (y2a, y1b) if y1b > y2a else (y2b, y1a)
                    out.append(Skyway(xm - width / 2, ys[0],
                                      xm + width / 2, ys[1], z_deck,
                                      z_deck + width, width))
            if len(out) >= limit:
                return out
    return out


def place_power_lines(net, spacing: float = 4.0, pole_h: float = 2.0,
                      sag: float = 0.10, conductors: int = 3,
                      cond_dz: float = 0.08) -> PowerLines:
    """Poles at regular spacing along one side of every road segment,
    with `conductors` sagging wires between consecutive poles of the
    same run (power_pole_t: wire runs along roads; catenary approximated
    by the midpoint droop `sag` * span)."""
    poles = []
    wires = []
    for s in net.segs:
        length = max(abs(s.x2 - s.x1), abs(s.y2 - s.y1))
        n = int(length // spacing)
        if n < 1:
            continue
        run = []
        for i in range(n + 1):
            t = i / max(n, 1)
            x = s.x1 + t * (s.x2 - s.x1)
            y = s.y1 + t * (s.y2 - s.y1)
            if s.dim == 0:
                y += s.width * 0.9
            else:
                x += s.width * 0.9
            run.append((x, y))
        poles.extend(run)
        for a, b in zip(run[:-1], run[1:]):
            span = float(np.hypot(b[0] - a[0], b[1] - a[1]))
            for k in range(conductors):
                z = pole_h - 0.1 - k * cond_dz
                mid = (0.5 * (a[0] + b[0]), 0.5 * (a[1] + b[1]),
                       z - sag * span)
                wires.append(((a[0], a[1], z), mid, (b[0], b[1], z)))
    return PowerLines(
        poles=np.asarray(poles, np.float32).reshape(-1, 2),
        pole_h=pole_h,
        wires=np.asarray(wires, np.float32).reshape(-1, 3, 3))


def place_ug_elevators(blocks, seed: int = 1, frac: float = 0.25,
                       depth: float = 1.2, cab: float = 0.25,
                       ground_z: float = 0.0) -> list[UgElevator]:
    """One underground-parking elevator near the corner of a fraction
    of (commercial) blocks (ug_elevator_t into the underground garage
    levels)."""
    rg = RandGen(seed + 77, seed + 5)
    out = []
    for (x1, y1, x2, y2, _city) in blocks:
        if rg.randd() >= frac:
            continue
        if (x2 - x1) < 4 * cab or (y2 - y1) < 4 * cab:
            continue
        out.append(UgElevator(x1 + 2 * cab, y1 + 2 * cab, ground_z,
                              depth, cab))
    return out


def structures_to_cobjs(skyways=(), power: PowerLines | None = None,
                        elevators=(), ground_z: float = 0.0,
                        device="cuda"):
    """Collision export: skyway deck boxes, pole cylinders, elevator
    shaft walls.  Returns (CobjSet, cab_platforms) where cab_platforms
    is a PlatformSet moving each elevator cab over its depth; both on
    `device`."""
    from ..scene import cobj as SC
    from ..physics.cobjs import COLL_CUBE, COLL_CYLINDER
    from ..physics import platforms as PP
    sp = SC.SceneParse()
    for sw in skyways:
        sp.cobjs.append(SC.RawCobj(
            COLL_CUBE, (sw.x1, sw.y1, sw.z_bot), (sw.x2, sw.y2, sw.z_top)))
    if power is not None:
        for (x, y) in np.asarray(power.poles):
            sp.cobjs.append(SC.RawCobj(
                COLL_CYLINDER, (float(x), float(y), ground_z),
                (float(x), float(y), ground_z + power.pole_h),
                r1=0.04, r2=0.04))
    cab_ids = []
    for ue in elevators:
        c = ue.cab
        # 4 shaft walls from -depth to ground level
        for (dx1, dy1, dx2, dy2) in ((-c - 0.05, -c, -c, c),
                                     (c, -c, c + 0.05, c),
                                     (-c, -c - 0.05, c, -c),
                                     (-c, c, c, c + 0.05)):
            sp.cobjs.append(SC.RawCobj(
                COLL_CUBE, (ue.x + dx1, ue.y + dy1, ue.ground_z - ue.depth),
                (ue.x + dx2, ue.y + dy2, ue.ground_z + 0.02)))
        # the cab floor rides a platform over the shaft depth
        cab_ids.append(len(sp.cobjs))
        sp.cobjs.append(SC.RawCobj(
            COLL_CUBE, (ue.x - c, ue.y - c, ue.ground_z - 0.04),
            (ue.x + c, ue.y + c, ue.ground_z),
            platform_id=len(cab_ids) - 1))
    cobjs = SC.pack_cobjs(sp, device=device)
    plats = PP.make_platforms(
        cab_ids, [(0.0, 0.0, -e.depth) for e in elevators], speed=0.01,
        device=device) \
        if elevators else None
    return cobjs, plats


def overlay_structures(img, skyways=(), power: PowerLines | None = None,
                       elevators=(), world=None):
    """Overhead-map overlay: skyway decks (cyan), wires (yellow dots at
    poles), elevator shafts (magenta) — mirrors
    map_view.overlay_roads_buildings' raster scheme."""
    import numpy as np
    img = np.asarray(img).copy()
    h, w = img.shape[:2]
    xs = world.x_scene if world is not None else 8.0
    ys = world.y_scene if world is not None else 8.0

    def px(x, y):
        return (int(np.clip((y + ys) / (2 * ys) * (h - 1), 0, h - 1)),
                int(np.clip((x + xs) / (2 * xs) * (w - 1), 0, w - 1)))

    for sw in skyways:
        r1, c1 = px(sw.x1, sw.y1)
        r2, c2 = px(sw.x2, sw.y2)
        img[min(r1, r2):max(r1, r2) + 1,
            min(c1, c2):max(c1, c2) + 1] = (0, 255, 255)
    if power is not None:
        for (x, y) in np.asarray(power.poles):
            r, c = px(float(x), float(y))
            img[r, c] = (255, 255, 0)
    for ue in elevators:
        r, c = px(ue.x, ue.y)
        img[max(r - 1, 0):r + 2, max(c - 1, 0):c + 2] = (255, 0, 255)
    return img

"""Building interiors: walls / rooms / hallways / doors / stairs (port of
`3dworld_tpu/city/floorplan.py`, host numpy code, copied whole).

The reference splits each building part into rooms via wall placement
with hallways in large parts, connecting doors, stairwells and elevators
(`gen_interior_int`, building_floorplan.cpp:325-1313), then ~30 room
content generators.

Here: a seeded recursive-split floorplanner covering EVERY part of the
building (parts stack vertically with setbacks); one split per part is
reused across its floors so stairwells and walls stack, as the
reference's office-building path does.  Walls are emitted as SEGMENTS
with doorway cutouts (not solid slabs with door points), door
connectivity is a spanning tree over the shared-edge room adjacency (so
every room is reachable), the stairwell is a real room
(`Room.is_stairs`) stacked across floors and across parts, and every
room gets a ceiling light for the indirect-lighting pass
(building_lighting.cpp).  Pure host generation (irregular/discrete),
emitting fixed-form arrays for physics/lighting/AI.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..utils.rng import RandGen

# scale factors relative to floor_height (room proportions track the
# building scale, as the reference's wall_thick/doorway_width do)
WALL_THICK_F = 0.12
DOOR_WIDTH_F = 0.8
MIN_ROOM_F = 1.4        # min room span, in floor heights
HALL_MIN_SPAN_F = 4.0   # need this much width for a hallway
HALL_HALF_F = 0.6


@dataclass
class Room:
    x1: float
    y1: float
    x2: float
    y2: float
    floor: int
    is_hallway: bool = False
    is_stairs: bool = False
    part: int = 0

    @property
    def area(self):
        return (self.x2 - self.x1) * (self.y2 - self.y1)


@dataclass
class Interior:
    rooms: list = field(default_factory=list)
    walls: list = field(default_factory=list)   # (x1,y1,z1,x2,y2,z2)
    doors: list = field(default_factory=list)   # (x, y, z, dim)
    stairs: list = field(default_factory=list)  # (x1,y1,x2,y2,floor)
    elevators: list = field(default_factory=list)  # (x1,y1,x2,y2) shafts (all floors)
    num_floors: int = 1
    lights: list = field(default_factory=list)  # (x, y, z, floor) ceiling
    z1: float = 0.0                # z of floor 0 (doors store absolute z)
    floor_height: float = 1.0


def _split_rooms(rg: RandGen, x1, y1, x2, y2, min_room, depth=0):
    """Recursive split into rooms; returns list of (x1,y1,x2,y2)."""
    w = x2 - x1
    h = y2 - y1
    if depth > 4 or (w < 2 * min_room and h < 2 * min_room):
        return [(x1, y1, x2, y2)]
    if w >= h and w >= 2 * min_room:
        cut = x1 + rg.rand_uniform(0.35, 0.65) * w
        return (_split_rooms(rg, x1, y1, cut, y2, min_room, depth + 1)
                + _split_rooms(rg, cut, y1, x2, y2, min_room, depth + 1))
    if h >= 2 * min_room:
        cut = y1 + rg.rand_uniform(0.35, 0.65) * h
        return (_split_rooms(rg, x1, y1, x2, cut, min_room, depth + 1)
                + _split_rooms(rg, x1, cut, x2, y2, min_room, depth + 1))
    return [(x1, y1, x2, y2)]


def _shared_edge(a, b, tol=1e-6):
    """Shared boundary segment between room rects a and b, or None.
    Returns (dim, coord, lo, hi): dim 0 = wall runs along x (rooms abut
    in y at y=coord), dim 1 = wall runs along y."""
    ax1, ay1, ax2, ay2 = a
    bx1, by1, bx2, by2 = b
    # abut in y (a above/below b)
    if abs(ay2 - by1) < tol or abs(ay1 - by2) < tol:
        coord = ay2 if abs(ay2 - by1) < tol else ay1
        lo = max(ax1, bx1)
        hi = min(ax2, bx2)
        if hi - lo > tol:
            return (0, coord, lo, hi)
    if abs(ax2 - bx1) < tol or abs(ax1 - bx2) < tol:
        coord = ax2 if abs(ax2 - bx1) < tol else ax1
        lo = max(ay1, by1)
        hi = min(ay2, by2)
        if hi - lo > tol:
            return (1, coord, lo, hi)
    return None


def _floorplan_part(out: Interior, part, part_id: int, base_floor: int,
                    nf: int, fh: float, rg: RandGen, stair_pt):
    """Rooms/walls/doors/stairs/lights for one part; floors are global
    indices [base_floor, base_floor + nf)."""
    x1, y1, z1p, x2, y2, _z2 = part
    w = x2 - x1
    h = y2 - y1
    long_x = w >= h
    span = h if long_x else w
    min_room = MIN_ROOM_F * fh
    wall_t = WALL_THICK_F * fh
    door_w = DOOR_WIDTH_F * fh

    # one split reused across this part's floors -> stacked walls
    rects = []
    hall_rect = None
    if span >= HALL_MIN_SPAN_F * fh:
        mid = 0.5 * ((y1 + y2) if long_x else (x1 + x2))
        hw = HALL_HALF_F * fh
        if long_x:
            hall_rect = (x1, mid - hw, x2, mid + hw)
            sides = [(x1, y1, x2, mid - hw), (x1, mid + hw, x2, y2)]
        else:
            hall_rect = (mid - hw, y1, mid + hw, y2)
            sides = [(x1, y1, mid - hw, y2), (mid + hw, y1, x2, y2)]
        rects.append(hall_rect)
        for s in sides:
            rects.extend(_split_rooms(rg, *s, min_room))
    else:
        rects.extend(_split_rooms(rg, x1, y1, x2, y2, min_room))

    # the stairwell room: the rect containing the (stacked) stair point
    sx, sy = stair_pt
    stair_ri = 0
    for i, (rx1, ry1, rx2, ry2) in enumerate(rects):
        if rx1 - 1e-6 <= sx <= rx2 + 1e-6 and ry1 - 1e-6 <= sy <= ry2 + 1e-6:
            stair_ri = i
            break

    # room adjacency via shared edges wide enough for a doorway
    R = len(rects)
    edges = []
    for i in range(R):
        for j in range(i + 1, R):
            se = _shared_edge(rects[i], rects[j])
            if se is not None and se[3] - se[2] >= door_w + 2 * wall_t:
                edges.append((i, j, se))

    # spanning tree from room 0 -> every room reachable; hallway (rect 0
    # when present) additionally doors to every neighbor
    adj = {i: [] for i in range(R)}
    for (i, j, se) in edges:
        adj[i].append((j, se))
        adj[j].append((i, se))
    door_edges = {}
    seen = {0}
    stack = [0]
    while stack:
        u = stack.pop()
        for (v, se) in adj[u]:
            if v not in seen:
                seen.add(v)
                door_edges[(min(u, v), max(u, v))] = se
                stack.append(v)
    if hall_rect is not None:
        for (v, se) in adj[0]:
            door_edges.setdefault((0, v) if 0 < v else (v, 0), se)

    for fl_local in range(nf):
        fl = base_floor + fl_local
        z = z1p + fl_local * fh
        for i, (rx1, ry1, rx2, ry2) in enumerate(rects):
            out.rooms.append(Room(rx1, ry1, rx2, ry2, fl,
                                  is_hallway=(hall_rect is not None and i == 0),
                                  is_stairs=(i == stair_ri and nf + base_floor > 1),
                                  part=part_id))
            out.lights.append((0.5 * (rx1 + rx2), 0.5 * (ry1 + ry2),
                               z + 0.9 * fh, fl))

        # doors + walls with cutouts along each shared edge
        doored = {}
        for (i, j), (dim, coord, lo, hi) in door_edges.items():
            dpos = 0.5 * (lo + hi)
            if dim == 0:
                out.doors.append((dpos, coord, z, 0))
            else:
                out.doors.append((coord, dpos, z, 1))
            doored[(i, j, dim, round(coord, 6))] = dpos
        emitted = set()
        for (i, j, se) in edges:
            dim, coord, lo, hi = se
            key = (dim, round(coord, 6), round(lo, 6), round(hi, 6))
            if key in emitted:
                continue
            emitted.add(key)
            gap = doored.get((min(i, j), max(i, j), dim, round(coord, 6)))
            segs = [(lo, hi)] if gap is None else \
                [(lo, gap - 0.5 * door_w), (gap + 0.5 * door_w, hi)]
            for (a, b) in segs:
                if b - a < 1e-6:
                    continue
                if dim == 0:
                    out.walls.append((a, coord - wall_t / 2, z,
                                      b, coord + wall_t / 2, z + fh))
                else:
                    out.walls.append((coord - wall_t / 2, a, z,
                                      coord + wall_t / 2, b, z + fh))

        # stairs up from this floor (inside the stairwell room); the top
        # floor of a part still gets stairs when another part sits above
        if fl_local < nf - 1 or getattr(out, "_more_parts", 0) > 0:
            srx1, sry1, srx2, sry2 = rects[stair_ri]
            s_sz = min(2.5 * fh, srx2 - srx1, sry2 - sry1)
            scx = min(max(sx, srx1 + 0.5 * s_sz), srx2 - 0.5 * s_sz)
            scy = min(max(sy, sry1 + 0.5 * s_sz), sry2 - 0.5 * s_sz)
            out.stairs.append((scx - 0.5 * s_sz, scy - 0.5 * s_sz,
                               scx + 0.5 * s_sz, scy + 0.5 * s_sz, fl))
    return rects, stair_ri


def gen_interior(part, num_floors: int, floor_height: float, seed: int,
                 has_basement: bool = False, has_attic: bool = False) -> Interior:
    """Floorplan one building part (x1,y1,z1,x2,y2,z2); optional basement
    level (floor -1, one storage room) and attic (single room at the top)
    ~ the reference's basements/attics (building_floorplan.cpp)."""
    x1, y1, z1, x2, y2, z2 = part
    rg = RandGen(seed + 11, 3 * seed + 7)
    out = Interior(num_floors=num_floors, z1=z1, floor_height=floor_height)
    if has_basement:
        out.rooms.append(Room(x1, y1, x2, y2, -1))
        out.stairs.append((x1 + 0.1 * (x2 - x1), y1 + 0.1 * (y2 - y1),
                           x1 + 0.1 * (x2 - x1) + 2 * floor_height,
                           y1 + 0.1 * (y2 - y1) + 2 * floor_height, -1))
    if has_attic:
        out.rooms.append(Room(x1, y1, x2, y2, num_floors))

    w = x2 - x1
    h = y2 - y1
    sx = x1 + rg.rand_uniform(0.25, 0.75) * w
    sy = y1 + rg.rand_uniform(0.25, 0.75) * h
    # elevator shaft next to the stairwell in buildings tall enough
    # (building_floorplan adds stacked elevators; >= 3 floors here)
    if num_floors >= 3:
        fh = floor_height
        ex = min(sx + 2.5 * fh, x2 - 1.5 * fh)
        out.elevators.append((ex, sy, min(ex + 1.2 * fh, x2),
                              min(sy + 1.2 * fh, y2)))
    _floorplan_part(out, part, 0, 0, num_floors, floor_height, rg, (sx, sy))
    return out


def gen_building_interiors(buildings, params, seed: int = 1):
    """Floorplan ALL parts of every building (gen_buildings interior
    pass; the reference interiors every part, building_floorplan.cpp:325).
    Parts stack vertically with setbacks; global floor indices run up the
    stack, and the shared stairwell point sits inside the intersection of
    all footprints (setbacks nest, so the top part's footprint works) so
    stairwell rooms stack across part boundaries."""
    for bi, b in enumerate(buildings):
        if not b.parts:
            continue
        rg = RandGen(seed + bi, 2 * seed + 3)
        fh = params.floor_height
        top = b.parts[-1]
        sx = 0.5 * (top[0] + top[3]) + (rg.randd() - 0.5) * 0.3 * (top[3] - top[0])
        sy = 0.5 * (top[1] + top[4]) + (rg.randd() - 0.5) * 0.3 * (top[4] - top[1])
        total_floors = sum(max(1, int(round((p[5] - p[2]) / fh)))
                           for p in b.parts)
        inter = Interior(num_floors=total_floors, z1=b.parts[0][2],
                         floor_height=fh)
        if rg.randd() < 0.3:
            p0 = b.parts[0]
            inter.rooms.append(Room(p0[0], p0[1], p0[3], p0[4], -1))
            inter.stairs.append((sx - fh, sy - fh, sx + fh, sy + fh, -1))
        base = 0
        for pi, p in enumerate(b.parts):
            nf = max(1, int(round((p[5] - p[2]) / fh)))
            inter._more_parts = len(b.parts) - 1 - pi  # stairs up to next part
            _floorplan_part(inter, p, pi, base, nf, fh, rg, (sx, sy))
            base += nf
        inter._more_parts = 0
        if b.roof_type == 1:
            pt = b.parts[-1]
            inter.rooms.append(Room(pt[0], pt[1], pt[3], pt[4], total_floors))
        b.interior = inter
    return buildings


# ---------------------------------------------------------------------------
# elevator car state machine (the reference's elevator_t + the
# player_in_elevator states 0=out 1=in 2=doors closed 3=moving,
# building_gameplay.cpp:17)
# ---------------------------------------------------------------------------

@dataclass
class ElevatorCar:
    """One car in a shaft: floor-to-floor travel with door timing."""

    z: float = 0.0               # car height in floor units
    target: int = 0              # destination floor
    state: int = 0               # 0 idle(open), 1 closing, 2 moving, 3 opening
    timer: int = 0
    DOOR_TICKS: int = 20
    SPEED: float = 0.05          # floors per tick

    def call(self, floor: int):
        if self.state == 0 and floor != round(self.z):
            self.target = floor
            self.state = 1
            self.timer = self.DOOR_TICKS

    def step(self):
        if self.state == 1:          # doors closing
            self.timer -= 1
            if self.timer <= 0:
                self.state = 2
        elif self.state == 2:        # moving
            d = self.target - self.z
            if abs(d) <= self.SPEED:
                self.z = float(self.target)
                self.state = 3
                self.timer = self.DOOR_TICKS
            else:
                self.z += self.SPEED if d > 0 else -self.SPEED
        elif self.state == 3:        # doors opening
            self.timer -= 1
            if self.timer <= 0:
                self.state = 0
        return self.state

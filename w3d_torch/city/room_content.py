"""Room content generation: furnishing rooms by assigned type (port of
`3dworld_tpu/city/room_content.py`, host numpy code, copied whole).

The reference has ~30 specialized room generators (kitchens, bathrooms,
offices, retail, malls, jails, hospitals, ... —
building_room_obj_place.cpp 5145 LoC, building_room_geom.cpp 8229 LoC).
This module provides the same *mechanism* at smaller catalog size: rooms
get types assigned by floor/size heuristics, then a per-type generator
places furniture boxes (SoA cubes + type ids) with wall-alignment and
clearance rules — deterministic from the building seed.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..utils.rng import RandGen

# room types
(R_HALL, R_BEDROOM, R_BATHROOM, R_KITCHEN, R_LIVING, R_OFFICE, R_DINING,
 R_STORAGE, R_LIBRARY, R_RETAIL, R_SERVER, R_LAUNDRY, R_UTILITY,
 R_CONFERENCE, R_CLASSROOM, R_CAFETERIA, R_GAME, R_JAIL, R_HOSPITAL,
 R_FACTORY, R_DATACENTER, R_RESTAURANT, R_PARKING,
 R_OPERATING, R_WAITING, R_HOTEL, R_WAREHOUSE, R_BAR) = range(28)

# furniture kinds
(F_BED, F_TOILET, F_SINK, F_TUB, F_COUNTER, F_FRIDGE, F_STOVE, F_TABLE,
 F_CHAIR, F_COUCH, F_TV, F_DESK, F_BOOKCASE, F_SHELF, F_RACK, F_LAMP,
 F_RUG, F_PLANT, F_WARDROBE, F_NIGHTSTAND, F_DRESSER, F_MICROWAVE,
 F_WASHER, F_DRYER, F_WATER_HEATER, F_FURNACE, F_POOL_TABLE,
 F_WHITEBOARD, F_CONF_TABLE, F_VENDING, F_JAIL_BARS, F_HOSPITAL_BED,
 F_MACHINE, F_SERVER_RACK_ROW, F_BOOTH, F_PARK_SPACE) = range(36)

# secondary / surface / wall kinds (building_room_obj_expand.cpp: items
# placed ON parent surfaces; building_room_geom wall decorations)
(F_PILLOW, F_MONITOR, F_KEYBOARD, F_COMPUTER, F_BOOK, F_BOTTLE, F_PLATE,
 F_PICTURE, F_MIRROR, F_TOWEL_RACK, F_CUBICLE, F_RAILING, F_CABINET,
 F_PAPER, F_PAN) = range(36, 51)
# nested/expanded contents + per-room fixtures (add_closet_to_room,
# building_room_obj_expand.cpp hanger/box expansion; TYPE_LIGHT,
# TYPE_LAVALAMP, floor clothes TYPE_TEESHIRT/TYPE_PANTS)
(F_CLOSET, F_HANGER, F_CLOTHES, F_BOX, F_CEIL_LIGHT, F_LAVALAMP,
 F_FLOOR_CLOTHES, F_PILLAR, F_RAMP, F_OLD_CHAIR, F_CHEST,
 F_PIPE, F_DUCT) = range(51, 64)
# institutional kinds (building_school.cpp, building_hospital.cpp,
# building_jail.cpp): chalkboards behind teacher desks, privacy curtains
# between hospital beds, school hallway lockers, operating tables,
# solid jail-cell partition walls (bars are F_JAIL_BARS above)
(F_CHALKBOARD, F_CURTAIN, F_LOCKER, F_OPERATING_TABLE,
 F_CELL_WALL) = range(64, 69)
# industrial kinds (building_machines.cpp): chem tanks and conveyor
# belts in factory machine grids
F_TANK, F_CONV_BELT = 69, 70
# round-4 depth pass — restaurant/bar fittings (building_room_obj_place
# dining/bar paths), datacenter fittings (server rows + cable trays),
# machine internals (building_machines.cpp gauges/valves/breaker
# panels), shelf/rack content variety (building_room_obj_expand.cpp
# TYPE_PAINTCAN/TYPE_LG_BALL/TYPE_SPRAYCAN/TYPE_FLASHLIGHT/TYPE_FEXT),
# and the basement pipe network types (building_basement.cpp:853-864
# sewer / cold water / hot water / gas + vertical risers)
(F_STOOL, F_BAR, F_CASH_REG, F_WINE_RACK, F_MENU_BOARD,
 F_SERVER, F_CABLE_TRAY, F_VENT_TILE, F_PDU, F_CRAC,
 F_GAUGE, F_VALVE, F_HOSE, F_BREAKER_PANEL, F_LADDER, F_CATWALK,
 F_PAINT_CAN, F_BALL, F_SPRAYCAN, F_TRASHCAN, F_FIRE_EXT, F_FLASHLIGHT,
 F_SEWER_PIPE, F_CW_PIPE, F_HW_PIPE, F_GAS_PIPE,
 F_PIPE_RISER) = range(71, 98)
# round-5 interaction surface (building_interact.cpp): wall light
# switches by doors (add_light_switches_to_room), window blinds in
# bedrooms (add_window_coverings)
F_LIGHT_SWITCH, F_BLINDS = 98, 99
# clocks (building_clocks.cpp): analog/digital wall clocks in
# classrooms, digital nightstand clocks in house bedrooms; display
# state lives in city/clocks.py
F_CLOCK = 100
NUM_FURNITURE_KINDS = 101

# building types (building_defs.h:137 BTYPE_*; the subset with distinct
# interior content models here)
(BT_HOUSE, BT_OFFICE, BT_SCHOOL, BT_HOSPITAL, BT_JAIL, BT_APARTMENT,
 BT_HOTEL, BT_WAREHOUSE, BT_POLICE, BT_FIRE_STATION, BT_CONV_STORE) = range(11)

# per-room-type furniture recipes: (kind, count, against_wall, w, d, h)
# — ONLY for room types without a composite generator; types in
# _COMPOSITE_GENS (bedroom/bathroom/kitchen/living/office/dining/
# classroom/hospital/operating/jail/cafeteria/waiting/hotel/warehouse/
# factory/parking) never read a recipe
_RECIPES = {
    R_STORAGE: [(F_SHELF, 3, True, 0.3, 0.1, 0.3)],
    R_LIBRARY: [(F_BOOKCASE, 4, True, 0.25, 0.08, 0.3), (F_TABLE, 1, False, 0.25, 0.15, 0.14),
                (F_CHAIR, 2, False, 0.1, 0.1, 0.15)],
    R_RETAIL: [(F_COUNTER, 1, True, 0.3, 0.12, 0.18), (F_RACK, 4, False, 0.15, 0.15, 0.25)],
    R_SERVER: [(F_RACK, 6, True, 0.15, 0.2, 0.4)],
    R_LAUNDRY: [(F_WASHER, 1, True, 0.12, 0.12, 0.16), (F_DRYER, 1, True, 0.12, 0.12, 0.16),
                (F_COUNTER, 1, True, 0.25, 0.1, 0.18)],
    R_UTILITY: [(F_WATER_HEATER, 1, True, 0.1, 0.1, 0.3), (F_FURNACE, 1, True, 0.14, 0.12, 0.3),
                (F_SHELF, 1, True, 0.25, 0.08, 0.3)],
    R_CONFERENCE: [(F_CONF_TABLE, 1, False, 0.45, 0.2, 0.14), (F_CHAIR, 6, False, 0.1, 0.1, 0.15),
                   (F_WHITEBOARD, 1, True, 0.3, 0.02, 0.2), (F_TV, 1, True, 0.25, 0.05, 0.18)],
    R_GAME: [(F_POOL_TABLE, 1, False, 0.35, 0.2, 0.14), (F_COUCH, 1, True, 0.4, 0.16, 0.14),
             (F_TV, 1, True, 0.3, 0.06, 0.2)],
}


@dataclass
class RoomObjects:
    cubes: list = field(default_factory=list)   # (x1,y1,z1,x2,y2,z2)
    kinds: list = field(default_factory=list)
    rooms: list = field(default_factory=list)   # room index per object
    room_types: list = field(default_factory=list)
    parent: list = field(default_factory=list)  # -1, or index of the
    # surface object this one sits on (books on shelves, monitors on
    # desks — building_room_obj_expand semantics)
    rot: list = field(default_factory=list)     # facing dir 0..3 (+x,+y,-x,-y)

    def add(self, ri, kind, x1, y1, z1, x2, y2, z2, parent=-1, rot=0):
        self.cubes.append((x1, y1, z1, x2, y2, z2))
        self.kinds.append(kind)
        self.rooms.append(ri)
        self.parent.append(parent)
        self.rot.append(rot)
        return len(self.cubes) - 1


def assign_room_types(interior, rg: RandGen, is_office_bldg: bool = False,
                      btype: int | None = None, fh: float = 0.1):
    """Type assignment heuristics (~ assign_special_room_types +
    the per-building-type room preference tables of building_school/
    hospital/jail.cpp `room_pref_t`): hallways stay halls; ground floor
    gets kitchen/living (houses) or entry/waiting/cafeteria
    (institutions); small rooms become bathrooms; the institutional
    types fill remaining rooms with their signature room kind
    (classroom / hospital bed room / jail cell block)."""
    if btype is None:
        btype = BT_OFFICE if is_office_bldg else BT_HOUSE
    types = []
    per_floor_first = {}
    for r in interior.rooms:
        if r.is_hallway:
            types.append(R_HALL)
            continue
        area = r.area
        first = not per_floor_first.get(r.floor)
        per_floor_first[r.floor] = True
        if btype == BT_SCHOOL:
            # schools: mostly classrooms; per floor one special room
            # (cafeteria on the ground floor, library above, admin
            # office), small rooms become bathrooms.  Classrooms need
            # >= 3 x 1.8 floor-spacings (add_classroom_objs size gate,
            # building_school.cpp:17)
            w_ = r.x2 - r.x1
            h_ = r.y2 - r.y1
            fits = (max(w_, h_) >= 3.0 * fh and min(w_, h_) >= 1.8 * fh)
            if area < 0.02:
                types.append(R_BATHROOM)
            elif first:
                types.append(R_CAFETERIA if r.floor == 0 else
                             (R_LIBRARY if r.floor == 1 else R_OFFICE))
            else:
                types.append(R_CLASSROOM if fits else R_OFFICE)
            continue
        if btype == BT_HOSPITAL:
            # hospitals: waiting room at the entrance, one operating
            # room per upper floor (first large room), bed rooms
            # otherwise (add_hospital_room_objs fills them with beds)
            if area < 0.02:
                types.append(R_BATHROOM)
            elif r.floor == 0 and first:
                types.append(R_WAITING)
            elif r.floor > 0 and first and area > 0.03:
                types.append(R_OPERATING)
            else:
                types.append(R_HOSPITAL)
            continue
        if btype == BT_JAIL:
            # prisons: entry with reception desk, a security office and
            # cafeteria on the ground floor, cell blocks elsewhere
            if r.floor == 0 and first:
                types.append(R_OFFICE)       # entry/reception
            elif r.floor == 0 and area > 0.04:
                types.append(R_CAFETERIA)
            else:
                types.append(R_JAIL)
            continue
        if btype == BT_HOTEL:
            # hotels: each non-hall room is a hotel room (the reference
            # carves living/bed/bath sub-rooms per unit,
            # building_floorplan.cpp:1483-1560; condensed here to a
            # furnished hotel room with a bathroom corner)
            types.append(R_BATHROOM if area < 0.015 else R_HOTEL)
            continue
        if btype == BT_APARTMENT:
            # apartments: rooms cycle unit roles — living w/ kitchenette,
            # bedroom, bathroom (building_floorplan.cpp make_small_apt)
            k = len(types) % 3
            types.append(R_BATHROOM if area < 0.015 else
                         (R_LIVING, R_BEDROOM, R_KITCHEN)[k])
            continue
        if btype == BT_WAREHOUSE:
            # warehouses: the big open rooms get shelf-rack rows
            # (building_factory.cpp RTYPE_WAREHOUSE + add_shelf_rack
            # rows); small rooms become the office/bathroom block
            if area < 0.015:
                types.append(R_BATHROOM)
            elif area < 0.03:
                types.append(R_OFFICE)
            else:
                types.append(R_WAREHOUSE)
            continue
        if btype == BT_POLICE:
            # police stations: offices + holding cells on the ground
            # floor + locker room (building_rooms.cpp:1030 adds jail
            # rooms for police stations; offices get cubicles like
            # large office buildings, :1015).  The first big-enough
            # ground-floor room becomes the holding cell block.
            if area < 0.015:
                types.append(R_BATHROOM)
            elif (r.floor == 0 and area > 0.03
                  and not per_floor_first.get("holding")):
                per_floor_first["holding"] = True
                types.append(R_JAIL)            # holding cell block
            elif first:
                types.append(R_STORAGE)         # evidence/locker room
            else:
                types.append(R_OFFICE)
            continue
        if btype == BT_FIRE_STATION:
            # fire stations: the big ground-floor room is the apparatus
            # bay (vehicle slots like a parking garage), upstairs gets
            # bunks + kitchen + office
            if area < 0.015:
                types.append(R_BATHROOM)
            elif r.floor == 0 and area > 0.03:
                types.append(R_PARKING)         # apparatus bay
            elif first and r.floor > 0:
                types.append(R_KITCHEN)
            elif r.floor > 0 and (len(types) % 3) == 1:
                types.append(R_BEDROOM)         # bunk room
            else:
                types.append(R_OFFICE)
            continue
        if btype == BT_CONV_STORE:
            # convenience stores: one retail floor (shelf racks +
            # checkout), back room storage
            types.append(R_STORAGE if (area < 0.02 or not first
                                       and len(types) % 4 == 3)
                         else R_RETAIL)
            continue
        if btype == BT_OFFICE:
            roll = rg.rand() % 16
            types.append({0: R_SERVER, 1: R_STORAGE, 2: R_CONFERENCE,
                          3: R_CLASSROOM, 4: R_CAFETERIA, 5: R_DATACENTER,
                          6: R_RESTAURANT, 8: R_BAR,
                          7: R_HOSPITAL}.get(roll, R_OFFICE))
            continue
        if area < 0.02:
            types.append(R_BATHROOM)
        elif r.floor == 0 and not per_floor_first.get("kitchen"):
            per_floor_first["kitchen"] = True
            types.append(R_KITCHEN)
        elif r.floor == 0 and area > 0.04:
            types.append(R_LIVING if rg.rand_bool() else R_DINING)
        else:
            roll = rg.rand() % 12
            types.append({0: R_LIBRARY, 1: R_STORAGE, 2: R_LAUNDRY,
                          3: R_UTILITY, 4: R_GAME}.get(roll, R_BEDROOM))
    return types


class _Placer:
    """Shared placement engine: wall alignment, overlap rejection, and
    DOOR CLEARANCE — nothing may block a doorway (the reference's
    is_valid_placement_for_room + door blocking checks,
    building_room_obj_place.cpp)."""

    def __init__(self, rg, room, doors, door_clear):
        self.rg = rg
        self.room = room
        self.placed = []
        self.doors = doors          # [(x, y)] on this room's floor
        self.clear = door_clear

    def blocks_door(self, x1, y1, x2, y2):
        c = self.clear
        return any(x1 - c < dx < x2 + c and y1 - c < dy < y2 + c
                   for (dx, dy) in self.doors)

    def overlaps(self, x1, y1, x2, y2):
        return any(x1 < px2 and x2 > px1 and y1 < py2 and y2 > py1
                   for (px1, py1, px2, py2) in self.placed)

    def commit(self, x1, y1, x2, y2):
        self.placed.append((x1, y1, x2, y2))

    def try_place(self, w, d, against_wall, tries=8, commit=True):
        """Returns (x, y, rot) or None.  rot faces INTO the room
        (0 +x, 1 +y, 2 -x, 3 -y)."""
        r = self.room
        if w > (r.x2 - r.x1) - 0.02 or d > (r.y2 - r.y1) - 0.02:
            return None
        for _ in range(tries):
            rot = 0
            if against_wall:
                wall = self.rg.rand() % 4
                if wall == 0:
                    x = r.x1 + 0.01
                    y = r.y1 + self.rg.randd() * max(r.y2 - r.y1 - d, 0.01)
                    rot = 0
                elif wall == 1:
                    x = r.x2 - w - 0.01
                    y = r.y1 + self.rg.randd() * max(r.y2 - r.y1 - d, 0.01)
                    rot = 2
                elif wall == 2:
                    x = r.x1 + self.rg.randd() * max(r.x2 - r.x1 - w, 0.01)
                    y = r.y1 + 0.01
                    rot = 1
                else:
                    x = r.x1 + self.rg.randd() * max(r.x2 - r.x1 - w, 0.01)
                    y = r.y2 - d - 0.01
                    rot = 3
            else:
                x = r.x1 + self.rg.randd() * max(r.x2 - r.x1 - w, 0.01)
                y = r.y1 + self.rg.randd() * max(r.y2 - r.y1 - d, 0.01)
                rot = self.rg.rand() % 4
            if x < r.x1 or y < r.y1 or x + w > r.x2 or y + d > r.y2:
                continue
            if self.overlaps(x, y, x + w, y + d):
                continue
            if self.blocks_door(x, y, x + w, y + d):
                continue
            if commit:
                self.commit(x, y, x + w, y + d)
            return (x, y, rot)
        return None


def _surface_items(out, pl, rg, ri, kind, idx, x, y, z_top, w, d, scale):
    """Small objects ON a surface (building_room_obj_expand.cpp): books
    on shelves/bookcases, monitor+keyboard on desks, bottles/plates on
    tables and counters, pans on stoves."""
    def on_top(k, fw, fd, fh, fx, fy):
        out.add(ri, k, fx, fy, z_top, fx + fw * scale, fy + fd * scale,
                z_top + fh * scale, parent=idx)

    if kind in (F_BOOKCASE, F_SHELF):
        n = 2 + rg.rand() % 4
        for i in range(n):
            bx = x + (0.05 + 0.8 * i / n) * w
            on_top(F_BOOK, 0.02, 0.04, 0.05, bx, y + 0.2 * d)
    elif kind == F_DESK:
        on_top(F_MONITOR, 0.08, 0.02, 0.08, x + 0.3 * w, y + 0.2 * d)
        on_top(F_KEYBOARD, 0.08, 0.03, 0.01, x + 0.3 * w, y + 0.6 * d)
        if rg.rand_bool():
            on_top(F_PAPER, 0.04, 0.05, 0.002, x + 0.7 * w, y + 0.3 * d)
    elif kind in (F_TABLE, F_CONF_TABLE, F_COUNTER):
        n = 1 + rg.rand() % 3
        for i in range(n):
            k = (F_BOTTLE, F_PLATE, F_BOOK)[rg.rand() % 3]
            on_top(k, 0.03, 0.03, 0.04 if k == F_BOTTLE else 0.01,
                   x + (0.1 + 0.7 * rg.randd()) * w,
                   y + (0.1 + 0.7 * rg.randd()) * d)
    elif kind == F_STOVE:
        on_top(F_PAN, 0.05, 0.05, 0.02, x + 0.25 * w, y + 0.25 * d)
    elif kind == F_RACK:
        # retail/storage rack contents — the full expand variety
        # (building_room_obj_expand.cpp get_shelf_objects: boxes,
        # bottles, plates, paint cans, balls, spray cans, flashlights)
        n = 2 + rg.rand() % 5
        sizes = {F_BOX: (0.04, 0.04, 0.04), F_BOTTLE: (0.02, 0.02, 0.04),
                 F_PLATE: (0.03, 0.03, 0.01),
                 F_PAINT_CAN: (0.025, 0.025, 0.035),
                 F_BALL: (0.03, 0.03, 0.03),
                 F_SPRAYCAN: (0.015, 0.015, 0.04),
                 F_FLASHLIGHT: (0.015, 0.04, 0.015)}
        ks = list(sizes)
        for i in range(n):
            k = ks[rg.rand() % len(ks)]
            fw, fd, fz = sizes[k]
            on_top(k, fw, fd, fz, x + (0.05 + 0.8 * i / n) * w,
                   y + (0.1 + 0.5 * rg.randd()) * d)
    elif kind == F_NIGHTSTAND:
        on_top(F_LAVALAMP if rg.rand() % 4 == 0 else F_LAMP,
               0.04, 0.04, 0.08, x + 0.2 * w, y + 0.2 * d)


def _gen_closet(out, pl, rg, ri, room, z0, fh, scale):
    """Closet with EXPANDED contents (add_closet_to_room +
    building_room_obj_expand.cpp): hangers with clothes on a rod, boxes
    on the floor inside — nested objects parented to the closet."""
    cw = min(0.3 * scale, 0.5 * (room.x2 - room.x1))
    cd = min(0.12 * scale, 0.3 * (room.y2 - room.y1))
    p = pl.try_place(cw, cd, True, tries=12)
    if p is None:
        return
    x, y, rot = p
    ci = out.add(ri, F_CLOSET, x, y, z0, x + cw, y + cd, z0 + 0.95 * fh,
                 rot=rot)
    nh = 2 + rg.rand() % 4
    for k in range(nh):
        hx = x + (0.1 + 0.8 * k / nh) * cw
        hi = out.add(ri, F_HANGER, hx, y + 0.4 * cd, z0 + 0.75 * fh,
                     hx + 0.01, y + 0.6 * cd, z0 + 0.8 * fh, parent=ci)
        if rg.randd() < 0.7:    # most hangers hold clothes
            out.add(ri, F_CLOTHES, hx - 0.02, y + 0.2 * cd, z0 + 0.5 * fh,
                    hx + 0.03, y + 0.8 * cd, z0 + 0.75 * fh, parent=hi)
    for k in range(rg.rand() % 3):
        bx = x + (0.1 + 0.6 * rg.randd()) * cw
        out.add(ri, F_BOX, bx, y + 0.2 * cd, z0,
                bx + 0.08 * scale, y + 0.9 * cd, z0 + 0.07 * scale,
                parent=ci)


def _gen_bedroom(out, pl, rg, ri, room, z0, fh, scale):
    """Bedroom generator (add_bedroom_objs): bed against a wall with
    pillow, nightstands FLANKING the bed with lamps (or a lavalamp),
    closet with expanded contents, dresser with mirror, clothes dropped
    on the floor, rug under the middle."""
    # fit the bed to the room (the reference scales bed size to the
    # room's dimensions, add_bed building_room_obj_place.cpp)
    rw = room.x2 - room.x1
    rh = room.y2 - room.y1
    bw = min(0.45 * scale, 0.55 * max(rw, rh))
    bd = min(bw * (2.0 / 3.0), 0.45 * min(rw, rh))
    p = pl.try_place(bw, bd, True, tries=16)
    if p:
        x, y, rot = p
        bi = out.add(ri, F_BED, x, y, z0, x + bw, y + bd, z0 + 0.12 * scale,
                     rot=rot)
        out.add(ri, F_PILLOW, x + 0.05 * scale, y + 0.02 * scale,
                z0 + 0.12 * scale, x + 0.2 * scale, y + 0.1 * scale,
                z0 + 0.15 * scale, parent=bi)
        nw = 0.08 * scale
        for side in (-1, 1):
            nx_ = x + (bw if side > 0 else -nw)
            if room.x1 <= nx_ and nx_ + nw <= room.x2 \
                    and not pl.overlaps(nx_, y, nx_ + nw, y + nw) \
                    and not pl.blocks_door(nx_, y, nx_ + nw, y + nw):
                pl.commit(nx_, y, nx_ + nw, y + nw)
                ni = out.add(ri, F_NIGHTSTAND, nx_, y, z0, nx_ + nw,
                             y + nw, z0 + 0.1 * scale)
                _surface_items(out, pl, rg, ri, F_NIGHTSTAND, ni, nx_, y,
                               z0 + 0.1 * scale, nw, nw, scale)
                if rg.rand_bool():
                    # digital clock on the nightstand facing the bed
                    # (add_nightstand_clock building_clocks.cpp:211)
                    from . import clocks as CK
                    ck, _, _ = CK.nightstand_clock_cube(
                        (nx_, y, z0, nx_ + nw, y + nw, z0 + 0.1 * scale),
                        (x + 0.5 * bw, y + 0.5 * bd), fh, rg)
                    out.add(ri, F_CLOCK, ck[0], ck[1], ck[2], ck[3],
                            ck[4], ck[5], parent=ni)
    _gen_closet(out, pl, rg, ri, room, z0, fh, scale)
    for kind, w, d, h in ((F_DRESSER, 0.18, 0.1, 0.14),
                          (F_WARDROBE, 0.2, 0.1, 0.3),
                          (F_DESK, 0.25, 0.15, 0.15)):
        p = pl.try_place(w * scale, d * scale, True)
        if p:
            x, y, rot = p
            i = out.add(ri, kind, x, y, z0, x + w * scale, y + d * scale,
                        z0 + h * scale, rot=rot)
            _surface_items(out, pl, rg, ri, kind, i, x, y, z0 + h * scale,
                           w * scale, d * scale, scale)
            if kind == F_DRESSER:
                # mirror above the dresser (TYPE_DRESS_MIR)
                out.add(ri, F_MIRROR, x, y, z0 + h * scale,
                        x + w * scale, y + 0.01, z0 + h * scale + 0.3 * fh,
                        parent=i)
    # clothes dropped on the floor (TYPE_TEESHIRT / TYPE_PANTS)
    for _ in range(rg.rand() % 3):
        fx = room.x1 + (0.1 + 0.8 * rg.randd()) * (room.x2 - room.x1)
        fy = room.y1 + (0.1 + 0.8 * rg.randd()) * (room.y2 - room.y1)
        out.add(ri, F_FLOOR_CLOTHES, fx, fy, z0, fx + 0.06 * scale,
                fy + 0.05 * scale, z0 + 0.01)
    # rug under the room center (doesn't block anything)
    cx, cy = 0.5 * (room.x1 + room.x2), 0.5 * (room.y1 + room.y2)
    rw, rd = 0.2 * scale, 0.15 * scale
    out.add(ri, F_RUG, cx - rw, cy - rd, z0, cx + rw, cy + rd, z0 + 0.004)
    _wall_picture(out, rg, ri, room, z0, fh)


def _gen_bathroom(out, pl, rg, ri, room, z0, fh, scale):
    """add_bathroom_objs: toilet/sink/tub on walls, MIRROR above the
    sink, towel rack near the tub."""
    for kind, w, d, h in ((F_TOILET, 0.12, 0.16, 0.12),
                          (F_TUB, 0.35, 0.16, 0.1)):
        p = pl.try_place(w * scale, d * scale, True)
        if p:
            x, y, rot = p
            out.add(ri, kind, x, y, z0, x + w * scale, y + d * scale,
                    z0 + h * scale, rot=rot)
            if kind == F_TUB:
                out.add(ri, F_TOWEL_RACK, x, y - 0.01, z0 + 0.5 * fh,
                        x + 0.15 * scale, y, z0 + 0.55 * fh)
    p = pl.try_place(0.14 * scale, 0.1 * scale, True)
    if p:
        x, y, rot = p
        si = out.add(ri, F_SINK, x, y, z0, x + 0.14 * scale,
                     y + 0.1 * scale, z0 + 0.18 * scale, rot=rot)
        out.add(ri, F_MIRROR, x, y, z0 + 0.5 * fh, x + 0.14 * scale,
                y + 0.01, z0 + 0.8 * fh, parent=si)


def _gen_kitchen(out, pl, rg, ri, room, z0, fh, scale):
    """add_kitchen_objs: an L-run of counters along two adjacent walls
    with embedded sink + stove and upper cabinets, fridge at the run's
    end, table with chairs AROUND it."""
    ch = 0.18 * scale
    cd = 0.12 * scale
    # counter run along the -y wall
    run_w = min(0.8 * (room.x2 - room.x1), 1.0 * scale)
    x0 = room.x1 + 0.01
    y0 = room.y1 + 0.01
    segs = max(int(run_w / (0.3 * scale)),
               2 if run_w >= 0.15 * scale else 1)
    for i in range(segs):
        sx = x0 + i * run_w / segs
        ex = x0 + (i + 1) * run_w / segs
        if pl.overlaps(sx, y0, ex, y0 + cd) or pl.blocks_door(sx, y0, ex, y0 + cd):
            continue
        pl.commit(sx, y0, ex, y0 + cd)
        kind = F_COUNTER if i not in (0, segs - 1) else (F_SINK if i == 0 else F_STOVE)
        ci = out.add(ri, kind, sx, y0, z0, ex, y0 + cd, z0 + ch, rot=1)
        out.add(ri, F_CABINET, sx, y0, z0 + 0.6 * fh, ex, y0 + 0.7 * cd,
                z0 + 0.95 * fh, parent=ci)
        _surface_items(out, pl, rg, ri,
                       F_STOVE if kind == F_STOVE else F_COUNTER,
                       ci, sx, y0, z0 + ch, ex - sx, cd, scale)
        if kind == F_COUNTER and i == 1:    # microwave on the counter
            out.add(ri, F_MICROWAVE, sx + 0.01, y0 + 0.01, z0 + ch,
                    sx + 0.01 + 0.08 * scale, y0 + 0.01 + 0.06 * scale,
                    z0 + ch + 0.06 * scale, parent=ci)
    # short counter runs (segs == 1) hold only the sink; place the
    # stove standalone so every kitchen still cooks
    if segs < 2:
        p = pl.try_place(0.14 * scale, 0.12 * scale, True)
        if p:
            x, y, rot = p
            si = out.add(ri, F_STOVE, x, y, z0, x + 0.14 * scale,
                         y + 0.12 * scale, z0 + ch, rot=rot)
            _surface_items(out, pl, rg, ri, F_STOVE, si, x, y, z0 + ch,
                           0.14 * scale, 0.12 * scale, scale)
    p = pl.try_place(0.14 * scale, 0.14 * scale, True)
    if p:
        x, y, rot = p
        out.add(ri, F_FRIDGE, x, y, z0, x + 0.14 * scale, y + 0.14 * scale,
                z0 + 0.35 * scale, rot=rot)
    _gen_table_and_chairs(out, pl, rg, ri, room, z0, scale, 0.2, 2)


def _gen_table_and_chairs(out, pl, rg, ri, room, z0, scale, tsize, nchairs):
    """Dining set: chairs placed AROUND the table, facing it
    (add_table_and_chairs, building_room_obj_place.cpp)."""
    tw = tsize * scale
    p = pl.try_place(tw, tw, False)
    if p is None:
        return
    x, y, _ = p
    ti = out.add(ri, F_TABLE, x, y, z0, x + tw, y + tw, z0 + 0.14 * scale)
    _surface_items(out, pl, rg, ri, F_TABLE, ti, x, y, z0 + 0.14 * scale,
                   tw, tw, scale)
    cw = 0.08 * scale
    spots = [(x + 0.5 * tw - 0.5 * cw, y - cw, 1),
             (x + 0.5 * tw - 0.5 * cw, y + tw, 3),
             (x - cw, y + 0.5 * tw - 0.5 * cw, 0),
             (x + tw, y + 0.5 * tw - 0.5 * cw, 2)]
    for k in range(min(nchairs, 4)):
        cx, cy, rot = spots[k]
        if cx < room.x1 or cy < room.y1 or cx + cw > room.x2 \
                or cy + cw > room.y2:
            continue
        if pl.overlaps(cx, cy, cx + cw, cy + cw) \
                or pl.blocks_door(cx, cy, cx + cw, cy + cw):
            continue
        pl.commit(cx, cy, cx + cw, cy + cw)
        out.add(ri, F_CHAIR, cx, cy, z0, cx + cw, cy + cw,
                z0 + 0.15 * scale, rot=rot)


def _gen_office(out, pl, rg, ri, room, z0, fh, scale):
    """add_office_objs: desks with chair FACING the desk and
    monitor/keyboard on top; large offices get cubicle partitions."""
    n_desks = 2 if room.area < 0.08 else 4
    for _ in range(n_desks):
        p = pl.try_place(0.25 * scale, 0.15 * scale, True)
        if p is None:
            continue
        x, y, rot = p
        di = out.add(ri, F_DESK, x, y, z0, x + 0.25 * scale,
                     y + 0.15 * scale, z0 + 0.15 * scale, rot=rot)
        _surface_items(out, pl, rg, ri, F_DESK, di, x, y, z0 + 0.15 * scale,
                       0.25 * scale, 0.15 * scale, scale)
        # chair in front of the desk, facing it
        cw = 0.1 * scale
        off = {0: (0.25 * scale, 0.02), 2: (-cw, 0.02),
               1: (0.02, 0.15 * scale), 3: (0.02, -cw)}[rot]
        cx, cy = x + off[0], y + off[1]
        if room.x1 <= cx and cx + cw <= room.x2 and room.y1 <= cy \
                and cy + cw <= room.y2 \
                and not pl.overlaps(cx, cy, cx + cw, cy + cw):
            pl.commit(cx, cy, cx + cw, cy + cw)
            out.add(ri, F_CHAIR, cx, cy, z0, cx + cw, cy + cw,
                    z0 + 0.15 * scale, rot=(rot + 2) % 4)
        if n_desks >= 4:
            out.add(ri, F_CUBICLE, x - 0.02, y - 0.02, z0,
                    x + 0.27 * scale, y + 0.17 * scale, z0 + 0.45 * fh,
                    parent=di)
    p = pl.try_place(0.2 * scale, 0.08 * scale, True)
    if p:
        x, y, rot = p
        bi = out.add(ri, F_BOOKCASE, x, y, z0, x + 0.2 * scale,
                     y + 0.08 * scale, z0 + 0.3 * scale, rot=rot)
        _surface_items(out, pl, rg, ri, F_BOOKCASE, bi, x, y,
                       z0 + 0.3 * scale, 0.2 * scale, 0.08 * scale, scale)


def _gen_living(out, pl, rg, ri, room, z0, fh, scale):
    """add_livingroom_objs: couch FACING the TV across the room, coffee
    table between them on a rug, plants in corners."""
    p = pl.try_place(0.4 * scale, 0.16 * scale, True)
    if p:
        x, y, rot = p
        out.add(ri, F_COUCH, x, y, z0, x + 0.4 * scale, y + 0.16 * scale,
                z0 + 0.14 * scale, rot=rot)
        # TV on the opposite wall, facing back
        tv_rot = (rot + 2) % 4
        p2 = pl.try_place(0.3 * scale, 0.06 * scale, True)
        if p2:
            tx, ty, _ = p2
            out.add(ri, F_TV, tx, ty, z0 + 0.1 * scale, tx + 0.3 * scale,
                    ty + 0.06 * scale, z0 + 0.3 * scale, rot=tv_rot)
    cx, cy = 0.5 * (room.x1 + room.x2), 0.5 * (room.y1 + room.y2)
    rw, rd = 0.22 * scale, 0.16 * scale
    out.add(ri, F_RUG, cx - rw, cy - rd, z0, cx + rw, cy + rd, z0 + 0.004)
    tw = 0.12 * scale
    if not pl.overlaps(cx - tw, cy - tw, cx + tw, cy + tw) \
            and not pl.blocks_door(cx - tw, cy - tw, cx + tw, cy + tw):
        pl.commit(cx - tw, cy - tw, cx + tw, cy + tw)
        ti = out.add(ri, F_TABLE, cx - tw, cy - tw, z0, cx + tw, cy + tw,
                     z0 + 0.08 * scale)
        _surface_items(out, pl, rg, ri, F_TABLE, ti, cx - tw, cy - tw,
                       z0 + 0.08 * scale, 2 * tw, 2 * tw, scale)
    p = pl.try_place(0.08 * scale, 0.08 * scale, True)
    if p:
        x, y, _ = p
        out.add(ri, F_PLANT, x, y, z0, x + 0.08 * scale, y + 0.08 * scale,
                z0 + 0.2 * scale)
    _wall_picture(out, rg, ri, room, z0, fh)


def _wall_picture(out, rg, ri, room, z0, fh):
    """Pictures hung on a random wall (add_picture)."""
    if rg.rand() % 3 == 0:
        return
    w = 0.12
    if rg.rand_bool():
        x = room.x1 + rg.randd() * max(room.x2 - room.x1 - w, 0.01)
        y = room.y1 + 0.005
        out.add(ri, F_PICTURE, x, y, z0 + 0.45 * fh, x + w, y + 0.005,
                z0 + 0.75 * fh)
    else:
        x = room.x1 + 0.005
        y = room.y1 + rg.randd() * max(room.y2 - room.y1 - w, 0.01)
        out.add(ri, F_PICTURE, x, y, z0 + 0.45 * fh, x + 0.005, y + w,
                z0 + 0.75 * fh)


def _gen_dining(out, pl, rg, ri, room, z0, fh, scale):
    _gen_table_and_chairs(out, pl, rg, ri, room, z0, scale, 0.3, 4)
    _wall_picture(out, rg, ri, room, z0, fh)


def _gen_attic(out, pl, rg, ri, room, z0, fh, scale):
    """Attic contents (add_attic_objects): scattered storage boxes
    (sometimes stacked), an old chair or wardrobe, a chest, dust-lamp —
    clutter pushed toward the center where the roof has headroom."""
    cx = 0.5 * (room.x1 + room.x2)
    cy = 0.5 * (room.y1 + room.y2)
    nb = 2 + rg.rand() % 5
    for _ in range(nb):
        bx = cx + (rg.randd() - 0.5) * 0.5 * (room.x2 - room.x1)
        by = cy + (rg.randd() - 0.5) * 0.5 * (room.y2 - room.y1)
        bw = (0.05 + 0.04 * rg.randd()) * scale
        bi = out.add(ri, F_BOX, bx, by, z0, bx + bw, by + bw,
                     z0 + 0.6 * bw)
        if rg.rand() % 3 == 0:      # stacked box
            out.add(ri, F_BOX, bx + 0.1 * bw, by + 0.1 * bw, z0 + 0.6 * bw,
                    bx + 0.9 * bw, by + 0.9 * bw, z0 + 1.1 * bw, parent=bi)
    for kind, w, h, p_ in ((F_OLD_CHAIR, 0.1, 0.14, 2),
                           (F_CHEST, 0.16, 0.1, 2),
                           (F_WARDROBE, 0.18, 0.3, 3)):
        if rg.rand() % p_ == 0:
            x = cx + (rg.randd() - 0.5) * 0.4 * (room.x2 - room.x1)
            y = cy + (rg.randd() - 0.5) * 0.4 * (room.y2 - room.y1)
            out.add(ri, kind, x, y, z0, x + w * scale, y + 0.8 * w * scale,
                    z0 + h * scale)
    out.add(ri, F_LAMP, cx, cy, z0 + 0.85 * fh, cx + 0.04 * scale,
            cy + 0.04 * scale, z0 + 0.95 * fh)


def _ceiling_pipes(out, rg, ri, room, z0, fh, scale):
    """Exposed ceiling pipe + duct runs (the reference's factory /
    datacenter / basement pipe networks, building_room_geom machine +
    pipe detail): 2-4 parallel pipes along the long axis plus one duct."""
    rw = room.x2 - room.x1
    rh = room.y2 - room.y1
    long_x = rw >= rh
    n = 2 + rg.rand() % 3
    pr = 0.012 * scale
    for k in range(n):
        off = (0.2 + 0.6 * k / max(n - 1, 1))
        zc = z0 + (0.88 + 0.04 * (k % 2)) * fh
        if long_x:
            y = room.y1 + off * rh
            out.add(ri, F_PIPE, room.x1, y - pr, zc - pr,
                    room.x2, y + pr, zc + pr)
        else:
            x = room.x1 + off * rw
            out.add(ri, F_PIPE, x - pr, room.y1, zc - pr,
                    x + pr, room.y2, zc + pr)
    dr = 0.03 * scale
    zc = z0 + 0.8 * fh
    if long_x:
        y = room.y1 + 0.5 * rh
        out.add(ri, F_DUCT, room.x1, y - dr, zc - dr, room.x2, y + dr,
                zc + dr)
    else:
        x = room.x1 + 0.5 * rw
        out.add(ri, F_DUCT, x - dr, room.y1, zc - dr, x + dr, room.y2,
                zc + dr)


def _gen_parking(out, pl, rg, ri, room, z0, fh, scale):
    """Parking garage structure (building_room_obj_place parking-garage
    path): support PILLAR grid on ~3fh spacing, parking-space rows
    along the long axis, an entry ramp at one end."""
    rw = room.x2 - room.x1
    rh = room.y2 - room.y1
    sp = 3.0 * fh
    nx_ = max(int(rw / sp), 2)      # >= one interior pillar row each way
    ny_ = max(int(rh / sp), 2)
    pw = 0.06 * scale
    for ix in range(1, nx_):
        for iy in range(1, ny_):
            px_ = room.x1 + ix * rw / nx_
            py_ = room.y1 + iy * rh / ny_
            out.add(ri, F_PILLAR, px_ - pw / 2, py_ - pw / 2, z0,
                    px_ + pw / 2, py_ + pw / 2, z0 + fh)
    # parking spaces along the long axis walls
    long_x = rw >= rh
    ns = max(int((rw if long_x else rh) / (0.14 * scale)), 1)
    for k in range(ns):
        if long_x:
            sx = room.x1 + k * rw / ns
            out.add(ri, F_PARK_SPACE, sx, room.y1, z0, sx + 0.12 * scale,
                    room.y1 + 0.2 * scale, z0 + 0.002)
        else:
            sy = room.y1 + k * rh / ns
            out.add(ri, F_PARK_SPACE, room.x1, sy, z0, room.x1 + 0.2 * scale,
                    sy + 0.12 * scale, z0 + 0.002)
    # ramp at the +x end
    out.add(ri, F_RAMP, room.x2 - 0.3 * scale, room.y1, z0,
            room.x2, room.y1 + 0.15 * scale, z0 + 0.5 * fh)


def _axis_helpers(room, dim):
    """(u along dim, v along !dim) -> world (x1, y1, x2, y2)."""
    lo = (room.x1, room.y1)
    hi = (room.x2, room.y2)

    def mk(u1, v1, u2, v2):
        if dim == 0:
            return (min(u1, u2), min(v1, v2), max(u1, u2), max(v1, v2))
        return (min(v1, v2), min(u1, u2), max(v1, v2), max(u1, u2))
    return lo, hi, mk


def _door_on_wall(pl, room, dim, dr):
    wall = ((room.x1, room.x2) if dim == 0 else (room.y1, room.y2))[dr]
    for (dx, dy) in pl.doors:
        if abs((dx if dim == 0 else dy) - wall) < pl.clear:
            return True
    return False


def _gen_classroom(out, pl, rg, ri, room, z0, fh, scale):
    """add_classroom_objs (building_school.cpp:11-130): teacher desk
    fronting a door-free wall with a chalkboard behind it, then a grid
    of student desks, each with a chair facing the front and papers on
    some desks."""
    w, h = room.x2 - room.x1, room.y2 - room.y1
    dim = 0 if w >= h else 1            # long dim; front is a short wall
    valid = [not _door_on_wall(pl, room, dim, d) for d in (0, 1)]
    if not (valid[0] or valid[1]):
        return
    fdir = 0 if valid[0] and (not valid[1] or rg.rand_bool()) else 1
    lo, hi, mk = _axis_helpers(room, dim)
    fw = (lo, hi)[fdir][dim]            # front wall u coordinate
    ds = 1.0 if fdir == 0 else -1.0     # into the room along u
    vc = 0.5 * (lo[1 - dim] + hi[1 - dim])
    # facing rotations along u: toward the front wall
    face_front = (2 if fdir == 0 else 0) if dim == 0 else (3 if fdir == 0 else 1)
    face_back = (face_front + 2) % 4
    # sizes follow add_classroom_objs (building_school.cpp:42-46), in
    # floor-spacing units: teacher desk 0.8x0.38x0.23 fh, student desks
    # 0.48x0.34x0.25 fh with ~0.3 fh clearance
    cb_w = min(1.5 * fh, 0.8 * (hi[1 - dim] - lo[1 - dim]))
    x1, y1, x2, y2 = mk(fw, vc - 0.5 * cb_w, fw + ds * 0.02 * fh,
                        vc + 0.5 * cb_w)
    out.add(ri, F_CHALKBOARD, x1, y1, z0 + 0.35 * fh, x2, y2,
            z0 + 0.8 * fh, rot=face_back)
    # wall clock on the back wall facing the class (add_clock_to_cube
    # via building_room_obj_place.cpp:3456; digital half the time;
    # digital/analog is carried by the cube aspect — wide+flat=digital)
    from . import clocks as CK
    bw_u = (hi, lo)[fdir][dim]
    ck = CK.wall_clock_cube(bw_u, vc, z0, fh, dim, fdir,
                            digital=rg.rand_bool())
    out.add(ri, F_CLOCK, ck[0], ck[1], ck[2], ck[3], ck[4], ck[5],
            rot=face_front)
    # teacher desk + chair, centered, near the front
    td_u1 = fw + ds * 0.3 * fh
    td_w = 0.8 * fh
    x1, y1, x2, y2 = mk(td_u1, vc - 0.5 * td_w, td_u1 + ds * 0.38 * fh,
                        vc + 0.5 * td_w)
    if not pl.blocks_door(x1, y1, x2, y2):
        pl.commit(x1, y1, x2, y2)
        ti = out.add(ri, F_DESK, x1, y1, z0, x2, y2, z0 + 0.23 * fh,
                     rot=face_back)
        _surface_items(out, pl, rg, ri, F_DESK, ti, x1, y1,
                       z0 + 0.23 * fh, x2 - x1, y2 - y1, scale)
        cu = td_u1 - ds * 0.28 * fh     # teacher chair between wall/desk
        x1, y1, x2, y2 = mk(cu, vc - 0.14 * fh, cu + ds * 0.26 * fh,
                            vc + 0.14 * fh)
        if not pl.overlaps(x1, y1, x2, y2):
            pl.commit(x1, y1, x2, y2)
            out.add(ri, F_CHAIR, x1, y1, z0, x2, y2, z0 + 0.4 * fh,
                    rot=face_back)
    # student desk grid facing the front
    desk_w, desk_d = 0.48 * fh, 0.34 * fh
    u_start = fw + ds * 1.1 * fh
    u_end = (hi, lo)[fdir][dim] - ds * 0.25 * fh
    v1 = lo[1 - dim] + 0.25 * fh
    v2 = hi[1 - dim] - 0.25 * fh
    du, dv = desk_d + 0.45 * fh, desk_w + 0.3 * fh
    nrows = max(0, min(8, int(abs(u_end - u_start) / du)))
    ncols = max(0, min(8, int((v2 - v1) / dv)))
    for r_i in range(nrows):
        for c_i in range(ncols):
            u = u_start + ds * du * r_i
            v = v1 + dv * c_i + 0.02 * fh
            x1, y1, x2, y2 = mk(u, v, u + ds * desk_d, v + desk_w)
            if pl.blocks_door(x1, y1, x2, y2) or pl.overlaps(x1, y1, x2, y2):
                continue
            pl.commit(x1, y1, x2, y2)
            di = out.add(ri, F_DESK, x1, y1, z0, x2, y2, z0 + 0.25 * fh,
                         rot=face_front)
            if rg.randd() < 0.7:
                out.add(ri, F_PAPER, x1 + 0.005, y1 + 0.005,
                        z0 + 0.25 * fh, x1 + 0.005 + 0.2 * fh,
                        y1 + 0.005 + 0.26 * fh, z0 + 0.255 * fh,
                        parent=di)
            cu = u + ds * (desk_d + 0.02 * fh)
            x1, y1, x2, y2 = mk(cu, v + 0.08 * fh,
                                cu + ds * 0.26 * fh, v + 0.36 * fh)
            if not (pl.overlaps(x1, y1, x2, y2)
                    or pl.blocks_door(x1, y1, x2, y2)):
                pl.commit(x1, y1, x2, y2)
                out.add(ri, F_CHAIR, x1, y1, z0, x2, y2,
                        z0 + 0.4 * fh, rot=face_front)


def _gen_hospital_room(out, pl, rg, ri, room, z0, fh, scale):
    """add_hospital_room_objs (building_hospital.cpp:124-200): a row of
    hospital beds with heads against one wall, all sharing an
    orientation, privacy curtains hung between adjacent beds, a
    nightstand per bed, and a TV on the opposite wall."""
    w, h = room.x2 - room.x1, room.y2 - room.y1
    dim = 0 if w >= h else 1            # beds spread along the long dim
    hdir = 0 if not _door_on_wall(pl, room, 1 - dim, 0) else 1
    lo, hi, mk = _axis_helpers(room, dim)
    head_v = (lo, hi)[hdir][1 - dim]    # heads against this v wall
    vs = 1.0 if hdir == 0 else -1.0
    bed_w, bed_len = 0.55 * fh, 1.1 * fh
    max_beds = max(1, min(16, int(0.25 * (w * h) / (fh * fh))))
    u1 = lo[dim] + 0.25 * fh
    u2 = hi[dim] - 0.25 * fh
    pitch = bed_w + 0.5 * fh
    nbeds = max(0, min(max_beds, int((u2 - u1 + 0.5 * fh) / pitch)))
    rot = (1 if hdir == 0 else 3) if dim == 0 else (0 if hdir == 0 else 2)
    placed_u = []
    for i in range(nbeds):
        u = u1 + pitch * i
        x1, y1, x2, y2 = mk(u, head_v, u + bed_w, head_v + vs * bed_len)
        if pl.blocks_door(x1, y1, x2, y2) or pl.overlaps(x1, y1, x2, y2):
            continue
        pl.commit(x1, y1, x2, y2)
        out.add(ri, F_HOSPITAL_BED, x1, y1, z0, x2, y2, z0 + 0.45 * fh,
                rot=rot)
        nu = u + bed_w + 0.02 * fh
        x1, y1, x2, y2 = mk(nu, head_v, nu + 0.25 * fh,
                            head_v + vs * 0.25 * fh)
        if not (pl.overlaps(x1, y1, x2, y2) or pl.blocks_door(x1, y1, x2, y2)):
            pl.commit(x1, y1, x2, y2)
            ni = out.add(ri, F_NIGHTSTAND, x1, y1, z0, x2, y2,
                         z0 + 0.4 * fh)
            _surface_items(out, pl, rg, ri, F_NIGHTSTAND, ni, x1, y1,
                           z0 + 0.4 * fh, x2 - x1, y2 - y1, scale)
        placed_u.append(u)
    # curtains hung between adjacent beds (ceiling-mounted, near-floor)
    for ua, ub in zip(placed_u, placed_u[1:]):
        cu = 0.5 * (ua + bed_w + ub)
        x1, y1, x2, y2 = mk(cu - 0.02 * fh, head_v, cu + 0.02 * fh,
                            head_v + vs * (bed_len + 0.15 * fh))
        out.add(ri, F_CURTAIN, x1, y1, z0 + 0.15 * fh, x2, y2,
                z0 + 0.92 * fh)
    if placed_u:                        # TV on the opposite wall
        tv_v = (hi, lo)[hdir][1 - dim]
        uc = 0.5 * (u1 + u2)
        x1, y1, x2, y2 = mk(uc - 0.3 * fh, tv_v - vs * 0.06 * fh,
                            uc + 0.3 * fh, tv_v)
        out.add(ri, F_TV, x1, y1, z0 + 0.5 * fh, x2, y2,
                z0 + 0.85 * fh, rot=(rot + 2) % 4)


def _gen_operating_room(out, pl, rg, ri, room, z0, fh, scale):
    """add_operating_room_objs (building_hospital.cpp:508+): central
    operating table under a surgical light, counters along the walls,
    and a scrub sink."""
    cx = 0.5 * (room.x1 + room.x2)
    cy = 0.5 * (room.y1 + room.y2)
    tw, td = 0.22 * scale, 0.12 * scale
    x1, y1 = cx - 0.5 * tw, cy - 0.5 * td
    pl.commit(x1, y1, x1 + tw, y1 + td)
    out.add(ri, F_OPERATING_TABLE, x1, y1, z0, x1 + tw, y1 + td,
            z0 + 0.13 * scale)
    out.add(ri, F_CEIL_LIGHT, cx - 0.04 * scale, cy - 0.04 * scale,
            z0 + 0.8 * fh, cx + 0.04 * scale, cy + 0.04 * scale,
            z0 + 0.85 * fh)
    for _ in range(2):
        p = pl.try_place(0.25 * scale, 0.08 * scale, True)
        if p:
            x, y, rot = p
            out.add(ri, F_COUNTER, x, y, z0, x + 0.25 * scale,
                    y + 0.08 * scale, z0 + 0.14 * scale, rot=rot)
    p = pl.try_place(0.07 * scale, 0.06 * scale, True)
    if p:
        x, y, rot = p
        out.add(ri, F_SINK, x, y, z0, x + 0.07 * scale, y + 0.06 * scale,
                z0 + 0.13 * scale, rot=rot)


def _gen_jail_cells(out, pl, rg, ri, room, z0, fh, scale):
    """add_prison_jail_cell_objs / populate_jail_cell
    (building_jail.cpp:380-460, 1100-1260): a row of cells along one
    long wall, fronted by bars with a door gap per cell; each cell gets
    a bed along its partition wall and a toilet + sink on the back
    wall; the strip in front of the bars is the cell-block hall."""
    w, h = room.x2 - room.x1, room.y2 - room.y1
    dim = 0 if w >= h else 1            # cells along the long dim
    bdir = 0 if not _door_on_wall(pl, room, 1 - dim, 0) else 1
    lo, hi, mk = _axis_helpers(room, dim)
    back_v = (lo, hi)[bdir][1 - dim]
    vs = 1.0 if bdir == 0 else -1.0
    depth = min(1.6 * fh, 0.55 * (h if dim == 0 else w))
    front_v = back_v + vs * depth
    cell_w = 1.2 * fh
    u1 = lo[dim]
    ncells = max(0, int((hi[dim] - lo[dim]) / cell_w))
    bed_rot = (1 if bdir == 0 else 3) if dim == 0 else (0 if bdir == 0 else 2)
    for i in range(ncells):
        cu1 = u1 + i * cell_w
        cu2 = cu1 + cell_w
        x1, y1, x2, y2 = mk(cu1, back_v, cu2, front_v)
        if pl.blocks_door(x1, y1, x2, y2) or pl.overlaps(x1, y1, x2, y2):
            continue
        pl.commit(x1, y1, x2, y2)
        # partition wall on the cell's high-u side (full height)
        if i + 1 < ncells:
            x1, y1, x2, y2 = mk(cu2 - 0.02 * fh, back_v, cu2 + 0.02 * fh,
                                front_v)
            out.add(ri, F_CELL_WALL, x1, y1, z0, x2, y2, z0 + fh)
        # front bars with a door gap on the hinge side (alternating,
        # like the reference's per-room hinge_side = room_id & 1)
        gap_w = 0.45 * fh
        gap_lo = cu1 + (0.1 * fh if (i & 1) else cell_w - gap_w - 0.1 * fh)
        for (ba, bb) in ((cu1, gap_lo), (gap_lo + gap_w, cu2)):
            if bb - ba < 0.02 * fh:
                continue
            x1, y1, x2, y2 = mk(ba, front_v - vs * 0.02 * fh, bb,
                                front_v + vs * 0.02 * fh)
            out.add(ri, F_JAIL_BARS, x1, y1, z0, x2, y2, z0 + fh)
        # bed along the partition, head at the back wall (clamped
        # inside the cell so it can't poke through the front bars)
        bed_len = min(1.0 * fh, depth - 0.1 * fh)
        x1, y1, x2, y2 = mk(cu1 + 0.08 * fh, back_v,
                            cu1 + 0.53 * fh, back_v + vs * bed_len)
        out.add(ri, F_BED, x1, y1, z0, x2, y2, z0 + 0.3 * fh,
                rot=bed_rot)
        # toilet + sink on the back wall, opposite corner from the bed
        x1, y1, x2, y2 = mk(cu2 - 0.4 * fh, back_v,
                            cu2 - 0.1 * fh, back_v + vs * 0.3 * fh)
        out.add(ri, F_TOILET, x1, y1, z0, x2, y2, z0 + 0.3 * fh,
                rot=bed_rot)
        x1, y1, x2, y2 = mk(cu2 - 0.75 * fh, back_v,
                            cu2 - 0.5 * fh, back_v + vs * 0.22 * fh)
        out.add(ri, F_SINK, x1, y1, z0, x2, y2, z0 + 0.4 * fh,
                rot=bed_rot)


def _gen_cafeteria(out, pl, rg, ri, room, z0, fh, scale):
    """School/prison cafeteria: rows of long tables with chairs on both
    sides, a serving counter on a short wall, and a vending machine."""
    w, h = room.x2 - room.x1, room.y2 - room.y1
    dim = 0 if w >= h else 1
    lo, hi, mk = _axis_helpers(room, dim)
    t_len = min(2.2 * fh, 0.6 * (hi[dim] - lo[dim]))
    t_w = 0.55 * fh
    pitch = t_w + 0.9 * fh
    v1 = lo[1 - dim] + 0.55 * fh
    nrows = max(0, int(((hi[1 - dim] - 0.55 * fh) - v1 + 0.9 * fh) / pitch))
    uc = 0.5 * (lo[dim] + hi[dim])
    for r_i in range(nrows):
        v = v1 + pitch * r_i
        x1, y1, x2, y2 = mk(uc - 0.5 * t_len, v, uc + 0.5 * t_len, v + t_w)
        if pl.blocks_door(x1, y1, x2, y2) or pl.overlaps(x1, y1, x2, y2):
            continue
        pl.commit(x1, y1, x2, y2)
        ti = out.add(ri, F_TABLE, x1, y1, z0, x2, y2, z0 + 0.3 * fh)
        _surface_items(out, pl, rg, ri, F_TABLE, ti, x1, y1,
                       z0 + 0.3 * fh, x2 - x1, y2 - y1, scale)
        for side in (0, 1):
            cv = v - 0.32 * fh if side == 0 else v + t_w + 0.02 * fh
            rot = ((1 if side == 0 else 3) if dim == 0 else
                   (0 if side == 0 else 2))
            nch = max(1, int(t_len / (0.55 * fh)))
            for ci in range(nch):
                cu = uc - 0.5 * t_len + (0.1 + 0.55 * ci) * fh
                x1, y1, x2, y2 = mk(cu, cv, cu + 0.3 * fh,
                                    cv + 0.3 * fh)
                if not (pl.overlaps(x1, y1, x2, y2)
                        or pl.blocks_door(x1, y1, x2, y2)):
                    pl.commit(x1, y1, x2, y2)
                    out.add(ri, F_CHAIR, x1, y1, z0, x2, y2,
                            z0 + 0.4 * fh, rot=rot)
    p = pl.try_place(1.4 * fh, 0.4 * fh, True)
    if p:
        x, y, rot = p
        ci = out.add(ri, F_COUNTER, x, y, z0, x + 1.4 * fh,
                     y + 0.4 * fh, z0 + 0.35 * fh, rot=rot)
        _surface_items(out, pl, rg, ri, F_COUNTER, ci, x, y,
                       z0 + 0.35 * fh, 1.4 * fh, 0.4 * fh, scale)
    p = pl.try_place(0.5 * fh, 0.35 * fh, True)
    if p:
        x, y, rot = p
        out.add(ri, F_VENDING, x, y, z0, x + 0.5 * fh, y + 0.35 * fh,
                z0 + 0.8 * fh, rot=rot)


def _gen_waiting(out, pl, rg, ri, room, z0, fh, scale):
    """Hospital waiting room: chairs in rows along the walls, a low
    table with magazines, and a plant."""
    for _ in range(10):
        p = pl.try_place(0.08 * scale, 0.08 * scale, True)
        if p:
            x, y, rot = p
            out.add(ri, F_CHAIR, x, y, z0, x + 0.08 * scale,
                    y + 0.08 * scale, z0 + 0.12 * scale, rot=rot)
    p = pl.try_place(0.15 * scale, 0.12 * scale, False)
    if p:
        x, y, _ = p
        ti = out.add(ri, F_TABLE, x, y, z0, x + 0.15 * scale,
                     y + 0.12 * scale, z0 + 0.1 * scale)
        out.add(ri, F_PAPER, x + 0.02, y + 0.02, z0 + 0.1 * scale,
                x + 0.06, y + 0.07, z0 + 0.102 * scale, parent=ti)
    p = pl.try_place(0.06 * scale, 0.06 * scale, False)
    if p:
        x, y, _ = p
        out.add(ri, F_PLANT, x, y, z0, x + 0.06 * scale, y + 0.06 * scale,
                z0 + 0.25 * scale)


def _gen_factory(out, pl, rg, ri, room, z0, fh, scale):
    """add_industrial_machines (building_machines.cpp:805-900): a 2D
    grid of machines with walkable aisles in the room center, chem
    tanks along one side when the grid is deep enough, and a conveyor
    belt emptying into a crate for factories; machines also line the
    walls (add_machines_to_room)."""
    w, h = room.x2 - room.x1, room.y2 - room.y1
    dim = 0 if w >= h else 1
    lo, hi, mk = _axis_helpers(room, dim)
    m_u = min(1.0 * fh, 0.3 * (hi[dim] - lo[dim]))
    m_v = min(1.0 * fh, 0.3 * (hi[1 - dim] - lo[1 - dim]))
    aisle = 0.8 * fh
    u1 = lo[dim] + 0.5 * fh
    u2 = hi[dim] - 0.5 * fh
    v1 = lo[1 - dim] + 0.5 * fh
    v2 = hi[1 - dim] - 0.5 * fh
    ncols = max(0, int((u2 - u1 + aisle) / (m_u + aisle)))
    nrows = max(0, int((v2 - v1 + aisle) / (m_v + aisle)))
    mh = (0.6 + 0.2 * rg.randd()) * fh
    for r_i in range(nrows):
        for c_i in range(ncols):
            u = u1 + c_i * (m_u + aisle)
            v = v1 + r_i * (m_v + aisle)
            # the last grid row becomes chem tanks when deep enough
            # (add_tanks at num rows >= 3); cylinders stand taller
            is_tank = (nrows >= 3 and r_i == nrows - 1)
            x1, y1, x2, y2 = mk(u, v, u + m_u, v + m_v)
            if pl.blocks_door(x1, y1, x2, y2) or pl.overlaps(x1, y1, x2, y2):
                continue
            pl.commit(x1, y1, x2, y2)
            if is_tank:
                out.add(ri, F_TANK, x1, y1, z0, x2, y2,
                        z0 + min(0.9 * fh, 2.25 * 0.5 * m_u))
            else:
                mi = out.add(ri, F_MACHINE, x1, y1, z0, x2, y2, z0 + mh)
                _machine_internals(out, rg, ri, mi, x1, y1, x2, y2, z0,
                                   mh, fh)
                if rg.randd() < 0.5:    # connecting pipe up to the ceiling
                    cxp = 0.5 * (x1 + x2)
                    cyp = 0.5 * (y1 + y2)
                    out.add(ri, F_PIPE, cxp - 0.02 * fh, cyp - 0.02 * fh,
                            z0 + mh, cxp + 0.02 * fh, cyp + 0.02 * fh,
                            z0 + fh, parent=mi)
    # conveyor belt along one side with a crate at its end (factories,
    # num cols >= 5 in the reference; scaled to the aisle count here)
    if ncols >= 3:
        cb_v = v1 - 0.45 * fh
        x1, y1, x2, y2 = mk(u1, cb_v, u2, cb_v + 0.3 * fh)
        if not (pl.blocks_door(x1, y1, x2, y2)
                or pl.overlaps(x1, y1, x2, y2)):
            pl.commit(x1, y1, x2, y2)
            out.add(ri, F_CONV_BELT, x1, y1, z0, x2, y2, z0 + 0.35 * fh)
            ex1, ey1, ex2, ey2 = mk(u2 + 0.02 * fh, cb_v,
                                    u2 + 0.45 * fh, cb_v + 0.3 * fh)
            if not pl.overlaps(ex1, ey1, ex2, ey2):
                pl.commit(ex1, ey1, ex2, ey2)
                out.add(ri, F_BOX, ex1, ey1, z0, ex2, ey2, z0 + 0.3 * fh)
    # machines along the walls
    for _ in range(3):
        p = pl.try_place(0.7 * fh, 0.5 * fh, True)
        if p:
            x, y, rot = p
            mi = out.add(ri, F_MACHINE, x, y, z0, x + 0.7 * fh,
                         y + 0.5 * fh, z0 + 0.7 * fh, rot=rot)
            _machine_internals(out, rg, ri, mi, x, y, x + 0.7 * fh,
                               y + 0.5 * fh, z0, 0.7 * fh, fh)
    # breaker panel + wall ladder (building_machines.cpp / industrial
    # wall details) and a catwalk spanning the machine rows
    p = pl.try_place(0.25 * fh, 0.04 * fh, True)
    if p:
        x, y, rot = p
        out.add(ri, F_BREAKER_PANEL, x, y, z0 + 0.35 * fh,
                x + 0.25 * fh, y + 0.04 * fh, z0 + 0.7 * fh, rot=rot)
    p = pl.try_place(0.12 * fh, 0.05 * fh, True)
    if p:
        x, y, rot = p
        out.add(ri, F_LADDER, x, y, z0, x + 0.12 * fh, y + 0.05 * fh,
                z0 + 0.9 * fh, rot=rot)
    if nrows >= 2 and ncols >= 2:
        # catwalk across the middle of the grid with railings
        cw_v = 0.5 * (v1 + v2)
        x1, y1, x2, y2 = mk(lo[dim] + 0.1 * fh, cw_v - 0.12 * fh,
                            hi[dim] - 0.1 * fh, cw_v + 0.12 * fh)
        ci = out.add(ri, F_CATWALK, x1, y1, z0 + 0.62 * fh, x2, y2,
                     z0 + 0.66 * fh)
        out.add(ri, F_RAILING, x1, y1, z0 + 0.66 * fh, x2,
                y1 + 0.02 * fh, z0 + 0.82 * fh, parent=ci)
        out.add(ri, F_RAILING, x1, y2 - 0.02 * fh, z0 + 0.66 * fh, x2,
                y2, z0 + 0.82 * fh, parent=ci)


def _gen_hotel_room(out, pl, rg, ri, room, z0, fh, scale):
    """Hotel room (building_floorplan.cpp:1483+ three-room hotel unit,
    condensed): bed with nightstand, desk + chair, wall TV opposite the
    bed, and a bathroom corner (toilet + sink) away from the door."""
    p = pl.try_place(0.55 * fh, 1.0 * fh, True)
    if p:
        x, y, rot = p
        out.add(ri, F_BED, x, y, z0, x + 0.55 * fh, y + 1.0 * fh,
                z0 + 0.3 * fh, rot=rot)
        nx, ny = x + 0.57 * fh, y
        if nx + 0.25 * fh <= room.x2 and not pl.overlaps(
                nx, ny, nx + 0.25 * fh, ny + 0.25 * fh):
            pl.commit(nx, ny, nx + 0.25 * fh, ny + 0.25 * fh)
            ni = out.add(ri, F_NIGHTSTAND, nx, ny, z0, nx + 0.25 * fh,
                         ny + 0.25 * fh, z0 + 0.4 * fh)
            _surface_items(out, pl, rg, ri, F_NIGHTSTAND, ni, nx, ny,
                           z0 + 0.4 * fh, 0.25 * fh, 0.25 * fh, scale)
        # TV on the opposite wall from the bed
        tv_rot = (rot + 2) % 4
        r = room
        if rot == 0:
            tx1, ty1 = r.x2 - 0.06 * fh, 0.5 * (r.y1 + r.y2) - 0.3 * fh
            tx2, ty2 = r.x2, ty1 + 0.6 * fh
        elif rot == 2:
            tx1, ty1 = r.x1, 0.5 * (r.y1 + r.y2) - 0.3 * fh
            tx2, ty2 = r.x1 + 0.06 * fh, ty1 + 0.6 * fh
        elif rot == 1:
            tx1, ty1 = 0.5 * (r.x1 + r.x2) - 0.3 * fh, r.y2 - 0.06 * fh
            tx2, ty2 = tx1 + 0.6 * fh, r.y2
        else:
            tx1, ty1 = 0.5 * (r.x1 + r.x2) - 0.3 * fh, r.y1
            tx2, ty2 = tx1 + 0.6 * fh, r.y1 + 0.06 * fh
        out.add(ri, F_TV, tx1, ty1, z0 + 0.5 * fh, tx2, ty2,
                z0 + 0.85 * fh, rot=tv_rot)
    p = pl.try_place(0.5 * fh, 0.3 * fh, True)
    if p:
        x, y, rot = p
        di = out.add(ri, F_DESK, x, y, z0, x + 0.5 * fh, y + 0.3 * fh,
                     z0 + 0.25 * fh, rot=rot)
        _surface_items(out, pl, rg, ri, F_DESK, di, x, y, z0 + 0.25 * fh,
                       0.5 * fh, 0.3 * fh, scale)
    # bathroom corner: toilet + sink against a wall
    p = pl.try_place(0.3 * fh, 0.3 * fh, True)
    if p:
        x, y, rot = p
        out.add(ri, F_TOILET, x, y, z0, x + 0.3 * fh, y + 0.3 * fh,
                z0 + 0.3 * fh, rot=rot)
    p = pl.try_place(0.25 * fh, 0.22 * fh, True)
    if p:
        x, y, rot = p
        out.add(ri, F_SINK, x, y, z0, x + 0.25 * fh, y + 0.22 * fh,
                z0 + 0.4 * fh, rot=rot)


def _gen_warehouse(out, pl, rg, ri, room, z0, fh, scale):
    """Warehouse shelf racks (building_retail.cpp add_shelf_rack rows +
    building_factory.cpp RTYPE_WAREHOUSE): tall rack rows spanning the
    long dim with forklift aisles between them, boxes stacked on each
    shelf level, and loose pallet boxes near the walls."""
    w, h = room.x2 - room.x1, room.y2 - room.y1
    dim = 0 if w >= h else 1
    lo, hi, mk = _axis_helpers(room, dim)
    rack_len = (hi[dim] - lo[dim]) - 1.2 * fh
    if rack_len < 1.0 * fh:
        return
    rack_w, aisle = 0.5 * fh, 0.9 * fh
    pitch = rack_w + aisle
    v1 = lo[1 - dim] + 0.6 * fh
    v2 = hi[1 - dim] - 0.6 * fh
    nrows = max(0, int((v2 - v1 + aisle) / pitch))
    rack_h = 0.85 * fh
    u1 = lo[dim] + 0.6 * fh
    for r_i in range(nrows):
        v = v1 + pitch * r_i
        x1, y1, x2, y2 = mk(u1, v, u1 + rack_len, v + rack_w)
        if pl.blocks_door(x1, y1, x2, y2) or pl.overlaps(x1, y1, x2, y2):
            continue
        pl.commit(x1, y1, x2, y2)
        rk = out.add(ri, F_RACK, x1, y1, z0, x2, y2, z0 + rack_h)
        # boxes on each of 3 shelf levels along the rack
        nbox = max(1, int(rack_len / (0.45 * fh)))
        for lvl in range(3):
            bz = z0 + (0.06 + 0.27 * lvl) * fh
            for b in range(nbox):
                if rg.randd() < 0.35:
                    continue        # partially stocked
                bu = u1 + (0.05 + 0.45 * b) * fh
                bx1, by1, bx2, by2 = mk(bu, v + 0.05 * fh,
                                        bu + 0.35 * fh, v + rack_w - 0.05 * fh)
                out.add(ri, F_BOX, bx1, by1, bz, bx2, by2, bz + 0.2 * fh,
                        parent=rk)
    for _ in range(4):                  # loose pallet boxes by the walls
        p = pl.try_place(0.4 * fh, 0.4 * fh, True)
        if p:
            x, y, _ = p
            out.add(ri, F_BOX, x, y, z0, x + 0.4 * fh, y + 0.4 * fh,
                    z0 + 0.35 * fh)


def _gen_restaurant(out, pl, rg, ri, room, z0, fh, scale):
    """Restaurant dining room (the reference's restaurant retail-space
    path, building_room_obj_place.cpp dining/booth placement): booths
    along the walls with tables between the benches, free-standing
    dining tables with chairs and place settings, a service counter
    with cash register and menu board, and a trashcan by the door."""
    r = room
    rw, rh = r.x2 - r.x1, r.y2 - r.y1
    dim = 0 if rw >= rh else 1
    lo, hi, mk = _axis_helpers(room, dim)
    # booths along both long walls: bench | table | bench groups
    bw = 0.55 * fh                       # booth group width along wall
    bd = 0.42 * fh                       # depth into the room
    n = max(int((hi[dim] - lo[dim] - fh) / (bw + 0.15 * fh)), 0)
    for side in (0, 1):
        v = (lo, hi)[side][1 - dim]
        vs = 1.0 if side == 0 else -1.0
        for i in range(n):
            u = lo[dim] + 0.5 * fh + i * (bw + 0.15 * fh)
            x1, y1, x2, y2 = mk(u, v, u + bw, v + vs * bd)
            if pl.blocks_door(x1, y1, x2, y2) or pl.overlaps(x1, y1, x2, y2):
                continue
            pl.commit(x1, y1, x2, y2)
            bi = out.add(ri, F_BOOTH, x1, y1, z0, x2, y2, z0 + 0.35 * fh)
            # table slab between the benches, plates on it
            tx1, ty1, tx2, ty2 = mk(u + 0.18 * bw, v + vs * 0.1 * bd,
                                    u + 0.82 * bw, v + vs * 0.9 * bd)
            ti = out.add(ri, F_TABLE, tx1, ty1, z0 + 0.18 * fh,
                         tx2, ty2, z0 + 0.25 * fh, parent=bi)
            for _ in range(1 + rg.rand() % 2):
                px_ = tx1 + rg.randd() * max(tx2 - tx1 - 0.03, 0.01)
                py_ = ty1 + rg.randd() * max(ty2 - ty1 - 0.03, 0.01)
                out.add(ri, F_PLATE, px_, py_, z0 + 0.25 * fh,
                        px_ + 0.03, py_ + 0.03, z0 + 0.255 * fh, parent=ti)
    # center tables with chairs + settings
    for _ in range(2 + rg.rand() % 3):
        _gen_table_and_chairs(out, pl, rg, ri, room, z0, scale, 0.18, 4)
    # service counter with register + menu board above it
    p = pl.try_place(0.8 * fh, 0.25 * fh, True, tries=12)
    if p:
        x, y, rot = p
        ci = out.add(ri, F_COUNTER, x, y, z0, x + 0.8 * fh, y + 0.25 * fh,
                     z0 + 0.35 * fh, rot=rot)
        out.add(ri, F_CASH_REG, x + 0.05 * fh, y + 0.05 * fh, z0 + 0.35 * fh,
                x + 0.2 * fh, y + 0.2 * fh, z0 + 0.47 * fh, parent=ci)
        out.add(ri, F_MENU_BOARD, x, y, z0 + 0.6 * fh,
                x + 0.6 * fh, y + 0.02, z0 + 0.85 * fh)
    p = pl.try_place(0.12 * fh, 0.12 * fh, True)
    if p:
        x, y, _ = p
        out.add(ri, F_TRASHCAN, x, y, z0, x + 0.12 * fh, y + 0.12 * fh,
                z0 + 0.3 * fh)


def _gen_bar(out, pl, rg, ri, room, z0, fh, scale):
    """Bar room (the reference's bar retail space): a long bar counter
    with stool row in front and wine racks + bottle shelves behind, a
    wall TV, a few booths, and sometimes a pool table."""
    r = room
    rw, rh = r.x2 - r.x1, r.y2 - r.y1
    dim = 0 if rw >= rh else 1
    lo, hi, mk = _axis_helpers(room, dim)
    bar_len = min(hi[dim] - lo[dim] - fh, 2.2 * fh)
    if bar_len > 0.6 * fh:
        u = lo[dim] + 0.5 * fh
        v = lo[1 - dim] + 0.35 * fh
        x1, y1, x2, y2 = mk(u, v, u + bar_len, v + 0.22 * fh)
        if not (pl.blocks_door(x1, y1, x2, y2)
                or pl.overlaps(x1, y1, x2, y2)):
            pl.commit(x1, y1, x2, y2)
            bi = out.add(ri, F_BAR, x1, y1, z0, x2, y2, z0 + 0.38 * fh)
            # bottles ON the bar
            for _ in range(2 + rg.rand() % 3):
                bx = x1 + rg.randd() * max(x2 - x1 - 0.03, 0.01)
                by = y1 + rg.randd() * max(y2 - y1 - 0.03, 0.01)
                out.add(ri, F_BOTTLE, bx, by, z0 + 0.38 * fh,
                        bx + 0.02, by + 0.02, z0 + 0.45 * fh, parent=bi)
            # stool row in FRONT of the bar
            ns = max(int(bar_len / (0.25 * fh)), 1)
            for i in range(ns):
                su = u + (i + 0.5) * bar_len / ns
                sx1, sy1, sx2, sy2 = mk(su - 0.05 * fh, v + 0.26 * fh,
                                        su + 0.05 * fh, v + 0.36 * fh)
                out.add(ri, F_STOOL, sx1, sy1, z0, sx2, sy2, z0 + 0.22 * fh)
            # wine racks + back shelf BEHIND the bar (against the wall)
            wx1, wy1, wx2, wy2 = mk(u, lo[1 - dim] + 0.02,
                                    u + 0.5 * bar_len,
                                    lo[1 - dim] + 0.12 * fh)
            wi = out.add(ri, F_WINE_RACK, wx1, wy1, z0, wx2, wy2,
                         z0 + 0.6 * fh)
            for _ in range(3 + rg.rand() % 4):
                bx = wx1 + rg.randd() * max(wx2 - wx1 - 0.02, 0.01)
                bz = z0 + (0.1 + 0.4 * rg.randd()) * fh
                out.add(ri, F_BOTTLE, bx, wy1, bz, bx + 0.02, wy2,
                        bz + 0.06 * fh, parent=wi)
    p = pl.try_place(0.3 * fh, 0.05 * fh, True)
    if p:
        x, y, rot = p
        out.add(ri, F_TV, x, y, z0 + 0.55 * fh, x + 0.3 * fh,
                y + 0.05 * fh, z0 + 0.8 * fh, rot=rot)
    if rg.rand_bool():
        p = pl.try_place(0.5 * fh, 0.3 * fh, False)
        if p:
            x, y, rot = p
            out.add(ri, F_POOL_TABLE, x, y, z0, x + 0.5 * fh,
                    y + 0.3 * fh, z0 + 0.22 * fh, rot=rot)
    for _ in range(1 + rg.rand() % 2):
        _gen_table_and_chairs(out, pl, rg, ri, room, z0, scale, 0.14, 2)


def _gen_datacenter(out, pl, rg, ri, room, z0, fh, scale):
    """Datacenter hall (the reference's datacenter sub-rooms,
    building_room_obj_place.cpp server-row placement): hot/cold aisle
    rack rows with individual servers racked in each row, overhead
    cable trays running across the rows with per-row drops, vent tiles
    in the cold aisles, a PDU at each row end, CRAC units against the
    walls, and an operator desk."""
    r = room
    rw, rh = r.x2 - r.x1, r.y2 - r.y1
    dim = 0 if rw >= rh else 1
    lo, hi, mk = _axis_helpers(room, dim)
    row_len = (hi[dim] - lo[dim]) - 1.2 * fh
    if row_len < 0.8 * fh:
        return
    row_w, aisle = 0.3 * fh, 0.5 * fh
    pitch = row_w + aisle
    v1 = lo[1 - dim] + 0.5 * fh
    v2 = hi[1 - dim] - 0.5 * fh
    nrows = max(int((v2 - v1 + aisle) / pitch), 0)
    u1 = lo[dim] + 0.6 * fh
    rack_h = 0.7 * fh
    rows_done = []
    for k in range(nrows):
        v = v1 + k * pitch
        x1, y1, x2, y2 = mk(u1, v, u1 + row_len, v + row_w)
        if pl.blocks_door(x1, y1, x2, y2) or pl.overlaps(x1, y1, x2, y2):
            continue
        pl.commit(x1, y1, x2, y2)
        rk = out.add(ri, F_SERVER_RACK_ROW, x1, y1, z0, x2, y2, z0 + rack_h)
        rows_done.append(v)
        # individual servers racked along the row, 3 levels
        nsrv = max(int(row_len / (0.22 * fh)), 1)
        for lvl in range(3):
            sz = z0 + (0.08 + 0.2 * lvl) * fh
            for s in range(nsrv):
                if rg.randd() < 0.2:
                    continue        # empty slots
                su = u1 + s * row_len / nsrv
                sx1, sy1, sx2, sy2 = mk(su + 0.01, v + 0.03 * fh,
                                        su + 0.18 * fh, v + row_w - 0.03 * fh)
                out.add(ri, F_SERVER, sx1, sy1, sz, sx2, sy2,
                        sz + 0.12 * fh, parent=rk)
        # PDU at the row end
        px1, py1, px2, py2 = mk(u1 + row_len + 0.02, v,
                                u1 + row_len + 0.14 * fh, v + row_w)
        if not pl.overlaps(px1, py1, px2, py2):
            pl.commit(px1, py1, px2, py2)
            out.add(ri, F_PDU, px1, py1, z0, px2, py2, z0 + 0.55 * fh)
        # cold-aisle vent tiles in front of the row
        nv = max(int(row_len / (0.4 * fh)), 1)
        for t in range(nv):
            tu = u1 + (t + 0.25) * row_len / nv
            tx1, ty1, tx2, ty2 = mk(tu, v - 0.3 * aisle,
                                    tu + 0.2 * fh, v - 0.05 * aisle)
            out.add(ri, F_VENT_TILE, tx1, ty1, z0, tx2, ty2, z0 + 0.004)
    # overhead cable trays run PERPENDICULAR to the rows, with a drop
    # to each row they cross (building datacenter cable routing)
    if rows_done:
        tr = 0.05 * fh
        for frac in (0.3, 0.7):
            u = lo[dim] + frac * (hi[dim] - lo[dim])
            x1, y1, x2, y2 = mk(u - tr, v1 - aisle, u + tr,
                                rows_done[-1] + row_w + 0.2 * fh)
            ti = out.add(ri, F_CABLE_TRAY, x1, y1, z0 + 0.88 * fh,
                         x2, y2, z0 + 0.92 * fh)
            for v in rows_done:
                dx1, dy1, dx2, dy2 = mk(u - 0.02 * fh, v + 0.3 * row_w,
                                        u + 0.02 * fh, v + 0.7 * row_w)
                out.add(ri, F_HOSE, dx1, dy1, z0 + rack_h, dx2, dy2,
                        z0 + 0.88 * fh, parent=ti)
    # CRAC units against the walls + operator desk
    for _ in range(2):
        p = pl.try_place(0.45 * fh, 0.3 * fh, True)
        if p:
            x, y, rot = p
            out.add(ri, F_CRAC, x, y, z0, x + 0.45 * fh, y + 0.3 * fh,
                    z0 + 0.8 * fh, rot=rot)
    p = pl.try_place(0.5 * fh, 0.3 * fh, True)
    if p:
        x, y, rot = p
        di = out.add(ri, F_DESK, x, y, z0, x + 0.5 * fh, y + 0.3 * fh,
                     z0 + 0.25 * fh, rot=rot)
        _surface_items(out, pl, rg, ri, F_DESK, di, x, y, z0 + 0.25 * fh,
                       0.5 * fh, 0.3 * fh, scale)


def _machine_internals(out, rg, ri, mi, x1, y1, x2, y2, z0, mh, fh):
    """Per-machine detail (building_machines.cpp:100-400 machine part
    gen: gauges, valves, vents, connecting hoses): a gauge + valve on
    the front face and sometimes a side vent."""
    w = x2 - x1
    d = y2 - y1
    gx = x1 + 0.2 * w
    out.add(ri, F_GAUGE, gx, y1 - 0.012 * fh, z0 + 0.6 * mh,
            gx + 0.08 * w, y1, z0 + 0.6 * mh + 0.08 * w, parent=mi)
    vx = x1 + 0.6 * w
    out.add(ri, F_VALVE, vx, y1 - 0.02 * fh, z0 + 0.35 * mh,
            vx + 0.1 * w, y1, z0 + 0.35 * mh + 0.1 * w, parent=mi)
    if rg.rand_bool():
        out.add(ri, F_DUCT, x2, y1 + 0.3 * d, z0 + 0.7 * mh,
                x2 + 0.05 * fh, y1 + 0.6 * d, z0 + 0.85 * mh, parent=mi)


def _hall_lockers(out, pl, rg, ri, room, z0, fh, scale):
    """School hallway lockers (building_school.cpp locker rows): banks
    of lockers along both long walls, skipping doorways."""
    w, h = room.x2 - room.x1, room.y2 - room.y1
    dim = 0 if w >= h else 1
    lo, hi, mk = _axis_helpers(room, dim)
    lk_w, lk_d = 0.3 * fh, 0.12 * fh
    for side in (0, 1):
        v = (lo, hi)[side][1 - dim]
        vs = 1.0 if side == 0 else -1.0
        n = int((hi[dim] - lo[dim] - 0.5 * fh) / lk_w)
        for i in range(n):
            u = lo[dim] + 0.25 * fh + i * lk_w
            x1, y1, x2, y2 = mk(u, v, u + lk_w, v + vs * lk_d)
            if pl.blocks_door(x1, y1, x2, y2):
                continue
            out.add(ri, F_LOCKER, x1, y1, z0, x2, y2, z0 + 0.6 * fh)


_COMPOSITE_GENS = {}


def _init_gens():
    _COMPOSITE_GENS.update({
        R_BEDROOM: _gen_bedroom, R_BATHROOM: _gen_bathroom,
        R_KITCHEN: _gen_kitchen, R_LIVING: _gen_living,
        R_OFFICE: _gen_office, R_DINING: _gen_dining,
        R_PARKING: _gen_parking,
        R_CLASSROOM: _gen_classroom, R_HOSPITAL: _gen_hospital_room,
        R_OPERATING: _gen_operating_room, R_JAIL: _gen_jail_cells,
        R_CAFETERIA: _gen_cafeteria, R_WAITING: _gen_waiting,
        R_HOTEL: _gen_hotel_room, R_WAREHOUSE: _gen_warehouse,
        R_FACTORY: _gen_factory,
        R_RESTAURANT: _gen_restaurant, R_BAR: _gen_bar,
        R_DATACENTER: _gen_datacenter,
    })


_init_gens()


def furnish_rooms(interior, floor_height: float, seed: int,
                  is_office_bldg: bool = False,
                  btype: int | None = None) -> RoomObjects:
    """Place furniture in every room: composite per-type generators for
    the rich room types (bedroom/bathroom/kitchen/living/office/dining
    plus the institutional classroom/hospital/operating/jail/cafeteria/
    waiting rooms — oriented furniture groups, surface items, wall
    decorations, doorway clearance), recipe tables for the rest."""
    rg = RandGen(seed + 31, seed * 5 + 17)
    out = RoomObjects()
    out.room_types = assign_room_types(interior, rg, is_office_bldg, btype,
                                       fh=floor_height)
    # recipe dims are in units of 2.5 floor heights (a bed ~ 1.1 fh wide),
    # so furniture fits rooms whose min span is MIN_ROOM_F=1.4 fh
    scale = floor_height / 0.2
    fh = floor_height
    z1 = getattr(interior, "z1", 0.0)
    door_clear = 0.5 * fh
    doors_by_floor = {}
    for (dx, dy, dz, _dim) in getattr(interior, "doors", ()):
        fl = int(round((dz - z1) / fh)) if fh else 0
        doors_by_floor.setdefault(fl, []).append((dx, dy))

    for ri, (room, rtype) in enumerate(zip(interior.rooms, out.room_types)):
        z0 = z1 + room.floor * floor_height
        # doors on this room's boundary gate placement
        rdoors = [(dx, dy) for (dx, dy) in doors_by_floor.get(room.floor, ())
                  if room.x1 - 1e-6 <= dx <= room.x2 + 1e-6
                  and room.y1 - 1e-6 <= dy <= room.y2 + 1e-6]
        pl = _Placer(rg, room, rdoors, door_clear)
        if room.floor >= interior.num_floors:     # attic level
            _gen_attic(out, pl, rg, ri, room, z0, fh, scale)
            continue
        # every room gets a ceiling light (the reference's per-room
        # TYPE_LIGHT placement)
        lcx = 0.5 * (room.x1 + room.x2)
        lcy = 0.5 * (room.y1 + room.y2)
        out.add(ri, F_CEIL_LIGHT, lcx - 0.05 * scale, lcy - 0.05 * scale,
                z0 + 0.97 * fh, lcx + 0.05 * scale, lcy + 0.05 * scale,
                z0 + fh)
        # a wall light switch beside each door at hand height
        # (add_light_switches_to_room, building_interact.cpp: switches
        # toggle the room's ceiling light)
        for (dx, dy) in rdoors[:2]:
            # beside the door, clamped inside the room
            sx = min(max(dx + 0.12 * scale, room.x1), room.x2 - 0.03 * scale)
            sy = min(max(dy + 0.02 * scale, room.y1), room.y2 - 0.03 * scale)
            out.add(ri, F_LIGHT_SWITCH, sx, sy, z0 + 0.35 * fh,
                    sx + 0.025 * scale, sy + 0.012 * scale,
                    z0 + 0.42 * fh)
        if rtype in (R_BEDROOM, R_HOTEL):
            # window blinds on one exterior-ish wall (add_window_coverings)
            bx = room.x1 + 0.02 * scale
            by = 0.5 * (room.y1 + room.y2)
            out.add(ri, F_BLINDS, bx, by - 0.15 * scale, z0 + 0.4 * fh,
                    bx + 0.01 * scale, by + 0.15 * scale, z0 + 0.9 * fh)
        gen = _COMPOSITE_GENS.get(rtype)
        if rtype in (R_FACTORY, R_DATACENTER, R_UTILITY, R_SERVER):
            _ceiling_pipes(out, rg, ri, room, z0, fh, scale)
        if btype == BT_SCHOOL and rtype == R_HALL:
            _hall_lockers(out, pl, rg, ri, room, z0, fh, scale)
        if gen is not None:
            gen(out, pl, rg, ri, room, z0, fh, scale)
            continue
        recipe = _RECIPES.get(rtype, [])
        for (kind, count, against_wall, w, d, h) in recipe:
            w *= scale
            d *= scale
            h *= scale
            for _ in range(count):
                p = pl.try_place(w, d, against_wall)
                if p is None:
                    continue
                x, y, rot = p
                idx = out.add(ri, kind, x, y, z0, x + w, y + d, z0 + h,
                              rot=rot)
                _surface_items(out, pl, rg, ri, kind, idx, x, y, z0 + h,
                               w, d, scale)
    add_basement_pipes(interior, out, fh, rg)
    return out


def add_basement_pipes(interior, out: RoomObjects, fh: float,
                       rg: RandGen) -> int:
    """Basement utility pipe network (building_basement.cpp:853-864 +
    building_pipes.cpp): every water fixture placed on the floors above
    (toilets, sinks, tubs, washers) gets a vertical riser dropping into
    the basement; risers join a main trunk run along the basement
    ceiling through L-shaped branch segments, one parallel run per pipe
    type — sewer (largest), cold water, hot water, gas — and the trunk
    exits through an exterior wall.  Returns the number of pipe objects
    added (0 when the interior has no basement)."""
    basement = None
    b_ri = -1
    for ri, room in enumerate(interior.rooms):
        if room.floor < 0:
            basement = room
            b_ri = ri
            break
    if basement is None:
        return 0
    z1 = getattr(interior, "z1", 0.0)
    ceil_z = z1                        # basement ceiling = ground floor
    # fixture connection points (get_pipe_basement_water_connections)
    water_kinds = {F_TOILET, F_SINK, F_TUB, F_WASHER}
    gas_kinds = {F_STOVE, F_FURNACE, F_WATER_HEATER, F_DRYER}
    conns = []
    for i, k in enumerate(out.kinds):
        if k in water_kinds or k in gas_kinds:
            (x1, y1, _zz1, x2, y2, _zz2) = out.cubes[i]
            cx = 0.5 * (x1 + x2)
            cy = 0.5 * (y1 + y2)
            if basement.x1 < cx < basement.x2 and \
                    basement.y1 < cy < basement.y2:
                conns.append((cx, cy, k in gas_kinds))
    if not conns:
        return 0
    n0 = len(out.cubes)
    # pipe types: (kind, radius in fh units, z offset below ceiling)
    # sewer is the largest and lowest (add_basement_pipes order)
    ptypes = ((F_SEWER_PIPE, 0.035, 0.10), (F_CW_PIPE, 0.018, 0.16),
              (F_HW_PIPE, 0.015, 0.20), (F_GAS_PIPE, 0.012, 0.24))
    rw = basement.x2 - basement.x1
    rh = basement.y2 - basement.y1
    long_x = rw >= rh
    for (kind, prf, zoff) in ptypes:
        pr = prf * fh
        zc = ceil_z - zoff * fh
        gas = kind == F_GAS_PIPE
        pts = [(cx, cy) for (cx, cy, g) in conns if g == gas]
        if not pts:
            continue
        # trunk along the long axis through the mean lateral position
        lat = sum((p[1] if long_x else p[0]) for p in pts) / len(pts)
        lat += (rg.randd() - 0.5) * 0.1 * (rh if long_x else rw)
        if long_x:
            lat = min(max(lat, basement.y1 + 2 * pr), basement.y2 - 2 * pr)
            # trunk exits through the -x wall (main sewer line exit)
            out.add(b_ri, kind, basement.x1 - 0.05 * fh, lat - pr, zc - pr,
                    basement.x2 - 0.2 * rw * rg.randd(), lat + pr, zc + pr)
        else:
            lat = min(max(lat, basement.x1 + 2 * pr), basement.x2 - 2 * pr)
            out.add(b_ri, kind, lat - pr, basement.y1 - 0.05 * fh, zc - pr,
                    lat + pr, basement.y2 - 0.2 * rh * rg.randd(), zc + pr)
        ti = len(out.cubes) - 1
        for (cx, cy) in pts:
            # vertical riser from the ceiling down to the pipe level
            out.add(b_ri, F_PIPE_RISER, cx - pr, cy - pr, zc,
                    cx + pr, cy + pr, ceil_z, parent=ti)
            # L-branch from the riser to the trunk
            if long_x:
                out.add(b_ri, kind, cx - pr, min(cy, lat), zc - pr,
                        cx + pr, max(cy, lat), zc + pr, parent=ti)
            else:
                out.add(b_ri, kind, min(cx, lat), cy - pr, zc - pr,
                        max(cx, lat), cy + pr, zc + pr, parent=ti)
    return len(out.cubes) - n0


def furnish_buildings(buildings, params, seed: int = 1):
    """Furnish every floorplanned building (the room-content pass of
    gen_buildings)."""
    results = []
    for bi, b in enumerate(buildings):
        if b.interior is None:
            results.append(None)
            continue
        office = (len(b.parts) > 0 and (b.parts[0][5] - b.parts[0][2])
                  > 4 * params.floor_height)
        # a fraction of office-class buildings become institutional
        # types (the reference assigns BTYPE_SCHOOL/HOSPITAL/PRISON at
        # city building gen; city gen configs set the mix)
        btype = BT_OFFICE if office else BT_HOUSE
        if office:
            roll = (seed * 131 + bi * 29) % 16
            btype = {0: BT_SCHOOL, 1: BT_HOSPITAL, 2: BT_JAIL,
                     3: BT_HOTEL, 4: BT_APARTMENT, 5: BT_WAREHOUSE,
                     6: BT_POLICE, 7: BT_FIRE_STATION,
                     8: BT_CONV_STORE}.get(roll, BT_OFFICE)
        results.append(furnish_rooms(b.interior, params.floor_height,
                                     seed + 7 * bi, office, btype=btype))
    return results


# room-type door-sign nouns (get_room_name, building_names_signs.cpp:155;
# numbered like add_numbered_door_sign)
_SIGN_NOUNS = {R_CLASSROOM: "Classroom", R_HOTEL: "Room",
               R_HOSPITAL: "Room", R_OFFICE: "Office",
               R_CONFERENCE: "Conference Room", R_OPERATING: "OR",
               R_JAIL: "Cell Block", R_CAFETERIA: "Cafeteria",
               R_LIBRARY: "Library", R_WAITING: "Waiting Room"}


def label_objects(interior, objs: RoomObjects, seed: int):
    """Text labels: book titles from the shipped book_titles.txt and
    numbered door signs per labeled room type (building_names_signs.cpp
    add_numbered_door_sign / TYPE_BOOK title assignment).  Drawn from a
    separate RNG stream so placement stays byte-identical."""
    from ..utils.names import choose_book_title
    rg = RandGen(seed + 41, 3 * seed + 13)
    labels = {}
    for idx, kind in enumerate(objs.kinds):
        if kind == F_BOOK:
            labels[idx] = choose_book_title(rg)
    signs = {}
    counters = {}
    for ri, rt in enumerate(objs.room_types):
        noun = _SIGN_NOUNS.get(rt)
        if noun is None:
            continue
        floor = interior.rooms[ri].floor
        n = counters.get((rt, floor), 0) + 1
        counters[(rt, floor)] = n
        signs[ri] = (f"{noun} {100 * (floor + 1) + n}"
                     if rt in (R_HOTEL, R_HOSPITAL) else f"{noun} {n}")
    return labels, signs


def building_name(btype: int, seed: int) -> str:
    """Business name on the building sign (choose_business_name)."""
    from ..utils.names import choose_business_name
    kind = {BT_HOUSE: "house", BT_OFFICE: "office", BT_SCHOOL: "school",
            BT_HOSPITAL: "hospital", BT_JAIL: "prison",
            BT_APARTMENT: "apartment", BT_HOTEL: "hotel",
            BT_WAREHOUSE: "warehouse", BT_POLICE: "police",
            BT_FIRE_STATION: "fire_stat",
            BT_CONV_STORE: "office"}[btype]
    rg = RandGen(seed + 23, seed * 7 + 3)
    if kind == "house":
        from ..utils.names import gen_person_name
        return gen_person_name(seed, bool(seed & 1), False, True) \
            + " Residence"
    return choose_business_name(rg, kind)

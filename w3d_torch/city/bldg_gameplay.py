"""Building gameplay: room-object pickup/inventory, consumables, sound
alerts, and zombie mode (people hunt the player).

Re-designed equivalent of the reference's building gameplay layer
(building_gameplay.cpp:11-1510 — bldg_obj_type table, player_inventory_t
with health/drunkenness/weight, do_room_obj_pickup, consumables,
register_building_sound; building_navigation.cpp:1216-1410 and :2842-2979
— ai_target_player routing, zombie_in_attack_range damage).

Host-side state machine by design: inventory and alert bookkeeping are
O(1) per event; the batched parts (people stepping, thrown-object
physics) ride the existing vmapped walkers (city/people.py) and the
object SoA (physics/step.py).

Port of `3dworld_tpu/city/bldg_gameplay.py` (host code, copied whole):
the zombies' re-routed paths go to the people's device, and a thrown
object is written into the port's `physics/step.ObjectState` tensors.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from . import room_content as RC
from . import people as PP

THROW_VELOCITY = 0.0050        # building_gameplay.cpp:11
ALERT_THRESH = 0.08            # building_gameplay.cpp:12
PLAYER_RESPAWN = 5.0           # seconds, building_gameplay.cpp:13
ZOMBIE_ATTACK_RANGE = 0.6      # in room-grid units (person radius scale)
ZOMBIE_ATTACK_DAMAGE = 0.04    # health per attack tick
DRUNK_MAX_DAMAGE_REDUCTION = 0.75  # building_gameplay.cpp:821
SOUND_DECAY = 0.92             # per-frame alert decay


# secondary/surface item properties (setup_bldg_obj_types small items)
_SMALL_PROPS = {
    "F_PILLOW":   (15.0, 1.0, True, False, 0.0),
    "F_MONITOR":  (250.0, 15.0, True, False, 0.0),
    "F_KEYBOARD": (30.0, 2.0, True, False, 0.0),
    "F_COMPUTER": (500.0, 20.0, True, False, 0.0),
    "F_BOOK":     (10.0, 1.5, True, False, 0.0),
    "F_BOTTLE":   (2.0, 1.0, True, True, 0.05),
    "F_PLATE":    (6.0, 1.0, True, False, 0.0),
    "F_PICTURE":  (40.0, 4.0, True, False, 0.0),
    "F_MIRROR":   (60.0, 12.0, False, False, 0.0),
    "F_TOWEL_RACK": (20.0, 3.0, False, False, 0.0),
    "F_CUBICLE":  (200.0, 60.0, False, False, 0.0),
    "F_RAILING":  (0.0, 0.0, False, False, 0.0),
    "F_CABINET":  (100.0, 40.0, False, False, 0.0),
    "F_PAPER":    (0.0, 0.0, True, False, 0.0),
    "F_PAN":      (12.0, 2.5, True, False, 0.0),
}


# per-furniture-kind gameplay properties, mirroring setup_bldg_obj_types
# (building_gameplay.cpp:56-318): (value $, weight lbs, pickupable,
# consumable, heal amount).  Kind ids from room_content.py.
_PROPS = {
    RC.F_BED:      (120.0, 80.0, False, False, 0.0),
    RC.F_TOILET:   (120.0, 88.0, False, False, 0.0),
    RC.F_SINK:     (80.0, 55.0, False, False, 0.0),
    RC.F_TUB:      (250.0, 200.0, False, False, 0.0),
    RC.F_COUNTER:  (0.0, 0.0, False, False, 0.0),
    RC.F_FRIDGE:   (700.0, 300.0, False, False, 0.0),
    RC.F_STOVE:    (400.0, 150.0, False, False, 0.0),
    RC.F_TABLE:    (70.0, 40.0, True, False, 0.0),
    RC.F_CHAIR:    (50.0, 25.0, True, False, 0.0),
    RC.F_COUCH:    (600.0, 150.0, False, False, 0.0),
    RC.F_TV:       (400.0, 70.0, True, False, 0.0),
    RC.F_DESK:     (100.0, 80.0, False, False, 0.0),
    RC.F_BOOKCASE: (150.0, 100.0, False, False, 0.0),
    RC.F_SHELF:    (75.0, 80.0, False, False, 0.0),
    RC.F_RACK:     (150.0, 100.0, False, False, 0.0),
    RC.F_LAMP:     (45.0, 12.0, True, False, 0.0),
    RC.F_RUG:      (50.0, 16.0, True, False, 0.0),
    RC.F_PLANT:    (18.0, 8.0, True, True, 0.25),  # ~healing food stand-in
    RC.F_WARDROBE: (200.0, 120.0, False, False, 0.0),
    RC.F_NIGHTSTAND: (60.0, 25.0, True, False, 0.0),
    RC.F_DRESSER:  (130.0, 110.0, False, False, 0.0),
    RC.F_MICROWAVE: (100.0, 30.0, True, False, 0.0),
    RC.F_WASHER:   (300.0, 160.0, False, False, 0.0),
    RC.F_DRYER:    (300.0, 160.0, False, False, 0.0),
    RC.F_WATER_HEATER: (500.0, 280.0, False, False, 0.0),
    RC.F_FURNACE:  (600.0, 300.0, False, False, 0.0),
    RC.F_POOL_TABLE: (1500.0, 500.0, False, False, 0.0),
    RC.F_WHITEBOARD: (50.0, 15.0, True, False, 0.0),
    RC.F_CONF_TABLE: (250.0, 120.0, False, False, 0.0),
    RC.F_VENDING:  (2000.0, 400.0, False, False, 0.0),
    RC.F_JAIL_BARS: (0.0, 0.0, False, False, 0.0),
    RC.F_HOSPITAL_BED: (900.0, 180.0, False, False, 0.0),
    RC.F_MACHINE:  (5000.0, 800.0, False, False, 0.0),
    RC.F_SERVER_RACK_ROW: (8000.0, 600.0, False, False, 0.0),
    RC.F_BOOTH:    (400.0, 150.0, False, False, 0.0),
    RC.F_PARK_SPACE: (0.0, 0.0, False, False, 0.0),
}
_PROPS.update({getattr(RC, k): v for k, v in _SMALL_PROPS.items()})
# nested/expanded content kinds (closet internals, floor clothes,
# fixtures): value/weight/pickable/consumable/heal
_PROPS.update({
    RC.F_CLOSET:        (250.0, 150.0, False, False, 0.0),
    RC.F_HANGER:        (0.5, 0.1, True, False, 0.0),
    RC.F_CLOTHES:       (15.0, 1.0, True, False, 0.0),
    RC.F_BOX:           (5.0, 8.0, True, False, 0.0),
    RC.F_CEIL_LIGHT:    (40.0, 10.0, False, False, 0.0),
    RC.F_LAVALAMP:      (60.0, 6.0, True, False, 0.0),
    RC.F_FLOOR_CLOTHES: (10.0, 1.0, True, False, 0.0),
    RC.F_PILLAR:        (0.0, 0.0, False, False, 0.0),
    RC.F_RAMP:          (0.0, 0.0, False, False, 0.0),
    RC.F_OLD_CHAIR:     (20.0, 20.0, True, False, 0.0),
    RC.F_CHEST:         (150.0, 60.0, False, False, 0.0),
    RC.F_PIPE:          (0.0, 0.0, False, False, 0.0),
    RC.F_DUCT:          (0.0, 0.0, False, False, 0.0),
    # institutional kinds (schools/hospitals/jails)
    RC.F_CHALKBOARD:    (80.0, 30.0, False, False, 0.0),
    RC.F_CURTAIN:       (30.0, 4.0, True, False, 0.0),
    RC.F_LOCKER:        (90.0, 60.0, False, False, 0.0),
    RC.F_OPERATING_TABLE: (4000.0, 350.0, False, False, 0.0),
    RC.F_CELL_WALL:     (0.0, 0.0, False, False, 0.0),
    RC.F_TANK:          (3000.0, 900.0, False, False, 0.0),
    RC.F_CONV_BELT:     (2500.0, 700.0, False, False, 0.0),
    # round-4 depth-pass kinds: restaurant/bar, datacenter, machine
    # internals, shelf contents, basement pipe network
    RC.F_STOOL:         (25.0, 12.0, True, False, 0.0),
    RC.F_BAR:           (900.0, 500.0, False, False, 0.0),
    RC.F_CASH_REG:      (250.0, 30.0, True, False, 0.0),
    RC.F_WINE_RACK:     (300.0, 120.0, False, False, 0.0),
    RC.F_MENU_BOARD:    (40.0, 10.0, False, False, 0.0),
    RC.F_SERVER:        (1200.0, 25.0, True, False, 0.0),
    RC.F_CABLE_TRAY:    (0.0, 0.0, False, False, 0.0),
    RC.F_VENT_TILE:     (0.0, 0.0, False, False, 0.0),
    RC.F_PDU:           (800.0, 90.0, False, False, 0.0),
    RC.F_CRAC:          (5000.0, 400.0, False, False, 0.0),
    RC.F_GAUGE:         (15.0, 1.0, False, False, 0.0),
    RC.F_VALVE:         (20.0, 2.0, False, False, 0.0),
    RC.F_HOSE:          (10.0, 3.0, False, False, 0.0),
    RC.F_BREAKER_PANEL: (120.0, 40.0, False, False, 0.0),
    RC.F_LADDER:        (80.0, 25.0, False, False, 0.0),
    RC.F_CATWALK:       (0.0, 0.0, False, False, 0.0),
    RC.F_PAINT_CAN:     (12.0, 10.0, True, False, 0.0),
    RC.F_BALL:          (8.0, 1.0, True, False, 0.0),
    RC.F_SPRAYCAN:      (4.0, 1.0, True, False, 0.0),
    RC.F_TRASHCAN:      (15.0, 8.0, True, False, 0.0),
    RC.F_FIRE_EXT:      (50.0, 15.0, True, False, 0.0),
    RC.F_FLASHLIGHT:    (10.0, 1.0, True, False, 0.0),
    RC.F_SEWER_PIPE:    (0.0, 0.0, False, False, 0.0),
    RC.F_CW_PIPE:       (0.0, 0.0, False, False, 0.0),
    RC.F_HW_PIPE:       (0.0, 0.0, False, False, 0.0),
    RC.F_GAS_PIPE:      (0.0, 0.0, False, False, 0.0),
    RC.F_PIPE_RISER:    (0.0, 0.0, False, False, 0.0),
    # interaction-surface kinds (round 5): fixed to walls, not lootable
    RC.F_LIGHT_SWITCH:  (0.0, 0.0, False, False, 0.0),
    RC.F_BLINDS:        (25.0, 4.0, False, False, 0.0),
    # clocks: value 20, weight 1, takeable (bldg_obj_types TYPE_CLOCK,
    # building_gameplay.cpp:171)
    RC.F_CLOCK:         (20.0, 1.0, True, False, 0.0),
})
MAX_CARRY_WEIGHT = 200.0  # lbs, reference player_inventory weight limit


@dataclass
class PlayerInventory:
    """player_inventory_t (building_gameplay.cpp:729-830): carried value
    and weight, lifetime totals, and survival stats."""

    carried: list = field(default_factory=list)   # kind ids
    cur_value: float = 0.0
    cur_weight: float = 0.0
    tot_value: float = 0.0
    tot_weight: float = 0.0
    best_value: float = 0.0
    damage_done: float = 0.0
    health: float = 1.0
    drunkenness: float = 0.0
    oxygen: float = 1.0
    thirst: float = 1.0
    respawn_timer: float = 0.0    # >0 while waiting to respawn

    @property
    def dead(self) -> bool:
        return self.respawn_timer > 0.0

    def adjust_health(self, dh: float):
        """building_gameplay.cpp:761-777 (+ drunk damage reduction :821)."""
        if dh < 0.0:
            dh *= 1.0 - DRUNK_MAX_DAMAGE_REDUCTION * min(self.drunkenness, 1.0)
        self.health = min(1.0, self.health + dh)
        if self.health <= 0.0:
            self.respawn_timer = PLAYER_RESPAWN

    def tick(self, dt: float):
        if self.respawn_timer > 0.0:
            self.respawn_timer -= dt
            if self.respawn_timer <= 0.0:   # respawn with empty hands
                self.respawn_timer = 0.0
                self.health = 1.0
                self.drunkenness = 0.0
                self.carried.clear()
                self.cur_value = self.cur_weight = 0.0


def can_pickup(kind: int, inv: PlayerInventory) -> bool:
    val, wt, pick, _cons, _heal = _PROPS[kind]
    return pick and not inv.dead and inv.cur_weight + wt <= MAX_CARRY_WEIGHT


def do_pickup(kind: int, inv: PlayerInventory) -> bool:
    """do_room_obj_pickup: consumable heal-food is eaten immediately when
    hurt, otherwise carried (building_gameplay.cpp:573)."""
    val, wt, pick, cons, heal = _PROPS[kind]
    if not can_pickup(kind, inv):
        return False
    if cons and heal > 0.0 and inv.health < 1.0:
        inv.adjust_health(heal)
        inv.tot_value += val
        return True
    inv.carried.append(kind)
    inv.cur_value += val
    inv.cur_weight += wt
    inv.tot_value += val
    inv.tot_weight += wt
    inv.best_value = max(inv.best_value, inv.cur_value)
    return True


def drop_last(inv: PlayerInventory):
    """use_last_pickup_object: drop/throw the most recent item; returns
    (kind, throw_velocity) or None."""
    if not inv.carried:
        return None
    kind = inv.carried.pop()
    val, wt, _p, _c, _h = _PROPS[kind]
    inv.cur_value -= val
    inv.cur_weight -= wt
    return kind, THROW_VELOCITY


# ---------------------------------------------------------------------------
# sound alerts
# ---------------------------------------------------------------------------

@dataclass
class SoundAlert:
    """cur_building_sound_level with decay; zombies hear above
    ALERT_THRESH (building_gameplay.cpp:12,587-650)."""

    level: float = 0.0
    pos: tuple = (0.0, 0.0, 0.0)

    def register(self, level: float, pos):
        if level >= self.level * SOUND_DECAY:
            self.pos = tuple(float(v) for v in pos)
        self.level = min(1.0, self.level + level)

    def tick(self):
        self.level *= SOUND_DECAY

    @property
    def alerted(self) -> bool:
        return self.level >= ALERT_THRESH


# ---------------------------------------------------------------------------
# zombie mode
# ---------------------------------------------------------------------------

def retarget_zombies(st: PP.PeopleState, graph: PP.NavGraph,
                     player_room: int, alert: SoundAlert,
                     cur_rooms, rg) -> PP.PeopleState:
    """ai_target_player retarget (building_navigation.cpp:1216-1278):
    when alerted (or sharing the player's room), every person re-routes
    to the player's room; otherwise normal wandering goals."""
    if player_room < 0:
        return PP.assign_goals(st, graph, cur_rooms, rg)
    n = len(cur_rooms)
    same_room = [r == player_room for r in cur_rooms]
    if not (alert.alerted or any(same_room)):
        return PP.assign_goals(st, graph, cur_rooms, rg)
    return PP.assign_goals(st, graph, cur_rooms, rg,
                           forced_dest=player_room)


def zombies_in_attack_range(st: PP.PeopleState, player_xy, player_floor,
                            attack_range: float = ZOMBIE_ATTACK_RANGE):
    """zombie_in_attack_range (building_navigation.cpp:2842): boolean [N]
    mask of people close enough to damage the player this tick."""
    px, py = float(player_xy[0]), float(player_xy[1])
    dx = st.x.cpu().numpy() - px
    dy = st.y.cpu().numpy() - py
    same_floor = st.floor.cpu().numpy().astype(np.int32) == int(player_floor)
    return same_floor & ((dx * dx + dy * dy) < attack_range * attack_range)


def zombie_attack_tick(st: PP.PeopleState, inv: PlayerInventory,
                       player_xy, player_floor) -> int:
    """Apply contact damage from all in-range zombies; returns count."""
    if inv.dead:
        return 0
    hits = int(zombies_in_attack_range(st, player_xy, player_floor).sum())
    if hits:
        inv.adjust_health(-ZOMBIE_ATTACK_DAMAGE * hits)
    return hits


# ---------------------------------------------------------------------------
# achievements (building_gameplay.cpp:694-715 achievement_tracker_t)
# ---------------------------------------------------------------------------

@dataclass
class AchievementTracker:
    """NUM_ACHIEVEMENTS named one-shot flags; register returns True only
    the first time (the reference shows an onscreen message then)."""

    unlocked: set = field(default_factory=set)

    NAMES = (
        "first_pickup", "kleptomaniac", "big_spender", "full_inventory",
        "first_kill", "zombie_slayer", "survivor", "night_owl",
        "deep_diver", "high_climber", "fire_starter", "rat_whisperer",
        "spider_squisher", "snake_charmer", "mall_rat", "backrooms_escapee",
        "teetotaler", "drunkard", "marathon", "completionist",
    )

    def register(self, name: str) -> bool:
        if name not in self.NAMES or name in self.unlocked:
            return False
        self.unlocked.add(name)
        return True

    @property
    def count(self) -> int:
        return len(self.unlocked)


# ---------------------------------------------------------------------------
# thrown objects, door state, zombie state machine
# (building_gameplay.cpp:1100-1300 throw/drop; building_interact.cpp
# doors; building_navigation.cpp:1216-1410 states)
# ---------------------------------------------------------------------------

def throw_object(inv: PlayerInventory, state, table, origin, direction,
                 free_slot: int, velocity: float = None):
    """Throw the last-picked-up inventory item as a physics object
    (player_inventory_t::use_last_item throw path): removes it from the
    inventory and spawns a BALL-class projectile carrying its weight."""
    from ..physics import types as PT
    if not inv.carried:
        return state, False
    kind = inv.carried.pop()
    val, wt, *_ = _PROPS.get(kind, (0.0, 1.0, True, False, 0.0))
    inv.cur_weight = max(inv.cur_weight - wt, 0.0)
    inv.cur_value = max(inv.cur_value - val, 0.0)
    v = THROW_VELOCITY * 400.0 if velocity is None else velocity
    d = np.asarray(direction, np.float32)
    d = d / max(np.linalg.norm(d), 1e-9)
    tid = PT.type_id("BALL")

    def put(a: torch.Tensor, value) -> torch.Tensor:
        a = a.clone()
        a[free_slot] = float(value)
        return a
    state = state._replace(
        px=put(state.px, origin[0]), py=put(state.py, origin[1]),
        pz=put(state.pz, origin[2]),
        vx=put(state.vx, v * d[0]), vy=put(state.vy, v * d[1]),
        vz=put(state.vz, v * d[2]),
        otype=put(state.otype, tid), status=put(state.status, 1),
        health=put(state.health, 100.0))
    return state, True


@dataclass
class DoorState:
    """Open/closed doors (building interact): closed doors cut the nav
    edge they carry and muffle sound through them."""

    open: dict = field(default_factory=dict)   # door index -> bool

    def toggle(self, di: int):
        self.open[di] = not self.open.get(di, True)
        return self.open[di]

    def is_open(self, di: int) -> bool:
        return self.open.get(di, True)


def nav_graph_with_doors(interior, doors: DoorState) -> PP.NavGraph:
    """Nav graph where closed doors remove their room-to-room edge
    (people/zombies can't path through a shut door)."""
    g = PP.build_nav_graph(interior)
    fh = getattr(interior, "floor_height", 1.0) or 1.0
    z1 = getattr(interior, "z1", 0.0)
    for di, (dx, dy, dz, _dim) in enumerate(interior.doors):
        if doors.is_open(di):
            continue
        # find the edge whose waypoint is this door and cut it
        for (a, b), (wx, wy, *_e) in list(g.waypoints.items()):
            if abs(wx - dx) < 1e-6 and abs(wy - dy) < 1e-6:
                if b in g.adj[a]:
                    g.adj[a].remove(b)
                if a in g.adj[b]:
                    g.adj[b].remove(a)
                del g.waypoints[(a, b)]
    return g


# zombie AI states (ai_room_update state machine)
Z_WANDER, Z_INVESTIGATE, Z_PURSUE, Z_ATTACK = range(4)


@dataclass
class ZombieAI:
    """Per-person AI state driving goal selection: wandering zombies
    that HEAR a sound go investigate its room; seeing the player (same
    room, or alerted) escalates to pursuit; contact attacks.  The
    reference drives this per-person in ai_room_update
    (building_navigation.cpp:2864); goals feed the batched walkers."""

    states: list = field(default_factory=list)

    def ensure(self, n: int):
        while len(self.states) < n:
            self.states.append(Z_WANDER)

    def update(self, st: PP.PeopleState, graph: PP.NavGraph, cur_rooms,
               player_room: int, player_xy, player_floor,
               alert: SoundAlert, sound_room: int, rg) -> PP.PeopleState:
        n = len(cur_rooms)
        self.ensure(n)
        in_range = zombies_in_attack_range(st, player_xy, player_floor) \
            if player_room >= 0 else np.zeros(n, bool)
        dests = []
        for i in range(n):
            sees_player = (player_room >= 0 and cur_rooms[i] == player_room)
            if in_range[i]:
                self.states[i] = Z_ATTACK
            elif sees_player or (alert.alerted and self.states[i] == Z_PURSUE):
                self.states[i] = Z_PURSUE
            elif alert.alerted and sound_room >= 0:
                self.states[i] = Z_INVESTIGATE
            elif self.states[i] in (Z_INVESTIGATE, Z_PURSUE) \
                    and not alert.alerted:
                self.states[i] = Z_WANDER
            dests.append({Z_WANDER: None,
                          Z_INVESTIGATE: sound_room,
                          Z_PURSUE: player_room,
                          Z_ATTACK: player_room}[self.states[i]])
        # group by destination for assign_goals (None = random wander)
        px = np.zeros((n, PP.MAX_PATH), np.float32)
        py = np.zeros((n, PP.MAX_PATH), np.float32)
        pf = np.zeros((n, PP.MAX_PATH), np.float32)
        plen = np.zeros(n, np.int32)
        R = len(graph.centers)
        for i in range(n):
            dest = dests[i] if dests[i] is not None else rg.rand() % R
            wps = graph.expand(graph.route(cur_rooms[i], dest))[:PP.MAX_PATH]
            for k, (wx, wy, wf, _we) in enumerate(wps):
                px[i, k], py[i, k], pf[i, k] = wx, wy, wf
            plen[i] = len(wps)
        t = lambda a: torch.as_tensor(a, device=st.x.device)
        return st._replace(path_x=t(px), path_y=t(py), path_f=t(pf), path_len=t(plen),
                           path_pos=torch.zeros((n,), dtype=torch.int32,
                                                device=st.x.device))


def loot_room(objs, room_ix: int, inv: PlayerInventory,
              ach: AchievementTracker = None) -> int:
    """Pick up every pickupable object in a room (do_room_obj_pickup
    over the room's contents); returns the number taken."""
    taken = 0
    for i, r in enumerate(objs.rooms):
        if r != room_ix:
            continue
        if do_pickup(objs.kinds[i], inv):
            taken += 1
    if ach is not None and taken:
        ach.register("first_pickup")
        if len(inv.carried) >= 20:
            ach.register("kleptomaniac")
    return taken

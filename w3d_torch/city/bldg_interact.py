"""Building interaction surface: light switches, appliances, openable
storage, window blinds.

The reference's `building_t::interact_with_object` (building_interact.cpp,
2796 LoC) lets the player toggle wall switches (room lights on/off),
open/close cabinets, closets, fridges, lockers, boxes and chests (gating
their contents), power TVs/monitors/lamps on and off (dynamic light
sources), turn stove burners on (heat + smoke source), and open window
blinds (daylight factor).  This module is that interaction layer over
`room_content.RoomObjects`:

  * `InteractState` — one open/on flag per room object + per-room light
    state (every room light starts ON, like the reference's
    building lights defaulting lit when the player enters).
  * `interact_at` — toggle the nearest interactable within reach.
  * Effects feed the REAL subsystems, not a side store:
      - `apply_room_lights(mgr, ...)` drives
        lighting.building_indir.BuildingIndirManager.set_enabled, so a
        flipped switch invalidates/re-composites that room's indirect
        volume exactly like the reference's light-toggle path
        (building_lighting.cpp:register_indir_lighting_state_change);
      - `active_object_lights` lists lit TVs/lamps for the dlight layer;
      - `stove_heat_sources` lists burning stoves for smoke/fire;
      - `lootable_mask` gates loot_room on container open state;
      - `window_light_scale` scales per-room daylight by blinds state.

Port of `3dworld_tpu/city/bldg_interact.py` (host code, copied whole);
`apply_room_lights` drives the port's
`lighting/building_indir.BuildingIndirManager`.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from . import room_content as RC

# object kinds the player can toggle (interact_with_object cases)
SWITCHES = (RC.F_LIGHT_SWITCH,)
OPENABLE = (RC.F_CABINET, RC.F_CLOSET, RC.F_FRIDGE, RC.F_LOCKER, RC.F_BOX,
            RC.F_CHEST, RC.F_WARDROBE, RC.F_DRESSER, RC.F_NIGHTSTAND,
            RC.F_MICROWAVE, RC.F_WASHER, RC.F_DRYER, RC.F_BLINDS)
POWERED = (RC.F_TV, RC.F_MONITOR, RC.F_LAMP, RC.F_LAVALAMP, RC.F_STOVE)
INTERACTABLE = SWITCHES + OPENABLE + POWERED

# emissive colors for powered objects (TV screen glow, lamp warm white,
# stove burner red — building_lighting.cpp dynamic light colors)
_POWER_COLOR = {
    RC.F_TV: (0.35, 0.40, 0.55),
    RC.F_MONITOR: (0.30, 0.35, 0.45),
    RC.F_LAMP: (1.0, 0.85, 0.6),
    RC.F_LAVALAMP: (0.9, 0.3, 0.7),
    RC.F_STOVE: (1.0, 0.35, 0.1),
}


@dataclass
class InteractState:
    """Mutable interaction state for one furnished building."""

    obj_on: np.ndarray          # [K] bool: open (storage/blinds) or
    #                             powered-on (TV/lamp/stove)
    room_light_on: np.ndarray   # [R] bool: ceiling light per room
    toggles: int = 0            # interaction count (stats/achievements)
    log: list = field(default_factory=list)   # (kind, index, new_state)


def make_interact_state(objs: RC.RoomObjects, num_rooms: int) -> InteractState:
    k = len(objs.kinds)
    return InteractState(
        obj_on=np.zeros(k, bool),
        room_light_on=np.ones(max(num_rooms, 1), bool))


def _centers(objs: RC.RoomObjects) -> np.ndarray:
    c = np.asarray(objs.cubes, np.float32).reshape(-1, 6)
    return 0.5 * (c[:, :3] + c[:, 3:])


def interact_at(objs: RC.RoomObjects, st: InteractState, px, py, pz,
                reach: float = 0.25):
    """Toggle the nearest interactable object within `reach` of the
    player point (interact_with_object's proximity pick).  Returns the
    toggled object index, or -1 if nothing is in reach.

    A light switch toggles its ROOM's ceiling light; everything else
    flips its own open/on flag."""
    if not objs.kinds:
        return -1
    kinds = np.asarray(objs.kinds)
    cent = _centers(objs)
    mask = np.isin(kinds, INTERACTABLE)
    if not mask.any():
        return -1
    d2 = ((cent[:, 0] - px) ** 2 + (cent[:, 1] - py) ** 2
          + (cent[:, 2] - pz) ** 2)
    d2 = np.where(mask, d2, np.inf)
    i = int(np.argmin(d2))
    if d2[i] > reach * reach:
        return -1
    kind = int(kinds[i])
    if kind in SWITCHES:
        ri = int(objs.rooms[i])
        st.room_light_on[ri] = ~st.room_light_on[ri]
        st.log.append((kind, i, bool(st.room_light_on[ri])))
    else:
        st.obj_on[i] = ~st.obj_on[i]
        st.log.append((kind, i, bool(st.obj_on[i])))
    st.toggles += 1
    return i


def apply_room_lights(mgr, objs: RC.RoomObjects, st: InteractState) -> int:
    """Push per-room light states into a BuildingIndirManager: the
    ceiling light of a switched-off room is disabled (its cached volume
    drops out of composite instantly — the reference's indir state
    change).  Light registration indices follow the object index.
    Returns the number of lights whose state changed."""
    kinds = np.asarray(objs.kinds)
    changed = 0
    for i in np.where(kinds == RC.F_CEIL_LIGHT)[0]:
        ri = int(objs.rooms[i])
        want = bool(st.room_light_on[ri])
        if int(i) in mgr.lights and mgr.enabled.get(int(i), True) != want:
            mgr.set_enabled(int(i), want)
            changed += 1
    return changed


def active_object_lights(objs: RC.RoomObjects, st: InteractState):
    """(pos [L,3], color [L,3]) of powered-on emissive objects, for the
    dynamic-light layer (lighting/dlights.py)."""
    kinds = np.asarray(objs.kinds)
    cent = _centers(objs)
    onk = np.isin(kinds, POWERED) & st.obj_on
    idx = np.where(onk)[0]
    pos = cent[idx]
    col = np.asarray([_POWER_COLOR[int(kinds[i])] for i in idx], np.float32) \
        if len(idx) else np.zeros((0, 3), np.float32)
    return pos, col


def stove_heat_sources(objs: RC.RoomObjects, st: InteractState):
    """Positions of burning stoves — smoke/heat emitters for the smoke
    volume (the reference ignites fires from lit burners)."""
    kinds = np.asarray(objs.kinds)
    cent = _centers(objs)
    idx = np.where((kinds == RC.F_STOVE) & st.obj_on)[0]
    return cent[idx]


def lootable_mask(objs: RC.RoomObjects, st: InteractState) -> np.ndarray:
    """[K] bool: an object whose PARENT is a closed container can't be
    picked up (contents gated behind opening it, as the reference gates
    expanded objects behind open cabinet/closet doors)."""
    kinds = np.asarray(objs.kinds)
    par = np.asarray(objs.parent)
    ok = np.ones(len(kinds), bool)
    has_parent = par >= 0
    pk = kinds[np.clip(par, 0, len(kinds) - 1)]
    closed_parent = has_parent & np.isin(pk, OPENABLE) & \
        ~st.obj_on[np.clip(par, 0, len(kinds) - 1)]
    ok[closed_parent] = False
    return ok


def window_light_scale(objs: RC.RoomObjects, st: InteractState,
                       num_rooms: int, closed_scale: float = 0.25):
    """[R] daylight factor per room: closed blinds attenuate window
    light to `closed_scale` (add_window_coverings / blinds state)."""
    kinds = np.asarray(objs.kinds)
    out = np.ones(max(num_rooms, 1), np.float32)
    for i in np.where(kinds == RC.F_BLINDS)[0]:
        if not st.obj_on[i]:    # blinds start closed; open = on
            out[int(objs.rooms[i])] = closed_scale
    return out

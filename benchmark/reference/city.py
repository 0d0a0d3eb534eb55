"""Plain reference of the live city frame (`tiled_city_128`): the
stoplights, the cars, the pedestrians, the helicopters, the perch birds,
the trains, the elevator bank and the building people, one frame after
another, with the host's reroutes applied between frames.

Plain float32 PyTorch, written from the engine's description
(`next_city_frame`, city_gen.cpp:3801, run each drawn frame by
display_world.cpp:1295-1309; `stoplight_t`, city.h:365-397 and
roads.cpp:205-292; `car_manager_t::next_frame`, cars.cpp:1855;
`ped_manager_t`, pedestrians.cpp:2550; city_birds.cpp:173-178;
`ai_room_update`, building_navigation.cpp:2689 and :2864), independent of
the port: it imports nothing of it.  Its inputs are data: the layout
(road graph, stoplight tables, pedestrian navigation tables, helipads,
perches, rail line) and a start state as dicts of tensors, each frame's
draws (`frame_draws`, made here from the seed), and the paths that the
host's reroute of the building people applied after each frame (path
planning is host code).

Departures from the engine's description, each the deployment's own:

- Stoplights: the six states {EGL, EGWG, WGL, NGL, NGSG, SGL} advance
  when their time (5, 6, 5, 5, 6, 5 s at 40 frames a second) has passed,
  skipping the states of a missing direction at a three-way crossing;
  no waiting-car skip.  Two-way crossings never stop traffic.
- Cars: one road segment per grid line of a city, a lane each way; a car
  picks its next segment by a hash of its index and its segment, not a
  random roll, so a car waiting at a red arrow keeps its intent; it
  stops at a red light once past 0.92 of its segment and brakes while
  another driving car of its lane is ahead within 0.35 cells; a car
  parks at a segment end when its timer runs out and leaves its spot
  at the start of its segment when the timer runs out again (timers of
  120 + hash % 900 frames).  No acceleration, no lane change.
- Pedestrians: each walks within its block toward a goal; on reaching it
  one in 0.4 heads for a crossing to a neighbouring block, waits at the
  curb until the crossing's light is red both ways for the road crossed,
  crosses toward the next block's centre and takes a new goal there.
  Neighbours within 0.15 cells push with weight 1/d^2, the push summed
  over every other pedestrian of the city map and scaled to unit length,
  then mixed 0.4 into the step direction.  No cars in the way.
- Helicopters fly pad to pad: take off to 0.6 (or 0.08 above the target
  pad), cruise at 0.02 a frame, land at 0.01 a frame, wait the drawn
  frames.  Birds: take off to 0.175 above the perch, fly at 0.012 a frame
  toward the perch while nearing its height, glide while descending,
  land, wait.  Trains run out and back along one straight line.
- Elevators: one car a shaft, its doors closing and opening for 20
  frames, moving 0.05 floors a frame; an idle car takes the call of the
  lowest-numbered person waiting for it or riding it.
- Building people walk a padded path of at most 32 waypoints, push away
  from same-floor people within 0.06 (at most 0.35 of a step), wait for
  and ride the elevator, and rest for their drawn time at the path's
  end; the host reroutes those who arrived (the reroute is an input).
"""

from __future__ import annotations

import torch

STATE_SECS = (5.0, 6.0, 5.0, 5.0, 6.0, 5.0)     # city.h:368
STRAIGHT_GREEN = (2, 3, 1, 8, 12, 4)            # city.h:369, bits {W, E, S, N}
LEFT_GREEN = (2, 0, 1, 8, 0, 4)                 # city.h:370
NEAR_END = 0.92         # a car stops at a red light past this share of its segment
HEADWAY = 0.35          # cells
PED_RADIUS = 0.15       # cells
PED_PUSH = 0.4
CROSS_SHARE = 0.4       # of the pedestrians at their goal who head for a crossing
HELI_CRUISE, HELI_SPEED, HELI_VSPEED = 0.6, 0.02, 0.01
BIRD_SPEED, BIRD_VSPEED, BIRD_CRUISE = 0.012, 0.006, 0.35
DOOR_TICKS, CAR_SPEED = 20, 0.05
PATH = 32               # waypoints
AVOID, AVOID_SHARE = 0.06, 0.35
WALK, WAIT, RIDE, SIT, SLEEP = range(5)

FLOAT_FIELDS = {"cars": ("t",), "peds": ("x", "y", "gx", "gy"), "people": ("x", "y"),
                "helis": ("px", "py", "pz"), "birds": ("px", "py", "pz"), "trains": ("s",)}


def frame_draws(seed: int, frame: int, n_peds: int, n_helis: int, n_pads: int,
                n_birds: int, n_perches: int) -> dict:
    """One frame's draws, on the CPU, from a generator seeded by (seed,
    frame): for each pedestrian a uniform to head for a crossing, a side
    to cross and a new goal's two uniforms; for each helicopter its next
    pad and wait; for each bird its next perch and wait."""
    g = torch.Generator().manual_seed((seed % 2 ** 31) * 2 ** 32 + frame % 2 ** 32)
    u = lambda n: torch.rand((n,), generator=g, dtype=torch.float32)
    i = lambda lo, hi, n: torch.randint(lo, hi, (n,), generator=g, dtype=torch.int32)
    return {"ped_u": u(n_peds), "ped_side": i(0, 4, n_peds), "ped_u3": u(n_peds),
            "ped_u4": u(n_peds), "heli_pad": i(0, max(n_pads, 1), n_helis),
            "heli_wait": i(30, 120, n_helis), "bird_perch": i(0, max(n_perches, 1), n_birds),
            "bird_wait": i(60, 400, n_birds)}


def _sel(c, a, b):
    return torch.where(c, a, b)


# ---------------------------------------------------------------------------
# stoplights
# ---------------------------------------------------------------------------

def lights(lay: dict, st: dict) -> dict:
    tab = lay["lights"]
    s = st["state"].long()
    ticks = st["ticks"] + 1.0
    due = ticks > tab["state_time"].gather(1, s[:, None])[:, 0]
    return {"state": _sel(due, tab["next_state"].gather(1, s[:, None])[:, 0], st["state"]),
            "ticks": _sel(due, torch.zeros_like(ticks), ticks)}


def _green(lay: dict, st: dict, isec: torch.Tensor, left) -> torch.Tensor:
    """The green bits of crossing `isec`'s current state: straight and
    right turns, or left turns where `left`."""
    dev = isec.device
    sg = torch.tensor(STRAIGHT_GREEN, dtype=torch.int32, device=dev)
    lg = torch.tensor(LEFT_GREEN, dtype=torch.int32, device=dev)
    s = st["state"][isec.clamp(min=0).long()].long()
    return _sel(left, lg[s], sg[s]) if left is not None else sg[s]


def red(lay: dict, st: dict, isec, bit, left) -> torch.Tensor:
    ic = isec.clamp(min=0).long()
    stop = (_green(lay, st, isec, left) >> bit) & 1 == 0
    return stop & (isec >= 0) & (lay["lights"]["num_conn"][ic] > 2)


def may_cross(lay: dict, st: dict, isec, road_dim) -> torch.Tensor:
    bits = _sel(road_dim == 0, torch.full_like(road_dim, 3), torch.full_like(road_dim, 12))
    return (isec < 0) | ((_green(lay, st, isec, None) & bits) == 0)


# ---------------------------------------------------------------------------
# cars
# ---------------------------------------------------------------------------

def _heading(dim, end):
    sign = _sel(end == 1, torch.ones_like(dim, dtype=torch.float32),
                -torch.ones_like(dim, dtype=torch.float32))
    zero = torch.zeros_like(sign)
    return _sel(dim == 0, sign, zero), _sel(dim == 1, sign, zero)


def cars(lay: dict, c: dict, lit: dict) -> dict:
    g = lay["graph"]
    n = c["t"].shape[0]
    dev = c["t"].device
    seg, end = c["seg"].long(), c["end"].long()
    seg_len = g["length"][seg]
    dim = g["dim"][seg]
    # the turn intent: a hash of (car, segment) on 32-bit lanes
    m = 0xFFFFFFFF
    h = (torch.arange(n, dtype=torch.int64, device=dev) * 2654435761 + seg * 40503) & m
    h = h ^ (h >> 13)
    h = (h * 747796405) & m
    h = ((h ^ (h >> 16)) & (2 ** 30 - 1)).to(torch.int32)
    nn = g["num_next"][seg, end]
    pick = (h % nn.clamp(min=1)).long()
    nxt = g["next_seg"][seg, end, pick]
    nxt_end = 1 - g["next_end"][seg, end, pick]
    ax, ay = _heading(dim, c["end"])
    bx, by = _heading(g["dim"][nxt.clamp(min=0).long()], nxt_end)
    turn_left = ax * by - ay * bx > 0.5
    stop = g["has_light"][seg, end] & red(lay, lit, g["isec_id"][seg, end],
                                          2 * dim + c["end"], turn_left)
    # headway: another driving car of the lane ahead within HEADWAY cells
    moving = ~c["parked"]
    lane = (c["seg"][:, None] == c["seg"][None, :]) & (c["end"][:, None] == c["end"][None, :])
    gap = c["t"][None, :] - c["t"][:, None]
    close = (c["t"][None, :] > c["t"][:, None]) & (gap * seg_len[:, None] < HEADWAY)
    other = ~torch.eye(n, dtype=torch.bool, device=dev)
    brake = (lane & close & other & moving[:, None] & moving[None, :]).any(1)
    go = moving & ~brake & ~(stop & (c["t"] > NEAR_END))
    v = _sel(go, c["speed"], torch.zeros_like(c["speed"]))
    t = c["t"] + v / seg_len.clamp(min=1e-6)
    done = (t >= 1.0) & ~stop & moving
    turn = done & (nn > 0) & (nxt >= 0)
    t = _sel(turn, torch.zeros_like(t), _sel(done, torch.full_like(t, 0.999), t.clamp(max=0.999)))
    timer = (c["timer"] - 1).clamp(min=0)
    park = moving & (timer == 0) & done
    leave = c["parked"] & (timer == 0)
    return {**c, "seg": _sel(turn, nxt, c["seg"]), "end": _sel(turn, nxt_end, c["end"]),
            "t": _sel(leave, torch.zeros_like(t), t),
            "parked": (c["parked"] | park) & ~leave,
            "timer": _sel(park | leave, 120 + (h >> 8) % 900, timer),
            "frame": c["frame"] + 1}


# ---------------------------------------------------------------------------
# pedestrians
# ---------------------------------------------------------------------------

def push(x: torch.Tensor, y: torch.Tensor) -> tuple:
    """Each pedestrian's unit push away from the others within PED_RADIUS,
    weighted 1/d^2."""
    ex = x[:, None] - x[None, :]
    ey = y[:, None] - y[None, :]
    d2 = ex * ex + ey * ey
    near = (d2 < PED_RADIUS ** 2) & ~torch.eye(x.shape[0], dtype=torch.bool, device=x.device)
    w = _sel(near, 1.0 / d2.clamp(min=1e-4), torch.zeros_like(d2))
    px, py = (w * ex).sum(1), (w * ey).sum(1)
    n = torch.sqrt(px * px + py * py) + 1e-9
    return px / n, py / n


def _toward(tx, ty, x, y):
    dx, dy = tx - x, ty - y
    return dx, dy, torch.sqrt(dx * dx + dy * dy) + 1e-9


def peds(lay: dict, p: dict, lit: dict, dr: dict) -> dict:
    nav = lay["nav"]
    rx, ry = push(p["x"], p["y"])
    b, s = p["blk"].long(), p["side"].long()
    x1, y1, x2, y2 = nav["blk"][b].unbind(-1)
    to_blk = nav["adj"][b, s]
    walk = p["stage"] < 2
    tx = _sel(walk, nav["cross_x"][b, s].clamp(x1, x2), p["gx"])
    ty = _sel(walk, nav["cross_y"][b, s].clamp(y1, y2), p["gy"])
    dx, dy, d = _toward(tx, ty, p["x"], p["y"])
    at_curb = (p["stage"] == 0) & (d < 0.06)
    ok = may_cross(lay, lit, nav["cross_isec"][b, s], nav["cross_dim"][b, s])
    wait = at_curb & ~ok
    u1, v1, u2, v2 = nav["blk"][to_blk.clamp(min=0).long()].unbind(-1)
    over = (p["stage"] == 1) & (p["x"] >= u1) & (p["x"] <= u2) & (p["y"] >= v1) & (p["y"] <= v2)
    stage = _sel(over, torch.full_like(p["stage"], 2),
                 _sel(at_curb & ok, torch.ones_like(p["stage"]), p["stage"]))
    blk = _sel(over, to_blk, p["blk"])
    on_road = stage == 1
    tx = _sel(on_road, 0.5 * (u1 + u2), tx)
    ty = _sel(on_road, 0.5 * (v1 + v2), ty)
    dx, dy, d = _toward(tx, ty, p["x"], p["y"])
    mx, my = dx / d + PED_PUSH * rx, dy / d + PED_PUSH * ry
    ml = torch.sqrt(mx * mx + my * my) + 1e-9
    v = _sel(wait, torch.zeros_like(p["speed"]), p["speed"])
    x, y = p["x"] + v * mx / ml, p["y"] + v * my / ml
    c1, e1, c2, e2 = nav["blk"][blk.long()].unbind(-1)
    x = _sel(on_road, x, torch.minimum(torch.maximum(x, c1), c2))
    y = _sel(on_road, y, torch.minimum(torch.maximum(y, e1), e2))
    at_goal = (p["stage"] == 2) & (d < 0.05)
    side = dr["ped_side"]
    cross = at_goal & (dr["ped_u"] < CROSS_SHARE) & (nav["adj"][b, side.long()] >= 0)
    u3, u4 = dr["ped_u3"], dr["ped_u4"]
    gx = _sel(over, u1 + u3 * (u2 - u1), _sel(at_goal, x1 + u3 * (x2 - x1), p["gx"]))
    gy = _sel(over, v1 + u4 * (v2 - v1), _sel(at_goal, y1 + u4 * (y2 - y1), p["gy"]))
    return {**p, "x": x, "y": y, "gx": gx, "gy": gy, "blk": blk,
            "stage": _sel(cross, torch.zeros_like(stage), stage),
            "side": _sel(cross, side, p["side"])}


# ---------------------------------------------------------------------------
# helicopters, birds, trains
# ---------------------------------------------------------------------------

def helis(lay: dict, h: dict, dr: dict) -> dict:
    tx, ty, tz = lay["pads"][h["pad"].long()].unbind(-1)
    ph = h["phase"]
    parked, rising, flying, landing = ph == 0, ph == 1, ph == 2, ph == 3
    wait = (h["wait"] - parked.to(torch.int32)).clamp(min=0)
    cruise = (tz + 0.08).clamp(min=HELI_CRUISE)
    z = _sel(rising, torch.maximum(torch.minimum(h["pz"] + HELI_VSPEED, cruise), h["pz"]), h["pz"])
    up = rising & (z >= cruise - 1e-6)
    dx, dy, d = _toward(tx, ty, h["px"], h["py"])
    step = d.clamp(max=HELI_SPEED)
    x = _sel(flying, h["px"] + step * dx / d, h["px"])
    y = _sel(flying, h["py"] + step * dy / d, h["py"])
    above = flying & (d < 0.01)
    z = _sel(landing, torch.maximum(z - HELI_VSPEED, tz), z)
    down = landing & (z <= tz + 1e-6)
    one = torch.ones_like(ph)
    ph = _sel(parked & (wait == 0), one, ph)
    ph = _sel(up, 2 * one, ph)
    ph = _sel(above, 3 * one, ph)
    ph = _sel(down, 0 * one, ph)
    return {"px": x, "py": y, "pz": z, "pad": _sel(down, dr["heli_pad"], h["pad"]),
            "phase": ph, "wait": _sel(down, dr["heli_wait"], wait)}


def birds(lay: dict, b: dict, dr: dict) -> dict:
    tx, ty, tz = lay["perches"][b["perch"].long()].unbind(-1)
    s = b["state"]
    perched, rising, air, landing = s == 0, s == 1, (s == 2) | (s == 3), s == 4
    wait = (b["wait"] - perched.to(torch.int32)).clamp(min=0)
    z = _sel(rising, b["pz"] + BIRD_VSPEED, b["pz"])
    up = rising & (z >= tz + 0.5 * BIRD_CRUISE)
    dx, dy, d = _toward(tx, ty, b["px"], b["py"])
    step = d.clamp(max=BIRD_SPEED)
    x = _sel(air, b["px"] + step * dx / d, b["px"])
    y = _sel(air, b["py"] + step * dy / d, b["py"])
    vz = (tz + (d * 0.5).clamp(max=BIRD_CRUISE) - z).clamp(-BIRD_VSPEED, BIRD_VSPEED)
    z = _sel(air, z + vz, z)
    arrive = air & (d < 0.02)
    down = landing & (z <= tz + 1e-3)
    z = _sel(landing, torch.maximum(z - BIRD_VSPEED, tz), z)
    one = torch.ones_like(s)
    s = _sel(perched & (wait == 0), one, s)
    s = _sel(up, 2 * one, s)
    s = _sel(air & (vz < 0), 3 * one, s)
    s = _sel(air & (vz >= 0), 2 * one, s)
    s = _sel(arrive, 4 * one, s)
    s = _sel(down, 0 * one, s)
    return {"px": x, "py": y, "pz": z, "vz_sign": vz, "state": s,
            "perch": _sel(down, dr["bird_perch"], b["perch"]),
            "wait": _sel(down, dr["bird_wait"], wait)}


def trains(lay: dict, t: dict) -> dict:
    length = lay["rail"]["length"]
    s = t["s"] + t["speed"]
    turn = (s >= length) | (s <= 0.0)
    return {**t, "s": torch.minimum(s.clamp(min=0.0), length),
            "speed": _sel(turn, -t["speed"], t["speed"])}


# ---------------------------------------------------------------------------
# elevators and building people
# ---------------------------------------------------------------------------

def _at(a: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    return a.gather(1, k.long()[:, None])[:, 0]


def elevators(e: dict, q: dict) -> dict:
    n, cars_n = q["x"].shape[0], e["z"].shape[0]
    k = q["path_pos"].clamp(max=PATH - 1)
    shaft = _at(q["path_e"], k)
    waiting, riding = q["activity"] == WAIT, q["activity"] == RIDE
    want = _sel(waiting, torch.round(q["floor"]), _at(q["path_f"], (k + 1).clamp(max=PATH - 1)))
    asks = (waiting | riding) & (shaft >= 0)
    calls = asks[:, None] & (shaft[:, None] == torch.arange(cars_n, device=shaft.device)[None, :])
    first = torch.where(calls, torch.arange(n, device=shaft.device)[:, None],
                        torch.full_like(calls, n, dtype=torch.int64)).min(0).values
    floor = want[first.clamp(max=n - 1)]
    st, timer, target = e["state"], e["timer"], e["target"]
    take = (st == 0) & calls.any(0) & (torch.round(floor) != torch.round(e["z"]))
    target = _sel(take, torch.round(floor), target)
    st = _sel(take, torch.ones_like(st), st)
    timer = _sel(take, torch.full_like(timer, DOOR_TICKS), timer)
    closing, moving, opening = st == 1, st == 2, st == 3
    timer = _sel(closing, timer - 1, timer)
    st = _sel(closing & (timer <= 0), torch.full_like(st, 2), st)
    d = target - e["z"]
    there = moving & (d.abs() <= CAR_SPEED + 1e-4)
    z = _sel(moving, _sel(there, target, e["z"] + torch.sign(d) * CAR_SPEED), e["z"])
    st = _sel(there, torch.full_like(st, 3), st)
    timer = _sel(there, torch.full_like(timer, DOOR_TICKS), timer)
    timer = _sel(opening, timer - 1, timer)
    st = _sel(opening & (timer <= 0), torch.zeros_like(st), st)
    return {"z": z, "target": target, "state": st, "timer": timer}


def people(q: dict, car_z: torch.Tensor) -> dict:
    n = q["x"].shape[0]
    k = q["path_pos"].clamp(max=PATH - 1)
    tx, ty, tf = _at(q["path_x"], k), _at(q["path_y"], k), _at(q["path_f"], k)
    shaft = _at(q["path_e"], k)
    tf_next = _at(q["path_f"], (k + 1).clamp(max=PATH - 1))
    dx, dy, d = _toward(tx, ty, q["x"], q["y"])
    act = q["activity"]
    walking = act == WALK
    step = _sel(walking, torch.minimum(q["speed"], d), torch.zeros_like(d))
    ex = q["x"][:, None] - q["x"][None, :]
    ey = q["y"][:, None] - q["y"][None, :]
    d2 = ex * ex + ey * ey
    near = (q["floor"][:, None] == q["floor"][None, :]) & (d2 < AVOID * AVOID) & \
        ~torch.eye(n, dtype=torch.bool, device=ex.device)
    w = _sel(near, AVOID * torch.rsqrt(d2.clamp(min=1e-12)) - 1.0, torch.zeros_like(d2))
    ax, ay = (w * ex).sum(-1), (w * ey).sum(-1)
    al = torch.sqrt(ax * ax + ay * ay) + 1e-9
    scale = (AVOID_SHARE * q["speed"] * walking.to(torch.float32) / al).clamp(max=1.0)
    x = q["x"] + step * dx / d + ax * scale
    y = q["y"] + step * dy / d + ay * scale
    ne = car_z.shape[0]
    cz = _sel((shaft >= 0) & (shaft < ne), car_z[shaft.clamp(0, ne - 1).long()],
              torch.zeros_like(d))
    arrived_wp = d < 0.01
    one = torch.ones_like(act)
    act = _sel(walking & arrived_wp & (shaft >= 0) & ((tf_next - q["floor"]).abs() > 0.5),
               WAIT * one, act)
    act = _sel((act == WAIT) & ((cz - q["floor"]).abs() < 0.05), RIDE * one, act)
    riding = act == RIDE
    out = riding & ((cz - tf_next).abs() < 0.02)
    floor = _sel(out, tf_next, _sel(riding, cz, q["floor"]))
    act = _sel(out, WALK * one, act)
    floor = _sel(walking & (d < 0.02) & (shaft < 0), tf, floor)
    last = q["path_pos"] >= q["path_len"] - 1
    nxt = ((walking & arrived_wp & (shaft < 0)) | out) & ~last
    end = walking & arrived_wp & last & (q["end_act"] > 0)
    act = _sel(end, q["end_act"], act)
    timer = _sel(end, q["end_dur"], q["timer"])
    rest = (act == SIT) | (act == SLEEP)
    timer = _sel(rest, (timer - 1.0).clamp(min=0.0), timer)
    act = _sel(rest & (timer <= 0.0), WALK * one, act)
    return {**q, "x": x, "y": y, "floor": floor, "path_pos": q["path_pos"] + nxt.to(act.dtype),
            "activity": act, "timer": timer,
            "end_act": _sel(end, torch.zeros_like(act), q["end_act"])}


def reroute(q: dict, applied) -> dict:
    """The host's reroute after a frame: `applied` = (mask, path_x, path_y,
    path_f, path_e, path_len, end_act, end_dur) host arrays, or None."""
    if applied is None:
        return q
    dev = q["x"].device
    m, px, py, pf, pe, plen, eact, edur = (torch.as_tensor(a, device=dev) for a in applied)
    r = m[:, None]
    zero = torch.zeros_like
    return {**q, "path_x": _sel(r, px, q["path_x"]), "path_y": _sel(r, py, q["path_y"]),
            "path_f": _sel(r, pf, q["path_f"]), "path_e": _sel(r, pe, q["path_e"]),
            "path_len": _sel(m, plen, q["path_len"]),
            "path_pos": _sel(m, zero(q["path_pos"]), q["path_pos"]),
            "activity": _sel(m, zero(q["activity"]), q["activity"]),
            "timer": _sel(m, zero(q["timer"]), q["timer"]),
            "end_act": _sel(m, eact, q["end_act"]), "end_dur": _sel(m, edur, q["end_dur"])}


# ---------------------------------------------------------------------------
# the frame
# ---------------------------------------------------------------------------

def _bf16(part: dict, fields) -> dict:
    return {**part, **{f: part[f].to(torch.bfloat16).to(torch.float32) for f in fields}}


def frame(lay: dict, st: dict, dr: dict, applied=None, lowp: bool = False) -> dict:
    """One city frame from state `st` with draws `dr` (on the state's
    device), then the host's reroute `applied`.  With `lowp` (the
    control) the float state of the cars, the crowds and the movers
    (helicopters, birds, trains) is held in bfloat16."""
    if lowp:
        st = {**st, **{k: _bf16(st[k], f) for k, f in FLOAT_FIELDS.items()
                       if st.get(k) is not None}}
    out = dict(st)
    out["lights"] = lit = lights(lay, st["lights"])
    out["cars"] = cars(lay, st["cars"], lit)
    out["peds"] = peds(lay, st["peds"], lit, dr)
    if st.get("helis") is not None:
        out["helis"] = helis(lay, st["helis"], dr)
    if st.get("birds") is not None:
        out["birds"] = birds(lay, st["birds"], dr)
    if st.get("trains") is not None and lay.get("rail") is not None:
        out["trains"] = trains(lay, st["trains"])
    if st.get("people") is not None:
        out["elev"] = elevators(st["elev"], st["people"])
        out["people"] = reroute(people(st["people"], out["elev"]["z"]), applied)
    if lowp:
        out = {**out, **{k: _bf16(out[k], f) for k, f in FLOAT_FIELDS.items()
                         if out.get(k) is not None}}
    return out


def run(lay: dict, st: dict, frames, lowp: bool = False) -> dict:
    """`frames`: (draws, applied) for each frame in turn."""
    for dr, applied in frames:
        st = frame(lay, st, dr, applied, lowp)
    return st


# ---------------------------------------------------------------------------
# the readings
# ---------------------------------------------------------------------------

def _rows_off(a: dict, b: dict, fields) -> int:
    off = torch.zeros_like(a[fields[0]], dtype=torch.bool)
    for f in fields:
        off |= a[f] != b[f]
    return int(off.sum())


def _err(a: dict, b: dict, fields) -> float:
    e = 0.0
    for f in fields:
        d = (a[f].double() - b[f].double()).abs()
        e = max(e, float(torch.nan_to_num(d, nan=float("inf")).max()) if d.numel() else 0.0)
    return e


def readings(cand: dict, ref: dict) -> dict:
    """A city state `cand` held against the reference's `ref`: rows whose
    discrete fields differ, and the largest float errors."""
    out = {"lights_off": _rows_off(cand["lights"], ref["lights"], ("state", "ticks")),
           "cars_off": _rows_off(cand["cars"], ref["cars"], ("seg", "end", "parked", "timer")),
           "peds_off": _rows_off(cand["peds"], ref["peds"], ("blk", "stage", "side")),
           "car_t_err_max": _err(cand["cars"], ref["cars"], ("t",)),
           "ped_pos_err_max": _err(cand["peds"], ref["peds"], ("x", "y", "gx", "gy"))}
    if ref.get("people") is not None:
        out["people_off"] = _rows_off(cand["people"], ref["people"],
                                      ("activity", "path_pos", "end_act"))
        out["elev_off"] = _rows_off(cand["elev"], ref["elev"], ("state", "timer", "target"))
        out["people_pos_err_max"] = _err(cand["people"], ref["people"], ("x", "y", "floor"))
    movers, off = 0.0, 0
    for k, fl, dis in (("helis", ("px", "py", "pz"), ("phase", "pad", "wait")),
                       ("birds", ("px", "py", "pz"), ("state", "perch", "wait")),
                       ("trains", ("s", "speed"), ())):
        if ref.get(k) is not None:
            movers = max(movers, _err(cand[k], ref[k], fl))
            off += _rows_off(cand[k], ref[k], dis) if dis else 0
    out["movers_err_max"] = movers
    out["movers_off"] = off
    return out

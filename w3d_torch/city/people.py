"""Building people AI: room nav graph + batched walkers (port of
`3dworld_tpu/city/people.py`).

The reference builds a nav graph over rooms/stairs/doors
(`building_nav_graph_t`, building_navigation.cpp:283), finds routes with
A* (`find_route_to_point` :1931) and updates each person's state machine
per frame (`ai_room_update` :2864).

Split: graph + routing on the host (irregular, low-frequency; host code
copied from the JAX package), movement of ALL people as one elementwise
step over padded waypoint paths on the device (`step_people`).  Edges are
door-keyed: each room-to-room edge carries the connecting door's position
(stair edges carry the stair center), and routes expand to door-waypoint
paths.  The step adds pairwise separation avoidance (ai_room_update's
person-person collision, building_navigation.cpp:2689).  The JAX step's
one-hot row reads are indexed gathers here (the same values).
`BuildingPeopleSim` drives one building from the host, reading the people
back every step as the JAX package's does; the fused city step
(`city_step`) is the batched form.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from ..utils.rng import RandGen

MAX_PATH = 32           # waypoints: door + room-center per hop
AVOID_RADIUS = 0.06     # personal space, world units
AVOID_PUSH = 0.35       # max fraction of a step spent dodging


@dataclass
class NavGraph:
    """Rooms as nodes; door/stair/elevator adjacency as edges with
    waypoints.  Waypoint values are (x, y, elevator_id); doors and
    stairs carry elevator_id -1."""

    centers: np.ndarray     # [R, 3] room centers (x, y, floor)
    adj: list               # adjacency lists
    waypoints: dict         # (a, b) -> (x, y, eid) crossing point
    elev_edges: dict = None  # (a, b) -> (x, y, eid) elevator crossings

    def route(self, a: int, b: int) -> list[int]:
        """BFS route (A* reduces to BFS on the unweighted room graph)."""
        if a == b:
            return [a]
        prev = {a: -1}
        q = deque([a])
        while q:
            u = q.popleft()
            for v in self.adj[u]:
                if v not in prev:
                    prev[v] = u
                    if v == b:
                        path = [b]
                        while path[-1] != a:
                            path.append(prev[path[-1]])
                        return path[::-1]
                    q.append(v)
        return [a]

    def expand(self, rooms: list[int],
               use_elevator: bool = False) -> list[tuple]:
        """Room route -> (x, y, floor, elevator_id) waypoints through
        each connecting door (then the next room's center).

        With use_elevator, floor-crossing hops served by an elevator
        shaft emit a BOARDING waypoint at the source floor carrying the
        elevator id (the rider waits there for the car — see
        step_people) followed by the exit at the destination floor; the
        reference's people likewise pick elevator or stairs per trip
        (ai_room_update, building_navigation.cpp:2864+)."""
        wps = []
        ee = self.elev_edges or {}
        for k in range(len(rooms) - 1):
            a, b = rooms[k], rooms[k + 1]
            fa = self.centers[a, 2]
            fb = self.centers[b, 2]
            el = ee.get((a, b)) or ee.get((b, a))
            if use_elevator and el is not None and fa != fb:
                wps.append((el[0], el[1], fa, el[2]))     # board + wait
                wps.append((el[0], el[1], fb, -1))        # exit
            else:
                wp = self.waypoints.get((a, b)) or self.waypoints.get((b, a))
                if wp is None:
                    wp = el       # elevator-only connection
                    if wp is not None and fa != fb:
                        wps.append((wp[0], wp[1], fa, wp[2]))
                        wps.append((wp[0], wp[1], fb, -1))
                        wp = None
                if wp is not None:
                    # cross the door at the SOURCE room's floor, then
                    # step to the destination floor (stairs change floor
                    # mid-crossing)
                    wps.append((wp[0], wp[1], fa if fa == fb else fb, -1))
            wps.append((self.centers[b, 0], self.centers[b, 1], fb, -1))
        if not wps:
            a = rooms[0]
            wps.append((self.centers[a, 0], self.centers[a, 1],
                        self.centers[a, 2], -1))
        return wps


def build_nav_graph(interior) -> NavGraph:
    """Nav graph from a floorplanned Interior: rooms connect via doors
    (the door's z names its floor: floor = round((z - z1) / fh)) and
    stairwells (between floors); each edge stores its crossing point."""
    rooms = interior.rooms
    R = len(rooms)
    centers = np.array([[0.5 * (r.x1 + r.x2), 0.5 * (r.y1 + r.y2), r.floor]
                        for r in rooms], np.float32)
    adj = [[] for _ in range(R)]
    waypoints = {}
    elev_edges = {}

    by_floor = {}
    for i, r in enumerate(rooms):
        by_floor.setdefault(r.floor, []).append(i)

    def room_at(x, y, fl):
        for i in by_floor.get(fl, ()):
            r = rooms[i]
            if r.x1 - 1e-6 <= x <= r.x2 + 1e-6 \
                    and r.y1 - 1e-6 <= y <= r.y2 + 1e-6:
                return i
        return -1

    def connect(a, b, wx, wy, eid=-1):
        if b not in adj[a]:
            adj[a].append(b)
            adj[b].append(a)
        if eid >= 0:
            elev_edges.setdefault((a, b), (wx, wy, eid))
        else:
            waypoints.setdefault((a, b), (wx, wy, eid))

    fh = getattr(interior, "floor_height", 1.0) or 1.0
    z1 = getattr(interior, "z1", 0.0)
    for (dx, dy, dz, dim) in interior.doors:
        fl0 = int(round((dz - z1) / fh))
        eps = 0.05 * fh
        # try the z-derived floor first; interiors built without z1/fh
        # metadata (mall/backrooms floors) fall back to a floor scan
        floors = [fl0] if fl0 in by_floor else sorted(by_floor)
        for fl in floors:
            a = room_at(dx, dy - eps, fl) if dim == 0 else \
                room_at(dx - eps, dy, fl)
            b = room_at(dx, dy + eps, fl) if dim == 0 else \
                room_at(dx + eps, dy, fl)
            if a >= 0 and b >= 0 and a != b:
                connect(a, b, dx, dy)
                break

    # stairs connect the rooms containing them across floors
    for (sx1, sy1, sx2, sy2, fl) in interior.stairs:
        cx = 0.5 * (sx1 + sx2)
        cy = 0.5 * (sy1 + sy2)
        a = room_at(cx, cy, fl)
        b = room_at(cx, cy, fl + 1)
        if a >= 0 and b >= 0:
            connect(a, b, cx, cy)

    # elevator shafts connect the rooms they open into on EVERY pair of
    # consecutive floors (riders chain floors inside the car); edges are
    # tagged with the shaft id so routes board/ride instead of stepping
    # (ai_room_update elevator riding, building_navigation.cpp:2864+)
    for eid, (ex1, ey1, ex2, ey2) in enumerate(
            getattr(interior, "elevators", ()) or ()):
        cx = 0.5 * (ex1 + ex2)
        cy = 0.5 * (ey1 + ey2)
        served = sorted(by_floor)
        for fl in served:
            a = room_at(cx, cy, fl)
            b = room_at(cx, cy, fl + 1)
            if a >= 0 and b >= 0:
                connect(a, b, cx, cy, eid)
    return NavGraph(centers=centers, adj=adj, waypoints=waypoints,
                    elev_edges=elev_edges)


# activity states (ai_room_update's per-person state machine,
# building_navigation.cpp:2864; AI_WAITING/AI_MOVING + the sitting /
# sleeping / elevator sub-states of people_t)
ACT_WALK = 0
ACT_WAIT_ELEVATOR = 1
ACT_RIDE_ELEVATOR = 2
ACT_SIT = 3
ACT_SLEEP = 4


class PeopleState(NamedTuple):
    """Batched walkers following padded waypoint paths."""

    x: torch.Tensor
    y: torch.Tensor
    floor: torch.Tensor
    path_x: torch.Tensor     # [N, MAX_PATH]
    path_y: torch.Tensor
    path_f: torch.Tensor
    path_e: torch.Tensor     # [N, MAX_PATH] int32 elevator id per waypoint (-1)
    path_len: torch.Tensor   # [N] int32
    path_pos: torch.Tensor   # [N] int32 current waypoint index
    speed: torch.Tensor
    activity: torch.Tensor   # [N] int32 ACT_*
    timer: torch.Tensor      # [N] f32 frames left sitting/sleeping
    end_act: torch.Tensor    # [N] int32 activity on arrival (SIT/SLEEP/WALK)
    end_dur: torch.Tensor    # [N] f32 duration of the arrival activity


def make_people(graph: NavGraph, n: int, seed: int = 0,
                device: torch.device | str = "cuda") -> PeopleState:
    rg = RandGen(seed + 5, seed * 3 + 1)
    R = len(graph.centers)
    starts = [rg.rand() % R for _ in range(n)]
    c = lambda k: torch.as_tensor(graph.centers[starts, k].copy(), device=device)
    zf = lambda *sh: torch.zeros(sh, dtype=torch.float32, device=device)
    zi = lambda *sh: torch.zeros(sh, dtype=torch.int32, device=device)
    st = PeopleState(
        x=c(0), y=c(1), floor=c(2),
        path_x=zf(n, MAX_PATH), path_y=zf(n, MAX_PATH), path_f=zf(n, MAX_PATH),
        path_e=torch.full((n, MAX_PATH), -1, dtype=torch.int32, device=device),
        path_len=zi(n), path_pos=zi(n),
        speed=torch.as_tensor(np.asarray([0.002 + 0.002 * rg.randd() for _ in range(n)],
                                         np.float32), device=device),
        activity=zi(n), timer=zf(n), end_act=zi(n), end_dur=zf(n),
    )
    return assign_goals(st, graph, [int(s) for s in starts], rg)


def plan_paths(graph: NavGraph, cur_rooms, rg: RandGen,
               forced_dest: int | None = None, room_objs=None,
               use_elevator_prob: float = 0.5):
    """Host path-planning core shared by assign_goals and the fused
    city step's mirror-based reroute: route each listed person to a
    random (or forced) destination room and return the padded numpy
    path arrays (px, py, pf, pe, plen, end_act, end_dur)."""
    n = len(cur_rooms)
    R = len(graph.centers)
    px = np.zeros((n, MAX_PATH), np.float32)
    py = np.zeros((n, MAX_PATH), np.float32)
    pf = np.zeros((n, MAX_PATH), np.float32)
    pe = np.full((n, MAX_PATH), -1, np.int32)
    plen = np.zeros(n, np.int32)
    eact = np.zeros(n, np.int32)
    edur = np.zeros(n, np.float32)
    sit_kinds = sleep_kinds = None
    if room_objs is not None:
        from . import room_content as RC
        sit_kinds = {RC.F_CHAIR, RC.F_COUCH}
        sleep_kinds = {RC.F_BED, RC.F_HOSPITAL_BED}
    for i, cur in enumerate(cur_rooms):
        dest = forced_dest if forced_dest is not None else rg.rand() % R
        use_el = rg.randd() < use_elevator_prob
        wps = graph.expand(graph.route(cur, dest), use_elevator=use_el)
        wps = wps[:MAX_PATH]
        for k, (wx, wy, wf, we) in enumerate(wps):
            px[i, k], py[i, k], pf[i, k], pe[i, k] = wx, wy, wf, we
        plen[i] = len(wps)
        if room_objs is not None:
            kinds = {int(k) for k, r in zip(room_objs.kinds,
                                            room_objs.rooms)
                     if int(r) == dest}
            if kinds & sleep_kinds and rg.randd() < 0.5:
                eact[i], edur[i] = ACT_SLEEP, 200 + rg.rand() % 200
            elif kinds & sit_kinds and rg.randd() < 0.5:
                eact[i], edur[i] = ACT_SIT, 100 + rg.rand() % 100
    return px, py, pf, pe, plen, eact, edur


def assign_goals(st: PeopleState, graph: NavGraph, cur_rooms, rg: RandGen,
                 forced_dest: int | None = None, room_objs=None,
                 use_elevator_prob: float = 0.5):
    """Host: route each person to a random destination room (the ai state
    machine's choose-destination step), expanded to door waypoints.
    `forced_dest` routes everyone to one room — the ai_target_player /
    zombie mode (building_navigation.cpp:1216-1255).

    Floor-crossing trips pick the elevator with `use_elevator_prob` (the
    reference's stairs-vs-elevator choice).  With `room_objs` (a
    room_content.RoomObjects), arriving in a room with a bed / chair /
    couch queues a SLEEP / SIT activity (ai sitting & lying,
    building_navigation.cpp:2864,3573).  The new paths go to `st`'s
    device."""
    n = len(cur_rooms)
    px, py, pf, pe, plen, eact, edur = plan_paths(
        graph, cur_rooms, rg, forced_dest=forced_dest, room_objs=room_objs,
        use_elevator_prob=use_elevator_prob)
    dev = st.x.device
    t = lambda a: torch.as_tensor(a, device=dev)
    return st._replace(path_x=t(px), path_y=t(py), path_f=t(pf), path_e=t(pe),
                       path_len=t(plen),
                       path_pos=torch.zeros((n,), dtype=torch.int32, device=dev),
                       activity=torch.zeros((n,), dtype=torch.int32, device=dev),
                       timer=torch.zeros((n,), dtype=torch.float32, device=dev),
                       end_act=t(eact), end_dur=t(edur))


def _path_at(a: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """a[i, pos[i]] for [N, MAX_PATH] paths."""
    return torch.gather(a, 1, pos.long()[:, None])[:, 0]


def step_people(st: PeopleState, elev_z: torch.Tensor | None = None) -> PeopleState:
    """Advance every walker toward its current waypoint; waypoint reached
    -> next path entry (ai_room_update movement), with pairwise
    separation so people avoid each other (:2689).

    `elev_z` [E] gives each elevator car's current height in floor
    units.  Boarding waypoints (path_e >= 0) put the person in
    WAIT_ELEVATOR until the car is at their floor, then RIDE — floor
    tracks the car — until the car reaches the exit waypoint's floor.
    Sitting/sleeping people hold position while their timer runs."""
    n = st.x.shape[0]
    dev = st.x.device
    if elev_z is None:
        elev_z = torch.zeros((1,), dtype=torch.float32, device=dev)
    pos_c = torch.clamp(st.path_pos, max=MAX_PATH - 1)
    tx = _path_at(st.path_x, pos_c)
    ty = _path_at(st.path_y, pos_c)
    tf = _path_at(st.path_f, pos_c)
    te = _path_at(st.path_e, pos_c)
    tf_next = _path_at(st.path_f, torch.clamp(pos_c + 1, max=MAX_PATH - 1))  # ride destination
    dx = tx - st.x
    dy = ty - st.y
    d = torch.sqrt(dx * dx + dy * dy) + 1e-9

    act = st.activity
    walking = act == ACT_WALK
    step = torch.where(walking, torch.minimum(st.speed, d), 0.0)
    mx = step * dx / d
    my = step * dy / d

    # separation: same-floor neighbors within AVOID_RADIUS push apart,
    # capped at AVOID_PUSH of the step so door funnels still pass
    ex = st.x[:, None] - st.x[None, :]
    ey = st.y[:, None] - st.y[None, :]
    same = (st.floor[:, None] == st.floor[None, :]) & \
        ~torch.eye(n, dtype=torch.bool, device=dev)
    d2 = ex * ex + ey * ey
    near = same & (d2 < AVOID_RADIUS * AVOID_RADIUS)
    inv = torch.rsqrt(torch.clamp(d2, min=1e-12))
    push = torch.where(near, (AVOID_RADIUS * inv - 1.0), 0.0)
    ax = torch.sum(push * ex, -1)
    ay = torch.sum(push * ey, -1)
    al = torch.sqrt(ax * ax + ay * ay) + 1e-9
    amax = AVOID_PUSH * st.speed * walking.to(torch.float32)
    scale = torch.clamp(amax / al, max=1.0)
    x = st.x + mx + ax * scale
    y = st.y + my + ay * scale

    # elevator car heights seen by each person (ids outside the bank,
    # -1 included, see a car at 0)
    E = elev_z.shape[0]
    has_car = (te >= 0) & (te < E)
    car_z = torch.where(has_car, elev_z[torch.clamp(te, 0, E - 1).long()], 0.0)

    reached = d < 0.01
    at_board = reached & (te >= 0) & (torch.abs(tf_next - st.floor) > 0.5)
    # WALK -> WAIT at a boarding waypoint
    act = torch.where(walking & at_board, ACT_WAIT_ELEVATOR, act)
    # WAIT -> RIDE when the car arrives at this floor
    waiting = act == ACT_WAIT_ELEVATOR
    car_here = torch.abs(car_z - st.floor) < 0.05
    act = torch.where(waiting & car_here, ACT_RIDE_ELEVATOR, act)
    # RIDE: floor tracks the car; arrive when the car hits the exit floor
    riding = act == ACT_RIDE_ELEVATOR
    floor = torch.where(riding, car_z, st.floor)
    arrived = riding & (torch.abs(car_z - tf_next) < 0.02)
    floor = torch.where(arrived, tf_next, floor)
    act = torch.where(arrived, ACT_WALK, act)
    # ordinary waypoint floor switch (stairs/doors)
    floor = torch.where(walking & (d < 0.02) & (te < 0), tf, floor)

    advance = (walking & reached & (te < 0)) | arrived
    pos = torch.where(advance & (st.path_pos < st.path_len - 1),
                      st.path_pos + 1, st.path_pos)

    # path complete -> queued sit/sleep activity with its timer
    done = walking & reached & (st.path_pos >= st.path_len - 1)
    start_rest = done & (st.end_act > 0)
    act = torch.where(start_rest, st.end_act, act)
    timer = torch.where(start_rest, st.end_dur, st.timer)
    resting = (act == ACT_SIT) | (act == ACT_SLEEP)
    timer = torch.where(resting, torch.clamp(timer - 1.0, min=0.0), timer)
    act = torch.where(resting & (timer <= 0.0), ACT_WALK, act)
    end_act = torch.where(start_rest, 0, st.end_act)

    return st._replace(x=x, y=y, floor=floor, path_pos=pos,
                       activity=act, timer=timer, end_act=end_act)


def _host(a: torch.Tensor) -> np.ndarray:
    return a.detach().cpu().numpy()


def people_need_goals(st: PeopleState) -> np.ndarray:
    """Host check: who finished their path AND isn't resting or riding
    (triggers re-routing).  'Finished' requires ARRIVAL at the final
    waypoint, not merely walking toward it — rerouting at path_pos ==
    path_len-1 would preempt the device-side rest transition (start_rest
    in step_people) every time, so queued SIT/SLEEP would never start."""
    pos = _host(st.path_pos)
    plen = _host(st.path_len)
    last = np.maximum(plen - 1, 0)
    wx = np.take_along_axis(_host(st.path_x), last[:, None], 1)[:, 0]
    wy = np.take_along_axis(_host(st.path_y), last[:, None], 1)[:, 0]
    dx = _host(st.x) - wx
    dy = _host(st.y) - wy
    arrived = (pos >= plen - 1) & (dx * dx + dy * dy < 1e-4)
    idle = _host(st.activity) == ACT_WALK
    return arrived & idle


def elevator_calls(st: PeopleState, num_elevators: int) -> list:
    """Host: per-shaft floor requests from waiting/riding people — the
    call-button presses (nearest-waiter floor first) and the riders'
    destination floors."""
    act = _host(st.activity)
    floors = _host(st.floor)
    pe = _host(st.path_e)
    pf = _host(st.path_f)
    pos = np.minimum(_host(st.path_pos), MAX_PATH - 1)
    calls = [[] for _ in range(num_elevators)]
    for i in range(len(act)):
        eid = int(pe[i, pos[i]])
        if eid < 0 or eid >= num_elevators:
            continue
        if act[i] == ACT_WAIT_ELEVATOR:
            calls[eid].append(int(round(floors[i])))
        elif act[i] == ACT_RIDE_ELEVATOR:
            nxt = min(pos[i] + 1, MAX_PATH - 1)
            calls[eid].append(int(round(pf[i, nxt])))
    return calls


class BuildingPeopleSim:
    """Host loop: people + elevator cars for one building (the
    per-building slice of ai_room_update / elevator_t updates).  The
    people live on `device`; the elevator cars and the goal choice stay
    on the host, which reads the people back every step."""

    def __init__(self, interior, n_people: int, seed: int = 0,
                 room_objs=None, device: torch.device | str = "cuda"):
        from .floorplan import ElevatorCar
        self.device = torch.device(device)
        self.graph = build_nav_graph(interior)
        self.room_objs = room_objs
        self.rg = RandGen(seed + 17, seed * 5 + 3)
        self.people = make_people(self.graph, n_people, seed=seed, device=device)
        self.cars = [ElevatorCar()
                     for _ in (getattr(interior, "elevators", ()) or ())]

    def step(self):
        for car in self.cars:
            car.step()
        calls = elevator_calls(self.people, max(len(self.cars), 1))
        for eid, car in enumerate(self.cars):
            if calls[eid] and car.state == 0:
                want = calls[eid][0]
                if want != round(car.z):
                    car.call(want)
        elev_z = torch.as_tensor(np.asarray([c.z for c in self.cars] or [0.0], np.float32),
                                 device=self.device)
        self.people = step_people(self.people, elev_z)
        need = people_need_goals(self.people)
        if need.any():
            # re-route finished walkers from their current room
            idx = np.where(need)[0]
            cx = _host(self.people.x)
            cy = _host(self.people.y)
            cf = _host(self.people.floor)
            cur = [self._room_at(cx[i], cy[i], cf[i]) for i in idx]
            sub = assign_goals(
                _take(self.people, idx), self.graph, cur, self.rg,
                room_objs=self.room_objs)
            self.people = _put(self.people, idx, sub)
        return self.people

    def _room_at(self, x, y, fl):
        c = self.graph.centers
        d = (c[:, 0] - x) ** 2 + (c[:, 1] - y) ** 2 \
            + 1e6 * (c[:, 2] - round(float(fl))) ** 2
        return int(np.argmin(d))


def _take(st: PeopleState, idx) -> PeopleState:
    i = torch.as_tensor(np.asarray(idx), dtype=torch.int64, device=st.x.device)
    return PeopleState(*(f[i] for f in st))


def _put(st: PeopleState, idx, sub: PeopleState) -> PeopleState:
    i = torch.as_tensor(np.asarray(idx), dtype=torch.int64, device=st.x.device)
    out = []
    for f, g in zip(st, sub):
        a = f.clone()
        a[i] = g.to(a.dtype)
        out.append(a)
    return PeopleState(*out)


def person_name(person_id: int) -> str:
    """Display name for a person, seeded by their id like the
    reference's ssn-seeded person_name_gen (pedestrians.cpp:130-151);
    gender alternates by id as the reference's person gen rolls it."""
    from ..utils.names import gen_person_name
    return gen_person_name(int(person_id), bool(person_id & 1))

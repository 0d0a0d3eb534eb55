"""Fused live city frame (port of `3dworld_tpu/city/city_step.py`).

The reference's city frame runs cars / pedestrians / building-AI across
3 OMP threads (display_world.cpp:1295-1309, next_city_frame
city_gen.cpp:3801).  Here:

* the elevator cars are a device SoA bank (`ElevatorBank`) with the
  same 4-state door/move machine as `floorplan.ElevatorCar`;
* call-button presses are computed on the device from the people state
  (`elevator_calls_device`);
* `city_frames_chained` runs K whole city frames (stoplights -> cars ->
  peds -> helis -> birds -> trains -> elevators -> building people) as a
  Python loop that never reads a device value back, so the host queues a
  chunk without waiting (the JAX package scans them in one program);
* goal re-routing (irregular BFS, `people.plan_paths`) stays on the host
  and runs once per chunk (`MergedBuildingPeople.reroute`), from one
  packed fetch (`people_probe`).

A frame runs in the spans `city.cars` (stoplights and cars), `city.peds`
and `city.people` (elevator calls, the elevator bank, building people),
each with CUDA events on a card.  On a card a chunk goes through
`FRAMES`, the city's `GraphCache`: some 650 small launches a frame would
otherwise pace it from the host.

The JAX frame splits a threefry key five ways each frame; here the draws
are inputs, a `CityDraws` of [K, ...] tensors per chunk, so every device
sees the same values (the app draws them from seeded CPU generators,
`app.TiledDraws`).  The JAX one-hot reads are gathers, and nothing adds
floats atomically, so a chunk gives the same bits on every run of one
device.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from ..ops.cuda import graphs as CG
from . import traffic as CT
from . import people as CPE
from .floorplan import ElevatorCar

# single source of truth: the device bank replays ElevatorCar exactly
DOOR_TICKS = ElevatorCar.DOOR_TICKS
ELEV_SPEED = ElevatorCar.SPEED


class ElevatorBank(NamedTuple):
    """All elevator cars of all simulated buildings as one SoA batch
    (device twin of a list of `floorplan.ElevatorCar`)."""

    z: torch.Tensor        # [E] f32 car height in floor units
    target: torch.Tensor   # [E] f32 destination floor
    state: torch.Tensor    # [E] i32 0 idle(open) 1 closing 2 moving 3 opening
    timer: torch.Tensor    # [E] i32 door timer


def make_elevator_bank(num_cars: int, device: torch.device | str = "cuda") -> ElevatorBank:
    e = max(num_cars, 1)
    zf = torch.zeros((e,), dtype=torch.float32, device=device)
    zi = torch.zeros((e,), dtype=torch.int32, device=device)
    return ElevatorBank(z=zf, target=zf.clone(), state=zi, timer=zi.clone())


def _people_current_wp(st: CPE.PeopleState):
    """Current waypoint's elevator id + the NEXT waypoint's floor for
    every person (the ride destination)."""
    pos_c = torch.clamp(st.path_pos, max=CPE.MAX_PATH - 1)
    te = CPE._path_at(st.path_e, pos_c)
    tf_next = CPE._path_at(st.path_f, torch.clamp(pos_c + 1, max=CPE.MAX_PATH - 1))
    return te, tf_next


def elevator_calls_device(st: CPE.PeopleState, num_cars: int):
    """Per-shaft call floor from waiting/riding people.  Selection =
    lowest person index with a request.  Returns (call_floor[E],
    has_call[E])."""
    te, tf_next = _people_current_wp(st)
    waiting = st.activity == CPE.ACT_WAIT_ELEVATOR
    riding = st.activity == CPE.ACT_RIDE_ELEVATOR
    req_floor = torch.where(waiting, torch.round(st.floor), tf_next)
    has_req = (waiting | riding) & (te >= 0)
    n = st.x.shape[0]
    e = max(num_cars, 1)
    dev = st.x.device
    m = has_req[:, None] & (te[:, None] == torch.arange(e, dtype=torch.int32, device=dev)[None, :])
    idx = torch.arange(n, dtype=torch.int32, device=dev)[:, None]
    sel = torch.argmin(torch.where(m, idx, n), dim=0)           # [E]
    return req_floor[sel], torch.any(m, dim=0)


def step_elevator_bank(bank: ElevatorBank, call_floor: torch.Tensor,
                       has_call: torch.Tensor) -> ElevatorBank:
    """One tick of every car: door close -> move -> door open -> idle,
    accepting a new call only while idle with doors open (the
    `ElevatorCar.call` + `.step` machine, batched)."""
    idle = bank.state == 0

    # accept calls (idle cars only; ignore a call to the current floor);
    # the accepting car starts closing THIS tick, as ElevatorCar.call
    # followed by .step in the same frame
    want = torch.round(call_floor)
    accept = idle & has_call & (want != torch.round(bank.z))
    target = torch.where(accept, want, bank.target)
    state = torch.where(accept, 1, bank.state)
    timer = torch.where(accept, DOOR_TICKS, bank.timer)

    closing = state == 1
    moving = state == 2
    opening = state == 3

    # doors closing
    timer = torch.where(closing, timer - 1, timer)
    state = torch.where(closing & (timer <= 0), 2, state)

    # moving (1e-4 slack: f32 accumulation of 0.05-steps can leave the
    # remaining distance one ulp above SPEED on the arrival tick)
    d = target - bank.z
    arrive = moving & (torch.abs(d) <= ELEV_SPEED + 1e-4)
    z = torch.where(moving, torch.where(arrive, target, bank.z + torch.sign(d) * ELEV_SPEED),
                    bank.z)
    state = torch.where(arrive, 3, state)
    timer = torch.where(arrive, DOOR_TICKS, timer)

    # doors opening
    timer = torch.where(opening, timer - 1, timer)
    state = torch.where(opening & (timer <= 0), 0, state)
    return ElevatorBank(z=z, target=target, state=state, timer=timer)


class CityState(NamedTuple):
    """Everything the fused city frame advances on the device (the JAX
    state's threefry key is `CityDraws` here)."""

    stoplights: CT.StoplightSet
    cars: CT.CarState
    peds: CT.PedState
    people: CPE.PeopleState | None
    elev: ElevatorBank
    helis: CT.HeliState | None
    birds: CT.BirdState | None
    trains: CT.TrainState | None = None


class CityDraws(NamedTuple):
    """A chunk's draws, [K, ...] per frame: the pedestrians'
    (`traffic.PedDraws` fields), the helicopters' new pads and waits and
    the birds' new perches and waits (None without helicopters or
    birds)."""

    ped_u: torch.Tensor        # [K, N] uniform [0, 1)
    ped_side: torch.Tensor     # [K, N] int32 in [0, 4)
    ped_u3: torch.Tensor       # [K, N] uniform [0, 1)
    ped_u4: torch.Tensor       # [K, N] uniform [0, 1)
    heli_pad: torch.Tensor | None = None     # [K, H] int32 in [0, P)
    heli_wait: torch.Tensor | None = None    # [K, H] int32 in [30, 120)
    bird_perch: torch.Tensor | None = None   # [K, B] int32 in [0, perches)
    bird_wait: torch.Tensor | None = None    # [K, B] int32 in [60, 400)


def draw_city(frames: int, n_peds: int, n_helis: int, n_pads: int,
              n_birds: int, n_perches: int, generator: torch.Generator,
              device: torch.device | str = "cuda") -> CityDraws:
    """A chunk's `CityDraws` from a CPU generator, copied to `device`."""
    g = generator
    u = lambda n: torch.rand((frames, n), generator=g, dtype=torch.float32)
    ri = lambda lo, hi, n: torch.randint(lo, hi, (frames, n), generator=g,
                                         dtype=torch.int32)
    d = CityDraws(ped_u=u(n_peds), ped_side=ri(0, 4, n_peds), ped_u3=u(n_peds),
                  ped_u4=u(n_peds),
                  heli_pad=ri(0, max(n_pads, 1), n_helis) if n_helis else None,
                  heli_wait=ri(30, 120, n_helis) if n_helis else None,
                  bird_perch=ri(0, max(n_perches, 1), n_birds) if n_birds else None,
                  bird_wait=ri(60, 400, n_birds) if n_birds else None)
    return CityDraws(*(None if v is None else v.to(device) for v in d))


PARTS = CityState._fields


def frame_phases(parts, graph, nav, pads, perches, frames: int, rail=None,
                 exchange=None) -> list:
    """`frames` chained city frames as `ops/cuda/graphs` phases over a
    dict of the state's `parts` (of `PARTS`, those not None) and the
    chunk's `draws`.  A frame's phases: the stoplights and cars
    (`city.cars`), the pedestrians (`city.peds`), the helicopters, birds
    and trains, and the elevator calls, bank and building people
    (`city.people`), each where its parts are."""

    def cars(b, k):
        b["peers"] = (None, None) if exchange is None else exchange(b["cars"], b["peds"])
        b["stoplights"] = CT.step_stoplights(b["stoplights"])
        b["cars"] = CT.step_cars(b["cars"], graph, stoplights=b["stoplights"],
                                 peers=b["peers"][0])

    def peds(b, k):
        d = b["draws"]
        b["peds"] = CT.step_peds(b["peds"], CT.PedDraws(d.ped_u[k], d.ped_side[k],
                                                        d.ped_u3[k], d.ped_u4[k]),
                                 nav=nav, stoplights=b["stoplights"], peers=b["peers"][1])

    def movers(b, k):
        d = b["draws"]
        if "helis" in b:
            b["helis"] = CT.step_helis(b["helis"], pads, d.heli_pad[k], d.heli_wait[k])
        if "birds" in b:
            b["birds"] = CT.step_birds(b["birds"], perches, d.bird_perch[k], d.bird_wait[k])
        if "trains" in b:
            b["trains"] = CT.step_trains(b["trains"], rail)

    def people(b, k):
        call_floor, has_call = elevator_calls_device(b["people"], b["elev"].z.shape[0])
        b["elev"] = step_elevator_bank(b["elev"], call_floor, has_call)
        b["people"] = CPE.step_people(b["people"], b["elev"].z)

    parts = set(parts) - ({"trains"} if rail is None else set())
    frame = [("city.cars", cars), ("city.peds", peds)]
    frame += [(None, movers)] if parts & {"helis", "birds", "trains"} else []
    frame += [("city.people", people)] if "people" in parts else []
    return [(name, functools.partial(fn, k=k)) for k in range(frames) for name, fn in frame]


def frame_key(b: dict, frames: int, graph, nav, pads, perches, rail,
              exchange=None) -> tuple | None:
    """Everything a capture of the chained frames bakes in, hashable: the
    device, the frame count, each part's shapes and dtypes, and the layout
    by identity and by its tensors' `_version`s; None off a card or with
    an `exchange` (a rank's slab), which never capture."""
    dev = b["peds"].x.device
    if dev.type != "cuda" or exchange is not None:
        return None
    shapes = tuple((k, tuple(None if t is None else (tuple(t.shape), t.dtype) for t in v))
                   for k, v in b.items())
    return (dev, frames, shapes) + tuple(CG.tensors_key(x) for x in
                                         (graph, nav, pads, perches, rail))


def city_frames_chained(cs: CityState, graph: CT.RoadGraph, nav: CT.PedNav,
                        pads, perches, frames: int, draws: CityDraws,
                        rail=None, exchange=None) -> CityState:
    """K city frames — traffic, crowds, building people, elevator cars,
    helicopters, birds, trains — queued without a host sync; frame k
    reads row k of `draws`.  On a card a chunk whose key (`frame_key`)
    repeats replays from `FRAMES` as one CUDA graph a phase
    (`frame_phases`), bit for bit the eager frames.

    With `exchange`, `cs.cars` and `cs.peds` (and the pedestrian columns
    of `draws`) are one rank's slab: `exchange(cars, peds)` returns the
    whole previous populations as (`traffic.CarPeers`, `PedPeers`) each
    frame (`parallel/city.make_sharded_city_frames`); such frames run
    eager."""
    b = {k: v for k, v in zip(PARTS, cs) if v is not None}
    names = tuple(b)
    b["draws"] = draws
    phases = frame_phases(names, graph, nav, pads, perches, frames, rail=rail,
                          exchange=exchange)
    out = FRAMES.run(frame_key(b, frames, graph, nav, pads, perches, rail, exchange),
                     phases, b, names, refs=(graph, nav, pads, perches, rail))
    return cs._replace(**dict(zip(names, out)))


FRAMES = CG.GraphCache("city")


def city_frame_single(cs: CityState, graph, nav, pads, perches, draws: CityDraws,
                      rail=None) -> CityState:
    """One un-chained frame (host-stepping debug path): row 0 of
    `draws`."""
    return city_frames_chained(cs, graph, nav, pads, perches, 1, draws, rail=rail)


def people_probe(st: CPE.PeopleState) -> torch.Tensor:
    """ONE packed [N, 5] float32 tensor (x, y, floor, path_pos, activity):
    the only device->host transfer the per-chunk host phase needs."""
    return torch.stack([st.x, st.y, st.floor, st.path_pos.to(torch.float32),
                        st.activity.to(torch.float32)], dim=-1)


def apply_reroute(st: CPE.PeopleState, mask, px, py, pf, pe, plen,
                  eact, edur) -> CPE.PeopleState:
    """Merge host-planned paths into the device state for masked
    people (uploads only; no device fetches)."""
    m = mask[:, None]
    return st._replace(
        path_x=torch.where(m, px, st.path_x),
        path_y=torch.where(m, py, st.path_y),
        path_f=torch.where(m, pf, st.path_f),
        path_e=torch.where(m, pe, st.path_e),
        path_len=torch.where(mask, plen, st.path_len),
        path_pos=torch.where(mask, 0, st.path_pos),
        activity=torch.where(mask, 0, st.activity),
        timer=torch.where(mask, 0.0, st.timer),
        end_act=torch.where(mask, eact, st.end_act),
        end_dur=torch.where(mask, edur, st.end_dur))


class MergedBuildingPeople:
    """People of SEVERAL buildings merged into one device batch.

    Each building keeps its own nav graph and room objects; elevator ids
    are offset so every shaft across all buildings maps to one slot of a
    shared `ElevatorBank`.  The per-frame movement of everyone runs in
    the fused device step; this class owns the low-frequency host phase
    (goal re-routing) and a HOST MIRROR of the path arrays — paths are
    host-written/device-read, so rerouting never fetches them back
    (vect_building_t::ai_room_update, building_navigation.cpp:3573)."""

    def __init__(self, builders, seed: int = 0,
                 device: torch.device | str = "cuda"):
        """builders: [(interior, n_people, room_objs), ...]."""
        from ..utils.rng import RandGen
        self.device = device
        self.entries = []       # (graph, room_objs, lo, hi)
        self.rg = RandGen(seed + 17, seed * 5 + 3)
        states = []
        ebase = 0
        lo = 0
        for (interior, n_people, room_objs) in builders:
            g = CPE.build_nav_graph(interior)
            ne = len(getattr(interior, "elevators", ()) or ())
            if ebase and g.elev_edges:
                g.elev_edges = {k: (x, y, eid + ebase)
                                for k, (x, y, eid) in g.elev_edges.items()}
            states.append(CPE.make_people(g, n_people, seed=seed + lo, device="cpu"))
            self.entries.append((g, room_objs, lo, lo + n_people))
            lo += n_people
            ebase += ne
        self.num_elevators = max(ebase, 1)
        self.counts = {"rerouted": 0}
        # what the last reroute uploaded, as host arrays (need, px, py, pf,
        # pe, plen, end_act, end_dur); None where it rerouted nobody
        self.applied = None
        merged = CPE.PeopleState(*(torch.cat(list(f), dim=0) for f in zip(*states)))
        # host mirror of the host-owned path arrays
        self.m_px, self.m_py, self.m_pf, self.m_pe, self.m_plen = (
            getattr(merged, f).numpy().copy()
            for f in ("path_x", "path_y", "path_f", "path_e", "path_len"))
        self.people = CPE.PeopleState(*(v.to(device) for v in merged))
        self.elev = make_elevator_bank(self.num_elevators, device=device)

    def reroute(self, people: CPE.PeopleState,
                probe: np.ndarray | None = None) -> CPE.PeopleState:
        """Host phase per chunk: new goals for every finished walker,
        routed within their own building's graph.  `probe` is the
        fetched people_probe array (fetched here if not given)."""
        if probe is None:
            probe = people_probe(people).cpu().numpy()
        self.applied = None
        x, y, fl = probe[:, 0], probe[:, 1], probe[:, 2]
        pos = probe[:, 3].astype(np.int32)
        act = probe[:, 4].astype(np.int32)
        last = np.maximum(self.m_plen - 1, 0)
        wx = np.take_along_axis(self.m_px, last[:, None], 1)[:, 0]
        wy = np.take_along_axis(self.m_py, last[:, None], 1)[:, 0]
        dx = x - wx
        dy = y - wy
        need = (pos >= self.m_plen - 1) & (dx * dx + dy * dy < 1e-4) \
            & (act == CPE.ACT_WALK)
        if not need.any():
            return people
        n = len(need)
        eact_full = np.zeros(n, np.int32)
        edur_full = np.zeros(n, np.float32)
        for (g, room_objs, lo, hi) in self.entries:
            idx = np.where(need[lo:hi])[0] + lo
            if not len(idx):
                continue
            centers = g.centers
            cur = []
            for i in idx:
                d = (centers[:, 0] - x[i]) ** 2 \
                    + (centers[:, 1] - y[i]) ** 2 \
                    + 1e6 * (centers[:, 2] - round(float(fl[i]))) ** 2
                cur.append(int(np.argmin(d)))
            px, py, pf, pe, plen, eact, edur = CPE.plan_paths(
                g, cur, self.rg, room_objs=room_objs)
            self.m_px[idx] = px
            self.m_py[idx] = py
            self.m_pf[idx] = pf
            self.m_pe[idx] = pe
            self.m_plen[idx] = plen
            eact_full[idx] = eact
            edur_full[idx] = edur
        self.counts["rerouted"] += int(need.sum())
        self.applied = (need.copy(), self.m_px.copy(), self.m_py.copy(), self.m_pf.copy(),
                        self.m_pe.copy(), self.m_plen.copy(), eact_full, edur_full)
        # one masked device update from the full mirrors (uploads only)
        dev = people.x.device
        t = lambda a: torch.as_tensor(a, device=dev)
        return apply_reroute(people, t(need), t(self.m_px), t(self.m_py),
                             t(self.m_pf), t(self.m_pe), t(self.m_plen),
                             t(eact_full), t(edur_full))

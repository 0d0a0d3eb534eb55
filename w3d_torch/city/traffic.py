"""City traffic: cars on the road graph + pedestrian crowds (port of
`3dworld_tpu/city/traffic.py`).

The reference simulates config-driven cars with path following,
intersections/stoplights and parked cars (`car_manager_t`, cars.cpp:1855)
and a pedestrian crowd with plot navigation + collision avoidance
(`ped_manager_t`, pedestrians.cpp:2550), dispatched across 3 OMP threads
per frame (`next_city_frame`, city_gen.cpp:3801).

Cars and pedestrians are SoA populations advanced by elementwise state
machines; road topology is padded arrays (per segment-end: up to 4
candidate next segments); car headway and pedestrian separation use dense
masked pair math (on the card the separation is one CUDA kernel,
`ops/cuda/separation_kernel`).  The JAX package reads per-agent table rows
with one-hot products (`oh @ table`, `einsum("cs,se,ce->c", ...)`), a TPU
layout workaround; here they are indexed gathers, which give the same
values (a one-hot product of finite float32 values is exact).  No step
scatters or adds floats atomically, so a step gives the same bits on
every run of one device.

The threefry draws of the JAX steps are inputs here: `step_peds` takes
`PedDraws`, `step_helis` and `step_birds` their new targets and waits
(`city/city_step.CityDraws` carries them per frame).  The build functions take
`device` (the card unless the caller asks for the CPU).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from ..ops.cuda import separation_kernel as SEP
from ..utils import rng as w3d_rng
from ..utils.rng import RandGen
from .roads import RoadNetwork

STOPLIGHT_PERIOD = 120.0  # frames per light phase (legacy global clock)

# stoplight_t 6-state machine (city.h:365-370):
# {EGL, EGWG, WGL, NGL, NGSG, SGL}; E/W/N/S = travel direction,
# G = straight|right green, L = left-arrow green
ST_TIMES = (5.0, 6.0, 5.0, 5.0, 6.0, 5.0)       # seconds (city.h:368)
ST_R_MASKS = (2, 3, 1, 8, 12, 4)                # straight/right (city.h:369)
LEFT_MASKS = (2, 0, 1, 8, 0, 4)                 # left turns (city.h:370)
TICKS_PER_SECOND = 40.0                          # frame clock
YELLOW_SECS = 2.0                                # roads.cpp:292
TURN_NONE, TURN_LEFT, TURN_RIGHT = 0, 1, 2
# 3-way intersections skip states involving the missing direction
# (advance_state, roads.cpp:205-224); conn bitmask {-x=1,+x=2,-y=4,+y=8}
_ALLOW_BY_CONN = {7: (0, 1, 1, 1, 0, 0),    # no +y
                  11: (1, 1, 0, 0, 0, 1),   # no -y
                  13: (1, 0, 0, 1, 1, 0),   # no +x
                  14: (0, 0, 1, 0, 1, 1),   # no -x
                  15: (1, 1, 1, 1, 1, 1)}   # 4-way: all valid


def _t(a, device, dtype=None) -> torch.Tensor:
    """A host array as a tensor of its own on `device`."""
    return torch.as_tensor(np.array(a, copy=True), dtype=dtype, device=device)


def _rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table[idx] for int32/int64 indices."""
    return table[idx.long()]


class StoplightSet(NamedTuple):
    """Batched per-intersection stoplight machines (stoplight_ns)."""

    state: torch.Tensor       # [I] int32 current state (0..5)
    ticks: torch.Tensor       # [I] f32 frames in state
    next_state: torch.Tensor  # [I, 6] int32 precomputed valid-successor table
    state_time: torch.Tensor  # [I, 6] f32 per-state duration in frames
    num_conn: torch.Tensor    # [I] int32


def build_stoplights(net: RoadNetwork, seed: int = 0,
                     device: torch.device | str = "cuda") -> StoplightSet:
    """Per-isec machines; 3-way isecs get successor tables that skip the
    missing direction's states; durations follow state_times
    (get_cur_state_time_secs, city.h:397)."""
    isecs = net.isecs
    I = max(len(isecs), 1)
    nxt = np.zeros((I, 6), np.int32)
    times = np.zeros((I, 6), np.float32)
    nconn = np.full(I, 4, np.int32)
    rg = RandGen(seed + 17, 3 * seed + 5)
    state0 = np.zeros(I, np.int32)
    ticks0 = np.zeros(I, np.float32)
    eps = 1e-4
    for i, it in enumerate(isecs):
        conn = 0
        for si in it.roads:
            s = net.segs[si]
            if s.dim == 0:
                if s.x1 < it.x - eps:
                    conn |= 1    # road extends -x
                if s.x2 > it.x + eps:
                    conn |= 2
            else:
                if s.y1 < it.y - eps:
                    conn |= 4
                if s.y2 > it.y + eps:
                    conn |= 8
        allow = _ALLOW_BY_CONN.get(conn, _ALLOW_BY_CONN[15])
        nconn[i] = bin(conn).count("1")
        for st in range(6):
            n = (st + 1) % 6
            for _ in range(6):
                if allow[n]:
                    break
                n = (n + 1) % 6
            nxt[i, st] = n
        times[i] = np.asarray(ST_TIMES, np.float32) * TICKS_PER_SECOND
        state0[i] = nxt[i, rg.rand() % 6]
        ticks0[i] = (rg.randd()) * times[i, state0[i]]
    return StoplightSet(state=_t(state0, device), ticks=_t(ticks0, device),
                        next_state=_t(nxt, device), state_time=_t(times, device),
                        num_conn=_t(nconn, device))


def step_stoplights(sl: StoplightSet) -> StoplightSet:
    """stoplight_t::next_frame + run_update_logic: advance when the
    state's time elapses (the waiting-car skip heuristic is omitted —
    it's a latency optimization, not a semantic)."""
    ticks = sl.ticks + 1.0
    st = sl.state.long()[:, None]
    cur_time = torch.gather(sl.state_time, 1, st)[:, 0]
    adv = ticks > cur_time
    nxt = torch.gather(sl.next_state, 1, st)[:, 0]
    return sl._replace(state=torch.where(adv, nxt, sl.state),
                       ticks=torch.where(adv, 0.0, ticks))


@functools.lru_cache(maxsize=None)
def _mask_tables(device: torch.device):
    """The per-state green masks on `device`, made once (a copy to the
    card waits for it, so the frames never make one)."""
    return (torch.tensor(ST_R_MASKS, dtype=torch.int32, device=device),
            torch.tensor(LEFT_MASKS, dtype=torch.int32, device=device))


def light_masks(sl: StoplightSet):
    """[I] straight/right + left green orient masks for each isec's
    current state (red_light, roads.cpp:277-284)."""
    sr, lf = _mask_tables(sl.state.device)
    return _rows(sr, sl.state), _rows(lf, sl.state)


def red_for(sl: StoplightSet, isec: torch.Tensor, orient: torch.Tensor,
            turn_left: torch.Tensor) -> torch.Tensor:
    """Per-car red-light test: orient = 2*dim + dir ({W,E,S,N} bit);
    2-way isecs never stop traffic (roads.cpp:279)."""
    ic = torch.clamp(isec, min=0)
    sr, lf = light_masks(sl)
    mask = torch.where(turn_left, _rows(lf, ic), _rows(sr, ic))
    nconn = _rows(sl.num_conn, ic)
    red = (mask & torch.bitwise_left_shift(torch.ones_like(orient), orient)) == 0
    return torch.where((isec < 0) | (nconn <= 2), False, red)


def can_cross(sl: StoplightSet, isec: torch.Tensor, road_dim: torch.Tensor):
    """Crosswalk gate (stoplight_t::can_walk): crossing a dim-d road is
    allowed while that road's straight traffic has red both ways."""
    sr, _ = light_masks(sl)
    mask = _rows(sr, torch.clamp(isec, min=0))
    dim_bits = torch.where(road_dim == 0, 1 | 2, 4 | 8)
    return torch.where(isec < 0, True, (mask & dim_bits) == 0)


class RoadGraph(NamedTuple):
    """Padded device-side road topology."""

    x1: torch.Tensor
    y1: torch.Tensor
    x2: torch.Tensor
    y2: torch.Tensor
    length: torch.Tensor
    dim: torch.Tensor           # 0 x-aligned, 1 y-aligned
    # next-segment candidates per (segment, end): [S, 2, K]
    next_seg: torch.Tensor
    next_end: torch.Tensor      # which end of the next segment we enter at
    num_next: torch.Tensor      # [S, 2]
    isec_id: torch.Tensor       # [S, 2] intersection id at each end (-1 none)
    has_light: torch.Tensor     # [S, 2] bool


def build_road_graph(net: RoadNetwork, k: int = 4,
                     device: torch.device | str = "cuda") -> RoadGraph:
    segs = net.segs
    S = max(len(segs), 1)
    x1 = np.zeros(S, np.float32)
    y1 = np.zeros(S, np.float32)
    x2 = np.zeros(S, np.float32)
    y2 = np.zeros(S, np.float32)
    dim = np.zeros(S, np.int32)
    for i, s in enumerate(segs):
        x1[i], y1[i], x2[i], y2[i], dim[i] = s.x1, s.y1, s.x2, s.y2, s.dim
    length = np.maximum(np.hypot(x2 - x1, y2 - y1), 1e-6).astype(np.float32)

    # endpoints -> connectivity
    ends = {}
    for i, s in enumerate(segs):
        for e, (ex, ey) in enumerate(((s.x1, s.y1), (s.x2, s.y2))):
            ends.setdefault((round(ex, 4), round(ey, 4)), []).append((i, e))
    next_seg = -np.ones((S, 2, k), np.int32)
    next_end = np.zeros((S, 2, k), np.int32)
    num_next = np.zeros((S, 2), np.int32)
    isec_id = -np.ones((S, 2), np.int32)
    has_light = np.zeros((S, 2), bool)
    isec_pos = {(round(it.x, 4), round(it.y, 4)): (j, it.has_stoplight)
                for j, it in enumerate(net.isecs)}
    for key, lst in ends.items():
        for (i, e) in lst:
            cands = [(j, je) for (j, je) in lst if j != i][:k]
            num_next[i, e] = len(cands)
            for c, (j, je) in enumerate(cands):
                next_seg[i, e, c] = j
                next_end[i, e, c] = je
            if key in isec_pos:
                isec_id[i, e], has_light[i, e] = isec_pos[key]
    J = lambda a: _t(a, device)
    return RoadGraph(x1=J(x1), y1=J(y1), x2=J(x2), y2=J(y2), length=J(length),
                     dim=J(dim), next_seg=J(next_seg), next_end=J(next_end),
                     num_next=J(num_next), isec_id=J(isec_id),
                     has_light=J(has_light))


class CarState(NamedTuple):
    seg: torch.Tensor       # [C] int32 current segment
    end: torch.Tensor       # [C] int32 destination end (0 = toward (x1,y1), 1 = toward (x2,y2))
    t: torch.Tensor         # [C] param in [0,1] measured toward `end`
    speed: torch.Tensor     # [C]
    frame: torch.Tensor     # int32 scalar
    # parked-car pool (car_manager_t parked cars, cars.cpp): each car owns
    # a parking spot; parked cars sit in it until their timer unparks them
    parked: torch.Tensor    # [C] bool
    spot_x: torch.Tensor    # [C] owned spot position
    spot_y: torch.Tensor
    timer: torch.Tensor     # [C] int32 frames until state flip (park <-> drive)


def gen_parking_spots(blocks, per_block: int = 4, inset: float = 0.6):
    """Parking spots in rows along each block's -y edge
    (parking_lot_t/driveways; cars.cpp parked-car placement)."""
    spots = []
    for (x1, y1, x2, y2, *_c) in blocks:
        w = max(x2 - x1 - 2 * inset, 0.0)
        for i in range(per_block):
            spots.append((x1 + inset + (i + 0.5) * w / per_block,
                          y1 + inset))
    return np.asarray(spots, np.float32).reshape(-1, 2)


def make_cars(n: int, graph: RoadGraph, seed: int = 0,
              spots: np.ndarray | None = None,
              parked_frac: float = 0.0) -> CarState:
    """Cars hashed from their index (`xxhash_u32`), on the graph's device."""
    dev = graph.x1.device
    h = w3d_rng.xxhash_u32(torch.arange(n, dtype=torch.int64), seed=seed)
    S = graph.x1.shape[0]
    if spots is None or len(spots) == 0:
        spots = np.zeros((1, 2), np.float32)
    sp = np.asarray(spots, np.float32)[np.arange(n) % len(spots)]
    # (h >> sh) rounded to float32 first, then taken mod m, as the JAX
    # package does (h >> 4 has 28 bits, so the rounding shows)
    b = lambda sh, m: (h >> sh).to(torch.float32) % m
    parked = b(12, 256) / 256.0 < parked_frac
    cars = CarState(
        seg=(h % S).to(torch.int32),
        end=((h >> 8) % 2).to(torch.int32),
        t=b(16, 256) / 256.0,
        # cells/frame (road coords are heightmap cells)
        speed=0.06 + 0.06 * b(4, 256) / 256.0,
        frame=torch.zeros((), dtype=torch.int32),
        parked=parked,
        spot_x=torch.as_tensor(sp[:, 0].copy()), spot_y=torch.as_tensor(sp[:, 1].copy()),
        timer=((h >> 20) % 600).to(torch.int32) + 120,
    )
    return CarState(*(v.to(dev) for v in cars))


def car_positions(cars: CarState, graph: RoadGraph):
    sx1, sy1 = _rows(graph.x1, cars.seg), _rows(graph.y1, cars.seg)
    sx2, sy2 = _rows(graph.x2, cars.seg), _rows(graph.y2, cars.seg)
    toward1 = cars.end == 0
    ax = torch.where(toward1, sx2, sx1)
    ay = torch.where(toward1, sy2, sy1)
    bx = torch.where(toward1, sx1, sx2)
    by = torch.where(toward1, sy1, sy2)
    rx = ax + cars.t * (bx - ax)
    ry = ay + cars.t * (by - ay)
    # parked cars sit in their owned spot
    return (torch.where(cars.parked, cars.spot_x, rx),
            torch.where(cars.parked, cars.spot_y, ry))


def _seg_dir_vec(dim, end):
    """Unit travel direction of (segment dim, toward-end)."""
    dx = torch.where(dim == 0, torch.where(end == 1, 1.0, -1.0), 0.0)
    dy = torch.where(dim == 1, torch.where(end == 1, 1.0, -1.0), 0.0)
    return dx, dy


class CarPeers(NamedTuple):
    """What headway reads of every car: the previous frame's whole
    population (a rank's cars are `first`, `first + 1`, ... of it)."""

    seg: torch.Tensor
    end: torch.Tensor
    t: torch.Tensor
    parked: torch.Tensor
    first: int = 0


def step_cars(cars: CarState, graph: RoadGraph,
              stoplights: StoplightSet | None = None,
              peers: CarPeers | None = None) -> CarState:
    """One traffic frame: advance along segments, stop at red lights (the
    full per-intersection 6-state machine with left-arrow masks when
    `stoplights` is given; the legacy global 2-phase clock otherwise),
    keep headway, classify and take turns at intersections, park/unpark
    on timers (car_manager_t::next_frame, cars.cpp:1855).  Draws nothing
    (the JAX step takes a key it never reads).

    `cars` may be a slab of the population (`parallel/city`): `peers` is
    then the whole previous population and `peers.first` the slab's first
    index, which the turn hash and the self test use; by default the cars
    are the whole population."""
    seg = cars.seg.long()
    end = cars.end.long()
    length = graph.length[seg]
    dim = graph.dim[seg]
    end_light = graph.has_light[seg, end]
    isec = graph.isec_id[seg, end]

    # choose the next segment first so the turn type gates the light.  The
    # choice is a hash of (car index, current segment), not a per-frame
    # roll, so a car's turn intent persists while it waits at a red arrow;
    # 32-bit lanes carried in int64 and masked
    m32 = 0xFFFFFFFF
    if peers is None:
        peers = CarPeers(cars.seg, cars.end, cars.t, cars.parked)
    car_ix = peers.first + torch.arange(cars.t.shape[0], dtype=torch.int64, device=seg.device)
    hbits = (car_ix * 2654435761 + seg * 40503) & m32
    hbits = hbits ^ (hbits >> 13)
    hbits = (hbits * 747796405) & m32
    hsel = ((hbits ^ (hbits >> 16)) & ((1 << 30) - 1)).to(torch.int32)
    nn = graph.num_next[seg, end]
    choice = hsel % torch.clamp(nn, min=1)
    new_seg = graph.next_seg[seg, end, choice.long()]
    new_from_end = graph.next_end[seg, end, choice.long()]
    new_end = 1 - new_from_end
    ndim = graph.dim[torch.clamp(new_seg, min=0).long()]

    # turn classification from travel-direction cross product
    d1x, d1y = _seg_dir_vec(dim, cars.end)
    d2x, d2y = _seg_dir_vec(ndim, new_end)
    cross = d1x * d2y - d1y * d2x
    turn = torch.where(cross > 0.5, TURN_LEFT,
                       torch.where(cross < -0.5, TURN_RIGHT, TURN_NONE))

    if stoplights is not None:
        orient = 2 * dim + cars.end        # {W,E,S,N} (roads.cpp:272)
        red = end_light & red_for(stoplights, isec, orient, turn == TURN_LEFT)
    else:
        # legacy global clock: x-roads green on phase 0, y on phase 1
        phase = (cars.frame.to(torch.float32) // STOPLIGHT_PERIOD).to(torch.int32) % 2
        red = end_light & (dim != phase)
    near_end = cars.t > 0.92

    # headway: same segment+direction, ahead within gap -> brake (a row
    # per car of `cars`, a column per car of `peers`)
    n = peers.t.shape[0]
    same = (cars.seg[:, None] == peers.seg[None, :]) & \
        (cars.end[:, None] == peers.end[None, :]) & \
        ~cars.parked[:, None] & ~peers.parked[None, :]
    ahead = (peers.t[None, :] > cars.t[:, None]) & \
        ((peers.t[None, :] - cars.t[:, None]) * length[:, None] < 0.35)
    not_self = car_ix[:, None] != torch.arange(n, dtype=torch.int64, device=seg.device)[None, :]
    blocked = torch.any(same & ahead & not_self, dim=1)

    driving = ~cars.parked
    v = torch.where(driving & ~blocked & ~(red & near_end), cars.speed, 0.0)
    t = cars.t + v / torch.clamp(length, min=1e-6)

    done = (t >= 1.0) & ~red & driving
    has_next = (nn > 0) & (new_seg >= 0)
    seg_o = torch.where(done & has_next, new_seg, cars.seg)
    end_o = torch.where(done & has_next, new_end, cars.end)
    t = torch.where(done & has_next, 0.0,
                    torch.where(done, 0.999, torch.clamp(t, max=0.999)))

    # park/unpark on timers: a driving car parks when its timer expires at
    # a segment end; a parked car re-enters at its segment start
    timer = torch.clamp(cars.timer - 1, min=0)
    do_park = driving & (timer == 0) & done
    do_unpark = cars.parked & (timer == 0)
    parked = torch.where(do_park, True, torch.where(do_unpark, False, cars.parked))
    t = torch.where(do_unpark, 0.0, t)
    new_timer = 120 + (hsel >> 8) % 900
    timer = torch.where(do_park | do_unpark, new_timer, timer)
    return CarState(seg=seg_o, end=end_o, t=t, speed=cars.speed,
                    frame=cars.frame + 1, parked=parked,
                    spot_x=cars.spot_x, spot_y=cars.spot_y, timer=timer)


class PedNav(NamedTuple):
    """Block-level ped navigation tables (host-built once).

    Blocks are nodes; edges cross one road to a grid-adjacent block via a
    crosswalk waypoint gated by the nearest intersection's light
    (ped_manager_t plot navigation, pedestrians.cpp:2550)."""

    blk: torch.Tensor        # [B, 4] x1 y1 x2 y2
    adj: torch.Tensor        # [B, 4] neighbor block (-1 none): -x +x -y +y
    cross_x: torch.Tensor    # [B, 4] crossing waypoint (road centerline)
    cross_y: torch.Tensor
    cross_isec: torch.Tensor  # [B, 4] gating intersection (-1 ungated)
    cross_dim: torch.Tensor   # [B, 4] dim of the road being crossed


def build_ped_nav(net: RoadNetwork, max_gap: float = 3.0,
                  device: torch.device | str = "cuda") -> PedNav:
    blocks = [b for b in net.blocks]
    B = max(len(blocks), 1)
    blk = np.zeros((B, 4), np.float32)
    adj = -np.ones((B, 4), np.int32)
    cx = np.zeros((B, 4), np.float32)
    cy = np.zeros((B, 4), np.float32)
    cisec = -np.ones((B, 4), np.int32)
    cdim = np.zeros((B, 4), np.int32)
    for i, (x1, y1, x2, y2, *c) in enumerate(blocks):
        blk[i] = (x1, y1, x2, y2)
    ipos = np.asarray([(it.x, it.y) for it in net.isecs], np.float32) \
        if net.isecs else np.zeros((0, 2), np.float32)
    for i in range(len(blocks)):
        x1, y1, x2, y2, *ci = blocks[i]
        for j in range(len(blocks)):
            if i == j or blocks[j][4:] != blocks[i][4:]:
                continue
            u1, v1, u2, v2, *cj = blocks[j]
            ovy = min(y2, v2) - max(y1, v1)
            ovx = min(x2, u2) - max(x1, u1)
            mid_y = 0.5 * (max(y1, v1) + min(y2, v2))
            mid_x = 0.5 * (max(x1, u1) + min(x2, u2))
            side = None
            if 0 < x1 - u2 <= max_gap and ovy > 0:     # j is -x neighbor
                side, px, py, dm = 0, 0.5 * (x1 + u2), mid_y, 1
            elif 0 < u1 - x2 <= max_gap and ovy > 0:   # +x
                side, px, py, dm = 1, 0.5 * (u1 + x2), mid_y, 1
            elif 0 < y1 - v2 <= max_gap and ovx > 0:   # -y
                side, px, py, dm = 2, mid_x, 0.5 * (y1 + v2), 0
            elif 0 < v1 - y2 <= max_gap and ovx > 0:   # +y
                side, px, py, dm = 3, mid_x, 0.5 * (v1 + y2), 0
            if side is None or adj[i, side] >= 0:
                continue
            adj[i, side] = j
            cx[i, side] = px
            cy[i, side] = py
            cdim[i, side] = dm
            if len(ipos):
                d2 = (ipos[:, 0] - px) ** 2 + (ipos[:, 1] - py) ** 2
                k = int(np.argmin(d2))
                if net.isecs[k].has_stoplight:
                    cisec[i, side] = k
    J = lambda a: _t(a, device)
    return PedNav(blk=J(blk), adj=J(adj), cross_x=J(cx), cross_y=J(cy),
                  cross_isec=J(cisec), cross_dim=J(cdim))


class PedState(NamedTuple):
    x: torch.Tensor
    y: torch.Tensor
    gx: torch.Tensor    # goal
    gy: torch.Tensor
    speed: torch.Tensor
    blk: torch.Tensor = None      # [N] int32 current block
    stage: torch.Tensor = None    # 0 to-crosswalk, 1 crossing, 2 to-goal
    side: torch.Tensor = None     # [N] int32 chosen crossing side


def make_peds(n: int, blocks, seed: int = 0,
              device: torch.device | str = "cuda") -> PedState:
    """Spawn pedestrians in city blocks with in-block goals (numpy's
    `default_rng`, as in the JAX package)."""
    rg = np.random.default_rng(seed)
    blk = np.asarray(blocks, np.float32)
    bi = rg.integers(0, len(blk), n)
    u1, u2, u3, u4 = rg.random((4, n)).astype(np.float32)
    x = blk[bi, 0] + u1 * (blk[bi, 2] - blk[bi, 0])
    y = blk[bi, 1] + u2 * (blk[bi, 3] - blk[bi, 1])
    gx = blk[bi, 0] + u3 * (blk[bi, 2] - blk[bi, 0])
    gy = blk[bi, 1] + u4 * (blk[bi, 3] - blk[bi, 1])
    speed = 0.002 + 0.002 * rg.random(n).astype(np.float32)
    J = lambda a: _t(a, device)
    return PedState(x=J(x), y=J(y), gx=J(gx), gy=J(gy), speed=J(speed),
                    blk=J(bi.astype(np.int32)),
                    stage=torch.full((n,), 2, dtype=torch.int32, device=device),
                    side=torch.zeros((n,), dtype=torch.int32, device=device))


class PedDraws(NamedTuple):
    """One pedestrian frame's draws (the JAX step's threefry values)."""

    u: torch.Tensor        # [N] uniform [0, 1): cross instead of wander
    side: torch.Tensor     # [N] int32 in [0, 4): the side to cross
    u3: torch.Tensor       # [N] uniform [0, 1): new goal x
    u4: torch.Tensor       # [N] uniform [0, 1): new goal y


class PedPeers(NamedTuple):
    """What separation reads of every pedestrian: the previous frame's
    whole population (a rank's pedestrians are `first`, `first + 1`, ...
    of it)."""

    x: torch.Tensor
    y: torch.Tensor
    first: int = 0


def _separation(x, y, sep_radius, peers: PedPeers | None = None):
    """Unit push away from the neighbours within `sep_radius`: a row per
    pedestrian of (x, y), a column per pedestrian of `peers` (default the
    same ones), each row summed over all columns.  `separation_plain` on
    CPU tensors, the CUDA kernel on the card (`ops/cuda/separation_kernel`)."""
    if peers is None:
        peers = PedPeers(x, y)
    return SEP.separation(x, y, sep_radius, peers)


def separation_plain(x, y, sep_radius, peers: PedPeers):
    """`_separation` in plain PyTorch: [rows x peers] offsets, masks and
    weights, summed along each row."""
    ex = x[:, None] - peers.x[None, :]
    ey = y[:, None] - peers.y[None, :]
    d2 = ex * ex + ey * ey
    n = peers.x.shape[0]
    ix = peers.first + torch.arange(x.shape[0], dtype=torch.int64, device=x.device)
    near = (d2 < sep_radius ** 2) & \
        (ix[:, None] != torch.arange(n, dtype=torch.int64, device=x.device)[None, :])
    w = torch.where(near, 1.0 / torch.clamp(d2, min=1e-4), 0.0)
    rx = torch.sum(w * ex, 1)
    ry = torch.sum(w * ey, 1)
    rl = torch.sqrt(rx * rx + ry * ry) + 1e-9
    return rx / rl, ry / rl


def step_peds(p: PedState, draws: PedDraws, sep_radius: float = 0.15,
              nav: PedNav | None = None,
              stoplights: StoplightSet | None = None,
              peers: PedPeers | None = None) -> PedState:
    """Goal steering + neighbor separation (ped_manager_t crowd update).
    With `nav`, pedestrians do plot navigation: wander inside their
    block, pick an adjacent block, walk to the crosswalk, wait for the
    light (can_walk via `stoplights`), cross, continue — never roaming
    open road except at crosswalks (pedestrians.cpp:2550).  Without it,
    a reached goal moves by (4 u3 - 2, 4 u4 - 2), the JAX step's uniform
    draws in [-2, 2) taken as 4 u - 2.  `p` and `draws` may be a slab of
    the crowd: `peers` is then the whole previous crowd (`step_cars`)."""
    n = p.x.shape[0]
    rx, ry = _separation(p.x, p.y, sep_radius, peers)

    if nav is None or p.blk is None:
        dx = p.gx - p.x
        dy = p.gy - p.y
        d = torch.sqrt(dx * dx + dy * dy) + 1e-9
        mx = dx / d + 0.5 * rx
        my = dy / d + 0.5 * ry
        ml = torch.sqrt(mx * mx + my * my) + 1e-9
        x = p.x + p.speed * mx / ml
        y = p.y + p.speed * my / ml
        reached = d < 0.05
        ngx = p.gx + (draws.u3 * 4.0 - 2.0)
        ngy = p.gy + (draws.u4 * 4.0 - 2.0)
        return p._replace(x=x, y=y, gx=torch.where(reached, ngx, p.gx),
                          gy=torch.where(reached, ngy, p.gy))

    b = p.blk.long()
    s = p.side.long()
    wx = nav.cross_x[b, s]
    wy = nav.cross_y[b, s]
    isec = nav.cross_isec[b, s]
    rdim = nav.cross_dim[b, s]
    nblk = nav.adj[b, s]

    # stage targets: 0 -> curb point (crosswalk waypoint clipped into the
    # ped's own block, so the light wait happens on the sidewalk), 1 ->
    # across the road, 2 -> in-block goal
    bx1, by1, bx2, by2 = nav.blk[b].unbind(-1)
    curb_x = torch.clamp(wx, bx1, bx2)
    curb_y = torch.clamp(wy, by1, by2)
    crossing = p.stage < 2
    tx = torch.where(crossing, curb_x, p.gx)
    ty = torch.where(crossing, curb_y, p.gy)
    dx = tx - p.x
    dy = ty - p.y
    d = torch.sqrt(dx * dx + dy * dy) + 1e-9

    # light gate at the crosswalk entry (stage 0 arrival)
    if stoplights is not None:
        walk_ok = can_cross(stoplights, isec, rdim)
    else:
        walk_ok = torch.ones((n,), dtype=torch.bool, device=p.x.device)
    at_entry = (p.stage == 0) & (d < 0.06)
    hold = at_entry & ~walk_ok
    stage = torch.where(at_entry & walk_ok, 1, p.stage)
    # crossing complete: inside the destination block
    nx1, ny1, nx2, ny2 = nav.blk[torch.clamp(nblk, min=0).long()].unbind(-1)
    in_dest = (p.x >= nx1) & (p.x <= nx2) & (p.y >= ny1) & (p.y <= ny2)
    done_cross = (p.stage == 1) & in_dest
    stage = torch.where(done_cross, 2, stage)
    blk = torch.where(done_cross, nblk, p.blk)
    # crossing target past the entry: aim at the dest-block center while
    # on the road
    cxd = 0.5 * (nx1 + nx2)
    cyd = 0.5 * (ny1 + ny2)
    tx = torch.where(stage == 1, cxd, tx)
    ty = torch.where(stage == 1, cyd, ty)
    dx = tx - p.x
    dy = ty - p.y
    d = torch.sqrt(dx * dx + dy * dy) + 1e-9

    mx = dx / d + 0.4 * rx
    my = dy / d + 0.4 * ry
    ml = torch.sqrt(mx * mx + my * my) + 1e-9
    v = torch.where(hold, 0.0, p.speed)
    x = p.x + v * mx / ml
    y = p.y + v * my / ml
    # plot containment: off-road stages (0 and 2) stay inside their
    # (updated) block; only stage 1 (mid-crossing) is on the road
    cx1, cy1, cx2, cy2 = nav.blk[blk.long()].unbind(-1)
    contained = stage != 1
    x = torch.where(contained, torch.minimum(torch.maximum(x, cx1), cx2), x)
    y = torch.where(contained, torch.minimum(torch.maximum(y, cy1), cy2), y)

    # in-block goal reached -> either wander in-block or head for a
    # random valid crossing side
    reached = (p.stage == 2) & (d < 0.05)
    pick_cross = reached & (draws.u < 0.4)
    new_side = draws.side
    side_ok = nav.adj[b, new_side.long()] >= 0
    stage = torch.where(pick_cross & side_ok, 0, stage)
    side = torch.where(pick_cross & side_ok, new_side, p.side)
    # new in-block goal for wanderers
    u3, u4 = draws.u3, draws.u4
    ngx = bx1 + u3 * (bx2 - bx1)
    ngy = by1 + u4 * (by2 - by1)
    # after crossing, the goal must live in the NEW block
    gx = torch.where(done_cross, nx1 + u3 * (nx2 - nx1),
                     torch.where(reached, ngx, p.gx))
    gy = torch.where(done_cross, ny1 + u4 * (ny2 - ny1),
                     torch.where(reached, ngy, p.gy))
    return PedState(x=x, y=y, gx=gx, gy=gy, speed=p.speed,
                    blk=blk, stage=stage, side=side)


# ---------------------------------------------------------------------------
# railroads (roads.cpp railroad segments) + trains
# ---------------------------------------------------------------------------

class RailLine(NamedTuple):
    """One polyline rail line: waypoint arrays + cumulative arc length
    (trains parameterize by distance along the line)."""

    wx: torch.Tensor       # [W]
    wy: torch.Tensor
    cum: torch.Tensor      # [W] cumulative length, cum[0]=0
    length: torch.Tensor   # scalar total


def gen_railroad(route_pts, jitter: float = 0.0, seed: int = 0,
                 device: torch.device | str = "cuda") -> RailLine:
    """Rail line along a connector-route polyline ([(x, y), ...])."""
    pts = np.asarray(route_pts, np.float32)
    d = np.sqrt(((pts[1:] - pts[:-1]) ** 2).sum(1))
    cum = np.concatenate([[0.0], np.cumsum(d)]).astype(np.float32)
    return RailLine(wx=_t(pts[:, 0], device), wy=_t(pts[:, 1], device),
                    cum=_t(cum, device), length=_t(cum[-1], device))


class TrainState(NamedTuple):
    s: torch.Tensor        # [N] arc position along the line
    speed: torch.Tensor    # [N] signed (bounces between the ends)
    line: torch.Tensor     # [N] int32 rail line index


def make_trains(n: int, num_lines: int, seed: int = 0,
                device: torch.device | str = "cuda") -> TrainState:
    rg = RandGen(seed + 2, 5 * seed + 9)
    s = np.asarray([rg.randd() for _ in range(n)], np.float32)
    speed = np.asarray([0.02 + 0.02 * rg.randd() for _ in range(n)], np.float32)
    line = np.asarray([rg.rand() % num_lines for _ in range(n)], np.int32)
    return TrainState(s=_t(s, device), speed=_t(speed, device), line=_t(line, device))


def step_trains(t: TrainState, line: RailLine) -> TrainState:
    """Advance along arc length; reverse at the ends (out-and-back
    service along the connector, like the reference's track-bound cars)."""
    s = t.s + t.speed
    over = (s >= line.length) | (s <= 0.0)
    speed = torch.where(over, -t.speed, t.speed)
    s = torch.minimum(torch.clamp(s, min=0.0), line.length)
    return t._replace(s=s, speed=speed)


def train_positions(t: TrainState, line: RailLine):
    """[N] world xy by piecewise-linear interpolation of arc position."""
    seg_lo = line.cum[:-1][None, :]            # [1, W-1]
    seg_hi = line.cum[1:][None, :]
    s = t.s[:, None]
    in_seg = ((s >= seg_lo) & (s < seg_hi)).to(torch.float32)
    frac = torch.where(seg_hi > seg_lo,
                       (s - seg_lo) / torch.clamp(seg_hi - seg_lo, min=1e-9), 0.0)
    x = torch.sum(in_seg * (line.wx[:-1][None, :] * (1 - frac)
                            + line.wx[1:][None, :] * frac), 1)
    y = torch.sum(in_seg * (line.wy[:-1][None, :] * (1 - frac)
                            + line.wy[1:][None, :] * frac), 1)
    # past the last segment (s == length): clamp to the final waypoint
    past = (t.s >= line.cum[-1]).to(torch.float32)
    return x * (1 - past) + line.wx[-1] * past, y * (1 - past) + line.wy[-1] * past


# ---------------------------------------------------------------------------
# helicopters (city helicopters: fly between building-roof helipads)
# ---------------------------------------------------------------------------

HELI_CRUISE_Z = 0.6
HELI_SPEED = 0.02
HELI_VSPEED = 0.01


class HeliState(NamedTuple):
    px: torch.Tensor
    py: torch.Tensor
    pz: torch.Tensor
    pad: torch.Tensor      # [N] int32 target helipad index
    phase: torch.Tensor    # 0 parked, 1 takeoff, 2 cruise, 3 landing
    wait: torch.Tensor     # parked frames remaining


def make_helipads(buildings, max_pads: int = 8):
    """Helipads on the tallest buildings' top parts: [P, 3] (x, y, roof_z)."""
    tops = []
    for b in buildings:
        (x1, y1, _z1, x2, y2, z2) = b.parts[-1]
        tops.append((0.5 * (x1 + x2), 0.5 * (y1 + y2), z2))
    tops.sort(key=lambda p: -p[2])
    return np.asarray(tops[:max_pads], np.float32).reshape(-1, 3)


def make_helis(n: int, pads: np.ndarray, seed: int = 0,
               device: torch.device | str = "cuda") -> HeliState:
    rg = RandGen(seed + 3, seed + 13)
    start = np.asarray([rg.rand() % len(pads) for _ in range(n)])
    p = pads[start]
    pad = np.asarray([rg.rand() % len(pads) for _ in range(n)], np.int32)
    wait = np.asarray([rg.rand() % 60 for _ in range(n)], np.int32)
    return HeliState(px=_t(p[:, 0], device), py=_t(p[:, 1], device),
                     pz=_t(p[:, 2], device), pad=_t(pad, device),
                     phase=torch.zeros((n,), dtype=torch.int32, device=device),
                     wait=_t(wait, device))


def step_helis(h: HeliState, pads: torch.Tensor, new_pad: torch.Tensor,
               new_wait: torch.Tensor) -> HeliState:
    """Parked -> takeoff (climb to cruise) -> cruise (fly over the city
    toward the target pad) -> land (descend) -> parked; the destination
    `new_pad` ([N] int32 in [0, P)) and wait `new_wait` ([N] int32 in
    [30, 120)) are taken on touchdown."""
    tx, ty, tz = pads[h.pad.long()].unbind(-1)
    parked = h.phase == 0
    takeoff = h.phase == 1
    cruise = h.phase == 2
    landing = h.phase == 3

    wait = torch.clamp(h.wait - parked.to(torch.int32), min=0)
    launch = parked & (wait == 0)

    # cruise above the destination pad plus clearance, and never snap DOWN
    # during takeoff (pads higher than the cruise height count as already
    # at altitude)
    cruise_z = torch.clamp(tz + 0.08, min=HELI_CRUISE_Z)
    pz = torch.where(takeoff,
                     torch.maximum(torch.minimum(h.pz + HELI_VSPEED, cruise_z), h.pz),
                     h.pz)
    at_cruise = takeoff & (pz >= cruise_z - 1e-6)

    dx = tx - h.px
    dy = ty - h.py
    d = torch.sqrt(dx * dx + dy * dy) + 1e-9
    stepc = torch.clamp(d, max=HELI_SPEED)
    px = torch.where(cruise, h.px + stepc * dx / d, h.px)
    py = torch.where(cruise, h.py + stepc * dy / d, h.py)
    over_pad = cruise & (d < 0.01)

    pz = torch.where(landing, torch.maximum(pz - HELI_VSPEED, tz), pz)
    touched = landing & (pz <= tz + 1e-6)

    phase = torch.where(launch, 1, h.phase)
    phase = torch.where(at_cruise, 2, phase)
    phase = torch.where(over_pad, 3, phase)
    phase = torch.where(touched, 0, phase)
    return HeliState(px=px, py=py, pz=pz,
                     pad=torch.where(touched, new_pad, h.pad),
                     phase=phase,
                     wait=torch.where(touched, new_wait, wait))


CAR_LEN = 0.27      # nominal car size (city_params get_nom_car_size)
CAR_WID = 0.12
CAR_HGT = 0.09


def car_geometry(cars: CarState, graph: RoadGraph, ground_z: float = 0.0):
    """Oriented car boxes for export/collision (car_t bcube + dim/dir):
    returns (cx, cy, cz, half_len_x, half_len_y, half_h, heading) with the
    long axis along the travel direction; parked cars sit in their spots
    aligned to +x."""
    x, y = car_positions(cars, graph)
    dim = _rows(graph.dim, cars.seg)
    along_x = torch.where(cars.parked, True, dim == 0)
    hx = torch.where(along_x, 0.5 * CAR_LEN, 0.5 * CAR_WID)
    hy = torch.where(along_x, 0.5 * CAR_WID, 0.5 * CAR_LEN)
    d1x, d1y = _seg_dir_vec(dim, cars.end)
    heading = torch.where(cars.parked, 0.0, torch.atan2(d1y, d1x))
    return (x, y, torch.full_like(x, ground_z + 0.5 * CAR_HGT),
            hx, hy, torch.full_like(x, 0.5 * CAR_HGT), heading)


# ---------------------------------------------------------------------------
# city birds (city_birds.cpp): standing / takeoff / flying / gliding /
# landing between perch points on city objects and roofs
# ---------------------------------------------------------------------------

(BIRD_STANDING, BIRD_TAKEOFF, BIRD_FLYING, BIRD_GLIDING,
 BIRD_LANDING) = range(5)
BIRD_SPEED = 0.012
BIRD_VSPEED = 0.006
BIRD_CRUISE = 0.35


def bird_perches(objs, buildings, max_perches: int = 64):
    """Perch points: tops of perchable city objects (benches, mailboxes,
    streetlights — add_bird_loc, city_obj_placer.cpp:671; `objs` an
    `objects.CityObjects` or None) + building roof centers."""
    from . import objects as CO
    pts = []
    if objs is not None and len(objs.x):
        perchable = {CO.KIND_INDEX[k] for k in
                     ("bench", "mailbox", "streetlight", "hydrant",
                      "power_pole", "statue")}
        for i in range(len(objs.x)):
            if int(objs.kind[i]) in perchable:
                pts.append((float(objs.x[i]), float(objs.y[i]),
                            float(CO.KIND_HEIGHT[objs.kind[i]])))
    for b in buildings or []:
        (x1, y1, _z1, x2, y2, z2) = b.parts[-1]
        pts.append((0.5 * (x1 + x2), 0.5 * (y1 + y2), z2))
    if not pts:
        pts = [(0.0, 0.0, 0.0)]
    return np.asarray(pts[:max_perches], np.float32)


class BirdState(NamedTuple):
    px: torch.Tensor
    py: torch.Tensor
    pz: torch.Tensor
    vz_sign: torch.Tensor   # >0 climbing (flying anim), <0 descending (glide)
    state: torch.Tensor
    perch: torch.Tensor     # target perch index
    wait: torch.Tensor


def make_birds(n: int, perches: np.ndarray, seed: int = 0,
               device: torch.device | str = "cuda") -> BirdState:
    rg = RandGen(seed + 9, 2 * seed + 7)
    start = np.asarray([rg.rand() % len(perches) for _ in range(n)])
    p = perches[start]
    perch = np.asarray([rg.rand() % len(perches) for _ in range(n)], np.int32)
    wait = np.asarray([30 + rg.rand() % 200 for _ in range(n)], np.int32)
    return BirdState(px=_t(p[:, 0], device), py=_t(p[:, 1], device),
                     pz=_t(p[:, 2], device),
                     vz_sign=torch.zeros((n,), dtype=torch.float32, device=device),
                     state=torch.zeros((n,), dtype=torch.int32, device=device),
                     perch=_t(perch, device), wait=_t(wait, device))


def step_birds(b: BirdState, perches: torch.Tensor, new_perch: torch.Tensor,
               new_wait: torch.Tensor) -> BirdState:
    """standing -> takeoff (climb to cruise) -> flying toward the target
    perch, switching to GLIDING while descending (city_birds.cpp:173-178)
    -> landing -> standing with a new destination `new_perch` ([N] int32
    in [0, P)) and wait `new_wait` ([N] int32 in [60, 400))."""
    tx, ty, tz = perches[b.perch.long()].unbind(-1)
    standing = b.state == BIRD_STANDING
    takeoff = b.state == BIRD_TAKEOFF
    airborne = (b.state == BIRD_FLYING) | (b.state == BIRD_GLIDING)
    landing = b.state == BIRD_LANDING

    wait = torch.clamp(b.wait - standing.to(torch.int32), min=0)
    launch = standing & (wait == 0)

    pz = torch.where(takeoff, b.pz + BIRD_VSPEED, b.pz)
    up_done = takeoff & (pz >= tz + 0.5 * BIRD_CRUISE)

    dx = tx - b.px
    dy = ty - b.py
    d = torch.sqrt(dx * dx + dy * dy) + 1e-9
    stepc = torch.clamp(d, max=BIRD_SPEED)
    px = torch.where(airborne, b.px + stepc * dx / d, b.px)
    py = torch.where(airborne, b.py + stepc * dy / d, b.py)
    # descend toward the perch height while cruising in
    dz_target = tz + torch.clamp(d * 0.5, max=BIRD_CRUISE)
    climb = dz_target - pz
    vz = torch.clamp(climb, -BIRD_VSPEED, BIRD_VSPEED)
    pz = torch.where(airborne, pz + vz, pz)
    over = airborne & (d < 0.02)
    touched = landing & (pz <= tz + 1e-3)
    pz = torch.where(landing, torch.maximum(pz - BIRD_VSPEED, tz), pz)

    # flying <-> gliding by vertical velocity sign (city_birds.cpp:173)
    state = torch.where(launch, BIRD_TAKEOFF, b.state)
    state = torch.where(up_done, BIRD_FLYING, state)
    state = torch.where(airborne & (vz < 0), BIRD_GLIDING, state)
    state = torch.where(airborne & (vz >= 0), BIRD_FLYING, state)
    state = torch.where(over, BIRD_LANDING, state)
    state = torch.where(touched, BIRD_STANDING, state)
    return BirdState(px=px, py=py, pz=pz, vz_sign=vz, state=state,
                     perch=torch.where(touched, new_perch, b.perch),
                     wait=torch.where(touched, new_wait, wait))

"""Underground basement tunnels (building_tunnels.cpp).

Reference behavior: basement rooms sprout walkable utility-tunnel
networks (`try_place_tunnel_at_extb_hallway_end`
building_tunnels.cpp:204-245) — a room-connected center segment runs
parallel to the end wall of the room just outside a false door, is
extended stepwise up to a max length per side
(`try_extend_tunnel` :184-202), and each end grows 1-2 recursive
90-degree bend segments (`add_extend_tunnel_seg` :252-294).  Closed
ends carry barred gates 5 floor-spacings in (:297-301); each segment
has a water level/flow (:228); long segments get a vertical shaft to a
street manhole when in a city plus 0-3 side pipe connections, and all
segments get interior pipes and spider webs
(`add_tunnel_objects` :309-420).  The player walk area inside a
tunnel is the center strip, clamped at closed ends and gates
(`get_walk_area` :33-51).

Port of `3dworld_tpu/city/tunnels.py`: generation is host-side seeded
geometry (irregular, like floorplan.py) emitting TunnelSeg records,
copied whole; the per-frame part — keeping players/zombies inside the
walk area — is a fixed-shape packed table on the caller's device
(`pack_tunnels`) and an elementwise clamp over it
(`clamp_to_walk_area`).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from ..utils.rng import RandGen

# tuning (building_tunnels.cpp:204-245, in floor-heights)
RADIUS_F = 0.4            # bore radius = half the door height
MIN_LEN_F = 8.0           # min tunnel length per side from the door
MAX_LEN_F = 20.0          # max tunnel length per side
GATE_DIST_F = 5.0         # gate distance from a closed end
WALL_GAP_F = 0.24         # 2x wall thickness
EXTEND_STEPS = 10         # try_extend_tunnel num_steps


@dataclass
class TunnelConn:
    """Side pipe or vertical shaft off a segment (tunnel_conn_t)."""
    dim: int          # axis the conn extends along (2 = vertical shaft)
    dir: int          # +1 side or -1 side of the tunnel
    pos: float        # position along the parent segment's run axis
    length: float
    radius: float
    water_level: float = 0.0
    water_flow: float = 0.0


@dataclass
class TunnelSeg:
    """One straight tunnel segment (tunnel_seg_t)."""
    p0: tuple         # low endpoint (x, y, z) — centerline
    p1: tuple         # high endpoint
    radius: float
    dim: int          # axis the tunnel runs along (0=x, 1=y)
    tseg_ix: int = 0
    parent_ix: int = -1
    room_conn: bool = False   # connects to the basement room
    room_dir: int = 0         # which side of the room wall
    closed_lo: bool = True
    closed_hi: bool = True
    has_gate: bool = False
    gate_pos: float = 0.0
    water_level: float = 0.0
    water_flow: float = 0.0
    conns: list = field(default_factory=list)
    conns_added: bool = False   # add_tunnel_objects ran (one-shot flag)

    @property
    def length(self):
        return self.p1[self.dim] - self.p0[self.dim]

    def bcube(self, pad: float = 0.0):
        """AABB of the bore, optionally padded by wall thickness."""
        r = self.radius + pad
        lo = [self.p0[0], self.p0[1], self.p0[2] - r]
        hi = [self.p1[0], self.p1[1], self.p0[2] + r]
        lo[1 - self.dim] -= r
        hi[1 - self.dim] += r
        lo[self.dim] -= pad
        hi[self.dim] += pad
        return (lo[0], lo[1], lo[2], hi[0], hi[1], hi[2])


def _cubes_intersect(a, b):
    return (a[0] < b[3] and b[0] < a[3] and a[1] < b[4] and b[1] < a[4]
            and a[2] < b[5] and b[2] < a[5])


def _placement_valid(bc, avoid_cubes, ground_z):
    """is_tunnel_bcube_placement_valid: clear of basement/building cubes
    and fully below the ground surface (terrain clip check,
    building_tunnels.cpp:173-179)."""
    if bc[5] >= ground_z:
        return False
    return not any(_cubes_intersect(bc, a) for a in avoid_cubes)


def _try_extend(p0, p1, max_extend, check_r, dim, direction,
                avoid_cubes, ground_z):
    """Greedy stepwise extension of one end (try_extend_tunnel)."""
    step = max_extend / EXTEND_STEPS
    p0 = list(p0)
    p1 = list(p1)
    for _ in range(EXTEND_STEPS):
        cand0, cand1 = list(p0), list(p1)
        if direction:
            cand1[dim] += step
        else:
            cand0[dim] -= step
        seg = TunnelSeg(tuple(cand0), tuple(cand1), check_r, dim)
        if not _placement_valid(seg.bcube(), avoid_cubes, ground_z):
            break
        p0, p1 = cand0, cand1
    return tuple(p0), tuple(p1)


def _add_run(segs, a, b, run_dim, parent_ix, far_is_hi, gate_dist,
             radius, water_level, water_flow):
    """connect_and_add_tunnel_seg: a straight run from a connection
    point to a far endpoint, gated gate_dist in from the far (closed)
    end; the connected end is open."""
    lo, hi = (list(a), list(b)) if a[run_dim] <= b[run_dim] else \
             (list(b), list(a))
    seg = TunnelSeg(tuple(lo), tuple(hi), radius, run_dim,
                    tseg_ix=len(segs), parent_ix=parent_ix,
                    water_level=water_level, water_flow=water_flow)
    if far_is_hi:
        seg.closed_lo = False
        gp = hi[run_dim] - gate_dist
    else:
        seg.closed_hi = False
        gp = lo[run_dim] + gate_dist
    if lo[run_dim] < gp < hi[run_dim]:
        seg.has_gate = True
        seg.gate_pos = gp
    segs.append(seg)
    return seg


def _grow_bend(segs, parent_ix, depth, dim, min_len, max_extend,
               gate_dist, wall_t, avoid_cubes, ground_z, rg):
    """add_extend_tunnel_seg's bend half: try a 90-degree bend at the
    parent run's closed far end, growing along `dim`; recurse 1-2 deep
    (building_tunnels.cpp:252-294)."""
    parent = segs[parent_ix]
    radius = parent.radius
    if depth >= (1 if rg.rand_bool() else 2):
        return
    at_hi = parent.closed_hi
    end_pt = parent.p1 if at_hi else parent.p0
    first_dir = rg.rand_bool()
    for n in range(2):
        bend_dir = bool(n) ^ first_dir
        q0, q1 = list(end_pt), list(end_pt)
        if bend_dir:
            q1[dim] += min_len
        else:
            q0[dim] -= min_len
        # pull the connecting end back so the validity query doesn't see
        # the parent bore (building_tunnels.cpp:275-277)
        t0, t1 = list(q0), list(q1)
        (t0 if bend_dir else t1)[dim] += ((radius + wall_t) if bend_dir
                                          else -(radius + wall_t))
        probe = TunnelSeg(tuple(t0), tuple(t1), radius + wall_t, dim)
        if not _placement_valid(probe.bcube(), avoid_cubes, ground_z):
            continue
        q0, q1 = _try_extend(q0, q1, max_extend, radius + wall_t, dim,
                             bend_dir, avoid_cubes, ground_z)
        far = tuple(q1) if bend_dir else tuple(q0)
        child = _add_run(segs, end_pt, far, dim, parent_ix, bend_dir,
                         gate_dist, radius, parent.water_level,
                         parent.water_flow)
        avoid_cubes.append(child.bcube())
        # bend replaces the parent's end gate and opens that end
        parent.has_gate = False
        if at_hi:
            parent.closed_hi = False
        else:
            parent.closed_lo = False
        _grow_bend(segs, child.tseg_ix, depth + 1, 1 - dim, min_len,
                   max_extend, gate_dist, wall_t, avoid_cubes, ground_z,
                   rg)
        return


def gen_tunnels(building, buildings, floor_height: float, seed: int,
                ground_z: float | None = None):
    """Grow a tunnel network off one end of a building's basement room.

    Mirrors try_place_tunnel_at_extb_hallway_end: pick an end of the
    basement room's long dim, place the room-connected center segment
    parallel to that wall just outside it, extend both ways, then grow
    bends.  Returns [] if the building has no basement or no valid
    placement.  `buildings` supplies the avoid set (other basements +
    this building's own basement footprint)."""
    inter = getattr(building, "interior", None)
    if inter is None:
        return []
    base_rooms = [r for r in inter.rooms if r.floor < 0]
    if not base_rooms:
        return []
    room = base_rooms[0]
    fh = floor_height
    bz1 = inter.z1 + room.floor * fh          # basement floor z
    radius = RADIUS_F * fh
    wall_t = 0.12 * fh
    wall_gap = WALL_GAP_F * fh
    zc = bz1 + radius + 0.02 * fh             # bore centerline height
    rg = RandGen(seed * 7 + 11, seed + 5)

    avoid = []
    for b in buildings:
        bi = getattr(b, "interior", None)
        if not getattr(b, "parts", None):
            continue
        p0 = b.parts[0]
        if bi is not None and any(r.floor < 0 for r in bi.rooms):
            avoid.append((p0[0], p0[1], bi.z1 - fh, p0[3], p0[4], bi.z1))
    if ground_z is None:
        ground_z = inter.z1 - 0.01 * fh       # just below this building

    dim = 0 if (room.x2 - room.x1) >= (room.y2 - room.y1) else 1
    lo = (room.x1, room.y1)
    hi = (room.x2, room.y2)
    min_len = MIN_LEN_F * fh
    max_extend = (MAX_LEN_F - MIN_LEN_F) * fh
    gate_dist = GATE_DIST_F * fh
    first_end = rg.rand_bool()
    for d in (first_end, not first_end):
        # door centered on the end wall; tunnel centerline sits
        # dist_from_door = radius + wall_gap outside the room
        mid = [0.0, 0.0, zc]
        mid[1 - dim] = 0.5 * (lo[1 - dim] + hi[1 - dim])
        mid[dim] = (hi[dim] + radius + wall_gap) if d else \
                   (lo[dim] - radius - wall_gap)
        run = 1 - dim                          # center seg runs along !dim
        p0, p1 = list(mid), list(mid)
        p0[run] -= min_len
        p1[run] += min_len
        probe = TunnelSeg(tuple(p0), tuple(p1), radius + wall_t, run)
        if not _placement_valid(probe.bcube(), avoid, ground_z):
            continue
        p0, p1 = _try_extend(p0, p1, max_extend, radius + wall_t, run,
                             True, avoid, ground_z)
        p0, p1 = _try_extend(p0, p1, max_extend, radius + wall_t, run,
                             False, avoid, ground_z)
        water_level = rg.rand_uniform(0.0, 1.0) * 0.2 * radius
        water_flow = 2.0 * rg.randd() - 1.0
        # door-width room-connected center segment, then the left/right
        # runs out to the extended endpoints (building_tunnels.cpp:
        # 226-242: tseg_c over [pa, pb], then add_extend_tunnel_seg per
        # end)
        door_w = 0.8 * fh
        pa, pb = list(mid), list(mid)
        pa[run] -= 0.5 * door_w
        pb[run] += 0.5 * door_w
        center = TunnelSeg(tuple(pa), tuple(pb), radius, run, tseg_ix=0,
                           room_conn=True, room_dir=int(d),
                           closed_lo=False, closed_hi=False,
                           water_level=water_level, water_flow=water_flow)
        segs = [center]
        avoid_local = avoid + [TunnelSeg(tuple(p0), tuple(p1), radius,
                                         run).bcube()]
        for e in (0, 1):
            conn_pt = center.p1 if e else center.p0
            far = tuple(p1) if e else tuple(p0)
            child = _add_run(segs, conn_pt, far, run, 0, bool(e),
                             gate_dist, radius, water_level, water_flow)
            _grow_bend(segs, child.tseg_ix, 0, dim, min_len, max_extend,
                       gate_dist, wall_t, avoid_local, ground_z, rg)
        return segs
    return []


def add_tunnel_objects(segs, building_footprint, seed: int,
                       ground_z: float = 0.0, in_city: bool = True):
    """Shafts/manholes/side pipes/interior pipes/webs
    (add_tunnel_objects building_tunnels.cpp:309-420).  Returns
    (objects, manholes): objects = [(kind, (x1,y1,z1,x2,y2,z2))] with
    kind in {'pipe', 'web', 'gate'}; manholes = [(x, y, radius)]."""
    rg = RandGen(seed + 3, 2 * seed + 9)
    objs = []
    manholes = []
    for t in segs:
        if t.room_conn:
            continue                      # nothing added to these
        dim = t.dim
        lo_end, hi_end = t.p0[dim], t.p1[dim]
        avoid = []
        if t.has_gate:
            avoid.append((t.gate_pos, t.radius))
            bar_r = 0.05 * t.radius
            c = [t.p0[0], t.p0[1], t.p0[2]]
            lo = [c[0] - t.radius, c[1] - t.radius, c[2] - t.radius]
            hi = [c[0] + t.radius, c[1] + t.radius, c[2] + t.radius]
            lo[dim] = t.gate_pos - bar_r
            hi[dim] = t.gate_pos + bar_r
            objs.append(("gate", (lo[0], lo[1], lo[2], hi[0], hi[1], hi[2])))
        if t.length > 4.0 * t.radius and not t.conns_added:
            t.conns_added = True
            if in_city:
                # vertical shaft to a surface manhole (:325-345)
                r = rg.rand_uniform(0.8, 0.9) * t.radius
                pad = 1.5 * r
                if hi_end - pad > lo_end + pad:
                    pos = rg.rand_uniform(lo_end + pad, hi_end - pad)
                    clear = all(abs(pos - av) > pad + ar
                                for av, ar in avoid)
                    top = [t.p0[0], t.p0[1]]
                    top[dim] = pos
                    fx1, fy1, fx2, fy2 = building_footprint
                    outside = not (fx1 <= top[0] <= fx2
                                   and fy1 <= top[1] <= fy2)
                    if clear and outside and ground_z > t.p0[2] + t.radius:
                        t.conns.append(TunnelConn(2, 1, pos,
                                                  ground_z - t.p0[2], r))
                        manholes.append((top[0], top[1], 0.6 * r))
                        avoid.append((pos, r))
            # 0-4 side pipe connections (:348-370, rand % (max_pipes+2))
            for _ in range(rg.rand() % 5):
                r = rg.rand_uniform(0.1, 0.3) * t.radius
                pad = 2.0 * r
                if hi_end - pad <= lo_end + pad:
                    continue
                pos = rg.rand_uniform(lo_end + pad, hi_end - pad)
                if any(abs(pos - av) < pad + ar for av, ar in avoid):
                    continue
                conn = TunnelConn(1 - dim, 1 if rg.rand_bool() else -1,
                                  pos, 4.0 * t.radius, r)
                if rg.rand_bool():
                    conn.water_level = min(
                        rg.rand_uniform(0.0, 1.0) * 0.2 * r,
                        0.5 * t.water_level)
                    conn.water_flow = rg.rand_uniform(0.25, 0.5) * conn.dir
                t.conns.append(conn)
                avoid.append((pos, r))
        # 0-2 thin interior pipes along the crown (:373-388)
        for _ in range(rg.rand() % 3):
            r = 0.05 * t.radius * rg.rand_uniform(0.5, 1.0)
            v1, v2 = lo_end + 2.0 * r, hi_end - 2.0 * r
            if v1 >= v2:
                continue
            pos = rg.rand_uniform(v1, v2)
            height = t.radius * rg.rand_uniform(0.7, 0.9)
            if t.has_gate and abs(pos - t.gate_pos) < 2.0 * r:
                continue
            hlen = float(np.sqrt(max(t.radius ** 2 - height ** 2, 0.0))) + 2.0 * r
            z = t.p0[2] + height
            lo = [t.p0[0], t.p0[1], z - r]
            hi = [t.p0[0], t.p0[1], z + r]
            lo[dim], hi[dim] = pos - r, pos + r
            lo[1 - dim] -= hlen
            hi[1 - dim] += hlen
            objs.append(("pipe", (lo[0], lo[1], lo[2], hi[0], hi[1], hi[2])))
        # 0-2 spider webs near the crown corners (:390-400)
        for _ in range(rg.rand() % 3):
            side = 1 if rg.rand_bool() else -1
            width = 0.65 * t.radius * rg.rand_uniform(0.6, 1.0)
            height = 0.65 * t.radius * rg.rand_uniform(0.6, 1.0)
            pos = rg.rand_uniform(lo_end, hi_end)
            shift = 0.16 * t.radius
            edge = t.p0[1 - dim] + side * (t.radius - shift)
            top = t.p0[2] + t.radius - shift
            lo = [t.p0[0], t.p0[1], top - height]
            hi = [t.p0[0], t.p0[1], top]
            lo[dim], hi[dim] = pos - 0.01 * t.radius, pos + 0.01 * t.radius
            lo[1 - dim] = min(edge, edge - side * width)
            hi[1 - dim] = max(edge, edge - side * width)
            objs.append(("web", (lo[0], lo[1], lo[2], hi[0], hi[1], hi[2])))
    return objs, manholes


# ---------------------------------------------------------------------------
# fixed-shape device path: walk-area clamp inside the gameplay step

PACK_FIELDS = ("x1", "y1", "x2", "y2", "z", "radius", "dim", "gate",
               "gate_pos", "closed_lo", "closed_hi")


def pack_tunnels(segs, cap: int = 16, device: torch.device | str = "cuda"):
    """Pack segments into fixed [cap] float32 tensors on `device` for the
    clamp.  Unused rows have radius 0 (never match)."""
    n = min(len(segs), cap)
    out = {k: np.zeros(cap, np.float32) for k in PACK_FIELDS}
    for i, t in enumerate(segs[:n]):
        out["x1"][i], out["y1"][i] = t.p0[0], t.p0[1]
        out["x2"][i], out["y2"][i] = t.p1[0], t.p1[1]
        out["z"][i] = t.p0[2]
        out["radius"][i] = t.radius
        out["dim"][i] = t.dim
        out["gate"][i] = float(t.has_gate)
        out["gate_pos"][i] = t.gate_pos
        out["closed_lo"][i] = float(t.closed_lo)
        out["closed_hi"][i] = float(t.closed_hi)
    return {k: torch.as_tensor(v, device=device) for k, v in out.items()}


def clamp_to_walk_area(pos, user_radius, packed):
    """get_walk_area (building_tunnels.cpp:33-51) as a pure function:
    for positions inside a tunnel bore, clamp to the walkable center
    strip (width 0.1*radius each side of the centerline), pull in from
    closed ends by user_radius, and stop at the gate on whichever side
    of it the position is.  [P,3] positions (on the table's device) ->
    [P,3] clamped.  Positions in no tunnel pass through unchanged."""
    p = torch.as_tensor(pos, dtype=torch.float32, device=packed["x1"].device)
    x, y = p[..., 0], p[..., 1]
    col = lambda k: packed[k][:, None]
    px1, py1, px2, py2 = col("x1"), col("y1"), col("x2"), col("y2")
    r = col("radius")
    d = col("dim")
    # per-segment run/lateral coordinates of each position [S,P]
    run = torch.where(d == 0, x[None, :], y[None, :])
    lat = torch.where(d == 0, y[None, :], x[None, :])
    run_lo = torch.where(d == 0, px1, py1)
    run_hi = torch.where(d == 0, px2, py2)
    lat_c = torch.where(d == 0, py1, px1)
    inside = ((run >= run_lo - 1e-6) & (run <= run_hi + 1e-6)
              & (torch.abs(lat - lat_c) <= r) & (r > 0))
    walk_w = 0.1 * r
    lat_cl = lat_c + torch.clamp(lat - lat_c, -walk_w, walk_w)
    lo_eff = run_lo + col("closed_lo") * user_radius
    hi_eff = run_hi - col("closed_hi") * user_radius
    gp = col("gate_pos")
    has_g = col("gate") > 0.5
    below = run < gp
    lo_eff = torch.where(has_g & ~below, torch.maximum(lo_eff, gp + user_radius), lo_eff)
    hi_eff = torch.where(has_g & below, torch.minimum(hi_eff, gp - user_radius), hi_eff)
    run_cl = torch.minimum(torch.maximum(run, lo_eff), hi_eff)
    # first matching segment wins
    any_in = inside.any(dim=0)
    first = torch.argmax(inside.to(torch.int32), dim=0)
    pick = lambda a: torch.gather(a, 0, first[None, :])[0]
    run_c, lat_c2 = pick(run_cl), pick(lat_cl)
    dims = packed["dim"][first]
    nx = torch.where(dims == 0, run_c, lat_c2)
    ny = torch.where(dims == 0, lat_c2, run_c)
    return torch.stack([torch.where(any_in, nx, x), torch.where(any_in, ny, y),
                        p[..., 2]], dim=-1)


def tunnels_to_cobjs(segs, device: torch.device | str = "cuda"):
    """Collision export: one floor slab + two side walls per segment so
    exported scenes block movement off the bore (the reference collides
    via the room/tunnel walk area; cobjs are its export analog), packed
    on `device`."""
    from ..scene import cobj as SC
    from ..physics.cobjs import COLL_CUBE
    sp = SC.SceneParse()
    for t in segs:
        bc = t.bcube()
        wall = 0.1 * t.radius
        # floor
        sp.cobjs.append(SC.RawCobj(
            COLL_CUBE, (bc[0], bc[1], bc[2]),
            (bc[3], bc[4], bc[2] + wall)))
        # side walls along the run axis
        for side in (0, 1):
            lo = [bc[0], bc[1], bc[2]]
            hi = [bc[3], bc[4], bc[5]]
            if side == 0:
                hi[1 - t.dim] = bc[1 - t.dim] + wall
            else:
                lo[1 - t.dim] = bc[3 + (1 - t.dim)] - wall
            sp.cobjs.append(SC.RawCobj(
                COLL_CUBE, tuple(lo), tuple(hi)))
    return SC.pack_cobjs(sp, device=device)

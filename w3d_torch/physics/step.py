"""Batched physics step (port of `3dworld_tpu/physics/step.py`): the
`process_groups` / `dwobject::advance_object` hot loop
(build_world.cpp:310-600, Physics.cpp:716-1080) over all objects at once.

The object population is SoA tensors (`ObjectState`); one substep is a
function state -> state and a frame runs `substeps` of them.  With pair
collisions on, the state is sorted on x once per frame and the exact
banded sphere-pair pass runs over the sorted order every `pair_every`-th
substep.

Three hot pieces run as hand-written CUDA kernels behind the wrappers in
`ops/cuda/`: mesh sampling (`sample_kernel`), the static-cobj narrow phase
over a `GroupedCobjs` scene (`narrow_kernel`) and the banded pair pass
(`pairs_kernel`).  Their plain PyTorch versions are `sample_mesh` and
`banded_pair_collisions` here and `cobjs.deepest_hits_grouped`; the
wrappers take those for CPU tensors.  A plain `CobjSet` scene takes the
ungrouped `cobjs.deepest_hits` on every device, as the JAX package takes
its XLA version.  The glue around them is phases, each a kernel on the
card behind `ops/cuda/glue_kernel` and plain PyTorch here: a substep is
`advance`, the mesh sample, `contact`, the narrow phase, `respond` and,
on a pair substep, the pair pass and `apply_pairs`; a frame adds
`take_rows` (the sort's gather) and `age_objects`.

Reference quirk preserved: `advance_object`'s static-friction branch is
dead code — its condition is `!(flags | IN_WATER)` (always false,
Physics.cpp:826-829) — so the reference never applies it and neither do we.

`step_objects_fused` is the other frame path: one fused-substep kernel
launch (`ops/cuda/physics_kernel`, plain version `physics/fused`) per
substep in place of `_substep`'s phases, with the sort and the banded
pair pass between the launches.

`local_wind_field` is the batched local wind (plain PyTorch, as the JAX
package leaves it to XLA).  `morton_key` is the 2-D Z-order key the
universe's asteroid field sorts by.  Not ported: the Morton sort of the
object population, the grid, block and rowblock pair paths and
`spatial_sort_repair` (ROADMAP: left out).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..utils.constants import WorldConst, DEFAULT_WORLD
from ..utils.profiler import span
from . import graphs
from . import types as T
from .cobjs import CobjSet, GroupedCobjs, deepest_hits
from ..ops.cuda import glue_kernel as GL
from ..ops.cuda import narrow_kernel as NK
from ..ops.cuda import pairs_kernel as PK
from ..ops.cuda import physics_kernel as GK
from ..ops.cuda import sample_kernel as SK


class ObjectState(NamedTuple):
    """SoA dynamic object state (~ dwobject, physics_objects.h:150)."""

    px: torch.Tensor
    py: torch.Tensor
    pz: torch.Tensor
    vx: torch.Tensor
    vy: torch.Tensor
    vz: torch.Tensor
    status: torch.Tensor  # [N] int32: 0=dead, 1=airborne, 2=on mesh, 3=underwater-ground, 4=stopped
    flags: torch.Tensor   # [N] int32 FL_* bits
    otype: torch.Tensor   # [N] int32 object type id
    time: torch.Tensor    # [N] int32 frames alive
    health: torch.Tensor  # [N] f32


class PhysicsEnv(NamedTuple):
    """Per-step environment: terrain + water + wind (0-d tensors for the
    scalars, on the state's device)."""

    mesh_height: torch.Tensor   # [my, mx]
    water_plane_z: torch.Tensor # scalar flat-water level
    wind: torch.Tensor          # [3] global wind (Physics.cpp:36)
    temperature: torch.Tensor   # scalar degrees C
    base_gravity: torch.Tensor  # scalar (config "gravity")
    zmin: torch.Tensor          # kill plane
    # per-cell water surface (the reference's water_matrix, mesh.h:100):
    # objects see max(water_plane_z, water_height[cell]); None = flat water
    water_height: torch.Tensor | None = None


def make_state(pos, vel, otype, table: T.ObjTypeTable) -> ObjectState:
    """State for N objects at pos/vel [N, 3] of types otype [N], on the
    table's device."""
    dev = table.radius.device
    pos = torch.as_tensor(pos, dtype=torch.float32, device=dev)
    vel = torch.as_tensor(vel, dtype=torch.float32, device=dev)
    n = pos.shape[0]
    otype = torch.as_tensor(otype, dtype=torch.int32, device=dev)
    i32 = dict(dtype=torch.int32, device=dev)
    return ObjectState(
        px=pos[:, 0].contiguous(), py=pos[:, 1].contiguous(),
        pz=pos[:, 2].contiguous(),
        vx=vel[:, 0].contiguous(), vy=vel[:, 1].contiguous(),
        vz=vel[:, 2].contiguous(),
        status=torch.ones(n, **i32),
        flags=torch.zeros(n, **i32),
        otype=otype,
        time=torch.zeros(n, **i32),
        health=table.health[otype.long()],
    )


# ---------------------------------------------------------------------------
# mesh sampling (plain version of the sample kernel)
# ---------------------------------------------------------------------------

def sample_mesh(mesh: torch.Tensor, x, y, world: WorldConst):
    """Bilinear (height, normal-xyz) sample at world (x, y) for a batch —
    interpolate_mesh_zval + surface-normal lookup.

    Weights clamp to the border (floor clamped to [0, n-2], fraction to
    [0, 1]); the central-difference gradient maps wrap periodically at the
    border, as `jnp.roll` does in the JAX package.  Values contract y
    first, then x, each product and sum rounded on its own."""
    my, mx = mesh.shape
    gx = x * world.dx_inv + mx // 2
    gy = y * world.dy_inv + my // 2
    x0 = torch.clamp(torch.floor(gx).long(), 0, mx - 2)
    y0 = torch.clamp(torch.floor(gy).long(), 0, my - 2)
    fx = torch.clamp(gx - x0.float(), 0.0, 1.0)
    fy = torch.clamp(gy - y0.float(), 0.0, 1.0)
    wx0, wy0 = 1.0 - fx, 1.0 - fy

    def interp(m):
        c0 = m[y0, x0] * wy0 + m[y0 + 1, x0] * fy
        c1 = m[y0, x0 + 1] * wy0 + m[y0 + 1, x0 + 1] * fy
        return c0 * wx0 + c1 * fx

    h, sx, sy = (interp(m) for m in GK.mesh_maps(mesh, world).view(3, my, mx))
    inv = torch.rsqrt(sx * sx + sy * sy + 1.0)
    return h, -sx * inv, -sy * inv, inv  # (height, nx, ny, nz)


def outside_mesh(x, y, world: WorldConst):
    my, mx = world.mesh_y, world.mesh_x
    gx = x * world.dx_inv + mx // 2
    gy = y * world.dy_inv + my // 2
    return (gx < 0) | (gx >= mx) | (gy < 0) | (gy >= my)


# ---------------------------------------------------------------------------
# bounce (dwobject::object_bounce, Physics.cpp:1349-1409), componentized
# ---------------------------------------------------------------------------

def bounce_velocity(vx, vy, vz, nx, ny, nz, elasticity, air_factor):
    """(bounced vx,vy,vz, did_bounce).  Reflect about the normal
    (calc_reflection_angle); xy scaled by e*(1-air), z by e; bounce only
    sticks if post-bounce |v|^2 >= BOUNCE_CUTOFF (Physics.cpp:1391-1409)."""
    e = torch.clamp(elasticity, 0.0, 1.0)
    vdotn = vx * nx + vy * ny + vz * nz
    bx = vx - 2.0 * vdotn * nx
    by = vy - 2.0 * vdotn * ny
    bz = vz - 2.0 * vdotn * nz
    exy = e * (1.0 - air_factor)
    bx, by, bz = bx * exy, by * exy, bz * e
    did = (bx * bx + by * by + bz * bz) >= T.BOUNCE_CUTOFF
    return (torch.where(did, bx, vx), torch.where(did, by, vy),
            torch.where(did, bz, vz), did)


# ---------------------------------------------------------------------------
# sorted-order broad phase + banded pairs
# ---------------------------------------------------------------------------

def spatial_sort(state: ObjectState) -> ObjectState:
    """Sort the population on x; dead objects sort last so the active
    prefix stays dense.  Contacts then sit within a sorted-order window
    bounded by the occupancy of an rsum-wide x slab, so the banded pair
    pass with window=PAIR_WINDOW is exact for realistic densities.  The
    order of dead objects (all keyed +inf) is unspecified, as in the JAX
    package."""
    k = torch.where(state.status > 0, state.px, float("inf"))
    idx = torch.sort(k, stable=True).indices
    return GL.take_rows(state, idx)


def take_rows(state: ObjectState, idx: torch.Tensor) -> ObjectState:
    """Every column of `state` at the rows `idx`."""
    return ObjectState(*(col[idx] for col in state))


# banded window over the x-sorted order: must exceed the max occupancy of
# an rsum-wide x slab (247 measured at 10K pile density in the JAX package)
PAIR_WINDOW = 288


def _part1by1(v: torch.Tensor) -> torch.Tensor:
    """Interleave a 16-bit value with zeros (Morton helper), on int64
    lanes holding uint32 values: the JAX package's uint32 shifts and masks,
    which give the same bits."""
    v = v & 0x0000FFFF
    v = (v | (v << 8)) & 0x00FF00FF
    v = (v | (v << 4)) & 0x0F0F0F0F
    v = (v | (v << 2)) & 0x33333333
    v = (v | (v << 1)) & 0x55555555
    return v


def morton_key(px: torch.Tensor, py: torch.Tensor, cell: float,
               half_extent: float) -> torch.Tensor:
    """2-D Morton (Z-order) cell key, a spatially local sort order: the
    cell coordinates truncated toward zero as int32, clipped to [0, 0xFFFF]
    and interleaved.  int64 values in [0, 2^32), equal to the JAX
    package's uint32 keys, so the sort order is the same."""
    cx = torch.clamp(((px + half_extent) / cell).to(torch.int32), 0, 0xFFFF).to(torch.int64)
    cy = torch.clamp(((py + half_extent) / cell).to(torch.int32), 0, 0xFFFF).to(torch.int64)
    return _part1by1(cx) | (_part1by1(cy) << 1)


def banded_pair_collisions(px, py, pz, vx, vy, vz, radius, mass, elas, active,
                           window: int = 64, i_limit: int | None = None):
    """Plain version of the pair kernel: collisions against the `window`
    nearest sorted-order neighbours.

    For each offset d in 1..window compare row i with row i+d: mass-weighted
    push-out of overlapping pairs plus a restitution impulse at min(elas)
    when they approach, added to i and subtracted from i+d.  `i_limit`
    restricts the i side of every pair to ranks < i_limit (the sharded
    halo pass uses it).
    """
    n = px.shape[0]
    ilim = n if i_limit is None else i_limit
    act = active.to(px.dtype)
    idx = torch.arange(n, device=px.device)
    dpx, dpy, dpz = (torch.zeros_like(px) for _ in range(3))
    dvx, dvy, dvz = (torch.zeros_like(px) for _ in range(3))
    for d in range(1, window + 1):
        sh = lambda a: torch.roll(a, -d, 0)      # row i+d on row i
        ex = px - sh(px)
        ey = py - sh(py)
        ez = pz - sh(pz)
        d2 = torch.clamp(ex * ex + ey * ey + ez * ez, min=1e-12)
        dist = torch.sqrt(d2)
        rsum = radius + sh(radius)
        valid = (idx < min(ilim, n - d)) & (act > 0) & (sh(act) > 0)
        hit = valid & (dist < rsum)
        pen = torch.where(hit, rsum - dist, 0.0)
        m_i, m_j = mass, sh(mass)
        mw_i = m_j / (m_i + m_j)        # push weight on i
        mw_j = m_i / (m_i + m_j)
        push_i = pen * mw_i / dist      # coeff on (p_i - p_j)
        push_j = pen * mw_j / dist
        relv = ((vx - sh(vx)) * ex + (vy - sh(vy)) * ey + (vz - sh(vz)) * ez) / d2
        eij = torch.minimum(elas, sh(elas))
        a = torch.where(hit & (relv < 0), -(1.0 + eij) * relv, 0.0)
        ai = a * mw_i
        aj = a * mw_j
        unsh = lambda v: torch.roll(v, d, 0)  # accumulate back onto row i+d
        dpx = dpx + push_i * ex - unsh(push_j * ex)
        dpy = dpy + push_i * ey - unsh(push_j * ey)
        dpz = dpz + push_i * ez - unsh(push_j * ez)
        dvx = dvx + ai * ex - unsh(aj * ex)
        dvy = dvy + ai * ey - unsh(aj * ey)
        dvz = dvz + ai * ez - unsh(aj * ez)
    return dpx, dpy, dpz, dvx, dvy, dvz


# ---------------------------------------------------------------------------
# static-cobj narrow phase
# ---------------------------------------------------------------------------

def cobj_hits(px, py, pz, radius, cobjs: CobjSet | GroupedCobjs):
    """(hit, pen, nx, ny, nz, elas, fric), each [N]: every sphere's deepest
    cobj hit.  A shape-grouped scene takes the narrow-phase kernel on the
    card; a plain CobjSet the all-shapes select on every device (the JAX
    package's XLA path)."""
    if isinstance(cobjs, GroupedCobjs):
        return NK.deepest_hits(px, py, pz, radius, cobjs)
    return deepest_hits(px, py, pz, radius, cobjs)


# ---------------------------------------------------------------------------
# per-type parameter fetch
# ---------------------------------------------------------------------------

def _type_params(otype, table: T.ObjTypeTable):
    """(radius, air, friction, gravity, elasticity, density, terminal_vel,
    mass, lifetime) per object, gathered by type id."""
    cols = torch.stack([table.radius, table.air_factor, table.friction,
                        table.gravity, table.elasticity, table.density,
                        table.terminal_vel, table.mass,
                        table.lifetime.to(torch.float32)], dim=1)
    return tuple(cols[otype.long()].T.contiguous())


# ---------------------------------------------------------------------------
# one substep, in phases
# ---------------------------------------------------------------------------

class Moved(NamedTuple):
    """A substep after `advance`, before the mesh sample: the moved state
    and what `contact` reads of the entry state."""

    px: torch.Tensor
    py: torch.Tensor
    pz: torch.Tensor
    vx: torch.Tensor
    vy: torch.Tensor
    vz: torch.Tensor
    status: torch.Tensor    # the entry status
    flags: torch.Tensor
    rad: torch.Tensor
    air_eff: torch.Tensor
    vz_old: torch.Tensor    # vz after the Z_STOPPED clause, before gravity
    alive: torch.Tensor     # the entry status's sets
    moving: torch.Tensor
    grounded: torch.Tensor
    z_stop: torch.Tensor    # the entry flags' bits (Z_STOPPED as the clause left it)
    xy_stop: torch.Tensor
    underwater: torch.Tensor
    in_water: torch.Tensor


class Carry(NamedTuple):
    """A substep from `contact` on (through the narrow phase, `respond`,
    the pair pass and `apply_pairs`): the moving state so far and what the
    later phases read of the earlier ones."""

    px: torch.Tensor
    py: torch.Tensor
    pz: torch.Tensor
    vx: torch.Tensor
    vy: torch.Tensor
    vz: torch.Tensor
    status: torch.Tensor
    flags: torch.Tensor
    rad: torch.Tensor       # per-object radius (the narrow and pair phases')
    mh: torch.Tensor        # mesh height and normal under the moved object
    mnx: torch.Tensor
    mny: torch.Tensor
    mnz: torch.Tensor
    alive: torch.Tensor     # the entry status's sets
    moving: torch.Tensor
    grounded: torch.Tensor
    xy_stop: torch.Tensor   # the entry flags' bits
    in_water: torch.Tensor
    off_mesh: torch.Tensor
    on_mesh: torch.Tensor
    touches_water: torch.Tensor  # the water block's sets (none without water)
    wcoll: torch.Tensor
    ice_touch: torch.Tensor


def _substep(state: ObjectState, env: PhysicsEnv,
             cobjs: CobjSet | GroupedCobjs | None,
             table: T.ObjTypeTable, tstep: float, world: WorldConst,
             run_pairs: bool, pair_window: int = PAIR_WINDOW,
             water: bool = True, pair_fn=None) -> ObjectState:
    """One substep of length `tstep`.  `pair_fn(px, py, pz, vx, vy, vz,
    radius, mass, elas, active)`, when given, computes the pair deltas in
    place of the banded pass over the whole population (the sharded frame
    passes its halo pair pass, `parallel/pairs.make_halo_pair_fn`).

    The phases around the mesh sample, the narrow phase and the pair pass
    go through `ops/cuda/glue_kernel`: their plain versions below on the
    CPU, one kernel each on the card."""
    m = GL.advance(state, env, table, tstep, world)
    with span("kernel.sample"):
        mesh = SK.sample_mesh(env.mesh_height, m.px, m.py, world)
    wh = None
    if water and env.water_height is not None:
        with span("kernel.sample"):
            wh = SK.sample_mesh(env.water_height, m.px, m.py, world)[0]
    c = GL.contact(m, mesh, wh, state.otype, env, table, tstep, world, water)
    hits = None
    if cobjs is not None and cobjs.size > 0:
        with span("kernel.narrow"):
            hits = cobj_hits(c.px, c.py, c.pz, c.rad, cobjs)
    c, pair_in = GL.respond(c, state.otype, hits, env, table, tstep, world, water,
                            run_pairs)
    if run_pairs:
        mass, elas, act = pair_in
        cols = (c.px, c.py, c.pz, c.vx, c.vy, c.vz, c.rad, mass, elas, act)
        if pair_fn is None:
            with span("kernel.pairs"):
                deltas = PK.banded_pairs(*cols, window=pair_window)
        else:
            deltas = pair_fn(*cols)
        c = GL.apply_pairs(c, act, deltas, env)
    return state._replace(px=c.px, py=c.py, pz=c.pz, vx=c.vx, vy=c.vy, vz=c.vz,
                          status=c.status, flags=c.flags)


def advance(state: ObjectState, env: PhysicsEnv, table: T.ObjTypeTable,
            tstep: float, world: WorldConst) -> Moved:
    """The substep up to the mesh sample: air factor, Z_STOPPED, gravity,
    wind, drag and the move."""
    rad, air, fric, grav, _elas, dens, tv, _mass, _life = _type_params(state.otype, table)

    alive = state.status > 0
    # capture + clear last-substep collision (advance_object entry,
    # Physics.cpp:720-721: coll_last_frame then flags &= ~OBJ_COLLIDED)
    coll_last = (state.flags & T.FL_COLLIDED) != 0
    flags = state.flags & ~T.FL_COLLIDED
    floating = (flags & T.FL_FLOATING) != 0
    z_stop = (flags & T.FL_Z_STOPPED) != 0
    xy_stop = (flags & T.FL_XY_STOPPED) != 0
    underwater = (flags & T.FL_UNDERWATER) != 0
    in_water = (flags & T.FL_IN_WATER) != 0
    # the reference's airborne branch is status==1 only; 2/3 take the
    # on-ground surface_advance path below (Physics.cpp:755,901)
    moving = alive & (state.status == 1)
    grounded = alive & ((state.status == 2) | (state.status == 3))

    px, py, pz = state.px, state.py, state.pz
    vx, vy, vz = state.vx, state.vy, state.vz

    # air factor (Physics.cpp:760-774)
    air_eff = torch.where(underwater, 0.0,
                          torch.where(floating, (1.0 - T.WATER_SURF_FRICTION) * air, air))

    # Z_STOPPED clause (Physics.cpp:774-785), BEFORE the collided flag and
    # vz_old capture: above the water line with low friction the flag
    # clears (object resumes falling); otherwise vz is zeroed
    unstop = z_stop & moving & ((pz - rad) > env.water_plane_z) \
        & (fric < 2.0 * T.STICK_THRESHOLD)
    z_stop = z_stop & ~unstop
    flags = torch.where(unstop, flags & ~T.FL_Z_STOPPED, flags)
    vz = torch.where(z_stop & moving, 0.0, vz)
    # collided flag + vz_old captured POST-zero, PRE-gravity
    # (Physics.cpp:787-789); vz_old feeds the buoyant deep-float branch
    collided = coll_last | (torch.abs(vz) < 1.0e-6)
    vz_old = vz

    # gravity with terminal velocity (Physics.cpp:795-819); objects denser
    # than water sink with reduced gravity (gscale, :798)
    gscale = torch.where(in_water & (dens > T.WATER_DENSITY),
                         (dens - T.WATER_DENSITY) / dens, 1.0)
    can_fall = moving & ~z_stop
    vz_new = torch.where(-vz < tv,
                         torch.maximum(vz - env.base_gravity * gscale * T.GRAVITY
                                       * tstep * grav, -tv),
                         vz)
    vz = torch.where(can_fall, vz_new, vz)
    # wind (Physics.cpp:820-833): xy drag relaxes toward vtot = v + wind
    # (wind skipped when collided last frame); z adds wind directly
    wx, wy, wz = env.wind[0], env.wind[1], env.wind[2]
    vz = torch.where(can_fall & ((torch.abs(air_eff * wz) > torch.abs(vz))
                                 | ((wz < 0) != (vz < 0))),
                     vz + air_eff * wz, vz)
    move_xy = moving & ~xy_stop

    def drag(v, w):
        vtot = v + torch.where(collided, 0.0, w)
        c = (torch.abs(air_eff * vtot) > torch.abs(v)) | ((vtot < 0) != (v < 0))
        return torch.where(c & move_xy, (1.0 - air_eff) * v + air_eff * vtot, v)

    vx = drag(vx, wx)
    vy = drag(vy, wy)

    px = px + torch.where(move_xy, tstep * vx, 0.0)
    py = py + torch.where(move_xy, tstep * vy, 0.0)
    pz = pz + torch.where(moving, tstep * vz, 0.0)
    return Moved(px=px, py=py, pz=pz, vx=vx, vy=vy, vz=vz, status=state.status,
                 flags=flags, rad=rad, air_eff=air_eff, vz_old=vz_old, alive=alive,
                 moving=moving, grounded=grounded, z_stop=z_stop, xy_stop=xy_stop,
                 underwater=underwater, in_water=in_water)


def contact(m: Moved, mesh: tuple, wh, otype: torch.Tensor, env: PhysicsEnv,
            table: T.ObjTypeTable, tstep: float, world: WorldConst,
            water: bool) -> Carry:
    """The substep from the mesh sample `mesh` (height, nx, ny, nz under the
    moved objects) to the narrow phase: outside and on the mesh, the water
    and ice block (`water=False`, the scene's disable_water, skips it) at
    the level max(water plane, `wh`), `wh` the water map's sample or None."""
    _rad, _air, _fric, _grav, elas, dens, _tv, _mass, _life = _type_params(otype, table)
    px, py, pz, vx, vy, vz = m.px, m.py, m.pz, m.vx, m.vy, m.vz
    flags, rad, alive, z_stop = m.flags, m.rad, m.alive, m.z_stop
    air_eff, underwater, vz_old = m.air_eff, m.underwater, m.vz_old
    mh, mnx, mny, mnz = mesh

    # --- mesh surface ---
    off_mesh = outside_mesh(px, py, world)
    on_mesh = ~off_mesh & ((pz - rad) <= mh)

    # --- water (check_water_collision core, Physics.cpp:1082-1180); the
    # per-object level comes from water_matrix when a per-cell map exists ---
    status = m.status
    touches_water = torch.zeros_like(alive)
    wcoll = touches_water
    ice_touch = touches_water
    if water:
        wpz = env.water_plane_z if wh is None else torch.maximum(env.water_plane_z, wh)
        over_water = ~off_mesh & (wpz > mh)
        touches_water = over_water & ((pz - rad) < wpz) & alive
        # frozen water becomes an ice SURFACE (Physics.cpp:1198-1218)
        frozen = env.temperature <= T.W_FREEZE_POINT
        ice_touch = touches_water & frozen
        touches_water = touches_water & ~frozen
        v_sq = vx * vx + vy * vy + vz * vz
        # slow branch also taken when Z_STOPPED regardless of speed
        # (Physics.cpp:1117)
        fast = (v_sq >= T.BOUNCE_CUTOFF) & ~z_stop
        den_ratio = T.WATER_DENSITY / (dens + T.WATER_DENSITY)
        damp = 1.0 - T.WATER_DAMPING * den_ratio
        floats = dens < T.WATER_DENSITY
        w_fast = touches_water & fast
        w_slow = touches_water & ~fast
        # surface skip / ricochet (Physics.cpp:1154-1163): fast shallow-angle
        # surface hits bounce off the water instead of entering
        v_mag = torch.sqrt(torch.clamp(v_sq, min=1e-12))
        coll_angle = torch.acos(torch.clamp(-vz / v_mag, -1.0, 1.0))
        zpos_w = torch.maximum(wpz + rad * (1.0 - 2.0 * dens), mh + rad)
        surf_coll = (pz > wpz - rad - T.MAX_SPLASH_DEPTH) & ~underwater & ~z_stop
        ones = torch.ones_like(vx)
        sbx, sby, sbz, s_did = bounce_velocity(vx, vy, vz, 0.0, 0.0, ones,
                                               T.WATER_ELASTIC * ones, air_eff)
        skip = (w_fast & surf_coll & (coll_angle >= T.CRITICAL_ANGLE / den_ratio)
                & ((zpos_w - pz) <= 6.0 * rad) & s_did)
        w_fast = w_fast & ~skip
        vx = torch.where(skip, sbx, torch.where(w_fast, vx * damp, vx))
        vy = torch.where(skip, sby, torch.where(w_fast, vy * damp, vy))
        vz = torch.where(skip, sbz,
                         torch.where(w_fast, torch.where(floats, 0.0, vz * damp), vz))
        touches_water = touches_water & ~skip
        flags = torch.where(touches_water, flags | T.FL_IN_WATER, flags)
        # fast floaters enter Z_STOPPED|FLOATING (Physics.cpp:1171-1173)
        flags = torch.where(w_fast & floats,
                            flags | (T.FL_Z_STOPPED | T.FL_FLOATING), flags)
        flags = torch.where(w_fast & ~floats, flags | T.FL_UNDERWATER, flags)
        ground_z = mh + rad
        zpos_f = zpos_w
        # slow branch (Physics.cpp:1117-1151): floaters more than 2r below
        # their float height rise buoyantly; shallow floaters snap to
        # zpos + 0.001; sinkers above the bottom damp by dens/(dens+WATER)
        f_deep = w_slow & floats & ((zpos_f - pz) > 2.0 * rad)
        f_snap = w_slow & floats & ~((zpos_f - pz) > 2.0 * rad)
        buoy_vz = vz_old - ((dens - T.WATER_DENSITY) / dens) \
            * env.base_gravity * T.GRAVITY * tstep
        sink = w_slow & ~floats
        s_damp = sink & (pz > ground_z + 1e-5)
        s_rest = sink & ~(pz > ground_z + 1e-5)
        sink_f = dens / (dens + T.WATER_DENSITY)
        vx = torch.where(f_snap | s_rest, 0.0, torch.where(s_damp, vx * sink_f, vx))
        vy = torch.where(f_snap | s_rest, 0.0, torch.where(s_damp, vy * sink_f, vy))
        vz = torch.where(f_snap | s_rest, 0.0,
                         torch.where(s_damp, vz * sink_f,
                                     torch.where(f_deep, buoy_vz, vz)))
        pz = torch.where(f_snap, zpos_f + 0.001, torch.where(s_rest, ground_z, pz))
        flags = torch.where(f_deep, flags | T.FL_Z_STOPPED, flags)
        flags = torch.where(f_snap, flags | T.FL_FLOATING, flags)
        # float-branch status (Physics.cpp:1130-1140)
        w_float = w_slow & floats
        air_or_mesh = (m.status == 1) | (m.status == 2)
        edge_st = torch.where(air_or_mesh, 3, 4).to(torch.int32)
        status = torch.where(w_float, torch.where(pz > ground_z, 1, edge_st),
                             m.status)
        status = torch.where(s_rest, 3, status)
        # fast underwater ground contact: status 3 only, no snap
        hit_bottom = w_fast & ~floats & (pz <= ground_z + 1e-5)
        status = torch.where(hit_bottom, 3, status)
        # water-HANDLED set (check_water_collision returned 1); the other
        # paths continue into the mesh/cobj collision handling below
        edge3 = w_float & ~(pz > ground_z) & air_or_mesh
        wcoll = touches_water & ~edge3 & ~s_rest & ~hit_bottom

        # ice surface: sit at wpz + radius + 0.001; bounce only for
        # elasticity >= ICE_BOUNCE_ELAS, otherwise stuck to the ice
        ibx, iby, ibz, idid = bounce_velocity(vx, vy, vz, 0.0, 0.0, ones,
                                              elas * T.ICE_ELASTICITY, air_eff)
        stick = ice_touch & ((elas < T.ICE_BOUNCE_ELAS) | ~idid)
        bounce_ice = ice_touch & ~stick
        pz = torch.where(ice_touch, wpz + rad + 0.001, pz)
        vx = torch.where(stick, 0.0, torch.where(bounce_ice, ibx, vx))
        vy = torch.where(stick, 0.0, torch.where(bounce_ice, iby, vy))
        vz = torch.where(stick, 0.0, torch.where(bounce_ice, ibz, vz))
        status = torch.where(stick, 4, torch.where(bounce_ice, 1, status))
        flags = torch.where(stick, flags | (T.FL_Z_STOPPED | T.FL_XY_STOPPED
                                            | T.FL_IS_ON_ICE), flags)

    return Carry(px=px, py=py, pz=pz, vx=vx, vy=vy, vz=vz, status=status, flags=flags,
                 rad=rad, mh=mh, mnx=mnx, mny=mny, mnz=mnz, alive=alive, moving=m.moving,
                 grounded=m.grounded, xy_stop=m.xy_stop, in_water=m.in_water,
                 off_mesh=off_mesh, on_mesh=on_mesh, touches_water=touches_water,
                 wcoll=wcoll, ice_touch=ice_touch)


def respond(c: Carry, otype: torch.Tensor, hits, env: PhysicsEnv,
            table: T.ObjTypeTable, tstep: float, world: WorldConst, water: bool,
            pairs: bool):
    """The substep from the narrow phase's `hits` (None: no cobjs) to the
    pair pass: cobj response, water tail, mesh bounce, rolling.  Returns
    (Carry, None) after the kill conditions, or with `pairs` (Carry,
    (mass, elas, active)) for the pair pass, the kill conditions left to
    `apply_pairs`."""
    _rad, air, fric, _grav, elas, dens, _tv, mass, _life = _type_params(otype, table)
    rad, alive, moving, wcoll = c.rad, c.alive, c.moving, c.wcoll
    mh, mnx, mny, mnz = c.mh, c.mnx, c.mny, c.mnz
    px, py, pz, vx, vy, vz = c.px, c.py, c.pz, c.vx, c.vy, c.vz
    status, flags = c.status, c.flags

    # --- static cobj collisions ---
    cobj_hit = torch.zeros_like(alive)
    if hits is not None:
        hit, pen, cnx, cny, cnz, celas, cfric = hits
        hit = hit & alive & ~wcoll
        px = px + torch.where(hit, pen * cnx, 0.0)
        py = py + torch.where(hit, pen * cny, 0.0)
        pz = pz + torch.where(hit, pen * cnz, 0.0)
        bx, by, bz, did = bounce_velocity(vx, vy, vz, cnx, cny, cnz, elas * celas, air)
        # fresh speed: the water/ice block may have rewritten the velocity
        v_sq_c = vx * vx + vy * vy + vz * vz
        stop = hit & ~did & ((torch.maximum(fric, cfric) >= T.STICK_THRESHOLD)
                             | (v_sq_c < T.BOUNCE_CUTOFF))
        hd = hit & did
        vx = torch.where(hd, bx, torch.where(stop, 0.0, vx))
        vy = torch.where(hd, by, torch.where(stop, 0.0, vy))
        vz = torch.where(hd, bz, torch.where(stop, 0.0, vz))
        status = torch.where(stop, 4, torch.where(hd, 1, status))
        flags = torch.where(hit, flags | (T.FL_STATIC_COBJ_COLL | T.FL_COLLIDED), flags)
        cobj_hit = hit

    if water:
        # no cobj collision this substep -> Z_STOPPED clears
        # (Physics.cpp:861); ice-stuck objects keep their flags
        clr = moving & ~cobj_hit & ~c.ice_touch
        flags = torch.where(clr, flags & ~T.FL_Z_STOPPED, flags)
        # water-HANDLED objects: status 1, stop flags clear (Physics.cpp:863-867)
        status = torch.where(wcoll, 1, status)
        flags = torch.where(wcoll, flags & ~T.FL_ALL_COLL_STOPPED, flags)

    # --- mesh bounce (airborne val==2 && !coll path, Physics.cpp:868-882) ---
    mesh_coll = c.on_mesh & moving & ~wcoll & ~cobj_hit
    pz = torch.where(mesh_coll, torch.maximum(pz, mh + rad), pz)
    bx, by, bz, did_m = bounce_velocity(vx, vy, vz, mnx, mny, mnz,
                                        elas * T.LAND_ELASTICITY, air)
    v_sq2 = vx * vx + vy * vy + vz * vz
    stopped_m = mesh_coll & ~did_m & ((fric >= T.STICK_THRESHOLD) | c.xy_stop
                                      | (v_sq2 < T.BOUNCE_CUTOFF))
    md = mesh_coll & did_m
    damp_m = torch.where(stopped_m, 0.0, 0.95)
    vx = torch.where(md, bx, torch.where(mesh_coll, vx * damp_m, vx))
    vy = torch.where(md, by, torch.where(mesh_coll, vy * damp_m, vy))
    vz = torch.where(md, bz, torch.where(mesh_coll, vz * damp_m, vz))
    status = torch.where(md, 1, torch.where(mesh_coll, 2, status))
    # mesh contact does NOT set the collided flag: only cobj collisions do
    # (collision_detect.cpp:1561, build_world.cpp:292)

    # --- on-ground rolling (surface_advance, Physics.cpp:980-1037) ---
    roll_ok = c.grounded & ~cobj_hit & ~c.touches_water
    stick_g = (fric >= T.STICK_THRESHOLD) | c.xy_stop
    killed_g = roll_ok & (pz < mh - T.KILL_DEPTH * rad)
    pz = torch.where(roll_ok & (pz < mh - T.RECOVER_DEPTH * rad), mh, pz)
    dzn = torch.sqrt(torch.clamp(mnx * mnx + mny * mny, min=1.0e-20))
    vel_m = ((T.SURF_ADV_STEP / world.x_scene) * dzn
             * (1.0 - 0.5 * fric) / T.DEF_TIMESTEP)
    vel_m = torch.where(c.in_water & (dens >= T.WATER_DENSITY),
                        vel_m * (dens - T.WATER_DENSITY) / torch.clamp(dens, min=1e-9),
                        vel_m)
    moved_g = (dzn > 1.0e-12) & (dzn > fric) & (vel_m > 1.0e-12)
    mvx = torch.where(moved_g, vel_m * world.dx * mnx / dzn, 0.0)
    mvy = torch.where(moved_g, vel_m * world.dy * mny / dzn, 0.0)
    vmult = torch.clamp(1.0 - fric, min=0.0)          # (1-friction)^fticks
    gvx = mvx * (1.0 - vmult) + vx * vmult
    gvy = mvy * (1.0 - vmult) + vy * vmult
    rolling = roll_ok & ~stick_g
    vx = torch.where(rolling, gvx, torch.where(roll_ok & stick_g, 0.0, vx))
    vy = torch.where(rolling, gvy, torch.where(roll_ok & stick_g, 0.0, vy))
    vz = torch.where(roll_ok, 0.0, vz)
    px = px + torch.where(rolling, gvx * tstep, 0.0)
    py = py + torch.where(rolling, gvy * tstep, 0.0)
    pz = torch.where(roll_ok, mh + rad, pz)
    # val==1 (no slope motion) -> stopped; val==2 -> status 3 (moving)
    settled = roll_ok & (stick_g | ~moved_g)
    vx = torch.where(settled, 0.0, vx)
    vy = torch.where(settled, 0.0, vy)
    status = torch.where(settled, 4, torch.where(rolling & moved_g, 3, status))
    status = torch.where(killed_g, 0, status)

    out = c._replace(px=px, py=py, pz=pz, vx=vx, vy=vy, vz=vz, flags=flags)
    if pairs:
        # dynamic object-object collisions (sorted-band broad phase) next
        return out._replace(status=status), (mass, elas, alive & (rad >= T.LARGE_OBJ_RAD))
    return out._replace(status=_kill(status, pz, c.off_mesh, alive, env)), None


def apply_pairs(c: Carry, act: torch.Tensor, deltas, env: PhysicsEnv) -> Carry:
    """The pair pass's deltas on the active objects, the wake of stopped
    ones, then the kill conditions."""
    (px, py, pz, vx, vy, vz), status = _add_pair_deltas(
        (c.px, c.py, c.pz, c.vx, c.vy, c.vz), c.status, act, deltas)
    return c._replace(px=px, py=py, pz=pz, vx=vx, vy=vy, vz=vz,
                      status=_kill(status, pz, c.off_mesh, c.alive, env))


def _add_pair_deltas(xyz: tuple, status, act, deltas):
    """(px, py, pz, vx, vy, vz) plus the pair deltas on the active
    objects, and `status` with the stopped ones they move woken."""
    out = tuple(v + torch.where(act, d, 0.0) for v, d in zip(xyz, deltas))
    dvx, dvy, dvz = deltas[3:]
    woke = act & ((dvx * dvx + dvy * dvy + dvz * dvz) > 1e-10)
    return out, torch.where(woke & (status == 4), 1, status)


def _kill(status, pz, off_mesh, alive, env: PhysicsEnv):
    """Kill conditions (advance_object preamble, Physics.cpp:725-729)."""
    status = torch.where(pz < env.zmin, 0, status)
    return torch.where(off_mesh & alive, 0, status)


def step_objects(
    state: ObjectState,
    env: PhysicsEnv,
    cobjs: CobjSet | GroupedCobjs | None,
    table: T.ObjTypeTable,
    tstep: float = T.DEF_TIMESTEP,
    substeps: int = 4,
    world: WorldConst = DEFAULT_WORLD,
    obj_collisions: bool = True,
    pair_window: int = PAIR_WINDOW,
    pair_every: int = 1,
    water: bool = True,
) -> ObjectState:
    """One frame: `substeps` uniform substeps with dt = tstep/substeps (the
    reference runs 1-40 substeps by type, build_world.cpp:467-505).  With
    pair collisions on, the state is x-sorted once per frame and the exact
    banded pair pass runs on substeps 0, pair_every, 2*pair_every, ...
    (pair_every=substeps matches the reference's once-per-frame cadence,
    build_world.cpp:397-404,526-543).

    On the card the frame goes through `physics/graphs`: once its key
    repeats on two calls in a row, it is captured into a CUDA graph and
    replayed, bit for bit the eager frame."""
    dt = float(torch.tensor(tstep / substeps, dtype=torch.float32))

    def frame(b: dict) -> None:
        state, env = b["state"], b["env"]
        if obj_collisions:
            with span("physics.sort"):
                state = spatial_sort(state)
        for k in range(substeps):
            run_pairs = obj_collisions and (pair_every <= 1 or k % pair_every == 0)
            with span("physics.substep"):
                state = _substep(state, env, cobjs, table, dt, world, run_pairs,
                                 pair_window=pair_window, water=water)
        b["state"] = GL.age_objects(state, table)

    key = held = None
    if graphs.capturable(state, env):
        key = graphs.frame_key(state, env, cobjs, table, tstep=tstep,
                               substeps=substeps, world=world,
                               obj_collisions=obj_collisions,
                               pair_window=pair_window, pair_every=pair_every,
                               water=water)
        held = graphs.refs(cobjs, table)
    return graphs.FRAMES.run(key, [(None, frame)], {"state": state, "env": env},
                             ("state",), held)[0]


def age_objects(state: ObjectState, table: T.ObjTypeTable) -> ObjectState:
    """Age + lifetime kill (advance_object preamble)."""
    life = _type_params(state.otype, table)[8]
    time = state.time + 1
    status = torch.where((life > 0) & (time.to(torch.float32) > life), 0,
                         state.status)
    return state._replace(time=time, status=status)


# ---------------------------------------------------------------------------
# fused-kernel frame path (ops/cuda/physics_kernel)
# ---------------------------------------------------------------------------

def step_objects_fused(
    state: ObjectState,
    env: PhysicsEnv,
    cobjs: GroupedCobjs,
    table: T.ObjTypeTable,
    tstep: float = T.DEF_TIMESTEP,
    substeps: int = 4,
    world: WorldConst = DEFAULT_WORLD,
    obj_collisions: bool = True,
    pair_every: int = 1,
) -> ObjectState:
    """`step_objects` with the per-substep pipeline (integrate -> mesh ->
    water -> cobjs -> mesh bounce -> rolling) fused into one kernel launch;
    the x sort and the banded pair pass run between the launches.

    Semantics are the fused kernel's (see `physics/fused`): penetration
    ties average, there is no ice branch (use `step_objects` below
    freezing), the water level is `env.water_plane_z` alone
    (`env.water_height` is not read), and the cobj narrow phase always
    runs."""
    if obj_collisions:
        state = spatial_sort(state)
    rad, air, fric, grav, elas, dens, tv, mass, _life = _type_params(state.otype, table)
    maps3 = GK.mesh_maps(env.mesh_height, world)
    tables = NK.kernel_tables(cobjs)
    f32 = dict(dtype=torch.float32, device=state.px.device)
    env12 = torch.cat([torch.tensor([tstep / substeps], **f32),
                       env.base_gravity.reshape(1), env.wind.reshape(3),
                       env.water_plane_z.reshape(1),
                       torch.tensor([world.dx_inv, world.dy_inv, world.x_scene,
                                     world.dx, world.dy, 0.0], **f32)])
    act_rad = rad >= T.LARGE_OBJ_RAD
    s = state
    for k in range(substeps):
        px, py, pz, vx, vy, vz, status, flags = GK.substep(
            s.px, s.py, s.pz, s.vx, s.vy, s.vz, s.status, s.flags,
            rad, air, fric, grav, elas, dens, tv, maps3, tables, env12)
        alive = s.status > 0
        # off-mesh kill tests the position before the pair pass
        off = outside_mesh(px, py, world)
        if obj_collisions and (pair_every <= 1 or k % pair_every == 0):
            act = alive & act_rad
            deltas = PK.banded_pairs(px, py, pz, vx, vy, vz, rad, mass, elas, act,
                                     window=PAIR_WINDOW)
            (px, py, pz, vx, vy, vz), status = _add_pair_deltas(
                (px, py, pz, vx, vy, vz), status, act, deltas)
        s = s._replace(px=px, py=py, pz=pz, vx=vx, vy=vy, vz=vz,
                       status=_kill(status, pz, off, alive, env), flags=flags)
    return GL.age_objects(s, table)


def local_wind_field(px, py, pz, wind, mesh, world: WorldConst,
                     zbottom, ztop, t_offset=0.0, seed: int = 0):
    """Batched get_local_wind (Physics.cpp:649-676): under the mesh no
    wind; near the surface the wind follows the terrain contour
    (orthogonalized against the vertex normal, z damped 10x) blended by
    (1 - rel_height)^2; pressure rises over hills; spatial intensity
    modulates by a drifting hashed cell noise (the WIND_TEX lookup), the
    cell hash in uint32 arithmetic as the JAX package's."""
    from ..utils import rng as w3d_rng
    dev = px.device
    f32 = lambda v: torch.as_tensor(v, dtype=torch.float32, device=dev)
    mh, nx, ny, nz = sample_mesh(mesh, px, py, world)
    wx, wy, wz = wind[0], wind[1], wind[2]
    d = wx * nx + wy * ny + wz * nz
    ox = wx - d * nx
    oy = wy - d * ny
    oz = (wz - d * nz) * 0.1            # z component much smaller
    span = torch.clamp(ztop - mh, min=1e-6)
    rel = torch.clamp((pz - mh) / span, 0.0, 1.0)
    hval = (1.0 - rel) * (1.0 - rel)
    half = 0.5 * (ztop - zbottom)
    pressure = torch.clamp(f32(half) / torch.clamp(ztop - mh, min=1e-6), max=2.0)
    lwx = ox * hval + wx * (1.0 - hval)
    lwy = oy * hval + wy * (1.0 - hval)
    lwz = oz * hval + wz * (1.0 - hval)
    # wind-texture intensity: hashed cell noise drifting with total wind
    u32 = 0xFFFFFFFF
    gx = (px * world.dx_inv + t_offset).to(torch.int32).to(torch.int64) & u32
    gy = (py * world.dy_inv + t_offset).to(torch.int32).to(torch.int64) & u32
    h = w3d_rng.xxhash_u32(((gx * 92837111) & u32) ^ gy, seed=seed)
    tex = (h & 0xFFFF).to(torch.float32) / f32(65535.0)
    inten = torch.clamp(1.0 - 2.0 * tex, 0.0, 1.0)
    scale = pressure * (hval * inten + (1.0 - hval))
    under = pz < mh
    above = pz > ztop

    def sel(lc, w):
        return torch.where(under, 0.0, torch.where(above, w, lc * scale))
    return sel(lwx, wx), sel(lwy, wy), sel(lwz, wz)

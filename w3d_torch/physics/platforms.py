"""Animated platforms + triggers (port of `3dworld_tpu/physics/platforms.py`).

`platform` (platform.cpp:211-380, collision_detect.h:460+) animates cobjs
along a direction for `ext_dist` units (or rotates them) through states
NOACT -> WAIT(sdelay) -> FWD -> CHDIR(rdelay) -> REV -> reset, at
fspeed/rspeed units per tick; `cont` platforms re-activate after reset,
triggered ones wait for a trigger (trigger_t: activation distance/region,
trigger.h) or an `act_dist` proximity trigger at the origin.  Platform
riders inherit the platform's frame delta (Physics.cpp:1427-1445).

Platform state is SoA tensors advanced by elementwise torch code (the
reference's per-platform while-loop unrolled to 3 state transitions a
frame, in the JAX package's order); cobjs move each frame through their
`platform_id` field.  Nothing here reads a device value back.  Where the
JAX package used TPU layout workarounds, the port indexes: `eval_triggers`
ORs each trigger into its platform with an indexed add (the JAX package
multiplies by a one-hot matrix), and `rider_deltas` sums each rider's
0/1-weighted cobj deltas (the JAX package's `w @ cdx`).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .cobjs import CobjSet

TICKS_PER_SECOND = 40.0   # 3DWorld.h:61

# states (platform.cpp)
ST_NOACT, ST_WAIT, ST_FWD, ST_CHDIR, ST_REV = 0, 1, 2, 3, 4

# compatibility modes for make_platforms
P_TRIGGERED = 0
P_CONTINUOUS = 1


class PlatformSet(NamedTuple):
    """SoA platforms (static params + dynamic state)."""

    # static
    fspeed: torch.Tensor     # [P] units/tick (file units/sec / TICKS_PER_SECOND)
    rspeed: torch.Tensor     # [P] units/tick
    sdelay: torch.Tensor     # [P] ticks
    rdelay: torch.Tensor     # [P] ticks (<0 = never reverse)
    ext_dist: torch.Tensor   # [P] travel distance (or rotation angle)
    act_dist: torch.Tensor   # [P] >0 = origin proximity trigger
    ox: torch.Tensor         # [P] origin
    oy: torch.Tensor
    oz: torch.Tensor
    dx: torch.Tensor         # [P] normalized direction (or rotation axis)
    dy: torch.Tensor
    dz: torch.Tensor
    cont: torch.Tensor       # [P] bool continuous
    is_rot: torch.Tensor     # [P] bool rotation platform
    # dynamic
    state: torch.Tensor      # [P] int32 ST_*
    ns_time: torch.Tensor    # [P] ticks until next state event
    dist: torch.Tensor       # [P] current travel distance (or angle)
    is_stopped: torch.Tensor  # [P] bool (auto-off pause)
    active_time: torch.Tensor  # [P] ticks active (auto_off)

    @property
    def size(self) -> int:
        return self.state.shape[0]


def _f32(vals, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(vals, np.float32), device=device)


def _dynamic(n: int, device) -> dict:
    z = lambda: torch.zeros(n, dtype=torch.float32, device=device)
    return dict(state=torch.zeros(n, dtype=torch.int32, device=device),
                ns_time=z(), dist=z(),
                is_stopped=torch.zeros(n, dtype=torch.bool, device=device),
                active_time=z())


def build_platforms(specs, device: torch.device | str = "cuda") -> PlatformSet:
    """From scene PlatformSpecs (platform_cont::add_from_file units:
    speeds units/sec, delays seconds; divided and multiplied by
    TICKS_PER_SECOND on the host in float64, then rounded to float32)."""
    f = lambda g: _f32([g(s) for s in specs], device)
    b = lambda g: torch.as_tensor(np.asarray([g(s) for s in specs], bool),
                                  device=device)
    return PlatformSet(
        fspeed=f(lambda s: s.fspeed / TICKS_PER_SECOND),
        rspeed=f(lambda s: s.rspeed / TICKS_PER_SECOND),
        sdelay=f(lambda s: s.sdelay * TICKS_PER_SECOND),
        rdelay=f(lambda s: s.rdelay * TICKS_PER_SECOND),
        ext_dist=f(lambda s: s.ext_dist), act_dist=f(lambda s: s.act_dist),
        ox=f(lambda s: s.origin[0]), oy=f(lambda s: s.origin[1]),
        oz=f(lambda s: s.origin[2]),
        dx=f(lambda s: s.dir[0]), dy=f(lambda s: s.dir[1]),
        dz=f(lambda s: s.dir[2]),
        cont=b(lambda s: s.cont), is_rot=b(lambda s: s.is_rot),
        **_dynamic(len(specs), device),
    )


def make_platforms(cobj_idx, travel, speed, mode=P_CONTINUOUS,
                   device: torch.device | str = "cuda") -> PlatformSet:
    """Convenience constructor: platforms translating along `travel` at
    `speed` (fraction of travel per tick).  Platform i drives the cobjs
    whose platform_id is i; `cobj_idx` gives the count."""
    n = len(cobj_idx)
    travel = np.asarray(travel, np.float32).reshape(n, 3)
    ext = np.linalg.norm(travel, axis=1)
    d = travel / np.maximum(ext[:, None], 1e-9)
    sp = np.asarray(speed, np.float32) * np.ones(n) * ext
    zero = lambda: torch.zeros(n, dtype=torch.float32, device=device)
    return PlatformSet(
        fspeed=_f32(sp, device), rspeed=_f32(sp, device),
        sdelay=zero(), rdelay=zero(),
        ext_dist=_f32(ext, device), act_dist=zero(),
        ox=zero(), oy=zero(), oz=zero(),
        dx=_f32(d[:, 0], device), dy=_f32(d[:, 1], device),
        dz=_f32(d[:, 2], device),
        cont=torch.full((n,), mode == P_CONTINUOUS, dtype=torch.bool, device=device),
        is_rot=torch.zeros(n, dtype=torch.bool, device=device),
        **_dynamic(n, device),
    )


def advance_platforms(p: PlatformSet, triggered: torch.Tensor | None = None,
                      fticks: float = 1.0):
    """One frame of platform::advance_timestep (platform.cpp:296-380) for
    every platform.  `triggered`: [P] bool from eval_triggers (sensor /
    trigger activation this frame).  Returns (new_platforms, mx, my, mz):
    per-platform frame deltas (for rotation platforms the delta is the
    angle change in mx; my/mz zero)."""
    trig = (torch.zeros(p.size, dtype=torch.bool, device=p.state.device)
            if triggered is None else triggered)
    state, ns_time, dist = p.state, p.ns_time, p.dist

    # NOACT + (cont | trigger) -> activate (state=WAIT, ns_time=sdelay)
    act = (state == ST_NOACT) & (p.cont | trig)
    state = torch.where(act, ST_WAIT, state)
    ns_time = torch.where(act, p.sdelay, ns_time)

    started = state != ST_NOACT
    ns_time = torch.where(started, ns_time - fticks, ns_time)
    dist0 = dist

    # unrolled state-transition loop (while ns_time < 0)
    for _ in range(3):
        pending = started & (ns_time < 0.0)
        # WAIT -> FWD (fallthrough)
        w = pending & (state == ST_WAIT)
        state = torch.where(w, ST_FWD, state)
        # FWD: move forward by -fspeed*ns_time, clamp at ext_dist
        fw = pending & (state == ST_FWD)
        dt_f = -p.fspeed * ns_time
        past_end = (p.ext_dist > 0.0) & (dt_f + dist > p.ext_dist)
        dt_f_cl = torch.where(past_end, p.ext_dist - dist, dt_f)
        new_ns = torch.where(
            past_end,
            ns_time + dt_f_cl / torch.clamp(p.fspeed, min=1e-9)
            + torch.clamp(p.rdelay, min=0.0),
            0.0)
        dist = torch.where(fw, dist + dt_f_cl, dist)
        ns_time = torch.where(fw, new_ns, ns_time)
        state = torch.where(fw & past_end, ST_CHDIR, state)
        # CHDIR -> REV when rdelay >= 0 (rdelay < 0: wait forever)
        pending = started & (ns_time < 0.0)
        ch = pending & (state == ST_CHDIR)
        state = torch.where(ch & (p.rdelay >= 0.0), ST_REV, state)
        ns_time = torch.where(ch & (p.rdelay < 0.0), 0.0, ns_time)
        # REV: move back by rspeed*ns_time (negative), reset past start
        pending = started & (ns_time < 0.0)
        rv = pending & (state == ST_REV)
        no_rev = rv & (p.rspeed == 0.0)
        # rspeed==0 && cont && is_rot: infinite rotation — reset the
        # angle and go straight back to FWD (platform.cpp:348); others
        # wait in REV forever
        spin = no_rev & p.cont & p.is_rot
        dist = torch.where(spin, 0.0, dist)
        state = torch.where(spin, ST_FWD, state)
        ns_time = torch.where(no_rev, 0.0, ns_time)
        dt_r = p.rspeed * ns_time          # negative
        past_start = (dt_r + dist) < 0.0
        reset = rv & ~no_rev & past_start
        dist = torch.where(rv & ~no_rev & ~past_start, dist + dt_r, dist)
        ns_time = torch.where(rv & ~no_rev & ~past_start, 0.0, ns_time)
        # reset: back to origin, NOACT (cont platforms re-activate next frame)
        state = torch.where(reset, ST_NOACT, state)
        dist = torch.where(reset, 0.0, dist)
        ns_time = torch.where(reset, 0.0, ns_time)

    dd = dist - dist0
    # a cont+is_rot wrap resets dist to 0 after a full ext_dist cycle;
    # report the CONTINUOUS angle delta (without the -ext_dist jump) so
    # the applied rotation stays seamless for any ext_dist
    dd = torch.where(p.is_rot & (dd < -0.5 * p.ext_dist), dd + p.ext_dist, dd)
    out = p._replace(state=state, ns_time=ns_time, dist=dist)
    mx = torch.where(p.is_rot, dd, dd * p.dx)
    my = torch.where(p.is_rot, 0.0, dd * p.dy)
    mz = torch.where(p.is_rot, 0.0, dd * p.dz)
    return out, mx, my, mz


def step_platforms(p: PlatformSet, triggered: torch.Tensor | None = None):
    """Back-compat alias of advance_platforms."""
    return advance_platforms(p, triggered)


def _cobj_deltas(cobjs: CobjSet, mx, my, mz):
    """Gather each cobj's platform delta via its platform_id (-1 = none)."""
    if mx.shape[0] == 0:
        z = torch.zeros(cobjs.size, dtype=torch.float32, device=mx.device)
        return z, z, z
    pid = cobjs.platform_id
    idx = torch.clamp(pid, 0, mx.shape[0] - 1).long()
    w = (pid >= 0).to(torch.float32)
    return mx[idx] * w, my[idx] * w, mz[idx] * w


def _rodrigues(v, axis, ang):
    """Rotate vectors v [...,3] about per-row unit axes by per-row angles."""
    c = torch.cos(ang)[..., None]
    s = torch.sin(ang)[..., None]
    av = torch.linalg.cross(axis.expand_as(v), v, dim=-1)
    dot = (axis[..., 0] * v[..., 0] + axis[..., 1] * v[..., 1]) + axis[..., 2] * v[..., 2]
    aav = axis * dot[..., None]
    return v * c + av * s + aav * (1.0 - c)


def _platform_rot_params(cobjs: CobjSet, p: PlatformSet, mx):
    """Per-cobj (is_rot mask, angle delta, axis [M,3], origin [M,3])."""
    pid = cobjs.platform_id
    idx = torch.clamp(pid, 0, max(p.size - 1, 0)).long()
    is_rot_c = p.is_rot[idx] & (pid >= 0)
    ang = mx[idx] * is_rot_c.to(torch.float32)
    axis = torch.stack([p.dx[idx], p.dy[idx], p.dz[idx]], -1)
    orig = torch.stack([p.ox[idx], p.oy[idx], p.oz[idx]], -1)
    return is_rot_c, ang, axis, orig


def apply_platform_motion(cobjs: CobjSet, p: PlatformSet, mx, my, mz) -> CobjSet:
    """Move platform cobjs by the frame delta (a new CobjSet; the
    reference re-registers moved cobjs in the collision grid).

    Translation platforms shift p1/p2/pts; ROTATION platforms rotate
    them about the platform origin+axis by the angle delta in mx
    (rotate_about — cube cobjs only rotate faithfully for axis-aligned
    quarter/full turns; the reference converts rotated cubes to polygon
    cobjs, as does scene CSG here)."""
    if p.size == 0:
        return cobjs
    dx, dy, dz = _cobj_deltas(cobjs, mx, my, mz)
    is_rot_c, ang, axis, orig = _platform_rot_params(cobjs, p, mx)
    delta = torch.stack([dx, dy, dz], -1)
    delta = torch.where(is_rot_c[:, None], 0.0, delta)

    def rot_pt(q):
        return orig + _rodrigues(q - orig, axis, ang)

    sel = is_rot_c[:, None]
    p1 = torch.where(sel, rot_pt(cobjs.p1), cobjs.p1 + delta)
    p2 = torch.where(sel, rot_pt(cobjs.p2), cobjs.p2 + delta)
    pts = torch.where(sel[:, None],
                      orig[:, None] + _rodrigues(cobjs.pts - orig[:, None],
                                                 axis[:, None], ang[:, None]),
                      cobjs.pts + delta[:, None, :])
    pnorm = torch.where(sel, _rodrigues(cobjs.pnorm, axis, ang), cobjs.pnorm)
    return cobjs._replace(p1=p1, p2=p2, pts=pts, pnorm=pnorm)


def rider_deltas(obj_px, obj_py, obj_pz, obj_status, cobjs: CobjSet,
                 p: PlatformSet, mx, my, mz, rad):
    """Objects stopped on top of a platform cobj inherit its delta
    (Physics.cpp:1427-1445); riders on ROTATION platforms move along
    the arc their contact point sweeps, about the first rotating cobj
    they touch.  Returns per-object (dx, dy, dz)."""
    cdx, cdy, cdz = _cobj_deltas(cobjs, mx, my, mz)
    moving_cobj = cobjs.platform_id >= 0
    # standing on a cube top: xy inside, z near the top face
    lo = torch.minimum(cobjs.p1, cobjs.p2)
    hi = torch.maximum(cobjs.p1, cobjs.p2)
    X = obj_px[:, None]
    Y = obj_py[:, None]
    Z = obj_pz[:, None]
    on = ((X >= lo[:, 0]) & (X <= hi[:, 0]) & (Y >= lo[:, 1]) & (Y <= hi[:, 1])
          & (torch.abs(Z - rad[:, None] - hi[:, 2]) < 0.05) & moving_cobj[None, :])
    stopped = (obj_status == 4) | (obj_status == 2)
    w = on.to(torch.float32) * stopped[:, None].to(torch.float32)
    # sums of 0/1-weighted deltas (the JAX package's w @ cdx)
    tdx, tdy, tdz = ((w * c[None, :]).sum(1) for c in (cdx, cdy, cdz))
    if p.size > 0:
        # rotation platforms: the rider's own position sweeps the arc
        is_rot_c, ang, axis, orig = _platform_rot_params(cobjs, p, mx)
        wr = w * is_rot_c[None, :].to(torch.float32)   # [N, M]
        any_rot = wr.sum(1) > 0
        ci = torch.argmax(wr, dim=1)      # the first contact on ties
        pos = torch.stack([obj_px, obj_py, obj_pz], -1)
        rd = orig[ci] + _rodrigues(pos - orig[ci], axis[ci], ang[ci]) - pos
        tdx = torch.where(any_rot, rd[:, 0], tdx)
        tdy = torch.where(any_rot, rd[:, 1], tdy)
        tdz = torch.where(any_rot, rd[:, 2], tdz)
    return tdx, tdy, tdz


class TriggerSet(NamedTuple):
    """Proximity triggers activating platforms (trigger_t, trigger.h):
    point + activation distance, optional cube region."""

    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor
    radius: torch.Tensor
    platform: torch.Tensor     # platform index to activate
    # optional activation region (x1,x2,y1,y2,z1,z2); all-zero = unused
    region: torch.Tensor       # [T, 6]


def make_triggers(x, y, z, radius, platform, region=None,
                  device: torch.device | str = "cuda") -> TriggerSet:
    n = len(x)
    return TriggerSet(
        x=_f32(x, device), y=_f32(y, device), z=_f32(z, device),
        radius=_f32(radius, device),
        platform=torch.as_tensor(np.asarray(platform, np.int32), device=device),
        region=(_f32(region, device) if region is not None
                else torch.zeros((n, 6), dtype=torch.float32, device=device)),
    )


def triggers_from_specs(platform_specs, device: torch.device | str = "cuda") -> TriggerSet:
    """Build the trigger table from scene PlatformSpecs: each platform's
    'K' triggers plus the built-in act_dist trigger at its origin
    (platform.cpp:219)."""
    xs, ys, zs, rs, ps, regs = [], [], [], [], [], []
    for i, s in enumerate(platform_specs):
        for tr in s.triggers:
            xs.append(tr.act_pos[0])
            ys.append(tr.act_pos[1])
            zs.append(tr.act_pos[2])
            rs.append(tr.act_dist)
            ps.append(i)
            regs.append(tr.act_region or (0.0,) * 6)
        if s.act_dist > 0.0 and not s.triggers:
            xs.append(s.origin[0])
            ys.append(s.origin[1])
            zs.append(s.origin[2])
            rs.append(s.act_dist)
            ps.append(i)
            regs.append((0.0,) * 6)
    return make_triggers(xs, ys, zs, rs, ps, regs, device=device)


def eval_triggers(tr: TriggerSet, px, py, pz, platforms: PlatformSet) -> torch.Tensor:
    """Any activator inside a trigger radius (or region) fires the
    trigger; returns [P] bool per-platform activation for
    advance_platforms: a platform fires when any of its triggers does."""
    ddx = tr.x[:, None] - px[None, :]
    ddy = tr.y[:, None] - py[None, :]
    ddz = tr.z[:, None] - pz[None, :]
    near = (ddx * ddx + ddy * ddy + ddz * ddz) <= (tr.radius * tr.radius)[:, None]
    has_reg = torch.any(tr.region != 0.0, dim=1)
    rg = tr.region
    in_reg = ((px[None, :] >= rg[:, 0:1]) & (px[None, :] <= rg[:, 1:2])
              & (py[None, :] >= rg[:, 2:3]) & (py[None, :] <= rg[:, 3:4])
              & (pz[None, :] >= rg[:, 4:5]) & (pz[None, :] <= rg[:, 5:6]))
    # a region REPLACES the distance test (Physics.cpp:1296-1303: if
    # use_act_region contains_pt(pos) ELSE dist_less_than; set_act_region
    # zeroes act_dist, so AND-ing the two could never fire)
    fired = torch.any(torch.where(has_reg[:, None], in_reg, near), dim=1)
    hits = torch.zeros(platforms.size, dtype=torch.int32, device=fired.device)
    return hits.index_add_(0, tr.platform.long(), fired.to(torch.int32)) > 0

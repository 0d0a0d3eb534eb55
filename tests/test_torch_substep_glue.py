"""The substep glue's CUDA kernels (`w3d_torch/csrc/substep_glue.cu`, wrapper
`ops/cuda/glue_kernel`) against their plain PyTorch phases
(`physics/step.advance`, `respond`, `apply_pairs`, `take_rows`,
`age_objects`).  This file imports no jax, so the machine with the card
runs it alone:

    PYTHONPATH=.:tests python -m pytest --noconftest -p no:cacheprovider -m gpu \\
        tests/test_torch_substep_glue.py

On the CPU: each wrapper takes its plain phase and launches nothing; the
source's C structs list the wrapper's ctypes fields in their order; the
test states' crafted rows reach the branches they are made for.
On the card (`gpu`), bit for bit (`torch.equal`; a NaN against a NaN):
each kernel against its plain phase on the same CUDA tensors, on fuzzed
states (every type id and status, random flags, rows on and off a bumpy
mesh, under and over water, from rest to 30 units/s) with the crafted
rows, dry, over water (a per-cell map and a flat level) and on ice, with
a grouped scene, a plain CobjSet and none, with and without the pair
pass; the same with NaN and +-inf velocities; a 20-frame pile chain
through `step_objects` (graphs and all) against the plain phases'; the
device kernels of a replayed pile frame (at most 200).
"""

import math
import re

import pytest
import torch

from w3d_torch.models import physics_model as PM
from w3d_torch.ops.cuda import build
from w3d_torch.ops.cuda import glue_kernel as GL
from w3d_torch.ops.cuda import pairs_kernel as PK
from w3d_torch.ops.cuda import sample_kernel as SK
from w3d_torch.physics import graphs as G
from w3d_torch.physics import step as PS
from w3d_torch.physics import types as T
from w3d_torch.ops.cuda import graphs as CG
from w3d_torch.utils.constants import WorldConst

from torch_port_util import cuda_device  # noqa: F401

WORLD = WorldConst(mesh_x=64, mesh_y=64, x_scene=4.0, y_scene=4.0, z_scene=4.0)
DT = float(torch.tensor(T.DEF_TIMESTEP / 10, dtype=torch.float32))
WATERS = [None, "water", "flat", "ice"]
FLAG_BITS = (T.FL_COLLIDED, T.FL_STATIC_COBJ_COLL, T.FL_Z_STOPPED, T.FL_XY_STOPPED,
             T.FL_IN_WATER, T.FL_FLOATING, T.FL_UNDERWATER, T.FL_IS_ON_ICE)


def _maps():
    """(mesh, water map) on the CPU: a bumpy mesh in [-0.4, 0.2] and a
    water level rising from -0.6 to 0.2 across x."""
    lin = torch.linspace(-1.0, 1.0, 64)
    yy, xx = torch.meshgrid(lin, lin, indexing="ij")
    mesh = 0.3 * torch.sin(3.0 * xx) * torch.cos(2.0 * yy) - 0.1
    water = (-0.2 + 0.4 * xx).contiguous()
    return mesh.contiguous(), water


def _world(device, water, scene):
    """The spheres world's scene (the ground cube's top at z = 0, 100
    spheres) over `_maps()`'s mesh; `water` None (dry), "water" (level
    max(-0.3, map)), "flat" (-0.3) or "ice" (the map, frozen); `scene`
    "grouped", "plain" (a CobjSet) or "none"."""
    mesh, wmap = _maps()
    pos = torch.zeros((1, 3))
    w = PM.build_spheres_world(pos.to(device), pos.to(device), world=WORLD,
                               mesh_height=mesh.to(device), device=device,
                               group_shapes=scene == "grouped")
    f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=device)
    env = w.env._replace(zmin=f32(-0.5), wind=f32([0.4, -0.2, -0.1]))
    if water:
        env = env._replace(water_plane_z=f32(-0.3),
                           water_height=None if water == "flat" else wmap.to(device),
                           temperature=f32(-5.0 if water == "ice" else 20.0))
    return w._replace(env=env, cobjs=None if scene == "none" else w.cobjs)


def _level(x, y, water):
    """The water level the plain phase sees at world (x, y)."""
    mesh, wmap = _maps()
    if water == "flat":
        return torch.full_like(x, -0.3)
    return torch.maximum(torch.tensor(-0.3), PS.sample_mesh(wmap, x, y, WORLD)[0])


def _cells(water):
    """World (x, y) of a deep-water cell and of a dry cell under the cube's
    top (mesh below z = -0.05, water below the mesh) away from `_state`'s
    crowd of balls."""
    mesh, wmap = _maps()
    ix = torch.arange(64, dtype=torch.float32)
    xs = ((ix - 32) * WORLD.dx).expand(64, 64)
    ys = ((ix - 32) * WORLD.dy)[:, None].expand(64, 64)
    lvl = _level(xs.reshape(-1), ys.reshape(-1), water or "water").reshape(64, 64)
    inner = torch.zeros(64, 64, dtype=torch.bool)
    inner[4:-4, 4:-4] = True
    deep = torch.where(inner, lvl - mesh, -1e9).argmax()
    apart = (xs < -2.5) | (xs > -0.9)
    dry = torch.where(inner & apart & (mesh < -0.05) & (mesh - lvl > 0.05), mesh,
                      -1e9).argmax()
    return [(float(xs.reshape(-1)[k]), float(ys.reshape(-1)[k])) for k in (deep, dry)]


# crafted rows: (name, type, cell, z as (base, radii), velocity, status, flags);
# base "water" is the level there, "mesh" the mesh, "air" the mesh + 1
CRAFTED = [
    ("skip", "BALL", 0, ("water", -0.5), (8.0, 0.0, -1.0), 1, 0),
    ("fast float", "BALL", 0, ("water", -0.5), (0.0, 0.0, -8.0), 1, 0),
    ("fast sink", "ROCK", 0, ("water", -5.0), (0.0, 0.0, -8.0), 1, 0),
    ("deep float", "BALL", 0, ("water", -4.0), (0.1, 0.0, 0.0), 1, 0),
    ("snap float", "BALL", 0, ("water", -0.5), (0.1, 0.0, 0.0), 1, 0),
    ("sink damp", "ROCK", 0, ("water", -5.0), (0.1, 0.0, 0.0), 1, 0),
    ("sink rest", "ROCK", 0, ("mesh", 1.0), (0.1, 0.0, 0.0), 1, 0),
    ("ice stick", "SNOW", 0, ("water", -0.5), (0.0, 0.0, -1.0), 1, 0),
    ("ice bounce", "BALL", 0, ("water", -0.5), (0.0, 0.0, -8.0), 1, 0),
    ("cobj bounce", "BALL", 1, ("mesh", 0.5), (0.0, 0.0, -5.0), 1, 0),
    ("cobj stop", "SNOW", 1, ("mesh", 0.5), (0.0, 0.0, -0.1), 1, 0),
    ("airborne", "BALL", 1, ("air", 0.0), (1.0, 0.0, 0.5), 1, 0),
    ("killed below", "BALL", 1, ("mesh", -13.0), (0.0, 0.0, 0.0), 2, 0),
    ("killed zmin", "BALL", 1, ("mesh", -60.0), (0.0, 0.0, 0.0), 4, 0),
    ("wake", "BALL", 1, ("air", 0.0), (0.0, 0.0, 0.0), 4, 0),
    ("waker", "BALL", 1, ("air", 0.0), (-3.0, 0.0, 0.0), 1, 0),
]


def _state(device, water, n=4096, seed=5, bad=False):
    """A fuzzed state of `n` rows followed by the crafted rows, x-sorted;
    `time` holds each row's index before the sort.  With `bad`, every
    16th row's vx and vz are NaN, +inf or -inf."""
    g = torch.Generator().manual_seed(seed)
    u = lambda *s: torch.rand(s, generator=g)
    mesh, _ = _maps()
    table = T.make_type_table(z_scene=WORLD.z_scene, device="cpu")
    # a quarter of the rows crowd a 0.6-wide square, for the pair pass
    crowd = u(n) < 0.25
    x = torch.where(crowd, u(n) * 0.6 - 2.0, u(n) * 9.0 - 4.5)
    y = torch.where(crowd, u(n) * 0.6 + 1.0, u(n) * 9.0 - 4.5)
    otype = torch.randint(0, T.NUM_TOT_OBJS, (n,), generator=g, dtype=torch.int32)
    otype = torch.where(crowd, T.type_id("BALL"), otype).to(torch.int32)
    rad = table.radius[otype.long()]
    h = PS.sample_mesh(mesh, x, y, WORLD)[0]
    high = u(n) < 0.25
    z = torch.where(high, h + u(n) * 2.0, h + rad * (u(n) * 30.0 - 16.0))
    lvl = _level(x, y, water or "water")
    wet = u(n) < 0.25
    z = torch.where(wet, lvl + rad * (u(n) * 16.0 - 12.0), z)
    speed = 0.01 * torch.exp(u(n) * math.log(3000.0))
    d = torch.randn((n, 3), generator=g)
    vel = d / d.norm(dim=1, keepdim=True) * speed[:, None]
    vel = torch.where(u(n)[:, None] < 0.1, 0.0, vel)
    status = torch.tensor([0, 1, 1, 1, 2, 3, 4], dtype=torch.int32)[
        torch.randint(0, 7, (n,), generator=g)]
    flags = sum(torch.where(u(n) < 0.2, b, 0) for b in FLAG_BITS).to(torch.int32)

    cells = _cells(water)
    cols = dict(px=[], py=[], pz=[], vx=[], vy=[], vz=[], otype=[], status=[], flags=[])
    for k, (_name, typ, cell, (base, radii), v, st, fl) in enumerate(CRAFTED):
        cx, cy = cells[cell]
        cx += 0.2 * (k % 4) * WORLD.dx      # apart, off the crowd
        r = float(table.radius[T.type_id(typ)])
        mh = float(PS.sample_mesh(mesh, torch.tensor([cx]), torch.tensor([cy]), WORLD)[0][0])
        if base == "water":
            zb = float(_level(torch.tensor([cx]), torch.tensor([cy]), water or "water")[0])
        else:
            zb = mh + (1.0 if base == "air" else 0.0)
        cz = zb + radii * r
        if _name == "waker":    # overlaps "wake", moving into it
            cx, cz = cols["px"][-1] + 0.05, cols["pz"][-1]
        cols["px"].append(cx)
        cols["py"].append(cy)
        cols["pz"].append(cz)
        for c, vv in zip(("vx", "vy", "vz"), v):
            cols[c].append(vv)
        cols["otype"].append(T.type_id(typ))
        cols["status"].append(st)
        cols["flags"].append(fl)
    f = lambda k: torch.tensor(cols[k], dtype=torch.float32)
    i = lambda k: torch.tensor(cols[k], dtype=torch.int32)
    px, py, pz = torch.cat([x, f("px")]), torch.cat([y, f("py")]), torch.cat([z, f("pz")])
    vx = torch.cat([vel[:, 0], f("vx")])
    vy = torch.cat([vel[:, 1], f("vy")])
    vz = torch.cat([vel[:, 2], f("vz")])
    if bad:
        for k, v in enumerate((math.nan, math.inf, -math.inf)):
            vx[k::48] = v
            vz[(k + 1) % 3::48] = v
    otype = torch.cat([otype, i("otype")])
    m = px.shape[0]
    st = PS.ObjectState(px=px, py=py, pz=pz, vx=vx, vy=vy, vz=vz,
                        status=torch.cat([status, i("status")]),
                        flags=torch.cat([flags, i("flags")]), otype=otype,
                        time=torch.arange(m, dtype=torch.int32),
                        health=table.health[otype.long()])
    k = torch.where(st.status > 0, st.px, float("inf"))
    st = PS.take_rows(st, torch.sort(k, stable=True).indices)
    return PS.ObjectState(*(t.to(device) for t in st))


def _row(state, name):
    """The sorted row of the crafted row `name`."""
    k = state.time.shape[0] - len(CRAFTED) + [c[0] for c in CRAFTED].index(name)
    return int((state.time == k).nonzero()[0, 0])


def _surface(m, w, water):
    """B's samples under the moved objects, as `_substep` takes them."""
    mesh = SK.sample_mesh(w.env.mesh_height, m.px, m.py, WORLD)
    wh = None
    if water and w.env.water_height is not None:
        wh = SK.sample_mesh(w.env.water_height, m.px, m.py, WORLD)[0]
    return mesh, wh


def _phases(w, state, water, pairs, phase):
    """Run the phases through `phase` (the plain module or the wrappers):
    (advance's Moved, contact's Carry, respond's Carry and pair inputs,
    apply_pairs' Carry or None).  B, C and D run as `_substep` runs them."""
    wet = water is not None
    m = phase.advance(state, w.env, w.table, DT, WORLD)
    c = phase.contact(m, *_surface(m, w, wet), state.otype, w.env, w.table, DT, WORLD, wet)
    hits = None if w.cobjs is None else PS.cobj_hits(c.px, c.py, c.pz, c.rad, w.cobjs)
    r, pin = phase.respond(c, state.otype, hits, w.env, w.table, DT, WORLD, wet, pairs)
    if not pairs:
        return m, c, r, pin, None
    mass, elas, act = pin
    deltas = PK.banded_pairs(r.px, r.py, r.pz, r.vx, r.vy, r.vz, r.rad, mass, elas, act,
                             window=64)
    return m, c, r, pin, phase.apply_pairs(r, act, deltas, w.env)


# ---------------------------------------------------------------------------
# on the CPU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("phase", ["advance", "contact", "respond", "apply_pairs",
                                   "take_rows", "age_objects"])
def test_wrappers_take_the_plain_phase_on_the_cpu(phase, monkeypatch):
    w = _world("cpu", "water", "grouped")
    state = _state("cpu", "water", n=256)
    m = PS.advance(state, w.env, w.table, DT, WORLD)
    mesh, wh = _surface(m, w, True)
    c = PS.contact(m, mesh, wh, state.otype, w.env, w.table, DT, WORLD, True)
    r, (mass, elas, act) = PS.respond(c, state.otype, None, w.env, w.table, DT, WORLD,
                                      True, True)
    zero = tuple(torch.zeros_like(r.px) for _ in range(6))
    args = dict(advance=(state, w.env, w.table, DT, WORLD),
                contact=(m, mesh, wh, state.otype, w.env, w.table, DT, WORLD, True),
                respond=(c, state.otype, None, w.env, w.table, DT, WORLD, True, True),
                apply_pairs=(r, act, zero, w.env),
                take_rows=(state, torch.arange(state.px.shape[0] - 1, -1, -1)),
                age_objects=(state, w.table))[phase]
    calls = []
    plain = getattr(PS, phase)
    monkeypatch.setattr(PS, phase, lambda *a: calls.append(phase) or plain(*a))
    before = [k.launches for k in GL.KERNELS]
    got = getattr(GL, phase)(*args)
    assert calls == [phase]
    assert [k.launches for k in GL.KERNELS] == before
    want = plain(*args)
    flat = lambda v: [t for x in v for t in (x if isinstance(x, tuple) else (x,))
                      if t is not None]
    assert all(torch.equal(a, b) for a, b in zip(flat(got), flat(want)))


def _c_fields(struct: str) -> list:
    src = open(build.CSRC + "/substep_glue.cu").read()
    body = re.search(r"struct %s \{(.*?)\};" % struct, src, re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    names = []
    for decl in body.split(";"):
        decl = re.sub(r"\b(const|float|int|bool|unsigned)\b|\*", " ", decl)
        names += [n.strip() for n in decl.split(",") if n.strip()]
    return names


@pytest.mark.parametrize("struct", ["Consts", "TypeCols", "Env", "Rows", "Moved",
                                    "Surface", "Carry", "Hits"])
def test_c_structs_match_the_wrapper(struct):
    want = [f for f, _ in getattr(GL, struct)._fields_]
    assert _c_fields(struct) == want
    if struct in ("Moved", "Carry"):
        assert want == list(getattr(PS, struct)._fields)


@pytest.mark.parametrize("water", ["water", "ice"])
def test_crafted_rows_reach_their_branches(water):
    w = _world("cpu", water, "grouped")
    state = _state("cpu", water, n=64)
    m, c, r, pin, a = _phases(w, state, water, True, PS)
    at = lambda name: _row(state, name)
    has = lambda t, name, bit: bool(int(t.flags[at(name)]) & bit)
    if water == "water":
        assert float(r.vz[at("skip")]) > 0 and not has(r, "skip", T.FL_IN_WATER)
        assert has(c, "fast float", T.FL_FLOATING) and has(c, "fast float", T.FL_Z_STOPPED)
        assert has(c, "fast sink", T.FL_UNDERWATER)
        assert has(c, "deep float", T.FL_Z_STOPPED) and not has(c, "deep float", T.FL_FLOATING)
        assert has(c, "snap float", T.FL_FLOATING) and float(c.vz[at("snap float")]) == 0
        assert has(c, "sink damp", T.FL_IN_WATER) and int(c.status[at("sink damp")]) == 1
        assert int(c.status[at("sink rest")]) == 3 and float(c.vx[at("sink rest")]) == 0
    else:
        assert has(c, "ice stick", T.FL_IS_ON_ICE) and int(c.status[at("ice stick")]) == 4
        assert bool(c.ice_touch[at("ice bounce")]) and float(c.vz[at("ice bounce")]) > 0
    for name, st in (("cobj bounce", 1), ("cobj stop", 4)):
        assert has(r, name, T.FL_STATIC_COBJ_COLL) and int(r.status[at(name)]) == st
    assert int(a.status[at("airborne")]) == 1 and bool(c.moving[at("airborne")])
    assert int(a.status[at("killed below")]) == 0 and int(a.status[at("killed zmin")]) == 0
    assert int(state.status[at("wake")]) == 4 and int(a.status[at("wake")]) == 1
    # the fuzzed rows: every status out, grounded rows rolled and settled,
    # mesh bounces, kills off the mesh
    grounded = c.grounded & (a.status > 0)
    assert set(a.status.tolist()) == {0, 1, 2, 3, 4}
    assert bool((grounded & (a.status == 3)).any()) and bool((grounded & (a.status == 4)).any())
    assert bool((c.on_mesh & c.moving & (r.status == 1) & (r.vz > 0)).any())
    assert bool((c.off_mesh & c.alive).any()) and bool((c.touches_water | c.ice_touch).any())


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

def _same(a, b, what=""):
    """Bit for bit, a NaN against a NaN; a NamedTuple or tuple field by field."""
    if isinstance(a, tuple):
        names = getattr(a, "_fields", range(len(a)))
        for name, x, y in zip(names, a, b):
            _same(x, y, f"{what}.{name}")
        return
    assert a.dtype == b.dtype and a.shape == b.shape, what
    if a.is_floating_point():
        nan = torch.isnan(a)
        assert torch.equal(nan, torch.isnan(b)), f"{what}: NaN rows differ"
        a, b = (torch.where(nan, 0.0, t).view(torch.int32) for t in (a, b))
    diff = (a != b).nonzero()
    assert diff.numel() == 0, f"{what}: {diff.numel()} rows differ, first {diff[:4].tolist()}"


@pytest.mark.gpu
@pytest.mark.parametrize("bad", [False, True], ids=["finite", "nan-inf"])
@pytest.mark.parametrize("scene", ["grouped", "plain", "none"])
@pytest.mark.parametrize("water", WATERS, ids=["dry", "water", "flat", "ice"])
def test_kernels_equal_their_plain_phases(cuda_device, water, scene, bad):
    w = _world(cuda_device, water, scene)
    state = _state(cuda_device, water, bad=bad)
    wet = water is not None
    for pairs in (False, True):
        before = [k.launches for k in GL.KERNELS]
        want = _phases(w, state, water, pairs, PS)
        _same(GL.advance(state, w.env, w.table, DT, WORLD), want[0], "advance")
        # each later kernel from the plain phase before it
        m = want[0]
        c = GL.contact(m, *_surface(m, w, wet), state.otype, w.env, w.table, DT, WORLD, wet)
        _same(c, want[1], "contact")
        c = want[1]
        hits = None if w.cobjs is None else PS.cobj_hits(c.px, c.py, c.pz, c.rad, w.cobjs)
        r, pin = GL.respond(c, state.otype, hits, w.env, w.table, DT, WORLD, wet, pairs)
        _same(r, want[2], "respond")
        if pairs:
            _same(pin, want[3], "pair inputs")
            r = want[2]
            deltas = PK.banded_pairs(r.px, r.py, r.pz, r.vx, r.vy, r.vz, r.rad,
                                     *want[3], window=64)
            _same(GL.apply_pairs(r, pin[2], deltas, w.env), want[4], "apply_pairs")
        launched = [k.launches - b for k, b in zip(GL.KERNELS, before)]
        assert launched == [1, 1, 1, int(pairs), 0, 0]
    idx = torch.randperm(state.px.shape[0], device=cuda_device)
    _same(GL.take_rows(state, idx), PS.take_rows(state, idx), "take_rows")
    _same(GL.age_objects(state, w.table), PS.age_objects(state, w.table), "age_objects")


PILE = WorldConst(mesh_x=128, mesh_y=128, x_scene=4.0, y_scene=4.0, z_scene=4.0)


def _pile(device, water=None):
    """The 10K pile as `test_torch_graphs` builds it: dry, or over a water
    level rising from 1.5 to 2.5 across x, liquid or frozen."""
    pos, vel = PM.spawn(10_000, torch.Generator(device=device).manual_seed(7), device=device)
    w = PM.build_spheres_world(pos, vel, world=PILE, device=device)
    if water:
        ramp = torch.linspace(1.5, 2.5, PILE.mesh_x, device=device)
        w = w._replace(env=w.env._replace(
            water_plane_z=torch.tensor(2.0, device=device),
            water_height=ramp.expand(PILE.mesh_y, -1).contiguous(),
            temperature=torch.tensor(20.0 if water == "water" else -5.0, device=device)))
    return w


def _plain_frame(w, water):
    """`step_objects`' frame (10 substeps, pairs every 5th) through the plain
    phases, the narrow phase and the pair pass as the frame calls them."""
    dt = float(torch.tensor(T.DEF_TIMESTEP / 10, dtype=torch.float32))
    s = w.state
    k = torch.where(s.status > 0, s.px, float("inf"))
    s = PS.take_rows(s, torch.sort(k, stable=True).indices)
    for j in range(10):
        pairs = j % 5 == 0
        m = PS.advance(s, w.env, w.table, dt, PILE)
        mesh = SK.sample_mesh(w.env.mesh_height, m.px, m.py, PILE)
        wh = None
        if water:
            wh = SK.sample_mesh(w.env.water_height, m.px, m.py, PILE)[0]
        c = PS.contact(m, mesh, wh, s.otype, w.env, w.table, dt, PILE, water)
        hits = PS.cobj_hits(c.px, c.py, c.pz, c.rad, w.cobjs)
        c, pin = PS.respond(c, s.otype, hits, w.env, w.table, dt, PILE, water, pairs)
        if pairs:
            deltas = PK.banded_pairs(c.px, c.py, c.pz, c.vx, c.vy, c.vz, c.rad, *pin,
                                     window=PS.PAIR_WINDOW)
            c = PS.apply_pairs(c, pin[2], deltas, w.env)
        s = s._replace(px=c.px, py=c.py, pz=c.pz, vx=c.vx, vy=c.vy, vz=c.vz,
                       status=c.status, flags=c.flags)
    return w._replace(state=PS.age_objects(s, w.table))


@pytest.fixture
def frames(monkeypatch):
    """A fresh frame cache in place of the module's."""
    fg = CG.GraphCache("physics")
    monkeypatch.setattr(G, "FRAMES", fg)
    return fg


@pytest.mark.gpu
@pytest.mark.parametrize("water", [None, "water", "ice"])
def test_pile_chain_equals_the_plain_phases(cuda_device, frames, water):
    w = a = b = _pile(cuda_device, water)
    for f in range(20):
        a = PM.frame_step(a, substeps=10, world=PILE, pair_every=5, water=bool(water))
        b = _plain_frame(b, bool(water))
        _same(a.state, b.state, f"frame {f}")
    assert frames.counts["graph_replays"] >= 17
    assert int((a.state.status > 0).sum()) > 1000 and not torch.equal(a.state.px, w.state.px)


@pytest.mark.gpu
def test_replayed_pile_frame_runs_few_kernels(cuda_device, frames):
    w = _pile(cuda_device)
    for _ in range(3):          # eager, capture, replay
        w = PM.frame_step(w, substeps=10, world=PILE, pair_every=5, water=False)
    torch.cuda.synchronize()
    steps = 4
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            w = PM.frame_step(w, substeps=10, world=PILE, pair_every=5, water=False)
        torch.cuda.synchronize()
    kernels = [e for e in prof.profiler.kineto_results.events()
               if e.device_type() == torch.autograd.DeviceType.CUDA
               and not e.name().startswith(("Memcpy", "Memset"))]
    assert frames.counts["graph_replays"] >= steps
    assert 0 < len(kernels) / steps <= 200, len(kernels) / steps

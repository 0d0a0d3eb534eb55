"""Torch port vs JAX package: the chained ground frame and its parts —
water ripples, the ungrouped (plain `CobjSet`) narrow phase and physics
frame, the player, and `ground_frames_chained`.

Tolerances: ripples 1e-6 over 16 steps; the ungrouped narrow phase hit
mask and winner index exact, pen, normals and winner fields 1e-6;
`step_objects` over a plain `CobjSet` 1e-5 with status and flags exact;
the player 1e-5 with `on_ground` exact; chained frames 1e-5 with `live`
exact.  The JAX frame takes its block pair path on the CPU, so chained
references with object collisions are built frame by frame from
`step_objects(pair_method="banded")`, `step_ripples` and `step_player`.
The frame over the wide scene runs the JAX code op by op
(`jax.disable_jit`), as `tests/test_torch_wide_scene.py` does: compiled,
XLA's CPU fusion rounds a capsule's normal a few ulp apart, which a deep
contact there amplifies past 1e-5.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import w3d  # noqa: F401
from w3d.gameplay import player as JPL
from w3d.models import physics_model as JPM
from w3d.models import world as JWM
from w3d.physics import cobjs as JC
from w3d.physics import step as JPS
from w3d.physics import types as JT
from w3d.scene import cobj as JSC
from w3d.terrain import mesh as JM
from w3d.utils.constants import WorldConst as JWorld
from w3d.water import ripples as JWR

from w3d_torch import convert
from w3d_torch.gameplay import player as TPL
from w3d_torch.models import physics_model as TPM
from w3d_torch.models import world as TWM
from w3d_torch.physics import cobjs as TC
from w3d_torch.physics import step as TPS
from w3d_torch.scene import cobj as TSC
from w3d_torch.utils.constants import WorldConst as TWorld
from w3d_torch.water import ripples as TWR

from torch_port_util import bumpy_world, narrow_case, np_tree, wide_scene


def _close(a, b, tol, what=""):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, what
    d = float(np.abs(a.astype(np.float64) - b.astype(np.float64)).max()) if a.size else 0.0
    assert d <= tol, (what, d)


# ---------------------------------------------------------------------------
# ripples
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tstep", [1.0, 0.6, "tensor"])
def test_ripples_match_jax(tstep):
    """16 steps on a 24x32 pool with an island, after a splash (and a
    second one midway): rval, acc and the clamped zval within 1e-6; the
    time step a number, or a scalar tensor."""
    rg = np.random.default_rng(2)
    my, mx = 24, 32
    mesh = rg.standard_normal((my, mx)).astype(np.float32) * 0.3
    mesh[8:12, 10:16] += 2.0                         # an island
    wpz = np.float32(0.1)
    inside = wpz > mesh
    depth = np.maximum(wpz - mesh, 0.0).astype(np.float32)
    js = JWR.make_ripples(my, mx)
    ts = TWR.make_ripples(my, mx, device="cpu")
    js = JWR.add_splash(js, 20, 6, 3, 0.8, mx, my)
    ts = TWR.add_splash(ts, 20, 6, 3, 0.8, mx, my)
    ti, td = torch.as_tensor(inside), torch.as_tensor(depth)
    for k in range(16):
        if k == 7:
            js = JWR.add_splash(js, 5.5, 17.0, 2, -0.5, mx, my)
            ts = TWR.add_splash(ts, 5.5, 17.0, 2, -0.5, mx, my)
        js, jz = JWR.step_ripples(js, jnp.asarray(inside), jnp.asarray(depth),
                                  0.45 if tstep == "tensor" else tstep)
        ts, tz = TWR.step_ripples(ts, ti, td, torch.tensor(0.45)
                                  if tstep == "tensor" else tstep)
    _close(js.rval, ts.rval.numpy(), 1e-6, "rval")
    _close(js.acc, ts.acc.numpy(), 1e-6, "acc")
    _close(jz, tz.numpy(), 1e-6, "zval")
    assert np.abs(np.asarray(js.rval)).max() > 1e-3     # waves travelled
    assert (np.asarray(jz) == depth).any() or (np.asarray(jz) == -depth).any()
    assert (ts.rval.numpy()[~inside] == 0).all()


# ---------------------------------------------------------------------------
# ungrouped narrow phase and frame
# ---------------------------------------------------------------------------

def _narrow_inputs(case):
    """(JAX CobjSet, port CobjSet, [px, py, pz, radius] numpy)."""
    if case == "wide":
        jc = JSC.pack_cobjs(wide_scene(8, JSC))
        tc = TSC.pack_cobjs(wide_scene(8, TSC), device="cpu")
        rg = np.random.default_rng(6)
        ins = [rg.uniform(-2.5, 2.5, 160).astype(np.float32) for _ in range(3)]
        ins.append(rg.uniform(0.02, 0.2, 160).astype(np.float32))
        # a quarter inside the first duplicated sphere: exact ties far apart
        s = next(c for c in wide_scene(8, TSC).cobjs if c.shape == TSC.COLL_SPHERE)
        for a in range(3):
            ins[a][:40] = (s.p1[a] + rg.uniform(-0.5, 0.5, 40) * s.r1).astype(np.float32)
    else:
        jsp, ins = narrow_case(case, JSC, 160)
        tsp, _ = narrow_case(case, TSC, 160)
        jc, tc = JSC.pack_cobjs(jsp), TSC.pack_cobjs(tsp, device="cpu")
    return jc, tc, ins


@pytest.mark.parametrize("case", ["base", "ties", "far", "wide"])
def test_deepest_hits_plain_matches_jax(case):
    """The all-shapes select over a plain CobjSet (the seven-shape scene,
    its tie and far cases, and `wide_scene(8)` ungrouped, M = 640 slots):
    every slot's pen and normal against the JAX `sphere_cobj_test`, and
    the reduction against the JAX `deepest_hits`' own (first index of the
    argmax; its one-hot sums read the winner's values) applied to those
    JAX planes.  One evaluation on each side: near a formula's switch an
    ulp decides the branch, and in one full test run a second evaluation
    disagreed with the first on a lane whose planes agreed."""
    jc, tc, ins = _narrow_inputs(case)
    assert jc.size == tc.size
    jin = [jnp.asarray(a) for a in ins]
    tin = [torch.as_tensor(a) for a in ins]
    jpen = [np.asarray(a) for a in JC.sphere_cobj_test(*jin, jc)]
    tpen = [a.numpy() for a in TC.sphere_cobj_test(*tin, tc)]
    for a, b, name in zip(jpen, tpen, ("pen", "nx", "ny", "nz")):
        # every slot's value, far ones included (pen down to -50: 1e-6 of it)
        np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-6, err_msg=name)
    live = np.asarray(jc.shape) != JC.COLL_NULL
    masked = np.where(live, jpen[0], -1.0)
    win = np.argmax(masked, axis=1)                      # first index on ties
    rows = np.arange(len(win))
    best = masked[rows, win]
    ref = [best > 0.0, best] + [p[rows, win] for p in jpen[1:]] \
        + [np.asarray(jc.elasticity)[win], np.asarray(jc.friction)[win]]
    out = [a.numpy() for a in TC.deepest_hits(*tin, tc)]
    np.testing.assert_array_equal(
        win, np.argmax(np.where(live, tpen[0], -1.0), axis=1))
    np.testing.assert_array_equal(ref[0], out[0])
    for k, name in enumerate(("pen", "nx", "ny", "nz", "elas", "fric"), 1):
        _close(ref[k], out[k], 1e-6, name)
    n = len(ins[0])
    if case == "far":
        assert not ref[0].any()
    else:
        assert ref[0].sum() > 0.05 * n
    if case in ("ties", "wide"):     # exact ties happened; the first row won
        top2 = -np.sort(-masked, axis=1)[:, :2]
        assert (ref[0] & (top2[:, 0] == top2[:, 1])).sum() > n // 16


@pytest.mark.parametrize("scene,water", [("spheres", True), ("spheres", False),
                                         ("wide", True)])
def test_step_objects_plain_cobjs_matches_jax(scene, water):
    """One frame over a plain CobjSet: the spheres scene built with
    `group_shapes=False`, and `wide_scene(8)` (capsules: op by op)."""
    n = 128 if scene == "spheres" else 64
    world, sw = bumpy_world(n, water)
    if scene == "spheres":
        jsw = JPM.build_spheres_world(num_objects=n, world=world,
                                      group_shapes=False)
        assert not isinstance(jsw.cobjs, JC.GroupedCobjs)
        cobjs = jsw.cobjs
    else:
        cobjs = JSC.pack_cobjs(wide_scene(8, JSC))
    sw = sw._replace(cobjs=cobjs)
    tsw = convert.spheres_world(np_tree(sw), "cpu")
    assert isinstance(tsw.cobjs, TC.CobjSet)
    kw = dict(substeps=2, obj_collisions=True, water=water)
    if scene == "wide":
        with jax.disable_jit():
            ref = np_tree(JPS.step_objects(sw.state, sw.env, sw.cobjs, sw.table,
                                           world=world, pair_method="banded", **kw))
    else:
        ref = np_tree(JPS.step_objects(sw.state, sw.env, sw.cobjs, sw.table,
                                       world=world, pair_method="banded", **kw))
    out = TPS.step_objects(tsw.state, tsw.env, tsw.cobjs, tsw.table,
                           world=TWorld(), **kw)
    for name in ("px", "py", "pz", "vx", "vy", "vz"):
        _close(getattr(ref, name), getattr(out, name).numpy(), 1e-5, name)
    for name in ("status", "flags", "time"):
        a, b = getattr(ref, name), getattr(out, name).numpy()
        np.testing.assert_array_equal(a.astype(b.dtype), b, err_msg=name)
    assert ((ref.flags & int(JT.FL_STATIC_COBJ_COLL)) != 0).sum() > 5


def test_spheres_world_group_shapes_option():
    """`group_shapes=False` keeps the packed CobjSet; True groups it."""
    pos = torch.zeros((2, 3))
    plain = TPM.build_spheres_world(pos, pos, group_shapes=False, device="cpu")
    grouped = TPM.build_spheres_world(pos, pos, device="cpu")
    assert isinstance(plain.cobjs, TC.CobjSet)
    assert isinstance(grouped.cobjs, TC.GroupedCobjs)
    assert torch.equal(TC.group_cobjs(plain.cobjs).cobjs.p1, grouped.cobjs.cobjs.p1)


def test_empty_cobjs_match_jax():
    ref = np_tree(JC.empty_cobjs(24))
    out = TC.empty_cobjs(24, device="cpu")
    for name in TC.CobjSet._fields:
        a, b = getattr(ref, name), getattr(out, name).numpy()
        assert a.shape == b.shape, name
        np.testing.assert_array_equal(a.astype(b.dtype), b, err_msg=name)


# ---------------------------------------------------------------------------
# player
# ---------------------------------------------------------------------------

def _player_scene(kind):
    """(JAX cobjs, port cobjs) of the spheres scene: grouped, plain, or
    24 dead slots."""
    sp = TPM.spheres_scene()
    jsp = JSC.SceneParse()
    jsp.cobjs = sp.cobjs
    if kind == "empty":
        return JC.empty_cobjs(24), TC.empty_cobjs(24, device="cpu")
    jc, tc = JSC.pack_cobjs(jsp), TSC.pack_cobjs(sp, device="cpu")
    if kind == "grouped":
        return JC.group_cobjs(jc), TC.group_cobjs(tc)
    return jc, tc


@pytest.mark.parametrize("kind", ["grouped", "plain", "empty"])
def test_step_player_matches_jax(kind):
    """90 ticks: fall from z = 1, land (on a cobj's top in the scenes, on
    the mesh in the empty one), walk a curve through the spheres, and jump
    twice; each tick within 1e-5, on_ground exact."""
    world = JWorld()
    rg = np.random.default_rng(8)
    mesh = (rg.standard_normal((world.mesh_y, world.mesh_x)).astype(np.float32)
            * 0.02 - 0.3)
    jc, tc = _player_scene(kind)
    jp = JPL.make_player(0.4, -0.3, 1.0)
    tp = TPL.make_player(0.4, -0.3, 1.0, device="cpu")
    tmesh = torch.as_tensor(mesh)
    seen, stood = set(), []
    for i in range(90):
        mx, my = np.cos(0.05 * i), np.sin(0.05 * i)
        jump = i in (60, 75)
        jp = JPL.step_player(jp, jnp.asarray(mesh), jc, mx, my, jump, world=world)
        tp = TPL.step_player(tp, tmesh, tc, mx, my, jump, world=TWorld())
        r, o = np_tree(jp), convert.to_numpy(tp)
        for name in ("x", "y", "z", "vz"):
            _close(getattr(r, name), getattr(o, name), 1e-5, f"tick {i} {name}")
        np.testing.assert_array_equal(r.on_ground, o.on_ground, err_msg=f"tick {i}")
        seen.add((bool(r.on_ground[0]), bool(r.vz[0] > 0)))
        if r.on_ground[0]:
            stood.append(float(r.z[0]))
    assert (True, False) in seen and (False, True) in seen   # stood and jumped
    if kind == "empty":      # on the mesh, camera_height above it
        assert max(stood) < -0.15
    else:                    # on a cobj's top (the ground cube's is z = 0)
        assert max(stood) > 0.0


def test_step_player_takes_device_scalars():
    """Moves and the jump may be scalar tensors (never read back)."""
    tc = TC.group_cobjs(TSC.pack_cobjs(TPM.spheres_scene(), device="cpu"))
    mesh = torch.full((128, 128), -0.7)
    p0 = TPL.make_player(0.0, 0.0, 0.05, device="cpu")
    a = TPL.step_player(p0, mesh, tc, 0.3, -0.2, False)
    b = TPL.step_player(p0, mesh, tc, torch.tensor(0.3), torch.tensor(-0.2),
                        torch.tensor(False))
    for x, y in zip(a, b):
        assert torch.equal(x, y)


# ---------------------------------------------------------------------------
# chained ground frames
# ---------------------------------------------------------------------------

def _check_state(ref, out, tol, rows=None):
    """Positions and velocities within `tol`, status/flags/time exact, on
    the first `rows` rows (the alive prefix of the last frame's sort)."""
    sl = slice(None) if rows is None else slice(0, rows)
    for name in ("px", "py", "pz", "vx", "vy", "vz"):
        _close(getattr(ref, name)[sl], getattr(out, name).numpy()[sl], tol, name)
    for name in ("status", "flags", "time"):
        a, b = getattr(ref, name)[sl], getattr(out, name).numpy()[sl]
        np.testing.assert_array_equal(a.astype(b.dtype), b, err_msg=name)


def test_ground_frames_chained_matches_jax_smoke():
    """tests/test_water.py:227-248's setting: a 32^2 world, 32 balls in
    the grouped spheres scene, smoke on, 4 frames of 1 substep without
    object collisions, against the JAX `ground_frames_chained` itself."""
    jw = JWorld(mesh_x=32, mesh_y=32, mesh_z=8)
    tw = TWorld(mesh_x=32, mesh_y=32, mesh_z=8)
    sw = JPM.build_spheres_world(num_objects=32, world=jw)
    rip = JWR.make_ripples(32, 32)
    ply = JPL.make_player(0.0, 0.0, 1.0)
    smoke = jnp.zeros((8, 32, 32)).at[2, 16, 16].set(10.0)
    mv = jnp.zeros((4, 2))
    ref = np_tree(JWM.ground_frames_chained(
        sw.state, sw.env, sw.cobjs, sw.table, rip, ply, mv, jw, 4, substeps=1,
        obj_collisions=False, smoke=smoke))
    tsw = convert.spheres_world(np_tree(sw), "cpu")
    out = TWM.ground_frames_chained(
        tsw.state, tsw.env, tsw.cobjs, tsw.table,
        convert.ripple_state(np_tree(rip), "cpu"),
        convert.player_state(np_tree(ply), "cpu"), torch.zeros((4, 2)), tw, 4,
        substeps=1, obj_collisions=False, smoke=convert.array(smoke, "cpu"))
    assert len(out) == 5
    _check_state(ref[0], out[0], 1e-5)
    for a, b in zip(ref[1], out[1]):
        _close(a, b.numpy(), 1e-5, "ripples")
    for name in TPL.PlayerState._fields:
        a, b = getattr(ref[2], name), getattr(out[2], name).numpy()
        if name == "on_ground":
            np.testing.assert_array_equal(a, b)
        else:
            _close(a, b, 1e-5, name)
    assert out[3].dtype == torch.int32
    np.testing.assert_array_equal(ref[3], out[3].numpy())
    _close(ref[4], out[4].numpy(), 1e-5, "smoke")
    s2 = out[4].numpy()
    assert s2[2, 16, 16] < 10.0 and (s2 > 0).sum() > 1


def test_ground_frames_chained_matches_jax_generated_mesh():
    """obj_collisions on, over a generated (fBm simplex) 32^2 mesh with
    water at its 40% height quantile (ripples live, after a splash), 64
    balls thrown down at the ground and the water in the seven-shape
    scene as a plain CobjSet, the player walking: 3 frames of 2 substeps
    against the JAX parts frame by frame."""
    jw = JWorld(mesh_x=32, mesh_y=32)
    tw = TWorld(mesh_x=32, mesh_y=32)
    terr = np_tree(JM.gen_terrain(JM.TerrainConfig(mode=1), jw))
    scale = 2.0 / float(terr.zmax_est)       # heights into the scene's +-2
    mesh = (terr.mesh_height * scale).astype(np.float32)
    wpz = np.float32(np.quantile(mesh, 0.4))
    rg = np.random.default_rng(12)
    n = 64
    px = rg.uniform(-0.8 * jw.x_scene, 0.8 * jw.x_scene, n)
    py = rg.uniform(-0.8 * jw.y_scene, 0.8 * jw.y_scene, n)
    # just above the ground or the water under each ball, thrown down
    cell = mesh[(py / jw.dy + 16).astype(int), (px / jw.dx + 16).astype(int)]
    pos = np.stack([px, py, np.maximum(cell, wpz) + rg.uniform(0.02, 0.12, n)],
                   1).astype(np.float32)
    vel = np.stack([rg.normal(0, 1, n), rg.normal(0, 1, n),
                    rg.uniform(-8, -2, n)], 1).astype(np.float32)
    table = JT.make_type_table(z_scene=jw.z_scene)
    st = JPS.make_state(pos, vel, np.full(n, JT.type_id("BALL")), table)
    env = JPS.PhysicsEnv(mesh_height=jnp.asarray(mesh), water_plane_z=jnp.float32(wpz),
                         wind=jnp.asarray([0.4, 0.2, 0.0], jnp.float32),
                         temperature=jnp.float32(20.0), base_gravity=jnp.float32(1.0),
                         zmin=jnp.float32(-4.0))
    cobjs = JSC.pack_cobjs(narrow_case("base", JSC, 1)[0])
    gy, gx = np.unravel_index(np.argmin(mesh), mesh.shape)   # in the water
    rip = JWR.add_splash(JWR.make_ripples(32, 32), int(gx), int(gy), 3, 0.5, 32, 32)
    ply = JPL.make_player(0.3, 0.2, 1.0)
    mv = np.stack([np.cos(0.2 * np.arange(3)), np.sin(0.2 * np.arange(3))], 1)
    t_in = (convert.object_state(np_tree(st), "cpu"),
            convert.physics_env(np_tree(env), "cpu"),
            convert.cobj_set(np_tree(cobjs), "cpu"),
            convert.type_table(np_tree(table), "cpu"),
            convert.ripple_state(np_tree(rip), "cpu"),
            convert.player_state(np_tree(ply), "cpu"))
    inside = env.water_plane_z > env.mesh_height
    depth = jnp.maximum(env.water_plane_z - env.mesh_height, 0.0)
    live = []
    for k in range(3):
        st = JPS.step_objects(st, env, cobjs, table, substeps=2, world=jw,
                              obj_collisions=True, pair_method="banded")
        rip, _ = JWR.step_ripples(rip, inside, depth)
        ply = JPL.step_player(ply, env.mesh_height, cobjs, mv[k, 0], mv[k, 1],
                              False, world=jw)
        live.append(int(jnp.sum(st.status > 0)))
    out = TWM.ground_frames_chained(*t_in, torch.as_tensor(mv), tw, 3, substeps=2,
                                    obj_collisions=True)
    assert len(out) == 4
    np.testing.assert_array_equal(np.asarray(live), out[3].numpy())
    _check_state(np_tree(st), out[0], 1e-5, rows=live[-2])
    for a, b in zip(rip, out[1]):
        _close(a, b.numpy(), 1e-5, "ripples")
    assert np.abs(np.asarray(rip.rval)).max() > 1e-3
    for name in ("x", "y", "z", "vz"):
        _close(getattr(ply, name), getattr(out[2], name).numpy(), 1e-5, name)
    np.testing.assert_array_equal(np.asarray(ply.on_ground), out[2].on_ground.numpy())
    flags = np.asarray(st.flags)
    assert ((flags & int(JT.FL_STATIC_COBJ_COLL)) != 0).any()
    assert ((flags & int(JT.FL_IN_WATER)) != 0).any()

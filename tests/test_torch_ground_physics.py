"""Torch port vs JAX package: the rest of ground physics: cobj destruction
and fragments (`physics/destroy`), object groups (`physics/groups`), the
particle pools (`physics/particles`), movable cobjs (`physics/movable`)
and the local wind (`physics/step.local_wind_field`).

The cases are those of tests/test_gaps.py, tests/test_physics.py and
tests/test_movable_rotate.py, run through both packages on the same
inputs (scenes packed by the JAX package and carried across by
`w3d_torch.convert`).  The JAX package's threefry draws become the port's
draw inputs: the test draws them from the same keys.  Tolerances: float
fields within 1e-6 (most are bitwise), integer fields, masks and shapes
equal; the host-side movable decisions (float64 numpy in both) equal."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import w3d  # noqa: F401
from w3d.physics import destroy as JD, groups as JG, particles as JPP, movable as JMV
from w3d.physics import step as JPS, types as JT
from w3d.physics.cobjs import empty_cobjs as jempty, COLL_CUBE
from w3d.scene import cobj as JSC
from w3d.utils.constants import WorldConst as JWorld

from w3d_torch import convert
from w3d_torch.physics import destroy as TD, groups as TG, particles as TPP, movable as TMV
from w3d_torch.physics import step as TPS, types as TT
from w3d_torch.utils.constants import WorldConst as TWorld

from torch_port_util import np_tree

JTABLE = JT.make_type_table()
TTABLE = TT.make_type_table(device="cpu")


def _same(a, b, tol=1e-6, what=""):
    """A port value (tensors in NamedTuples) against a JAX one."""
    a, b = convert.to_numpy(a), np_tree(b)
    if hasattr(b, "_fields"):
        for f in b._fields:
            _same(getattr(a, f), getattr(b, f), tol, f"{what}.{f}")
        return
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, what
    if b.dtype.kind == "f":
        np.testing.assert_allclose(a, b, rtol=0, atol=tol, err_msg=what)
    else:
        np.testing.assert_array_equal(a.astype(np.int64), b.astype(np.int64), err_msg=what)


def _port(jvalue, fn):
    return fn(np_tree(jvalue), "cpu")


def _state(n, seed, dead_frac=0.5):
    """A JAX ObjectState of n balls, some dead, with ages and stale flags."""
    rg = np.random.default_rng(seed)
    st = JPS.make_state(rg.uniform(-1, 1, (n, 3)).astype(np.float32),
                        rg.normal(0, 1, (n, 3)).astype(np.float32),
                        np.full(n, JT.type_id("BALL")), JTABLE)
    return st._replace(
        status=jnp.asarray(np.where(rg.uniform(size=n) < dead_frac, 0, 1), jnp.int32),
        time=jnp.asarray(rg.integers(0, 500, n), jnp.int32),
        flags=jnp.asarray(rg.integers(0, 64, n).astype(np.uint32)))


# ---- destroy ----------------------------------------------------------------

def _cubes_scene():
    sp = JSC.SceneParse()
    for k in range(6):
        sp.cobjs.append(JSC.RawCobj(JSC.COLL_CUBE, (0.4 * k, 0, 0), (0.4 * k + 0.3, 1, 0.2)))
    sp.cobjs.append(JSC.RawCobj(JSC.COLL_SPHERE, (0.5, 0.5, 0.3), r1=0.2))
    return JSC.pack_cobjs(sp)


@pytest.mark.parametrize("seed_key", [0, 7])
def test_destroy_and_fragments_match_jax(seed_key):
    jc = _cubes_scene()
    levels = np.zeros(jc.size, np.int32)
    levels[:7] = [1, 2, 3, 0, 1, 3, 1]
    jds = JD.make_destroy_state(jc, jnp.asarray(levels))
    tc = _port(jc, convert.cobj_set)
    tds = TD.make_destroy_state(tc, levels)
    for args in ((0.5, 0.5, 0.1, 1.0, 1), (0.5, 0.5, 0.1, 1.0, 2), (1.9, 0.4, 0.0, 0.35, 1)):
        jc2, jhit = JD.destroy_coll_objs(jc, jds, *args)
        tc2, thit = TD.destroy_coll_objs(tc, tds, *args)
        _same(thit, jhit, what="hit")
        _same(tc2.shape, jc2.shape, what="shape")
        assert bool(jhit.any())
    # fragments: dead slots with stale Z/XY_STOPPED bits get reset
    st = _state(40, 3)
    st = st._replace(flags=jnp.full(40, JT.FL_Z_STOPPED | JT.FL_XY_STOPPED, jnp.uint32))
    key = jax.random.key(seed_key)
    centers = [[0.5, 0.5, 0.1], [1.9, 0.4, 0.0], [0.1, 0.2, 0.3]]
    js = JD.spawn_fragments(st, JTABLE, centers, key=key)
    seed = int(np.asarray(jax.random.key_data(key))[-1])
    ts = TD.spawn_fragments(_port(st, convert.object_state), TTABLE, centers, seed=seed)
    _same(ts, js, tol=0.0, what="fragments")
    frag = np.asarray(js.otype) == JT.type_id("FRAGMENT")
    assert frag.sum() > 8 and (np.asarray(js.flags)[frag] == 0).all()


def test_surface_damage_and_decals_match_jax():
    jsd = JD.make_surface_damage(16, 16, max_decals=4)
    tsd = TD.make_surface_damage(16, 16, max_decals=4, device="cpu")
    jsd, tsd = JD.add_surface_damage(jsd, 5, 7, 2.0), TD.add_surface_damage(tsd, 5, 7, 2.0)
    jsd, tsd = JD.add_surface_damage(jsd, 5, 7, 0.5), TD.add_surface_damage(tsd, 5, 7, 0.5)
    for i in range(6):  # the ring wraps
        jsd = JD.add_decal(jsd, float(i), 0.5 * i, 0.0)
        tsd = TD.add_decal(tsd, float(i), 0.5 * i, 0.0)
    _same(tsd, jsd, tol=0.0, what="surface damage")
    assert int(tsd.head) == 6 and float(tsd.decal_x[0]) == 4.0


# ---- groups -------------------------------------------------------------------

@pytest.mark.parametrize("max_spawn", [5, 64])
def test_spawn_into_group_matches_jax(max_spawn):
    st = _state(48, 5, dead_frac=0.4)
    key = jax.random.key(max_spawn)
    otype = JT.type_id("SAND")
    js = JG.spawn_into_group(st, JTABLE, key, otype, max_spawn)
    ks = jax.random.split(key, 7)
    draws = TG.GroupDraws(
        torch.as_tensor(np.stack([np.asarray(jax.random.uniform(ks[i], (48,))) for i in range(3)])),
        torch.as_tensor(np.stack([np.asarray(jax.random.normal(ks[i], (48,)))
                                  for i in range(3, 6)])))
    ts = TG.spawn_into_group(_port(st, convert.object_state), TTABLE, draws, otype, max_spawn)
    _same(ts, js, what="group")     # jitted and eager normals differ by an ulp
    n_dead = int((np.asarray(st.status) == 0).sum())
    assert TG.group_stats(ts, otype) == JG.group_stats(js, otype) == min(max_spawn, n_dead)
    spec = JG.GroupSpec(otype, 100, 2.7)
    assert [TG.frame_spawns(convert.group_spec(spec), f) for f in range(10)] == \
        [JG.frame_spawns(spec, f) for f in range(10)]


# ---- particles ----------------------------------------------------------------

def _j(v):
    return jnp.asarray(np.asarray(v, np.float32))


def _t(v):
    return torch.as_tensor(np.asarray(v, np.float32))


def test_bubbles_and_clouds_match_jax():
    jb, tb = JPP.make_bubbles(16), TPP.make_bubbles(16, device="cpu")
    args = ([0.0, 0.1, 3.9, 0.5], [0.0, 0.0, 0.0, 0.2], [-0.5, -0.5, -0.3, -0.8],
            [1.0, 1.0, 0.5, 0.7], [0.01, 0.01, 0.02, 0.01])
    jb = JPP.spawn_bubbles(jb, *(_j(a) for a in args))
    tb = TPP.spawn_bubbles(tb, *(_t(a) for a in args))
    popped_any = False
    for k in range(30):
        temp = 20.0 if k < 25 else -5.0
        jb, jp = JPP.step_bubbles(jb, jnp.float32(0.025), jnp.float32(0.0),
                                  jnp.float32(temp), 4.0)
        tb, tp = TPP.step_bubbles(tb, torch.tensor(0.025), torch.tensor(0.0),
                                  torch.tensor(temp), 4.0)
        _same(tp, jp, what="popped")
        _same(tb, jb, what="bubbles")
        popped_any |= bool(jp.any())
    assert popped_any
    jc, tc = JPP.make_clouds(8), TPP.make_clouds(8, device="cpu")
    cargs = ([0.0, 0.3], [0.0, -0.2], [0.0, 0.2], [0.0, 0.1], [0.0, 0.0], [0.3, 0.1],
             [0.05, 0.2], [1.0, 0.5], [1.0, 0.8], [0.0, 1.0])
    jc = JPP.spawn_clouds(jc, *(_j(a) for a in cargs))
    tc = TPP.spawn_clouds(tc, *(_t(a) for a in cargs))
    for _ in range(101):
        jc = JPP.step_clouds(jc, jnp.float32(0.025), _j([0.1, 0.0, 0.05]),
                             jnp.float32(-10.0), 1.0)
        tc = TPP.step_clouds(tc, torch.tensor(0.025), _t([0.1, 0.0, 0.05]),
                             torch.tensor(-10.0), 1.0)
        _same(tc, jc, what="clouds")
    assert int(tc.status.sum()) == 0


def _fire_draws(key, n):
    """The JAX step_fires' draws from its key, as a FireDraws."""
    k1, k2, k3, k4 = jax.random.split(key, 4)
    u = lambda k, lo, hi: torch.as_tensor(np.array(
        jax.random.uniform(k, (n,), minval=lo, maxval=hi)))
    return TPP.FireDraws(u(k1, -1.5, 1.5), u(k2, -1.5, 1.5), u(k3, -0.05, 0.0585),
                         u(k4, -0.02, 0.02), u(jax.random.fold_in(k4, 1), 0.25, 1.2))


def test_fires_and_decals_match_jax():
    jw, tw = JWorld(), TWorld()
    jf, tf = JPP.make_fires(8), TPP.make_fires(8, device="cpu")
    fargs = ([0.0, 1.0, -1.0], [0.0, 0.5, 2.0], [0.1, 0.2, -0.3], [0.02, 0.05, 0.01])
    jf = JPP.spawn_fires(jf, *(_j(a) for a in fargs))
    tf = TPP.spawn_fires(tf, *(_t(a) for a in fargs))
    jsd = jnp.zeros((jw.mesh_y, jw.mesh_x))
    tsd = torch.zeros((tw.mesh_y, tw.mesh_x))
    key = jax.random.key(1)
    for i in range(8):
        k = jax.random.fold_in(key, i)
        wz = -10.0 if i < 6 else -0.25
        jf, jsd, jsm = JPP.step_fires(jf, k, jnp.float32(0.025), _j([0.1, 0.0, 0.0]),
                                      jnp.float32(wz), jsd, jw)
        tf, tsd, tsm = TPP.step_fires(tf, _fire_draws(k, 8), torch.tensor(0.025),
                                      _t([0.1, 0.0, 0.0]), torch.tensor(wz), tsd, tw)
        _same(tf, jf, what=f"fires {i}")
        _same(tsm, jsm, what="smoke")
        np.testing.assert_allclose(tsd.numpy(), np.asarray(jsd), rtol=0, atol=1e-6)
    assert float(jsd.sum()) > 0.0 and int(np.asarray(jf.status).sum()) < 3
    jd, td = JPP.make_decals(4), TPP.make_decals(4, device="cpu")
    for a in range(2):
        dargs = [[0.1 * a]] * 6 + [[0.05], [1.0]]
        jd = JPP.spawn_decals(jd, *(_j(v) for v in dargs), jnp.asarray([a], jnp.int32),
                              jnp.asarray([10], jnp.int32))
        td = TPP.spawn_decals(td, *(_t(v) for v in dargs), torch.tensor([a], dtype=torch.int32),
                              torch.tensor([10], dtype=torch.int32))
    for _ in range(13):
        jd, td = JPP.step_decals(jd), TPP.step_decals(td)
        _same(td, jd, what="decals")
        _same(TPP.decal_alpha(td), JPP.decal_alpha(jd), what="alpha")
    # a full pool drops the extra spawns
    jb = JPP.spawn_bubbles(JPP.make_bubbles(2), *(_j([0.0, 0.1, 0.2])for _ in range(5)))
    tb = TPP.spawn_bubbles(TPP.make_bubbles(2, device="cpu"),
                           *(_t([0.0, 0.1, 0.2]) for _ in range(5)))
    _same(tb, jb, tol=0.0, what="full pool")


# ---- movable --------------------------------------------------------------------

def _pack(cubes, movable):
    """A JAX CobjSet of cubes [(lo, hi)], `movable` slot ids flagged."""
    sp = JSC.SceneParse()
    for lo, hi in cubes:
        sp.cobjs.append(JSC.RawCobj(JSC.COLL_CUBE, lo, hi, layer=JSC.CobjLayer()))
    c = JSC.pack_cobjs(sp)
    return c._replace(is_movable=c.is_movable.at[np.asarray(movable)].set(True))


PUSH_CASES = {
    # test_gaps.py::test_movable_push_and_settle
    "free": ([((0, 0, 0), (1, 1, 1)), ((5, 0, 1), (6, 1, 2))], [0, 1], {0: (0.03, 0.0)}, {}),
    "blocked": ([((0, 0, 0), (1, 1, 1)), ((1.005, 0, 0), (2, 1, 1))], [0], {0: (0.03, 0.0)}, {}),
    # test_gaps.py::test_movable_push_blocked_by_tall_neighbor
    "tall": ([((0, 0, 0), (1, 1, 0.5)), ((1.005, 0, 0), (2, 1, 2))], [0, 1],
             {0: (0.05, 0.0)}, {}),
    # test_gaps.py::test_movable_simultaneous_pushes_no_interpenetration
    "toward": ([((0, 0, 0), (1, 1, 1)), ((1.06, 0, 0), (2.06, 1, 1))], [0, 1],
               {0: (0.05, 0.0), 1: (-0.05, 0.0)}, {}),
    # test_physics.py::test_movable_push_binary_step_partial_motion
    "partial": ([((0.0, 0.0, 0.0), (0.2, 0.2, 0.2)), ((0.25, -1.0, 0.0), (0.35, 1.0, 0.5)),
                 ((0.02, 0.02, 0.2), (0.18, 0.18, 0.35))], [0, 2], {0: (0.08, 0.01)},
                {"max_step": 0.1}),
}


@pytest.mark.parametrize("case", sorted(PUSH_CASES))
def test_push_and_settle_match_jax(case):
    cubes, movable, pushes, kw = PUSH_CASES[case]
    jc = _pack(cubes, movable)
    px, py = np.zeros(jc.size, np.float32), np.zeros(jc.size, np.float32)
    for i, (a, b) in pushes.items():
        px[i], py[i] = a, b
    jc2 = JMV.push_movable_cobjs(jc, jnp.asarray(px), jnp.asarray(py), **kw)
    tc2 = TMV.push_movable_cobjs(_port(jc, convert.cobj_set), torch.as_tensor(px),
                                 torch.as_tensor(py), **kw)
    _same(tc2.p1, jc2.p1, tol=0.0, what="push p1")
    _same(tc2.p2, jc2.p2, tol=0.0, what="push p2")
    assert float(np.abs(np.asarray(jc2.p1 - jc.p1)).max()) > 0.0 or case == "blocked"
    for _ in range(30):                 # settle to rest
        jc2 = JMV.settle_movable_cobjs(jc2, 0.0)
        tc2 = TMV.settle_movable_cobjs(tc2, 0.0)
    _same(tc2.p1, jc2.p1, tol=0.0, what="settle p1")


def test_settle_lands_on_cobj_top_and_object_pushes_match_jax():
    # test_gaps.py::test_movable_settle_lands_on_cobj_top
    jc = _pack([((0, 0, 0), (1, 1, 1)), ((0.2, 0.2, 1.015), (0.8, 0.8, 1.515))], [1])
    tc = _port(jc, convert.cobj_set)
    for _ in range(30):
        jc, tc = JMV.settle_movable_cobjs(jc, -10.0), TMV.settle_movable_cobjs(tc, -10.0)
    _same(tc.p1, jc.p1, tol=0.0, what="p1")
    assert abs(float(tc.p1[1, 2]) - 1.0) < 1e-4
    rg = np.random.default_rng(2)
    obj = [rg.uniform(-0.2, 1.2, 64).astype(np.float32) for _ in range(5)] + \
        [rg.uniform(0.01, 0.1, 64).astype(np.float32), rg.uniform(0.5, 2, 64).astype(np.float32)]
    jp = JMV.object_pushes(jc, *(jnp.asarray(a) for a in obj))
    tp = TMV.object_pushes(tc, *(torch.as_tensor(a) for a in obj))
    for a, b in zip(tp, jp):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-6)
    assert float(np.abs(np.asarray(jp[0])).sum()) > 0.0


def _two_cubes(ped, box):
    """test_movable_rotate.py's pedestal + movable box, as a JAX CobjSet."""
    c = jempty(4)
    return c._replace(
        shape=c.shape.at[0].set(COLL_CUBE).at[1].set(COLL_CUBE),
        p1=c.p1.at[0].set(jnp.asarray(ped[0], jnp.float32)).at[1].set(
            jnp.asarray(box[0], jnp.float32)),
        p2=c.p2.at[0].set(jnp.asarray(ped[1], jnp.float32)).at[1].set(
            jnp.asarray(box[1], jnp.float32)),
        is_movable=c.is_movable.at[1].set(True))


TIP_CASES = {
    "overhang": (((0.0, 0.0, 0.0), (2.0, 1.0, 1.0)), ((1.7, 0.2, 1.0), (2.9, 0.8, 1.6))),
    "stable": (((0.0, 0.0, 0.0), (2.0, 1.0, 1.0)), ((0.5, 0.2, 1.0), (1.5, 0.8, 1.6))),
    "floor_contact": (((0.0, 0.0, 0.0), (1.0, 1.0, 0.2)), ((0.85, 0.2, 0.2), (1.25, 0.6, 0.6))),
    "quarter_turn": (((0.0, 0.0, 0.0), (1.0, 1.0, 3.0)), ((0.95, 0.2, 3.0), (1.15, 0.4, 3.2))),
    "on_top": (((0.0, 0.0, 0.0), (1.0, 1.0, 0.4)), ((0.3, 0.3, 0.4), (0.6, 0.6, 0.7))),
    "diagonal_y": (((0.0, 0.0, 0.0), (1.0, 1.0, 1.0)), ((0.3, 0.6, 1.0), (0.7, 1.5, 1.3))),
}


@pytest.mark.parametrize("case", sorted(TIP_CASES))
def test_tipping_and_rotation_match_jax(case):
    """test_gaps.py::test_movable_tipping and test_movable_rotate.py: the
    support decisions, tip_cube/apply_tipping, rotate_cube_to_rest and
    binary_search_drop on the same pedestal-and-box scenes."""
    jc = _two_cubes(*TIP_CASES[case])
    tc = _port(jc, convert.cobj_set)
    for fn in ("support_region", "check_unstable", "check_unstable_hull"):
        assert getattr(TMV, fn)(tc, 1, 0.0) == getattr(JMV, fn)(jc, 1, 0.0), fn
    np.testing.assert_array_equal(TMV.support_points(tc, 1, 0.0), JMV.support_points(jc, 1, 0.0))
    ja, ta = JMV.get_cobj_rot_axis(jc, 1, 0.0), TMV.get_cobj_rot_axis(tc, 1, 0.0)
    assert (ja is None) == (ta is None)
    if ja is not None:
        for x, y in zip(ta, ja):
            np.testing.assert_array_equal(x, y)
    _same(TMV.apply_tipping(tc, 0.0), JMV.apply_tipping(jc, 0.0), tol=0.0, what="tipped")
    (jr, jrot), (tr, trot) = JMV.rotate_cube_to_rest(jc, 1, 0.0), TMV.rotate_cube_to_rest(tc, 1, 0.0)
    assert jrot == trot
    _same(tr, jr, tol=0.0, what="rotated")
    assert TMV.binary_search_drop(tc, 1, 0.0, 2.0) == JMV.binary_search_drop(jc, 1, 0.0, 2.0)
    if case == "overhang":
        assert JMV.check_unstable(jc, 1, 0.0) == (1, 0) and jrot


def test_hull_axis_and_mesh_alignment_match_jax():
    """test_physics.py::test_movable_hull_rotate_to_rest's corner post and
    test_movable_rotate.py's sloped mesh."""
    sp = JSC.SceneParse()
    sp.cobjs.append(JSC.RawCobj(JSC.COLL_CUBE, (0.0, 0.0, 0.0), (0.25, 0.25, 1.0),
                                layer=JSC.CobjLayer()))
    sp.cobjs.append(JSC.RawCobj(JSC.COLL_CUBE, (0.0, 0.0, 1.0), (1.0, 1.0, 1.1),
                                layer=JSC.CobjLayer(), movable=True))
    jc = JSC.pack_cobjs(sp)
    tc = _port(jc, convert.cobj_set)
    ja, ta = JMV.get_cobj_rot_axis(jc, 1, -10.0), TMV.get_cobj_rot_axis(tc, 1, -10.0)
    for x, y in zip(ta, ja):
        np.testing.assert_array_equal(x, y)
    assert abs(ja[1][0]) > 0.3 and abs(ja[1][1]) > 0.3          # a diagonal axis
    pts = np.random.default_rng(1).uniform(0, 1, (12, 2))
    np.testing.assert_array_equal(TMV.convex_hull_2d(pts), JMV.convex_hull_2d(pts))
    jw, tw = JWorld(), TWorld()
    xs = np.linspace(-jw.x_scene, jw.x_scene, jw.mesh_x, dtype=np.float32)
    mesh = np.broadcast_to(0.25 * xs + 0.1 * np.sin(3 * xs)[:, None],
                           (jw.mesh_y, jw.mesh_x)).copy()
    c = jempty(2)
    c = c._replace(shape=c.shape.at[0].set(COLL_CUBE),
                   p1=c.p1.at[0].set(jnp.asarray([-0.2, -0.3, 0.0])),
                   p2=c.p2.at[0].set(jnp.asarray([0.2, 0.1, 0.4])),
                   is_movable=c.is_movable.at[0].set(True))
    jo, jrot = JMV.rotate_to_align_with_mesh(c, 0, mesh, jw)
    to, trot = TMV.rotate_to_align_with_mesh(_port(c, convert.cobj_set), 0,
                                             torch.as_tensor(mesh), tw)
    assert jrot and trot
    _same(to, jo, tol=0.0, what="aligned")


# ---- local wind -----------------------------------------------------------------

def test_local_wind_field_matches_jax():
    """test_physics.py::test_local_wind_contour_following's slope, plus
    random points over a bumpy mesh (under, near and above the surface),
    with a drifting texture offset and a seed."""
    jw, tw = JWorld(), TWorld()
    xx = np.linspace(-1, 1, jw.mesh_x, dtype=np.float32)
    rg = np.random.default_rng(4)
    slope = np.tile(xx * 0.5, (jw.mesh_y, 1))
    bumpy = (slope + 0.2 * rg.standard_normal((jw.mesh_y, jw.mesh_x))).astype(np.float32)
    n = 512
    pts = [rg.uniform(-3.9, 3.9, n).astype(np.float32), rg.uniform(-3.9, 3.9, n).astype(np.float32),
           rg.uniform(-1.5, 2.5, n).astype(np.float32)]
    pts[0][:3], pts[1][:3], pts[2][:3] = 0.0, 0.0, [-0.5, 0.02, 5.0]
    for mesh, kw in ((slope, {}), (bumpy, {"t_offset": 3.7, "seed": 9})):
        wind = np.asarray([0.5, -0.2, 0.1], np.float32)
        jo = JPS.local_wind_field(*(jnp.asarray(a) for a in pts), jnp.asarray(wind),
                                  jnp.asarray(mesh), jw, zbottom=-1.0, ztop=2.0, **kw)
        to = TPS.local_wind_field(*(torch.as_tensor(a) for a in pts), torch.as_tensor(wind),
                                  torch.as_tensor(mesh), tw, zbottom=-1.0, ztop=2.0, **kw)
        for a, b in zip(to, jo):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-6)
    assert float(to[0][0]) == 0.0 and abs(float(to[0][2]) - 0.5) < 1e-6

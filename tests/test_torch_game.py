"""Torch port vs JAX package: FPS game mode: the smiley AI
(`gameplay/ai`), weapons, blasts, smileys, scores and routing
(`gameplay/game`), the explosion frame (`gameplay/frame`), waypoints,
teleporters, spray paint, and the app's game loop
(`app.run_ground(game=True)`, `main(["--game", ...])`).

The JAX package draws threefry keys where the port takes draws as inputs:
the tests draw them from the same keys (`_ai_draws`, `JaxDraws`).  The
firing-error stream is numpy in both packages and is reset in both before
each comparison.  The cases of tests/test_ai.py run as parity cases.
Tolerances: floats within 1e-6 absolute (1e-5 over several steps) plus
1e-6 relative (XLA fuses a jitted step's arithmetic, so values in the
hundreds, such as health, can differ by a float32 unit); integer fields,
masks, decisions and printed rows equal."""

import contextlib
import copy
import io
import json

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import w3d  # noqa: F401
from w3d import app as JAPP
from w3d.gameplay import ai as JAI, game as JGG, frame as JGF, waypoints as JWP
from w3d.gameplay import teleport as JTP, spray as JSP, player as JPL
from w3d.models import world as JWM
from w3d.physics import destroy as JD, particles as JPP, step as JPS, types as JT
from w3d.scene import cobj as JSC, loader as JL
from w3d.utils.constants import WorldConst as JWorld
from w3d.water import ripples as JWR

from w3d_torch import app as TAPP, convert
from w3d_torch.gameplay import ai as TAI, game as TGG, frame as TGF, waypoints as TWP
from w3d_torch.gameplay import teleport as TTP, spray as TSP
from w3d_torch.physics import particles as TPP, types as TT
from w3d_torch.utils.constants import WorldConst as TWorld

from torch_port_util import np_tree, seven_shape_scene

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
        np.testing.assert_allclose(a, b, rtol=1e-6 if tol else 0, atol=tol, err_msg=what)
    else:
        np.testing.assert_array_equal(a.astype(np.int64), b.astype(np.int64), err_msg=what)


def _ai_draws(key, P):
    """`step_smileys_ai`'s threefry draws from its key, as AIDraws."""
    _sel, k_sw, k_cad, k_wander = jax.random.split(key, 4)
    t = lambda a: torch.as_tensor(np.array(a))
    return TAI.AIDraws(t(jax.random.uniform(k_sw, (P, JAI.NUM_W))),
                       t(jax.random.uniform(k_cad, (P,))),
                       t(jax.random.normal(k_wander, (P,))),
                       t(jax.random.normal(jax.random.fold_in(k_wander, 1), (P,))))


def _cobjs(kind):
    sp = JSC.SceneParse()
    if kind == "open":      # one far-away cube (no occlusion anywhere)
        sp.cobjs.append(JSC.RawCobj(JSC.COLL_CUBE, (50, 50, 0), (51, 51, 1),
                                    layer=JSC.CobjLayer()))
    elif kind == "wall":    # a tall wall on the y axis
        sp.cobjs.append(JSC.RawCobj(JSC.COLL_CUBE, (-0.05, -10, -1), (0.05, 10, 3),
                                    layer=JSC.CobjLayer()))
    else:
        sp = seven_shape_scene(JSC)
    jc = JSC.pack_cobjs(sp)
    return jc, convert.cobj_set(np_tree(jc), "cpu")


def _two_smileys(d=0.5, team2=1):
    s = JAI.make_ai_smileys(jax.random.key(0), 2)
    return s._replace(x=jnp.asarray([-d / 2, d / 2]), y=jnp.zeros(2), z=jnp.zeros(2),
                      team=jnp.asarray([0, team2], jnp.int32))


def _edit(s, case):
    rocket = JGG.WEAPON_INDEX["rocket"]
    return {
        "fires": lambda: s,
        "memory": lambda: s,
        "expires": lambda: s._replace(tmem=jnp.asarray([JAI.MEM_FRAMES + 1, 0])),
        "no_ammo": lambda: s._replace(weapon=jnp.full((2,), rocket, jnp.int32),
                                      ammo=s.ammo.at[:, rocket].set(0)),
        "flee": lambda: s._replace(health=jnp.asarray([10.0, 100.0])),
        "stuck": lambda: s._replace(stuck=jnp.asarray([JAI.STUCK_FRAMES + 5, 0])),
    }[case]()


AI_CASES = {   # tests/test_ai.py: (scene, distance, second team, steps)
    "fires": ("open", 0.5, 1, 1), "wall": ("wall", 1.0, 1, 1),
    "same_team": ("open", 0.5, 0, 1), "memory": ("open", 3.0, 1, 2),
    "expires": ("open", 3.0, 1, 2), "no_ammo": ("open", 0.5, 1, 1),
    "flee": ("open", 1.0, 1, 1), "stuck": ("open", 0.5, 1, 1),
}


@pytest.mark.parametrize("case", sorted(AI_CASES))
def test_step_smileys_ai_matches_jax(case):
    kind, d, team2, steps = AI_CASES[case]
    jc, tc = _cobjs(kind)
    js = _two_smileys(d, team2)
    if case not in ("memory", "expires"):
        js = _edit(js, case) if case in ("no_ammo", "flee", "stuck") else js
    ts = convert.smiley_ai(np_tree(js), "cpu")
    for k in range(steps):
        if k == 1:       # hide the enemy: pursue the memory (or forget it)
            js = js._replace(x=js.x.at[1].set(100.0), y=js.y.at[1].set(100.0))
            if case == "expires":
                js = _edit(js, case)
            ts = convert.smiley_ai(np_tree(js), "cpu")
        key = jax.random.key(k + 1 if case != "no_ammo" else 3)
        js, jf, jr = JAI.step_smileys_ai(js, key, jc)
        ts, tf, tr = TAI.step_smileys_ai(ts, _ai_draws(key, 2), tc)
        _same(ts, js, what=case)
        _same(tf, jf, what="fire")
        _same(tr, jr, what="route")
    tv = ts.tvis.tolist()
    assert {"fires": tv == [1, 1] and bool(tf.all()), "wall": tv == [0, 0],
            "same_team": tv == [0, 0] and not bool(tf.any()), "memory": tv[0] == 2,
            "expires": tv[0] == 0, "no_ammo": int(ts.weapon[0]) != JGG.WEAPON_INDEX["rocket"],
            "flee": float(ts.x[0]) < -0.5, "stuck": bool(tr[0]) == (int(ts.stuck[0]) >= 30),
            }[case]


def test_step_smileys_ai_population_matches_jax():
    """Eight smileys over the seven-shape scene (every family in the line
    of sight rays), ten steps with per-step keys."""
    jc, tc = _cobjs("seven")
    js = JAI.make_ai_smileys(jax.random.key(4), 8, spread=2.0)
    ts = convert.smiley_ai(np_tree(js), "cpu")
    fired = 0
    for k in range(10):
        key = jax.random.fold_in(jax.random.key(9), k)
        js, jf, jr = JAI.step_smileys_ai(js, key, jc)
        ts, tf, tr = TAI.step_smileys_ai(ts, _ai_draws(key, 8), tc)
        _same(ts, js, tol=1e-5, what=f"step {k}")
        _same(tf, jf, what="fire")
        fired += int(tf.sum())
    assert fired > 0 and (ts.tvis.numpy() == 1).any() and (ts.tvis.numpy() == 0).any()


def test_weapon_choice_and_range_match_jax():
    s = _two_smileys(d=1.0)
    ts = convert.smiley_ai(np_tree(s), "cpu")
    for i in range(8):
        key = jax.random.key(i)
        for in_r, uw in ((True, False), (False, False), (True, True)):
            a, b = jnp.full(2, in_r), jnp.full(2, uw)
            jw = JAI.check_switch_weapon(s, key, a, b)
            tw = TAI.check_switch_weapon(ts, torch.as_tensor(np.array(
                jax.random.uniform(key, (2, JAI.NUM_W)))), torch.full((2,), in_r),
                torch.full((2,), uw))
            _same(tw, jw, what="weapon")
    for w in ("sball", "ball", "rocket", "m16"):
        s2 = s._replace(weapon=jnp.full((2,), JGG.WEAPON_INDEX[w], jnp.int32))
        t2 = convert.smiley_ai(np_tree(s2), "cpu")
        for dx, dz, vx in ((2.8, 0.0, 0.0), (2.0, 2.6, 0.0), (0.5, 0.0, 10.0), (1.0, 0.0, 0.0)):
            args = (s2.x + dx, s2.y, s2.z + dz, jnp.asarray([vx, -vx]), jnp.zeros(2),
                    jnp.asarray([True, False]))
            _same(TAI.target_in_range(t2, *(torch.as_tensor(np.array(a)) for a in args)),
                  JAI.target_in_range(s2, *args), what=f"range {w}")


def _objects(n=64, seed=2, dead=0.3):
    rg = np.random.default_rng(seed)
    st = JPS.make_state(rg.uniform(-1.5, 1.5, (n, 3)).astype(np.float32),
                        rg.normal(0, 0.5, (n, 3)).astype(np.float32),
                        np.full(n, JT.type_id("BALL")), JTABLE)
    return st._replace(
        status=jnp.asarray(np.where(rg.uniform(size=n) < dead, 0, 1), jnp.int32),
        health=jnp.asarray(rg.uniform(20, 120, n).astype(np.float32)))


def test_fire_weapon_and_hitscan_match_jax():
    jc, tc = _cobjs("seven")
    js = _objects()
    ts = convert.object_state(np_tree(js), "cpu")
    JGG.reset_fire_stream(0)
    TGG.reset_fire_stream(0)
    free = np.where(np.asarray(js.status) == 0)[0]
    live = np.where(np.asarray(js.status) > 0)[0]
    pos = np.stack([np.asarray(js.px), np.asarray(js.py), np.asarray(js.pz)], 1)
    hits = 0
    for k, w in enumerate(("rocket", "sball", "m16", "shotgun", "grenade", "laser", "m16")):
        wi = JGG.WEAPON_INDEX[w]
        # aimed at a live ball from 0.5 away
        target = pos[live[3 * k]]
        origin = tuple(float(v) for v in target + [0.3, -0.4, 0.0])
        d = tuple(float(v) for v in target - np.asarray(origin))
        if JGG.WEAPONS[wi][1] is None:
            js, jh, jn = JGG.fire_hitscan(js, jc, origin, d, wi, JTABLE)
            ts, th, tn = TGG.fire_hitscan(ts, tc, origin, d, wi, TTABLE)
            _same(th, jh, what=f"{w} hits")
            assert int(tn) == int(jn)
            hits += int(th.sum())
        else:
            js = JGG.fire_weapon(js, free[k:k + 1].tolist(), wi, origin, d, JTABLE)
            ts = TGG.fire_weapon(ts, free[k:k + 1].tolist(), wi, origin, d, TTABLE)
        _same(ts, js, what=w)
    assert hits > 0 and JGG._FIRE_SEQ[0] == TGG._FIRE_SEQ[0] == 7
    # a blast, the simple smileys, scores and blood decals
    before = int((np.asarray(js.status) > 0).sum())
    js = JGG.apply_blast(js, 0.1, 0.2, 0.0, 0.8, 1000.0)
    ts = TGG.apply_blast(ts, 0.1, 0.2, 0.0, 0.8, 1000.0)
    _same(ts, js, what="blast")
    assert int((ts.status > 0).sum()) < before
    key = jax.random.key(3)
    jsm = JGG.make_smileys(key, 6, spread=1.0)
    tsm = TGG.make_smileys(np.array(jsm.x), np.array(jsm.y), np.array(jsm.team), device="cpu")
    _same(tsm, jsm, tol=0.0, what="smileys")
    for _ in range(20):
        jsm, jf = JGG.step_smileys(jsm, key)
        tsm, tf = TGG.step_smileys(tsm)
        _same(tsm, jsm, what="smiley step")
        _same(tf, jf, what="smiley fire")
    jsc, tsc = JGG.make_scores(4), TGG.make_scores(4, device="cpu")
    att, dam, kill = [0, 2, 2, 3], [10.0, 5.0, 1.0, 7.5], [False, True, True, False]
    jsc = JGG.credit_death(JGG.credit_damage(jsc, jnp.asarray(att), jnp.asarray(dam),
                                             jnp.asarray(kill)), jnp.asarray([1, 1]))
    tsc = TGG.credit_death(TGG.credit_damage(tsc, torch.tensor(att), torch.tensor(dam),
                                             torch.tensor(kill)), torch.tensor([1, 1]))
    _same(tsc, jsc, tol=0.0, what="scores")
    mask = np.zeros(64, bool)
    mask[[3, 9, 40]] = True
    jdc = JGG.spawn_blood_decals(JPP.make_decals(8), js, jnp.asarray(mask), key)
    tdc = TGG.spawn_blood_decals(TPP.make_decals(8, device="cpu"), ts, torch.as_tensor(mask))
    _same(tdc, jdc, tol=0.0, what="blood")


def test_routing_waypoints_and_teleporters_match_jax():
    """test_ai.py::test_route_interop_with_waypoint_layer, waypoints built
    on a mesh, A*, and test_gaps.py::test_teleporters_and_jump_pads."""
    rg = np.random.default_rng(3)
    mesh = (0.3 * rg.standard_normal((32, 32))).astype(np.float32)
    nz = rg.uniform(0.5, 1.0, (32, 32)).astype(np.float32)
    jw, tw = JWorld(mesh_x=32, mesh_y=32), TWorld(mesh_x=32, mesh_y=32)
    jg = JWP.build_waypoints(jnp.asarray(mesh), jnp.asarray(nz), -0.2, jw, seed=4, max_points=40)
    tg = TWP.build_waypoints(torch.as_tensor(mesh), torch.as_tensor(nz), -0.2, tw, seed=4,
                             max_points=40)
    for a, b in zip(tg, jg):
        np.testing.assert_array_equal(a, b)
    g = convert.waypoint_graph(jg)
    for s0, g0 in ((0, 17), (3, 3), (5, 30)):
        assert TWP.run_a_star(g, s0, g0) == JWP.run_a_star(jg, s0, g0)
    s = JAI.make_ai_smileys(jax.random.key(1), 5, spread=3.0)
    s = s._replace(tx=-s.x, ty=s.y[::-1])
    ts = convert.smiley_ai(np_tree(s), "cpu")
    jr = JGG.route_smileys(s, jg)
    tr = TGG.route_smileys(ts, g)
    for a, b in zip(tr, jr):
        _same(a, b, tol=0.0, what="route")
    pos_j, pos_t = jnp.zeros(5, jnp.int32), torch.zeros(5, dtype=torch.int32)
    for _ in range(80):
        s, pos_j = JGG.follow_paths(s, *jr, pos_j, speed=0.05)
        ts, pos_t = TGG.follow_paths(ts, *tr, pos_t, speed=0.05)
    _same(ts, s, tol=1e-5, what="follow")
    _same(pos_t, pos_j, what="pos")
    assert int(pos_t.max()) > 0
    rows = [[0, 0, 0, 0.5, 5, 5, 5, 0], [2, 2, 0, 0.5, 0, 0, 0, 1], [0.3, 0, 0, 0.5, 1, 1, 1, 0]]
    jtp, ttp = JTP.make_teleporters(rows), TTP.make_teleporters(rows, device="cpu")
    st = JPS.make_state(np.array([[0.1, 0, 0], [2, 2, 0], [9, 9, 9], [0.5, 0.1, 0.0]]),
                        np.zeros((4, 3)), np.zeros(4, np.int32), JTABLE)
    _same(TTP.apply_teleporters(convert.object_state(np_tree(st), "cpu"), ttp),
          JTP.apply_teleporters(st, jtp), tol=0.0, what="teleport")
    s2 = s._replace(x=jnp.asarray([0.1, 2.0, 0.4, 9.0, 0.0]), y=jnp.zeros(5), z=jnp.zeros(5))
    _same(TTP.apply_teleporters_smileys(convert.smiley_ai(np_tree(s2), "cpu"), ttp),
          JTP.apply_teleporters_smileys(s2, jtp), tol=0.0, what="teleport smileys")


def test_spray_paint_matches_jax():
    jc, tc = _cobjs("seven")
    jw, tw = JWorld(mesh_x=32, mesh_y=32), TWorld(mesh_x=32, mesh_y=32)
    rg = np.random.default_rng(5)
    mesh = (0.2 * rg.standard_normal((32, 32)) - 2.5).astype(np.float32)
    jg, tg = JSP.make_paint_grid(jw), TSP.make_paint_grid(tw, device="cpu")
    jd, td = JPP.make_decals(8), TPP.make_decals(8, device="cpu")
    kinds = []
    for k, (cam, view) in enumerate((((0.0, 0.0, 3.5), (0.1, 0.05, -1.0)),     # down
                                     ((-3.0, -3.0, 3.0), (1.0, 1.0, -0.6)),
                                     ((3.5, 3.5, -2.0), (1.0, 1.0, -0.2)),     # off the mesh
                                     ((0.5, -3.0, 0.0), (0.0, 1.0, 0.0)))):
        jg, jd, jh = JSP.spray_paint(jg, jd, jnp.asarray(mesh), jc, cam, view, color_ix=k,
                                     world=jw)
        tg, td, th = TSP.spray_paint(tg, td, torch.as_tensor(mesh), tc, cam, view,
                                     color_ix=k, world=tw)
        assert jh == th
        _same(tg, jg, tol=0.0, what="paint")
        for f in TPP.DecalPool._fields:
            if f not in ("nx", "ny", "nz"):
                _same(getattr(td, f), getattr(jd, f), what=f"decal {f}")
        # a cobj hit's JAX normal is NaN on a scene with a torus (the one-hot
        # sums of ray_cobjs_nearest, tests/test_torch_ray.py); the port's is
        # the nearest slot's unit normal
        tn = np.stack([td.nx.numpy(), td.ny.numpy(), td.nz.numpy()])
        jn = np.stack([np.asarray(jd.nx), np.asarray(jd.ny), np.asarray(jd.nz)])
        ok = np.isfinite(jn).all(0)
        np.testing.assert_allclose(tn[:, ok], jn[:, ok], rtol=0, atol=1e-6)
        np.testing.assert_allclose(np.linalg.norm(tn[:, ~ok], axis=0), 1.0, atol=1e-5)
        kinds.append(int(np.asarray(jd.cobj_id)[k]) if jh else None)
    assert -1 in kinds and any(c is not None and c >= 0 for c in kinds)


def test_update_game_frame_matches_jax():
    """test_gaps.py::test_explosion_game_frame: a collided rocket beside a
    destroyable cube, bystanders hurt, fragments into dead slots; and a
    frame with nothing to explode."""
    sp = JSC.SceneParse()
    sp.cobjs.append(JSC.RawCobj(JSC.COLL_CUBE, (0.05, -0.1, -0.1), (0.25, 0.1, 0.1)))
    jc = JSC.pack_cobjs(sp)
    jds = JD.make_destroy_state(jc, jnp.full(jc.size, JD.DESTROYABLE))
    tc = convert.cobj_set(np_tree(jc), "cpu")
    tds = convert.destroy_state(np_tree(jds), "cpu")
    n = 32
    pos = np.zeros((n, 3), np.float32)
    pos[1:] = np.random.default_rng(0).uniform(-0.2, 0.2, (n - 1, 3))
    st = JPS.make_state(pos, np.zeros((n, 3)), np.full(n, JT.type_id("BALL")), JTABLE)
    st = st._replace(otype=st.otype.at[0].set(JT.type_id("ROCKET")).at[5].set(
                         JT.type_id("GRENADE")),
                     flags=st.flags.at[0].set(jnp.uint32(JT.FL_COLLIDED)),
                     time=st.time.at[5].set(int(JTABLE.lifetime[JT.type_id("GRENADE")])),
                     status=st.status.at[20:].set(0),
                     health=st.health.at[1:].set(50.0))
    key = jax.random.key(4)
    jr = JGF.update_game_frame(st, jc, jds, JTABLE, key=key)
    tr = TGF.update_game_frame(convert.object_state(np_tree(st), "cpu"), tc, tds, TTABLE,
                               seed=int(np.asarray(jax.random.key_data(key))[-1]))
    np.testing.assert_array_equal(tr.explosions, jr.explosions)
    assert len(jr.explosions) == 2 and int(tr.cobjs.shape[0]) == 0
    _same(tr.state, jr.state, tol=1e-6, what="boom")
    _same(tr.cobjs.shape, jr.cobjs.shape, what="cobjs")
    frag = (np.asarray(jr.state.otype) == JT.type_id("FRAGMENT")) & (np.asarray(jr.state.status) > 0)
    assert frag.sum() == 8
    quiet = TGF.update_game_frame(convert.object_state(np_tree(JPS.make_state(
        pos, np.zeros((n, 3)), np.full(n, JT.type_id("BALL")), JTABLE)), "cpu"), tc, tds, TTABLE)
    assert len(quiet.explosions) == 0


# ---- the app's game loop --------------------------------------------------------

GAME_SCENE = """
l 0.7 0.6 0.6 0.6 1.0 -1
B -3 3 -3 3 -1.2 -0.9
B -0.1 0.1 -2 2 -0.9 0.6
S 1.0 1.0 -0.5 0.3
C -1 1 -1.0  -1 1 -0.2  0.15 0.1
"""
# the 32^2 fBm ground of tests/test_torch_scene_loader.py, water raised
GAME_CFG = ("mesh_size 32 32 8\nrand_seed 3\nmesh_seed 3\nnum_dodgeballs 16\n"
            "mesh_gen_mode 2\nwater_h_off 0.053 0\nload_coll_objs 1\n"
            "coll_obj_file scene.txt\n")


def _write(tmp_path):
    (tmp_path / "scene.txt").write_text(GAME_SCENE)
    (tmp_path / "cfg.txt").write_text(GAME_CFG)
    return str(tmp_path / "cfg.txt")


def _jax_frame_banded(s, substeps=4):
    """The JAX ground_frame (a scene without platforms) with the banded
    pair pass the port takes (the JAX CPU default is the block pass)."""
    s.objects = JPS.step_objects(s.objects, s.env, s.cobjs, s.table, substeps=substeps,
                                 world=s.world, obj_collisions=True, pair_method="banded")
    wpz = s.env.water_plane_z
    s.ripples, _ = JWR.step_ripples(s.ripples, wpz > s.terrain.mesh_height,
                                    jnp.maximum(wpz - s.terrain.mesh_height, 0.0))
    return s


class JaxDraws(TAPP.GameDraws):
    """The JAX app's draws: smileys from fold_in(key, 0), frame i's AI
    step from fold_in(key, 100 + i), its fragments from 500 + i."""

    def __init__(self, seed=11, smileys=None):
        super().__init__(seed)
        self.key = jax.random.key(seed)
        self.sm = smileys

    def smileys(self, n, device):
        sm = self.sm if self.sm is not None else JAI.make_ai_smileys(
            jax.random.fold_in(self.key, 0), n)
        return convert.smiley_ai(np_tree(sm), device)

    def ai(self, frame, n, device):
        return _ai_draws(jax.random.fold_in(self.key, 100 + frame), n)

    def fragment_seed(self, frame):
        return int(np.asarray(jax.random.key_data(jax.random.fold_in(self.key, 500 + frame)))[-1])


def _rows(fn, *args, **kw):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args, **kw)
    return out, [json.loads(line) for line in buf.getvalue().splitlines()]


def _armed(js):
    """The loaded scene with a third of its objects dead (free slots for
    projectiles) and a grenade among them whose timer runs out in the
    first frame (an explosion among the smileys)."""
    st = js.objects
    n = st.px.shape[0]
    status = np.asarray(st.status).copy()
    status[n // 3:2 * n // 3] = 0
    gren = JT.type_id("GRENADE")
    js.objects = st._replace(
        status=jnp.asarray(status), otype=st.otype.at[0].set(gren),
        time=st.time.at[0].set(int(JTABLE.lifetime[gren]) - 2),
        px=st.px.at[0].set(0.2), py=st.py.at[0].set(0.0), pz=st.pz.at[0].set(-0.5))
    return js


@pytest.mark.parametrize("case", ["load", "armed"])
def test_run_ground_game_matches_jax(tmp_path, monkeypatch, case):
    """Six game frames of the JAX `_run_ground_game` (frames with the
    banded pair pass) against the port's with the JAX draws: the printed
    rows equal but for `ms`, the final objects within 1e-5 (status,
    flags, types and ages equal).  "load": `run_ground(game=True)` from
    the config, 8 smileys (the app's default); "armed": the loop on the
    loaded scene with free slots, a grenade about to go off and 4 smileys placed
    within range of each other."""
    path = _write(tmp_path)
    monkeypatch.setattr(JWM, "ground_frame", _jax_frame_banded)
    with jax.disable_jit():
        js = JL.load_scene(path, num_objects=24)
    nsm, sm = 8, None
    if case == "armed":
        js = _armed(js)
        nsm = 4
        sm = JAI.make_ai_smileys(jax.random.key(2), nsm, spread=0.6)
    seed = 11 if case == "load" else 5
    draws = JaxDraws(seed, sm)
    ts = convert.ground_scene(np_tree_scene(js), "cpu") if case == "armed" else None
    JGG.reset_fire_stream(0)
    if sm is not None:
        # the JAX loop spawns its own smileys: hand it the placed ones
        monkeypatch.setattr(JAI, "make_ai_smileys", lambda key, n: sm)
    js, jrows = _rows(JAPP._run_ground_game, js, JPL.make_player(0.0, 0.0, 1.0), 6, nsm,
                      seed=seed)
    TGG.reset_fire_stream(0)
    if case == "load":
        ts, trows = _rows(TAPP.run_ground, path, 6, 24, game=True, num_smileys=nsm,
                          device="cpu", draws=draws)
    else:
        ts, trows = _rows(TAPP._run_ground_game, ts, None, 6, nsm, draws=draws)
    strip = lambda rows: [{k: v for k, v in r.items() if k != "ms"} for r in rows]
    assert strip(trows) == strip(jrows)
    assert all(set(r) == {"frame", "mode", "smileys", "shots", "explosions", "live", "ms"}
               for r in trows)
    r = np_tree(js.objects)
    for name in ("px", "py", "pz", "vx", "vy", "vz", "health"):
        np.testing.assert_allclose(getattr(ts.objects, name).numpy(), getattr(r, name),
                                   rtol=0, atol=1e-5, err_msg=name)
    for name in ("status", "flags", "otype", "time"):
        np.testing.assert_array_equal(getattr(ts.objects, name).numpy(),
                                      getattr(r, name).astype(np.int64), err_msg=name)
    if case == "armed":
        assert trows[-1]["shots"] > 0 and sum(x["explosions"] for x in trows) > 0
        assert trows[-1]["smileys"] < nsm or trows[-1]["live"] < 24


def np_tree_scene(js):
    """The JAX GroundScene with its arrays as numpy (copied)."""
    out = copy.copy(js)
    for f in ("terrain", "cobjs", "table", "objects", "env", "ripples", "light_grid",
              "platforms", "triggers", "scenery"):
        v = getattr(js, f)
        setattr(out, f, None if v is None else np_tree(v))
    return out


def test_main_runs_game_mode_on_the_cpu(tmp_path, monkeypatch):
    """`main(["--game", ...])` runs game mode (W3D_PLATFORM=cpu, as the JAX
    app's platform override) and prints one row a frame with the JAX
    app's keys; `run_ground(game=True)` with the same default draws prints
    the same rows."""
    path = _write(tmp_path)
    monkeypatch.setenv("W3D_PLATFORM", "cpu")
    argv = ["--config", path, "--game", "--frames", "3", "--objects", "16", "--smileys", "4"]
    TGG.reset_fire_stream(0)
    _, rows = _rows(TAPP.main, argv)
    assert [r["frame"] for r in rows] == [0, 1, 2]
    assert all(r["mode"] == "ground-game" and r["smileys"] <= 4 and r["live"] <= 16
               for r in rows)
    TGG.reset_fire_stream(0)
    _, again = _rows(TAPP.run_ground, path, 3, 16, game=True, num_smileys=4, device="cpu")
    strip = lambda rs: [{k: v for k, v in r.items() if k != "ms"} for r in rs]
    assert strip(again) == strip(rows)


def test_convert_carries_gameplay_states():
    """`convert` turns the JAX gameplay, destroy and particle states, group
    specs, teleporters and waypoint graphs into the port's, field by field
    and bitwise (a round trip through `to_numpy`); the port's makers build
    the same initial weapon states and scores as the JAX ones."""
    key = jax.random.key(2)
    rows = [[0, 0, 0, 0.5, 5, 5, 5, 0], [2, 2, 0, 0.5, 0, 0, 0, 1]]
    jc = JSC.pack_cobjs(seven_shape_scene(JSC))
    values = {
        convert.smiley_ai: JAI.make_ai_smileys(key, 5),
        convert.smiley_state: JGG.make_smileys(key, 5),
        convert.weapon_state: JGG.make_weapon_states(3),
        convert.game_score: JGG.make_scores(3),
        convert.destroy_state: JD.make_destroy_state(jc, jnp.arange(jc.size) % 4),
        convert.surface_damage: JD.add_decal(JD.make_surface_damage(8, 8, 4), 1.0, 2.0, 3.0),
        convert.bubble_pool: JPP.make_bubbles(6),
        convert.cloud_pool: JPP.make_clouds(6),
        convert.fire_pool: JPP.make_fires(6),
        convert.decal_pool: JPP.make_decals(6),
        convert.teleporters: JTP.make_teleporters(rows),
    }
    for fn, jv in values.items():
        _same(convert.to_numpy(fn(np_tree(jv), "cpu")), jv, tol=0.0, what=fn.__name__)
    from w3d.physics import groups as JG
    spec = JG.GroupSpec(JT.type_id("SAND"), 64, 0.5)
    assert tuple(convert.group_spec(spec)) == tuple(spec)
    g = JWP.build_waypoints(jnp.zeros((16, 16)), jnp.ones((16, 16)), -1.0, JWorld(16, 16, 4),
                            max_points=12)
    for a, b in zip(convert.waypoint_graph(g), g):
        np.testing.assert_array_equal(a, b)
    _same(TGG.make_weapon_states(3, device="cpu"), JGG.make_weapon_states(3), tol=0.0)
    _same(TGG.make_scores(3, device="cpu"), JGG.make_scores(3), tol=0.0)
    ws = convert.weapon_state(np_tree(JGG.make_weapon_states(2)), "cpu")
    jws = JGG.make_weapon_states(2)
    for ammo, cool in ((0, 0), (5, 0), (5, 3)):
        jws = jws._replace(ammo=jws.ammo.at[0, 2].set(ammo), cooldown=jws.cooldown.at[0].set(cool))
        ws = convert.weapon_state(np_tree(jws), "cpu")
        assert TGG.can_fire(ws, 0) == JGG.can_fire(jws, 0)

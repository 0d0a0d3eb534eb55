"""Torch port vs JAX package: fleets, the fleet step and the small fleet
behaviors of `universe/ships`, on the CPU.

The JAX fleet draws are threefry: the tests replay the key chains
(`jax_fleet_draws`, `jax_fleet_positions`); `step_fleet`'s key is unused
in the JAX step and the port's takes none.  The JAX functions run op by
op (`jax.disable_jit`): compiled, XLA rounds a few quotients one ulp
apart (a heading `dx / d`), and a fleet's targeting and thresholds turn
such ulps into chaos over tens of frames (a battle of 195 ships drifts
1e-6 in 16 frames, then flips a kill).  Op by op the port agrees with
the JAX step bit for bit here; the tests hold floats within 1e-5 and
integer and boolean fields equal."""

import numpy as np
import jax
import jax.numpy as jnp
import torch

import w3d  # noqa: F401
from w3d.universe import ships as JSH, ship_config as JSC

from w3d_torch.universe import ships as TSH, ship_config as TSC
from w3d_torch.utils.kernel_probe import write_ship_defs

from torch_port_util import jax_fleet_draws, jax_fleet_positions, same_tree


def _mixed_fleet(n=48, seed=3, spread=0.6):
    """A fleet of all 7 built-in classes (abominations and reapers
    included), two teams close enough to fight, with 4% of their armor
    and shields, so that ships die within tens of frames."""
    key = jax.random.key(seed)
    cls = np.arange(n) % JSH.NUM_SHIP_CLASSES
    jf = JSH.make_fleet(key, n, spread=spread, classes=cls)
    tf = TSH.make_fleet(jax_fleet_draws(key, n, spread=spread), classes=cls)
    weak = lambda f: f._replace(armor=f.armor * 0.04, shields=f.shields * 0.04)
    return weak(jf), weak(tf)


def test_make_fleet_matches_jax():
    for n, teams, spread in ((64, 2, 2.0), (9, 3, 0.5)):
        key = jax.random.key(n)
        same_tree(TSH.make_fleet(jax_fleet_draws(key, n, teams, spread)),
                  JSH.make_fleet(key, n, num_teams=teams, spread=spread), tol=0.0)
    key = jax.random.key(1)
    same_tree(TSH.make_fleet(jax_fleet_draws(key, 5), aligns=[0, 1, 1, 0, 2],
                             center=(1.0, -2.0, 0.5)),
              JSH.make_fleet(key, 5, aligns=[0, 1, 1, 0, 2], center=(1.0, -2.0, 0.5)), tol=0.0)


def test_step_fleet_matches_jax():
    """40 single steps of the mixed fleet, with and without firing points:
    deaths, the abomination eye and the reaper's block happen."""
    jf, tf = _mixed_fleet()
    fp = np.zeros((JSH.NUM_SHIP_CLASSES, 3), np.float32)
    fp[:, 0] = np.linspace(-0.5, 1.0, JSH.NUM_SHIP_CLASSES)
    with jax.disable_jit():
        for i in range(40):
            kw = {"fire_pts": fp} if i % 2 else {}
            jf = JSH.step_fleet(jf, jax.random.key(i), **kw)
            tf = TSH.step_fleet(tf, **kw)
            same_tree(tf, jf)
    alive = tf.alive.numpy()
    assert 0 < alive.sum() < len(alive)
    assert tf.attacked.any() and (tf.state_val[tf.cls == JSH.CLS_ABOMINATION] > 0.1).any()


def test_fleet_frames_chained_matches_jax_and_the_loop():
    """K chained frames: bitwise equal to K single steps in the port, and
    within 1e-5 of the JAX chain; with the 7-class table and with a
    parsed 40-class table (abomination and reaper ids from the reference
    enum)."""
    jf, tf = _mixed_fleet(seed=9)
    with jax.disable_jit():
        jc = JSH.fleet_frames_chained(jf, jax.random.key(3), 12)
    tc = TSH.fleet_frames_chained(tf, 12)
    same_tree(tc, jc)
    loop = TSH.fleet_frames_chained(tf, 0)
    for _ in range(12):
        loop = TSH.step_fleet(loop)
    for a, b in zip(tc, loop):
        assert torch.equal(a, b)
    tbl = np.zeros((TSC.NUM_US_CLASS, 9), np.float32)
    tbl[:7] = JSH.SHIP_CLASSES
    tbl[JSH.USC_ABOMIN_ID] = JSH.SHIP_CLASSES[JSH.CLS_ABOMINATION]
    tbl[JSH.USC_REAPER_ID] = JSH.SHIP_CLASSES[JSH.CLS_REAPER]
    cls = np.array([0, 1, 2, 3, JSH.USC_ABOMIN_ID, JSH.USC_REAPER_ID] * 8, np.int32)
    key = jax.random.key(4)
    jf = JSH.make_fleet(key, 48, spread=0.6, classes=cls, tbl=tbl)
    tf = TSH.make_fleet(jax_fleet_draws(key, 48, spread=0.6), classes=cls, tbl=tbl)
    jf, tf = (f._replace(armor=f.armor * 0.04, shields=f.shields * 0.04) for f in (jf, tf))
    with jax.disable_jit():
        jc = JSH.fleet_frames_chained(jf, key, 20, tbl=tbl, abomin_id=JSH.USC_ABOMIN_ID,
                                      reaper_id=JSH.USC_REAPER_ID)
    tc = TSH.fleet_frames_chained(tf, 20, tbl=torch.as_tensor(tbl),
                                  abomin_id=TSH.USC_ABOMIN_ID, reaper_id=TSH.USC_REAPER_ID)
    same_tree(tc, jc)
    assert not tc.alive.all()


def test_exact_tie_targets_the_first_enemy():
    """Two enemies at exactly the same distance: both packages target the
    lower index (argmin's first minimum), and so does the reaper's
    alignment test on the Gram-form distances."""
    z = np.zeros(3, np.float32)
    state = dict(px=np.float32([0.0, 0.3, -0.3]), py=z, pz=z, vx=z, vy=z, vz=z,
                 cls=np.int32([1, 5, 5]), align=np.int32([0, 1, 1]),
                 armor=np.float32([400, 1500, 1500]), shields=np.float32([200, 500, 500]),
                 cooldown=z, alive=np.ones(3, bool), dx=np.float32([0, 1, 1]),
                 dy=np.float32([1, 0, 0]), dz=z, state_val=z)
    jf = JSH.FleetState(**{k: jnp.asarray(v) for k, v in state.items()})
    tf = TSH.fleet_to(JSH.FleetState(**state), "cpu")
    with jax.disable_jit():
        jn = JSH.step_fleet(jf, jax.random.key(0))
    tn = TSH.step_fleet(tf)
    same_tree(tn, jn, tol=0.0)
    # the cruiser heads for ship 1 (+x), both reapers for the cruiser
    assert float(tn.vx[0]) > 0 and float(tn.dx[0]) == 1.0


def test_fleet_from_defs_and_parts_match_jax(tmp_path):
    """fleet_from_defs on the JAX position draw (156 ships of the written
    defs, two teams) and ship_parts with the parsed part geometry and the
    built-in one."""
    path = write_ship_defs(str(tmp_path / "ship_defs.txt"))
    jd, td = JSC.parse_ship_defs(path), TSC.parse_ship_defs(path)
    key = jax.random.key(2)
    js, jt, jo, jn = JSH.fleet_from_defs(jd, key)
    ts, tt, to, tn = TSH.fleet_from_defs(td, jax_fleet_positions(key))
    assert len(ts.px) == 156 and set(ts.align.tolist()) == {4, 5}
    for a, b in zip((tt, to, tn), (jt, jo, jn)):
        np.testing.assert_array_equal(a, b)
    same_tree(TSH.fleet_to(ts, "cpu"), js, tol=0.0)
    tf = TSH.fleet_to(ts, "cpu")
    for a, b in zip(TSH.ship_parts(tf, tt, to, tn), JSH.ship_parts(js, jt, jo, jn)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-6)
    jf, tf = _mixed_fleet()
    for a, b in zip(TSH.ship_parts(tf), JSH.ship_parts(jf)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-6)


def test_hazards_player_and_explosions_match_jax():
    """avoid_hazards (a black hole, hot stars, padding), a sequence of the
    player ship's controls (turns, thrust, hyperspeed latch, brake,
    reverse) and fleet_explosions."""
    jf, tf = _mixed_fleet(n=32, spread=0.3)
    stars = np.array([[0.35, 0.0, 0.0], [-0.2, 0.25, 0.0], [0.0, -0.3, 0.1]]
                     + [[1e9, 1e9, 1e9]] * 5, np.float32)
    rad = np.float32([0.02, 0.06, 0.04, 0, 0, 0, 0, 0])
    bh = np.array([True, False, False] + [False] * 5)
    with jax.disable_jit():
        jn = JSH.avoid_hazards(jf, jnp.asarray(stars), jnp.asarray(rad), jnp.asarray(bh))
    tn = TSH.avoid_hazards(tf, torch.as_tensor(stars), torch.as_tensor(rad), torch.as_tensor(bh))
    same_tree(tn, jn)
    assert not torch.equal(tn.vx, tf.vx)
    js, ts = JSH.make_player_ship(1, (0.5, -0.2, 0.1)), TSH.make_player_ship(1, (0.5, -0.2, 0.1),
                                                                             device="cpu")
    controls = [(JSH.MOVE_FRONT, 1.0, False), (JSH.MOVE_LEFT, 1.0, False),
                (JSH.MOVE_FRONT, 2.0, True), (JSH.MOVE_RIGHT, 0.5, False),
                (JSH.MOVE_FRONT, 1.0, False), (JSH.MOVE_STOP, 1.0, False),
                (JSH.MOVE_BACK, 1.0, False), (JSH.MOVE_STOP, 3.0, False)]
    with jax.disable_jit():
        for c in controls * 3:
            js = JSH.player_ship_frame(JSH.player_thrust(js, *c))
            ts = TSH.player_ship_frame(TSH.player_thrust(ts, *c))
            same_tree(ts, js)
    prev = tf
    with jax.disable_jit():
        for _ in range(30):
            jf2 = JSH.step_fleet(jf, jax.random.key(0))
            tf2 = TSH.step_fleet(prev)
            np.testing.assert_allclose(TSH.fleet_explosions(prev, tf2),
                                       JSH.fleet_explosions(jf, jf2), rtol=0, atol=1e-5)
            jf, prev = jf2, tf2
    assert len(TSH.fleet_explosions(tf, prev)) > 0


def test_orbits_colonies_docks_and_belts_match_jax():
    """orbit_step, colonize_step (colony ships claim planets; first
    arrival wins), orbital_regen and gen_asteroid_belt on JAX draws."""
    key = jax.random.key(6)
    n = 24
    cls = np.where(np.arange(n) % 3 == 0, JSH.CLS_COLONY, np.arange(n) % 4)
    jf = JSH.make_fleet(key, n, spread=0.4, classes=cls)
    tf = TSH.make_fleet(jax_fleet_draws(key, n, spread=0.4), classes=cls)
    planets = np.float32([[0.1, 0.05, 0.0], [-0.3, 0.2, 0.05], [0.25, -0.3, 0.0]])
    jc, tc = JSH.make_claims(3), TSH.make_claims(3, device="cpu")
    with jax.disable_jit():
        for i in range(60):
            jf = JSH.orbit_step(jf, (0.0, 0.0, 0.0), 0.3) if i % 5 == 4 else jf
            tf = TSH.orbit_step(tf, (0.0, 0.0, 0.0), 0.3) if i % 5 == 4 else tf
            jf, jc = JSH.colonize_step(jf, jnp.asarray(planets), jc)
            tf, tc = TSH.colonize_step(tf, torch.as_tensor(planets), tc)
            same_tree(tf, jf)
            same_tree(tc, jc)
        assert (tc.owner >= 0).any()
        damaged = tf._replace(armor=tf.armor * 0.5)
        jd = jf._replace(armor=jf.armor * 0.5)
        docks, dalign = np.float32([[0.0, 0.0, 0.0], [0.2, 0.2, 0.0]]), np.int32([0, 1])
        same_tree(TSH.orbital_regen(damaged, torch.as_tensor(docks), torch.as_tensor(dalign)),
                  JSH.orbital_regen(jd, jnp.asarray(docks), jnp.asarray(dalign)))
    ks = jax.random.split(key, 4)
    r = jax.random
    draws = TSH.BeltDraws(*(torch.as_tensor(np.array(a)) for a in (
        r.uniform(ks[0], (64,), minval=0.0, maxval=2 * np.pi), r.normal(ks[1], (64,)),
        r.normal(ks[2], (64,)), r.uniform(ks[3], (64,), minval=0.3, maxval=3.0))))
    for a, b in zip(TSH.gen_asteroid_belt(draws, 2.5), JSH.gen_asteroid_belt(key, 2.5, 64)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-5)

"""Torch port vs JAX package: the full weapon model of `universe/combat`
on the ship defs of `kernel_probe.write_ship_defs`, on the CPU.

Each frame's four threefry draws are replayed from the JAX keys
(`jax_combat_draws`).  The JAX step runs op by op (`jax.disable_jit`):
compiled, XLA rounds a few quotients one ulp apart, which targeting and
the thresholds turn into chaos over tens of frames (see
test_torch_ships.py); op by op the port agrees with it bit for bit on
these scenes.  Floats within 1e-5 (infinite ammo equal), integer and
boolean fields equal.  The scenes are those of tests/test_combat.py
(which needs the reference's shipped defs): travel time against a beam,
point defence, a bay launch, a boarding capture, none with shields up;
then two boarders capturing one ship in the same frame, and a whole
battle of the written fleets."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import w3d  # noqa: F401
from w3d.universe import ship_config as JSC, ships as JSH, combat as JCB

from w3d_torch.universe import ship_config as TSC, ships as TSH, combat as TCB
from w3d_torch.utils.kernel_probe import write_ship_defs

from torch_port_util import jax_combat_draws, jax_fleet_positions, same_tree, np_tree

# class and weapon ids of the written defs (SHIP_IDS / WEAP_IDS order)
FIGHTER, FRIGATE, DESTROYER, CARRIER, ARMAGEDDON = 0, 2, 3, 8, 9
BSHUTTLE, ANTI_MISS = 17, 28
W_TORPEDO, W_PT_DEF, W_EBEAM, W_FIGHTER = 15, 17, 6, 20


@pytest.fixture(scope="module")
def defs(tmp_path_factory):
    path = write_ship_defs(str(tmp_path_factory.mktemp("defs") / "ship_defs.txt"))
    return JSC.parse_ship_defs(path), TSC.parse_ship_defs(path)


@pytest.fixture(scope="module")
def tables(defs):
    jd, td = defs
    return JCB.build_combat_tables(jd), TCB.build_combat_tables(td, device="cpu")


def _mk(jd, rows, pad=0):
    """rows = [(cls, align, (x, y, z)), ...] -> a host FleetState at rest."""
    cls = np.array([r[0] for r in rows], np.int32)
    pos = np.array([r[2] for r in rows], np.float32)
    tbl = JSC.ship_class_table(jd)
    n = len(rows)
    z = np.zeros(n, np.float32)
    f = JSH.FleetState(px=pos[:, 0], py=pos[:, 1], pz=pos[:, 2], vx=z, vy=z, vz=z,
                       cls=cls, align=np.array([r[1] for r in rows], np.int32),
                       armor=tbl[cls, 2], shields=tbl[cls, 3], cooldown=z,
                       alive=np.ones(n, bool), ai=np.full(n, JSH.AI_ATT_ENEMY, np.int32),
                       attacked=np.zeros(n, bool), dx=np.ones(n, np.float32), dy=z, dz=z,
                       state_val=z)
    return JCB.pad_fleet(f, n + pad) if pad else f


def _only(jct, tct, cls_id, wid):
    """Both packages' tables with one class's loadout cut to one weapon."""
    sw = np.array(jct.slot_wid)
    sw[cls_id] = np.where(sw[cls_id] == wid, sw[cls_id], 0)
    return jct._replace(slot_wid=sw), tct._replace(slot_wid=torch.as_tensor(sw))


def _run(jcs, tcs, jct, tct, frames, seed=0):
    """`frames` frames of both packages on the same draws, held together
    after every frame; returns both states."""
    key = jax.random.key(seed)
    n, slots = tcs.cool.shape
    draws = jax_combat_draws(key, frames, n, slots)
    with jax.disable_jit():
        for i, k in enumerate(jax.random.split(key, frames)):
            jcs = JCB.step_combat(jcs, k, jct)
            tcs = TCB.step_combat(tcs, TCB.CombatDraws(*(t[i] for t in draws)), tct)
            same_tree(tcs, jcs)
    return jcs, tcs


def _start(jd, rows, jct, tct, pad=0, pool=64, **fleet):
    f = _mk(jd, rows, pad)._replace(**fleet)
    jcs = jax.tree.map(jnp.asarray, JCB.make_combat_state(f, jct, pool_size=pool))
    return jcs, TCB.make_combat_state(f, tct, pool_size=pool)


def test_tables_states_and_padding_match_jax(defs, tables):
    jd, td = defs
    jct, tct = tables
    same_tree(tct, jct, tol=0.0)
    w = tct.w_tbl.numpy()
    assert w[W_TORPEDO, TCB.WF_SPEED] > 0 and w[W_TORPEDO, TCB.WF_SEEK_DIST] > 0
    assert w[W_PT_DEF, TCB.WF_DAMAGE] < w[W_TORPEDO, TCB.WF_PROJ_ARMOR] < 2 * w[W_PT_DEF, TCB.WF_DAMAGE]
    assert int(w[W_FIGHTER, TCB.WF_AMMO_CLASS]) == FIGHTER and w[W_FIGHTER, TCB.WF_REGEN] > 0
    jf, _t, _o, _n = JSH.fleet_from_defs(jd, jax.random.key(1))
    tf, _t, _o, _n = TSH.fleet_from_defs(td, jax_fleet_positions(jax.random.key(1)))
    jp, tp = JCB.pad_fleet(jf, 195), TCB.pad_fleet(tf, 195)
    same_tree(TSH.fleet_to(tp, "cpu"), jp, tol=0.0)
    same_tree(TCB.make_combat_state(tp, tct, pool_size=256),
              JCB.make_combat_state(jp, jct, pool_size=256), tol=0.0)
    # a fleet of tensors pads too (to host arrays)
    same_tree(TSH.fleet_to(TCB.pad_fleet(TSH.fleet_to(tf, "cpu"), 170), "cpu"),
              JCB.pad_fleet(jf, 170), tol=0.0)


def test_projectile_travel_time_vs_beam(defs, tables):
    """Torpedoes take distance / speed frames to arrive; beams hit the
    same frame."""
    jd, _td = defs
    jct, tct = _only(*tables, ARMAGEDDON, W_TORPEDO)
    ai = np.array([JSH.AI_ATT_ENEMY, JSH.AI_NONE], np.int32)
    jcs, tcs = _start(jd, [(ARMAGEDDON, 0, (0, 0, 0)), (FRIGATE, 1, (0.05, 0, 0))],
                      jct, tct, ai=ai)
    sh0 = float(tcs.fleet.shields[1])
    jcs, tcs = _run(jcs, tcs, jct, tct, 3)
    assert float(tcs.fleet.shields[1]) == sh0 and int(tcs.proj.alive.sum()) >= 1
    jcs, tcs = _run(jcs, tcs, jct, tct, 12, seed=1)
    assert float(tcs.fleet.shields[1]) < sh0
    jct, tct = _only(*tables, DESTROYER, W_EBEAM)
    jcs, tcs = _start(jd, [(DESTROYER, 0, (0, 0, 0)), (FRIGATE, 1, (0.03, 0, 0))],
                      jct, tct, ai=ai)
    jcs, tcs = _run(jcs, tcs, jct, tct, 1)
    assert float(tcs.fleet.shields[1]) < sh0 and not tcs.proj.alive.any()


def test_point_defense_intercepts_torpedoes(defs, tables):
    jd, _td = defs
    jct, tct = _only(*_only(*tables, ARMAGEDDON, W_TORPEDO), ANTI_MISS, W_PT_DEF)
    rows = [(ARMAGEDDON, 0, (0, 0, 0)), (FRIGATE, 1, (0.04, 0, 0))] + \
        [(ANTI_MISS, 1, (0.04 + 0.004 * k, 0.004, 0)) for k in range(4)]
    jcs, tcs = _start(jd, rows, jct, tct)
    sh0 = float(tcs.fleet.shields[1])
    fired = False
    for seed in range(24):
        jcs, tcs = _run(jcs, tcs, jct, tct, 1, seed=seed)
        fired |= bool((tcs.cool[2:, 0] > 0).any())      # an escort's PD fired
    assert fired and float(tcs.fleet.shields[1]) == sh0, "the torpedo was shot down"


def test_bay_launch(defs, tables):
    """A carrier inside its fire_dist gate launches fighters into reserve
    slots for its team, spending bay ammo."""
    jd, _td = defs
    jct, tct = _only(*tables, CARRIER, W_FIGHTER)
    jcs, tcs = _start(jd, [(CARRIER, 0, (0, 0, 0)), (FRIGATE, 1, (0.25, 0, 0))], jct, tct,
                      pad=8)
    ammo0 = float(tcs.ammo[0, 0])
    jcs, tcs = _run(jcs, tcs, jct, tct, 12)
    spawned = tcs.fleet.alive[2:]
    assert int(spawned.sum()) >= 1
    assert (tcs.fleet.cls[2:][spawned] == FIGHTER).all() and (tcs.fleet.align[2:][spawned] == 0).all()
    assert float(tcs.ammo[0, 0]) < ammo0


def _disabled_target(jd, gap_rows, **kw):
    tbl = JSC.ship_class_table(jd)
    n = len(gap_rows)
    sh = np.array([tbl[r[0], 3] for r in gap_rows], np.float32)
    ar = np.array([tbl[r[0], 2] for r in gap_rows], np.float32)
    sh[0], ar[0] = 0.0, 0.2 * tbl[FRIGATE, 2]
    return dict(shields=sh, armor=ar, **kw) if n else kw


def test_boarding_capture_flips_alignment(defs, tables):
    jd, _td = defs
    jct, tct = tables
    tbl = JSC.ship_class_table(jd)
    gap = 0.8 * JCB.BOARD_REACH * (tbl[BSHUTTLE, 7] + tbl[FRIGATE, 7])
    rows = [(FRIGATE, 1, (gap, 0, 0)), (BSHUTTLE, 0, (0, 0, 0))]
    # the frigate holds still (its standoff would back it out of reach)
    jcs, tcs = _start(jd, rows, jct, tct, **_disabled_target(
        jd, rows, ai=np.array([JSH.AI_NONE, JSH.AI_ATT_ENEMY], np.int32)))
    crew0 = float(tcs.crew[1])
    jcs, tcs = _run(jcs, tcs, jct, tct, 12)
    assert int(tcs.fleet.align[0]) == 0 and bool(tcs.captured[0])
    assert float(tcs.crew[1]) < crew0


def test_no_capture_with_shields_up(defs, tables):
    jd, _td = defs
    jct, tct = tables
    tbl = JSC.ship_class_table(jd)
    gap = 0.8 * JCB.BOARD_REACH * (tbl[BSHUTTLE, 7] + tbl[FRIGATE, 7])
    jcs, tcs = _start(jd, [(BSHUTTLE, 0, (0, 0, 0)), (FRIGATE, 1, (gap, 0, 0))], jct, tct)
    jcs, tcs = _run(jcs, tcs, jct, tct, 6)
    assert int(tcs.fleet.align[1]) == 1 and not bool(tcs.captured[1])


def test_two_boarders_capture_one_ship(defs, tables):
    """Boarders of teams 0 and 2 both win their roll against the same
    disabled ship of team 1 in one frame: the capture goes to the one of
    the higher index (team 2), the JAX CPU scatter's last write, in both
    packages."""
    jd, _td = defs
    jct, tct = tables
    tbl = JSC.ship_class_table(jd)
    gap = 0.8 * JCB.BOARD_REACH * (tbl[BSHUTTLE, 7] + tbl[FRIGATE, 7])
    rows = [(FRIGATE, 1, (0, 0, 0)), (BSHUTTLE, 0, (-gap, 0, 0)), (BSHUTTLE, 2, (gap, 0, 0))]
    jcs, tcs = _start(jd, rows, jct, tct, **_disabled_target(jd, rows))
    crew = np.array([0.01, 10.0, 10.0], np.float32)    # both rolls win
    jcs, tcs = jcs._replace(crew=jnp.asarray(crew)), tcs._replace(crew=torch.as_tensor(crew))
    jcs, tcs = _run(jcs, tcs, jct, tct, 1)
    assert int(tcs.fleet.align[0]) == 2 and bool(tcs.captured[0])
    assert (tcs.crew[1:] == 5.0).all()                  # both boarded


def test_battle_and_chained_frames_match_jax(defs, tables):
    """The written fleets (156 ships padded to 195 slots, a pool of 256):
    12 frames against the JAX step; then 6 chained frames equal to the
    port's own loop bit for bit and to the JAX chain."""
    jd, td = defs
    jct, tct = tables
    jf, _t, _o, _n = JSH.fleet_from_defs(jd, jax.random.key(1))
    jp = JCB.pad_fleet(jf, 195)
    jcs = jax.tree.map(jnp.asarray, JCB.make_combat_state(jp, jct, pool_size=256))
    tcs = TCB.make_combat_state(jp, tct, pool_size=256)
    # close the gap so the fleets trade fire from the first frames
    shift = lambda f, m: f._replace(px=f.px - 0.17 * m)
    m = np.asarray(jp.align) == 5
    jcs = jcs._replace(fleet=shift(jcs.fleet, jnp.asarray(m)))
    tcs = tcs._replace(fleet=shift(tcs.fleet, torch.as_tensor(m)))
    jcs, tcs = _run(jcs, tcs, jct, tct, 12, seed=4)
    assert int(tcs.proj.alive.sum()) > 0 and bool(tcs.fleet.attacked.any())
    key = jax.random.key(7)
    draws = jax_combat_draws(key, 6, *tcs.cool.shape)
    chained = TCB.combat_frames_chained(tcs, draws, 6, tct)
    loop = tcs
    for i in range(6):
        loop = TCB.step_combat(loop, TCB.CombatDraws(*(t[i] for t in draws)), tct)
    same_tree(chained, np_tree(loop), tol=0.0)
    with jax.disable_jit():
        same_tree(chained, JCB.combat_frames_chained(jcs, key, 6, jct))

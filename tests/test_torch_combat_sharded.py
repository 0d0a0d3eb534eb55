"""Torch port vs JAX package: the ship-sharded combat frame
(`w3d_torch/parallel/combat.py`), the JAX dry run's phase 7.

One 4-rank gloo group on the CPU (`torch_rank_cases.combat_cases`) runs
every case once, in a module fixture; the JAX side runs phase 7 here on a
4-device mesh of conftest's virtual CPU devices (every [16n] leaf sharded
on a `ships` axis, 2 frames of the compiled `combat_frames_chained` on the
toy tables) and its threefry draws reach the port through
`jax_combat_draws`.  Bounds against JAX: tests/test_torch_combat.py's
(floats 1e-5, infinite ammo equal, integers and flags equal).  Against
the port's single-rank `step_combat` on the same draws: every field bit
for bit after every frame, in a battle of the written fleets and in
scenes whose events cross a slab edge (a projectile spawned into another
rank's pool slot, a fighter launched into another rank's fleet slot,
point defence against another rank's projectile, boarders and their
victims on different ranks).  The battle again with non-dyadic damages:
the ships' shields and armor (the impact sums over the pool) within 1e-5,
every other field bit for bit."""


import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
from jax.sharding import Mesh as JMesh, NamedSharding, PartitionSpec as P

import w3d  # noqa: F401
from w3d.universe import ships as JSH, combat as JCB
from __graft_entry__ import _toy_combat_tables

from w3d_torch import convert, dryrun
from w3d_torch.parallel import launch
from w3d_torch.universe import combat as TCB, ship_config as TSC, ships as TSH
from w3d_torch.utils.kernel_probe import write_ship_defs

import torch_rank_cases
from torch_port_util import jax_combat_draws, np_tree, same_tree

RANKS = 4
NSHIPS = 16 * RANKS
# class and weapon ids of the written defs (tests/test_torch_combat.py)
FRIGATE, CARRIER, ARMAGEDDON, BSHUTTLE, ANTI_MISS = 2, 8, 9, 17, 28
W_TORPEDO, W_PT_DEF, W_FIGHTER = 15, 17, 20
SLOTS, POOL = 16, 16                    # scenes: 4 ships and 4 pool slots a rank


@pytest.fixture(scope="module")
def phase7():
    """The JAX phase 7 on 4 devices: the whole start state (numpy), the
    tables, and the 2-frame result."""
    fl = JSH.make_fleet(jax.random.key(5), NSHIPS, num_teams=2)
    fl = fl._replace(cls=jnp.asarray(np.arange(NSHIPS, dtype=np.int32) % 4))
    ct = _toy_combat_tables()
    cstate = JCB.make_combat_state(fl, ct, pool_size=NSHIPS)
    start = np_tree(cstate)
    umesh = JMesh(np.array(jax.devices()[:RANKS]), axis_names=("ships",))
    us = NamedSharding(umesh, P("ships"))

    def shard(x):
        arr = jnp.asarray(x)
        return jax.device_put(arr, us) if arr.ndim >= 1 and arr.shape[0] == NSHIPS else arr
    cstate = jax.tree.map(shard, cstate)
    with umesh:
        out = JCB.combat_frames_chained(cstate, jax.random.key(7), 2,
                                        jax.tree.map(jnp.asarray, ct))
    return start, ct, out


@pytest.fixture(scope="module")
def tables(tmp_path_factory):
    path = write_ship_defs(str(tmp_path_factory.mktemp("defs") / "ship_defs.txt"))
    defs = TSC.parse_ship_defs(path)
    return defs, TCB.build_combat_tables(defs, device="cpu")


def _only(ct, *cuts):
    """The tables with each (class, weapon) class's loadout cut to that
    weapon."""
    sw = ct.slot_wid.clone()
    for cls_id, wid in cuts:
        sw[cls_id] = torch.where(sw[cls_id] == wid, sw[cls_id], 0)
    return ct._replace(slot_wid=sw)


def _scene(defs, ct, ships, pool=POOL, **fields):
    """ships = {slot: (cls, align, (x, y, z))} in a fleet of SLOTS slots
    (the rest dead) -> a CombatState at rest."""
    tbl = TSC.ship_class_table(defs)
    cls = np.zeros(SLOTS, np.int32)
    align = np.zeros(SLOTS, np.int32)
    pos = np.zeros((SLOTS, 3), np.float32)
    alive = np.zeros(SLOTS, bool)
    for i, (c, a, p) in ships.items():
        cls[i], align[i], pos[i], alive[i] = c, a, p, True
    z = np.zeros(SLOTS, np.float32)
    f = TSH.FleetState(px=pos[:, 0], py=pos[:, 1], pz=pos[:, 2], vx=z, vy=z, vz=z, cls=cls,
                       align=align, armor=tbl[cls, 2], shields=tbl[cls, 3], cooldown=z,
                       alive=alive, ai=np.full(SLOTS, TSH.AI_ATT_ENEMY, np.int32),
                       attacked=np.zeros(SLOTS, bool), dx=np.ones(SLOTS, np.float32), dy=z,
                       dz=z, state_val=z)._replace(**fields)
    return TCB.make_combat_state(f, ct, pool_size=pool)


def _disabled(defs, slot, **kw):
    """Fleet fields with the frigate at `slot` shields down and armor at
    20%."""
    tbl = TSC.ship_class_table(defs)
    sh = np.full(SLOTS, tbl[FRIGATE, 3], np.float32)
    ar = np.full(SLOTS, tbl[FRIGATE, 2], np.float32)
    sh[slot], ar[slot] = 0.0, 0.2 * tbl[FRIGATE, 2]
    return dict(shields=sh, armor=ar, **kw)


def _cases(defs, ct, phase7_start):
    gen = torch.Generator().manual_seed(21)
    draws = lambda cs, k: TCB.draw_combat(k, *cs.cool.shape, gen)
    cases = {}
    # the dry run's phase 7 on the JAX draws
    pcs = convert.combat_state(phase7_start, "cpu")
    cases["phase7"] = (pcs, dryrun.toy_combat_tables("cpu"),
                       jax_combat_draws(jax.random.key(7), 2, NSHIPS, 2), 2)
    # a battle of the written fleets: 156 ships in 200 slots, a pool of 256
    fl, _t, _o, _n = TSH.fleet_from_defs(
        defs, lambda n: np.random.default_rng(1).uniform(-1, 1, (n, 3)).astype(np.float32))
    bcs = TCB.make_combat_state(TCB.pad_fleet(fl, 200), ct, pool_size=256)
    bcs = bcs._replace(fleet=bcs.fleet._replace(
        px=bcs.fleet.px - 0.17 * (bcs.fleet.align == 5)))
    cases["battle"] = (bcs, ct, draws(bcs, 16), 16)
    # the same battle with every weapon's damage 1.1 times as much: beam,
    # PD and impact damages that are not exact in every order of summation
    nct = ct._replace(w_tbl=ct.w_tbl.clone())
    nct.w_tbl[:, TCB.WF_DAMAGE] *= 1.1
    ncs = TCB.make_combat_state(TCB.pad_fleet(fl, 200), nct, pool_size=256)
    ncs = ncs._replace(fleet=ncs.fleet._replace(
        px=ncs.fleet.px - 0.17 * (ncs.fleet.align == 5)))
    cases["battle_non_dyadic"] = (ncs, nct, draws(ncs, 16), 16)
    # a torpedo from ship 1 (rank 0) into pool slot 8 (rank 2): slots 0-7
    # hold live far-away projectiles of its own team
    tct = _only(ct, (ARMAGEDDON, W_TORPEDO))
    none = np.full(SLOTS, TSH.AI_NONE, np.int32)
    none[1] = TSH.AI_ATT_ENEMY
    tcs = _scene(defs, tct, {1: (ARMAGEDDON, 0, (0, 0, 0)), 6: (FRIGATE, 1, (0.05, 0, 0))},
                 ai=none)
    held = torch.arange(POOL) < 8
    pr = tcs.proj
    tcs = tcs._replace(proj=pr._replace(
        px=torch.where(held, 50.0 + torch.arange(POOL, dtype=torch.float32), pr.px),
        hp=torch.where(held, 1e9, pr.hp), ttl=torch.where(held, 1000.0, pr.ttl),
        target=torch.where(held, 1, pr.target), alive=held))
    cases["torpedo"] = (tcs, tct, draws(tcs, 3), 3)
    # a carrier on rank 3 launches into fleet slot 0 (rank 0)
    bct = _only(ct, (CARRIER, W_FIGHTER))
    ccs = _scene(defs, bct, {13: (CARRIER, 0, (0, 0, 0)), 14: (FRIGATE, 1, (0.25, 0, 0))})
    cases["bay"] = (ccs, bct, draws(ccs, 4), 4)
    # point defence on rank 1 against a torpedo in pool slot 0 (rank 0)
    pct = _only(ct, (ARMAGEDDON, W_TORPEDO), (ANTI_MISS, W_PT_DEF))
    rows = {0: (ARMAGEDDON, 0, (0, 0, 0)), 1: (FRIGATE, 1, (0.04, 0, 0))}
    rows.update({4 + k: (ANTI_MISS, 1, (0.04 + 0.004 * k, 0.004, 0)) for k in range(4)})
    pcs2 = _scene(defs, pct, rows)
    cases["pd"] = (pcs2, pct, draws(pcs2, 24), 24)
    # a shuttle on rank 1 boards a disabled frigate on rank 0
    tbl = TSC.ship_class_table(defs)
    gap = 0.8 * TCB.BOARD_REACH * (tbl[BSHUTTLE, 7] + tbl[FRIGATE, 7])
    ai = np.full(SLOTS, TSH.AI_ATT_ENEMY, np.int32)
    ai[0] = TSH.AI_NONE
    bcs2 = _scene(defs, ct, {0: (FRIGATE, 1, (gap, 0, 0)), 4: (BSHUTTLE, 0, (0, 0, 0))},
                  **_disabled(defs, 0, ai=ai))
    cases["board"] = (bcs2, ct, draws(bcs2, 12), 12)
    # two boarders on ranks 0 and 2 win against one frigate on rank 1: the
    # higher index (team 2) takes it
    two = _scene(defs, ct, {4: (FRIGATE, 1, (0, 0, 0)), 0: (BSHUTTLE, 0, (-gap, 0, 0)),
                            8: (BSHUTTLE, 2, (gap, 0, 0))}, **_disabled(defs, 4))
    crew = two.crew.clone()
    crew[0], crew[4], crew[8] = 10.0, 0.01, 10.0
    two = two._replace(crew=crew)
    cases["two_boarders"] = (two, ct, draws(two, 1), 1)
    return cases


@pytest.fixture(scope="module")
def ranks(phase7, tables):
    defs, ct = tables
    inp = _cases(defs, ct, phase7[0])
    res = launch.run_ranks(torch_rank_cases.combat_cases, RANKS, "gloo", "cpu", inp,
                           timeout=300)
    return inp, [r.value for r in res]


def _singles(case):
    cs, ct, draws, frames = case
    out = []
    for k in range(frames):
        cs = TCB.step_combat(cs, TCB.CombatDraws(*(t[k] for t in draws)), ct)
        out.append(cs)
    return out


def test_toy_tables_match_the_jax_ones(phase7):
    same_tree(dryrun.toy_combat_tables("cpu"), phase7[1], tol=0.0)


def test_phase7_matches_the_jax_sharded_call(phase7, ranks):
    """2 frames over 4 ranks against the JAX phase 7 on 4 devices; finite
    fleet and projectile positions (what the JAX phase asserts)."""
    _inp, out = ranks
    got = out[0]["phase7"][0][-1]
    assert bool(torch.isfinite(got.fleet.px).all()) and bool(torch.isfinite(got.proj.px).all())
    same_tree(got, phase7[2])


# the fleet fields that the sharded frame's impact sums over the pool reach
# (parallel/combat.py): held at 1e-5 when the damages are not dyadic
SUMMED = ("shields", "armor")


@pytest.mark.parametrize("case", ["phase7", "battle", "torpedo", "bay", "pd", "board",
                                  "two_boarders", "battle_non_dyadic"])
def test_sharded_frames_equal_the_single_rank_step(ranks, case):
    """Every rank's gathered state equals the port's one-rank step after
    every frame, bit for bit; with non-dyadic damages the `SUMMED` fields
    within 1e-5, and the ships do take damage."""
    inp, out = ranks
    bounded = SUMMED if case == "battle_non_dyadic" else ()
    for k, ref in enumerate(_singles(inp[case])):
        ref = convert.to_numpy(ref)
        for r in range(RANKS):
            got = convert.to_numpy(out[r][case][0][k])
            for name in bounded:
                same_tree(getattr(got.fleet, name), getattr(ref.fleet, name), 1e-5,
                          f"rank {r} frame {k} fleet.{name}")
            got = got._replace(fleet=got.fleet._replace(
                **{name: getattr(ref.fleet, name) for name in bounded}))
            same_tree(got, ref, 0.0, f"rank {r} frame {k}")
    if bounded:
        assert (ref.fleet.shields < inp[case][0].fleet.shields.numpy()).any()


def _counts(out, case):
    total = {}
    for o in out:
        for key, v in o[case][1].items():
            total[key] = total.get(key, 0) + v
    return total


def test_battle_crosses_rank_edges(ranks):
    """The battle's spawns, fighter launches, PD shots and impacts happen,
    and some of each have their other end on another rank."""
    _inp, out = ranks
    c = _counts(out, "battle")
    for key in ("spawned", "launched", "pd_shots", "impacts"):
        assert c[key] > 0 and c[key + "_cross_rank"] > 0, (key, c)


def test_torpedo_lands_in_another_ranks_pool_slot(ranks):
    _inp, out = ranks
    pr = out[0]["torpedo"][0][0].proj
    assert bool(pr.alive[8]) and int(pr.wid[8]) == W_TORPEDO and int(pr.team[8]) == 0
    assert out[2]["torpedo"][1]["spawned_cross_rank"] >= 1


def test_fighter_launches_into_another_ranks_slot(ranks):
    _inp, out = ranks
    f = out[0]["bay"][0][-1].fleet
    assert bool(f.alive[0]) and int(f.align[0]) == 0 and int(f.cls[0]) == 0
    assert out[0]["bay"][1]["launched_cross_rank"] >= 1


def test_point_defence_shoots_another_ranks_torpedo(ranks, tables):
    """The escorts on rank 1 fire point defence at the torpedoes in rank 0's
    pool slots, and the frigate keeps its shields."""
    defs, _ct = tables
    _inp, out = ranks
    states = out[0]["pd"][0]
    assert any(bool((s.cool[4:8, 0] > 0).any()) for s in states)
    assert out[1]["pd"][1]["pd_shots_cross_rank"] >= 1
    assert float(states[-1].fleet.shields[1]) == TSC.ship_class_table(defs)[FRIGATE, 3]


def test_boarding_across_ranks(ranks):
    _inp, out = ranks
    last = out[0]["board"][0][-1]
    assert int(last.fleet.align[0]) == 0 and bool(last.captured[0])
    assert out[0]["board"][1]["captures_cross_rank"] >= 1


def test_two_boarders_on_two_ranks_capture_one_ship(ranks):
    """tests/test_torch_combat.py's tie across three ranks: both rolls win,
    the boarder of the higher index (team 2, rank 2) takes the ship."""
    _inp, out = ranks
    last = out[0]["two_boarders"][0][-1]
    assert int(last.fleet.align[4]) == 2 and bool(last.captured[4])
    assert float(last.crew[0]) == 5.0 and float(last.crew[8]) == 5.0


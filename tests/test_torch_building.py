"""Torch port vs JAX package: the building session — clocks' display state
(`city/clocks`), host-stepped building people with elevators
(`people.BuildingPeopleSim`, `person_name`), malls and backrooms
(`city/mall_backrooms`), flooded basements (`city/building_water`),
interaction with light switches feeding building lighting
(`city/bldg_interact`) and building gameplay with zombies
(`city/bldg_gameplay`).

The host modules are copies, so their results are equal; the people's
float state holds within 1e-5 (their step is float32 arithmetic on the
device; XLA and PyTorch round a few products apart), integer and path
fields equal."""

import dataclasses

import numpy as np
import pytest
import torch

import w3d  # noqa: F401
from w3d.city import clocks as JCK, floorplan as JCF, people as JPE, room_content as JRC
from w3d.city import mall_backrooms as JMB, building_water as JBW
from w3d.city import bldg_interact as JBX, bldg_gameplay as JBG
from w3d.lighting import building_indir as JBI
from w3d.physics import step as JPS, types as JPT
from w3d.utils.rng import RandGen as JRand

from w3d_torch.city import clocks as TCK, floorplan as TCF, people as TPE, room_content as TRC
from w3d_torch.city import mall_backrooms as TMB, building_water as TBW
from w3d_torch.city import bldg_interact as TBX, bldg_gameplay as TBG
from w3d_torch.lighting import building_indir as TBI
from w3d_torch.physics import step as TPS, types as TPT
from w3d_torch.scene import cobj as SC
from w3d_torch.utils.constants import WorldConst
from w3d_torch.utils.rng import RandGen as TRand

from torch_port_util import one_torch_thread, same_tree  # noqa: F401


def test_clock_display_matches():
    """Clock time (12 and 24 hour), hand positions and the 7-segment
    display with and without seconds over a day's seconds: equal (hands
    within 1e-7); elevator floor labels equal."""
    secs = np.concatenate([np.arange(0, 86400, 997), [0, 43200, 3599, 86399, 46800]]).astype(np.int32)
    for h24 in (True, False):
        same_tree(TCK.clock_time(torch.as_tensor(secs), h24), JCK.clock_time(secs, h24), 0.0)
        h, m, s = JCK.clock_time(secs, h24)
        same_tree(TCK.hand_fracs(*TCK.clock_time(torch.as_tensor(secs), h24)),
                  JCK.hand_fracs(h, m, s), 1e-7)
    for show in (False, True):
        a, b = TCK.display_state(torch.as_tensor(secs).reshape(4, -1), show_seconds=show)
        c, d = JCK.display_state(secs.reshape(4, -1), show_seconds=show)
        np.testing.assert_array_equal(a.numpy(), np.asarray(c))
        np.testing.assert_array_equal(b.numpy(), np.asarray(d))
    for label in ("G", "3", "12", "B2", "P1", " 4"):
        assert TCK.elevator_floor_digits(label) == JCK.elevator_floor_digits(label)


@pytest.fixture(scope="module")
def tower():
    """A furnished 3-floor building with elevators, in both packages."""
    part = (0.0, 0.0, 0.0, 1.2, 0.9, 0.4)
    ji, ti = JCF.gen_interior(part, 3, 0.08, seed=7), TCF.gen_interior(part, 3, 0.08, seed=7)
    jo, to = JRC.furnish_rooms(ji, 0.08, seed=7), TRC.furnish_rooms(ti, 0.08, seed=7)
    assert ti.elevators
    return ji, ti, jo, to


def test_building_people_sim_matches(tower):
    """16 host-driven steps of 12 people with the building's elevator
    cars (calls from waiting and riding people) and re-routing of
    finished walkers: the people within 1e-5 every step, the cars'
    heights and states equal; the elevator calls and goal checks equal."""
    ji, ti, jo, to = tower
    js = JPE.BuildingPeopleSim(ji, 12, seed=3, room_objs=jo)
    ts = TPE.BuildingPeopleSim(ti, 12, seed=3, room_objs=to, device="cpu")
    same_tree(ts.people, js.people, 0.0, "start")
    for k in range(16):
        same_tree(ts.step(), js.step(), 1e-5, f"step {k}")
        assert [(c.z, c.state, c.target) for c in ts.cars] == \
            [(c.z, c.state, c.target) for c in js.cars]
        assert TPE.elevator_calls(ts.people, len(ts.cars)) == \
            JPE.elevator_calls(js.people, len(js.cars))
        np.testing.assert_array_equal(TPE.people_need_goals(ts.people),
                                      JPE.people_need_goals(js.people))
    idx = np.array([1, 4, 7])
    same_tree(TPE._take(ts.people, idx), JPE._take(js.people, idx), 1e-5, "take")
    assert [TPE.person_name(i) for i in range(6)] == [JPE.person_name(i) for i in range(6)]


def test_mall_and_backrooms_match():
    """Backrooms mazes, a two-floor mall with its atrium, store names and
    furnishing: equal."""
    for seed in (3, 8):
        a = TMB.gen_backrooms((0.0, 0.0, 3.0, 2.0), 0.12, seed=seed)
        b = JMB.gen_backrooms((0.0, 0.0, 3.0, 2.0), 0.12, seed=seed)
        assert dataclasses.asdict(a) == dataclasses.asdict(b) and a.walls
    tm = TMB.gen_mall((0.0, 0.0, 4.0, 2.0), 2, 0.12, seed=4)
    jm = JMB.gen_mall((0.0, 0.0, 4.0, 2.0), 2, 0.12, seed=4)
    assert dataclasses.asdict(tm) == dataclasses.asdict(jm)
    assert TMB.mall_atrium_opening((0.0, 0.0, 4.0, 2.0), 0.12) == \
        JMB.mall_atrium_opening((0.0, 0.0, 4.0, 2.0), 0.12)
    assert TMB.store_names(tm, 4) == JMB.store_names(jm, 4)
    (to, tn), (jo, jn) = TMB.furnish_mall(tm, 0.12, seed=4), JMB.furnish_mall(jm, 0.12, seed=4)
    assert dataclasses.asdict(to) == dataclasses.asdict(jo) and tn == jn
    assert len(to.kinds) > 50
    # people walk the mall's concourse and stores
    same_tree(TPE.make_people(TPE.build_nav_graph(tm), 6, seed=1, device="cpu"),
              JPE.make_people(JPE.build_nav_graph(jm), 6, seed=1), 0.0, "mall people")


def test_flooded_basement_matches(tower):
    """A basement flooding and pumping out: the level, floor-below-water,
    wading, float heights, oxygen, floated room objects, room fill
    volumes and splashes equal the JAX ones."""
    ji, ti, jo, to = tower
    tw = TBW.BasementWater(floor_height=0.08, basement_z1=-0.16, num_levels=2, leak_rate=0.004)
    jw = JBW.BasementWater(floor_height=0.08, basement_z1=-0.16, num_levels=2, leak_rate=0.004)
    tsm, jsm = TBW.SplashManager(), JBW.SplashManager()
    ox_t = ox_j = 1.0
    for k in range(48):
        tw.step()
        jw.step()
        if k == 30:
            tw.leak_rate, tw.drain_rate = 0.0, 0.003
            jw.leak_rate, jw.drain_rate = 0.0, 0.003
        ox_t, ox_j = TBW.oxygen_tick(ox_t, -0.1, tw), JBW.oxygen_tick(ox_j, -0.1, jw)
        for z in (-0.15, -0.05, 0.1):
            assert tw.is_underwater(z) == jw.is_underwater(z)
            assert tw.wade_factor(z, 0.02) == jw.wade_factor(z, 0.02)
        assert (tw.level, tw.floor_below_water(), tw.float_z(0.3, 0.01)) == \
            (jw.level, jw.floor_below_water(), jw.float_z(0.3, 0.01))
        assert TBW.check_for_water_splash(ti, tw, tsm, 0.3, 0.3, -0.1) == \
            JBW.check_for_water_splash(ji, jw, jsm, 0.3, 0.3, -0.1)
        tsm.next_frame(1.0)
        jsm.next_frame(1.0)
        if k == 20:
            ft, fj = TBW.float_room_objects(to, tw, ti), JBW.float_room_objects(jo, jw, ji)
            assert repr(ft) == repr(fj)
            assert repr(TBW.room_fill_geometry(ti, tw)) == repr(JBW.room_fill_geometry(ji, jw))
    assert ox_t == ox_j and ox_t < 1.0
    assert repr(TBW.calc_splash_bounds(ti, 0.5, 0.4)) == repr(JBW.calc_splash_bounds(ji, 0.5, 0.4))
    assert repr(tsm.__dict__) == repr(jsm.__dict__)


def test_interaction_and_lights_match(tower):
    """Six light switches and ten storage and powered objects toggled, the
    room lights pushed after each into each package's
    `BuildingIndirManager`: the same toggles, enabled maps and light
    lists; the port's composite then drops exactly the switched-off
    rooms' volumes."""
    ji, ti, jo, to = tower
    jst, tst = JBX.make_interact_state(jo, len(ji.rooms)), TBX.make_interact_state(to, len(ti.rooms))
    kinds = np.asarray(to.kinds)
    cent = TBX._centers(to)
    picks = list(np.where(kinds == TRC.F_LIGHT_SWITCH)[0][:6]) + \
        list(np.where(np.isin(kinds, TBX.OPENABLE + TBX.POWERED))[0][:10])
    jm, tm = JBI.BuildingIndirManager(), TBI.BuildingIndirManager(
        world=WorldConst(mesh_x=8, mesh_y=8, mesh_z=4), rays_per_light=256, device="cpu")
    for li in np.where(kinds == TRC.F_CEIL_LIGHT)[0][:6]:
        c = np.asarray(to.cubes[li], np.float32)
        pos = tuple(float(v) for v in 0.5 * (c[:3] + c[3:]))
        jm.register_light(int(li), pos, (1.0, 0.9, 0.8))
        tm.register_light(int(li), pos, (1.0, 0.9, 0.8))
    empty = SC.pack_cobjs(SC.SceneParse(), device="cpu")
    while tm.process_one(empty, torch.full((8, 8), -5.0)) is not None:
        pass
    full = float(tm.composite().lc_r.sum())
    for i in picks:
        x, y, z = (float(v) for v in cent[i])
        assert TBX.interact_at(to, tst, x, y, z, reach=0.01) == \
            JBX.interact_at(jo, jst, x, y, z, reach=0.01) == i
        assert TBX.apply_room_lights(tm, to, tst) == JBX.apply_room_lights(jm, jo, jst)
        assert tm.enabled == jm.enabled
    np.testing.assert_array_equal(tst.room_light_on, jst.room_light_on)
    np.testing.assert_array_equal(tst.obj_on, jst.obj_on)
    assert tst.log == jst.log and tst.toggles == jst.toggles
    for f in ("active_object_lights", "stove_heat_sources", "lootable_mask"):
        assert repr(getattr(TBX, f)(to, tst)) == repr(getattr(JBX, f)(jo, jst))
    np.testing.assert_array_equal(TBX.window_light_scale(to, tst, len(ti.rooms)),
                                  JBX.window_light_scale(jo, jst, len(ji.rooms)))
    on = sum(float(tm.volumes[ix].lc_r.sum()) for ix in tm.volumes if tm.enabled[ix])
    assert abs(float(tm.composite().lc_r.sum()) - on) <= 1e-4 * max(full, 1.0)
    assert not all(tm.enabled.values()) and full > 0


def test_gameplay_and_zombies_match(tower):
    """Pickups and looting, a thrown object into a physics state, doors
    cutting nav edges, zombie retargeting and 64 ticks of the zombie AI
    and walkers with sound alerts and attacks: the inventories, states,
    paths and AI states equal (people floats within 1e-5)."""
    ji, ti, jo, to = tower
    jinv, tinv = JBG.PlayerInventory(), TBG.PlayerInventory()
    for r in sorted(set(to.rooms))[:6]:
        assert TBG.loot_room(to, r, tinv) == JBG.loot_room(jo, r, jinv)
    assert dataclasses.asdict(tinv) == dataclasses.asdict(jinv) and tinv.carried
    ttab, jtab = TPT.make_type_table(device="cpu"), JPT.make_type_table()
    z3 = np.zeros((4, 3), np.float32)
    tst = TPS.make_state(torch.as_tensor(z3), torch.as_tensor(z3),
                         torch.full((4,), TPT.type_id("BALL"), dtype=torch.int32), ttab)
    jst = JPS.make_state(z3, z3, np.full(4, JPT.type_id("BALL")), jtab)
    tst, tok = TBG.throw_object(tinv, tst, ttab, (0.5, 0.5, 0.15), (1, 0, 0.2), 2)
    jst, jok = JBG.throw_object(jinv, jst, jtab, (0.5, 0.5, 0.15), (1, 0, 0.2), 2)
    assert tok and jok
    same_tree(tst, jst, 0.0, "thrown")
    tdoors, jdoors = TBG.DoorState(), JBG.DoorState()
    for di in range(0, len(ti.doors), 3):
        tdoors.toggle(di)
        jdoors.toggle(di)
    tg, jg = TBG.nav_graph_with_doors(ti, tdoors), JBG.nav_graph_with_doors(ji, jdoors)
    assert tg.adj == jg.adj and tg.waypoints == jg.waypoints
    tp = TPE.make_people(tg, 10, seed=2, device="cpu")
    jp = JPE.make_people(jg, 10, seed=2)
    trg, jrg = TRand(3, 7), JRand(3, 7)
    talert, jalert = TBG.SoundAlert(), JBG.SoundAlert()
    tai, jai = TBG.ZombieAI(), JBG.ZombieAI()
    tinv, jinv = TBG.PlayerInventory(), JBG.PlayerInventory()
    player_room = 2
    px, py, pf = (float(v) for v in tg.centers[player_room])
    hits = 0
    for k in range(64):
        if k % 16 == 0:
            talert.register(0.3, (px, py, 0.0))
            jalert.register(0.3, (px, py, 0.0))
            cur_t = [TPE.BuildingPeopleSim._room_at(type("S", (), {"graph": tg})(), x, y, f)
                     for x, y, f in zip(tp.x.tolist(), tp.y.tolist(), tp.floor.tolist())]
            cur_j = [JPE.BuildingPeopleSim._room_at(type("S", (), {"graph": jg})(), x, y, f)
                     for x, y, f in zip(np.asarray(jp.x), np.asarray(jp.y), np.asarray(jp.floor))]
            assert cur_t == cur_j
            if k == 0:
                tp = TBG.retarget_zombies(tp, tg, player_room, talert, cur_t, trg)
                jp = JBG.retarget_zombies(jp, jg, player_room, jalert, cur_j, jrg)
            else:
                tp = tai.update(tp, tg, cur_t, player_room, (px, py), pf, talert, 1, trg)
                jp = jai.update(jp, jg, cur_j, player_room, (px, py), pf, jalert, 1, jrg)
                assert tai.states == jai.states
        tp, jp = TPE.step_people(tp), JPE.step_people(jp)
        same_tree(tp, jp, 1e-5, f"tick {k}")
        h = TBG.zombie_attack_tick(tp, tinv, (px, py), pf)
        assert h == JBG.zombie_attack_tick(jp, jinv, (px, py), pf)
        hits += h
        if k == 48:     # the player walks up to the nearest zombie
            px, py, pf = float(tp.x[0]), float(tp.y[0]), float(tp.floor[0])
        talert.tick()
        jalert.tick()
        tinv.tick(1.0)
        jinv.tick(1.0)
    assert dataclasses.asdict(tinv) == dataclasses.asdict(jinv)
    assert talert.level == jalert.level and hits > 0 and tinv.health < 1.0

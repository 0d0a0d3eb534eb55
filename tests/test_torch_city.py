"""Torch port vs JAX package: the city (`city/plots`, `roads`, `traffic`,
`people`, `city_step`, `assemble`, `spectate`) and
`utils/config.building_params`, on a 96^2 city with 12 building people
(the JAX tests' own case, tests/test_city_step.py:15-37).

The JAX steps draw threefry values where the port takes them as inputs:
the tests replay the JAX key chains (`jax_city_draws`).  Tolerances:
integer fields, masks and states equal; positions and other floats
within 1e-5, pedestrian positions within 1e-4 (the separation sums add
in another order in the two packages, and a pedestrian a few thousandths
from its target turns their last ulp into a visible turn); the host layout (plots, roads, buildings, nav graphs, paths)
equal."""

import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import w3d  # noqa: F401
from w3d.city import plots as JCP, roads as JCR, traffic as JCT, assemble as JCA
from w3d.city import floorplan as JCF, people as JCPE, room_content as JCRC
from w3d.city import city_step as JCS, spectate as JSP
from w3d.utils import config as JCFG

from w3d_torch import convert
from w3d_torch.city import plots as TCP, roads as TCR, traffic as TCT, assemble as TCA
from w3d_torch.city import floorplan as TCF, people as TCPE, room_content as TCRC
from w3d_torch.city import city_step as TCS, spectate as TSP
from w3d_torch.utils import config as TCFG

from torch_port_util import jax_city_draws, np_tree

FRAMES = 8


def _same(a, b, tol=1e-5, what=""):
    """A port value (tensors in NamedTuples) against a JAX one (its key,
    if any, left out)."""
    if hasattr(b, "_fields") and "key" in b._fields:
        b = b._replace(key=None)
    a, b = convert.to_numpy(a), np_tree(b)
    if hasattr(b, "_fields"):
        for f in b._fields:
            if f == "key":
                continue
            _same(getattr(a, f), getattr(b, f), tol, f"{what}.{f}")
        return
    if b is None:
        assert a is None, what
        return
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    if b.dtype.kind == "f":
        np.testing.assert_allclose(a, b, rtol=0, atol=tol, err_msg=what)
    else:
        np.testing.assert_array_equal(a.astype(np.int64), b.astype(np.int64), err_msg=what)


@pytest.fixture(scope="module")
def city():
    hm = np.zeros((96, 96), np.float32)
    _, jplots = JCP.gen_cities(hm, -0.5, num_cities=1, seed=3)
    _, tplots = TCP.gen_cities(hm, -0.5, num_cities=1, seed=3)
    assert [tuple(p) for p in tplots] == [tuple(p) for p in jplots]
    jnet, tnet = JCR.gen_city_roads(jplots), TCR.gen_city_roads(tplots)
    j = dict(graph=JCT.build_road_graph(jnet), sl=JCT.build_stoplights(jnet, seed=3),
             nav=JCT.build_ped_nav(jnet))
    t = dict(graph=TCT.build_road_graph(tnet, device="cpu"),
             sl=TCT.build_stoplights(tnet, seed=3, device="cpu"),
             nav=TCT.build_ped_nav(tnet, device="cpu"))
    spots = JCT.gen_parking_spots(jnet.blocks)
    j["cars"] = JCT.make_cars(16, j["graph"], seed=3, spots=spots, parked_frac=0.3)
    t["cars"] = TCT.make_cars(16, t["graph"], seed=3, spots=spots, parked_frac=0.3)
    j["peds"] = JCT.make_peds(24, jnet.blocks, seed=4)
    t["peds"] = TCT.make_peds(24, tnet.blocks, seed=4, device="cpu")
    return jnet, tnet, j, t


@pytest.fixture(scope="module")
def tower():
    ji = JCF.gen_interior((0.0, 0.0, 0.0, 1.2, 0.9, 0.4), 3, 0.08, seed=7)
    ti = TCF.gen_interior((0.0, 0.0, 0.0, 1.2, 0.9, 0.4), 3, 0.08, seed=7)
    assert dataclasses.asdict(ji) == dataclasses.asdict(ti)
    jo, to = JCRC.furnish_rooms(ji, 0.08, seed=7), TCRC.furnish_rooms(ti, 0.08, seed=7)
    assert dataclasses.asdict(jo) == dataclasses.asdict(to)
    return ji, ti, jo, to


def test_layout_and_tables_match(city):
    jnet, tnet, j, t = city
    assert jnet.segs == tnet.segs and jnet.isecs == tnet.isecs and jnet.blocks == tnet.blocks
    for name in ("graph", "sl", "nav", "cars", "peds"):
        _same(t[name], j[name], 0.0, name)
    _same(convert.road_graph(np_tree(j["graph"]), "cpu"), j["graph"], 0.0, "converted graph")
    _same(convert.ped_nav(np_tree(j["nav"]), "cpu"), j["nav"], 0.0, "converted nav")
    hm = np.random.default_rng(5).normal(0.0, 0.3, (64, 64)).astype(np.float32)
    used = np.zeros((64, 64), bool)
    used[:10, :20] = True
    np.testing.assert_allclose(
        TCP.city_score_map(torch.as_tensor(hm), 12, 10, -0.2, torch.as_tensor(used), 3).numpy(),
        np.asarray(JCP.city_score_map(jnp.asarray(hm), 12, 10, -0.2, jnp.asarray(used), 3)),
        rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        TCP.flatten_region(torch.as_tensor(hm), 5, 7, 20, 30, 0.25, 4).numpy(),
        np.asarray(JCP.flatten_region(jnp.asarray(hm), 5, 7, 20, 30, 0.25, 4)), rtol=0, atol=1e-6)
    jh, jp = JCP.gen_cities(hm, -0.5, num_cities=2, city_size=16, seed=1)
    th, tp = TCP.gen_cities(hm, -0.5, num_cities=2, city_size=16, seed=1)
    assert [p[:4] for p in tp] == [p[:4] for p in jp]
    np.testing.assert_allclose([p[4] for p in tp], [p[4] for p in jp], rtol=0, atol=1e-6)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=0, atol=1e-5)
    routes = JCR.gen_connector_roads(jp, JCR.RoadNetwork(), heightmap=hm, seed=2)
    assert TCR.gen_connector_roads(tp, TCR.RoadNetwork(), heightmap=hm, seed=2) == routes
    np.testing.assert_allclose(TCR.carve_roads(hm, routes, tp).numpy(),
                               np.asarray(JCR.carve_roads(hm, routes, jp)), rtol=0, atol=1e-6)
    assert TCP.assign_parks(jnet.blocks, 3, seed=2) == JCP.assign_parks(jnet.blocks, 3, seed=2)
    for a, b in zip(TCP.furnish_park(jnet.blocks[0], 4), JCP.furnish_park(jnet.blocks[0], 4)):
        np.testing.assert_array_equal(a, b)


def test_cars_and_stoplights_match(city):
    """40 frames of stoplights and cars: lights turn, cars turn, park and
    wait at red lights."""
    _, _, j, t = city
    jsl, jc, tsl, tc = j["sl"], j["cars"], t["sl"], t["cars"]
    key = jax.random.key(0)
    moved = 0
    for _ in range(40):
        jsl, tsl = JCT.step_stoplights(jsl), TCT.step_stoplights(tsl)
        jc = JCT.step_cars(jc, j["graph"], key, stoplights=jsl)
        tc2 = TCT.step_cars(tc, t["graph"], stoplights=tsl)
        moved += int((tc2.seg != tc.seg).sum())
        tc = tc2
        _same(tsl, jsl, 0.0, "stoplights")
        _same(tc, jc, 1e-6, "cars")
    assert moved > 0
    legacy_j = JCT.step_cars(jc, j["graph"], key)
    _same(TCT.step_cars(tc, t["graph"]), legacy_j, 1e-6, "cars, global clock")


def test_peds_helis_birds_trains_match(city):
    """80 frames of pedestrians with plot navigation and lights, helicopters
    between pads, birds between perches and trains, on the JAX draws."""
    jnet, tnet, j, t = city
    bl = JCA.CB.place_buildings_in_blocks(jnet.blocks, lambda x, y: 0.0,
                                          JCA.CB.BuildingParams(), seed=3)
    pads = JCT.make_helipads(bl)
    perch = JCT.bird_perches(None, bl)
    assert np.array_equal(TCT.bird_perches(None, bl), perch)
    jh, th = JCT.make_helis(3, pads, seed=3), TCT.make_helis(3, pads, seed=3, device="cpu")
    jb, tb = JCT.make_birds(5, perch, seed=3), TCT.make_birds(5, perch, seed=3, device="cpu")
    rail_pts = [(2.0, 1.0), (30.0, 1.0), (30.0, 20.0)]
    jr, tr = JCT.gen_railroad(rail_pts), TCT.gen_railroad(rail_pts, device="cpu")
    jt, tt = JCT.make_trains(3, 1, seed=3), TCT.make_trains(3, 1, seed=3, device="cpu")
    # goals a few steps away, so pedestrians reach them, draw new ones and
    # head for crosswalks within the run
    near = np.asarray(j["peds"].x) + np.float32(0.01) * (np.arange(24) % 4)
    jp = j["peds"]._replace(gx=jnp.asarray(near), gy=j["peds"].y)
    tp = t["peds"]._replace(gx=torch.as_tensor(near), gy=t["peds"].y.clone())
    jsl, tsl = j["sl"], t["sl"]
    tpads, tperch = torch.as_tensor(pads), torch.as_tensor(perch)
    key = jax.random.key(9)
    flew = landed = 0
    for f in range(80):
        key, _k1, k2, k3, k4 = jax.random.split(key, 5)
        # this frame's draws from this frame's keys (the city frame's split)
        a, b, c = jax.random.split(k2, 3)
        pd = TCT.PedDraws(*(torch.as_tensor(np.asarray(v)) for v in (
            jax.random.uniform(a, (24,)), jax.random.randint(b, (24,), 0, 4),
            jax.random.uniform(c, (24,)), jax.random.uniform(jax.random.fold_in(c, 1), (24,)))))
        jsl, tsl = JCT.step_stoplights(jsl), TCT.step_stoplights(tsl)
        jp = JCT.step_peds(jp, k2, nav=j["nav"], stoplights=jsl)
        tp = TCT.step_peds(tp, pd, nav=t["nav"], stoplights=tsl)
        _same(tp, jp, 1e-4, f"peds {f}")
        jh = JCT.step_helis(jh, jnp.asarray(pads), k3)
        th = TCT.step_helis(th, tpads, *(torch.as_tensor(np.asarray(v)) for v in (
            jax.random.randint(k3, (3,), 0, len(pads)),
            jax.random.randint(jax.random.fold_in(k3, 1), (3,), 30, 120))))
        _same(th, jh, 1e-5, f"helis {f}")
        jb = JCT.step_birds(jb, jnp.asarray(perch), k4)
        tb = TCT.step_birds(tb, tperch, *(torch.as_tensor(np.asarray(v)) for v in (
            jax.random.randint(k4, (5,), 0, len(perch)),
            jax.random.randint(jax.random.fold_in(k4, 1), (5,), 60, 400))))
        _same(tb, jb, 1e-5, f"birds {f}")
        jt, tt = JCT.step_trains(jt, jr), TCT.step_trains(tt, tr)
        _same(tt, jt, 1e-6, f"trains {f}")
        flew += int((th.phase > 0).sum()) + int((tb.state > 0).sum())
        landed += int((tp.stage < 2).sum())
    assert flew > 0 and landed > 0
    for a, b in zip(TCT.train_positions(tt, tr), JCT.train_positions(jt, jr)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-5)
    for a, b in zip(TCT.car_geometry(t["cars"], t["graph"]),
                    JCT.car_geometry(j["cars"], j["graph"])):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-6)
    # the crowd without plot navigation: goals re-drawn in [-2, 2)
    key = jax.random.key(4)
    jq = j["peds"]._replace(gx=j["peds"].x + 0.01)
    tq = t["peds"]._replace(gx=t["peds"].x + 0.01)
    jq2 = JCT.step_peds(jq, key)
    k1, k2, _k3 = jax.random.split(key, 3)
    u = lambda k: torch.as_tensor(np.asarray(jax.random.uniform(k, (24,))))
    tq2 = TCT.step_peds(tq, TCT.PedDraws(u(k1), None, u(k1), u(k2)))
    _same(tq2, jq2, 1e-5, "peds without nav")


def _people(tower, seed=4, n=12):
    ji, ti, jo, to = tower
    jb = JCS.MergedBuildingPeople([(ji, n, jo)], seed=seed)
    tb = TCS.MergedBuildingPeople([(ti, n, to)], seed=seed, device="cpu")
    return jb, tb


def test_people_and_elevators_match(tower):
    """120 frames of building people and the elevator bank from the same
    paths (people wait for and ride the car); `MergedBuildingPeople.reroute` from the same probe gives the
    same paths and mirrors."""
    jb, tb = _people(tower)
    _same(tb.people, jb.people, 0.0, "people")
    _same(convert.people_state(np_tree(jb.people), "cpu"), jb.people, 0.0, "converted")
    jst, tst, je, te = jb.people, tb.people, jb.elev, tb.elev
    rode = 0
    for f in range(120):
        cf, hc = JCS.elevator_calls_device(jst, je.z.shape[0])
        tcf, thc = TCS.elevator_calls_device(tst, te.z.shape[0])
        _same((tcf, thc), (cf, hc), 1e-6, f"calls {f}")
        je, te = JCS.step_elevator_bank(je, cf, hc), TCS.step_elevator_bank(te, tcf, thc)
        jst, tst = JCPE.step_people(jst, je.z), TCPE.step_people(tst, te.z)
        _same(te, je, 1e-5, f"elev {f}")
        _same(tst, jst, 1e-5, f"people {f}")
        rode += int((tst.activity == TCPE.ACT_RIDE_ELEVATOR).sum())
        if f % 20 == 19:
            jp = np.asarray(JCS.people_probe(jst))
            tp = TCS.people_probe(tst).numpy()
            np.testing.assert_allclose(tp, jp, rtol=0, atol=1e-5)
            jst = jb.reroute(jst, probe=jp)
            tst = tb.reroute(tst, probe=jp)
            for m in ("m_px", "m_py", "m_pf", "m_pe", "m_plen"):
                np.testing.assert_array_equal(getattr(tb, m), getattr(jb, m), err_msg=m)
            _same(tst, jst, 1e-5, f"rerouted {f}")
    assert rode > 0


def test_city_frames_chained_match(city, tower):
    """8 chained frames of the whole city state (traffic, crowd, lights,
    helicopters, birds, trains, elevators, building people) on the JAX
    draws, then the reroute; integer fields equal, floats 1e-5."""
    jnet, tnet, j, t = city
    jb, tb = _people(tower)
    bl = JCA.CB.place_buildings_in_blocks(jnet.blocks, lambda x, y: 0.0,
                                          JCA.CB.BuildingParams(), seed=3)
    pads, perch = JCT.make_helipads(bl), JCT.bird_perches(None, bl)
    rail_pts = [(2.0, 1.0), (30.0, 1.0)]
    jcs = JCS.CityState(stoplights=j["sl"], cars=j["cars"], peds=j["peds"], people=jb.people,
                        elev=jb.elev, helis=JCT.make_helis(2, pads, seed=1),
                        birds=JCT.make_birds(4, perch, seed=1), key=jax.random.key(5),
                        trains=JCT.make_trains(2, 1, seed=1))
    tcs = convert.city_state(np_tree(jcs._replace(key=None)), "cpu")
    for k in range(2):
        draws, _ = jax_city_draws(jcs.key, FRAMES, 24, 2, len(pads), 4, len(perch))
        jcs = JCS.city_frames_chained(jcs, j["graph"], j["nav"], jnp.asarray(pads),
                                      jnp.asarray(perch), FRAMES, rail=JCT.gen_railroad(rail_pts))
        tcs = TCS.city_frames_chained(tcs, t["graph"], t["nav"], torch.as_tensor(pads),
                                      torch.as_tensor(perch), FRAMES, draws,
                                      rail=TCT.gen_railroad(rail_pts, device="cpu"))
        _same(tcs, jcs, 1e-5, f"chunk {k}")
        probe = np.asarray(JCS.people_probe(jcs.people))
        jcs = jcs._replace(people=jb.reroute(jcs.people, probe=probe))
        tcs = tcs._replace(people=tb.reroute(tcs.people, probe=probe))
        _same(tcs, jcs, 1e-5, f"rerouted {k}")


def test_build_city_matches_at_the_walk_cells_size(monkeypatch):
    """`build_city` at `tiled_city_128`'s size (8 cities of 64 cells on a
    flat 512^2 map, 4,000 cars, 10,000 pedestrians, 4 helicopters, the
    layout seed below 2^31 as the cell takes it) against the JAX package's
    `build_city` with its `gen_cities` at `city_size` 64: the host layout,
    buildings, road graph, stoplights, pedestrian navigation, cars,
    pedestrians and helipads, field by field."""
    gen = JCP.gen_cities
    monkeypatch.setattr(JCA.CP, "gen_cities",
                        lambda *a, **kw: gen(*a, **{**kw, "city_size": 64}))
    hm = np.zeros((512, 512), np.float32)
    kw = dict(num_cities=8, num_cars=4000, num_peds=10000, num_helis=4, seed=2**31 - 99)
    jw = JCA.build_city(hm, **kw)
    tw = TCA.build_city(hm, city_size=64, device="cpu", **kw)
    assert len({b[4] for b in tw.net.blocks}) == 8 and len(tw.net.blocks) == 8 * 64
    assert tw.net.segs == jw.net.segs and tw.net.isecs == jw.net.isecs
    assert tw.net.blocks == jw.net.blocks
    assert [dataclasses.asdict(b) for b in tw.buildings] == \
        [dataclasses.asdict(b) for b in jw.buildings]
    for name in ("graph", "stoplights", "cars", "peds", "ped_nav", "helis", "helipads"):
        _same(getattr(tw, name), getattr(jw, name), 0.0, name)


def test_build_city_matches(city):
    """`build_city` field by field: the layout, buildings, structures and
    every device table; with interiors, the floorplans, tunnels and
    manholes too."""
    hm = np.zeros((96, 96), np.float32)
    jw = JCA.build_city(hm, num_cities=1, num_cars=16, num_peds=24, num_helis=2, seed=3)
    tw = TCA.build_city(hm, num_cities=1, num_cars=16, num_peds=24, num_helis=2, seed=3,
                        device="cpu")
    assert tw.net.segs == jw.net.segs and tw.net.blocks == jw.net.blocks
    assert [dataclasses.asdict(b) for b in tw.buildings] == \
        [dataclasses.asdict(b) for b in jw.buildings]
    for name in ("graph", "stoplights", "cars", "peds", "ped_nav", "helis", "helipads"):
        _same(getattr(tw, name), getattr(jw, name), 0.0, name)
    assert tw.skyways == jw.skyways and tw.ug_elevators == jw.ug_elevators
    for f in ("poles", "wires"):
        np.testing.assert_array_equal(getattr(tw.power, f), getattr(jw.power, f))
    # with interiors: floorplans, tunnel networks and manholes equal too
    jw = JCA.build_city(hm, num_cities=1, num_cars=16, num_peds=24, num_helis=2, seed=3,
                        interiors=True)
    tw = TCA.build_city(hm, num_cities=1, num_cars=16, num_peds=24, num_helis=2, seed=3,
                        interiors=True, device="cpu")
    assert [dataclasses.asdict(b) for b in tw.buildings] == \
        [dataclasses.asdict(b) for b in jw.buildings]
    assert [(i, [dataclasses.asdict(t) for t in s]) for i, s in tw.tunnels] == \
        [(i, [dataclasses.asdict(t) for t in s]) for i, s in jw.tunnels]
    assert tw.manholes == jw.manholes
    for name in ("graph", "stoplights", "cars", "peds", "helis", "helipads"):
        _same(getattr(tw, name), getattr(jw, name), 0.0, name)


def test_spectate_follows_the_same_agent(city):
    """Toggling picks the same agent as the JAX package, and the camera
    state follows it."""
    _, _, j, t = city
    from types import SimpleNamespace
    jcw = SimpleNamespace(cars=j["cars"], peds=j["peds"], graph=j["graph"])
    tcw = SimpleNamespace(cars=t["cars"], peds=t["peds"], graph=t["graph"])
    for px, py, r in ((20.0, 20.0, 25.0), (40.0, 33.0, 0.6), (40.0, 40.0, 0.01)):
        js = JSP.toggle(JSP.Spectate(), px, py, jcw, camera_radius=r)
        ts = TSP.toggle(TSP.Spectate(), px, py, tcw, camera_radius=r)
        assert tuple(ts) == tuple(js)
        a, b = TSP.camera_state(ts, tcw), JSP.camera_state(js, jcw)
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)
    car = TSP.Spectate(TSP.SPEC_CAR, 0)
    np.testing.assert_allclose(TSP.camera_state(car, tcw), JSP.camera_state(car, jcw),
                               rtol=0, atol=1e-6)


def test_building_params_match(tmp_path):
    cfg = tmp_path / "c.txt"
    cfg.write_text("buildings size_range_min 1.5\nbuildings size_range_max 4.0\n"
                   "buildings min_levels 2\nbuildings max_levels 12\n"
                   "buildings max_rot_angle 0.3\nbuildings num_spiders_max 5\n")
    jb, jx = JCFG.building_params(JCFG.load_config(str(cfg)))
    tb, tx = TCFG.building_params(TCFG.load_config(str(cfg)))
    assert tuple(tb) == tuple(jb) and tx == jx
    assert tb.max_floors == 12 and tb.rotate_prob == 0.2 and tx["num_spiders_max"] == 5


@pytest.fixture
def no_assets(monkeypatch):
    """W3D_ASSET_ROOT="" with both packages' `utils/names` reloaded (their
    text-data directory is read at import); reloaded again after."""
    import importlib
    from w3d.utils import names as JN
    from w3d_torch.utils import names as TN
    monkeypatch.setenv("W3D_ASSET_ROOT", "")
    importlib.reload(JN)
    importlib.reload(TN)
    yield
    monkeypatch.undo()
    importlib.reload(JN)
    importlib.reload(TN)


def test_labels_and_building_names_match(no_assets):
    """room_content.label_objects (book titles, numbered door signs) on
    furnished office and hotel towers, and building_name for every
    building type over several seeds: equal, without an asset tree."""
    for seed, btype in ((9, TCRC.BT_OFFICE), (4, TCRC.BT_HOTEL), (13, TCRC.BT_HOSPITAL)):
        ji = JCF.gen_interior((0.0, 0.0, 0.0, 1.2, 0.9, 0.4), 3, 0.08, seed=seed)
        ti = TCF.gen_interior((0.0, 0.0, 0.0, 1.2, 0.9, 0.4), 3, 0.08, seed=seed)
        jo = JCRC.furnish_rooms(ji, 0.08, seed=seed, is_office_bldg=True, btype=btype)
        to = TCRC.furnish_rooms(ti, 0.08, seed=seed, is_office_bldg=True, btype=btype)
        jl, js = JCRC.label_objects(ji, jo, seed=seed)
        tl, ts = TCRC.label_objects(ti, to, seed=seed)
        assert (tl, ts) == (jl, js) and len(ts) > 0
    kinds = [v for k, v in vars(TCRC).items() if k.startswith("BT_") and isinstance(v, int)]
    assert len(kinds) >= 10
    for bt in kinds:
        for seed in range(6):
            assert TCRC.building_name(bt, seed) == JCRC.building_name(bt, seed)

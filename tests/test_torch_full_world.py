"""Torch port vs JAX package: the full-world build (`w3d_torch.full_world`
against `examples/full_world.py`), section by section and whole, at small
sizes on the CPU, and the map view (`export/map_view`).

The JAX side is the example's code with its sizes as parameters
(`_jax_world`); the port's sections take the JAX heightmap and the JAX
draws (`torch_port_util.jax_world_draws`), so each section is held on
the same inputs.  Tolerances, each stated at its test: stats, counts,
names, tree cells and types, the star system and the exported map image
equal; the city's floats (plot elevations, carved heights, building and
tunnel geometry) within 1e-5, since a plot's elevation is a mean that
the two packages sum in other orders; walkers, traffic, the city frame
and the balls within 1e-5 (status equal; the JAX frames on the banded
pair pass the port runs); the bake per cell within rtol 3e-5, atol 1e-6
(the lighting tests' bound, the JAX tracer run op by op as there) and the
sweep within 1e-5; the uneroded terrain within 1e-5 of the height
scale; the map's colour ramps within an ulp."""

import dataclasses
import json
import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import w3d  # noqa: F401
from w3d.utils.constants import WorldConst as JWorld
from w3d.terrain import mesh as JTM, biomes as JB
from w3d.city import plots as JCP, roads as JCR, buildings as JCB, floorplan as JCF
from w3d.city import room_content as JRC, people as JPE, traffic as JTF, tunnels as JTN
from w3d.city import city_step as JCS, model_instances as JMI
from w3d.veg.trees import place_trees_on_tile as jax_trees
from w3d.models import physics_model as JPM
from w3d.physics import step as JPS
from w3d.lighting import lmap as JL, trace as JTR, sweep as JSW
from w3d.universe import gen as JUG
from w3d.utils.rng import RandGen as JRand
from w3d.export import heightmap_io as JHIO, map_view as JMV

from w3d_torch import full_world as FW
from w3d_torch.export import map_view as TMV
from w3d_torch.city import buildings as TCB
from w3d_torch.utils.constants import WorldConst as TWorld

from torch_port_util import jax_world_draws, one_torch_thread, same_tree  # noqa: F401

SIZES = FW.WorldSizes(mesh=64, erosion_iters=1024, city_size=16, cars=12, car_steps=10,
                      city_frames=6, balls=64, phys_frames=2, substeps=2, bake_rays=256,
                      sweep_nz=8)


def _jax_world(s: FW.WorldSizes, out_dir: str) -> dict:
    """examples/full_world.py with its sizes as parameters; returns its
    intermediate values and its stats."""
    world = JWorld(mesh_x=s.mesh, mesh_y=s.mesh)
    v, stats = {"world": world}, {}
    ts = JTM.gen_terrain(JTM.TerrainConfig(mesh_seed=7, erosion_iters=s.erosion_iters), world)
    hm = ts.mesh_height
    v["ts"] = ts
    stats["terrain"] = {"z_range": [round(float(hm.min()), 3), round(float(hm.max()), 3)],
                        "water_z": round(float(ts.water_plane_z), 3)}
    v["city_in"] = (np.asarray(hm), float(ts.water_plane_z))
    hm, plots = JCP.gen_cities(hm, ts.water_plane_z, num_cities=s.num_cities,
                               city_size=s.city_size)
    net = JCR.gen_city_roads(plots)
    routes = JCR.gen_connector_roads(plots, net)
    hm, bridges, tunnels = JCR.carve_roads_with_structures(hm, routes, plots)
    blocks = [(p.x1 + 2, p.y1 + 2, p.x2 - 2, p.y2 - 2, i) for i, p in enumerate(plots)]
    hm_np = np.asarray(hm)

    def elev(x, y):
        return float(hm_np[min(int(y), world.mesh_y - 1), min(int(x), world.mesh_x - 1)])

    bl = JCB.place_buildings_in_blocks(blocks, elev, JCB.BuildingParams(), seed=3, cell_w=1.0)
    interiors, people = 0, None
    for b in bl:
        (x1, y1, z1, x2, y2, z2) = b.parts[0]
        if x2 - x1 < 3 or y2 - y1 < 3:
            continue
        i = JCF.gen_interior((x1, y1, z1, x2, y2, z2), 3, 0.8, seed=11,
                             has_basement=(people is None))
        b.interior = i
        interiors += 1
        if people is None and i.rooms:
            ro = JRC.furnish_rooms(i, 0.8, 11)
            people = JPE.make_people(JPE.build_nav_graph(i), FW.PEOPLE, seed=4)
            for _ in range(FW.PEOPLE_STEPS):
                people = JPE.step_people(people)
            labels, signs = JRC.label_objects(i, ro, seed=4)
            stats["first_building"] = {
                "rooms": len(i.rooms), "furniture": len(ro.cubes),
                "people_walking": FW.PEOPLE, "name": JRC.building_name(JRC.BT_OFFICE, 4),
                "door_signs": len(signs), "book_titles": len(labels)}
    bsegs = []
    for b in bl:
        inter = getattr(b, "interior", None)
        if inter is not None and any(r.floor < 0 for r in inter.rooms):
            bsegs = JTN.gen_tunnels(b, bl, 0.8, seed=11)
            if bsegs:
                p0 = b.parts[0]
                JTN.add_tunnel_objects(bsegs, (p0[0], p0[1], p0[3], p0[4]), seed=11,
                                       ground_z=p0[2])
                break
    stats["city"] = {"plots": len(plots), "road_segs": len(net.segs), "bridges": len(bridges),
                     "tunnels": len(tunnels), "buildings": len(bl),
                     "round_buildings": int(sum(b.is_round for b in bl)),
                     "interiors": interiors, "basement_tunnel_segs": len(bsegs),
                     "basement_tunnel_gates": sum(1 for t in bsegs if t.has_gate)}
    v.update(hm=hm, plots=plots, net=net, routes=routes, bridges=bridges, tunnels=tunnels,
             buildings=bl, bsegs=bsegs, people=people)

    graph = JTF.build_road_graph(net)
    cars = JTF.make_cars(s.cars, graph, seed=5)
    key = jax.random.key(0)
    for i in range(s.car_steps):
        cars = JTF.step_cars(cars, graph, jax.random.fold_in(key, i))
    trains = rail = None
    if routes:
        rail = JTF.gen_railroad([(routes[0][0], routes[0][1]), (routes[0][2], routes[0][3])])
        trains = JTF.make_trains(s.trains, 1, seed=6)
        for _ in range(FW.TRAIN_STEPS):
            trains = JTF.step_trains(trains, rail)
    pads = JTF.make_helipads(bl)
    helis = JTF.make_helis(s.helis, pads, seed=2) if len(pads) else None
    if helis is not None:
        for i in range(FW.HELI_STEPS):
            helis = JTF.step_helis(helis, jnp.asarray(pads), jax.random.fold_in(key, 100 + i))
    stats["traffic"] = {"cars": s.cars, "trains": s.trains if routes else 0,
                        "helipads": int(len(pads))}
    v.update(graph=graph, cars=cars, trains=trains, rail=rail, helis=helis)

    cstate = JCS.CityState(stoplights=JTF.build_stoplights(net, seed=5), cars=cars,
                           peds=JTF.make_peds(FW.PEDS, net.blocks, seed=7), people=None,
                           elev=JCS.make_elevator_bank(1), helis=None, birds=None,
                           key=jax.random.key(4))
    cstate = JCS.city_frames_chained(cstate, graph, JTF.build_ped_nav(net), None, None,
                                     s.city_frames)
    inst = JMI.city_instances(cars=cstate.cars, graph=graph, peds=cstate.peds, specs={}, seed=4)
    stats["city_frame"] = {"chained": s.city_frames, "instanced_models": len(inst),
                           "instances": int(sum(t.transforms.shape[0] for t in inst))}
    v.update(cstate=cstate, inst=inst)

    tile_z = hm[:FW.TREE_TILE, :FW.TREE_TILE]
    wts = JB.biome_weights(tile_z, jnp.ones_like(tile_z), float(hm.min()), float(hm.max()))
    trees = jax_trees(9, -2.0, -2.0, tile_z, jnp.ones_like(tile_z), wts, world)
    stats["vegetation"] = {"trees": int(np.asarray(trees[4]).sum())}
    v["trees"] = trees

    sw = JPM.build_spheres_world(num_objects=s.balls, world=world)
    st = sw.state
    for _ in range(s.phys_frames):      # frame_step on the banded pair pass
        st = JPS.step_objects(st, sw.env, sw.cobjs, sw.table, substeps=s.substeps,
                              world=world, pair_method="banded")
    stats["physics"] = {"objects": s.balls, "live": int((np.asarray(st.status) > 0).sum())}
    v.update(sw=sw, st=st)

    cobjs = sw.cobjs.cobjs if hasattr(sw.cobjs, "cobjs") else sw.cobjs
    mesh = jnp.asarray(hm, jnp.float32)
    with jax.disable_jit():     # op by op, as tests/test_torch_lighting.py runs the tracer
        rays = JTR.sky_rays(key, s.bake_rays, world)
        grid = JTR.trace_batch(JL.make_light_grid(world), cobjs, mesh, *rays, key,
                               params=JTR.TraceParams(max_bounces=s.bounces,
                                                      samples_per_segment=4, mesh_steps=8),
                               world=world)
    stats["lighting"] = {"sky_energy": round(float(grid.sc_r.sum()), 4)}
    sgrid = JSW.compute_sky_lighting_sweep(JL.make_light_grid(world, nz=s.sweep_nz), cobjs,
                                           mesh, ndirs=s.sweep_dirs, world=world, bounce=False)
    stats["sweep_lighting"] = {"mean_visibility": round(float(np.asarray(sgrid.sv).mean()), 3)}
    v.update(grid=grid, sgrid=sgrid)

    sy = JUG.gen_system(JRand(3, 5), (1.0, 2.0, 3.0))
    stats["universe"] = {"system": JUG.system_name(sy),
                         "planets": [JUG.planet_name(p) for p in sy.planets]}
    v["system"] = sy

    os.makedirs(out_dir, exist_ok=True)
    JHIO.write_png_gray(os.path.join(out_dir, "world_height.png"),
                        JHIO.heights_to_pixels(np.asarray(hm), bit_depth=16))
    img = JMV.terrain_map(hm, ts.water_plane_z, float(hm.min()), float(hm.max()))
    img = JMV.overlay_roads_buildings(img, net.seg_array(), JCB.building_part_array(bl), world)
    rgb = np.transpose(np.asarray(jnp.clip(jnp.asarray(img) * 255, 0, 255).astype(jnp.uint8)),
                       (1, 2, 0))
    JHIO.write_png_rgb(os.path.join(out_dir, "world_map.png"), rgb)
    stats["artifacts"] = ["world_height.png", "world_map.png"]
    v.update(rgb=rgb, stats=stats)
    return v


def _close_tree(a, b, tol, what=""):
    """Nested dicts, lists and tuples equal, their floats within `tol`."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys(), what
        for k in a:
            _close_tree(a[k], b[k], tol, f"{what}.{k}")
    elif isinstance(a, (list, tuple)):
        assert isinstance(b, (list, tuple)) and len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            _close_tree(x, y, tol, f"{what}[{i}]")
    elif isinstance(a, float) or isinstance(b, float):
        assert abs(float(a) - float(b)) <= tol, (what, a, b)
    else:
        assert a == b, (what, a, b)


@pytest.fixture(scope="module")
def jaxw(tmp_path_factory):
    return _jax_world(SIZES, str(tmp_path_factory.mktemp("jax_world")))


@pytest.fixture(scope="module")
def portw(jaxw):
    """The port's sections on the JAX heightmap and draws."""
    world = TWorld(mesh_x=SIZES.mesh, mesh_y=SIZES.mesh)
    d = jax_world_draws()
    hm, wz = jaxw["city_in"]
    cb, cstats = FW.city_section(torch.as_tensor(hm), wz, SIZES, world, "cpu")
    tr, tstats = FW.traffic_section(cb, SIZES, d, "cpu")
    cstate, inst, fstats = FW.city_frame_section(cb, tr, SIZES, d, {}, "cpu")
    trees, vstats = FW.vegetation_section(cb.hm, world)
    sw, pstats = FW.physics_section(SIZES, d, world, "cpu")
    grid, lstats = FW.lighting_section(sw, cb.hm, SIZES, d, world, "cpu")
    sgrid, sstats = FW.sweep_section(sw, cb.hm, SIZES, world, "cpu")
    sy, ustats = FW.universe_section()
    return dict(world=world, cb=cb, tr=tr, cstate=cstate, inst=inst, trees=trees, sw=sw,
                grid=grid, sgrid=sgrid, system=sy,
                stats=dict(cstats, traffic=tstats, city_frame=fstats, vegetation=vstats,
                           physics=pstats, lighting=lstats, sweep_lighting=sstats,
                           universe=ustats))


def test_terrain_section_matches():
    """The terrain section without erosion against the JAX `gen_terrain`
    run op by op (compiled, XLA fuses the far grid's arguments and moves
    the height range 0.2%, see test_torch_fbm): heights within 1e-5 of the
    height scale, the water plane too, stats equal.  With erosion the
    section is `gen_terrain` on its draws' angles (the JAX key-0 angles
    here): at the example's erode amount of 1 a droplet walk turns an ulp
    into a different path (on equal 32^2 inputs, 256 droplets leave 20% of
    the cells apart), so the eroded heights are held to the JAX walk in
    test_torch_fbm, at erode amount 0.01."""
    w, tw = JWorld(mesh_x=32, mesh_y=32), TWorld(mesh_x=32, mesh_y=32)
    with jax.disable_jit():
        ref = JTM.gen_terrain(JTM.TerrainConfig(mesh_seed=7), w)
    ts, st = FW.terrain_section(SIZES._replace(mesh=32, erosion_iters=0), jax_world_draws(),
                                tw, "cpu")
    scale = abs(float(ref.zmax_est))
    np.testing.assert_allclose(ts.mesh_height.numpy(), np.asarray(ref.mesh_height), rtol=0,
                               atol=1e-5 * scale)
    assert abs(float(ts.water_plane_z) - float(ref.water_plane_z)) <= 1e-5 * scale
    hm = np.asarray(ref.mesh_height)
    assert st == {"z_range": [round(float(hm.min()), 3), round(float(hm.max()), 3)],
                  "water_z": round(float(ref.water_plane_z), 3)}
    d = jax_world_draws()
    eroded, _ = FW.terrain_section(SIZES._replace(mesh=32, erosion_iters=256), d, tw, "cpu")
    own = FW.TM.gen_terrain(FW.TM.TerrainConfig(mesh_seed=7, erosion_iters=256), tw,
                            angles=d.erosion_angles(256, "cpu"), device="cpu")
    assert torch.equal(eroded.mesh_height, own.mesh_height)
    assert float((eroded.mesh_height - ts.mesh_height).abs().max()) > 1e-3


def test_city_section_matches(jaxw, portw):
    """Plots, roads, bridges and tunnels, the carved heightmap, buildings
    with their interiors and the basement tunnels: integers equal, floats
    within 1e-5 (a plot's elevation is its region's mean, which the JAX
    package sums in float32 in XLA's order and the port in float64);
    the city stats equal; the first building's walkers within 1e-5."""
    cb, st, j = portw["cb"], portw["stats"], jaxw
    close = lambda a, b, what: _close_tree(a, b, 1e-5, what)
    close([tuple(p) for p in cb.plots], [tuple(p) for p in j["plots"]], "plots")
    close(cb.net.segs, j["net"].segs, "segs")
    close(cb.net.blocks, j["net"].blocks, "blocks")
    close((cb.routes, cb.bridges, cb.tunnels), (j["routes"], j["bridges"], j["tunnels"]),
          "routes")
    np.testing.assert_allclose(cb.hm.numpy(), np.asarray(j["hm"]), rtol=0, atol=1e-5)
    close([dataclasses.asdict(b) for b in cb.buildings],
          [dataclasses.asdict(b) for b in j["buildings"]], "buildings")
    close([dataclasses.asdict(t) for t in cb.bsegs], [dataclasses.asdict(t) for t in j["bsegs"]],
          "tunnels")
    same_tree(cb.people, j["people"], 1e-5, "walkers")
    for k in ("city", "first_building"):
        assert st[k] == j["stats"][k], k
    assert st["city"]["basement_tunnel_segs"] > 0


def test_traffic_and_city_frame_match(jaxw, portw):
    """Cars, trains and helicopters after their steps, the chained city
    frame and its instances: within 1e-5; stats equal."""
    tr, j = portw["tr"], jaxw
    same_tree(tr.cars, j["cars"], 1e-5, "cars")
    same_tree(tr.trains, j["trains"], 1e-5, "trains")
    same_tree(tr.helis, j["helis"], 1e-5, "helis")
    same_tree(portw["cstate"], FW.CS.CityState(*(getattr(j["cstate"], f)
                                                for f in FW.CS.CityState._fields)),
              1e-5, "city frame")
    assert [(s.kind, s.model_index) for s in portw["inst"]] == \
        [(s.kind, s.model_index) for s in j["inst"]]
    for a, b in zip(portw["inst"], j["inst"]):
        np.testing.assert_allclose(a.transforms, b.transforms, rtol=0, atol=1e-5)
    for k in ("traffic", "city_frame"):
        assert portw["stats"][k] == j["stats"][k], k


def test_vegetation_physics_lighting_universe_match(jaxw, portw):
    """Trees equal; the balls within 1e-5, status equal; the bake per
    cell within rtol 3e-5, atol 1e-6; the sweep's visibility within 1e-5;
    the star system's names and stats equal."""
    tx, ty, tz, tt, tv = (np.asarray(a) for a in portw["trees"])
    jx, jy, jz, jt, jv = (np.asarray(a) for a in jaxw["trees"])
    np.testing.assert_array_equal(tv, jv)
    for a, b in ((tx, jx), (ty, jy), (tt, jt)):
        np.testing.assert_array_equal(a[jv], b[jv])
    np.testing.assert_allclose(tz[jv], jz[jv], rtol=0, atol=1e-5)   # the carved heights
    st, ref = portw["sw"].state, jaxw["st"]
    for f in ("px", "py", "pz", "vx", "vy", "vz"):
        np.testing.assert_allclose(getattr(st, f).numpy(), np.asarray(getattr(ref, f)),
                                   rtol=0, atol=1e-5, err_msg=f)
    np.testing.assert_array_equal(st.status.numpy(), np.asarray(ref.status))
    for f in ("sc_r", "sc_g", "sc_b", "sv"):
        b = np.asarray(getattr(jaxw["grid"], f))
        assert b.sum() > 0, f
        np.testing.assert_allclose(getattr(portw["grid"], f).numpy(), b, rtol=3e-5, atol=1e-6,
                                   err_msg=f)
    np.testing.assert_allclose(portw["sgrid"].sv.numpy(), np.asarray(jaxw["sgrid"].sv),
                               rtol=0, atol=1e-5)
    for k in ("vegetation", "physics", "universe"):
        assert portw["stats"][k] == jaxw["stats"][k], k
    assert portw["stats"]["sweep_lighting"] == jaxw["stats"]["sweep_lighting"]
    assert portw["stats"]["vegetation"]["trees"] > 0


def test_map_view_matches(jaxw, portw):
    """`terrain_map` and the road and building overlay within an ulp of
    the JAX ones, the exported map image equal; `mandelbrot`'s escape
    counts equal."""
    hm, wz = jaxw["hm"], float(jaxw["ts"].water_plane_z)
    t = TMV.terrain_map(torch.as_tensor(np.asarray(hm)), wz, float(hm.min()), float(hm.max()))
    j = JMV.terrain_map(hm, wz, float(hm.min()), float(hm.max()))
    # compiled, XLA fuses the colour ramps' multiply-adds: within an ulp
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0, atol=1.2e-7)
    cb = portw["cb"]
    np.testing.assert_array_equal(
        FW.map_image(cb.hm, wz, cb.net, cb.buildings, portw["world"]), jaxw["rgb"])
    np.testing.assert_allclose(
        TMV.overlay_roads_buildings(t, cb.net.seg_array(), TCB.building_part_array(cb.buildings),
                                    portw["world"]),
        JMV.overlay_roads_buildings(j, jaxw["net"].seg_array(),
                                    JCB.building_part_array(jaxw["buildings"]), jaxw["world"]),
        rtol=0, atol=1.2e-7)
    a = TMV.mandelbrot(-0.5, 0.1, 2.5, n=48, max_iter=24, device="cpu").numpy()
    b = np.asarray(JMV.mandelbrot(-0.5, 0.1, 2.5, n=48, max_iter=24))
    # the escape counts equal; compiled, XLA divides them by 24 as a
    # multiply by 1/24, an ulp from the port's division
    np.testing.assert_array_equal(np.round(a * 24), np.round(b * 24))
    np.testing.assert_allclose(a, b, rtol=0, atol=1.2e-7)
    assert 0 < a.mean() < 1


def test_main_whole_on_cpu(jaxw, tmp_path, capsys):
    """`main` end to end on the CPU with the JAX draws: the JSON line has
    every key of the example's (and the section times), passes
    tests/test_full_world_example.py's checks, writes both PNGs, and its
    host-side keys equal the JAX example's."""
    stats, built = FW.main(str(tmp_path), sizes=SIZES, draws=jax_world_draws(), device="cpu")
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == json.loads(json.dumps(stats))
    ref = jaxw["stats"]
    assert set(ref) <= set(stats) and set(stats["section_seconds"]) >= {"terrain", "city",
                                                                        "physics", "export"}
    assert stats["city"]["buildings"] >= 1
    assert stats["first_building"]["rooms"] >= 5
    assert stats["first_building"]["furniture"] >= 20
    assert stats["physics"]["live"] > 0
    assert stats["lighting"]["sky_energy"] > 0
    assert stats["vegetation"]["trees"] > 0
    assert stats["universe"]["planets"]
    for name in stats["artifacts"]:
        assert (tmp_path / name).exists()
    # at 64^2 the heights all lie below 0 and export as a flat 87-byte
    # image, so both PNGs are checked by reading them back
    assert (tmp_path / "world_map.png").stat().st_size > 100
    back = FW.HIO.read_png_gray(str(tmp_path / "world_height.png"))
    np.testing.assert_array_equal(back, FW.HIO.heights_to_pixels(built.city.hm.numpy()))
    np.testing.assert_array_equal(FW.HIO.read_image_rgb(str(tmp_path / "world_map.png")),
                                  built.map_rgb)
    for k in ("city", "first_building", "traffic", "city_frame", "universe", "artifacts"):
        assert stats[k] == ref[k], k
    assert stats["physics"]["objects"] == ref["physics"]["objects"]

"""Torch port vs JAX package: city model instancing
(`city/model_instances`).  The test writes its own `city *_model` config
rows and OBJ model files to a temporary directory and gives the same
paths to both packages: rows parse equal (custom colours, blade
materials, people, keyword and shadow-material columns, a malformed row
skipped), meshes resolve equal (an OBJ through each package's parser;
missing files, the helicopter's .3ds among them, through the procedural
fallback), and the instance transforms of cars, pedestrians,
helicopters and furnished room objects driven by each package's traffic
state are equal within 1e-6 (the yaw's cos and sin)."""

import dataclasses
import glob
import os

import numpy as np
import pytest

import w3d  # noqa: F401
from w3d.city import model_instances as JMI, plots as JCP, roads as JCR, traffic as JCT
from w3d.city import floorplan as JCF, room_content as JRC

from w3d_torch.city import model_instances as TMI, plots as TCP, roads as TCR, traffic as TCT
from w3d_torch.city import floorplan as TCF, room_content as TRC

from torch_port_util import one_torch_thread  # noqa: F401

CONFIG = """\
# city models for the instancing test
city car_model cars/box_car.obj 1 0 0  22 -1 90  1 1.0 1.0  20 22
city car_model cars/missing_car.obj 1 0 5  3 -2 0.15 0.3 0.35 1.0  0  3 1.5 1.0  4 5
city car_model cars/tri_car.obj 0 1 3  0 -1 45  2 0.8 2.0
city ped_model people/walker.obj 1 0 1  -1 -1 0  1 1.0 1.0  0.7 1
city helicopter_model helis/ka27.3ds 1 0 5  -1 -1 0  1 2.5 1.0  1
city toilet_model objs/toilet.obj 1 0 0  -1 -1 0  1 1.0 1.0  mirrored=1 7
city sink_model objs/missing_sink.obj 1 0 0  -1 -1 0  1 1.0 1.0
city ceiling_fan_model objs/fan.obj 1 1 7  -1 -1 0  0 1.0 1.0  reverse_winding=4 allow_emissive=1
city stove_model objs/stove.obj 1 0
city fridge_model objs/fridge.obj 1 0 0  -1 -2 0.9 0.9 0.9 1.0  0  1 1.0 1.0
"""

BOX = """\
v -1 -0.5 0
v 1 -0.5 0
v 1 0.5 0
v -1 0.5 0
v -1 -0.5 0.8
v 1 -0.5 0.8
v 1 0.5 0.8
v -1 0.5 0.8
f 1 2 3 4
f 5 6 7 8
f 1 2 6 5
f 2 3 7 6
f 3 4 8 7
f 4 1 5 8
"""

TRI = "v 0 0 0\nv 2 0 0\nv 0 3 1\nvn 0 0 1\nf 1//1 2//1 3//1\n"


@pytest.fixture
def scene(tmp_path):
    """The config and model files; returns (config path, base dir)."""
    for rel, text in (("cars/box_car.obj", BOX), ("cars/tri_car.obj", TRI),
                      ("people/walker.obj", BOX), ("objs/toilet.obj", TRI),
                      ("objs/fan.obj", BOX)):
        p = tmp_path / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(text)
    cfg = tmp_path / "config_city.txt"
    cfg.write_text(CONFIG)
    return str(cfg), str(tmp_path)


def _resolve(MI, spec, base):
    """Resolve through the package's loader with no cache left by the
    other package."""
    for f in glob.glob(os.path.join(base, "*", "*.model3d.npz")):
        os.remove(f)
    return MI._resolve_mesh_uncached(spec, base)


def _rows(specs):
    """parse_city_models' output as plain dicts."""
    d = lambda v: [dataclasses.asdict(s) for s in v]
    return {k: ({n: d(v) for n, v in specs[k].items()} if k == "objects" else d(specs[k]))
            for k in specs}


def test_parse_rows_match(scene):
    cfg, _ = scene
    t, j = TMI.parse_city_models(cfg), JMI.parse_city_models(cfg)
    assert _rows(t) == _rows(j)
    assert len(t["car"]) == 3 and len(t["ped"]) == 1 and len(t["helicopter"]) == 1
    assert t["car"][1].fixed_color_id == -2 and t["car"][0].shadow_mat_ids == [20, 22]
    assert set(t["objects"]) == {"toilet", "sink", "ceiling_fan", "fridge"}   # stove malformed
    assert t["objects"]["ceiling_fan"][0].rev_winding_mask == 4
    assert _rows(TMI.parse_city_models(cfg, include_objects=False)) == \
        _rows(JMI.parse_city_models(cfg, include_objects=False))


def test_meshes_resolve_equal_with_fallbacks(scene):
    """Every spec's mesh: OBJ files parsed by each package, the missing
    files take the same procedural fallback; the fallback car is the
    nominal car size."""
    cfg, base = scene
    t, j = TMI.parse_city_models(cfg), JMI.parse_city_models(cfg)
    specs = [(a, b) for kind in ("car", "ped", "helicopter")
             for a, b in zip(t[kind], j[kind])]
    specs += [(t["objects"][n][0], j["objects"][n][0]) for n in t["objects"]]
    for a, b in specs:
        ma, mb = _resolve(TMI, a, base), _resolve(JMI, b, base)
        for f in ma._fields:
            np.testing.assert_array_equal(getattr(ma, f), getattr(mb, f), err_msg=f"{a.fn} {f}")
    fb = _resolve(TMI, t["car"][1], base)
    lo, hi = fb.bounds()
    assert fb.num_faces == 12 and (hi - lo).max() == pytest.approx(TCT.CAR_LEN, rel=1e-6)
    assert TMI.resolve_mesh(t["car"][0], base) is TMI.resolve_mesh(t["car"][0], base)


def _city(CP, CR, CT, device=None):
    kw = {} if device is None else {"device": device}
    _, plots = CP.gen_cities(np.zeros((96, 96), np.float32), -0.5, num_cities=1, seed=2)
    net = CR.gen_city_roads(plots)
    graph = CT.build_road_graph(net, **kw)
    cars = CT.make_cars(24, graph, seed=2)
    peds = CT.make_peds(16, net.blocks, seed=3, **kw)
    helis = CT.make_helis(3, np.array([[1.0, 2.0, 0.5], [4.0, 1.0, 0.7]], np.float32), seed=2,
                          **kw)
    return graph, cars, peds, helis


def _same_sets(a, b):
    assert [(s.kind, s.model_index, s.color) for s in a] == \
        [(s.kind, s.model_index, s.color) for s in b]
    for s, r in zip(a, b):
        for f in s.mesh._fields:
            np.testing.assert_array_equal(getattr(s.mesh, f), getattr(r.mesh, f))
        np.testing.assert_allclose(s.transforms, r.transforms, rtol=0, atol=1e-6)


def test_instances_driven_by_traffic_match(scene):
    """Cars (three models), pedestrians and helicopters from each
    package's traffic state, with and without specs."""
    cfg, base = scene
    tg, tc, tp, th = _city(TCP, TCR, TCT, device="cpu")
    jg, jc, jp, jh = _city(JCP, JCR, JCT)
    for ts, js in ((TMI.parse_city_models(cfg), JMI.parse_city_models(cfg)), (None, None)):
        a = TMI.city_instances(cars=tc, graph=tg, peds=tp, helis=th, specs=ts, base_dir=base,
                               ground_z=0.1, seed=4)
        b = JMI.city_instances(cars=jc, graph=jg, peds=jp, helis=jh, specs=js, base_dir=base,
                               ground_z=0.1, seed=4)
        _same_sets(a, b)
        assert sum(s.transforms.shape[0] for s in a if s.kind == "car") == 24


def test_room_object_instances_match(scene):
    """Furnished room objects bound to the object-model rows (toilet from
    its OBJ, the sink's missing file on the fallback, the fridge's custom
    colour), offset into a building."""
    cfg, base = scene
    ti = TCF.gen_interior((0.0, 0.0, 0.0, 0.6, 0.45, 0.4), 4, 0.08, seed=3)
    ji = JCF.gen_interior((0.0, 0.0, 0.0, 0.6, 0.45, 0.4), 4, 0.08, seed=3)
    to, jo = TRC.furnish_rooms(ti, 0.08, seed=3), JRC.furnish_rooms(ji, 0.08, seed=3)
    a = TMI.room_object_instances(to, specs=TMI.parse_city_models(cfg), base_dir=base,
                                  offset=(1.0, 2.0, 0.5))
    b = JMI.room_object_instances(jo, specs=JMI.parse_city_models(cfg), base_dir=base,
                                  offset=(1.0, 2.0, 0.5))
    _same_sets(a, b)
    assert {s.kind for s in a} & {"toilet", "sink", "fridge"}

"""Torch port vs JAX package: basement tunnels (`city/tunnels`) and
`build_city(interiors=True)`.  Generation is host code in both packages,
so segments, gates, side connections and manholes are equal; the walk-area
clamp is held within 1e-6 on random points in and around the bores."""

import dataclasses

import numpy as np
import pytest
import torch

import w3d  # noqa: F401
from w3d.city import assemble as JCA, buildings as JCB, floorplan as JCF
from w3d.city import tunnels as JTN

from w3d_torch.city import assemble as TCA, buildings as TCB, floorplan as TCF
from w3d_torch.city import tunnels as TTN

from torch_port_util import one_torch_thread  # noqa: F401


def _basement_building(CB, CF, seed=7, fh=0.12):
    """One building whose interior has a basement room (floor -1), as
    tests/test_tunnels.py finds it."""
    params = CB.BuildingParams(floor_height=fh)
    for s in range(seed, seed + 200):
        bl = CB.place_buildings_in_blocks([(0.0, 0.0, 4.0, 4.0, 0)], lambda a, b: 0.0,
                                          params, seed=s)
        CF.gen_building_interiors(bl, params, seed=s)
        for b in bl:
            inter = getattr(b, "interior", None)
            if inter is not None and any(r.floor < 0 for r in inter.rooms):
                return b, bl, params
    raise RuntimeError("no basement building found")


def _segs(segs):
    return [dataclasses.asdict(s) for s in segs]


@pytest.fixture(scope="module")
def basements():
    return _basement_building(JCB, JCF), _basement_building(TCB, TCF)


@pytest.mark.parametrize("seed", [0, 3, 11])
def test_segments_gates_and_manholes_equal(basements, seed):
    """`gen_tunnels` and `add_tunnel_objects` give the same segments (end
    points, gates, water, side connections) and the same pipes, webs,
    gates and manholes."""
    (jb, jbl, jp), (tb, tbl, tp) = basements
    js = JTN.gen_tunnels(jb, jbl, jp.floor_height, seed=seed)
    ts = TTN.gen_tunnels(tb, tbl, tp.floor_height, seed=seed)
    assert len(ts) >= 3 and _segs(ts) == _segs(js)
    p0 = jb.parts[0]
    fp = (p0[0], p0[1], p0[3], p0[4])
    jo = JTN.add_tunnel_objects(js, fp, seed=seed, ground_z=p0[2] + 1.0)
    to = TTN.add_tunnel_objects(ts, fp, seed=seed, ground_z=p0[2] + 1.0)
    assert to == jo and _segs(ts) == _segs(js)


def test_clamp_to_walk_area_matches(basements):
    """`pack_tunnels` and `clamp_to_walk_area` on 512 points scattered
    over the network's bounding box, most inside a bore: within 1e-6 (the
    clamp is a few float32 adds and compares; both packages round them
    alike)."""
    (jb, jbl, jp), (tb, tbl, tp) = basements
    js = JTN.gen_tunnels(jb, jbl, jp.floor_height, seed=3)
    ts = TTN.gen_tunnels(tb, tbl, tp.floor_height, seed=3)
    lo = np.min([s.bcube()[:3] for s in js], axis=0)
    hi = np.max([s.bcube()[3:] for s in js], axis=0)
    rng = np.random.default_rng(5)
    pts = (lo + (hi - lo) * rng.random((512, 3))).astype(np.float32)
    # points on the segments' centerlines, jittered across the bore
    for k, s in enumerate(js):
        t = rng.random(32)
        c = np.asarray(s.p0) + t[:, None] * (np.asarray(s.p1) - np.asarray(s.p0))
        c[:, 1 - s.dim] += (rng.random(32) - 0.5) * 1.6 * s.radius
        pts[32 * k:32 * (k + 1)] = c
    for ur in (0.0, 0.02):
        ref = np.asarray(JTN.clamp_to_walk_area(pts, ur, JTN.pack_tunnels(js)))
        out = TTN.clamp_to_walk_area(torch.as_tensor(pts), ur,
                                     TTN.pack_tunnels(ts, device="cpu")).numpy()
        np.testing.assert_allclose(out, ref, rtol=0, atol=1e-6)
        assert (np.abs(out - pts).max(axis=1) > 1e-6).sum() > 16   # the clamp acts
    jp_, tp_ = JTN.pack_tunnels(js, cap=4), TTN.pack_tunnels(ts, cap=4, device="cpu")
    for k in TTN.PACK_FIELDS:
        np.testing.assert_array_equal(tp_[k].numpy(), np.asarray(jp_[k]))


def test_tunnels_to_cobjs_matches(basements):
    """The collision export's packed cobjs are equal field by field."""
    (jb, jbl, jp), (tb, tbl, tp) = basements
    ref = JTN.tunnels_to_cobjs(JTN.gen_tunnels(jb, jbl, jp.floor_height, seed=3))
    out = TTN.tunnels_to_cobjs(TTN.gen_tunnels(tb, tbl, tp.floor_height, seed=3),
                               device="cpu")
    for f in ("shape", "p1", "p2", "r1", "r2"):
        np.testing.assert_array_equal(getattr(out, f).numpy(), np.asarray(getattr(ref, f)))


def test_build_city_interiors_matches():
    """`build_city(interiors=True)`: every building's interior (rooms,
    doors, walls, stairs, elevators), the tunnel networks and the
    manholes equal the JAX ones."""
    hm = np.zeros((64, 64), np.float32)
    kw = dict(num_cities=1, num_cars=8, num_peds=8, num_helis=0, seed=2, interiors=True)
    jw = JCA.build_city(hm, **kw)
    tw = TCA.build_city(hm, device="cpu", **kw)
    assert len(tw.buildings) == len(jw.buildings) > 0
    for a, b in zip(tw.buildings, jw.buildings):
        assert dataclasses.asdict(a.interior) == dataclasses.asdict(b.interior)
    assert tw.tunnels and [(i, _segs(s)) for i, s in tw.tunnels] == \
        [(i, _segs(s)) for i, s in jw.tunnels]
    assert tw.manholes == jw.manholes

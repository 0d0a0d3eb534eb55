"""Torch port vs JAX package: city street objects (`city/objects`), the
bird perches they give (`traffic.bird_perches`) and their collision
export (`objects_to_cobjs`).  The placer is host code in both packages,
so objects, perches and packed cobjs are equal; 32 chained city frames
with birds on those perches hold within 1e-5 on the JAX draws."""

import numpy as np
import pytest
import jax
import torch

import w3d  # noqa: F401
from w3d.city import objects as JCO, plots as JCP, roads as JCR, traffic as JCT
from w3d.city import buildings as JCB, city_step as JCS

from w3d_torch.city import objects as TCO, plots as TCP, roads as TCR, traffic as TCT
from w3d_torch.city import buildings as TCB, city_step as TCS

from torch_port_util import jax_city_draws, one_torch_thread, same_tree  # noqa: F401


def _layout(CP, CR, CB, size):
    plots = [CP.CityPlot(0, 0, size, size, 0.0)]
    net = CR.gen_city_roads(plots, block_size=8)
    bl = CB.place_buildings_in_blocks(net.blocks, lambda x, y: 0.0, CB.BuildingParams(),
                                      seed=3)
    return net, bl


@pytest.mark.parametrize("size,seed", [(24, 3), (40, 7)])
def test_placer_and_perches_match(size, seed):
    """`place_city_objects` with and without buildings, and the perches
    on those objects plus the roofs, equal the JAX ones."""
    jnet, jbl = _layout(JCP, JCR, JCB, size)
    tnet, tbl = _layout(TCP, TCR, TCB, size)
    for jb, tb in (([], []), (jbl, tbl)):
        jo = JCO.place_city_objects(jnet, jb, seed=seed)
        to = TCO.place_city_objects(tnet, tb, seed=seed)
        assert len(to.x) > 20
        for f in ("x", "y", "kind", "rot"):
            np.testing.assert_array_equal(getattr(to, f), getattr(jo, f))
        jp, tp = JCT.bird_perches(jo, jb), TCT.bird_perches(to, tb)
        np.testing.assert_array_equal(tp, jp)
        assert len(tp) > len(tb)      # some perches are on objects
    np.testing.assert_array_equal(TCT.bird_perches(None, tbl), JCT.bird_perches(None, jbl))


def test_objects_to_cobjs_matches():
    """The objects as packed collision cylinders: every field equal."""
    jnet, _ = _layout(JCP, JCR, JCB, 24)
    tnet, _ = _layout(TCP, TCR, TCB, 24)
    ref = JCO.objects_to_cobjs(JCO.place_city_objects(jnet, [], seed=3), ground_z=0.25)
    out = TCO.objects_to_cobjs(TCO.place_city_objects(tnet, [], seed=3), ground_z=0.25,
                               device="cpu")
    for f in ("shape", "p1", "p2", "r1", "r2"):
        np.testing.assert_array_equal(getattr(out, f).numpy(), np.asarray(getattr(ref, f)))


def test_birds_on_object_perches_match():
    """32 chained city frames with 12 birds (waiting 1-12 frames) flying
    between object and roof perches, on the JAX frame's draws: the whole
    city state within 1e-5."""
    jnet, jbl = _layout(JCP, JCR, JCB, 40)
    tnet, tbl = _layout(TCP, TCR, TCB, 40)
    jp = JCT.bird_perches(JCO.place_city_objects(jnet, jbl, seed=7), jbl)
    tp = TCT.bird_perches(TCO.place_city_objects(tnet, tbl, seed=7), tbl)
    jg, tg = JCT.build_road_graph(jnet), TCT.build_road_graph(tnet, device="cpu")
    jnav, tnav = JCT.build_ped_nav(jnet), TCT.build_ped_nav(tnet, device="cpu")
    key = jax.random.key(9)
    js = JCS.CityState(stoplights=JCT.build_stoplights(jnet, seed=1),
                       cars=JCT.make_cars(8, jg, seed=1), peds=JCT.make_peds(8, jnet.blocks, seed=2),
                       people=None, elev=JCS.make_elevator_bank(1), helis=None,
                       birds=JCT.make_birds(12, jp, seed=4), key=key)
    js = js._replace(birds=js.birds._replace(wait=jax.numpy.arange(1, 13, dtype=np.int32)))
    ts = TCS.CityState(stoplights=TCT.build_stoplights(tnet, seed=1, device="cpu"),
                       cars=TCT.make_cars(8, tg, seed=1),
                       peds=TCT.make_peds(8, tnet.blocks, seed=2, device="cpu"),
                       people=None, elev=TCS.make_elevator_bank(1, device="cpu"), helis=None,
                       birds=TCT.make_birds(12, tp, seed=4, device="cpu"))
    ts = ts._replace(birds=ts.birds._replace(wait=torch.arange(1, 13, dtype=torch.int32)))
    js = JCS.city_frames_chained(js, jg, jnav, None, jax.numpy.asarray(jp), 32)
    draws, _ = jax_city_draws(key, 32, 8, n_birds=12, n_perches=len(tp))
    ts = TCS.city_frames_chained(ts, tg, tnav, None, torch.as_tensor(tp), 32, draws)
    same_tree(ts, TCS.CityState(*(getattr(js, f) for f in TCS.CityState._fields)), 1e-5,
              "city")
    assert int((ts.birds.state != 0).sum()) > 0

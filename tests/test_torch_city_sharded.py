"""Torch port vs JAX package: the agent-sharded city frame
(`w3d_torch/parallel/city.py`), the JAX dry run's phase 6.

One 4-rank gloo group on the CPU (`torch_rank_cases.city_cases`) runs every
case once, in a module fixture; the JAX side runs phase 6 here on a
4-device mesh of conftest's virtual CPU devices (cars and pedestrians
sharded on an `agents` axis, 2 frames of the compiled
`city_frames_chained`) and its threefry draws reach the port through
`jax_city_draws`.  Bounds against JAX: tests/test_torch_city.py's (car
and other floats 1e-5, pedestrian positions 1e-4, integers equal).
Against the port's single-rank `city_frames_chained` on the same draws:
every field bit for bit, also where a car's leader or a pedestrian's
neighbour lies on another rank."""

import numpy as np
import pytest
import jax
import torch
from jax.sharding import Mesh as JMesh, NamedSharding, PartitionSpec as P

import w3d  # noqa: F401
from w3d.city import assemble as JCA, city_step as JCS

from w3d_torch import convert
from w3d_torch.city import city_step as TCS, traffic as TCT
from w3d_torch.parallel import launch

import torch_rank_cases
from torch_port_util import jax_city_draws, np_tree, same_tree

RANKS = 4
NC, NP = 8 * RANKS, 16 * RANKS          # the dry run's 8n cars and 16n pedestrians
KC, KP = NC // RANKS, NP // RANKS


@pytest.fixture(scope="module")
def phase6():
    """The JAX phase 6 on 4 devices: the whole start state (numpy), its
    2-frame result, the draws the JAX chain took, and the port's graph and
    nav."""
    cw = JCA.build_city(np.zeros((64, 64), np.float32), num_cities=1, num_cars=NC,
                        num_peds=NP, num_helis=0, seed=1)
    ccs = JCS.CityState(stoplights=cw.stoplights, cars=cw.cars, peds=cw.peds, people=None,
                        elev=JCS.make_elevator_bank(1), helis=None, birds=None,
                        key=jax.random.key(3), trains=None)
    start = np_tree(ccs._replace(key=None))
    cmesh = JMesh(np.array(jax.devices()[:RANKS]), axis_names=("agents",))
    ag = NamedSharding(cmesh, P("agents"))

    def shard(x):
        arr = jax.numpy.asarray(x)
        if arr.ndim >= 1 and arr.shape[0] % RANKS == 0 and arr.shape[0] >= RANKS:
            return jax.device_put(arr, ag)
        return arr
    ccs = ccs._replace(cars=jax.tree.map(shard, ccs.cars), peds=jax.tree.map(shard, ccs.peds))
    with cmesh:
        out = JCS.city_frames_chained(ccs, cw.graph, cw.ped_nav, None, None, frames=2)
    draws, _ = jax_city_draws(jax.random.key(3), 2, NP)
    return (start, out, draws, convert.road_graph(np_tree(cw.graph), "cpu"),
            convert.ped_nav(np_tree(cw.ped_nav), "cpu"))


def _crafted(start, graph):
    """Two cases across the rank-0 / rank-1 slab edge: car KC-1 trails car
    KC on one lane within the headway gap; pedestrian KP+0 stands 0.05
    from pedestrian KP-1 (the separation radius is 0.15)."""
    cs = convert.city_state(start, "cpu")
    cars = cs.cars
    seg = int(cars.seg[KC - 1])
    gap = 0.1 / float(graph.length[seg])
    put = lambda t, i, v: torch.cat([t[:i], torch.as_tensor([v], dtype=t.dtype), t[i + 1:]])
    lead = cars._replace(seg=put(cars.seg, KC, seg), end=put(cars.end, KC, 1),
                         t=put(put(cars.t, KC - 1, 0.3), KC, 0.3 + gap),
                         parked=put(put(cars.parked, KC - 1, False), KC, False))
    lead = lead._replace(end=put(lead.end, KC - 1, 1))
    behind = lead._replace(t=put(lead.t, KC, 0.1))
    p = cs.peds
    pair = p._replace(x=put(p.x, KP, float(p.x[KP - 1]) + 0.05),
                      y=put(p.y, KP, float(p.y[KP - 1])))
    return (cs._replace(cars=lead), cs._replace(cars=behind), cs._replace(peds=pair))


@pytest.fixture(scope="module")
def ranks(phase6):
    start, _out, jdraws, graph, nav = phase6
    cs = convert.city_state(start, "cpu")
    long_draws = TCS.draw_city(24, NP, 0, 0, 0, 0, torch.Generator().manual_seed(11),
                               device="cpu")
    lead, behind, pair = _crafted(start, graph)
    one = TCS.draw_city(1, NP, 0, 0, 0, 0, torch.Generator().manual_seed(12), device="cpu")
    inp = {"phase6": (cs, graph, nav, jdraws, 2, False),
           "long": (cs, graph, nav, long_draws, 24, False),
           "per_frame": (cs, graph, nav, long_draws, 6, True),
           "lead": (lead, graph, nav, one, 1, False),
           "behind": (behind, graph, nav, one, 1, False),
           "pair": (pair, graph, nav, one, 1, False)}
    res = launch.run_ranks(torch_rank_cases.city_cases, RANKS, "gloo", "cpu", inp,
                           timeout=300)
    return inp, [r.value for r in res]


def _single(case):
    cs, graph, nav, draws, frames, _ = case
    return TCS.city_frames_chained(cs, graph, nav, None, None, frames, draws)


def test_phase6_matches_the_jax_sharded_call(phase6, ranks):
    """2 frames over 4 ranks against the JAX phase 6 on 4 devices: car and
    pedestrian fields within the bounds, the rest equal, finite (what the
    JAX phase asserts)."""
    _start, jout, _d, _g, _n = phase6
    _inp, out = ranks
    got = out[0]["phase6"][0][-1]
    assert bool(torch.isfinite(got.cars.t).all()) and bool(torch.isfinite(got.peds.x).all())
    same_tree(got.cars, jout.cars, 1e-5, "cars")
    same_tree(got.peds._replace(x=None, y=None), jout.peds._replace(x=None, y=None), 1e-5,
              "peds")
    for f in ("x", "y"):
        np.testing.assert_allclose(getattr(got.peds, f).numpy(),
                                   np.asarray(getattr(jout.peds, f)), rtol=0, atol=1e-4)
    same_tree(got.stoplights, jout.stoplights, 0.0, "stoplights")
    same_tree(got.elev, jout.elev, 0.0, "elev")


@pytest.mark.parametrize("case", ["phase6", "long", "lead", "behind", "pair"])
def test_sharded_frames_equal_the_single_rank_call(ranks, case):
    """Every rank's gathered state equals the port's one-rank chain on the
    same draws, bit for bit."""
    inp, out = ranks
    ref = _single(inp[case])
    for r in range(RANKS):
        same_tree(out[r][case][0][-1], convert.to_numpy(ref), 0.0, f"rank {r} {case}")


def test_frame_by_frame_equals_the_chain(ranks):
    """Six one-frame calls equal the single-rank chain after each frame."""
    inp, out = ranks
    cs, graph, nav, draws, _f, _ = inp["per_frame"]
    for k, got in enumerate(out[0]["per_frame"][0]):
        d = type(draws)(*(None if t is None else t[k:k + 1] for t in draws))
        cs = TCS.city_frames_chained(cs, graph, nav, None, None, 1, d)
        same_tree(got, convert.to_numpy(cs), 0.0, f"frame {k}")


def test_a_leader_on_the_next_rank_holds_a_car(ranks):
    """Car KC-1 (rank 0) stops behind car KC (rank 1) on its lane, and
    drives on when that car is far behind it."""
    inp, out = ranks
    t0 = float(inp["lead"][0].cars.t[KC - 1])
    assert float(out[0]["lead"][0][-1].cars.t[KC - 1]) == t0
    assert float(out[0]["behind"][0][-1].cars.t[KC - 1]) > t0


def test_a_neighbour_on_the_next_rank_pushes_a_pedestrian(ranks):
    """Pedestrians KP-1 (rank 0) and KP (rank 1) push each other apart
    along x, so pedestrian KP-1 steps otherwise than in the same frame
    without its neighbour (the "lead" case's crowd)."""
    inp, out = ranks
    p = inp["pair"][0].peds
    rx, _ry = TCT._separation(p.x, p.y, 0.15)
    assert float(rx[KP - 1]) < 0.0 < float(rx[KP])
    with_pair, without = out[0]["pair"][0][-1].peds, out[0]["lead"][0][-1].peds
    assert (float(with_pair.x[KP - 1]), float(with_pair.y[KP - 1])) != \
        (float(without.x[KP - 1]), float(without.y[KP - 1]))


def test_bytes_a_frame(ranks):
    """Each frame gathers the cars' segment, end, parameter and parked flag
    (13 bytes) and the pedestrians' x and y (8 bytes) once: a rank
    receives the other ranks' share."""
    _inp, out = ranks
    per_frame = (RANKS - 1) * (KC * 13 + KP * 8)
    for r in range(RANKS):
        assert out[r]["phase6"][1] == 2 * per_frame
        assert out[r]["long"][1] == 24 * per_frame

"""The live tiled city (`tiled_city.walk`'s program path) against the
benchmark's plain reference `benchmark/reference/city.py`, on the CPU at
a tiny size: 2 cities of 24 cells, 64 cars, 256 pedestrians, a tower of
12 building people, 4 helicopters, 8 birds and 2 trains.

16 frames of `city_step.city_frames_chained` (two chained calls of 8,
each followed by the host's reroute) on the reference's draws, against
the reference run from the same start with the same reroutes: integer
fields equal, floats within the cell's limits.  Besides: `build_city`'s
`city_size` (the default builds the 24-cell city as before; 64 cells give
64 blocks and 256 parking spots a city), the city's spans under a
profiler (and none without one, or without a city), the readers of the
cell's span metrics on hand-built traces, and the reference's imports.
On the card (`gpu`): the chunk's CUDA graphs replay the eager frames bit
for bit.  This file imports no jax.
"""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark import harness as H
from benchmark.reference import city as RC
from benchmark.systems import tiled_city as SC
from w3d_torch.city import assemble as CA
from w3d_torch.city import city_step as CS
from w3d_torch.city import floorplan as CF
from w3d_torch.city import plots as CP
from w3d_torch.city import room_content as CRC
from w3d_torch.city import traffic as CT
from w3d_torch.models import world as W
from w3d_torch.utils import profiler as P

from torch_port_util import cuda_device, one_torch_thread  # noqa: F401

LIMITS = H.read_json(os.path.join(H.ROOT, "benchmark/configs/tiled_city_128.json"))[
    "check"]["limits"]


def _world(seed: int, tile_mgr=None, device="cpu") -> W.TiledWorld:
    cw = CA.build_city(np.zeros((128, 128), np.float32), num_cities=2, num_cars=64,
                       num_peds=256, num_helis=4, seed=seed, device=device)
    tower = CF.gen_interior((0.0, 0.0, 0.0, 1.2, 0.9, 0.4), 3, 0.08, seed=seed)
    objs = CRC.furnish_rooms(tower, 0.08, seed=seed)
    return W.make_tiled_world(tile_mgr, cw, builders=[(tower, 12, objs)], seed=seed,
                              chunk=8, num_birds=8, num_trains=2, draws=SC.Draws(seed),
                              device=device)


class _NoTiles:
    """A tile manager with nothing to stream: the city frame alone."""

    def update(self, cam_x, cam_y, max_tiles_per_frame=None):
        return [], []


@pytest.mark.parametrize("seed", [3, 2**31 + 11])
def test_frames_equal_the_reference(seed):
    """Two chained calls of 8 frames, each followed by the reroute: every
    field against the reference.  Integer fields and masks: equal.  Floats
    within the cell's limits (`tiled_city_128.json`): on one device both
    sides take the same operations in the same order and agree bit for
    bit.  The limits leave a pedestrian room to sum its neighbours'
    pushes in another order (1e-3 cells, ~30 ulps of a coordinate near
    512); the helicopters, birds and trains 1e-4 (3 ulps there); the cars'
    `t` (in [0, 1]) and the building people's positions (within 1.2
    cells) 1e-5, some 80 ulps."""
    w = _world(seed % 2**31, _NoTiles())
    lay = SC.layout(w)
    start = SC.city_state(w.city)
    frames = []
    for k in range(2):
        f0 = w.frame
        w.step_chunk(0.0, 0.0, frames=8)
        frames += [(RC.frame_draws(seed % 2**31, f0 + j, **w.draws.counts), None)
                   for j in range(8)]
        frames[-1] = (frames[-1][0], w.bldg.applied)
    got = SC.city_state(w.city)
    want = RC.run(lay, start, frames)
    r = RC.readings(got, want)
    for k, v in r.items():
        assert v <= LIMITS[k], (k, v)
    for part in want:
        for f, a in (want[part] or {}).items():
            b = got[part][f]
            if a.dtype.is_floating_point:
                continue
            assert torch.equal(a, b), (part, f)
    assert int(w.city.people.x.shape[0]) == 12 and w.counts["city_frames"] == 16
    assert w.counts["probe_fetches"] == 2 and w.counts["separation"] == 0   # no kernel on the CPU


def test_the_control_fails_a_limit():
    """The reference with the cars', crowds' and movers' float state in
    bfloat16 leaves the limits of the positions."""
    w = _world(5, _NoTiles())
    lay, start = SC.layout(w), SC.city_state(w.city)
    frames = [(RC.frame_draws(5, j, **SC.Draws(5).sizes(w)), None) for j in range(16)]
    r = RC.readings(RC.run(lay, start, frames, lowp=True), RC.run(lay, start, frames))
    assert r["ped_pos_err_max"] > LIMITS["ped_pos_err_max"]
    assert r["car_t_err_max"] > LIMITS["car_t_err_max"]
    assert r["movers_err_max"] > LIMITS["movers_err_max"]


def test_build_city_default_is_the_24_cell_city():
    """The default `city_size` builds the city `gen_cities` places with
    its own default, field by field as an explicit 24 builds it."""
    hm = np.zeros((96, 96), np.float32)
    kw = dict(num_cities=2, num_cars=16, num_peds=24, num_helis=2, seed=3, device="cpu")
    a, b = CA.build_city(hm, **kw), CA.build_city(hm, city_size=24, **kw)
    _, plots = CP.gen_cities(hm, -0.5, num_cities=2, seed=3)
    assert {(p.x1, p.y1, p.x2 - p.x1 + 1) for p in plots} == \
        {(min(s.x1 for s in a.net.segs if s.city == c), min(s.y1 for s in a.net.segs if s.city == c),
          24) for c in range(2)}
    assert a.net.segs == b.net.segs and a.net.blocks == b.net.blocks
    assert [dataclasses.asdict(x) for x in a.buildings] == [dataclasses.asdict(x) for x in b.buildings]
    for name in ("graph", "stoplights", "cars", "peds", "ped_nav", "helis"):
        for x, y in zip(getattr(a, name), getattr(b, name)):
            assert torch.equal(x, y), name


def test_city_size_64_gives_64_blocks_and_256_spots_a_city():
    cw = CA.build_city(np.zeros((256, 256), np.float32), num_cities=2, num_cars=16,
                       num_peds=24, num_helis=0, seed=1, city_size=64, device="cpu")
    per = [sum(1 for b in cw.net.blocks if b[4] == c) for c in range(2)]
    assert per == [64, 64]
    assert len(CT.gen_parking_spots(cw.net.blocks)) == 2 * 256
    assert len(cw.net.segs) == 2 * 18


def _tree(spans):
    return [(s.name, s.parent.name if s.parent else None) for s in spans]


def test_a_traced_city_frame_opens_its_spans():
    """Under a profiler one frame opens `city` (with `city.cars`,
    `city.peds`, `city.people` in it), `sync.people_probe` and
    `city.reroute` under `frame`; none without a profiler; the stream's
    world (no city) none under one."""
    w = _world(4, _NoTiles())
    P.spans(clear=True)
    w.step(0.0, 0.0)
    assert P.spans() == []
    with profile(activities=[ProfilerActivity.CPU]):
        w.step(0.0, 0.0)
    assert _tree(P.spans(clear=True)) == [
        ("frame", None), ("city", "frame"), ("city.cars", "city"), ("city.peds", "city"),
        ("city.people", "city"), ("sync.people_probe", "frame"), ("city.reroute", "frame")]
    bare = W.TiledWorld(tile_mgr=_NoTiles())
    with profile(activities=[ProfilerActivity.CPU]):
        bare.step(0.0, 0.0)
    assert _tree(P.spans(clear=True)) == [("frame", None)]


def test_spans_leave_the_frames_bit_for_bit():
    a, b = _world(6, _NoTiles()), _world(6, _NoTiles())
    a.step_chunk(0.0, 0.0, frames=4)
    with profile(activities=[ProfilerActivity.CPU]):
        b.step_chunk(0.0, 0.0, frames=4)
    P.spans(clear=True)
    for x, y in zip(SC.city_state(a.city).values(), SC.city_state(b.city).values()):
        for f in (x or {}):
            assert torch.equal(x[f], y[f]), f


@pytest.mark.gpu
def test_replayed_city_frames_are_eager_frames(cuda_device, monkeypatch):
    """On the card a world's one-frame chunk runs eager, then captures and
    replays its CUDA graphs (`city_step.FRAMES`), bit for bit the eager
    frames of a twin world whose key is None; under a profiler a replay
    opens the frame's phase spans, with CUDA events."""
    a, b = _world(7, _NoTiles(), cuda_device), _world(7, _NoTiles(), cuda_device)
    with monkeypatch.context() as m:
        m.setattr(CS, "frame_key", lambda *args, **kw: None)
        for _ in range(6):
            b.step(0.0, 0.0)
    before = dict(CS.FRAMES.counts)
    for _ in range(6):
        a.step(0.0, 0.0)
    assert [CS.FRAMES.counts[k] - before[k] for k in
            ("graph_eager", "graph_captures", "graph_replays", "graph_failed")] == [1, 1, 5, 0]
    for x, y in zip(SC.city_state(a.city).values(), SC.city_state(b.city).values()):
        for f in (x or {}):
            assert torch.equal(x[f], y[f]), f
    P.spans(clear=True)
    with profile(activities=[ProfilerActivity.CUDA]):
        a.step(0.0, 0.0)
    got = P.spans(clear=True)
    assert [n for n, _ in _tree(got)] == ["frame", "city", "city.graph", "city.cars",
                                          "city.peds", "city.people", "sync.people_probe",
                                          "city.reroute"]
    assert all(s.device_ms > 0.0 for s in got if s.name in ("city", "city.peds"))


# ---------------------------------------------------------------------------
# the readers of the cell's span metrics
# ---------------------------------------------------------------------------

class _Event:
    def __init__(self, t_ms):
        self.t = t_ms

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return end.t - self.t


def _span(name, parent, a_us, b_us, device_ms=None):
    s = P.Span(name, device_ms is not None)
    s.parent, s.start, s.end = parent, int(a_us * 1000), int(b_us * 1000)
    s.events = None if device_ms is None else (_Event(0.0), _Event(device_ms))
    return s


def _city_spans(n=4):
    """`n` frames: frame k's city 4 + k ms of device time (peds 3 + k,
    cars 0.5), its probe 100 us, its reroute 150 + 100 k us."""
    out = []
    for k in range(n):
        a = 1010.0 + 2000.0 * k
        f = _span("frame", None, a, a + 950)
        c = _span("city", f, a + 10, a + 500, 4.0 + k)
        out += [f, c, _span("city.cars", c, a + 20, a + 100, 0.5),
                _span("city.peds", c, a + 100, a + 400, 3.0 + k),
                _span("city.people", c, a + 400, a + 480, 0.2),
                _span("sync.people_probe", f, a + 500, a + 600),
                _span("city.reroute", f, a + 600, a + 750 + 100 * k)]
    return out


def _run(n_calls):
    marks = []
    for k in range(n_calls):
        a = 1000.0 + 2000.0 * k
        marks += [("bench.call", a, a + 1000.0), ("bench.read", a + 1000.0, a + 1010.0)]
    tr = H.Trace(device_ops=[], kernels=[], spans=marks, window=(marks[0][1], 9000.0),
                 steps=n_calls)
    return H.Run(setup_s=1.0, steps=[(0.0, 0.5, 1.0)] * n_calls, items_per_step=1,
                 trace=tr, work={})


def _reader(name):
    return H.load_file_module(H.reader_path(H.BENCH_DIR, name),
                              "test_reader_" + name.replace(".", "_"))


READS = [("city_device_ms.walk", 5.5), ("ped_device_ms.walk", 4.5),
         ("car_device_ms.walk", 0.5), ("reroute_host_ms.walk", 0.3),
         ("host_sync_ms.walk", 0.1)]


@pytest.mark.parametrize("name,want", READS)
def test_city_reader_on_a_hand_built_trace(monkeypatch, name, want):
    monkeypatch.setattr(P, "_SPANS", _city_spans())
    assert _reader(name).read(_run(4)) == pytest.approx(want, rel=1e-9)


@pytest.mark.parametrize("name", [r[0] for r in READS[:4]])
def test_city_reader_none_without_city_spans(monkeypatch, name):
    """A program without the city's spans (the parent's): nothing to read."""
    monkeypatch.setattr(P, "_SPANS", [s for s in _city_spans() if s.name == "frame"])
    assert _reader(name).read(_run(4)) is None
    monkeypatch.setattr(P, "_SPANS", [])
    assert _reader(name).read(_run(4)) is None


def test_the_city_reference_loads_nothing_of_the_port():
    code = ("import sys, benchmark.reference.city; "
            "print(','.join(sorted({n.split('.')[0] for n in sys.modules})))")
    env = {k: v for k, v in os.environ.items() if k not in ("PYTHONPATH", "JAX_PLATFORMS")}
    out = subprocess.run([sys.executable, "-c", code], cwd=H.ROOT, env=env,
                         capture_output=True, text=True, timeout=300, check=True)
    mods = set(out.stdout.strip().splitlines()[-1].split(","))
    assert "torch" in mods and not mods & (set(H.FORBIDDEN) | {"w3d_torch"})


def test_harness_runs_the_city_cell_traced():
    """The harness's traced run of the cell at a tiny size on the CPU:
    correct, with the city's counters and host-side span metrics.  A
    process of its own: the harness refuses to run beside JAX."""
    tiny = {"config": {"tile_size": 16, "erosion_iters_tt": 64, "num_cities": 2,
                       "city_size": 24, "city_map": 128, "num_cars": 64, "num_peds": 256,
                       "tower_people": 12},
            "traffic": {"row_tiles": 3, "sweep_rows": 2, "settle_steps": 8,
                        "trace_after": 4, "trace_steps": 16}}
    code = ("import json, torch; torch.set_num_threads(1); "
            "from benchmark import harness as H; "
            "r = H.run_cell('tiled_city.walk', 2**31 + 77, 0.5, True, "
            f"device='cpu', overrides={tiny!r}); print(json.dumps(r))")
    env = {**os.environ, "PYTHONPATH": H.ROOT}
    out = subprocess.run([sys.executable, "-c", code], cwd=H.ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["correct"] and r["failed"] == 0 and r["attempted"] == 20
    assert all(c["value"] == 0 for c in r["checks"].values()), r["checks"]
    got = {k: v["value"] for k, v in r["metrics"].items()}
    assert got["reroute_host_ms.walk"] > 0.0 and got["host_sync_ms.walk"] > 0.0
    assert "city_device_ms.walk" not in got       # no device on the CPU
    assert r["counters"]["city_frames"] == 16 and r["counters"]["probe_fetches"] == 16

"""The port's spans (`w3d_torch.utils.profiler.span`) and the benchmark's
readers of them.  This file imports no jax.

On the CPU: spans record nothing without a live `torch.profiler`
session, record the frame's and the tile call's span tree under one, and
leave every output bit for bit as it was; closed spans reach
`GLOBAL_PROFILER`; each reader of a span metric returns the hand-computed
value on a hand-built trace, and None without program spans or where an
outermost span leaves its mark; a traced run of the harness on a tiny
copy of `spheres_10k` reports the span metrics.  On the card (`gpu`):
the flag is up inside a CUDA-only session, and spans with `device=True`
give positive device times.
"""

import json
import os
import shutil
import subprocess
import sys

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark import harness as H
from w3d_torch.models import physics_model as PM
from w3d_torch.models import terrain_model as TMOD
from w3d_torch.utils import profiler as P
from w3d_torch.utils.constants import WorldConst

from torch_port_util import cuda_device  # noqa: F401

WORLD = WorldConst(mesh_x=32, mesh_y=32, x_scene=4.0, y_scene=4.0, z_scene=4.0)
MCFG = TMOD.TileModelConfig(tile_size=16, erosion_iters_tt=8, erosion_batch=8,
                            erosion_steps=4)
FRAME_TREE = ([("frame", None), ("physics.sort", "frame")]
              + [("physics.substep", "frame"), ("kernel.sample", "physics.substep"),
                 ("kernel.narrow", "physics.substep"), ("kernel.pairs", "physics.substep"),
                 ("physics.substep", "frame"), ("kernel.sample", "physics.substep"),
                 ("kernel.narrow", "physics.substep")] * 2)
TILE_TREE = [("tiles", None), ("tiles.noise", "tiles"), ("tiles.glaciate", "tiles"),
             ("tiles.erode", "tiles"), ("kernel.erosion", "tiles.erode"),
             ("sync.min_zval", "tiles.erode")]


def _world(device="cpu"):
    g = torch.Generator().manual_seed(1)
    pos = torch.rand((64, 3), generator=g) * 4.0 - 2.0
    pos[:, 2] += 3.0
    vel = torch.randn((64, 3), generator=g) * 0.5
    return PM.build_spheres_world(pos.to(device), vel.to(device), world=WORLD,
                                  obj_type="BALL", device=device)


def _frame(w):
    return PM.frame_step(w, substeps=4, world=WORLD, pair_every=2, water=False)


def _tiles(device="cpu"):
    args = TMOD.example_inputs(MCFG, WORLD, torch.Generator(device=device).manual_seed(2),
                               num_tiles=2, device=device)
    return lambda: TMOD.tile_batch_step(*args, MCFG, WORLD)


def _tree(spans):
    return [(s.name, s.parent.name if s.parent else None) for s in spans]


@pytest.fixture
def fresh():
    P.spans(clear=True)
    P.GLOBAL_PROFILER.clear()
    yield
    P.spans(clear=True)
    P.GLOBAL_PROFILER.clear()


def test_no_spans_without_a_profiler(fresh):
    with P.span("outside"):
        pass
    _frame(_world())
    _tiles()()
    assert P.spans() == [] and not P.GLOBAL_PROFILER.entries


@pytest.mark.parametrize("path,tree", [("frame", FRAME_TREE), ("tiles", TILE_TREE)])
def test_span_tree_under_a_profiler(fresh, path, tree):
    call = (lambda: _frame(_world())) if path == "frame" else _tiles()
    with profile(activities=[ProfilerActivity.CPU]):
        call()
    got = P.spans(clear=True)
    assert _tree(got) == tree
    assert all(0 < s.start <= s.end for s in got)
    for s in got:
        if s.parent is not None:
            assert s.parent.start <= s.start and s.end <= s.parent.end
    assert all(s.device_ms is None for s in got)     # no events off the card
    assert P.spans() == []


def test_outputs_bit_equal_traced_and_not(fresh):
    w = _world()
    tiles = _tiles()
    off = (_frame(w).state, tiles())
    with profile(activities=[ProfilerActivity.CPU]):
        on = (_frame(w).state, tiles())
    assert P.spans()
    for a, b in zip(off[0], on[0]):
        assert torch.equal(a, b)
    assert torch.equal(off[1], on[1])


def test_global_profiler_registers_closed_spans(fresh):
    with profile(activities=[ProfilerActivity.CPU]):
        _tiles()()
        with P.span("outer"):
            with P.span("inner"):
                pass
            assert "outer" not in P.GLOBAL_PROFILER.entries    # still open
    e = P.GLOBAL_PROFILER.entries
    assert set(e) == {n for n, _ in TILE_TREE} | {"outer", "inner"}
    assert all(v.count == 1 and v.total >= 0.0 for v in e.values())
    assert e["tiles"].total >= e["tiles.erode"].total >= e["kernel.erosion"].total
    assert "tiles.erode" in P.GLOBAL_PROFILER.report()


# ---------------------------------------------------------------------------
# the readers, on hand-built traces (marks and device ops in us on the
# trace's time base, program spans in ns of the same clock)
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


def _pile_spans():
    """Three frames.  Glue (sort and substeps less their kernel and sync
    children): 700, 440 and 400 us; sync: 10, 0 and 100 us.  Before them,
    a frame outside every mark."""
    out = [_span("frame", None, 100, 900)]
    f = _span("frame", None, 1010, 1990)
    s1 = _span("physics.substep", f, 1100, 1500)
    s2 = _span("physics.substep", f, 1500, 1900)
    out += [f, _span("physics.sort", f, 1020, 1100), s1,
            _span("kernel.sample", s1, 1200, 1250), _span("kernel.pairs", s1, 1300, 1320),
            _span("sync.wait", s1, 1400, 1410), s2, _span("kernel.narrow", s2, 1600, 1700)]
    f = _span("frame", None, 3010, 3500)
    out += [f, _span("physics.sort", f, 3020, 3060), _span("physics.substep", f, 3060, 3460)]
    f = _span("frame", None, 5010, 5800)
    s = _span("physics.substep", f, 5100, 5600)
    out += [f, s, _span("sync.a", s, 5200, 5260), _span("sync.b", s, 5300, 5340)]
    return out


def _graph_spans(replayed=(True, True, True)):
    """Three frames, each replayed from a graph (a `physics.graph` child)
    or run eager; before them, a replayed frame outside every mark."""
    out = [_span("frame", None, 100, 900)]
    out.append(_span("physics.graph", out[0], 110, 890))
    for k, graph in enumerate(replayed):
        a = 1010 + 2000 * k
        f = _span("frame", None, a, a + 600)
        kid = (_span("physics.graph", f, a + 10, a + 590) if graph
               else _span("physics.substep", f, a + 10, a + 590))
        out += [f, kid]
    return out


def _tile_spans():
    """Two calls: noise 1.5 and 2.5 ms of device time, erosion 9.0 and
    10.0 ms, sync 90 and 100 us."""
    out = []
    for (a, b), (nz, er), (sa, sb) in zip(((1010, 1900), (3010, 3900)),
                                          ((1.5, 9.0), (2.5, 10.0)),
                                          ((1800, 1890), (3700, 3800))):
        t = _span("tiles", None, a, b)
        e = _span("tiles.erode", t, a + 400, b - 5, er)
        out += [t, _span("tiles.noise", t, a + 10, a + 200, nz),
                _span("tiles.glaciate", t, a + 200, a + 400, 0.25), e,
                _span("kernel.erosion", e, a + 410, sa), _span("sync.min_zval", e, sa, sb)]
    return out


def _run(n_calls, ops=(), shift=0.0):
    marks = []
    for k in range(n_calls):
        a = 1000.0 + 2000.0 * k + shift
        marks += [("bench.call", a, a + 1000.0), ("bench.read", a + 1000.0, a + 1010.0)]
    tr = H.Trace(device_ops=list(ops), kernels=list(ops), spans=marks,
                 window=(marks[0][1], 6000.0 + shift), steps=n_calls)
    return H.Run(setup_s=1.0, steps=[(0.0, 0.5, 1.0)] * n_calls, items_per_step=1,
                 trace=tr, work={})


# device ops: 60 + 100 + 3,400 us busy in a 5,000 us window, so 1,440 us
# idle; the glue's own time is idle for 40+50+50+80+90+100+200 = 610 us
PILE_OPS = [("k", 1000.0, 1060.0), ("k", 1150.0, 1250.0), ("k", 2500.0, 5900.0)]
CASES = [
    ("glue_host_ms.pile", _pile_spans, 3, 0.44),
    ("glue_idle_share.pile", _pile_spans, 3, 100.0 * 610.0 / 1440.0),
    ("host_sync_ms.pile", _pile_spans, 3, 0.01),
    ("host_sync_ms.batch", _tile_spans, 2, 0.095),
    ("noise_device_ms.batch", _tile_spans, 2, 2.0),
    ("erosion_device_ms.batch", _tile_spans, 2, 9.5),
    ("graph_replay_share.pile", _graph_spans, 3, 100.0),
    ("graph_replay_share.pile", lambda: _graph_spans((True, False, True)), 3, 200.0 / 3.0),
    ("graph_replay_share.pile", _pile_spans, 3, 0.0),
]


def _reader(name):
    return H.load_file_module(H.reader_path(H.BENCH_DIR, name),
                              "test_reader_" + name.replace(".", "_"))


@pytest.mark.parametrize("name,make,n,want", CASES)
def test_reader_on_a_hand_built_trace(monkeypatch, name, make, n, want):
    monkeypatch.setattr(P, "_SPANS", make())
    got = _reader(name).read(_run(n, PILE_OPS))
    assert got == pytest.approx(want, rel=1e-9)


@pytest.mark.parametrize("name,make,n,want", CASES)
def test_reader_with_marks_moved_by_the_trace(monkeypatch, name, make, n, want):
    """Marks that `_trace_of` moved by more than a second: each call is
    placed at its mark's start (the device ops move with the marks)."""
    monkeypatch.setattr(P, "_SPANS", make())
    shift = 5.0e6
    ops = [(k, a + shift - 10.0, b + shift - 10.0) for k, a, b in PILE_OPS]
    got = _reader(name).read(_run(n, ops, shift))
    if name.startswith("glue_idle"):
        assert got is not None and 0.0 < got < 100.0
    else:
        assert got == pytest.approx(want, rel=1e-9)


@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_reader_none_without_program_spans(monkeypatch, name):
    monkeypatch.setattr(P, "_SPANS", [])
    assert _reader(name).read(_run(3, PILE_OPS)) is None


@pytest.mark.parametrize("name,make,n,_", CASES)
def test_reader_none_where_an_outermost_span_leaves_its_mark(monkeypatch, name, make, n, _):
    spans = make()
    outer = [s for s in spans if s.parent is None][-1]
    outer.end = int(outer.start + 1.2e6)     # past its mark's end
    monkeypatch.setattr(P, "_SPANS", spans)
    assert _reader(name).read(_run(n, PILE_OPS)) is None


def test_harness_reports_span_metrics_on_a_tiny_pile(tmp_path):
    """The harness's traced run of a tiny copy of `spheres_10k` on the CPU
    reports the span metrics; the frame's glue lies inside its enqueue.
    A process of its own: the harness refuses to run beside JAX, which
    this test session has loaded."""
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(H.ROOT, "benchmark"), root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    cfg = H.read_json(os.path.join(H.ROOT, "benchmark/configs/spheres_10k.json"))
    cfg.update(name="spheres_tiny", num_objects=200)
    (root / "benchmark/configs/spheres_tiny.json").write_text(json.dumps(cfg))
    (root / "benchmark/traffic/drop.json").write_text(json.dumps(
        {"settle_steps": 1, "check_from": 2, "check_sample": 1,
         "trace_after": 2, "trace_steps": 2}))
    m = H.read_json(os.path.join(H.ROOT, "BENCHMARK.json"))
    m["configs"].append({"name": "spheres_tiny", "source": "https://example.org/tiny",
                         "file": "benchmark/configs/spheres_tiny.json", "reduced": [],
                         "why": "a tiny pile"})
    m["workloads"].append({"name": "spheres_tiny.drop", "config": "spheres_tiny",
                           "traffic": "drop", "chips": 1, "why": "a tiny pile"})
    for e in m["end_to_end"] + m["per_layer"]:
        if "spheres_10k.pile" in e.get("workloads", []):
            e["workloads"].append("spheres_tiny.drop")
    (root / "BENCHMARK.json").write_text(json.dumps(m))
    code = ("import json, sys; from benchmark import harness as H; "
            "r = H.run_cell('spheres_tiny.drop', 3, 0.2, True, device='cpu', "
            f"root={str(root)!r}, bench_dir={str(root / 'benchmark')!r}); "
            "print(json.dumps(r))")
    env = {**os.environ, "PYTHONPATH": H.ROOT}
    out = subprocess.run([sys.executable, "-c", code], cwd=H.ROOT, env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    got = {k: v["value"] for k, v in r["metrics"].items()}
    assert r["correct"]
    assert {"glue_host_ms.pile", "host_sync_ms.pile", "host_enqueue_ms.pile"} <= set(got)
    assert 0.0 < got["glue_host_ms.pile"] < got["host_enqueue_ms.pile"]
    assert got["host_sync_ms.pile"] == 0.0
    assert "glue_idle_share.pile" not in got        # no device on the CPU


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.mark.gpu
def test_flag_is_up_in_a_cuda_only_session(cuda_device, fresh):
    with profile(activities=[ProfilerActivity.CUDA]):
        with P.span("probe"):
            pass
    assert _tree(P.spans()) == [("probe", None)]


@pytest.mark.gpu
def test_device_spans_time_the_card(cuda_device, fresh):
    call = _tiles(cuda_device)
    call()
    with profile(activities=[ProfilerActivity.CUDA]):
        z = call()
    torch.cuda.synchronize()
    got = P.spans()
    assert _tree(got) == TILE_TREE and z.is_cuda
    dev = {s.name: s.device_ms for s in got if s.device}
    assert set(dev) == {"tiles.noise", "tiles.glaciate", "tiles.erode"}
    assert all(v > 0.0 for v in dev.values())

"""The live tiled-terrain frame (`models/world.TiledWorld` with a tile
budget, `terrain/tiles.TileManager`, `height_at`) against the plain
reference of the benchmark's `inf_terrain_128` configuration
(`benchmark/reference/inf_terrain.py`), on the CPU at tile 16 with 64
droplets (one lockstep batch of 256, 96 steps) and the AO halo of 36.
This file imports no jax.

The port equals the reference bit for bit: the resident keys after every
frame of a 40-frame camera path, every tile made (heights, AO, shadow
mask, biome weights) and the height read under the camera; the shadow
scan and AO alone for every kind of sun and on random contexts.  A
budgeted `TiledWorld.step` makes what `TileManager.update` makes under the
same budget.  `gen_tile_batch`, built from its five phase functions,
equals the body it replaced, with and without erosion.  A traced frame
that makes tiles records the span tree
`frame` > `tiles.update` > `tiles.generate` > the five phases; the
stream's readers read their spans (the share of replayed batches too), and
nothing where no frame made tiles;
a traced run of the cell through the harness at a tiny size reports them.
The stream's sine arguments stay within those of the batch cell, and the
reference loads nothing of the port.
"""

import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark import harness as H
from benchmark.reference import inf_terrain as RI
from w3d_torch.models import world as W
from w3d_torch.ops import ao as AO
from w3d_torch.ops import shadows as SH
from w3d_torch.terrain import mesh as TM
from w3d_torch.terrain import tiles as TL
from w3d_torch.utils import profiler as P
from w3d_torch.utils.constants import WorldConst

from torch_port_util import one_torch_thread  # noqa: F401

CFG = {**H.read_json(os.path.join(H.ROOT, "benchmark/configs/inf_terrain_128.json")),
       "tile_size": 16, "erosion_iters_tt": 64}
FRAMES = 40
TINY = {"config": {"tile_size": 16, "erosion_iters_tt": 64},
        "traffic": {"row_tiles": 3, "sweep_rows": 2, "check_from": 16, "check_sample": 2,
                    "trace_after": 4, "trace_steps": 16}}
PHASES = ["tiles.context", "tiles.erode", "tiles.ao", "tiles.shadows", "tiles.biomes"]


def _world_const():
    return WorldConst(mesh_x=CFG["mesh_x"], mesh_y=CFG["mesh_y"], x_scene=CFG["x_scene"],
                      y_scene=CFG["y_scene"], z_scene=CFG["z_scene"])


def _angles():
    g = torch.Generator().manual_seed(11)
    nb = -(-CFG["erosion_iters_tt"] // CFG["erosion_batch"])
    return torch.rand((nb, CFG["erosion_steps"], CFG["erosion_batch"]),
                      generator=g) * (2.0 * math.pi)


def _manager(angles):
    tcfg = TM.TerrainConfig(mesh_seed=CFG["mesh_seed"], glaciate=CFG["glaciate"],
                            glaciate_exp=CFG["glaciate_exp"],
                            mesh_freq_filter=CFG["mesh_freq_filter"])
    tm = TL.TileManager(cfg=tcfg, world=_world_const(), tile_size=CFG["tile_size"],
                        erosion_iters_tt=CFG["erosion_iters_tt"],
                        sun_dir=tuple(CFG["sun_dir"]), device="cpu", angles=angles)
    tm.set_height_range(CFG["zmax_est"], CFG["water_plane_z"])
    return tm


def _cams(n=FRAMES):
    """1/8 tile a frame: 24 frames along +x, then along +y."""
    tw = CFG["tile_size"] * 2.0 * CFG["x_scene"] / CFG["mesh_x"]
    out = []
    for i in range(n):
        u, v = min(i, 24) / 8, max(i - 24, 0) / 8
        out.append(((0.5 + u) * tw - 3.0 * tw, (0.5 + v) * tw + 2.0 * tw))
    return out


def _fly(step, cams, mgr):
    """Each frame: step, the resident keys, the batch made, and the height
    read once the camera's tile is resident."""
    out = []
    for x, y in cams:
        created, deleted = step(x, y)
        key = RI.camera_tile(CFG, x, y)
        h = mgr.height_at(x, y) if key in mgr.tiles else None
        out.append((frozenset(mgr.tiles), list(created), list(deleted), h))
    return out


@pytest.fixture(scope="module")
def flown():
    """The port's 40 frames through `TiledWorld` with the budget 8."""
    angles = _angles()
    tm = _manager(angles)
    tw = W.TiledWorld(tile_mgr=tm, tile_budget=CFG["tile_budget"])
    frames = _fly(lambda x, y: tw.step(x, y), _cams(), tm)
    return tm, frames, angles


def test_resident_keys_and_batches_equal_the_reference(flown):
    tm, frames, _ = flown
    expect = RI.bookkeeping(CFG, _cams())
    assert [f[0] for f in frames] == [e[0] for e in expect]
    assert [f[1] for f in frames] == [e[1] for e in expect]
    made = [k for f in frames for k in f[1]]
    assert len(made) == len(set(made)) == 9 + 3 * 5     # the fill, then 5 edges
    assert tm.counts == {"created": len(made), "deleted": sum(len(f[2]) for f in frames),
                         "deferred": 1, "batches": 7, "resident": len(frames[-1][0]),
                         "graph_captures": 0, "graph_replays": 0, "graph_eager": 7,
                         "graph_failed": 0}


def test_tiles_equal_the_reference(flown):
    tm, frames, angles = flown
    keys = sorted(frames[-1][0])
    ref = RI.Tiles(CFG, "cpu", angles)(keys)
    got = {"zvals": torch.stack([tm.tiles[k].zvals for k in keys]),
           "ao": torch.stack([tm.tiles[k].ao for k in keys]),
           "shadow": torch.stack([tm.tiles[k].smask_sun for k in keys]),
           "weights": torch.stack([tm.tiles[k].weights for k in keys])}
    for f, v in got.items():
        assert torch.equal(v, ref[f]), f
    r = RI.tile_readings(got, ref)
    assert all(v == 0.0 for v in r.values()), r
    assert bool(ref["shadow"].any()) and float(ref["ao"].min()) < 1.0


def test_height_reads_equal_the_reference(flown):
    tm, frames, angles = flown
    reads = [(c, f[3]) for c, f in zip(_cams(), frames) if f[3] is not None]
    assert len(reads) >= FRAMES - 3
    keys = sorted({RI.camera_tile(CFG, *c) for c, _ in reads})
    ref = dict(zip(keys, RI.Tiles(CFG, "cpu", angles)(keys)["zvals"]))
    for (x, y), h in reads:
        key = RI.camera_tile(CFG, x, y)
        assert h.shape == () and torch.equal(h, RI.height(ref[key], key, x, y, CFG))


@pytest.mark.parametrize("frac", [(0.0, 0.0), (0.3, 0.7), (0.99, 0.5), (0.5, 0.999)])
def test_height_at_is_the_bilinear_read(flown, frac):
    """Inside a cell, and in the tile's last column and row, which read
    flat as the ground mesh's sample reads its border."""
    tm, frames, _ = flown
    key = sorted(frames[-1][0])[0]
    n = CFG["tile_size"]
    d = 2.0 * CFG["x_scene"] / CFG["mesh_x"]
    x, y = (key[0] + frac[0]) * n * d, (key[1] + frac[1]) * n * d
    zv = tm.tiles[key].zvals.double()
    gx, gy = frac[0] * n, frac[1] * n
    x0, y0 = min(int(gx), n - 2), min(int(gy), n - 2)
    fx, fy = min(gx - x0, 1.0), min(gy - y0, 1.0)
    want = ((zv[y0, x0] * (1 - fy) + zv[y0 + 1, x0] * fy) * (1 - fx)
            + (zv[y0, x0 + 1] * (1 - fy) + zv[y0 + 1, x0 + 1] * fy) * fx)
    got = tm.height_at(x, y)
    assert abs(float(got) - float(want)) < 1e-5
    assert torch.equal(got, RI.height(tm.tiles[key].zvals, key, x, y, CFG))


def test_height_at_needs_a_resident_tile(flown):
    tm, _, _ = flown
    with pytest.raises(KeyError):
        tm.height_at(1.0e4, 1.0e4)


@pytest.mark.parametrize("budget", [3, 8])
def test_budgeted_step_is_the_budgeted_update(budget):
    """`TiledWorld(tile_budget=b).step` and `TileManager.update(...,
    max_tiles_per_frame=b)` make the same keys and tiles frame by frame."""
    cams = _cams(14)
    a, b = _manager(_angles()), _manager(_angles())
    tw = W.TiledWorld(tile_mgr=a, tile_budget=budget)
    fa = _fly(lambda x, y: tw.step(x, y), cams, a)
    fb = _fly(lambda x, y: b.update(x, y, max_tiles_per_frame=budget), cams, b)
    assert [f[:3] for f in fa] == [f[:3] for f in fb]
    for k in a.tiles:
        for f in ("zvals", "ao", "smask_sun", "weights"):
            assert torch.equal(getattr(a.tiles[k], f), getattr(b.tiles[k], f))


def _gen_tile_batch_before(table, txs, tys, zmax_est, wpz, cfg, world, tile_size,
                           erosion_iters, sun_dir, angles=None):
    """`tiles.gen_tile_batch` as it was written before its phases were
    functions, op for op."""
    from w3d_torch.terrain import biomes as B
    stride = tile_size
    halo = AO.AO_RAY_LEN
    inner = (slice(None), slice(halo, halo + stride), slice(halo, halo + stride))
    ctx = TL.tile_context(table, txs, tys, zmax_est, cfg, world, tile_size)
    zv = ctx[inner]
    if erosion_iters > 0:
        zv = TL.erode_tiles(zv, zmax_est, wpz, cfg, world, erosion_iters, angles)
        ctx = ctx.clone()
        ctx[inner] = zv
    ao = AO.tile_ao(ctx, stride, dz=0.5 * world.half_dxy)
    smask, _ = SH.mesh_shadows(zv, sun_dir, cell_w=world.dx)
    s = slice(halo, halo + stride)
    dzdx = (ctx[:, s, halo + 1:halo + stride + 1]
            - ctx[:, s, halo - 1:halo + stride - 1]) * (0.5 * world.dx_inv)
    dzdy = (ctx[:, halo + 1:halo + stride + 1, s]
            - ctx[:, halo - 1:halo + stride - 1, s]) * (0.5 * world.dy_inv)
    norm_z = torch.rsqrt(dzdx ** 2 + dzdy ** 2 + 1.0)
    weights = B.biome_weights(zv, norm_z, -zmax_est, zmax_est, cfg)
    return zv, ao, smask, weights


@pytest.mark.parametrize("erosion_iters", [64, 0], ids=["eroded", "no erosion"])
def test_phases_make_the_batch_as_before(erosion_iters):
    """`gen_tile_batch`, now its five phase functions in order, equals the
    body it replaced exactly, with and without erosion; without erosion
    the erosion phase is left out."""
    tm = _manager(_angles())
    txs = torch.tensor([-3.0, 0.0, 2.0, 5.0])
    tys = torch.tensor([1.0, -2.0, 4.0, 0.0])
    args = (tm.table, txs, tys, tm._zmax_t, tm._wpz_t, tm.cfg, tm.world, tm.tile_size,
            erosion_iters, tm.sun_dir)
    got = TL.gen_tile_batch(*args, angles=tm.angles)
    want = _gen_tile_batch_before(*args, angles=tm.angles)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    spec = TL.BatchSpec(tm.table, tm.cfg, tm.world, tm.tile_size, erosion_iters,
                        tm.sun_dir, tm.angles)
    names = [n for n, _ in TL.phases(spec)]
    assert names == (PHASES if erosion_iters else PHASES[:1] + PHASES[2:])


SUNS = [(0.4, 0.3, 0.8), (-0.4, 0.3, 0.8), (0.2, -0.5, 0.6), (0.1, 0.7, 0.5),
        (0.5, 0.0, 0.4), (0.0, 0.0, 1.0)]


@pytest.mark.parametrize("sun", SUNS)
def test_shadow_scan_equals_the_reference(sun):
    g = torch.Generator().manual_seed(3)
    z = torch.cumsum(torch.randn((2, 24, 24), generator=g), -1) * 0.05
    got, _ = SH.mesh_shadows(z, sun, cell_w=0.0625)
    want = RI.sun_shadows(z, sun, 0.0625)
    assert torch.equal(got, want)
    assert bool(want.any()) == (sun[:2] != (0.0, 0.0))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ao_equals_the_reference(seed):
    g = torch.Generator().manual_seed(seed)
    n, h = 8, AO.AO_RAY_LEN
    ctx = torch.randn((2, n + 2 * h, n + 2 * h), generator=g) * 0.05
    want = RI.obscurance(ctx, n, h, 0.03125, AO.NUM_AO_STEPS)
    assert torch.equal(AO.tile_ao(ctx, n, dz=0.03125), want)
    assert float(want.min()) < 1.0 < float(want.max()) + 1e-9


def test_the_reference_loads_nothing_of_the_port():
    """A process of its own: this test session has loaded the port."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    code = ("import sys, benchmark.reference.inf_terrain; "
            "print(','.join(sorted({n.split('.')[0] for n in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], cwd=H.ROOT, env=env,
                         capture_output=True, text=True, timeout=300, check=True)
    mods = set(out.stdout.strip().splitlines()[-1].split(","))
    assert "torch" in mods and not mods & (set(H.FORBIDDEN) | {"w3d_torch"})


def test_derived_height_range_is_the_configuration_s():
    tm = TL.TileManager(cfg=TM.TerrainConfig(mesh_seed=0), world=_world_const(),
                        tile_size=16, device="cpu")
    assert np.float32(tm.zmax_est) == np.float32(CFG["zmax_est"])
    assert np.float32(tm.water_plane_z) == np.float32(CFG["water_plane_z"])


def test_stream_sine_arguments_stay_within_the_batch_cell_s():
    """The largest |argument| of a sine over every context the stream can
    make (a sweep from any corner the seed draws, with the AO halo) is
    below the batch cell's over its region, and below CUDA's fast-path
    bound for `sinf` (105,615)."""
    cfg = H.read_json(os.path.join(H.ROOT, "benchmark/configs/inf_terrain_128.json"))
    st = H.read_json(os.path.join(H.ROOT, "benchmark/traffic/stream.json"))
    bt = H.read_json(os.path.join(H.ROOT, "benchmark/traffic/batch4096.json"))
    world = WorldConst(mesh_x=cfg["mesh_x"], mesh_y=cfg["mesh_y"], x_scene=cfg["x_scene"],
                       y_scene=cfg["y_scene"], z_scene=cfg["z_scene"])
    table = TM.gen_table_for(TM.TerrainConfig(mesh_seed=cfg["mesh_seed"]), world, device="cpu")
    n, halo, j = cfg["tile_size"], cfg["ao_halo"], st["region_jitter_tiles"]
    assert j == bt["region_jitter_tiles"]

    def most(freq, phase, lo, hi):
        """The largest |freq X + freq / 2 + phase| over cells X in [lo, hi]."""
        f, c = freq.double(), 0.5 * freq.double() + phase.double()
        return float(torch.maximum((f * lo + c).abs(), (f * hi + c).abs()).max())

    # the stream, in cells: a row of tiles +-1 along x, the sweep's rows +-1
    # along y, each with the halo
    s_lo = (-j - 1) * n - halo
    s_hi_x = (j - 1 + st["row_tiles"] + 2) * n + halo
    s_hi_y = (j - 1 + st["row_gap_tiles"] * (st["sweep_rows"] - 1) + 2) * n + halo
    # the batch: the region's corner, its blocks and the golden shift (< 1 cell)
    side = bt["block_tiles"] * bt["region_blocks"]
    b_lo, b_hi = -bt["region_jitter_tiles"] * n, (bt["region_jitter_tiles"] + side) * n
    stream = max(most(table.freq_x, table.phase_x, s_lo, s_hi_x),
                 most(table.freq_y, table.phase_y, s_lo, s_hi_y))
    batch = max(most(table.freq_x, table.phase_x, b_lo, b_hi),
                most(table.freq_y, table.phase_y, b_lo, b_hi))
    assert stream < batch < 105615.0, (stream, batch)


# ---------------------------------------------------------------------------
# spans and their readers
# ---------------------------------------------------------------------------

def _tree(spans):
    return [(s.name, s.parent.name if s.parent else None) for s in spans]


def test_a_traced_creation_frame_records_its_phases():
    tm = _manager(_angles())
    tw = W.TiledWorld(tile_mgr=tm, tile_budget=CFG["tile_budget"])
    P.spans(clear=True)
    with profile(activities=[ProfilerActivity.CPU]):
        tw.step(*_cams(1)[0])
    got = _tree(P.spans(clear=True))
    assert got == ([("frame", None), ("tiles.update", "frame"),
                    ("tiles.generate", "tiles.update"), ("tiles.context", "tiles.generate"),
                    ("tiles.erode", "tiles.generate"), ("kernel.erosion", "tiles.erode"),
                    ("sync.min_zval", "tiles.erode")]
                   + [(p, "tiles.generate") for p in PHASES[2:]])
    with profile(activities=[ProfilerActivity.CPU]):
        tw.step(*_cams(1)[0])
        tw.step(*_cams(1)[0])
    got = _tree(P.spans(clear=True))
    assert got.count(("tiles.generate", "tiles.update")) == 1     # the 9th tile, then none
    assert got[-2:] == [("frame", None), ("tiles.update", "frame")]


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


def _stream_spans(make=(False, True, False, True)):
    """Four frames, the 2nd and 4th making tiles: `tiles.generate` 600 and
    800 us of host time, shadows 5 and 7 ms of device time, AO 2 and 3."""
    out = []
    gen = iter([(600, 5.0, 2.0), (800, 7.0, 3.0)])
    for k, makes in enumerate(make):
        a = 1010.0 + 2000.0 * k
        f = _span("frame", None, a, a + 950)
        u = _span("tiles.update", f, a + 10, a + 940)
        out += [f, u]
        if makes:
            host, sh, ao = next(gen)
            g = _span("tiles.generate", u, a + 100, a + 100 + host)
            out += [g, _span("tiles.context", g, a + 110, a + 200, 0.5),
                    _span("tiles.ao", g, a + 300, a + 400, ao),
                    _span("tiles.shadows", g, a + 400, a + 600, sh),
                    _span("tiles.biomes", g, a + 600, a + 650, 0.25)]
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


READS = [("tile_gen_host_ms.stream", 0.7), ("shadow_device_ms.stream", 6.0),
         ("ao_device_ms.stream", 2.5)]


@pytest.mark.parametrize("name,want", READS)
def test_stream_reader_on_a_hand_built_trace(monkeypatch, name, want):
    monkeypatch.setattr(P, "_SPANS", _stream_spans())
    assert _reader(name).read(_run(4)) == pytest.approx(want, rel=1e-9)


@pytest.mark.parametrize("name", [r[0] for r in READS])
def test_stream_reader_none_where_no_frame_made_tiles(monkeypatch, name):
    monkeypatch.setattr(P, "_SPANS", _stream_spans((False,) * 4))
    assert _reader(name).read(_run(4)) is None
    monkeypatch.setattr(P, "_SPANS", [])
    assert _reader(name).read(_run(4)) is None


def test_tile_graph_share_reader(monkeypatch):
    """Of the two traced frames that make tiles, the second replays its
    batch (`tiles.graph` inside its `tiles.generate`): 50%; none where no
    frame made tiles."""
    spans = _stream_spans()
    gens = [s for s in spans if s.name == "tiles.generate"]
    a = gens[1].start * 1e-3
    spans.append(_span("tiles.graph", gens[1], a + 5, a + 700))
    monkeypatch.setattr(P, "_SPANS", spans)
    assert _reader("tile_graph_share.stream").read(_run(4)) == pytest.approx(50.0)
    monkeypatch.setattr(P, "_SPANS", _stream_spans((False,) * 4))
    assert _reader("tile_graph_share.stream").read(_run(4)) is None


def test_harness_runs_the_stream_cell_traced():
    """The harness's traced run of the cell at tile 16 on the CPU: correct,
    with the frame metrics, the host time of the creation and the
    manager's counters.  A process of its own: the harness refuses to run
    beside JAX, which this test session has loaded."""
    code = ("import json, torch; torch.set_num_threads(1); "
            "from benchmark import harness as H; "
            "r = H.run_cell('tiled_terrain_128.stream', 2**31 + 77, 0.5, True, "
            f"device='cpu', overrides={TINY!r}); print(json.dumps(r))")
    env = {**os.environ, "PYTHONPATH": H.ROOT}
    out = subprocess.run([sys.executable, "-c", code], cwd=H.ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["correct"] and r["failed"] == 0 and r["attempted"] == 20
    assert all(c["value"] == 0.0 for c in r["checks"].values()), r["checks"]
    got = {k: v["value"] for k, v in r["metrics"].items()}
    assert got["tile_gen_host_ms.stream"] > 0.0
    assert "shadow_device_ms.stream" not in got       # no device on the CPU
    assert got["tile_graph_share.stream"] == 0.0       # the CPU's batches run eager
    assert r["counters"]["graph_eager"] == 2 and r["counters"]["graph_replays"] == 0
    assert r["counters"]["batches"] == 2 and r["counters"]["created"] == 6

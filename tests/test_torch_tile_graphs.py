"""CUDA graphs of the tile batch (`w3d_torch/terrain/tile_graphs`).  This
file imports no jax.

On the CPU: the key changes with what a capture bakes in (the batch size,
the sun, the tile size, the erosion, the sine table and the angles by
identity and by in-place edits) and not with the batch's origins or
height range; a CPU manager never captures, and its tiles are the eager
batch's exactly.  The capture policy, through the tile batch's wiring as
through the frame's, is tested in `test_torch_cuda_graphs`.  On the card (`gpu`): the manager's replayed batches are
`gen_tile_batch`'s eager batches bit for bit, over batches at other
origins, after a new height range and for a deferred batch adopted on
the next update; no two batches' outputs alias each other or the graphs'
buffers; kernel A's launch count rises by an eager batch's; a profiled
replay records its spans with device times.
"""

import types

import pytest
import torch

from w3d_torch.ops.cuda import erosion_kernel as EK
from w3d_torch.terrain import mesh as TM
from w3d_torch.terrain import tile_graphs as TG
from w3d_torch.terrain import tiles as TL
from w3d_torch.utils import profiler as P
from w3d_torch.utils.constants import WorldConst

from torch_port_util import cuda_device, one_torch_thread  # noqa: F401

WORLD = WorldConst(mesh_x=128, mesh_y=128, x_scene=4.0, y_scene=4.0, z_scene=4.0)
CFG = TM.TerrainConfig(mesh_seed=0, glaciate=True, glaciate_exp=3.0, mesh_freq_filter=2)
PHASES = ["tiles.context", "tiles.erode", "tiles.ao", "tiles.shadows", "tiles.biomes"]
OUTS = ("zvals", "ao", "smask_sun", "weights")


def _manager(device="cpu", tile_size=16, iters=64):
    return TL.TileManager(cfg=CFG, world=WORLD, tile_size=tile_size,
                          erosion_iters_tt=iters, device=device)


def _spec(tm, **change):
    s = TL.BatchSpec(tm.table, tm.cfg, tm.world, tm.tile_size, tm.erosion_iters_tt,
                     tm.sun_dir, tm.angles)
    return s._replace(**change)


def _card_txs(n=8):
    """What `batch_key` reads of a batch's origins on a card."""
    return types.SimpleNamespace(device=torch.device("cuda", 0), shape=(n,))


@pytest.fixture(scope="module")
def tm():
    return _manager()


@pytest.mark.parametrize("change", [
    lambda tm: (_spec(tm), _card_txs(16)),
    lambda tm: (_spec(tm, sun_dir=(-0.4, 0.3, 0.8)), _card_txs()),
    lambda tm: (_spec(tm, tile_size=32), _card_txs()),
    lambda tm: (_spec(tm, erosion_iters=0), _card_txs()),
    lambda tm: (_spec(tm, cfg=tm.cfg._replace(mesh_seed=1)), _card_txs()),
    lambda tm: (_spec(tm, world=WorldConst(mesh_x=64, mesh_y=64)), _card_txs()),
    lambda tm: (_spec(tm, table=tm.table._replace()), _card_txs()),
    lambda tm: (_spec(tm, angles=tm.angles.clone()), _card_txs()),
    lambda tm: (tm.table.mag.add_(0.0), (_spec(tm), _card_txs()))[1],
    lambda tm: (tm.angles.mul_(1.0), (_spec(tm), _card_txs()))[1],
], ids=["batch size", "sun", "tile size", "erosion", "terrain config", "world",
        "new table", "new angles", "table edited", "angles edited"])
def test_key_changes_with_what_a_capture_bakes_in(change):
    tm = _manager()
    k0 = TG.batch_key(_spec(tm), _card_txs())
    k1 = TG.batch_key(*change(tm))
    assert k1 != k0 and hash(k0) is not None and hash(k1) is not None


def test_key_holds_under_new_origins_and_height_range(tm):
    k0 = TG.batch_key(_spec(tm), _card_txs())
    tm.set_height_range(tm.zmax_est * 1.5, tm.water_plane_z - 1.0)
    assert TG.batch_key(_spec(tm), _card_txs()) == k0
    assert TG.batch_key(_spec(tm, sun_dir=list(tm.sun_dir)), _card_txs()) == k0


def test_no_key_off_a_card(tm):
    assert TG.batch_key(_spec(tm), torch.zeros(8)) is None


def test_a_cpu_manager_never_captures():
    """A manager flown over three tile columns with a budget of 8: every
    batch runs eager, and every tile is the eager batch's exactly."""
    tm = _manager()
    tw = 16 * WORLD.dx
    batches = []
    for i in range(20):
        cam = ((0.5 + i / 8) * tw, 0.5 * tw)
        pending = tm._pending
        tm.update(*cam, max_tiles_per_frame=8)
        if tm._pending is not None and tm._pending is not pending:
            batches.append(list(tm._pending[0]))
    tm.flush()
    assert len(batches) >= 3 and tm.counts["batches"] == len(batches)
    assert tm.counts["graph_eager"] == len(batches)
    assert tm.counts["graph_captures"] == tm.counts["graph_replays"] == 0
    assert tm.counts["graph_failed"] == 0 and not tm.graphs.graphs and tm.graphs.last is None
    for keys in batches:
        pad = -(-len(keys) // 8) * 8
        txs = torch.tensor([k[0] for k in keys] + [keys[-1][0]] * (pad - len(keys)),
                           dtype=torch.float32)
        tys = torch.tensor([k[1] for k in keys] + [keys[-1][1]] * (pad - len(keys)),
                           dtype=torch.float32)
        want = TL.gen_tile_batch(tm.table, txs, tys, tm._zmax_t, tm._wpz_t, tm.cfg,
                                 tm.world, tm.tile_size, tm.erosion_iters_tt, tm.sun_dir,
                                 angles=tm.angles)
        for i, k in enumerate(keys):
            if k in tm.tiles:
                for f, w in zip(OUTS, want):
                    assert torch.equal(getattr(tm.tiles[k], f), w[i]), (k, f)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

def _eager(tm, keys):
    """`gen_tile_batch` eager on the manager's padded batch of `keys`."""
    pad = -(-len(keys) // tm._batch_pad) * tm._batch_pad
    dev = tm._zmax_t.device
    txs = torch.tensor([k[0] for k in keys] + [keys[-1][0]] * (pad - len(keys)),
                       dtype=torch.float32, device=dev)
    tys = torch.tensor([k[1] for k in keys] + [keys[-1][1]] * (pad - len(keys)),
                       dtype=torch.float32, device=dev)
    return TL.gen_tile_batch(tm.table, txs, tys, tm._zmax_t, tm._wpz_t, tm.cfg, tm.world,
                             tm.tile_size, tm.erosion_iters_tt, tm.sun_dir, angles=tm.angles)


def _assert_tiles(tm, keys, want):
    for i, k in enumerate(keys):
        for f, w in zip(OUTS, want):
            assert torch.equal(getattr(tm.tiles[k], f), w[i]), (k, f)


def _batches(n):
    """`n` batches of 3 keys at other origins each."""
    return [[(5 * j - 40, 3 * j - 7 + d) for d in range(3)] for j in range(n)]


@pytest.fixture
def card_tm(cuda_device):
    return _manager(cuda_device, tile_size=128, iters=512)


@pytest.mark.gpu
def test_replayed_batches_are_eager_batches(card_tm):
    tm = card_tm
    outs = []
    for j, keys in enumerate(_batches(6)):
        if j == 4:      # a new height range: no new capture
            tm.set_height_range(tm.zmax_est * 1.25, tm.water_plane_z + 0.5)
        tm._generate(keys)
        outs.append([getattr(tm.tiles[k], f) for k in keys for f in OUTS])
        _assert_tiles(tm, keys, _eager(tm, keys))
    c = tm.counts
    assert (c["graph_eager"], c["graph_captures"], c["graph_replays"], c["graph_failed"]) \
        == (1, 1, 5, 0)
    # a deferred batch, adopted on the next update
    x, y = (0.5 - 30) * 128 * WORLD.dx, (0.5 + 20) * 128 * WORLD.dy
    made, _ = tm.update(x, y, max_tiles_per_frame=8)
    assert len(made) == 8 and tm._pending is not None
    tm.update(x, y, max_tiles_per_frame=8)
    _assert_tiles(tm, made, _eager(tm, made))
    assert tm.counts["graph_replays"] == 7 and tm.counts["graph_captures"] == 1
    # no two batches' outputs alias, nor the graphs' static buffers
    g = next(iter(tm.graphs.graphs.values()))
    ptrs = [t.data_ptr() for b in outs for t in b[::len(OUTS)]]
    ptrs += [tm.tiles[k].zvals.data_ptr() for k in made]
    assert len(set(ptrs)) == len(ptrs)
    static = {t.untyped_storage().data_ptr() for t in g.out}
    held = {t.untyped_storage().data_ptr() for b in outs for t in b}
    assert not static & held


@pytest.mark.gpu
def test_launch_counts_of_replayed_batches(card_tm):
    tm = card_tm
    per = []
    for keys in _batches(4):
        a0 = EK.KERNEL.launches
        tm._generate(keys)
        per.append(EK.KERNEL.launches - a0)
    assert tm.counts["graph_replays"] == 3
    assert per == [2, 2, 2, 2]


@pytest.mark.gpu
def test_profiled_replay_records_its_spans(card_tm):
    tm = card_tm
    for keys in _batches(2):       # eager, then the capture
        tm._generate(keys)
    P.spans(clear=True)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]):
        with P.span("frame"):
            tm._generate(_batches(3)[-1])
        torch.cuda.synchronize()
    spans = P.spans(clear=True)
    got = [(s.name, s.parent.name if s.parent else None) for s in spans]
    assert got == [("frame", None), ("tiles.generate", "frame"),
                   ("tiles.graph", "tiles.generate")] + [(p, "tiles.graph") for p in PHASES]
    for s in spans[3:]:
        assert s.device_ms is not None and s.device_ms > 0.0, s.name

"""The port's one CUDA-graph mechanism (`w3d_torch/ops/cuda/graphs`),
through each caller's wiring: the physics frame (`step_objects` and
`physics/graphs.FRAMES`) and the tile batch (`TileManager._generate` and
its cache).  This file imports no jax and runs on the CPU.

With the capture and the replay stubbed: the rule of two calls in a row.
The LRU bound.  A capture that raises (no CUDA stream on the CPU) leaves
its key eager, keeps its traceback, counts once, and changes no launch
count.  The `Kernel` registry holds the seven kernels of `ops/cuda` and
their variants; with only the CUDA recording stubbed, a capture leaves
a kernel's launch count as it was and each replay adds what it captured.
"""

import types

import pytest
import torch

from w3d_torch.models import physics_model as PM
from w3d_torch.ops.cuda import build
from w3d_torch.ops.cuda import erosion_kernel as EK
from w3d_torch.ops.cuda import graphs as CG
from w3d_torch.ops.cuda import narrow_kernel as NK
from w3d_torch.ops.cuda import noise_kernel as NZK
from w3d_torch.ops.cuda import pairs_kernel as PK
from w3d_torch.ops.cuda import physics_kernel as GK
from w3d_torch.ops.cuda import sample_kernel as SK
from w3d_torch.ops.cuda import stencil_kernel as STK
from w3d_torch.physics import graphs as G
from w3d_torch.physics import step as S
from w3d_torch.terrain import mesh as TM
from w3d_torch.terrain import tile_graphs as TG
from w3d_torch.terrain import tiles as TL
from w3d_torch.utils.constants import WorldConst

from torch_port_util import one_torch_thread  # noqa: F401

PILE = WorldConst(mesh_x=32, mesh_y=32, x_scene=4.0, y_scene=4.0, z_scene=4.0)
TERRAIN = WorldConst(mesh_x=128, mesh_y=128, x_scene=4.0, y_scene=4.0, z_scene=4.0)
CFG = TM.TerrainConfig(mesh_seed=0, glaciate=True, glaciate_exp=3.0, mesh_freq_filter=2)


class Caller:
    """One caller's wiring under a key the test chooses: `call(key)` runs
    one call through it and returns its outputs as a tuple; `cache` is
    the `GraphCache` it goes through."""

    def __init__(self, name, monkeypatch):
        self.name, self.mp = name, monkeypatch
        if name == "frame":
            g = torch.Generator().manual_seed(1)
            pos = torch.rand((64, 3), generator=g) * 4.0 - 2.0
            pos[:, 2] += 3.0
            self.w = PM.build_spheres_world(pos, torch.randn((64, 3), generator=g) * 0.5,
                                            world=PILE, obj_type="BALL", device="cpu")
            self.cache = CG.GraphCache("physics")
            monkeypatch.setattr(G, "FRAMES", self.cache)
            monkeypatch.setattr(G, "capturable", lambda state, env: True)
        else:
            self.tm = TL.TileManager(cfg=CFG, world=TERRAIN, tile_size=16,
                                     erosion_iters_tt=64, device="cpu")
            self.cache = self.tm.graphs

    def call(self, key) -> tuple:
        if self.name == "frame":
            self.mp.setattr(G, "frame_key", lambda *a, **k: key)
            w = self.w
            out = S.step_objects(w.state, w.env, w.cobjs, w.table, substeps=4, world=PILE,
                                 pair_every=2, water=False)
            return (out,) if isinstance(out, str) else tuple(out)
        self.mp.setattr(TG, "batch_key", lambda s, txs: key)
        self.tm._generate([(0, 1), (2, -1)], defer=True)
        return self.tm._pending[1]


@pytest.fixture(params=["frame", "tiles"])
def caller(request, monkeypatch):
    return Caller(request.param, monkeypatch)


def test_two_calls_in_a_row_then_replay(caller, monkeypatch):
    """The capture, the replay and the eager program are stubs."""
    captured = []

    def capture(phases, b, outputs, refs):
        captured.append(len(captured))
        return CG.Graph(phases=[], inputs=[], out=(), launches=(), refs=refs)

    monkeypatch.setattr(CG, "capture", capture)
    monkeypatch.setattr(CG, "replay", lambda g, b: ("replay",))
    monkeypatch.setattr(CG, "eager", lambda phases, b, outputs: ("eager",))
    keys = ["a", "b", "a", "a", "a", "b", "a", "b", "b", "b", None, None]
    got = [caller.call(k)[0] for k in keys]
    assert got == ["eager", "eager", "eager", "replay", "replay", "eager", "replay",
                   "eager", "replay", "replay", "eager", "eager"]
    assert len(captured) == 2 and list(caller.cache.graphs) == ["a", "b"]
    assert caller.cache.counts["graph_captures"] == 2
    assert caller.cache.counts["graph_replays"] == 5
    assert caller.cache.counts["graph_eager"] == 7 and caller.cache.counts["graph_failed"] == 0


def test_lru_bound(caller):
    assert CG.MAX_GRAPHS == 4
    cache = caller.cache
    for k in "abcd":
        cache.keep(k, object())
    assert cache.decide("a") == "replay"        # "a" is now the most recent
    cache.keep("e", object())
    assert list(cache.graphs) == ["c", "d", "a", "e"]
    assert cache.decide("b") == "eager"
    cache.keep("f", object())
    assert len(cache.graphs) == 4 and "c" not in cache.graphs


def test_a_capture_that_raises_leaves_its_key_eager(caller):
    """A CPU call under a card's key: its capture raises (no CUDA stream),
    the call runs eager, the failure is counted once with its traceback,
    and the key never captures again."""
    launches = {k: k.launches for k in build.Kernel.instances}
    outs = [caller.call("k") for _ in range(4)]
    assert {k: caller.cache.counts[k] for k in CG.COUNTS} == \
        {**dict.fromkeys(CG.COUNTS, 0), "graph_eager": 4, "graph_failed": 1}
    assert list(caller.cache.failed) == ["k"] and "Traceback" in caller.cache.failed["k"]
    assert not caller.cache.graphs
    assert {k: k.launches for k in build.Kernel.instances} == launches
    want = caller.call(None)
    for out in outs:
        assert len(out) == len(want) and all(torch.equal(a, b) for a, b in zip(out, want))


def test_kernel_registry_and_replayed_launch_counts(monkeypatch):
    kernels = {m.KERNEL for m in (EK, NK, NZK, PK, GK, SK, STK)}
    assert len(kernels) == 7 and kernels <= set(build.Kernel.instances)
    variant = EK.KERNEL.variant("W3D_EROSION_PHASES")
    assert variant in build.Kernel.instances and variant.launches == 0

    fake = build.Kernel("w3d_fake", [])

    def launch(b):              # a phase that "launches" the fake kernel twice
        fake.launches += 2
        b["y"] = b["x"] + 1.0

    # only the CUDA recording is stubbed: the phases run, graphs are stand-ins
    monkeypatch.setattr(CG, "_record", lambda phases, b: CG.walk(
        phases, lambda fn: (fn(b), types.SimpleNamespace(replay=lambda: None))[1], None))
    b = {"x": torch.arange(3.0)}
    g = CG.capture([("fake", launch)], b, ("y",), None)
    assert fake.launches == 0 and g.launches == ((fake, 2),)
    for i in (1, 2):
        (y,) = CG.replay(g, {"x": torch.zeros(3)})
        assert fake.launches == 2 * i
        assert torch.equal(y, torch.arange(3.0) + 1.0) and y is not g.out[0]

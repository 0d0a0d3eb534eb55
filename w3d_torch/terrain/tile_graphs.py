"""CUDA graphs of a tile batch (`tiles.gen_tile_batch`) for `TileManager`.

On the card a padded batch of new tiles is some 1,750 small launches (the
shadow scan's loop over the tile's columns, AO's compares, the erosion
around kernel A, the biome weights, the context noise), and the host's
dispatch of them, not the card, paces the frame that makes the batch.
`TileGraphs` captures the batch's phases (`tiles.phases`) once, each into
a CUDA graph of its own in one shared memory pool, and replays them in
capture order in place of the launches: the same kernels in the same
order, so the tiles are bit for bit the eager batch's.

What a capture bakes in is the batch's key (`batch_key`): the device, the
padded batch size, the tile size, the terrain configuration, the world,
the erosion's droplet count, the sun, and the sine table and the
erosion's angles by identity and by their tensors' `_version`s (an
in-place edit bumps them).  A key is captured once it is seen on two
calls in a row: the first runs eager and warms up (the kernel library,
the allocator); the second captures on a side stream, then replays.  A
batch size that never repeats stays eager, as does every batch off a
card.  At most `MAX_GRAPHS` keys stay captured (least recently used first
out).  A capture that raises marks its key eager for good and keeps its
traceback (`TileGraphs.failed`).

A replay copies the batch's origins and height range into the graphs'
static inputs, so a new `set_height_range` needs no new capture; replays
each phase inside the phase's span, whose CUDA events then time that
phase on the device; and returns fresh copies of the outputs, so that no
batch, deferred or resident, aliases another or the graphs' buffers.
Kernel A's launch count (`Kernel.launches`) rises by what the capture
launched, as an eager batch's does.  The replays run inside the span
`tiles.graph`, a capture inside `tiles.capture`; a capture opens no span
that records CUDA events.  The manager's `counts` count the batches
captured (`graph_captures`), replayed (`graph_replays`, a capture's own
call included) and run eager (`graph_eager`), and the captures that
raised (`graph_failed`).
"""

from __future__ import annotations

import dataclasses
import traceback
from collections import OrderedDict

import torch

from ..ops.cuda import erosion_kernel as EK
from ..utils.profiler import span
from . import tiles as TL

MAX_GRAPHS = 4
INPUTS = ("txs", "tys", "zmax_est", "wpz")


def _tensors_key(x) -> tuple | None:
    """A tensor, or a tuple of them, by identity and by the versions."""
    if x is None:
        return None
    ts = (x,) if isinstance(x, torch.Tensor) else tuple(x)
    return (id(x), tuple(t._version for t in ts))


def batch_key(s: TL.BatchSpec, txs: torch.Tensor) -> tuple | None:
    """Everything a capture of the batch bakes in, hashable; None for a
    batch off a card, which never captures."""
    if txs.device.type != "cuda":
        return None
    return (txs.device, txs.shape[0], s.tile_size, s.cfg, s.world, s.erosion_iters,
            tuple(s.sun_dir), _tensors_key(s.table), _tensors_key(s.angles))


@dataclasses.dataclass
class Graph:
    """One captured batch: its phases' graphs in capture order with their
    span names, the static inputs and outputs, what it adds to A's launch
    count, and the spec whose tensors it reads."""

    phases: list
    inputs: tuple
    out: tuple
    launches: int
    spec: TL.BatchSpec


def capture(s: TL.BatchSpec, inputs: tuple) -> Graph:
    """Capture the batch's phases on a side stream, each into a CUDA graph
    of one shared memory pool, over static copies of `inputs` (`INPUTS`).
    Runs no kernel of the batch: the first replay computes it."""
    static = tuple(t.clone() for t in inputs)
    b = dict(zip(INPUTS, static))
    dev = static[0].device
    before = EK.KERNEL.launches
    cur = torch.cuda.current_stream(dev)
    side = torch.cuda.Stream(dev)
    side.wait_stream(cur)
    pool = torch.cuda.graph_pool_handle()
    graphs = []
    try:
        with torch.cuda.stream(side):
            for name, phase in TL.phases(s):
                g = torch.cuda.CUDAGraph()
                g.capture_begin(pool=pool)
                try:
                    phase(b, s)
                finally:
                    g.capture_end()
                graphs.append((name, g))
    finally:
        cur.wait_stream(side)
        launches = EK.KERNEL.launches - before
        EK.KERNEL.launches = before      # nothing ran: a replay counts them
    return Graph(phases=graphs, inputs=static, out=tuple(b[k] for k in TL.OUTPUTS),
                 launches=launches, spec=s)


def replay(g: Graph, inputs: tuple) -> tuple:
    """The captured batch on `inputs`: fresh output tensors."""
    torch._foreach_copy_(list(g.inputs), list(inputs))
    for name, graph in g.phases:
        with span(name, device=True):
            graph.replay()
    EK.KERNEL.launches += g.launches
    return tuple(t.clone() for t in g.out)


class TileGraphs:
    """One manager's captured batches by key, and the decision to capture,
    replay or run eager (module docstring)."""

    def __init__(self):
        self.graphs: OrderedDict = OrderedDict()
        self.failed: dict = {}  # key -> the traceback of its capture: eager for good
        self.last = None        # (key, spec) of the previous call

    def decide(self, key) -> str:
        """"replay", "capture" or "eager" for a call with `key`, after the
        call before it (`last`): the rule of two calls in a row."""
        if key is not None and key in self.graphs:
            self.graphs.move_to_end(key)
            return "replay"
        repeat = key is not None and self.last is not None and self.last[0] == key
        if not repeat or key in self.failed:
            return "eager"
        return "capture"

    def keep(self, key, g: Graph) -> None:
        """Keep `g` under `key`; drop the least recently used past the
        bound."""
        self.graphs[key] = g
        while len(self.graphs) > MAX_GRAPHS:
            self.graphs.popitem(last=False)

    def run(self, s: TL.BatchSpec, txs, tys, zmax_est, wpz, counts: dict) -> tuple:
        """`tiles.gen_tile_batch` of the batch, replayed from graphs where
        its key allows; counts how it ran in `counts`."""
        key = batch_key(s, txs)
        how = self.decide(key)
        self.last = None if key is None else (key, s)
        inputs = (txs, tys, zmax_est, wpz)
        if how == "capture":
            try:
                with span("tiles.capture"):
                    g = capture(s, inputs)
            except Exception:       # noqa: BLE001 - any failure: eager for good
                self.failed[key] = traceback.format_exc()
                counts["graph_failed"] += 1
                how = "eager"
            else:
                counts["graph_captures"] += 1
                self.keep(key, g)
        if how == "eager":
            counts["graph_eager"] += 1
            return TL.gen_tile_batch(s.table, txs, tys, zmax_est, wpz, s.cfg, s.world,
                                     s.tile_size, s.erosion_iters, s.sun_dir,
                                     angles=s.angles)
        counts["graph_replays"] += 1
        with span("tiles.graph"):
            return replay(self.graphs[key], inputs)

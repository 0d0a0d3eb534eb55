"""CUDA graphs of the port's hot paths: the one capture, replay and
launch-count mechanism of the physics frame (`physics/graphs`), the
tile batch (`terrain/tile_graphs`), the chained city frames
(`city/city_step`) and the lighting tracer's ray batches
(`lighting/trace`).

A caller's program is a list of phases `(span name or None, fn)`; each
`fn(b)` reads and adds entries of the dict `b`, which starts as the
call's inputs (tensors, or tuples or NamedTuples of tensors and Nones).
`walk` runs the list eager, for a capture (on a side stream, one CUDA
graph a phase in one memory pool) and for a replay: the same kernels in
the same order, so a replay's outputs are bit for bit the eager ones.

`GraphCache` decides per call from the caller's key (None: never
capture).  A key is captured once it is seen on two calls in a row: the
first runs eager and warms up, the second captures, then replays.  At
most `MAX_GRAPHS` keys stay captured (least recently used first out).  A
capture that raises leaves its key eager for good (`failed`, with its
traceback).  The caller's `refs`, what its key names by identity, stay
alive beside the previous key and each graph.  A replay returns fresh
copies of the outputs.  A capture restores every `build.Kernel`'s launch
count, and each replay adds back what the capture launched.  A cache
named `name` replays inside the span `<name>.graph` and captures inside
`<name>.capture`, and counts its calls in the dict it is given (`COUNTS`).
"""

from __future__ import annotations

import contextlib
import dataclasses
import traceback
from collections import OrderedDict

import torch

from ...utils.profiler import span
from .build import Kernel

MAX_GRAPHS = 4
COUNTS = ("graph_captures", "graph_replays", "graph_eager", "graph_failed")
_NO_SPAN = contextlib.nullcontext()


def tensors_key(x) -> tuple | None:
    """A tensor, or a tuple of tensors (other entries allowed), by identity
    and by their `_version`s (an in-place edit bumps them)."""
    if x is None:
        return None
    ts = (x,) if isinstance(x, torch.Tensor) else x
    return (id(x), tuple(t._version if isinstance(t, torch.Tensor) else None for t in ts))


def _tensors(b: dict) -> list:
    """The tensors of `b`'s values, in order, Nones left out."""
    return [t for v in b.values() for t in ((v,) if isinstance(v, torch.Tensor) else v)
            if t is not None]


def _clone(v):
    """A fresh copy of a tensor, or of a tuple or NamedTuple of tensors and
    Nones."""
    if isinstance(v, torch.Tensor):
        return v.clone()
    ts = [None if t is None else t.clone() for t in v]
    return v._make(ts) if hasattr(v, "_make") else tuple(ts)


def walk(phases: list, step, device: bool | None) -> list:
    """`[step(x) for (name, x) in phases]`, each named phase inside its span
    (with CUDA events where `device`), none where `device` is None (a
    capture)."""
    out = []
    for name, x in phases:
        with _NO_SPAN if name is None or device is None else span(name, device=device):
            out.append(step(x))
    return out


def eager(phases: list, b: dict, outputs: tuple) -> tuple:
    """The program run eager on `b`: its `outputs`, by name."""
    first = next(iter(b.values()))
    on_card = (first if isinstance(first, torch.Tensor) else first[0]).is_cuda
    walk(phases, lambda fn: fn(b), on_card)
    return tuple(b[k] for k in outputs)


@dataclasses.dataclass
class Graph:
    """One captured program: its phases' graphs with their span names, the
    static input tensors and outputs, the launches it adds to each kernel,
    and what it keeps alive."""

    phases: list
    inputs: list
    out: tuple
    launches: tuple     # ((Kernel, launches), ...)
    refs: object


def _record(phases: list, b: dict) -> list:
    """Each phase's CUDA graph, captured on a side stream into one shared
    memory pool; runs no kernel."""
    dev = _tensors(b)[0].device
    cur = torch.cuda.current_stream(dev)
    side = torch.cuda.Stream(dev)
    side.wait_stream(cur)
    pool = torch.cuda.graph_pool_handle()

    def one(fn):
        g = torch.cuda.CUDAGraph()
        g.capture_begin(pool=pool)
        try:
            fn(b)
        finally:
            g.capture_end()
        return g

    try:
        with torch.cuda.stream(side):
            return walk(phases, one, None)
    finally:
        cur.wait_stream(side)


def capture(phases: list, b: dict, outputs: tuple, refs) -> Graph:
    """The program captured over static copies of `b`.  Runs no kernel: the
    first replay computes it."""
    static = {k: _clone(v) for k, v in b.items()}
    inputs = _tensors(static)
    before = {k: k.launches for k in Kernel.instances}
    try:
        graphs = _record(phases, static)
    finally:
        launches = tuple((k, k.launches - before.get(k, 0)) for k in Kernel.instances
                         if k.launches != before.get(k, 0))
        for k, n in launches:
            k.launches -= n             # nothing ran: a replay counts them
    return Graph(phases=[(name, g) for (name, _), g in zip(phases, graphs)],
                 inputs=inputs, out=tuple(static[k] for k in outputs),
                 launches=launches, refs=refs)


def replay(g: Graph, b: dict) -> tuple:
    """The captured program on `b`: fresh output tensors."""
    torch._foreach_copy_(g.inputs, _tensors(b))
    walk(g.phases, lambda graph: graph.replay(), True)
    for k, n in g.launches:
        k.launches += n
    return tuple(_clone(v) for v in g.out)


class GraphCache:
    """One caller's captured programs by key, the decision to capture,
    replay or run eager, and the count of each (module docstring)."""

    def __init__(self, name: str, counts: dict | None = None):
        self.spans = (f"{name}.capture", f"{name}.graph")
        self.counts = dict.fromkeys(COUNTS, 0) if counts is None else counts
        self.graphs: OrderedDict = OrderedDict()
        self.failed: dict = {}  # key -> the traceback of its capture: eager for good
        self.last = None        # (key, refs) of the previous call

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

    def run(self, key, phases: list, b: dict, outputs: tuple, refs=None) -> tuple:
        """The program's `outputs` on `b`, replayed from graphs where `key`
        allows."""
        how = self.decide(key)
        self.last = None if key is None else (key, refs)
        if how == "capture":
            try:
                with span(self.spans[0]):
                    g = capture(phases, b, outputs, refs)
            except Exception:       # noqa: BLE001 - any failure: eager for good
                self.failed[key] = traceback.format_exc()
                self.counts["graph_failed"] += 1
                how = "eager"
            else:
                self.counts["graph_captures"] += 1
                self.keep(key, g)
        if how == "eager":
            self.counts["graph_eager"] += 1
            return eager(phases, b, outputs)
        self.counts["graph_replays"] += 1
        with span(self.spans[1]):
            return replay(self.graphs[key], b)

"""CUDA graphs of the single-device physics frame (`step.step_objects`).

On the card a frame of `step_objects` is some 3,900 small launches (the x
sort, `_substep`'s eager glue around kernels B, C and D, the frame's
bookkeeping), and the host's dispatch of them, not the card, paces the
frame.  `FrameGraphs` captures the frame once into a CUDA graph and
replays it in place of the launches: the same kernels in the same order,
so the result is bit for bit the eager frame's.

What a capture bakes in is the call's key (`frame_key`): the device, the
state's shapes and dtypes, the env's tensors' shapes and dtypes, the
frame's options, and the scene and type table by identity and by the
`_version`s of their tensors (an in-place edit bumps them).  A key is
captured once it is seen on two calls in a row: the first runs eager and
warms up (kernel tables, sort storage, the kernel library); the second
captures on a side stream, then replays.  A caller whose scene changes
every frame stays eager.  At most `MAX_GRAPHS` keys stay captured (least
recently used first out).  A capture that raises marks its key eager for
good (`STATS.failed`).

A replay copies the state's columns and the env's tensors into the
graph's static inputs, replays, and returns fresh copies of the outputs,
so no two frames' results alias.  The launch counts of the port's kernels
(`Kernel.launches`) rise by what the captured frame launched, as an eager
frame's do.  A replay runs inside the span `physics.graph`, a capture
inside `physics.capture`; the sort and substep spans are recorded only
where the frame's glue runs on the host.
"""

from __future__ import annotations

import dataclasses
from collections import OrderedDict

import torch

from ..ops.cuda import narrow_kernel as NK
from ..ops.cuda import pairs_kernel as PK
from ..ops.cuda import sample_kernel as SK
from ..utils.profiler import span
from .cobjs import GroupedCobjs

MAX_GRAPHS = 4
# the kernels a frame launches, whose counts a replay keeps true
KERNELS = (SK.KERNEL, NK.KERNEL, PK.KERNEL)


@dataclasses.dataclass
class Stats:
    """Frames by how they ran, and captures that raised."""

    captures: int = 0
    replays: int = 0
    eager: int = 0
    failed: int = 0


STATS = Stats()


def _versions(tensors) -> tuple:
    return tuple(t._version if isinstance(t, torch.Tensor) else None for t in tensors)


def _scene_key(cobjs) -> tuple | None:
    """The scene by identity and by its tensors' versions."""
    if cobjs is None:
        return None
    if isinstance(cobjs, GroupedCobjs):
        c = cobjs.cobjs
        return (id(cobjs), id(c), cobjs.bounds, _versions(c))
    return (id(cobjs), _versions(cobjs))


def capturable(state, env) -> bool:
    """Whether the frame can be captured: its state on a card and every env
    tensor on the state's device."""
    dev = state.px.device
    return (dev.type == "cuda" and all(t.device == dev for t in state)
            and all(t is None or (isinstance(t, torch.Tensor) and t.device == dev)
                    for t in env))


def frame_key(state, env, cobjs, table, **options) -> tuple:
    """Everything a capture of the frame bakes in, hashable.  `options` are
    the frame's other arguments (`substeps`, `tstep`, `world`, ...), each
    hashable."""
    return (state.px.device, tuple((tuple(t.shape), t.dtype) for t in state),
            tuple(None if t is None else (tuple(t.shape), t.dtype) for t in env),
            tuple(sorted(options.items())), _scene_key(cobjs),
            (id(table), _versions(table)))


def refs(cobjs, table) -> tuple:
    """The objects whose identities a key holds: kept alive beside the key,
    so that no other object can take one of their ids."""
    return (cobjs, getattr(cobjs, "cobjs", None), table)


@dataclasses.dataclass
class Graph:
    """One captured frame: its graph, static inputs and outputs, what it
    adds to each kernel's launch count, and what it keeps alive."""

    graph: torch.cuda.CUDAGraph
    state: tuple
    env: tuple
    out: tuple
    launches: tuple
    refs: tuple


def _inputs(state, env) -> list:
    return list(state) + [t for t in env if t is not None]


def capture(frame, state, env, held: tuple) -> Graph:
    """Capture `frame(state, env)` on a side stream into a CUDA graph over
    static copies of `state` and `env`.  Runs no kernel: the graph's first
    replay computes the frame."""
    dev = state.px.device
    if held and isinstance(held[0], GroupedCobjs):
        held = held + (NK.kernel_tables(held[0]),)     # the tables the graph reads
    s_state = type(state)(*(t.clone() for t in state))
    s_env = type(env)(*(None if t is None else t.clone() for t in env))
    before = tuple(k.launches for k in KERNELS)
    cur = torch.cuda.current_stream(dev)
    side = torch.cuda.Stream(dev)
    side.wait_stream(cur)
    g = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.stream(side):
            g.capture_begin()
            try:
                out = frame(s_state, s_env)
            finally:
                g.capture_end()
    finally:
        cur.wait_stream(side)
        after = tuple(k.launches for k in KERNELS)
        for k, n in zip(KERNELS, before):
            k.launches = n          # nothing ran: a replay counts them
    return Graph(graph=g, state=tuple(s_state), env=tuple(s_env), out=out,
                 launches=tuple(a - b for a, b in zip(after, before)),
                 refs=held)


def replay(g: Graph, state, env):
    """The captured frame on `state` and `env`: fresh output tensors."""
    torch._foreach_copy_(_inputs(g.state, g.env), _inputs(state, env))
    g.graph.replay()
    for k, n in zip(KERNELS, g.launches):
        k.launches += n
    return type(g.out)(*(t.clone() for t in g.out))


class FrameGraphs:
    """The captured frames by key, and the decision to capture, replay or
    run eager (module docstring)."""

    def __init__(self):
        self.graphs: OrderedDict = OrderedDict()
        self.eager_keys: set = set()
        self.last = None        # (key, refs) of the previous call

    def decide(self, key) -> str:
        """"replay", "capture" or "eager" for a call with `key`, after the
        call before it (`last`): the rule of two calls in a row."""
        repeat = self.last is not None and key is not None and self.last[0] == key
        if key is not None and key in self.graphs:
            self.graphs.move_to_end(key)
            return "replay"
        if key is None or key in self.eager_keys or not repeat:
            return "eager"
        return "capture"

    def keep(self, key, g: Graph) -> None:
        """Keep `g` under `key`; drop the least recently used past the
        bound."""
        self.graphs[key] = g
        while len(self.graphs) > MAX_GRAPHS:
            self.graphs.popitem(last=False)

    def run(self, frame, key, state, env, held: tuple):
        """`frame(state, env)`, replayed from a graph where `key` allows."""
        how = self.decide(key)
        self.last = None if key is None else (key, held)
        g = self.graphs.get(key)
        if how == "capture":
            try:
                with span("physics.capture"):
                    g = capture(frame, state, env, held)
            except Exception:       # noqa: BLE001 - any failure: eager for good
                self.eager_keys.add(key)
                STATS.failed += 1
                how = "eager"
            else:
                STATS.captures += 1
                self.keep(key, g)
        if how == "eager":
            STATS.eager += 1
            return frame(state, env)
        STATS.replays += 1
        with span("physics.graph"):
            return replay(g, state, env)


FRAMES = FrameGraphs()

"""CUDA graphs of the single-device physics frame (`step.step_objects`).

On the card a frame is some 3,900 small launches, and the host's dispatch
of them paces it.  The frame goes through `FRAMES` (`ops/cuda/graphs`) as
one unnamed phase, so a repeated key replays it as one CUDA graph, inside
the span `physics.graph`.  The key (`frame_key`) is the device, the
shapes and dtypes of the state and the env, the frame's options, and the
scene and type table by identity and by their tensors' `_version`s.
"""

from __future__ import annotations

import torch

from ..ops.cuda import graphs as CG
from ..ops.cuda import narrow_kernel as NK
from .cobjs import GroupedCobjs


def _scene_key(cobjs) -> tuple | None:
    """The scene by identity and by its tensors' versions."""
    if isinstance(cobjs, GroupedCobjs):
        return (id(cobjs), cobjs.bounds, CG.tensors_key(cobjs.cobjs))
    return CG.tensors_key(cobjs)


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
            tuple(sorted(options.items())), _scene_key(cobjs), CG.tensors_key(table))


def refs(cobjs, table) -> tuple:
    """The objects whose identities a key holds, and a grouped scene's
    kernel tables, which its graph reads: kept alive beside the key."""
    if isinstance(cobjs, GroupedCobjs):
        return (cobjs, cobjs.cobjs, table, NK.kernel_tables(cobjs))
    return (cobjs, table)


FRAMES = CG.GraphCache("physics")

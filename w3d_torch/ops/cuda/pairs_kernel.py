"""Banded sorted-order pair collisions: CUDA kernel `csrc/pairs.cu`
(replaces the Pallas `_pairs_kernel`,
`3dworld_tpu/ops/pallas/pairs_kernel.py:61`).

One CTA per tile of 32 ranks: every pair of the band is tested from the
tile's shared-memory copy of its neighbourhood, touching pairs set bits in
a per-rank mask, and each rank then sums its touching pairs in the plain
version's order (`physics/step.banded_pair_collisions`, by offset, i side
first).  No float atomics: deterministic and bit-equal to the plain
version.  Takes any N and any window.
"""

from __future__ import annotations

import ctypes

import torch

from . import build

KERNEL = build.Kernel("w3d_banded_pairs",
                      [ctypes.c_void_p] * 16 + [ctypes.c_int] * 3)


def banded_pairs(px, py, pz, vx, vy, vz, radius, mass, elas, active,
                 window: int, i_limit: int | None = None):
    """(dpx, dpy, dpz, dvx, dvy, dvz) from every pair within `window` ranks
    of the sorted order; `i_limit` restricts the i side of each pair to
    ranks below it.  CPU tensors take the plain version; CUDA tensors take
    the kernel."""
    if px.device.type == "cpu":
        from ...physics.step import banded_pair_collisions
        return banded_pair_collisions(px, py, pz, vx, vy, vz, radius, mass,
                                      elas, active, window=window,
                                      i_limit=i_limit)
    if px.device.type != "cuda":
        raise ValueError(f"banded_pairs: unsupported device {px.device}")
    n = px.shape[0]
    dev = px.device
    ins = dict(px=px, py=py, pz=pz, vx=vx, vy=vy, vz=vz, radius=radius,
               mass=mass, elas=elas)
    for name, t in ins.items():
        build.check(name, t, torch.float32, (n,), dev)
    build.check("active", active, torch.bool, (n,), dev)
    if window < 1:
        raise ValueError(f"banded_pairs: window {window} < 1")
    act = active.to(torch.float32)
    outs = [torch.empty_like(px) for _ in range(6)]
    KERNEL.launch(*(t.data_ptr() for t in ins.values()), act.data_ptr(),
                  *(o.data_ptr() for o in outs), n, window,
                  n if i_limit is None else i_limit)
    return tuple(outs)

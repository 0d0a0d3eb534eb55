"""Droplet-erosion batch walk: CUDA kernel `csrc/erosion.cu` (replaces the
Pallas `_erosion_kernel`, `3dworld_tpu/ops/pallas/erosion_kernel.py:41`).

One CTA per tile, one thread per droplet.  The tile's float delta and an
int64 fixed-point map of the step's writes sit in shared memory; each step
is a read phase (every droplet reads snapshot + delta as it stood at the
start of the step), a barrier, a write phase (deposit and erosion as
integer shared-memory atomics, each 64-bit sum as two 32-bit words, so
their order does not matter), a barrier, and a combine of the cells the
step wrote (each claimed by its first writer).  Deterministic, and
bit-equal to the plain version `ops/erosion._walk_batch`.
"""

from __future__ import annotations

import ctypes

import torch

from . import build

KERNEL = build.Kernel("w3d_erosion_walk", [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5)

MAX_BATCH = 1024               # one thread per droplet, one CTA
MAX_SMEM = 227 * 1024          # float delta + int64 step sums per cell


def erosion_walk(hm: torch.Tensor, xi0: torch.Tensor, zi0: torch.Tensor,
                 angles: torch.Tensor, params6: torch.Tensor) -> torch.Tensor:
    """One lockstep batch walk on a batch of tiles -> delta maps.

    hm [T, ny, nx] f32; xi0/zi0 [T, B] int32 start cells; angles [steps, B]
    f32; params6 [6] f32 (`ops/erosion.pack_params`).  CPU tensors take the
    plain version; CUDA tensors take the kernel."""
    if hm.device.type == "cpu":
        from ..erosion import _walk_batch
        return _walk_batch(hm, xi0, zi0, angles, params6)
    if hm.device.type != "cuda":
        raise ValueError(f"erosion_walk: unsupported device {hm.device}")
    T, ny, nx = hm.shape
    B = xi0.shape[1]
    steps = angles.shape[0]
    dev = hm.device
    build.check("hm", hm, torch.float32, (T, ny, nx), dev)
    build.check("xi0", xi0, torch.int32, (T, B), dev)
    build.check("zi0", zi0, torch.int32, (T, B), dev)
    build.check("angles", angles, torch.float32, (steps, B), dev)
    build.check("params6", params6, torch.float32, (6,), dev)
    if not 0 < B <= MAX_BATCH:
        raise ValueError(f"erosion_walk: batch {B} outside 1..{MAX_BATCH}")
    if ny * nx * 12 > MAX_SMEM:
        raise ValueError(f"erosion_walk: a {ny}x{nx} tile's delta and step "
                         f"sums exceed {MAX_SMEM} bytes of shared memory")
    out = torch.empty_like(hm)
    KERNEL.launch(hm.data_ptr(), xi0.data_ptr(), zi0.data_ptr(),
                  angles.data_ptr(), params6.data_ptr(), out.data_ptr(),
                  T, ny, nx, B, steps)
    return out

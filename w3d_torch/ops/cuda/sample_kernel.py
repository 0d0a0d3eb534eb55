"""Bilinear mesh sampling: CUDA kernel `csrc/sample.cu` (replaces the Pallas
`_sample_kernel`, `3dworld_tpu/ops/pallas/sample_kernel.py:49`).

One thread per object in 64-thread CTAs; the four taps and their
central-difference gradients come from the 12 distinct mesh cells around
the object, each read once.  Takes any N and any mesh size.  The plain
version is `physics/step.sample_mesh`.
"""

from __future__ import annotations

import ctypes

import torch

from . import build
from ...utils.constants import WorldConst

KERNEL = build.Kernel("w3d_sample_mesh",
                      [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3
                      + [ctypes.c_float] * 4)


def sample_mesh(mesh: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                world: WorldConst):
    """(height, nx, ny, nz) at world (x, y) for [N] batches over the
    [my, mx] mesh.  CPU tensors take the plain version; CUDA tensors take
    the kernel."""
    if mesh.device.type == "cpu":
        from ...physics.step import sample_mesh as plain
        return plain(mesh, x, y, world)
    if mesh.device.type != "cuda":
        raise ValueError(f"sample_mesh: unsupported device {mesh.device}")
    my, mx = mesh.shape
    n = x.shape[0]
    dev = mesh.device
    build.check("mesh", mesh, torch.float32, (my, mx), dev)
    build.check("x", x, torch.float32, (n,), dev)
    build.check("y", y, torch.float32, (n,), dev)
    if my < 2 or mx < 2:
        raise ValueError("sample_mesh: the mesh needs at least 2x2 nodes")
    outs = [torch.empty_like(x) for _ in range(4)]
    KERNEL.launch(mesh.data_ptr(), x.data_ptr(), y.data_ptr(),
                  *(o.data_ptr() for o in outs), n, my, mx,
                  world.dx_inv, world.dy_inv,
                  0.5 * world.dx_inv, 0.5 * world.dy_inv)
    return tuple(outs)

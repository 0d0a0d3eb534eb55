"""Open-boundary smoke diffusion: CUDA kernel `csrc/stencil.cu` (replaces
the Pallas `_diffuse_kernel`, `3dworld_tpu/ops/pallas/stencil_kernel.py:22`,
called through `diffuse_smoke_pallas` at :53).

One thread per cell reads its six neighbours.  Takes any [nz, ny, nx]
grid.  The plain version is `water/smoke.diffuse_smoke_open`.
"""

from __future__ import annotations

import ctypes

import torch

from . import build
from ...water.smoke import diffuse_smoke_open as plain

KERNEL = build.Kernel("w3d_diffuse_smoke",
                      [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3)


def diffuse_smoke_open(smoke: torch.Tensor) -> torch.Tensor:
    """One open-boundary diffusion step on [nz, ny, nx], as
    `diffuse_smoke_pallas`.  CPU tensors take the plain version; CUDA
    tensors take the kernel."""
    if smoke.device.type == "cpu":
        return plain(smoke)
    if smoke.device.type != "cuda":
        raise ValueError(f"diffuse_smoke_open: unsupported device {smoke.device}")
    if smoke.dim() != 3:
        raise ValueError(f"diffuse_smoke_open: shape {tuple(smoke.shape)}, "
                         f"expected [nz, ny, nx]")
    build.check("smoke", smoke, torch.float32, tuple(smoke.shape), smoke.device)
    out = torch.empty_like(smoke)
    KERNEL.launch(smoke.data_ptr(), out.data_ptr(), *smoke.shape)
    return out

"""Open-boundary smoke diffusion: CUDA kernel `csrc/stencil.cu` (replaces
the Pallas `_diffuse_kernel`, `3dworld_tpu/ops/pallas/stencil_kernel.py:22`,
called through `diffuse_smoke_pallas` at :53).

Each thread owns a run of x (a float4 where the rows allow it) at one y
and marches z over a block of layers with the layers below and above in
registers; a warp's lanes pass their end cells to each other for the x
neighbours.  Takes any [nz, ny, nx] grid of fewer than 2^31 cells.  The
plain version is `water/smoke.diffuse_smoke_open`.
"""

from __future__ import annotations

import ctypes

import torch

from . import build
from ...water.smoke import diffuse_smoke_open as plain

KERNEL = build.Kernel("w3d_diffuse_smoke",
                      [ctypes.c_void_p] * 2 + [ctypes.c_int] * 5)

ROWS = 4                 # warps (rows of y) per CTA, as csrc/stencil.cu
MIN_THREADS = 132 * 256  # a z block is cut no longer than keeps this many threads


def z_block(nz: int, ny: int, nx: int, vec: int) -> int:
    """Layers one thread marches: the largest power of two (at most nz)
    that still leaves MIN_THREADS threads, one per run, row and z block."""
    runs = -(-nx // vec) * ny
    zb = 1
    while 2 * zb <= nz and runs * -(-nz // (2 * zb)) >= MIN_THREADS:
        zb *= 2
    return zb


def diffuse_smoke_open(smoke: torch.Tensor, zb: int | None = None) -> torch.Tensor:
    """One open-boundary diffusion step on [nz, ny, nx], as
    `diffuse_smoke_pallas`.  CPU tensors take the plain version; CUDA
    tensors take the kernel, whose threads march `zb` layers each
    (`z_block` by default)."""
    if smoke.device.type == "cpu":
        return plain(smoke)
    if smoke.device.type != "cuda":
        raise ValueError(f"diffuse_smoke_open: unsupported device {smoke.device}")
    if smoke.dim() != 3:
        raise ValueError(f"diffuse_smoke_open: shape {tuple(smoke.shape)}, "
                         f"expected [nz, ny, nx]")
    build.check("smoke", smoke, torch.float32, tuple(smoke.shape), smoke.device)
    nz, ny, nx = smoke.shape
    if smoke.numel() + ny * nx >= 2 ** 31 or -(-ny // ROWS) > 65535:
        raise ValueError(f"diffuse_smoke_open: grid {tuple(smoke.shape)} is "
                         f"too large for the kernel's 32-bit indices")
    out = torch.empty_like(smoke)
    vec = 4 if nx % 4 == 0 and smoke.data_ptr() % 16 == 0 else 1
    zb = z_block(nz, ny, nx, vec) if zb is None else zb
    if zb < 1 or -(-nz // zb) > 65535:
        raise ValueError(f"diffuse_smoke_open: z block {zb} for {nz} layers")
    KERNEL.launch(smoke.data_ptr(), out.data_ptr(), nz, ny, nx, vec, zb)
    return out

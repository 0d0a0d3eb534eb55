"""Fused sine-table tile noise: CUDA kernel `csrc/noise.cu` (replaces the
Pallas `_tile_noise_kernel`, `3dworld_tpu/ops/pallas/noise_kernel.py:28`,
called through `tile_noise_pallas` at :60).

One CTA per tile builds the tile's X and Y term tables in shared memory
(rows padded to a multiple of 64) and contracts them in its own loop, each
thread an 8 x 8 block of heights from float4 operands.  Takes any T and
any n whose two term tables fit a block's shared memory.  The plain
version is `ops/noise.tile_noise`.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import build
from .. import noise as N

KERNEL = build.Kernel("w3d_tile_noise",
                      [ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
                      + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2
                      + [ctypes.c_float] * 6)

SMEM_LIMIT = 232448   # bytes of shared memory a block may opt in to (H100)


def tile_noise(table: N.SineTable, x0: torch.Tensor, y0: torch.Tensor, n: int,
               dx: float, dy: float, mesh_scale: float = 1.0,
               mesh_scale_z_inv: float = 1.0, start_sin: int = 0) -> torch.Tensor:
    """[T] tile origins (grid units) -> [T, n, n] raw sine-mode heights, as
    `tile_noise_pallas`.  CPU tensors take the plain version; CUDA tensors
    take the kernel."""
    dev = table.mag.device
    if dev.type == "cpu":
        return N.tile_noise(table, x0, y0, n, dx, dy, mesh_scale,
                            mesh_scale_z_inv, start_sin)
    if dev.type != "cuda":
        raise ValueError(f"tile_noise: unsupported device {dev}")
    K = N.F_TABLE_SIZE
    T = x0.shape[0]
    for name in N.SineTable._fields:
        build.check(name, getattr(table, name), torch.float32, (K,), dev)
    build.check("x0", x0, torch.float32, (T,), dev)
    build.check("y0", y0, torch.float32, (T,), dev)
    start = min(max(int(start_sin), 0), K)
    if 2 * (-(-n // 64) * 64) * (K - start) * 4 > SMEM_LIMIT:
        raise ValueError(f"tile_noise: n={n} term tables exceed a block's "
                         f"{SMEM_LIMIT} bytes of shared memory")
    params = torch.stack(list(table)).contiguous()       # [5, K], field order
    out = torch.empty((T, n, n), dtype=torch.float32, device=dev)
    f32 = lambda v: float(np.float32(v))
    KERNEL.launch(params.data_ptr(), K, start, x0.data_ptr(), y0.data_ptr(),
                  out.data_ptr(), T, n, f32(dx), f32(dy),
                  f32(mesh_scale / dx), f32(mesh_scale / dy),
                  f32(0.5 * mesh_scale), f32(mesh_scale_z_inv))
    return out

"""The pedestrians' separation (`city/traffic._separation`) as one CUDA
kernel, `csrc/separation.cu`, in place of ~25 PyTorch launches over
[rows x peers] temporaries.

`separation` takes the plain PyTorch version
(`city/traffic.separation_plain`) for CPU tensors and the kernel for CUDA
tensors, and returns what the plain version returns: bit for bit in every
row with at most two neighbours within the radius, within an ulp or two of
the sum before the normalisation elsewhere (`torch.sum` adds in a tree
order of its own).  A row's bits depend only on the row and its peers, so
a rank's slab of rows gives the whole crowd's rows bit for bit.
"""

from __future__ import annotations

import ctypes

import torch

from . import build

_P, _I = ctypes.c_void_p, ctypes.c_int
KERNEL = build.Kernel("w3d_separation", [_P, _P, _P, _P, _I, _I, _I, ctypes.c_float, _P, _P])


def _on(dev: torch.device, name: str, t: torch.Tensor) -> torch.Tensor:
    """`t` as the kernel reads it; raises unless it is a 1-D float32 tensor
    on `dev`."""
    if t.device != dev:
        raise ValueError(f"{name}: on {t.device}, expected {dev}")
    if t.dtype != torch.float32 or t.dim() != 1:
        raise ValueError(f"{name}: {t.dtype} of shape {tuple(t.shape)}, expected "
                         "a 1-D float32 tensor")
    return t.contiguous()


def separation(x: torch.Tensor, y: torch.Tensor, sep_radius: float, peers):
    """Unit push (rx, ry) of each pedestrian at (x, y) away from the
    `peers` (a `traffic.PedPeers`) within `sep_radius`; row r is peer
    `peers.first + r`, which it does not count."""
    from ...city import traffic as CT
    if x.device.type == "cpu":
        return CT.separation_plain(x, y, sep_radius, peers)
    if x.device.type != "cuda":
        raise ValueError(f"separation: unsupported device {x.device}")
    dev = x.device
    x, y = _on(dev, "x", x), _on(dev, "y", y)
    px, py = _on(dev, "peers.x", peers.x), _on(dev, "peers.y", peers.y)
    rows, n = x.shape[0], px.shape[0]
    if y.shape[0] != rows or py.shape[0] != n:
        raise ValueError(f"separation: x, y of {rows}, {y.shape[0]} rows; peers' x, y "
                         f"of {n}, {py.shape[0]}")
    if rows == 0 or n == 0:        # no pair: the plain sums are 0, and so the push
        return (torch.zeros(rows, dtype=torch.float32, device=dev),
                torch.zeros(rows, dtype=torch.float32, device=dev))
    ox = torch.empty(rows, dtype=torch.float32, device=dev)
    oy = torch.empty(rows, dtype=torch.float32, device=dev)
    KERNEL.launch(x.data_ptr(), y.data_ptr(), px.data_ptr(), py.data_ptr(), rows, n,
                  int(peers.first), sep_radius ** 2, ox.data_ptr(), oy.data_ptr())
    return ox, oy

"""float32 math that rounds the same on every device.

PyTorch's vectorized CPU `sqrt` is not correctly rounded (about 6 in
1,000 results round the other way), and its float32 `sin`, `cos` and `exp`
round otherwise than CUDA's in a few results in 1,000.  A path that turns
an ulp into another branch (a Monte Carlo ray that lands in the next
cell, a combat target) then differs between the card and the CPU.  These
functions compute in float64 and round once to float32, which gives the
correctly rounded result on every device (for `sqrt` always; for the
others except where the float64 value lies within its own error of a
float32 rounding boundary, about once in 10^8).  The card's `sqrtf` is
correctly rounded already, so `sqrt32` keeps it there.
"""

from __future__ import annotations

import torch


def sqrt32(x: torch.Tensor) -> torch.Tensor:
    """float32 square root, correctly rounded on every device, as the JAX
    package's is."""
    return torch.sqrt(x) if x.device.type != "cpu" else torch.sqrt(x.double()).to(x.dtype)


def cos32(x: torch.Tensor) -> torch.Tensor:
    return torch.cos(x.double()).to(x.dtype)


def sin32(x: torch.Tensor) -> torch.Tensor:
    return torch.sin(x.double()).to(x.dtype)


def exp32(x: torch.Tensor) -> torch.Tensor:
    return torch.exp(x.double()).to(x.dtype)


def div32(a: torch.Tensor, s: float) -> torch.Tensor:
    """`a / s` for a Python number `s`, IEEE-rounded on every device."""
    return a / torch.full((), s, dtype=a.dtype, device=a.device)

"""Water surface ripples: damped wave-equation stencil (port of
`3dworld_tpu/water/ripples.py`).

Re-expresses `compute_ripples` (Water.cpp:678-830) as a vectorized
8-neighbour stencil: each active water cell exchanges (rval_c - rval_n)
increments with its neighbours (diagonals x 1/sqrt(2)); transfer INTO a
neighbour only happens when that neighbour is water (the reference's
`inside8` bitmask), while the source cell always loses the increment —
preserving the reference's shoreline energy leak.  Then
zval = DAMP1*(rval + DAMP2*acc) clamped to the water depth, and
rval = ATTEN^tstep * zval.

Constants: Water.cpp:13-17.  The neighbour sums run in `_DIRS` order and
the `** ts` powers are float32 powers of a float32 `ts`, as in the JAX
package, so the stencil gives its bits.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

RIPPLE_DAMP1 = 0.95
RIPPLE_DAMP2 = 0.02
RIPPLE_MAT_ATTEN = 0.965
SQRT2_INV = float(1.0 / np.sqrt(2.0))

# 8 neighbour shifts (dy, dx, weight)
_DIRS = [(0, -1, 1.0), (0, 1, 1.0), (-1, 0, 1.0), (1, 0, 1.0),
         (-1, -1, SQRT2_INV), (-1, 1, SQRT2_INV),
         (1, -1, SQRT2_INV), (1, 1, SQRT2_INV)]


class RippleState(NamedTuple):
    rval: torch.Tensor  # [my, mx] ripple height
    acc: torch.Tensor   # [my, mx] accumulated wave energy


def make_ripples(my: int, mx: int,
                 device: torch.device | str = "cuda") -> RippleState:
    z = torch.zeros((my, mx), dtype=torch.float32, device=device)
    return RippleState(rval=z, acc=z)


def _shift(a: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """Shift with zero boundary (off-mesh neighbours don't exist)."""
    out = torch.roll(a, (dy, dx), (0, 1))
    if dy == 1:
        out[0, :] = 0.0
    elif dy == -1:
        out[-1, :] = 0.0
    if dx == 1:
        out[:, 0] = 0.0
    elif dx == -1:
        out[:, -1] = 0.0
    return out


def _powers(tstep):
    """(ATTEN^ts, DAMP1^ts, DAMP2*ts) with ts = max(tstep, 0.25), each a
    float32 operation: Python floats for a number, tensors for a tensor."""
    if isinstance(tstep, torch.Tensor):
        ts = torch.clamp(tstep.to(torch.float32), min=0.25)
        return (torch.pow(RIPPLE_MAT_ATTEN, ts), torch.pow(RIPPLE_DAMP1, ts),
                RIPPLE_DAMP2 * ts)
    f = np.float32
    ts = max(f(tstep), f(0.25))
    return (float(f(RIPPLE_MAT_ATTEN) ** ts), float(f(RIPPLE_DAMP1) ** ts),
            float(f(RIPPLE_DAMP2) * ts))


def step_ripples(state: RippleState, inside: torch.Tensor, depth: torch.Tensor,
                 tstep: float | torch.Tensor = 1.0) -> tuple:
    """One ripple step.  inside [my,mx] bool water mask; depth [my,mx]
    water depth (clamps wave height).  Returns (state, ripple_zval)."""
    rm_atten, rdamp1, rdamp2 = _powers(tstep)

    ins = inside.to(torch.float32)
    rval = state.rval
    acc = state.acc * rm_atten

    out_flux = torch.zeros_like(rval)
    in_flux = torch.zeros_like(rval)
    for dy, dx, w in _DIRS:
        # difference toward the neighbour at (dy, dx), from active cells only
        d = (rval - _shift(rval, -dy, -dx)) * w * ins
        out_flux = out_flux + d
        # the neighbour receives it only if it is water: accumulate the
        # flux shifted into place, masked by the receiving cell's inside bit
        in_flux = in_flux + _shift(d, dy, dx) * ins
    acc = acc - out_flux + in_flux

    zval = rdamp1 * (rval + rdamp2 * acc)
    zval = torch.clamp(zval, min=-depth, max=depth)   # wave height bounded by depth
    new_rval = torch.where(inside, rm_atten * zval, 0.0)
    return RippleState(rval=new_rval, acc=torch.where(inside, acc, 0.0)), zval


def add_splash(state: RippleState, gx, gy, radius_cells: int, energy,
               mx: int, my: int) -> RippleState:
    """Object/rain splash: inject wave energy around grid cell (gx, gy)
    (add_splash / draw_splash semantics)."""
    dev = state.acc.device
    xi = torch.arange(mx, device=dev)[None, :]
    yi = torch.arange(my, device=dev)[:, None]
    d2 = (xi - gx) ** 2 + (yi - gy) ** 2
    mask = (d2 <= radius_cells ** 2).to(torch.float32)
    return state._replace(acc=state.acc + energy * mask)

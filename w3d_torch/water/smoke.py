"""3D smoke diffusion over the lighting grid (port of
`3dworld_tpu/water/smoke.py`).

Re-expresses `distribute_smoke` / `diffuse_smoke_xy/z` (smoke.cpp:141-260):
a cellular-automaton diffusion on the lmcell smoke channel with
direction-dependent rates (xy 0.05, z-up 0.08, z-down 0.03), optional
per-cell flow blocking (pflow, geometry-opaque faces), grid-edge cells as
infinite sinks, and values clamped to [0, SMOKE_MAX_VAL].

The reference staggers rows across 8 frames at 8x rate (SMOKE_SKIPVAL);
here the whole grid diffuses every step at 1x rate, the same steady state.

`diffuse_smoke` is the gated path (the JAX package's XLA path);
`diffuse_smoke_open` is the plain version of the open-boundary stencil
kernel (kernel F, `ops/cuda/stencil_kernel.diffuse_smoke_open`).  The two
compute the same exchange with the sums in another order.
"""

from __future__ import annotations

import torch

# smoke.cpp:13-22
SMOKE_MAX_CELL = 0.125
SMOKE_MAX_VAL = 100.0
SMOKE_DIS_XY = 0.05
SMOKE_DIS_ZU = 0.08
SMOKE_DIS_ZD = 0.03


def _neighbour(a: torch.Tensor, axis: int, step: int) -> torch.Tensor:
    """a shifted so each cell holds its neighbour at `axis` + `step`
    (step +1 or -1), with zero where that neighbour is outside the grid."""
    out = torch.roll(a, -step, axis)
    edge = [slice(None)] * a.dim()
    edge[axis] = -1 if step > 0 else 0
    out[tuple(edge)] = 0.0
    return out


def diffuse_smoke(smoke: torch.Tensor, flow_x: torch.Tensor | None = None,
                  flow_y: torch.Tensor | None = None,
                  flow_z: torch.Tensor | None = None) -> torch.Tensor:
    """One diffusion step on smoke [nz, ny, nx].

    flow_* in [0, 1] gate transfer across each axis (None = fully open);
    edge cells leak smoke out of the grid (infinite sink)."""
    one = torch.ones_like(smoke)
    fx = one if flow_x is None else flow_x
    fy = one if flow_y is None else flow_y
    fz = one if flow_z is None else flow_z

    def exchange(axis, rate_pos, rate_neg, flow):
        """Neighbour exchange along axis with edge sinks."""
        d_up = (_neighbour(smoke, axis, 1) - smoke) * flow   # > 0: inflow from +axis
        d_dn = (_neighbour(smoke, axis, -1) - smoke) * flow
        r_up = torch.where(d_up > 0, rate_pos, rate_neg)
        r_dn = torch.where(d_dn > 0, rate_neg, rate_pos)
        return d_up * r_up + d_dn * r_dn

    delta = (exchange(2, SMOKE_DIS_XY, SMOKE_DIS_XY, fx)
             + exchange(1, SMOKE_DIS_XY, SMOKE_DIS_XY, fy)
             # z: rising smoke moves up at the ZU rate, down at ZD
             + exchange(0, SMOKE_DIS_ZD, SMOKE_DIS_ZU, fz))
    return torch.clamp(smoke + delta, 0.0, SMOKE_MAX_VAL)


def diffuse_smoke_open(smoke: torch.Tensor) -> torch.Tensor:
    """One open-boundary diffusion step on [nz, ny, nx]: the plain version
    of kernel F, transcribing the Pallas `_diffuse_kernel`
    (`3dworld_tpu/ops/pallas/stencil_kernel.py:22-49`) op for op.  The xy
    exchange sums the four neighbours (zero outside the grid) before the
    rate; the z exchange takes ZD for inflow from above and outflow below,
    ZU otherwise, with the top and bottom layers' outer neighbours zero."""
    cur = smoke
    delta = (_neighbour(cur, 2, -1) + _neighbour(cur, 2, 1)
             + _neighbour(cur, 1, -1) + _neighbour(cur, 1, 1)
             - 4.0 * cur) * SMOKE_DIS_XY
    d_up = _neighbour(cur, 0, 1) - cur
    d_dn = _neighbour(cur, 0, -1) - cur
    delta = delta + torch.where(d_up > 0, SMOKE_DIS_ZD, SMOKE_DIS_ZU) * d_up
    delta = delta + torch.where(d_dn > 0, SMOKE_DIS_ZU, SMOKE_DIS_ZD) * d_dn
    return torch.clamp(cur + delta, 0.0, SMOKE_MAX_VAL)


def add_smoke(smoke: torch.Tensor, idx_z, idx_y, idx_x, amount) -> torch.Tensor:
    """Inject smoke at cells (fires, explosions; add_smoke smoke.cpp);
    repeated cells add up.  Returns a new grid."""
    idx = tuple(torch.as_tensor(i, dtype=torch.long, device=smoke.device)
                for i in (idx_z, idx_y, idx_x))
    amount = torch.as_tensor(amount, dtype=smoke.dtype, device=smoke.device)
    return smoke.index_put(idx, amount.expand(idx[0].shape), accumulate=True)

"""Torch port vs JAX package: the fused tile noise (kernel E's plain version
`ops/noise.tile_noise` against the Pallas `tile_noise_pallas`), the
open-boundary smoke stencil (kernel F's plain version
`water/smoke.diffuse_smoke_open` against `diffuse_smoke_pallas`), both in
interpret mode, and the gated `diffuse_smoke` and `add_smoke` against the
JAX package's.

Tolerances: tile heights 1e-4 (sin and the 90-term sum round differently
in the two packages; heights reach ~10); at far tile origins, one float32
unit of each term's largest sine argument, weighted by its magnitude (see
`test_tile_noise_matches_pallas_far_origins`); smoke 1e-6 (the same ops in
the same order on values up to 5).
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import w3d  # noqa: F401
from w3d.ops import noise as JN
from w3d.ops.pallas.noise_kernel import tile_noise_pallas
from w3d.ops.pallas.stencil_kernel import diffuse_smoke_pallas
from w3d.utils.constants import WorldConst as JWorld
from w3d.water import smoke as JS

from w3d_torch import convert
from w3d_torch.ops.cuda import noise_kernel as EK
from w3d_torch.ops.cuda import stencil_kernel as FK
from w3d_torch.ops import noise as TN
from w3d_torch.utils.kernel_probe import RATE_SHIFT, sine_arguments
from w3d_torch.water import smoke as TS


@pytest.mark.parametrize("n,start_sin", [(64, 0), (32, 20)])
def test_tile_noise_matches_pallas(n, start_sin):
    w = JWorld()
    table = JN.gen_sine_table(w, mesh_seed=3)
    x0 = np.array([0.0, 64.0, -32.0], np.float32)
    y0 = np.array([0.0, 32.0, 16.0], np.float32)
    ref = np.asarray(tile_noise_pallas(table, jnp.asarray(x0), jnp.asarray(y0),
                                       n, w.dx, w.dy, start_sin=start_sin,
                                       interpret=True))
    tt = convert.sine_table(jax.tree.map(np.asarray, table), "cpu")
    tx0, ty0 = convert.array(x0, "cpu"), convert.array(y0, "cpu")
    out = TN.tile_noise(tt, tx0, ty0, n, w.dx, w.dy, start_sin=start_sin)
    assert out.shape == (3, n, n) and np.abs(ref).max() > 1.0
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-4)
    # the wrapper takes the plain version for CPU tensors
    assert torch.equal(EK.tile_noise(tt, tx0, ty0, n, w.dx, w.dy,
                                     start_sin=start_sin), out)


def test_tile_noise_matches_pallas_far_origins():
    """Tiles at the origins of chip_smoke.py's rate loop (x0 ~ 3.6e5 grid
    units), where the sine arguments reach ~6e5 and one float32 unit of an
    argument is ~0.06 rad.  XLA on the CPU fuses the argument's products
    and sums into FMAs where the port rounds each op, so an argument may
    differ by a unit; the bound is the sum over terms of |mag| times one
    unit of the term's largest x and y argument (~1.6e-2 here; the heights
    differ by ~1.6e-3, and by 5e-7 at the origins of the other test)."""
    w = JWorld()
    n = 64
    table = JN.gen_sine_table(w, mesh_seed=3)
    x0 = np.array([0.0, 64.0, 32768.0], np.float32) + np.float32(RATE_SHIFT)
    y0 = np.array([0.0, 32.0, 16.0], np.float32)
    ref = np.asarray(tile_noise_pallas(table, jnp.asarray(x0), jnp.asarray(y0),
                                       n, w.dx, w.dy, interpret=True))
    tt = convert.sine_table(jax.tree.map(np.asarray, table), "cpu")
    tx0, ty0 = convert.array(x0, "cpu"), convert.array(y0, "cpu")
    out = TN.tile_noise(tt, tx0, ty0, n, w.dx, w.dy)
    amax = sine_arguments(tt, tx0, ty0, n, w.dx, w.dy, 1.0, 1.0).abs().amax(dim=(1, 2))
    assert float(amax.max()) > 105615.0              # past sinf's fast reduction
    unit = np.spacing(amax.numpy().astype(np.float32))           # [2, K]
    tol = float((np.abs(tt.mag.numpy()) * unit.sum(axis=0)).sum())
    assert out.shape == (3, n, n) and np.abs(ref).max() > 1.0
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=tol)
    assert torch.equal(EK.tile_noise(tt, tx0, ty0, n, w.dx, w.dy), out)


def _smoke(shape=(8, 16, 24), seed=0):
    return np.random.default_rng(seed).uniform(0, 5, shape).astype(np.float32)


def test_diffuse_smoke_open_matches_pallas():
    s = _smoke()
    s[0, 0, 0] = 150.0   # drains to above SMOKE_MAX_VAL: clamped
    s[3, 5, 7] = -20.0   # stays below 0: clamped
    ref = np.asarray(diffuse_smoke_pallas(jnp.asarray(s), interpret=True))
    ts = convert.array(s, "cpu")
    out = TS.diffuse_smoke_open(ts)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-6)
    assert out[0, 0, 0] == TS.SMOKE_MAX_VAL and out[3, 5, 7] == 0.0
    assert torch.equal(FK.diffuse_smoke_open(ts), out)


@pytest.mark.parametrize("gated", [False, True])
def test_diffuse_smoke_matches_jax(gated):
    s = _smoke(seed=1)
    flows = [None] * 3
    if gated:
        rng = np.random.default_rng(2)
        flows = [rng.uniform(0, 1, s.shape).astype(np.float32) for _ in range(3)]
    ref = np.asarray(JS.diffuse_smoke(
        jnp.asarray(s), *(None if f is None else jnp.asarray(f) for f in flows)))
    ts = convert.array(s, "cpu")
    out = TS.diffuse_smoke(ts, *(None if f is None else convert.array(f, "cpu")
                                 for f in flows))
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-6)
    # the gated and open paths are the same exchange, summed in another order
    if not gated:
        open_ = TS.diffuse_smoke_open(ts).numpy()
        np.testing.assert_allclose(out.numpy(), open_, rtol=0, atol=1e-5)


def test_add_smoke_matches_jax():
    s = _smoke(seed=3)
    iz, iy, ix = np.array([1, 1, 7]), np.array([2, 2, 15]), np.array([3, 3, 0])
    amount = np.array([0.5, 0.25, 2.0], np.float32)
    ref = np.asarray(JS.add_smoke(jnp.asarray(s), iz, iy, ix, jnp.asarray(amount)))
    out = TS.add_smoke(convert.array(s, "cpu"), iz, iy, ix,
                       convert.array(amount, "cpu"))
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-6)
    assert out[1, 2, 3] == pytest.approx(s[1, 2, 3] + 0.75)

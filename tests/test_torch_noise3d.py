"""Torch port vs JAX package: the 3-D noise of `ops/noise`
(`gen_sine_table_3d`, `eval_sine3d_grid`, `simplex3d`, `fbm3d`) and the
planet surfaces of `universe/surface`, on the CPU.

The sine table is host float32 code in the reference's op order: bitwise
(it is pinned against the compiled C++ in tests/test_cpp_golden.py).  The
rest within 1e-5, the water masks equal: the grid's product and the
surface's sum over 60 terms add in other orders, and the surfaces' sines
and the craters' arccos are other implementations."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

import w3d  # noqa: F401
from w3d.ops import noise as JN
from w3d.universe import surface as JS

from w3d_torch.ops import noise as TN
from w3d_torch.universe import surface as TS


def _t(a):
    return torch.as_tensor(np.array(a))


@pytest.mark.parametrize("mag,freq,s1,s2", [(1.0, 1.0, 1, 1), (0.7, 2.5, 12345, 77),
                                            (1.0, 1.0, 2147483000, 987654321)])
def test_sine_table_3d_bitwise(mag, freq, s1, s2):
    jt = JN.gen_sine_table_3d(mag, freq, s1, s2)
    tt = TN.gen_sine_table_3d(mag, freq, s1, s2, device="cpu")
    for a, b in zip(jt, tt):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


@pytest.mark.parametrize("num_sines", [None, 40])
def test_eval_sine3d_grid(num_sines):
    jt = JN.gen_sine_table_3d(1.0, 1.0, 5, 7)
    tt = TN.gen_sine_table_3d(1.0, 1.0, 5, 7, device="cpu")
    args = ((0.1, -0.3, 0.2), (0.05, 0.07, 0.03), 17, 9, 5)
    ref = np.asarray(JN.eval_sine3d_grid(jt, *args, num_sines=num_sines))
    out = TN.eval_sine3d_grid(tt, *args, num_sines=num_sines).numpy()
    assert out.shape == (5, 9, 17)
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)


def test_simplex3d_and_fbm3d():
    """Points across many lattice cells, negative indices included (the
    hash's int32 -> uint32 wrap), several seeds."""
    rng = np.random.default_rng(0)
    x, y, z = (rng.uniform(-40, 40, 4000).astype(np.float32) for _ in range(3))
    for seed in (0, 3, 0x7FFFFFF0):
        ref = np.asarray(JN.simplex3d(jnp.asarray(x), jnp.asarray(y), jnp.asarray(z), seed=seed))
        out = TN.simplex3d(_t(x), _t(y), _t(z), seed=seed).numpy()
        np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)
        assert np.abs(ref).max() > 0.5
    ref = np.asarray(JN.fbm3d(jnp.asarray(x), jnp.asarray(y), jnp.asarray(z), 1.3, 1.7,
                              octaves=5, mag=0.8, freq=1.5, seed=9))
    out = TN.fbm3d(_t(x), _t(y), _t(z), 1.3, 1.7, octaves=5, mag=0.8, freq=1.5, seed=9)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize("seed,shape", [(1, (32, 64)), (987654321, (64, 128))])
def test_planet_surface_color_and_craters(seed, shape):
    """gen_planet_surface (heights 1e-5, water mask equal), planet_surface
    at another magnitude, surface_color at three temperatures and
    add_craters."""
    jh, jm = JS.gen_planet_surface(seed, *shape, water_level=0.1)
    th, tm = TS.gen_planet_surface(seed, *shape, water_level=0.1, device="cpu")
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    assert 0 < int(tm.sum()) < tm.numel()
    jt = JN.gen_sine_table_3d(1.0, 1.0, seed, 3)
    tt = TN.gen_sine_table_3d(1.0, 1.0, seed, 3, device="cpu")
    np.testing.assert_allclose(TS.planet_surface(tt, 16, 24, mag=0.5).numpy(),
                               np.asarray(JS.planet_surface(jt, 16, 24, mag=0.5)),
                               rtol=0, atol=1e-5)
    h = np.asarray(jh)
    for temp in (5.0, 40.0, 200.0):
        ref = np.asarray(JS.surface_color(jh, jm, temp))
        out = TS.surface_color(_t(h), _t(np.asarray(jm)), temp).numpy()
        np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)
    ref = np.asarray(JS.add_craters(jh, seed=seed, num=12))
    out = TS.add_craters(_t(h), seed=seed, num=12).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)
    assert np.abs(ref - h).max() > 1e-3

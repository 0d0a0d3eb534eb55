"""Torch port vs JAX package: `physics/step.morton_key` and the asteroid
field of `universe/asteroids`, on the CPU.

The field's draws are threefry in the JAX package: the tests replay its
key chain (`jax_asteroid_draws`).  The JAX step's `_pair_deltas` is
patched to `method="banded"`: on the JAX CPU, `auto` is the block pass,
which differs from a banded pass at the Morton curve's long jumps
(`physics/step.py:266-272`); the port runs kernel D's banded pass (its
plain version here).  The JAX CPU sort keeps the input order of equal
keys (pinned below), so the port sorts stably and the fields compare
element by element.  Keys bitwise; fields within 1e-5, model seeds
equal."""

import functools

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import w3d  # noqa: F401
from w3d.physics import step as JPS
from w3d.universe import asteroids as JA

from w3d_torch.physics import step as TPS
from w3d_torch.universe import asteroids as TA

from torch_port_util import jax_asteroid_draws, same_tree


@pytest.fixture
def banded(monkeypatch):
    monkeypatch.setattr(JA, "_pair_deltas", functools.partial(JPS._pair_deltas,
                                                              method="banded"))


def test_morton_key_bitwise():
    """Keys of points inside and outside the clip range (cells below 0 and
    above 0xFFFF clip), in int64 lanes: equal to the JAX uint32 keys."""
    rng = np.random.default_rng(0)
    edge = np.array([[-1e6, -1e6], [1e6, 1e6], [1e6, -1e6], [0.0, 0.0], [-20.0, 7.25],
                     [19.999, -19.999]], np.float32)
    pts = np.concatenate([rng.uniform(-30, 30, (2000, 2)), rng.uniform(-5e4, 5e4, (500, 2)),
                          edge]).astype(np.float32)
    x, y = pts[:, 0], pts[:, 1]
    for cell, half in ((0.5, 20.0), (0.05, 2.0), (1.0, 1e4)):
        ref = np.asarray(JPS.morton_key(jnp.asarray(x), jnp.asarray(y), cell, half))
        out = TPS.morton_key(torch.as_tensor(x), torch.as_tensor(y), cell, half)
        assert out.dtype == torch.int64
        np.testing.assert_array_equal(out.numpy(), ref.astype(np.int64))
        # both clips: the far corner's key is all ones, the near one's 0
        assert ref[-5] == 0xFFFFFFFF and ref[-6] == 0


def test_jax_sort_keeps_tie_order():
    """The JAX CPU `lax.sort` co-sort the asteroid step uses keeps the
    input order of equal keys (the port's stable sort relies on it): a
    field's worth of keys with many ties."""
    rng = np.random.default_rng(4)
    for n in (64, 512, 4096):
        key = jnp.asarray(rng.integers(0, n // 8, n).astype(np.uint32))
        _, idx = jax.jit(lambda k, i: jax.lax.sort([k, i], num_keys=1))(
            key, jnp.arange(n, dtype=jnp.int32))
        np.testing.assert_array_equal(np.asarray(idx),
                                      np.argsort(np.asarray(key), kind="stable"))


@pytest.mark.parametrize("n,radius", [(512, 10.0), (300, 1.5)])
def test_asteroid_field_matches_jax(banded, n, radius):
    """gen_asteroid_field from the JAX draws, then 8 steps: within 1e-5,
    seeds equal.  At radius 1.5 the field is dense (pair contacts every
    step) and its Morton keys tie; at 10 (the JAX default) it is the
    app's field."""
    key = jax.random.key(5)
    jf = JA.gen_asteroid_field(key, radius, n)
    tf = TA.gen_asteroid_field(jax_asteroid_draws(key, n), radius)
    same_tree(tf, jf)
    moved = 0.0
    for _ in range(8):
        prev = tf
        jf = JA.step_asteroid_field(jf, radius, 1.0)
        tf = TA.step_asteroid_field(tf, radius, 1.0)
        same_tree(tf, jf)
        # the pair pass acted: velocities changed beyond the reflection
        moved = max(moved, float((tf.vx - prev.vx[torch.argsort(
            TPS.morton_key(prev.px + prev.vx, prev.py + prev.vy, 0.05 * radius,
                           2.0 * radius), stable=True)]).abs().max()))
    assert moved > 0.0
    keys = TPS.morton_key(tf.px, tf.py, 0.05 * radius, 2.0 * radius)
    if radius < 2:
        assert len(torch.unique(keys)) < n          # tied keys
    assert int(tf.rseed.max()) > 1 << 24            # seeds rounded through float32


def test_seeds_round_through_float32(banded):
    """The step carries the model seeds through the sort as float32, as
    the JAX step does: seeds above 2^24 come back rounded, equal in both."""
    key = jax.random.key(9)
    jf = JA.gen_asteroid_field(key, 10.0, 64)
    tf = TA.gen_asteroid_field(jax_asteroid_draws(key, 64), 10.0)
    j1 = np.asarray(JA.step_asteroid_field(jf, 10.0, 1.0).rseed)
    t1 = TA.step_asteroid_field(tf, 10.0, 1.0).rseed.numpy()
    np.testing.assert_array_equal(t1, j1)
    seeds = np.asarray(jf.rseed)
    assert set(t1.tolist()) == set(seeds.astype(np.float32).astype(np.int32).tolist())
    assert not set(t1.tolist()) <= set(seeds.tolist())     # some were rounded


@pytest.mark.parametrize("seed", [0, 77, 123457])
def test_asteroid_rock_mesh(seed):
    jp, jfc = JA.asteroid_rock_mesh(seed, radius=0.7, n_lat=12, n_lon=20)
    tp, tfc = TA.asteroid_rock_mesh(seed, radius=0.7, n_lat=12, n_lon=20, device="cpu")
    np.testing.assert_allclose(tp, jp, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(tfc, jfc)
    assert tp.dtype == np.float32 and tfc.shape == ((12 - 1) * 20 * 2, 3)

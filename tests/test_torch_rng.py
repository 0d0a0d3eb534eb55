"""Torch port vs JAX package: reference LCG, RandGen, xxhash and droplet
starts.  Integer code: every comparison is exact."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

import w3d  # noqa: F401
from w3d.utils import rng as JR
from w3d.ops import erosion as JE

from w3d_torch.utils import rng as TR
from w3d_torch.ops import erosion as TE


def _seeds(n=4096, seed=0):
    rs = np.random.default_rng(seed)
    return (rs.integers(1, 2**31 - 2, n, dtype=np.int64).astype(np.int32),
            rs.integers(1, 2**31 - 2, n, dtype=np.int64).astype(np.int32))


def test_lcg_next_sequence_bitwise():
    s1, s2 = _seeds()
    js = JR.lcg_init(jnp.asarray(s1), jnp.asarray(s2), xp=jnp)
    ts = TR.lcg_init(torch.as_tensor(s1), torch.as_tensor(s2))
    for _ in range(8):
        js, jr = JR.lcg_next(js, xp=jnp)
        ts, tr = TR.lcg_next(ts)
        np.testing.assert_array_equal(np.asarray(jr), tr.numpy())
        np.testing.assert_array_equal(np.asarray(js[0]), ts[0].numpy())
        np.testing.assert_array_equal(np.asarray(js[1]), ts[1].numpy())


@pytest.mark.parametrize("draw", ["rand_float", "randd", "rand_uniform"])
def test_lcg_float_draws_bitwise(draw):
    s1, s2 = _seeds(seed=1)
    js = JR.lcg_init(jnp.asarray(s1), jnp.asarray(s2), xp=jnp)
    ts = TR.lcg_init(torch.as_tensor(s1), torch.as_tensor(s2))
    for _ in range(4):
        if draw == "rand_float":
            js, jv = JR.lcg_rand_float(js, xp=jnp)
            ts, tv = TR.lcg_rand_float(ts)
        elif draw == "randd":
            js, jv = JR.lcg_randd(js, xp=jnp)
            ts, tv = TR.lcg_randd(ts)
        else:
            js, jv = JR.lcg_rand_uniform(js, -2.5, 2.5, xp=jnp)
            ts, tv = TR.lcg_rand_uniform(ts, -2.5, 2.5)
        np.testing.assert_array_equal(np.asarray(jv, np.float32), tv.numpy())


def test_randgen_sequence_matches():
    a, b = JR.RandGen(7, 3), TR.RandGen(7, 3)
    for _ in range(200):
        assert a.rand() == b.rand()
        assert a.randd() == b.randd()
        assert a.rand_float() == b.rand_float()
        assert a.rand_int(-5, 17) == b.rand_int(-5, 17)
        assert a.rand_bool() == b.rand_bool()
        a.rand_mix()
        b.rand_mix()
    assert (a.s1, a.s2) == (b.s1, b.s2)


@pytest.mark.parametrize("seed", [0, 1, 0xE05, 2**32 - 7])
def test_xxhash_u32_bitwise(seed):
    buf = np.random.default_rng(2).integers(0, 2**32, 5000, dtype=np.uint64)
    buf = np.concatenate([buf, [0, 1, 2**32 - 1, 2**31]]).astype(np.uint32)
    ref = np.asarray(JR.xxhash_u32(jnp.asarray(buf), seed=seed))
    out = TR.xxhash_u32(torch.as_tensor(buf.astype(np.int64)), seed=seed)
    np.testing.assert_array_equal(ref.astype(np.int64), out.numpy())


@pytest.mark.parametrize("num,xs,ys,pad", [(150, 32, 32, 0), (1000, 128, 96, 4)])
def test_droplet_starts_bitwise(num, xs, ys, pad):
    jx, jz = JE.droplet_starts(num, xs, ys, pad=pad)
    tx, tz = TE.droplet_starts(num, xs, ys, pad=pad, device="cpu")
    np.testing.assert_array_equal(np.asarray(jx), tx.numpy())
    np.testing.assert_array_equal(np.asarray(jz), tz.numpy())

"""Torch port vs JAX package: the tiled-terrain fauna (`veg/animals`:
`make_animals`, `step_flock`, `step_birds`, `gen_fish`, `step_fish`,
`make_butterflies`, `step_butterflies`, `step_tiled_fauna`) on a 64^2
mesh that is partly under the water plane, with the JAX draws injected
(`jax_fauna_draws`, `jax_spawn_rows`).

Tolerances: kinds and the butterflies' flags equal; positions and
velocities within 1e-5 over 8 chained frames (sums over neighbors add in
another order in the two packages).  The JAX chain runs op by op
(`jax.disable_jit`): compiled, XLA fuses the fish step's arithmetic
around its mesh sample, and a fish at the shallow-water edge turns back
in one program and not in the other (6e-4 apart after 8 frames; the op
by op JAX step equals the port's bit for bit)."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import w3d  # noqa: F401
from w3d.veg import animals as JVA
from w3d.utils.constants import WorldConst as JWorld

from w3d_torch import convert
from w3d_torch.veg import animals as TVA
from w3d_torch.utils.constants import WorldConst as TWorld

from torch_port_util import jax_fauna_draws, jax_spawn_rows, np_tree

JW, TW = JWorld(mesh_x=64, mesh_y=64), TWorld(mesh_x=64, mesh_y=64)
WATER = -0.4


def _same(a, b, tol=1e-5, what=""):
    a, b = convert.to_numpy(a), np_tree(b)
    for f in b._fields:
        x, y = np.asarray(getattr(a, f)), np.asarray(getattr(b, f))
        assert x.shape == y.shape, (what, f)
        if y.dtype.kind == "f":
            np.testing.assert_allclose(x, y, rtol=0, atol=tol, err_msg=f"{what}.{f}")
        else:
            np.testing.assert_array_equal(x, y, err_msg=f"{what}.{f}")


@pytest.fixture(scope="module")
def mesh():
    """A smooth 64^2 mesh, a basin below the water plane in its middle."""
    y, x = np.mgrid[0:64, 0:64].astype(np.float32) / 63.0
    m = 0.6 * ((x - 0.5) ** 2 + (y - 0.5) ** 2) * 4.0 - 0.9 \
        + 0.05 * np.sin(9.0 * x) * np.cos(7.0 * y)
    return m.astype(np.float32)


def test_spawns_match(mesh):
    fk = jax.random.key(1 ^ 0xFA0A)
    jb = JVA.make_animals(fk, 16, JVA.A_BIRD, center=(0.0, 0.0, 1.0))
    tb = TVA.make_animals(jax_spawn_rows(fk, "animals", 16), TVA.A_BIRD, center=(0.0, 0.0, 1.0))
    _same(tb, jb, 0.0, "birds")
    k1 = jax.random.fold_in(fk, 1)
    _same(TVA.make_butterflies(jax_spawn_rows(k1, "butterflies", 16, JW)),
          JVA.make_butterflies(k1, 16, JW), 1e-7, "butterflies")
    k2 = jax.random.fold_in(fk, 2)
    jf = JVA.gen_fish(k2, 64, jnp.asarray(mesh), WATER, JW)
    tf = TVA.gen_fish(jax_spawn_rows(k2, "fish", 64, JW), torch.as_tensor(mesh), WATER, TW)
    _same(tf, jf, 1e-6, "fish")
    alive = int((np.asarray(jf.kind) >= 0).sum())
    assert 0 < alive < 64     # some fish over the basin, some over dry land


def test_tiled_fauna_chunks_match(mesh):
    """Two chunks of 8 chained frames (birds, butterflies, fish), the
    player beside the basin so some fish flee."""
    fk = jax.random.key(3 ^ 0xFA0A)
    jb = JVA.make_animals(fk, 16, JVA.A_BIRD, center=(0.0, 0.0, 1.0))
    jf = JVA.make_butterflies(jax.random.fold_in(fk, 1), 16, JW)
    ju = JVA.gen_fish(jax.random.fold_in(fk, 2), 32, jnp.asarray(mesh), WATER, JW)
    tb, tf, tu = (convert.animal_state(np_tree(jb), "cpu"),
                  convert.butterfly_state(np_tree(jf), "cpu"),
                  convert.animal_state(np_tree(ju), "cpu"))
    tmesh = torch.as_tensor(mesh)
    for c, (px, py) in enumerate(((0.1, 0.0), (0.9, -0.3))):
        key = jax.random.fold_in(fk, 100 + 8 * c)
        with jax.disable_jit():
            jb, jf, ju = JVA.step_tiled_fauna(jb, jf, ju, key, jnp.asarray(mesh), JW, WATER,
                                              px, py, frames=8)
        tb, tf, tu = TVA.step_tiled_fauna(tb, tf, tu, jax_fauna_draws(key, 8, 16, 16, 32),
                                          tmesh, TW, WATER, px, py, frames=8)
        _same(tb, jb, 1e-5, f"birds {c}")
        _same(tf, jf, 1e-5, f"butterflies {c}")
        _same(tu, ju, 1e-5, f"fish {c}")
    assert np.abs(np.asarray(ju.px) - np.asarray(JVA.gen_fish(
        jax.random.fold_in(fk, 2), 32, jnp.asarray(mesh), WATER, JW).px)).max() > 1e-3


def test_flock_step_matches():
    fk = jax.random.key(7)
    ja = JVA.make_animals(fk, 24, JVA.A_BIRD, center=(0.0, 0.0, 1.0), spread=0.3)
    ta = convert.animal_state(np_tree(ja), "cpu")
    for _ in range(6):
        ja = JVA.step_flock(ja, 0.7, 1.2)
        ta = TVA.step_flock(ta, 0.7, 1.2)
    _same(ta, ja, 1e-5, "flock")

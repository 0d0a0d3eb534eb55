"""Torch port vs JAX package: ray casts (`ops/ray`).

`ray_cobjs_nearest` on the seven-shape scene (every shape family, the
torus's Newton refinement, dead padding slots and a carved cube), with and
without exits: the hit mask and the nearest slot equal wherever the gap
between the nearest and the second-nearest slot exceeds 1e-4; t, the
normal and the exit within 1e-5 there.  The stepped and the cell-walking
heightfield intersectors on a bumpy 32^2 mesh: hits equal, t within 1e-5.
`cosine_hemisphere_dirs` from the JAX draws within 1e-6.

The JAX `ray_cobjs_nearest` reads the nearest slot's normal and exit as
sums of one-hot rows, so one NaN anywhere in a ray's row makes its normal
NaN: a torus slot's normal evaluated at its miss value t = 1e30 overflows
to NaN, and every ray's JAX normal is NaN on a scene with a torus.  The
port gathers the nearest slot's values.  `_jax_at_nearest` builds the JAX
function's per-slot normals and exits from its own `_isect_*` families and
takes them at its argmin, which is the reference the port is held to."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import w3d  # noqa: F401
from w3d.ops import ray as JR
from w3d.scene import cobj as JSC
from w3d.utils.constants import WorldConst as JWorld

from w3d_torch import convert
from w3d_torch.ops import ray as TR
from w3d_torch.utils.constants import WorldConst as TWorld

from torch_port_util import np_tree, seven_shape_scene

N = 384


def _scene():
    jc = JSC.pack_cobjs(seven_shape_scene(JSC))
    return jc, convert.cobj_set(np_tree(jc), "cpu")


def _rays(seed, n=N):
    """Origins in [-3, 3]^3, directions unnormalized, tmax in [1, 6]; a
    quarter of the rays start inside the scene's spheres and tori's
    bounding spheres (near the origin), so inside-out hits happen too."""
    rg = np.random.default_rng(seed)
    o = rg.uniform(-3, 3, (3, n)).astype(np.float32)
    o[:, : n // 4] *= 0.3
    d = rg.normal(0, 1, (3, n)).astype(np.float32) * rg.uniform(0.5, 2.0, n).astype(np.float32)
    d[2, :8] = 0.0                       # rays parallel to the xy plane
    d[0, 8:16] = 0.0
    tmax = rg.uniform(1.0, 6.0, n).astype(np.float32)
    return [*o, *d, tmax]


def _second_gap(args, tc):
    """Per ray, second-nearest minus nearest slot t (the port's per-slot t:
    each slot alone in the set, the others dead); infinite for a ray that
    hits nothing."""
    M = tc.size
    t = np.full((N, M), 1e30, np.float32)
    for m in range(M):
        if int(tc.shape[m]) == 0:
            continue
        one = tc._replace(shape=torch.where(torch.arange(M) == m, tc.shape, 0))
        t[:, m] = TR.ray_cobjs_nearest(*args, one)[1].numpy()
    s = np.sort(t, axis=1)
    return np.where(s[:, 0] >= 1e30, np.inf, s[:, 1] - s[:, 0])


def _jax_at_nearest(rays, c, idx):
    """The JAX function's normals and exits at slot `idx` of each ray, its
    select over every family without the one-hot sums."""
    ox, oy, oz, dx, dy, dz, _ = (jnp.asarray(a)[:, None] for a in rays)
    inv = lambda d: 1.0 / jnp.where(jnp.abs(d) < JR._EPS, jnp.where(d < 0, -JR._EPS, JR._EPS), d)
    a = dx * dx + dy * dy + dz * dz
    args = (c, ox, oy, oz, dx, dy, dz)
    fam = JR._isect_tapered(*args, a, want_caps=True, want_rcyl=True)
    cands = [(JSC.COLL_CUBE, JR._isect_cube(*args, inv(dx), inv(dy), inv(dz))),
             (JSC.COLL_CYLINDER, JR._isect_vcyl(*args, inv(dz))),
             (JSC.COLL_POLYGON, JR._isect_polygon(*args)),
             (JSC.COLL_CAPSULE, fam["caps"]), (JSC.COLL_CYLINDER_ROT, fam["rcyl"]),
             (JSC.COLL_TORUS, JR._isect_torus(*args, a)),
             (JSC.COLL_SPHERE, JR._isect_sphere(*args, a))]
    preds = [c.shape == k for k, _ in cands]
    t_all = jnp.select(preds, [v[0] for _, v in cands], default=jnp.float32(JR._BIG))
    out = [jnp.select(preds, [v[1][k] for _, v in cands], default=jnp.float32(d))
           for k, d in enumerate((0.0, 0.0, 1.0))]
    tx = jnp.select(preds, [v[2] for _, v in cands], default=jnp.float32(JR._BIG))
    out.append(jnp.maximum(tx, t_all))
    i = jnp.asarray(idx)[:, None]
    return [np.asarray(jnp.take_along_axis(v, i, axis=1)[:, 0]) for v in out]


@pytest.mark.parametrize("with_exit", [False, True])
def test_ray_cobjs_nearest_matches_jax(with_exit):
    jc, tc = _scene()
    rays = _rays(4 + with_exit)
    jout = JR.ray_cobjs_nearest(*(jnp.asarray(a) for a in rays), jc, with_exit=with_exit)
    targs = [torch.as_tensor(a) for a in rays]
    tout = TR.ray_cobjs_nearest(*targs, tc, with_exit=with_exit)
    jhit, jt, jn = np.asarray(jout[0]), np.asarray(jout[1]), [np.asarray(a) for a in jout[2:5]]
    jidx = np.argmax(np.asarray(jout[5]), axis=1)
    gap = _second_gap(targs, tc)
    robust = gap > 1e-4
    assert robust.mean() > 0.9
    np.testing.assert_array_equal(tout[0].numpy()[robust], jhit[robust])
    hit = jhit & robust
    assert 0.2 * N < hit.sum() < N       # hits and misses both happen
    np.testing.assert_array_equal(tout[5].numpy()[hit], jidx[hit])
    np.testing.assert_allclose(tout[1].numpy()[hit], jt[hit], rtol=0, atol=1e-5)
    assert np.isnan(jn[0]).all()          # the one-hot sums' NaN (docstring)
    ref = _jax_at_nearest(rays, jc, jidx)
    for a, b in zip(tout[2:5], ref[:3]):
        np.testing.assert_allclose(a.numpy()[hit], b[hit], rtol=0, atol=1e-5)
    if with_exit:
        np.testing.assert_allclose(tout[6].numpy()[hit], ref[3][hit], rtol=0, atol=1e-5)
    # every family took part: nearest hits on each shape
    shapes = tc.shape.numpy()[tout[5].numpy()[hit]]
    assert set(shapes.tolist()) == {1, 2, 3, 4, 5, 6, 7}
    assert TR.present_types(tc) == JR.present_types(jc)


def test_ray_cobjs_nearest_present_subset():
    """Naming the present families gives the same answers as testing all."""
    _, tc = _scene()
    args = [torch.as_tensor(a) for a in _rays(9)]
    a = TR.ray_cobjs_nearest(*args, tc, present=TR.present_types(tc))
    b = TR.ray_cobjs_nearest(*args, tc)
    for x, y in zip(a, b):
        torch.testing.assert_close(x, y, rtol=0, atol=0)


def _bumpy(seed=2):
    rg = np.random.default_rng(seed)
    y, x = np.mgrid[0:32, 0:32] / 4.0
    return (0.3 * np.sin(x + rg.uniform(0, 6)) * np.cos(0.8 * y)
            + 0.05 * rg.standard_normal((32, 32))).astype(np.float32)


@pytest.mark.parametrize("which", ["stepped", "dda"])
def test_ray_heightfield_matches_jax(which):
    mesh = _bumpy()
    jw, tw = JWorld(mesh_x=32, mesh_y=32), TWorld(mesh_x=32, mesh_y=32)
    rg = np.random.default_rng(11)
    n = 256
    o = np.stack([rg.uniform(-3.5, 3.5, n), rg.uniform(-3.5, 3.5, n),
                  rg.uniform(0.2, 1.5, n)]).astype(np.float32)
    d = np.stack([rg.normal(0, 1, n), rg.normal(0, 1, n),
                  -rg.uniform(0.05, 0.6, n)]).astype(np.float32)
    o[:, :16] = [[5.5], [0.0], [0.5]]        # starts off the mesh
    tmax = rg.uniform(2.0, 8.0, n).astype(np.float32)
    rays = [*o, *d, tmax]
    if which == "stepped":
        jh, jt = JR.ray_heightfield(*(jnp.asarray(a) for a in rays), jnp.asarray(mesh), jw)
        th, tt = TR.ray_heightfield(*(torch.as_tensor(a) for a in rays),
                                    torch.as_tensor(mesh), tw)
    else:
        jh, jt = JR.ray_heightfield_dda(*(jnp.asarray(a) for a in rays), jnp.asarray(mesh),
                                        jw, max_cells=64)
        th, tt = TR.ray_heightfield_dda(*(torch.as_tensor(a) for a in rays),
                                        torch.as_tensor(mesh), tw, max_cells=64)
    jh, jt = np.asarray(jh), np.asarray(jt)
    np.testing.assert_array_equal(th.numpy(), jh)
    assert 0.2 * n < jh.sum() < n
    np.testing.assert_allclose(tt.numpy()[jh], jt[jh], rtol=0, atol=1e-5)


def test_cosine_hemisphere_dirs_matches_jax():
    key = jax.random.key(5)
    shape = (300,)
    rg = np.random.default_rng(1)
    n = rg.normal(0, 1, (3, 300)).astype(np.float32)
    n /= np.linalg.norm(n, axis=0)
    jd = JR.cosine_hemisphere_dirs(key, *(jnp.asarray(a) for a in n), shape)
    ku, kv = jax.random.split(key)
    u, v = np.array(jax.random.uniform(ku, shape)), np.array(jax.random.uniform(kv, shape))
    td = TR.cosine_hemisphere_dirs(torch.as_tensor(u), torch.as_tensor(v),
                                   *(torch.as_tensor(a) for a in n))
    for a, b in zip(td, jd):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-6)

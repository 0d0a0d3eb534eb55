"""Torch port vs JAX package: weather (`water/snow`, `water/precip`,
`water/clouds`) on seeded inputs, the JAX threefry draws fed to the port
(`SnowDraws`, `PrecipDraws`).

Tolerances:
- snow: one batch of 4,096 flakes over a bumpy 32^2 mesh and a scene
  with flat tops, a steep ramp (deflections) and spheres: cells, the
  valid mask and the deflection count exact, landing z within 1e-6; a
  map of 2 batches: counts exact, `snow_z` within rtol 3e-5 / atol 1e-6
  (the port sums each cell in a fixed order, `lighting/lmap.cell_sums`,
  the JAX package scatter-adds in another); the map file the same `.npz`
  both ways.  The JAX snow batch runs op by op (`jax.disable_jit`), as
  do the draws.
- precipitation: spawn, accumulation (the cells truncated toward zero
  then clipped, the rain volume) and melt exact.
- clouds: the layer within 1e-6 of the JAX function op by op, and within
  2e-6 of the compiled one (XLA contracts the scroll's products); the
  local wind within 1e-6; lightning paths exact (host LCG)."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import w3d  # noqa: F401
from w3d.water import snow as JSN, precip as JPR, clouds as JCL
from w3d.scene import cobj as JSC
from w3d.physics import types as JPT, step as JPS
from w3d.utils import rng as JRNG
from w3d.utils.constants import WorldConst as JWorld

from w3d_torch import convert
from w3d_torch.water import snow as TSN, precip as TPR, clouds as TCL
from w3d_torch.scene import cobj as TSC
from w3d_torch.physics import types as TPT, step as TPS
from w3d_torch.utils.constants import WorldConst as TWorld

from torch_port_util import one_torch_thread, same_tree  # noqa: F401

N = 32
JW, TW = JWorld(mesh_x=N, mesh_y=N), TWorld(mesh_x=N, mesh_y=N)


def _scene(SC, device=None):
    """Two flat-topped cubes, a steep ramp (nz ~ 0.27: flakes deflect off
    it) and three spheres, packed by the given package."""
    sp = SC.SceneParse()
    lay = SC.CobjLayer()
    sp.cobjs.append(SC.RawCobj(SC.COLL_CUBE, (-2.0, -2.0, -0.6), (-0.5, -0.5, 0.4),
                               layer=lay))
    sp.cobjs.append(SC.RawCobj(SC.COLL_CUBE, (1.0, -2.5, -0.6), (2.5, -1.0, 0.9),
                               layer=lay))
    sp.cobjs.append(SC.RawCobj(SC.COLL_POLYGON, pts=(
        (0.2, -0.5, -0.8), (0.9, -0.5, 1.5), (0.9, 2.0, 1.5), (0.2, 2.0, -0.8)),
        r1=0.0, layer=lay))
    for i, (x, y, r) in enumerate(((-1.5, 1.5, 0.5), (2.0, 2.0, 0.3), (-2.5, 0.0, 0.4))):
        sp.cobjs.append(SC.RawCobj(SC.COLL_SPHERE, (x, y, 0.2 * i), r1=r, layer=lay))
    return SC.pack_cobjs(sp) if device is None else SC.pack_cobjs(sp, device=device)


@pytest.fixture(scope="module")
def snow_scene():
    rng = np.random.default_rng(4)
    mesh = (0.2 * rng.standard_normal((N, N)) - 0.5).astype(np.float32)
    return mesh, _scene(JSC), _scene(TSC, "cpu")


def jax_snow_draws(key, batch, world):
    """The draws of the JAX `snow_batch(key, ...)`, op by op: the start
    from `split(key)`, each deflection round's normals from
    `kd, ka, kb = split(kd, 3)` with `kd` starting at `key`."""
    with jax.disable_jit():
        k1, k2 = jax.random.split(key)
        x = jax.random.uniform(k1, (batch,), minval=-world.x_scene, maxval=world.x_scene)
        y = jax.random.uniform(k2, (batch,), minval=-world.y_scene, maxval=world.y_scene)
        kd, na, nb = key, [], []
        for _ in range(JSN.MAX_DEFLECT - 1):
            kd, ka, kb = jax.random.split(kd, 3)
            na.append(jax.random.normal(ka, (batch,)))
            nb.append(jax.random.normal(kb, (batch,)))
    return TSN.SnowDraws(*(torch.as_tensor(np.array(a)) for a in
                           (x, y, np.stack(na), np.stack(nb))))


class JaxSnowDraws(TSN.SnowDrawSource):
    """The JAX `create_snow_map`'s per-batch keys, `key(seed, 0x5704, i)`."""

    def batch(self, i, batch, world, device):
        return jax_snow_draws(JRNG.key(self.seed, 0x5704, i), batch, JW)


def test_snow_batch_matches(snow_scene):
    mesh, jc, tc = snow_scene
    key = JRNG.key(3, 0x5704, 0)
    wind = (0.4, 0.2, 0.0)
    with jax.disable_jit():
        jcell, jz, jok = JSN.snow_batch(key, jnp.asarray(mesh), jc,
                                        jnp.asarray(wind, jnp.float32), JW, 4096)
    cell, z, ok = TSN.snow_batch(jax_snow_draws(key, 4096, JW), torch.as_tensor(mesh),
                                 tc, torch.tensor(wind), TW)
    np.testing.assert_array_equal(cell.numpy(), np.asarray(jcell))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(jok))
    np.testing.assert_allclose(z.numpy(), np.asarray(jz), rtol=0, atol=1e-6)
    zs = np.asarray(jz)
    # some flakes stopped on the cube tops, some on the mesh
    assert (np.abs(zs - 0.4) < 1e-4).sum() > 20 and (zs < 0.0).sum() > 1000


def test_snow_deflects_like_jax(snow_scene):
    """The ramp sheds flakes: with no deflection rounds the same draws
    stop on it; with them, the same flakes move on, in both packages."""
    mesh, jc, tc = snow_scene
    key = JRNG.key(5, 0x5704, 0)
    d = jax_snow_draws(key, 4096, JW)
    zero = torch.zeros(3)
    _, z_def, _ = TSN.snow_batch(d, torch.as_tensor(mesh), tc, zero, TW)
    moved = TSN.snow_batch(d._replace(na=d.na * 0, nb=d.nb * 0), torch.as_tensor(mesh),
                           tc, zero, TW)[1]
    with jax.disable_jit():
        jz = JSN.snow_batch(key, jnp.asarray(mesh), jc, jnp.zeros(3), JW, 4096)[1]
    np.testing.assert_allclose(z_def.numpy(), np.asarray(jz), rtol=0, atol=1e-6)
    assert int((z_def != moved).sum()) > 10     # the lateral steps changed landings


def test_snow_map_matches(snow_scene, tmp_path):
    mesh, jc, tc = snow_scene
    with jax.disable_jit():
        jz, jcnt = JSN.create_snow_map(jnp.asarray(mesh), jc, 8192, world=JW, seed=2,
                                       batch=4096)
    z, cnt = TSN.create_snow_map(torch.as_tensor(mesh), tc, 8192, world=TW, seed=2,
                                 batch=4096, draws=JaxSnowDraws(2))
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(jcnt))
    np.testing.assert_allclose(z.numpy(), np.asarray(jz), rtol=3e-5, atol=1e-6)
    assert float(cnt.sum()) > 7000
    # the map file: the same .npz both ways
    pj, pt = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    JSN.save_snow_map(pj, jz, jcnt)
    TSN.save_snow_map(pt, z, cnt)
    lz, lc = TSN.load_snow_map(pj, device="cpu")
    np.testing.assert_array_equal(lz.numpy(), np.asarray(jz))
    np.testing.assert_array_equal(lc.numpy(), np.asarray(jcnt))
    jlz, jlc = JSN.load_snow_map(pt)
    np.testing.assert_array_equal(np.asarray(jlz), z.numpy())
    np.testing.assert_array_equal(np.asarray(jlc), cnt.numpy())


def test_snow_map_default_draws_run(snow_scene):
    mesh, _, tc = snow_scene
    z, cnt = TSN.create_snow_map(torch.as_tensor(mesh), tc, 4096, world=TW, batch=2048)
    z2, cnt2 = TSN.create_snow_map(torch.as_tensor(mesh), tc, 4096, world=TW, batch=2048)
    assert torch.equal(z, z2) and torch.equal(cnt, cnt2)
    assert z.shape == (N, N) and bool(torch.isfinite(z).all())


def _states(n=256, seed=7):
    """The same object state in both packages: random positions over the
    scene (some off the map), statuses 0-4, precipitation and ball types."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-1.2 * JW.x_scene, 1.2 * JW.x_scene, (n, 3)).astype(np.float32)
    otype = rng.choice([JPT.type_id(k) for k in ("RAIN", "SNOW", "HAIL", "BALL")],
                       n).astype(np.int32)
    jst = JPS.make_state(pos, np.zeros((n, 3), np.float32), otype, JPT.make_type_table())
    jst = jst._replace(status=jnp.asarray(rng.integers(0, 5, n).astype(np.int32)))
    return jst, convert.object_state(jax.tree.map(np.asarray, jst), "cpu")


def test_spawn_precip_matches():
    jst, tst = _states()
    key = jax.random.key(1)
    ks = jax.random.split(key, 3)
    draws = TPR.PrecipDraws(*(torch.as_tensor(np.array(a)) for a in (
        jax.random.uniform(ks[0], (64,), minval=-JW.x_scene, maxval=JW.x_scene),
        jax.random.uniform(ks[1], (64,), minval=-JW.y_scene, maxval=JW.y_scene),
        jax.random.normal(ks[2], (64,)))))
    for kind in ("RAIN", "SNOW", "HAIL"):
        ref = JPR.spawn_precip(jst, key, 64, kind, JW, cloud_z=0.7)
        out = TPR.spawn_precip(tst, draws, kind, TW, cloud_z=0.7)
        same_tree(out, ref, 0.0, kind)
    # more drops than dead slots: only the dead slots take one
    n_dead = int((np.asarray(jst.status) == 0).sum())
    big = TPR.PrecipDraws(*(torch.zeros(n_dead + 10) for _ in range(3)))
    out = TPR.spawn_precip(tst, big, "RAIN", TW)
    assert int((out.status > 0).sum()) == len(out.status)


def test_accumulate_retire_melt_match():
    jst, tst = _states(seed=9)
    rng = np.random.default_rng(1)
    acc = rng.uniform(0, 2, (N, N)).astype(np.float32)
    ja, jv, jl = JPR.accumulate_landed(jnp.asarray(acc), jst, None, JW)
    ta, tv, tl = TPR.accumulate_landed(torch.as_tensor(acc), tst, None, TW)
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    assert float(tv) == float(jv) and float(jv) > 0
    assert float((ta - torch.as_tensor(acc)).sum()) > 10
    same_tree(TPR.retire_landed(tst, tl), JPR.retire_landed(jst, jl), 0.0, "retire")
    for temp in (2.0, 20.0, -5.0, 3.7):
        np.testing.assert_array_equal(TPR.melt_accumulation(ta, temp).numpy(),
                                      np.asarray(JPR.melt_accumulation(ja, jnp.float32(temp))))


def test_cloud_layer_matches():
    for t, seed in ((0.0, 0), (13.7, 3)):
        out = TCL.cloud_layer(t, 0.4, -0.3, 48, 40, density=0.6, octaves=5, seed=seed,
                              device="cpu").numpy()
        with jax.disable_jit():
            ref = np.asarray(JCL.cloud_layer(t, 0.4, -0.3, 48, 40, 0.6, 5, seed))
        np.testing.assert_allclose(out, ref, rtol=0, atol=1e-6)
        jit = np.asarray(JCL.cloud_layer(t, 0.4, -0.3, 48, 40, 0.6, 5, seed))
        np.testing.assert_allclose(out, jit, rtol=0, atol=2e-6)
        assert out.shape == (40, 48) and 0 < out.mean() < 1


def test_local_wind_and_lightning_match():
    rng = np.random.default_rng(3)
    p = rng.uniform(-3, 3, (3, 500)).astype(np.float32)
    ref = JCL.local_wind(*(jnp.asarray(a) for a in p), (0.4, 0.2, 0.05), 2.5, 0.3, 1)
    out = TCL.local_wind(*(torch.as_tensor(a) for a in p), (0.4, 0.2, 0.05), 2.5, 0.3, 1)
    for a, b in zip(out, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-6)
    for seed in (0, 7, 123):
        assert TCL.gen_lightning_strike(seed, 2.0, 0.1, 0.5, -0.5) == \
            JCL.gen_lightning_strike(seed, 2.0, 0.1, 0.5, -0.5)

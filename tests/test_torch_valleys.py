"""Torch port vs JAX package: valley water (`water/valleys`,
`models/world.with_valley_water`).

Meshes built here: the two bowls of tests/test_water.py, a 64^2 terrain of
seeded sines with noise (dozens of basins), a terraced map with flat
plateaus (the flat-cell flow rule) and the ridge of the float-downstream
case.  Watershed labels bitwise; basin levels and the water matrix within
1e-5 of the mesh's height span (the port sums each basin in a fixed
pairwise order, the JAX package in scatter order, and the bisection
compares those sums); the wet mask equal wherever the water surface is
farther than that from the ground; spill points, saddles and merges of
`update_valleys` equal; `float_downstream` within 1e-6."""

import types

import numpy as np
import pytest
import jax.numpy as jnp
import torch

import w3d  # noqa: F401
from w3d.models import world as JWM
from w3d.physics import step as JPS
from w3d.utils.constants import WorldConst as JWorld
from w3d.water import valleys as JV

from w3d_torch.models import world as TWM
from w3d_torch.physics import step as TPS
from w3d_torch.utils.constants import WorldConst as TWorld
from w3d_torch.water import valleys as TV


def _bowls(n=64):
    yy, xx = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    return np.minimum(0.001 * ((xx - 20) ** 2 + (yy - 32) ** 2),
                      0.001 * ((xx - 44) ** 2 + (yy - 32) ** 2)).astype(np.float32)


def _terrain(n=64, seed=3):
    rg = np.random.default_rng(seed)
    y, x = np.mgrid[0:n, 0:n] / 6.0
    f = sum(rg.uniform(0.3, 1.0) * np.sin(rg.uniform(0.5, 2.0) * x + rg.uniform(0, 6))
            * np.cos(rg.uniform(0.5, 2.0) * y + rg.uniform(0, 6)) for _ in range(4))
    return (0.2 * f + 0.02 * rg.standard_normal((n, n))).astype(np.float32)


def _terraced(n=48):
    return (np.floor(_terrain(n, 5) * 8.0) / 8.0).astype(np.float32)


MESHES = {"bowls": _bowls, "terrain": _terrain, "terraced": _terraced}


def _volumes(labels, seed, scale):
    """A volume at every basin minimum (random, some basins dry)."""
    rg = np.random.default_rng(seed)
    vol = np.zeros(labels.size, np.float32)
    for b in np.unique(labels):
        vol[b] = rg.uniform(0.0, scale) if rg.uniform() < 0.8 else 0.0
    return vol


@pytest.mark.parametrize("name", sorted(MESHES))
def test_fill_valleys_matches_jax(name):
    mesh = MESHES[name]()
    n = mesh.shape[0]
    jw, tw = JWorld(mesh_x=n, mesh_y=n), TWorld(mesh_x=n, mesh_y=n)
    jlab = np.asarray(JV.watershed_labels(jnp.asarray(mesh)))
    tlab = TV.watershed_labels(torch.as_tensor(mesh))
    np.testing.assert_array_equal(tlab.numpy(), jlab)
    np.testing.assert_array_equal(TV.flow_directions(torch.as_tensor(mesh)).numpy(),
                                  np.asarray(JV.flow_directions(jnp.asarray(mesh))))
    nb = len(np.unique(jlab))
    assert nb >= 2 if name == "bowls" else nb > 10
    span = float(mesh.max() - mesh.min())
    vol = _volumes(jlab, 1, 0.05 if name == "bowls" else 0.01)
    jout = JV.fill_valleys(jnp.asarray(mesh), jnp.asarray(vol), jw)
    tout = TV.fill_valleys(torch.as_tensor(mesh), torch.as_tensor(vol), tw)
    np.testing.assert_array_equal(tout[0].numpy(), np.asarray(jout[0]))
    for k in (1, 2):
        d = np.abs(tout[k].numpy().astype(np.float64) - np.asarray(jout[k])).max()
        assert d <= 1e-5 * span, (k, d, span)
    water = np.asarray(jout[2])
    clear = np.abs(water - mesh) > 1e-5 * span
    np.testing.assert_array_equal(tout[3].numpy()[clear], np.asarray(jout[3])[clear])
    wet = tout[3].numpy().mean()
    assert 0.02 < wet < 0.9, wet
    # the filled volumes are what was asked, basin by basin
    depth = np.maximum(tout[2].numpy() - mesh, 0.0).reshape(-1)
    got = np.zeros(n * n)
    np.add.at(got, jlab, depth * tw.dxdy)
    live = vol > 0
    assert np.abs(got[live] - vol[live]).max() < 1e-3 * max(vol.max(), 1e-6) + 1e-4 * span


def test_segment_sum_is_a_fixed_order_sum():
    """SegmentSum equals the float64 sum within float32 rounding, and is
    the same across calls and label layouts of the same sets."""
    rg = np.random.default_rng(2)
    labels = torch.as_tensor(rg.integers(0, 50, 5000))
    vals = torch.as_tensor(rg.uniform(-1, 1, 5000).astype(np.float32))
    ss = TV.SegmentSum(labels, 64)
    out = ss(vals)
    ref = np.zeros(64)
    np.add.at(ref, labels.numpy(), vals.numpy().astype(np.float64))
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-4)
    assert torch.equal(out, TV.SegmentSum(labels, 64)(vals))
    assert len(ss.levels) == 2 and (out[50:] == 0).all()


@pytest.mark.parametrize("volume,merged_basins", [(3.0, 1), (0.02, 2)])
def test_update_valleys_matches_jax(volume, merged_basins):
    """tests/test_gaps.py::test_valley_spillover: overfilling the left bowl
    spills into the right one and the basins merge; a small volume
    keeps them apart."""
    mesh = (2.0 * _bowls()).astype(np.float32)
    jw, tw = JWorld(mesh_x=64, mesh_y=64), TWorld(mesh_x=64, mesh_y=64)
    jlab = JV.watershed_labels(jnp.asarray(mesh))
    left = int(np.asarray(jlab)[32 * 64 + 20])
    vol = np.zeros(64 * 64, np.float32)
    vol[left] = volume
    jz, jwater, jwet, jm = JV.update_valleys(jnp.asarray(mesh), jlab, jnp.asarray(vol), jw)
    tz, twater, twet, tm = TV.update_valleys(torch.as_tensor(mesh),
                                             torch.as_tensor(np.array(jlab)),
                                             torch.as_tensor(vol), tw)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    assert len(np.unique(tm.numpy())) == merged_basins
    span = float(mesh.max() - mesh.min())
    assert np.abs(twater.numpy() - np.asarray(jwater)).max() <= 1e-5 * span
    assert TV.basin_saddles(torch.as_tensor(mesh), tm) == \
        JV.basin_saddles(jnp.asarray(mesh), jm)


def test_rain_spill_points_and_float_downstream_match_jax():
    """tests/test_water.py's rain accumulation and float-downstream
    cases."""
    W = JWorld(mesh_x=32, mesh_y=32)
    TW = TWorld(mesh_x=32, mesh_y=32)
    rain_mesh = np.random.default_rng(0).normal(0, 0.1, (32, 32)).astype(np.float32)
    jlab = JV.watershed_labels(jnp.asarray(rain_mesh))
    jvol = JV.add_rain_volume(jnp.zeros(32 * 32), jlab, 32, 32, 0.01, W)
    tvol = TV.add_rain_volume(torch.zeros(32 * 32), torch.as_tensor(np.array(jlab)),
                              32, 32, 0.01, TW)
    np.testing.assert_allclose(tvol.numpy(), np.asarray(jvol), rtol=1e-6, atol=0)
    yy, xx = np.meshgrid(np.arange(32), np.arange(32), indexing="ij")
    m = (np.minimum(np.abs(xx - 8), np.abs(xx - 24)) * 0.1
         + 0.001 * np.abs(yy - 16)).astype(np.float32)
    jlab = JV.watershed_labels(jnp.asarray(m))
    tlab = TV.watershed_labels(torch.as_tensor(m))
    jsp = JV.basin_spill_points(jnp.asarray(m), jlab)
    tsp = TV.basin_spill_points(torch.as_tensor(m), tlab)
    for a, b in zip(tsp, jsp):
        np.testing.assert_array_equal(a, b)
    lab0 = int(np.asarray(jlab).reshape(32, 32)[16, 10])
    assert abs(jsp[2][lab0] - 0.8) < 0.1
    flow = np.zeros(len(jsp[0]), np.float32)
    flow[lab0] = 500.0
    rg = np.random.default_rng(6)
    px = rg.uniform(-3.5, 3.5, 64).astype(np.float32)
    py = rg.uniform(-3.5, 3.5, 64).astype(np.float32)
    pz = rg.uniform(0.5, 1.0, 64).astype(np.float32)
    rad = np.full(64, 0.01, np.float32)
    water = np.full((32, 32), 0.9, np.float32)
    jd = JV.float_downstream(*(jnp.asarray(a) for a in (px, py, pz, rad)), jlab,
                             jnp.asarray(water), jnp.asarray(m), *jsp, jnp.asarray(flow), W)
    td = TV.float_downstream(*(torch.as_tensor(a) for a in (px, py, pz, rad)), tlab,
                             torch.as_tensor(water), torch.as_tensor(m), *tsp,
                             torch.as_tensor(flow), TW)
    for a, b in zip(td, jd):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-6)
    assert (np.asarray(jd[0]) != 0).sum() > 5


def test_with_valley_water_matches_jax():
    """The water matrix reaches the physics env, and a frame of objects
    over it floats them where the valleys are wet."""
    mesh = _terrain(32, 7)
    jw, tw = JWorld(mesh_x=32, mesh_y=32), TWorld(mesh_x=32, mesh_y=32)
    lab = np.asarray(JV.watershed_labels(jnp.asarray(mesh)))
    vol = _volumes(lab, 3, 0.02)
    env = dict(water_plane_z=-5.0, wind=np.zeros(3, np.float32), temperature=20.0,
               base_gravity=1.0, zmin=-4.0)
    js = types.SimpleNamespace(world=jw, env=JPS.PhysicsEnv(
        mesh_height=jnp.asarray(mesh), **{k: jnp.asarray(v, jnp.float32)
                                          for k, v in env.items()}))
    ts = types.SimpleNamespace(world=tw, env=TPS.PhysicsEnv(
        mesh_height=torch.as_tensor(mesh), **{k: torch.as_tensor(np.float32(v))
                                              for k, v in env.items()}))
    js = JWM.with_valley_water(js, jnp.asarray(vol))
    ts = TWM.with_valley_water(ts, torch.as_tensor(vol))
    span = float(mesh.max() - mesh.min())
    d = np.abs(ts.env.water_height.numpy() - np.asarray(js.env.water_height)).max()
    assert d <= 1e-5 * span
    assert (ts.env.water_height.numpy() > mesh + 1e-3).mean() > 0.05

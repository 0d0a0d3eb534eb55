"""Torch port vs JAX package: the fBm terrain generators (simplex, perlin,
fBm, domain warp, `noise_zval_grid`), ground-mode `gen_terrain` in every
generator mode, and the tile path's fBm branch.

The JAX generators run op by op here, as their own callers run them
outside a jit; against that the port is bitwise (the same float32
operations in the same order, and a gradient table holding the values
`jnp.cos`/`jnp.sin` give).  `gen_terrain` is jitted in the JAX package;
compiled, XLA rounds the fused far-grid arguments (`freq * x + crx` at
coordinates up to ~1e6, where a float32 unit is 0.0625) otherwise, which
moves far-grid heights well past these tolerances, so the reference runs
under `jax.disable_jit`.
Tolerances there: `zmax_est` and every height within 1e-5 of the height
scale (`zmax_est`), the histogram per element the same (sine mode: float32
sines of the far grid's large arguments); erosion of the same heights
within 1e-5, as `tests/test_torch_terrain.py` holds it.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import w3d  # noqa: F401
from w3d.models import terrain_model as JTM
from w3d.ops import erosion as JE
from w3d.ops import noise as JN
from w3d.terrain import mesh as JM
from w3d.utils.constants import WorldConst as JWorld

from w3d_torch import convert
from w3d_torch.models import terrain_model as TTM
from w3d_torch.ops import erosion as TE
from w3d_torch.ops import noise as TN
from w3d_torch.terrain import mesh as TMESH
from w3d_torch.utils.constants import WorldConst as TWorld

from torch_port_util import jax_angle_tables, np_tree


def _grid(scale: float, seed: int = 0, shape=(24, 32)):
    rg = np.random.default_rng(seed)
    return [rg.uniform(-scale, scale, shape).astype(np.float32) for _ in range(2)]


def test_grad_hash_matches_jax():
    """Lattice hashes, negative indices included (int32 -> uint32 wrap)."""
    rg = np.random.default_rng(1)
    ix = rg.integers(-2**31, 2**31 - 1, 4096, dtype=np.int64).astype(np.int32)
    iy = rg.integers(-70000, 70000, 4096).astype(np.int32)
    for seed in (0, 7):
        ref = np.asarray(JN._grad_hash(jnp.asarray(ix), jnp.asarray(iy), seed))
        out = TN._grad_hash(torch.as_tensor(ix), torch.as_tensor(iy), seed)
        np.testing.assert_array_equal(ref.astype(np.int64), out.numpy())
    cs = TN._grad_table("cpu")
    ang = jnp.arange(8, dtype=jnp.float32) * (JN.TWO_PI / 8.0)
    np.testing.assert_array_equal(np.asarray(jnp.cos(ang)), cs[0].numpy())
    np.testing.assert_array_equal(np.asarray(jnp.sin(ang)), cs[1].numpy())


@pytest.mark.parametrize("name", ["simplex2d", "perlin2d"])
def test_noise_2d_matches_jax(name):
    x, y = _grid(60.0)
    ref = np.asarray(getattr(JN, name)(jnp.asarray(x), jnp.asarray(y), 3))
    out = getattr(TN, name)(torch.as_tensor(x), torch.as_tensor(y), 3).numpy()
    np.testing.assert_array_equal(ref, out)
    assert 0.3 < np.abs(out).max() <= 1.5


@pytest.mark.parametrize("mode", [JN.MGEN_SIMPLEX, JN.MGEN_PERLIN])
@pytest.mark.parametrize("shape", [JN.SHAPE_LINEAR, JN.SHAPE_BILLOWY, JN.SHAPE_RIDGED])
def test_fbm2d_matches_jax(mode, shape):
    x, y = _grid(0.5, seed=2)
    ref = np.asarray(JN.fbm2d(jnp.asarray(x), jnp.asarray(y), 1.3, 1.7,
                              mode=mode, shape=shape))
    out = TN.fbm2d(torch.as_tensor(x), torch.as_tensor(y), 1.3, 1.7,
                   mode=mode, shape=shape).numpy()
    np.testing.assert_array_equal(ref, out)


def test_domain_warp2d_matches_jax():
    x, y = _grid(0.5, seed=4, shape=(16, 16))
    ref = JN.domain_warp2d(jnp.asarray(x), jnp.asarray(y), 1.1, 1.6, octaves=5)
    out = TN.domain_warp2d(torch.as_tensor(x), torch.as_tensor(y), 1.1, 1.6,
                           octaves=5)
    for a, b in zip(ref, out):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    assert np.abs(out[0].numpy() - x).max() > 1e-3         # the warp moved points


@pytest.mark.parametrize("mode", [1, 2, 3, 4])
def test_noise_zval_grid_matches_jax(mode):
    xv, yv = np.meshgrid(np.arange(16, dtype=np.float32) - 8.0,
                         np.arange(16, dtype=np.float32) * 3.0 + 100.0)
    kw = dict(shape=JN.SHAPE_BILLOWY if mode == 2 else JN.SHAPE_LINEAR,
              mesh_seed=5 if mode == 3 else 0)
    ref = np.asarray(JN.noise_zval_grid(jnp.asarray(xv), jnp.asarray(yv), mode,
                                        world=JWorld(), **kw))
    out = TN.noise_zval_grid(torch.as_tensor(xv), torch.as_tensor(yv), mode,
                             world=TWorld(), **kw).numpy()
    np.testing.assert_array_equal(ref, out)
    assert TN.gen_rx_ry(5, 0, mode) == JN.gen_rx_ry(5, 0, mode)
    assert TN.get_hmap_scale(mode, 0.4) == JN.get_hmap_scale(mode, 0.4)


def _check_terrain(ref, out, zscale: float):
    np.testing.assert_allclose(out.zmax_est.numpy(), ref.zmax_est, rtol=1e-5, atol=0)
    for name in TMESH.TerrainState._fields:
        a, b = getattr(ref, name), getattr(out, name).numpy()
        assert a.shape == b.shape, name
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-5 * zscale, err_msg=name)


@pytest.mark.parametrize("mode", [0, 1, 2, 3, 4])
def test_gen_terrain_matches_jax(mode):
    """Every generator mode on a 32^2 world, no erosion, against the JAX
    `gen_terrain` run op by op."""
    jw, tw = JWorld(mesh_x=32, mesh_y=32), TWorld(mesh_x=32, mesh_y=32)
    kw = dict(mode=mode, xoff2=3, yoff2=-5)
    if mode == 2:
        kw.update(shape=JN.SHAPE_RIDGED, water_h_off_rel=0.2)
    with jax.disable_jit():
        ref = np_tree(JM.gen_terrain(JM.TerrainConfig(**kw), jw))
    out = TMESH.gen_terrain(TMESH.TerrainConfig(**kw), tw, device="cpu")
    zscale = float(ref.zmax_est)
    _check_terrain(ref, out, zscale)
    _check_terrain(ref, convert.terrain_state(ref, "cpu"), 0.0)   # carried over
    assert out.height_histogram.shape == (1024,)
    assert float(ref.ztop - ref.zbottom) > 0.01 * zscale
    if mode != 0:   # the fBm modes are the same float32 operations
        np.testing.assert_array_equal(ref.mesh_height, out.mesh_height.numpy())


def test_gen_terrain_erosion_per_stage():
    """`gen_terrain` with erosion (simplex, 200 droplets, erode_amount
    0.01) per stage: the glaciated heights as the JAX run op by op gives
    them, the padded JAX `erode` of those heights (1,024-droplet batches,
    256 steps, clamped at the bottom) within 1e-5 of the port's with the
    JAX angle draws, and the port's `gen_terrain` equal to its stages
    composed."""
    jw, tw = JWorld(mesh_x=32, mesh_y=32), TWorld(mesh_x=32, mesh_y=32)
    kw = dict(mode=JN.MGEN_SIMPLEX, erode_amount=0.01)
    with jax.disable_jit():
        pre = np_tree(JM.gen_terrain(JM.TerrainConfig(**kw), jw))
    tcfg = TMESH.TerrainConfig(erosion_iters=200, **kw)
    pre_t = TMESH.gen_terrain(tcfg._replace(erosion_iters=0), tw, device="cpu")
    _check_terrain(pre, pre_t, float(pre.zmax_est))
    ze, wpz = jnp.float32(pre.zmax_est), jnp.float32(pre.water_plane_z)
    jp = JE.ErosionParams(erode_amount=0.01, water_plane_z=wpz,
                          half_dxy=jw.half_dxy, zmin=-ze, zmax=ze,
                          rock_thresh=JM.clip_hd1(JM.TerrainConfig(**kw)),
                          relh_adj_tex=0.0)
    jstage = np.asarray(JE.erode(jnp.asarray(pre.mesh_height), 200, jp,
                                 min_zval=jnp.float32(pre.zbottom)))
    assert np.abs(jstage - pre.mesh_height).max() > 1e-4    # erosion did something
    ang = torch.as_tensor(jax_angle_tables(200, 1024, 256))
    tp = TE.ErosionParams(erode_amount=0.01, water_plane_z=pre_t.water_plane_z,
                          half_dxy=tw.half_dxy, zmin=-pre_t.zmax_est,
                          zmax=pre_t.zmax_est, rock_thresh=TMESH.clip_hd1(tcfg),
                          relh_adj_tex=0.0)
    tstage = TE.erode(torch.as_tensor(pre.mesh_height)[None], 200, tp, ang,
                      min_zval=torch.as_tensor(pre.zbottom))[0]
    np.testing.assert_allclose(tstage.numpy(), jstage, rtol=0, atol=1e-5)
    # the port's gen_terrain is those stages composed
    out = TMESH.gen_terrain(tcfg, tw, angles=ang, device="cpu")
    own = TE.erode(pre_t.mesh_height[None], 200, tp, ang,
                   min_zval=pre_t.zbottom)[0]
    assert torch.equal(out.mesh_height, own)
    assert torch.equal(out.zbottom, own.min()) and torch.equal(out.ztop, own.max())
    for name in ("zmin", "zmax", "zmax_est", "water_plane_z", "height_histogram"):
        assert torch.equal(getattr(out, name), getattr(pre_t, name)), name
    with pytest.raises(ValueError, match="angles"):
        TMESH.gen_terrain(tcfg, tw, device="cpu")


@pytest.mark.parametrize("mode", [1, 2, 3, 4])
def test_tile_heights_fbm_matches_jax(mode):
    """The tile path's fBm branch: 2 tiles of 16^2 at far-apart origins,
    glaciated, against the JAX `_tile_heights` run op by op; and one
    `tile_batch_step` without erosion, which is the same heights."""
    kw = dict(tile_size=16)
    jm = JTM.TileModelConfig(cfg=JM.TerrainConfig(mode=mode), **kw)
    tm = TTM.TileModelConfig(cfg=TMESH.TerrainConfig(mode=mode), **kw)
    x0 = np.asarray([-40.0, 3000.0], np.float32)
    y0 = np.asarray([16.0, -700.0], np.float32)
    ze = np.float32(9.0)
    ref = np.asarray(JTM._tile_heights(None, jnp.asarray(x0), jnp.asarray(y0),
                                       jm, JWorld(), jnp.asarray(ze)))
    tx0, ty0, tze = (torch.as_tensor(a) for a in (x0, y0, ze))
    out = TTM._tile_heights(None, tx0, ty0, tm, TWorld(), tze)
    assert out.shape == (2, 16, 16)
    np.testing.assert_array_equal(ref, out.numpy())
    step = TTM.tile_batch_step(None, tx0, ty0, tze, torch.tensor(-8.0), None, tm)
    assert torch.equal(step, out)

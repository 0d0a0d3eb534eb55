"""Torch port vs JAX package: tiled terrain (`terrain/tiles`, `ops/ao`,
`ops/shadows`, `terrain/biomes`) on small tiles (tile 32, a 64^2 world).

The JAX `TileManager` takes its height range from the compiled
`gen_terrain`, whose fused far grid rounds `zmax_est` apart from the
op-by-op one the port reproduces (see test_torch_fbm), so the port's
managers are given the JAX range (`set_height_range`).  Erosion angles
are the JAX draws (`jax_angle_tables`, key 0).

Tolerances: AO and the shadow mask equal on the JAX's own context
heights, biome weights within 1e-5; tile heights within 1e-5 per stage
(noise and glaciation; erosion of equal heights at erode amount 0.01,
see `test_tile_stages_match`); end to end without
erosion heights within 1e-5 with AO and shadow masks equal; end to end
with erosion (erode amount 0.01: the walk turns a few ulp of noise into
branch flips, see test_torch_terrain; where heights reach the ocean
cut a flip moves a cell by ~0.005) 99% of heights within 1e-3 and all
within 1e-2, weights within 1e-2, and at most
2% of AO cells and 0.5% of shadow-mask cells differing.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import w3d  # noqa: F401
from w3d.terrain import tiles as JTL, mesh as JM, biomes as JB
from w3d.ops import erosion as JE, ao as JAO, shadows as JSH
from w3d.utils.constants import WorldConst as JWorld

from w3d_torch import convert
from w3d_torch.terrain import tiles as TTL, mesh as TM, biomes as TB
from w3d_torch.ops import ao as TAO, shadows as TSH
from w3d_torch.utils.constants import WorldConst as TWorld

from torch_port_util import jax_angle_tables, same_tree

JW, TW = JWorld(mesh_x=64, mesh_y=64), TWorld(mesh_x=64, mesh_y=64)
TILE = 32


def _managers(iters=0, erode_amount=1.0, seed=5):
    jm = JTL.TileManager(cfg=JM.TerrainConfig(mesh_seed=seed, erode_amount=erode_amount),
                         world=JW, tile_size=TILE, erosion_iters_tt=iters)
    ang = torch.as_tensor(jax_angle_tables(iters, 256, 96)) if iters else None
    tm = TTL.TileManager(cfg=TM.TerrainConfig(mesh_seed=seed, erode_amount=erode_amount),
                         world=TW, tile_size=TILE, erosion_iters_tt=iters,
                         device="cpu", angles=ang)
    tm.set_height_range(jm.zmax_est, jm.water_plane_z)
    return jm, tm


def _jax_context(jm, txs, tys):
    """The JAX tile generator's glaciated context heights (tiles.py:199-224)."""
    from w3d.ops import noise as JN
    cfg, w, halo = jm.cfg, jm.world, JAO.AO_RAY_LEN
    csz = TILE + 2 * halo
    x0 = jnp.asarray(txs, jnp.float32) * TILE - halo
    y0 = jnp.asarray(tys, jnp.float32) * TILE - halo
    start = JN.start_eval_sin(cfg.mesh_scale, cfg.mesh_freq_filter)
    xt, yt = JN.sine_term_tables(JN.SineTable(*jm.table), x0, y0, w.dx, w.dy, csz, csz,
                                 world=w, mesh_scale=cfg.mesh_scale,
                                 mesh_scale_z_inv=1.0 / cfg.mesh_scale_z, start_sin=start)
    ctx = JM.postproc_noise_zval(JN.apply_noise_shape_final(JN.eval_sine_grid(xt, yt),
                                                            cfg.shape), cfg.hmap)
    return np.asarray(JM.apply_glaciate(ctx, jnp.float32(jm.zmax_est), cfg))


def test_ao_shadows_biomes_on_jax_context():
    jm, _ = _managers()
    ctx = _jax_context(jm, [0, 1, -1], [0, 2, -1])
    h = JAO.AO_RAY_LEN
    zv = ctx[:, h:h + TILE, h:h + TILE]
    dz = 0.5 * JW.half_dxy
    np.testing.assert_array_equal(TAO.tile_ao(torch.as_tensor(ctx), TILE, dz).numpy(),
                                  np.asarray(JAO.tile_ao(jnp.asarray(ctx), TILE, dz)))
    for light in ((0.4, 0.3, 0.8), (-0.2, 0.9, 0.5), (0.7, -0.7, 0.3), (-1.0, 0.0, 0.4)):
        js, jo = JSH.mesh_shadows(jnp.asarray(zv), light, cell_w=JW.dx)
        ts, to = TSH.mesh_shadows(torch.as_tensor(zv), light, cell_w=TW.dx)
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js), err_msg=str(light))
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=1e-6, atol=1e-5)
        assert np.asarray(js).any(), light
        c = np.asarray(jo)
        np.testing.assert_allclose(
            TSH.carry_transform(torch.as_tensor(c), 17, light, TW.dx).numpy(),
            np.asarray(JSH.carry_transform(jnp.asarray(c), 17, light, JW.dx)),
            rtol=1e-6, atol=1e-5)
    nz = np.random.default_rng(0).uniform(0.3, 1.0, zv.shape).astype(np.float32)
    ze = jm.zmax_est
    np.testing.assert_allclose(
        TB.biome_weights(torch.as_tensor(zv), torch.as_tensor(nz), -ze, ze, TM.TerrainConfig()).numpy(),
        np.asarray(JB.biome_weights(jnp.asarray(zv), jnp.asarray(nz), -ze, ze, JM.TerrainConfig())),
        rtol=0, atol=1e-5)


def test_tile_stages_match():
    """Context heights, then erosion of the JAX's own interior heights
    against `jax.vmap(erode)` with each tile's minimum as `min_zval`, at
    erode amount 0.01: over 96 steps at amount 1 the two packages' step
    sums (float32 in matmul order in JAX, 64-bit fixed point here) feed
    back through the walk until a third of the cells differ by more than
    1e-4 (0.3 at most, of a 4.0 carve), on equal inputs."""
    jm, tm = _managers(iters=300, erode_amount=0.01)
    txs, tys = np.asarray([0, 1, -2, 3], np.float32), np.asarray([0, 0, 1, -1], np.float32)
    ref = _jax_context(jm, txs, tys)
    ctx = TTL.tile_context(tm.table, torch.as_tensor(txs), torch.as_tensor(tys),
                           tm._zmax_t, tm.cfg, TW, TILE).numpy()
    np.testing.assert_allclose(ctx, ref, rtol=0, atol=1e-5)
    h = JAO.AO_RAY_LEN
    zv = ref[:, h:h + TILE, h:h + TILE]
    ze, wpz = jnp.float32(jm.zmax_est), jnp.float32(jm.water_plane_z)
    ep = JE.ErosionParams(erode_amount=0.01, water_plane_z=wpz, half_dxy=JW.half_dxy,
                          zmin=-ze, zmax=ze, rock_thresh=JM.clip_hd1(jm.cfg),
                          relh_adj_tex=jm.cfg.relh_adj_tex)
    want = np.asarray(jax.vmap(lambda hm, mz: JE.erode(hm, 300, ep, min_zval=mz, batch_size=256,
                                                        max_steps=96))(
        jnp.asarray(zv), jnp.min(jnp.asarray(zv), axis=(-1, -2))))
    got = TTL.erode_tiles(torch.as_tensor(zv), tm._zmax_t, tm._wpz_t, tm.cfg, TW, 300,
                          tm.angles).numpy()
    assert np.abs(want - zv).max() > 1e-2          # the walk carved
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert (got >= zv.min(axis=(1, 2))[:, None, None]).all()


@pytest.mark.parametrize("iters", [0, 300])
def test_tile_manager_matches_jax(iters):
    """Nine tiles around the camera end to end, then a camera move that
    deletes and creates."""
    jm, tm = _managers(iters=iters, erode_amount=0.01)
    far = 2.5 * TILE * JW.dx
    for cam in ((0.0, 0.0), (far, 0.0)):
        a, b = jm.update(*cam), tm.update(*cam)
        assert a == b
        assert sorted(jm.tiles) == sorted(tm.tiles)
        for k in a[0]:
            J, T = jm.tiles[k], tm.tiles[k]
            dz = np.abs(T.zvals.numpy() - np.asarray(J.zvals))
            dw = np.abs(T.weights.numpy() - np.asarray(J.weights))
            if iters:
                assert (dz <= 1e-3).mean() >= 0.99 and dz.max() <= 1e-2, (k, dz.max())
                assert dw.max() <= 1e-2, (k, dw.max())
            else:
                assert dz.max() <= 1e-5 and dw.max() <= 1e-5, (k, dz.max(), dw.max())
            ao_bad = (T.ao.numpy() != np.asarray(J.ao)).mean()
            sh_bad = (T.smask_sun.numpy() != np.asarray(J.smask_sun)).mean()
            if iters:
                assert ao_bad <= 0.02 and sh_bad <= 0.005, (k, ao_bad, sh_bad)
            else:
                assert ao_bad == 0 and sh_bad == 0, k
            assert T.smask_sun.dtype == torch.bool and T.weights.shape == (5, TILE, TILE)
        k = a[0][0]
        back = convert.to_numpy(convert.tile(jm.tiles[k], "cpu"))
        assert (back.tx, back.ty) == k
        np.testing.assert_array_equal(back.ao, np.asarray(jm.tiles[k].ao))


def test_tile_budget_priority_and_deferred_batch():
    """Nearest-first creation under a per-call budget, the deferred batch
    adopted on the next call, `flush`, then an unbudgeted fill: the same
    keys at every step as the JAX manager, heights within 1e-5; then the
    grass and flowers of two resident tiles."""
    jm, tm = _managers(seed=7)
    for budget in (3, 3, None):
        a = jm.update(0.0, 0.0, max_tiles_per_frame=budget) if budget else None
        if budget is None:
            jm.flush()
            tm.flush()
            assert sorted(jm.tiles) == sorted(tm.tiles)
            a = jm.update(0.0, 0.0)
            b = tm.update(0.0, 0.0)
        else:
            b = tm.update(0.0, 0.0, max_tiles_per_frame=budget)
            assert len(b[0]) == budget
            assert [k for k in b[0]] == sorted(b[0], key=lambda k: k[0] ** 2 + k[1] ** 2)
        assert a == b
        assert sorted(jm.tiles) == sorted(tm.tiles)
    assert len(tm.tiles) == 9
    for k in tm.tiles:
        np.testing.assert_allclose(tm.tiles[k].zvals.numpy(), np.asarray(jm.tiles[k].zvals),
                                   rtol=0, atol=1e-5)
    # per-tile vegetation on the managers' own tiles: blades and flowers
    # within 1e-5 of the JAX manager's, masks equal
    for k in ((0, 0), (1, -1)):
        same_tree(tm.grass_for_tile(k), jm.grass_for_tile(k), 1e-5, f"grass {k}")
        same_tree(tm.flowers_for_tile(k), jm.flowers_for_tile(k), 1e-5, f"flowers {k}")

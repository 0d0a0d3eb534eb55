"""Torch port vs JAX package: sine-table noise, terrain post-processing,
plain erosion and the tile batch step, on small tiles.

Tolerances: term tables and per-cell shaping within 1e-5 (float32
transcendental and rounding noise on values of order 1); noise heights,
which are 90-term sums, within the JAX noise test's own 1e-3; erosion
within the JAX erosion-kernel test's 1e-5 (sums of deposits in another
order).
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import w3d  # noqa: F401
from w3d.ops import noise as JN
from w3d.ops import erosion as JE
from w3d.terrain import mesh as JM
from w3d.models import terrain_model as JTM
from w3d.ops.pallas.erosion_kernel import erode_tiles_pallas
from w3d.utils.constants import WorldConst as JWorld

from w3d_torch import convert
from w3d_torch.ops import noise as TN
from w3d_torch.ops import erosion as TE
from w3d_torch.terrain import mesh as TMESH
from w3d_torch.models import terrain_model as TTM
from w3d_torch.utils.constants import WorldConst as TWorld

from torch_port_util import jax_angle_tables


@pytest.mark.parametrize("seed", [0, 3])
def test_sine_table_bitwise(seed):
    ref = JN.gen_sine_table(JWorld(), mesh_seed=seed)
    out = TN.gen_sine_table(TWorld(), mesh_seed=seed, device="cpu")
    for a, b in zip(ref, out):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize("start_sin", [0, 20])
def test_sine_terms_and_grid_match(start_sin):
    jw, tw = JWorld(), TWorld()
    jt = JN.gen_sine_table(jw, mesh_seed=3)
    tt = convert.sine_table(jax.tree.map(np.asarray, jt), "cpu")
    x0 = np.asarray([0.0, 64.0, -32.0], np.float32)
    y0 = np.asarray([0.0, 32.0, 16.0], np.float32)
    jx, jy = JN.sine_term_tables(jt, jnp.asarray(x0), jnp.asarray(y0), jw.dx,
                                 jw.dy, 48, 40, world=jw, mesh_scale=1.0,
                                 mesh_scale_z_inv=1.0, start_sin=start_sin)
    tx, ty = TN.sine_term_tables(tt, torch.as_tensor(x0), torch.as_tensor(y0),
                                 tw.dx, tw.dy, 48, 40, world=tw, mesh_scale=1.0,
                                 mesh_scale_z_inv=1.0, start_sin=start_sin)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=0, atol=1e-5)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=0, atol=1e-5)
    zj = np.asarray(JN.eval_sine_grid(jx, jy))
    zt = TN.eval_sine_grid(tx, ty).numpy()
    assert zt.shape == zj.shape == (3, 40, 48)
    np.testing.assert_allclose(zt, zj, rtol=0, atol=1e-3)


@pytest.mark.parametrize("shape", [JN.SHAPE_LINEAR, JN.SHAPE_BILLOWY, JN.SHAPE_RIDGED])
def test_shape_postproc_glaciate_match(shape):
    z = np.random.default_rng(4).uniform(-6.0, 6.0, (2, 24, 24)).astype(np.float32)
    hp = dict(plat_bot=1.0, plat_h=0.3, plat_s=0.5, plat_max=0.4,
              crat_h=3.0, crat_s=0.7, crack_lo=-1.0, crack_hi=-0.2, crack_d=0.6)
    jcfg = JM.TerrainConfig(shape=shape, hmap=JM.HmapParams(**hp))
    tcfg = TMESH.TerrainConfig(shape=shape, hmap=TMESH.HmapParams(**hp))
    zmax = np.float32(7.5)
    ref = JN.apply_noise_shape_final(jnp.asarray(z), shape)
    ref = JM.apply_glaciate(JM.postproc_noise_zval(ref, jcfg.hmap),
                            jnp.float32(zmax), jcfg)
    out = TN.apply_noise_shape_final(torch.as_tensor(z), shape)
    out = TMESH.apply_glaciate(TMESH.postproc_noise_zval(out, tcfg.hmap),
                               torch.tensor(zmax), tcfg)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=1e-5)
    assert TMESH.clip_hd1(tcfg) == JM.clip_hd1(jcfg)
    assert TN.start_eval_sin(4.0, 2) == JN.start_eval_sin(4.0, 2)


def _erosion_case():
    T, n = 2, 32
    rng = np.random.default_rng(7)
    hms = (rng.standard_normal((T, n, n)).astype(np.float32) * 0.5 + 1.0)
    kw = dict(erode_amount=1.0, water_plane_z=0.0, half_dxy=0.06,
              zmin=-2.0, zmax=2.0, rock_thresh=0.75)
    return hms, JE.ErosionParams(**kw), TE.ErosionParams(**kw)


@pytest.mark.parametrize("num_iters,pad", [
    pytest.param(150, 0, id="150"), pytest.param(100, 0, id="100"),
    pytest.param(150, 4, id="150-pad4"), pytest.param(100, 4, id="100-pad4")])
def test_plain_erosion_matches_jax(num_iters, pad):
    """Plain `erode` vs `jax.vmap(E.erode(pad=...))` on the JAX angle draws
    (mirrors tests/test_pallas.py::test_pallas_erosion_walk_matches_xla):
    two batches, and one batch with dead padding droplets; without the roam
    ring (the kernel path's walk) and with the JAX default PAD = 4."""
    hms, jp, tp = _erosion_case()
    ref = jax.vmap(lambda h: JE.erode(h, num_iters, jp, batch_size=128,
                                      max_steps=8, pad=pad))(jnp.asarray(hms))
    ang = torch.as_tensor(jax_angle_tables(num_iters, 128, 8))
    out = TE.erode(torch.as_tensor(hms), num_iters, tp, ang, batch_size=128,
                   max_steps=8, pad=pad)
    ref = np.asarray(ref)
    assert np.abs(ref - hms).max() > 1e-3          # the walk changed the maps
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-5)


def test_tile_batch_step_matches_jax_kernel_path():
    """Port `tile_batch_step` vs JAX `_tile_heights` + `erode_tiles_pallas`
    (interpret mode), which is what `tile_batch_step(use_pallas_erosion=
    True)` runs on the TPU.

    The droplet walk is chaotic: a one-ulp difference in an input height
    flips some droplet's branch and moves cells by up to ~0.1.  The noise
    heights of the two packages differ by a few ulp (sin and the 90-term
    sums round differently), so the stages are held separately: heights
    within 1e-5, erosion of the same heights within 1e-4, and the port's
    step equal to its two stages composed.  1e-4 because on these heights
    the JAX package's own two erosion paths (Pallas interpret and XLA)
    already disagree beyond 1e-5 on 4 of the 3072 cells: deposit sums in
    another order flip a branch; the port is within 7.2e-5 of the
    Pallas path."""
    jw = JWorld(mesh_x=32, mesh_y=32)
    tw = TWorld(mesh_x=32, mesh_y=32)
    jm = JTM.TileModelConfig(tile_size=32, erosion_iters_tt=150,
                             erosion_batch=128, erosion_steps=8)
    tm = TTM.TileModelConfig(tile_size=32, erosion_iters_tt=150,
                             erosion_batch=128, erosion_steps=8,
                             use_pallas_erosion=True)
    table, x0, y0, _, _ = JTM.example_inputs(jm, jw, num_tiles=3)
    ze, wpz = jnp.float32(2.0), jnp.float32(-1.5)   # heights reach the ocean cut
    z = JTM._tile_heights(JN.SineTable(*table), x0, y0, jm, jw, ze)
    eparams = JE.ErosionParams(erode_amount=jm.cfg.erode_amount,
                               water_plane_z=wpz, half_dxy=jw.half_dxy,
                               zmin=-ze, zmax=ze,
                               rock_thresh=JM.clip_hd1(jm.cfg),
                               relh_adj_tex=jm.cfg.relh_adj_tex)
    ref = np.asarray(erode_tiles_pallas(z, 150, eparams, min_zval=-1.0e9,
                                        batch_size=128, max_steps=8,
                                        interpret=True))
    z = np.asarray(z)
    assert np.abs(ref - z).max() > 1e-3              # erosion did something

    targs = convert.tile_inputs(jax.tree.map(np.asarray, table), x0, y0, ze,
                                wpz, "cpu")
    ang = torch.as_tensor(jax_angle_tables(150, 128, 8))
    zt = TTM._tile_heights(targs[0], targs[1], targs[2], tm, tw, targs[3])
    np.testing.assert_allclose(zt.numpy(), z, rtol=0, atol=1e-5)

    tparams = TE.ErosionParams(erode_amount=tm.cfg.erode_amount,
                               water_plane_z=targs[4], half_dxy=tw.half_dxy,
                               zmin=-targs[3], zmax=targs[3],
                               rock_thresh=TMESH.clip_hd1(tm.cfg),
                               relh_adj_tex=tm.cfg.relh_adj_tex)
    run = lambda h: TE.erode(h, 150, tparams, ang, min_zval=-1.0e9,
                             batch_size=128, max_steps=8, pad=0)
    np.testing.assert_allclose(run(torch.as_tensor(z)).numpy(), ref, rtol=0,
                               atol=1e-4)

    out = TTM.tile_batch_step(*targs, ang, tm, tw)
    assert out.shape == (3, 32, 32)
    assert torch.equal(out, run(zt))


def test_tile_batch_step_matches_jax_padded_path():
    """Port `tile_batch_step(use_pallas_erosion=False)` vs the JAX one of
    the same config, which erodes each tile through the padded XLA
    `erode(pad=PAD)`.  Per stage, on heights that reach the ocean cut:
    heights within 1e-5, the padded erosion of the same heights within
    1e-5.  End to end at erode_amount 0.01 and the config's example
    inputs, within 1e-3: where heights reach the ocean cut, a few-ulp
    height difference decides whether a droplet dies there, which moves
    cells by ~0.01 even at this erode amount."""
    jw = JWorld(mesh_x=32, mesh_y=32)
    tw = TWorld(mesh_x=32, mesh_y=32)
    kw = dict(tile_size=32, erosion_iters_tt=150, erosion_batch=128,
              erosion_steps=8, use_pallas_erosion=False)
    jm = JTM.TileModelConfig(cfg=JM.TerrainConfig(erode_amount=0.01), **kw)
    tm = TTM.TileModelConfig(cfg=TMESH.TerrainConfig(erode_amount=0.01), **kw)
    table, x0, y0, ze_ex, wpz_ex = JTM.example_inputs(jm, jw, num_tiles=3)
    ang = torch.as_tensor(jax_angle_tables(150, 128, 8))

    ze, wpz = jnp.float32(2.0), jnp.float32(-1.5)   # heights reach the ocean cut
    z = JTM._tile_heights(JN.SineTable(*table), x0, y0, jm, jw, ze)
    targs = convert.tile_inputs(jax.tree.map(np.asarray, table), x0, y0, ze,
                                wpz, "cpu")
    zt = TTM._tile_heights(targs[0], targs[1], targs[2], tm, tw, targs[3])
    np.testing.assert_allclose(zt.numpy(), np.asarray(z), rtol=0, atol=1e-5)
    jp = JE.ErosionParams(erode_amount=0.01, water_plane_z=wpz,
                          half_dxy=jw.half_dxy, zmin=-ze, zmax=ze,
                          rock_thresh=JM.clip_hd1(jm.cfg),
                          relh_adj_tex=jm.cfg.relh_adj_tex)
    jstage = np.asarray(jax.vmap(lambda h: JE.erode(
        h, 150, jp, batch_size=128, max_steps=8, pad=JE.PAD))(z))
    assert np.abs(jstage - np.asarray(z)).max() > 1e-5   # erosion did something
    tp = TE.ErosionParams(erode_amount=0.01, water_plane_z=targs[4],
                          half_dxy=tw.half_dxy, zmin=-targs[3], zmax=targs[3],
                          rock_thresh=TMESH.clip_hd1(tm.cfg),
                          relh_adj_tex=tm.cfg.relh_adj_tex)
    tstage = TE.erode(torch.as_tensor(np.array(z)), 150, tp, ang,
                      batch_size=128, max_steps=8)
    assert TE.PAD == JE.PAD
    np.testing.assert_allclose(tstage.numpy(), jstage, rtol=0, atol=1e-5)
    # the step is its two stages, on the padded walk
    out = TTM.tile_batch_step(*targs, ang, tm, tw)
    assert torch.equal(out, TE.erode(zt, 150, tp, ang, batch_size=128, max_steps=8))

    ref = np.asarray(JTM.tile_batch_step(table, x0, y0, ze_ex, wpz_ex, jm, jw))
    targs = convert.tile_inputs(jax.tree.map(np.asarray, table), x0, y0, ze_ex,
                                wpz_ex, "cpu")
    out = TTM.tile_batch_step(*targs, ang, tm, tw)
    assert out.shape == (3, 32, 32)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-3)

"""Torch port vs JAX package: the voxel engine (`voxel/grid`, `mc256`,
`mc`, `ao`, `edit`, `collide`) on the CPU, at 32x24x16-sized grids.

Fields: `create_procedural` in sine and fBm modes within 1e-5 (the noise
bound of tests/test_torch_noise3d.py: the sine grid's product and the
simplex sums round in other orders).  Given the JAX field, the masks and
surfaces are exact: `atten_edges` (every mode), `classify_outside`,
`remove_unconnected`, `top_surface`, `falling_mask`, the drop tick and
`settle_unanchored`.  The JAX functions that are jitted (`voxel_ao`,
`apply_brush`, the collider's `sphere_vs_field`) are run op by op
(`jax.disable_jit`): compiled, XLA contracts a product and a sum into one
rounding (measured 2.4e-7 on brush values, 6e-8 on AO), op by op the
port is bitwise.  Marching cubes and tets: the 256-case tables bitwise,
counts and valid masks exact, vertices within 1e-6 (tets: 4.8e-7
measured against the compiled JAX function at |coords| ~ 4)."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import w3d  # noqa: F401
from w3d.voxel import grid as JG, mc256 as JM, mc as JMC, ao as JAO, edit as JE
from w3d.voxel import collide as JC
from w3d.utils.constants import WorldConst as JWorld

from w3d_torch.voxel import grid as TG, mc256 as TM, mc as TMC, ao as TAO, edit as TE
from w3d_torch.voxel import collide as TC
from w3d_torch.utils.constants import WorldConst as TWorld

from torch_port_util import one_torch_thread  # noqa: F401  (autouse)

SIZE = dict(xsize=32, ysize=24, zsize=16, freq=2.0, z_gradient=0.8)


def _t(a):
    return torch.as_tensor(np.array(a))


def _params(**kw):
    p = dict(SIZE, **kw)
    return JG.VoxelParams(**p), TG.VoxelParams(**p)


def _jax_field(gen_mode=0, atten=2):
    jp, _ = _params(gen_mode=gen_mode, atten_at_edges=atten)
    lo, vsz = JG.default_grid_geometry(jp, JWorld())
    return np.asarray(JG.atten_edges(JG.create_procedural(jp, lo, vsz), jp)), lo, vsz


@pytest.mark.parametrize("gen_mode", [0, 1])
def test_create_procedural(gen_mode):
    jp, tp = _params(gen_mode=gen_mode)
    lo, vsz = JG.default_grid_geometry(jp, JWorld())
    ref = np.asarray(JG.create_procedural(jp, lo, vsz, offset=(0.3, -0.2, 0.1)))
    out = TG.create_procedural(tp, lo, vsz, offset=(0.3, -0.2, 0.1), device="cpu").numpy()
    assert out.shape == (16, 24, 32)
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)
    assert 0.05 < (ref < 0).mean() < 0.95


@pytest.mark.parametrize("gen_mode", [0, 1])
@pytest.mark.parametrize("atten", [0, 1, 2, 3, 4])
def test_masks_and_surfaces_exact(gen_mode, atten):
    """atten_edges, both flood fills and top_surface (native and
    resampled) on the JAX field, exact."""
    jp, tp = _params(gen_mode=gen_mode, atten_at_edges=atten)
    lo, vsz = JG.default_grid_geometry(jp, JWorld())
    raw = np.asarray(JG.create_procedural(jp, lo, vsz))
    ja = np.asarray(JG.atten_edges(jnp.asarray(raw), jp))
    np.testing.assert_array_equal(TG.atten_edges(_t(raw), tp).numpy(), ja)
    for iso in (0.0, 0.2):
        np.testing.assert_array_equal(TG.classify_outside(_t(ja), iso).numpy(),
                                      np.asarray(JG.classify_outside(jnp.asarray(ja), iso)))
        np.testing.assert_array_equal(
            TG.remove_unconnected(_t(ja), iso).numpy(),
            np.asarray(JG.remove_unconnected(jnp.asarray(ja), iso)))
        g = JG.VoxelGrid(jnp.asarray(ja), lo, vsz)
        tg = TG.VoxelGrid(_t(ja), lo, vsz)
        for shape in (None, (40, 50), (16, 8)):
            np.testing.assert_array_equal(TG.top_surface(tg, iso, shape).numpy(),
                                          np.asarray(JG.top_surface(g, iso, shape)))


@pytest.mark.parametrize("gen_mode", [0, 1])
def test_make_voxel_grid(gen_mode):
    """The whole pipeline on its own field: values within the noise bound,
    and the solid mask equal.  The isolevel 0.13 keeps every cell more
    than 1e-4 from it (checked), so no cell can flip within the bound; at
    0 a few cells of this field are exactly 0."""
    jp, tp = _params(atten_at_edges=2, remove_unconnected=1, isolevel=0.13,
                     gen_mode=gen_mode)
    jg = JG.make_voxel_grid(jp, JWorld())
    tg = TG.make_voxel_grid(tp, TWorld(), device="cpu")
    raw = np.asarray(JG.atten_edges(JG.create_procedural(jp, jg.lo_pos, jg.vsz), jp))
    assert np.abs(raw - jp.isolevel).min() > 1e-4
    assert tg.lo_pos == jg.lo_pos and tg.vsz == jg.vsz
    np.testing.assert_allclose(tg.values.numpy(), np.asarray(jg.values), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(tg.values.numpy() < 0.13, np.asarray(jg.values) < 0.13)
    assert (raw < 0.13).sum() > (np.asarray(jg.values) < 0.13).sum() > 0   # blobs removed


def test_mc256_tables_bitwise():
    for a, b in zip(TM.build_tables(), JM.build_tables()):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(TM.EDGE_ENDS, JM.EDGE_ENDS)
    np.testing.assert_array_equal(TM.CORNERS, JM.CORNERS)
    assert TM._table_consistency_check()


def _field3(seed=3, shape=(13, 11, 9)):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("tri_cap", [0, 100])
def test_marching_cubes(tri_cap):
    f = _field3()
    jv, jm = JM.marching_cubes(jnp.asarray(f), 0.1, tri_cap=tri_cap)
    tv, tm = TM.marching_cubes(_t(f), 0.1, tri_cap=tri_cap)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=0, atol=1e-6)
    assert TM.triangle_count(tm) == JM.triangle_count(jm) > 50
    np.testing.assert_array_equal(TM.cell_configs(_t(f), 0.1).numpy(),
                                  np.asarray(JM.cell_configs(jnp.asarray(f), 0.1)))


@pytest.mark.parametrize("stride,nb,cap", [(1, 3, 64), (2, 2, 4096), (1, 1, 64)])
def test_marching_cubes_blocks(stride, nb, cap, monkeypatch):
    """Per-block lists; the blocks extracted a few at a time (a pass of
    at most 300 cells)."""
    monkeypatch.setattr(TM, "CELLS_PER_PASS", 300)
    f = _field3(5, (17, 14, 10))
    ref = JM.marching_cubes_blocks(jnp.asarray(f), 0.1, num_blocks=nb, tri_cap=cap,
                                   stride=stride)
    out = TM.marching_cubes_blocks(_t(f), 0.1, num_blocks=nb, tri_cap=cap, stride=stride)
    np.testing.assert_array_equal(out[1].numpy(), np.asarray(ref[1]))
    np.testing.assert_array_equal(out[2].numpy(), np.asarray(ref[2]))
    np.testing.assert_allclose(out[0].numpy(), np.asarray(ref[0]), rtol=0, atol=1e-6)
    lods_j = JM.extract_lods(jnp.asarray(f), 0.1, num_blocks=nb, tri_cap=cap, lods=(0, 1, 2))
    lods_t = TM.extract_lods(_t(f), 0.1, num_blocks=nb, tri_cap=cap, lods=(0, 1, 2))
    for lod in (0, 1, 2):
        np.testing.assert_array_equal(lods_t[lod][1].numpy(), np.asarray(lods_j[lod][1]))
        np.testing.assert_array_equal(lods_t[lod][2].numpy(), np.asarray(lods_j[lod][2]))
        np.testing.assert_allclose(lods_t[lod][0].numpy(), np.asarray(lods_j[lod][0]),
                                   rtol=0, atol=1e-6)


def test_marching_tets_and_lods():
    f = _field3(7, (9, 10, 12))
    kw = dict(lo_pos=(-4.0, 0.5, -2.0), vsz=(0.3, 0.2, 0.7))
    ref = JMC.marching_tets(jnp.asarray(f), 0.1, **kw)
    out = TMC.marching_tets(_t(f), 0.1, **kw)
    np.testing.assert_array_equal(out[3].numpy(), np.asarray(ref[3]))
    for a, b in zip(out[:3], ref[:3]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-6)
    np.testing.assert_allclose(TMC.compact_triangles(*out), JMC.compact_triangles(*ref),
                               rtol=0, atol=1e-6)
    assert TMC.triangle_count(out[3]) == JMC.triangle_count(ref[3]) > 100
    lj = JMC.marching_tets_lod(jnp.asarray(f), 0.1, levels=4, **kw)
    lt = TMC.marching_tets_lod(_t(f), 0.1, levels=4, **kw)
    assert TMC.lod_triangle_counts(lt) == JMC.lod_triangle_counts(lj)
    assert len(lt) == len(lj) == 4
    for a, b in zip(lt, lj):
        np.testing.assert_array_equal(a[3].numpy(), np.asarray(b[3]))
        for x, y in zip(a[:3], b[:3]):
            np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=0, atol=1e-6)


def test_voxel_ao():
    f, _, _ = _jax_field()
    with jax.disable_jit():
        ref = np.asarray(JAO.voxel_ao(jnp.asarray(f), 0.0))
    out = TAO.voxel_ao(_t(f), 0.0).numpy()
    np.testing.assert_array_equal(out, ref)
    assert ref.min() < 0.5 and ref.max() == 1.0


def test_brushes_and_journal(tmp_path):
    """Each brush shape, then a journal written by the JAX package replayed
    by the port (and the port's journal read back by the JAX package)."""
    f, lo, vsz = _jax_field()
    jv, tv = jnp.asarray(f), _t(f)
    for shape in range(4):
        with jax.disable_jit():
            ref = np.asarray(JE.apply_brush(jv, lo, vsz, (0.3, -0.2, 0.1), 1.1, 0.7, shape))
        out = TE.apply_brush(tv, lo, vsz, (0.3, -0.2, 0.1), 1.1, 0.7, shape).numpy()
        np.testing.assert_array_equal(out, ref)
        assert (ref != f).any()
    j = JE.BrushJournal()
    j.add(JE.Brush((0.0, 0.0, 0.0), 1.0, 0.5, JE.VB_SHAPE_LINEAR))
    j.add(JE.Brush((1.0, 1.0, 0.0), 0.5, -0.3, JE.VB_SHAPE_QUADRATIC))
    j.add(JE.Brush((-1.5, 0.7, -0.4), 0.8, 0.9, JE.VB_SHAPE_CUBE))
    p = str(tmp_path / "brushes.npy")
    j.save(p)
    tj = TE.BrushJournal.load(p)
    jl = JE.BrushJournal.load(p)
    assert [tuple(b) for b in tj.brushes] == [tuple(b) for b in jl.brushes]
    with jax.disable_jit():
        ref = np.asarray(jl.replay(jv, lo, vsz))
    np.testing.assert_array_equal(tj.replay(tv, lo, vsz).numpy(), ref)
    p2 = str(tmp_path / "port.npy")
    tj.save(p2)
    assert [tuple(b) for b in JE.BrushJournal.load(p2).brushes] == \
        [tuple(b) for b in jl.brushes]
    for c, r in (((0.0, 0.0, 0.0), 1.0), ((3.5, -3.5, 0.0), 0.4)):
        assert TE.modified_blocks(c, r, lo, vsz, f.shape, 4) == \
            JE.modified_blocks(c, r, lo, vsz, f.shape, 4)


def _tower():
    v = np.ones((16, 8, 8), np.float32)
    v[0] = -1.0
    v[0:4, 2, 2] = -1.0             # pillar, anchored
    v[8:10, 5:7, 5:7] = -1.0        # floating island
    v[5, 1, 6] = -1.0               # a lone floating voxel
    v[3, 3, 3] = -1.0               # touches the pillar only diagonally
    return v


@pytest.mark.parametrize("which", ["tower", "field"])
def test_falling_and_settle(which):
    if which == "tower":
        v = _tower()
    else:
        v = _jax_field(atten=0)[0]
        v = np.where(v < 0.0, v, 1.0).astype(np.float32)
        v[10:12, 3:9, 4:10] = -0.5  # a slab with air beneath in places
    for layers in (1, 2):
        np.testing.assert_array_equal(
            TE.falling_mask(_t(v), 0.0, anchor_layers=layers).numpy(),
            np.asarray(JE.falling_mask(jnp.asarray(v), 0.0, anchor_layers=layers)))
    rv, rf = JE.drop_unanchored_step(jnp.asarray(v), 0.0)
    tv, tf = TE.drop_unanchored_step(_t(v), 0.0)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(rv))
    assert bool(tf) == bool(rf)
    for max_steps in (None, 3):
        rv, rs = JE.settle_unanchored(jnp.asarray(v), 0.0, max_steps=max_steps)
        tv, ts = TE.settle_unanchored(_t(v), 0.0, max_steps=max_steps)
        np.testing.assert_array_equal(tv.numpy(), np.asarray(rv))
        assert int(ts) == int(rs) > 0


def _ball():
    nz, ny, nx = 24, 33, 33
    zz, yy, xx = np.meshgrid(np.arange(nz), np.arange(ny), np.arange(nx), indexing="ij")
    return (np.sqrt((xx - 16) ** 2 + (yy - 16) ** 2 + (zz - 12) ** 2) - 8.0).astype(np.float32)


def test_sphere_vs_field():
    f = _ball()
    rg = np.random.default_rng(2)
    p = [rg.uniform(-2, 35, 256).astype(np.float32) for _ in range(3)]
    rad = rg.uniform(0.2, 1.5, 256).astype(np.float32)
    args = ((0.5, -0.25, 0.0), 1.1, 0.2)
    with jax.disable_jit():
        ref = JC.sphere_vs_field(jnp.asarray(f), *args, *(jnp.asarray(a) for a in p),
                                 jnp.asarray(rad))
    out = TC.sphere_vs_field(_t(f), *args, *(_t(a) for a in p), _t(rad))
    np.testing.assert_array_equal(out[0].numpy(), np.asarray(ref[0]))
    for a, b in zip(out[1:], ref[1:]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert 0 < int(ref[0].sum()) < 256


@pytest.mark.parametrize("method", ["mc", "tets"])
def test_voxel_collider(method, monkeypatch):
    """Full rebuild, a dirty-block rebuild after a carve, the block
    mapping and the exported polygon cobjs; the blocks extracted two at a
    time (passes of at most 4,000 cells)."""
    monkeypatch.setattr(TM, "CELLS_PER_PASS", 4000)
    f = _ball()
    kw = dict(params=JG.VoxelParams(isolevel=0.0), block=8, spacing=0.5,
              origin=(1.0, -2.0, 0.5), method=method)
    jc = JC.VoxelCollider(**kw)
    tc = TC.VoxelCollider(**dict(kw, params=TG.VoxelParams(isolevel=0.0)), device="cpu")
    f2 = f.copy()
    f2[:, 14:19, 14:19] += 5.0
    for field, dirty in ((f, None), (f2, "edit")):
        if dirty:
            dirty = jc.dirty_blocks_for_edit(9.0, 6.0, 1.5)
            assert dirty == tc.dirty_blocks_for_edit(9.0, 6.0, 1.5)
            assert 0 < len(dirty) < len(jc.tris)
        jc.rebuild(field, dirty)
        tc.rebuild(field, dirty)
        assert sorted(tc.tris) == sorted(jc.tris)
        for k in jc.tris:
            assert tc.tris[k].shape == jc.tris[k].shape, k
            np.testing.assert_allclose(tc.tris[k], jc.tris[k], rtol=0, atol=1e-6)
        assert tc.num_tris == jc.num_tris > 500
    jp, tp = jc.to_cobjs(), tc.to_cobjs()
    assert len(tp.cobjs) == len(jp.cobjs) == jc.num_tris
    for a, b in zip(tp.cobjs[::97], jp.cobjs[::97]):
        assert (a.shape, a.r1, a.layer.elasticity) == (b.shape, b.r1, b.layer.elasticity)
        np.testing.assert_allclose(np.asarray(a.pts), np.asarray(b.pts), rtol=0, atol=1e-6)

"""Torch port vs JAX package: lighting (`lighting/lmap`, `dlights`,
`trace`, `accum`, `building_indir`) on the CPU, on tests/test_lighting.py's
32x32x16 world and `PARAMS`.

The tracer's threefry draws are replayed from the JAX keys
(`torch_port_util.jax_trace_draws` / `jax_draw_source`).  The JAX tracer
runs op by op (`jax.disable_jit`): compiled, XLA contracts the cell-index
products into other roundings, so a few of a batch's ~10^5 samples land in
the neighbouring cell (measured: 20 of 16,384 cells differ after a 4,096
ray bake); op by op every sample lands in the same cell.  The deposit is
a fixed-order sum (`lmap.cell_sums`) where the JAX CPU scatter adds in
sample order, so volumes are held at the JAX package's own bounds for a
reordered deposit: rtol 2e-5, atol 1e-6 for `accumulate`, rtol 3e-5,
atol 1e-6 for traces and bakes (measured: 4.3e-6 worst relative).  Ray
generation within 1e-6 (the port's and XLA's sin/cos differ by an ulp),
everything else as stated per test."""

import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import w3d  # noqa: F401
from w3d.lighting import lmap as JL, trace as JT, dlights as JD, accum as JA
from w3d.lighting import building_indir as JB
from w3d.scene import cobj as JSC
from w3d.city import floorplan as JF
from w3d.utils.constants import WorldConst as JWorld

from w3d_torch import convert
from w3d_torch.lighting import lmap as TL, trace as TT, dlights as TD, accum as TA
from w3d_torch.lighting import building_indir as TB
from w3d_torch.scene import cobj as TSC
from w3d_torch.city import floorplan as TF
from w3d_torch.utils.constants import WorldConst as TWorld

from torch_port_util import np_tree, jax_trace_draws, jax_draw_source
from torch_port_util import one_torch_thread  # noqa: F401  (autouse)

JW = JWorld(mesh_x=32, mesh_y=32, mesh_z=16)
TW = TWorld(mesh_x=32, mesh_y=32, mesh_z=16)
PARAMS = dict(max_bounces=3, samples_per_segment=6, line_length=16.0, mesh_steps=12)


def _t(a):
    return torch.as_tensor(np.array(a))


def _params(**kw):
    return JT.TraceParams(**dict(PARAMS, **kw)), TT.TraceParams(**dict(PARAMS, **kw))


def _scene(SC, glass=False, spec=False):
    """A floor, a sphere over it and (optionally) a glass wall, in `SC`'s
    classes: tests/test_lighting.py's floor and glass-wall scenes."""
    sp = SC.SceneParse()
    lay = SC.CobjLayer(color=(0.9, 0.9, 0.9, 1.0))
    sp.cobjs.append(SC.RawCobj(SC.COLL_CUBE, (-4, -4, -0.6), (4, 4, -0.4), layer=lay))
    shiny = SC.CobjLayer(color=(0.8, 0.3, 0.2, 1.0), specular=0.6 if spec else 0.0,
                         shininess=40.0)
    sp.cobjs.append(SC.RawCobj(SC.COLL_SPHERE, (1.5, 0.0, 0.5), r1=0.6, layer=shiny))
    if glass:
        g = SC.CobjLayer(color=(0.9, 0.9, 0.9, 0.3), refract_ix=1.5, light_atten=0.5)
        sp.cobjs.append(SC.RawCobj(SC.COLL_CUBE, (0.8, -4, -0.4), (1.2, 4, 4), layer=g))
    return sp


def _cobjs(**kw):
    jc = JSC.pack_cobjs(_scene(JSC, **kw))
    tc = TSC.pack_cobjs(_scene(TSC, **kw), device="cpu")
    return jc, tc


def _mesh(level=-3.5):
    rg = np.random.default_rng(0)
    return (np.full((32, 32), level, np.float32)
            + rg.uniform(-0.3, 0.3, (32, 32)).astype(np.float32))


def _grids():
    return JL.make_light_grid(JW), TL.make_light_grid(TW, device="cpu")


def _check_grid(port, ref, rtol=3e-5, atol=1e-6, fields=None):
    ref = np_tree(ref)
    for f in fields or ref._fields:
        np.testing.assert_allclose(getattr(port, f).numpy(), getattr(ref, f),
                                   rtol=rtol, atol=atol, err_msg=f)


# ---------------------------------------------------------------------------
# lmap
# ---------------------------------------------------------------------------

def _samples(n=4096, seed=3):
    rg = np.random.default_rng(seed)
    n_cells = 16 * 32 * 32
    idx = rg.integers(0, n_cells + 7, n).astype(np.int32)
    idx[: n // 4] = rg.integers(0, 50, n // 4)          # crowded cells
    return idx, idx < n_cells, [rg.uniform(-1, 1, n).astype(np.float32) for _ in range(4)]


@pytest.mark.parametrize("ltype", [0, 1, 2])
def test_accumulate(ltype):
    """Every light type; the JAX plain, sorted and sharded scatters; the
    port the same bit for bit whatever the options, its deposit of
    negated weights the exact negation."""
    idx, ok, (r, g, b, w) = _samples()
    jg, tg = _grids()
    outs = [TL.accumulate(tg, ltype, _t(idx).long(), _t(ok), _t(r), _t(g), _t(b), _t(w),
                          shards=s, sorted_deposit=sd)
            for s, sd in ((1, False), (4, False), (1, True))]
    for o in outs[1:]:
        for a, c in zip(o, outs[0]):
            assert torch.equal(a, c)
    for s, sd in ((1, False), (4, False), (1, True)):
        ref = JL.accumulate(jg, ltype, jnp.asarray(idx), jnp.asarray(ok), jnp.asarray(r),
                            jnp.asarray(g), jnp.asarray(b), jnp.asarray(w), shards=s,
                            sorted_deposit=sd)
        _check_grid(outs[0], ref, rtol=2e-5, atol=1e-6)
    neg = TL.accumulate(tg, ltype, _t(idx).long(), _t(ok), _t(r), _t(g), _t(b), _t(-w))
    for f in TL.CHANNELS[ltype]:
        assert torch.equal(getattr(neg, f), -getattr(outs[0], f))
        assert float(getattr(outs[0], f).abs().sum()) > 0


def test_cell_index_and_final_color():
    rg = np.random.default_rng(1)
    x, y, z = (rg.uniform(-5, 5, 2000).astype(np.float32) for _ in range(3))
    jg, tg = _grids()
    ji, jo = JL.cell_index(jg, jnp.asarray(x), jnp.asarray(y), jnp.asarray(z), JW)
    ti, to = TL.cell_index(tg, _t(x), _t(y), _t(z), TW)
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    vals = {f: rg.uniform(0, 2, (16, 32, 32)).astype(np.float32) for f in jg._fields[:12]}
    vals["sv"][:2] = 0.0
    jg = jg._replace(**{k: jnp.asarray(v) for k, v in vals.items()})
    tg = tg._replace(**{k: _t(v) for k, v in vals.items()})
    _check_grid(TL.normalize_sky(tg), JL.normalize_sky(jg), rtol=0, atol=0)
    kw = dict(indir_scale=0.8, sky_scale=1.3, global_scale=0.6, local_scale=2.0,
              ambient=(0.9, 1.0, 0.8), diffuse=(1.0, 0.7, 0.9))
    for a, b in zip(TL.final_color(tg, **kw), JL.final_color(jg, **kw)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-6)


def test_npz_both_ways(tmp_path):
    """A volume saved by either package loads in the other, field for
    field, with the same keys."""
    idx, ok, (r, g, b, w) = _samples()
    jg = JL.accumulate(JL.make_light_grid(JW), 0, jnp.asarray(idx), jnp.asarray(ok),
                       jnp.asarray(r), jnp.asarray(g), jnp.asarray(b), jnp.asarray(w))
    JL.save_npz(jg, str(tmp_path / "j.npz"))
    tg = TL.load_npz(str(tmp_path / "j.npz"), device="cpu")
    _check_grid(tg, jg, rtol=0, atol=0)
    TL.save_npz(tg, str(tmp_path / "t.npz"))
    assert sorted(np.load(tmp_path / "t.npz").files) == sorted(np.load(tmp_path / "j.npz").files)
    back = JL.load_npz(str(tmp_path / "t.npz"))
    for f in jg._fields:
        np.testing.assert_array_equal(np.asarray(getattr(back, f)), np.asarray(getattr(jg, f)))


# ---------------------------------------------------------------------------
# dlights
# ---------------------------------------------------------------------------

def test_dlights():
    rg = np.random.default_rng(4)
    entries = [tuple(rg.uniform(-3, 3, 3)) + (rg.uniform(0.5, 2.0),) + tuple(rg.uniform(0, 1, 3))
               for _ in range(40)]
    jd = JD.pack_dlights(entries, capacity=64)
    td = TD.pack_dlights(entries, capacity=64, device="cpu")
    for f in jd._fields:
        np.testing.assert_array_equal(getattr(td, f).numpy(), np.asarray(getattr(jd, f)))
    assert convert.dlights(np_tree(jd), "cpu").x.shape == (64,)
    p = [rg.uniform(-4, 4, 300).astype(np.float32) for _ in range(3)]
    for a, b in zip(TD.eval_dlights_at(td, *(_t(v) for v in p)),
                    JD.eval_dlights_at(jd, *(jnp.asarray(v) for v in p))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-6)
    jg, tg = _grids()
    _check_grid(TD.dlight_volume(td, tg, TW), JD.dlight_volume(jd, jg, JW), rtol=1e-5,
                atol=1e-6)


def test_material_sphere_dlights():
    from w3d.physics import types as JPT, step as JPS
    from w3d.scene.sphere_materials import SphereMat as JSM
    from w3d_torch.scene.sphere_materials import SphereMat as TSM
    kw = [dict(name="lamp", emissive=True, light_radius=0.8, diffuse_color=(1.0, 0.8, 0.4)),
          dict(name="rock"), dict(name="glow", emissive=True, light_radius=0.3)]
    table, first = JPT.extend_table_with_materials(JPT.make_type_table(),
                                                   [JSM(**k) for k in kw])
    rg = np.random.default_rng(6)
    n = 24
    st = JPS.make_state(rg.uniform(-2, 2, (n, 3)), np.zeros((n, 3)),
                        first + np.arange(n) % 3, table)
    st = st._replace(status=jnp.asarray(np.where(np.arange(n) % 5 == 0, 0, 1), jnp.int32))
    ref = JD.material_sphere_dlights(st, first, [JSM(**k) for k in kw], capacity=32)
    out = TD.material_sphere_dlights(convert.object_state(np_tree(st), "cpu"), first,
                                     [TSM(**k) for k in kw], capacity=32)
    for f in ref._fields:
        np.testing.assert_array_equal(getattr(out, f).numpy(), np.asarray(getattr(ref, f)))
    assert int(out.enabled.sum()) > 5


# ---------------------------------------------------------------------------
# ray generation and the tracer
# ---------------------------------------------------------------------------

def test_ray_generation():
    key = jax.random.key(7)
    d = jax_trace_draws(key)
    pairs = [(TT.sky_rays(d, 512, TW, ray_weight=3.0), JT.sky_rays(key, 512, JW, ray_weight=3.0)),
             (TT.global_rays(d, 512, (0.3, -0.2, -1.0), TW),
              JT.global_rays(key, 512, (0.3, -0.2, -1.0), JW)),
             (TT.local_rays(d, 512, (0.1, 0.2, 0.5), (1.0, 0.9, 0.8), TW),
              JT.local_rays(key, 512, (0.1, 0.2, 0.5), (1.0, 0.9, 0.8), JW))]
    for spec in _light_specs(TSC):
        jspec = _light_specs(JSC)[_light_specs(TSC).index(spec)]
        pairs.append((TT.scene_light_rays(d, spec, 512, TW),
                      JT.scene_light_rays(key, jspec, 512, JW)))
    for out, ref in pairs:
        for a, b in zip(out, ref):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-6)
    jl = JT.landscape_color_map(jnp.asarray(_mesh()), JW)
    np.testing.assert_allclose(TT.landscape_color_map(_t(_mesh()), TW).numpy(),
                               np.asarray(jl), rtol=0, atol=1e-6)


def _light_specs(SC):
    """A point light, a spotlight with an inner radius, a line light, a
    cube light and an ambient light (which the bake skips)."""
    L = SC.LightSpec
    return [L(size=0.5, pos=(0.0, 0.0, 0.5), color=(1.0, 0.9, 0.8, 1.0)),
            L(size=0.8, pos=(-1.0, 1.0, 1.0), color=(0.5, 0.6, 1.0, 0.7), dir=(0.2, 0.0, -1.0),
              beamwidth=0.3, r_inner=0.1, num_dlight_rays=2048),
            L(size=0.4, pos=(-2.0, -2.0, 0.3), pos2=(2.0, -1.0, 0.3), is_line=True),
            L(size=0.3, pos=(0.5, 0.5, 0.2), pos2=(0.9, 1.1, 0.6), is_cube_light=True,
              color=(0.2, 1.0, 0.4, 1.0)),
            L(kind="ambient", size=1.0, pos=(0.0, 0.0, 2.0))]


def _trace_both(jp, tp, n=2048, ltype=0, glass=False, spec=False, mesh=None, land=None,
                snow=None, seed=11):
    """One trace_batch of sky rays through both packages (the JAX one op
    by op), from the same key's draws."""
    jc, tc = _cobjs(glass=glass, spec=spec)
    mesh = _mesh() if mesh is None else mesh
    key = jax.random.key(seed)
    jrays = JT.sky_rays(jax.random.fold_in(key, 1), n, JW, ray_weight=float(n))
    trays = [_t(r) for r in jrays]
    jg, tg = _grids()
    jkw = dict(ltype=ltype, params=jp, world=JW,
               land_color=None if land is None else jnp.asarray(land),
               snow_depth=None if snow is None else jnp.asarray(snow))
    with jax.disable_jit():
        ref = JT.trace_batch(jg, jc, jnp.asarray(mesh), *jrays, jax.random.fold_in(key, 2),
                             **jkw)
    out = TT.trace_batch(tg, tc, _t(mesh), *trays, jax_trace_draws(jax.random.fold_in(key, 2)),
                         ltype=ltype, params=tp, world=TW,
                         land_color=None if land is None else _t(land),
                         snow_depth=None if snow is None else _t(snow))
    return out, ref


CASES = {
    "plain": dict(),
    "specular": dict(spec=True),
    "global": dict(ltype=1),
    "local-exact-mesh": dict(ltype=2, params=dict(exact_mesh=True)),
    "glass": dict(glass=True),
    "ice": dict(params=dict(water_plane_z=-1.0, temperature=-5.0)),
    "water": dict(params=dict(water_plane_z=-1.0)),
    "snow": dict(mesh_level=-1.0, snow=True),
    "landscape": dict(mesh_level=-1.0, land=True),
    "compact": dict(params=dict(compact=True, max_bounces=5)),
    "compact-uniform": dict(params=dict(compact=True, uniform_color0=True, compact_shift=1,
                                        samples_later=3, max_bounces=5)),
    "compact-glass": dict(glass=True, params=dict(compact=True, uniform_color0=True,
                                                  max_bounces=4)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_trace_batch(case):
    c = CASES[case]
    jp, tp = _params(**c.get("params", {}))
    mesh = _mesh(c.get("mesh_level", -3.5))
    land = np.asarray(JT.landscape_color_map(jnp.asarray(mesh), JW)) if c.get("land") else None
    snow = np.ones((32, 32), np.float32) if c.get("snow") else None
    out, ref = _trace_both(jp, tp, ltype=c.get("ltype", 0), glass=c.get("glass", False),
                           spec=c.get("spec", False), mesh=mesh, land=land, snow=snow,
                           n=2048 if tp.compact else 1024)
    _check_grid(out, ref)
    chans = TL.CHANNELS[c.get("ltype", 0)]
    assert float(np_tree(ref)._asdict()[chans[0]].sum()) > 0


def test_drivers():
    """compute_sky_lighting over a full batch and a remainder,
    compute_local_lighting over two lights, compute_scene_lighting over
    point, spot, line, cube and ambient lights."""
    jp, tp = _params()
    jc, tc = _cobjs(spec=True)
    mesh = _mesh()
    src = jax_draw_source()
    jg, tg = _grids()
    with jax.disable_jit():
        ref = JT.compute_sky_lighting(jg, jc, jnp.asarray(mesh), 3072, seed=4, params=jp,
                                      world=JW, batch=2048)
    out = TT.compute_sky_lighting(tg, tc, _t(mesh), 3072, seed=4, params=tp, world=TW,
                                  batch=2048, draws=src)
    _check_grid(out, ref)
    lights = [((0.0, 0.0, 0.5), (1.0, 1.0, 1.0)), ((-1.5, 1.0, 1.5), (0.3, 0.4, 1.0))]
    with jax.disable_jit():
        ref = JT.compute_local_lighting(jg, jc, jnp.asarray(mesh), lights, 1024, seed=2,
                                        params=jp, world=JW)
    out = TT.compute_local_lighting(tg, tc, _t(mesh), lights, 1024, seed=2, params=tp,
                                    world=TW, draws=src)
    _check_grid(out, ref)
    with jax.disable_jit():
        ref = JT.compute_scene_lighting(jg, jc, jnp.asarray(mesh), _light_specs(JSC), 1024,
                                        seed=5, params=jp, world=JW)
    out = TT.compute_scene_lighting(tg, tc, _t(mesh), _light_specs(TSC), 1024, seed=5,
                                    params=tp, world=TW, draws=src)
    _check_grid(out, ref)
    assert float(out.lc_r.sum()) > 0


def test_bake_is_deterministic_and_gates_match():
    """Two bakes from one seed are equal bit for bit (the default
    generator draws), and the static gates read the same scene facts as
    the JAX ones."""
    jp, tp = _params(compact=True)
    jc, tc = _cobjs(glass=True)
    mesh = _t(_mesh())
    a, b = (TT.compute_sky_lighting(TL.make_light_grid(TW, device="cpu"), tc, mesh, 3000,
                                    seed=9, params=tp, world=TW, batch=2048)
            for _ in range(2))
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert float(a.sv.sum()) > 0
    for kw in (dict(), dict(glass=True), dict(spec=True)):
        jc, tc = _cobjs(**kw)
        for p in (dict(), dict(compact=True), dict(temperature=-5.0)):
            jp, tp = _params(**p)
            assert tuple(TT._auto_gates(tp, tc)) == tuple(JT._auto_gates(jp, jc))


# ---------------------------------------------------------------------------
# incremental lighting
# ---------------------------------------------------------------------------

def test_platform_delta():
    """record_platform_rays keeps the JAX ray set; a move's delta equals
    the JAX one; A->B then B->A cancels to exactly zero; no move adds
    exactly zero."""
    jc, tc = _cobjs()
    mesh = _mesh()
    jp, tp = _params()
    key = jax.random.key(0)
    lo, hi = (0.0, 0.0, -0.5), (0.5, 0.5, 0.0)
    lo2, hi2 = (1.0, 1.0, -0.5), (1.5, 1.5, 0.0)
    jr = JA.record_platform_rays(key, 1024, lo, hi, JW, seed=3)
    tr = TA.record_platform_rays(jax_trace_draws(key), 1024, lo, hi, TW, seed=3)
    assert 0 < tr.ox.shape[0] == jr.ox.shape[0] < 1024 and tr.seed == jr.seed == 3
    for f in TA.AccumRays._fields[:-1]:
        np.testing.assert_allclose(getattr(tr, f).numpy(), np.asarray(getattr(jr, f)),
                                   rtol=0, atol=1e-6)
    tr = convert.accum_rays(np_tree(jr), "cpu")     # the same rays in both
    jg, tg = _grids()
    with jax.disable_jit():
        ref = JA.update_platform_lighting(jg, jr, jc, jnp.asarray(mesh), lo, hi, lo2, hi2,
                                          params=jp, world=JW)
    src = jax_draw_source()
    moved = TA.update_platform_lighting(tg, tr, tc, _t(mesh), lo, hi, lo2, hi2, params=tp,
                                        world=TW, draws=src)
    _check_grid(moved, ref)
    assert float(moved.sc_r.abs().sum()) > 0
    ab = TA.update_platform_lighting(tg, tr, tc, _t(mesh), lo, hi, lo2, hi2, params=tp,
                                     world=TW)
    aba = TA.update_platform_lighting(ab, tr, tc, _t(mesh), lo2, hi2, lo, hi, params=tp,
                                      world=TW)
    same = TA.update_platform_lighting(tg, tr, tc, _t(mesh), lo, hi, lo, hi, params=tp,
                                       world=TW)
    for f in TL.CHANNELS[0]:
        assert float(getattr(ab, f).abs().sum()) > 0
        assert not getattr(aba, f).any(), f
        assert not getattr(same, f).any(), f


def test_dlight_groups():
    jc, tc = _cobjs()
    mesh = _mesh()
    jp, tp = _params()
    lights = [((0., 0., 0.5), (1., 0.8, 0.6)), ((1., 0., 0.5), (0.5, 0.5, 1.))]
    jm, tm = JA.DlightGroupManager(), TA.DlightGroupManager()
    for m in (jm, tm):
        m.add_dlight("lamps", 0, scale=2.0)
        m.add_dlight("lamps", 1, scale=2.0)
        m.add_dlight("", 1, is_dynamic=True)
    assert sorted(tm.groups) == sorted(jm.groups) == ["__none__", "lamps"]
    with jax.disable_jit():
        ref = jm.gen_group_volume(jm.get_group("lamps", 2.0), jc, jnp.asarray(mesh), lights,
                                  1024, JW, seed=1, params=jp)
    out = tm.gen_group_volume(tm.get_group("lamps", 2.0), tc, _t(mesh), lights, 1024, TW,
                              seed=1, params=tp, draws=jax_draw_source())
    _check_grid(out, ref)
    for mask in ([True, True], [True, False], [False, False]):
        g = tm.get_group("lamps", 2.0)
        assert tm.group_scale(g, mask) == jm.group_scale(jm.get_group("lamps", 2.0), mask)
        _check_grid(tm.scaled_volume(g, mask),
                    jm.scaled_volume(jm.get_group("lamps", 2.0), mask), fields=("lc_r",))


def _interior(F):
    bbox = (0.0, 0.0, 0.0, 1.0, 0.8, 0.3)
    i = F.gen_interior(bbox, 3, 0.1, seed=3)
    return i, bbox


def test_building_indir_sliced():
    """A port-built interior equals the JAX one; a light traced in slices
    equals the JAX manager's slices (same streams), and the sliced bake
    matches the single-shot one in expectation; the queue, prioritize and
    composite behave as the JAX manager's."""
    ji, bbox = _interior(JF)
    ti, _ = _interior(TF)
    assert dataclasses.asdict(ti) == dataclasses.asdict(ji)
    jw, joff, jc, jmesh = JB.building_local_setup(ji, bbox, res=16)
    tw, toff, tc, tmesh = TB.building_local_setup(ti, bbox, res=16, device="cpu")
    assert dataclasses.asdict(tw) == dataclasses.asdict(jw) and toff == joff
    for f in jc._fields:
        np.testing.assert_array_equal(getattr(tc, f).numpy(), np.asarray(getattr(jc, f)))
    np.testing.assert_array_equal(tmesh.numpy(), np.asarray(jmesh))

    def manager(B, interior, **kw):
        m = B.BuildingIndirManager.for_building(interior, bbox, res=16, rays_per_light=1024,
                                                **kw)
        keep = min(m.lights)
        for ix in [i for i in m.lights if i != keep]:
            m.lights.pop(ix)
        m.queue.clear()
        m.enqueue(keep)
        return m, keep

    jm, keep = manager(JB, ji)
    tm, _ = manager(TB, ti, device="cpu")
    tm.draws = jax_draw_source()
    jm.slice_rays = tm.slice_rays = 512
    with jax.disable_jit():
        jm.process_all(seed=1)
    assert tm.process_all(seed=1) == 2
    _check_grid(tm.volumes[keep], jm.volumes[keep], fields=("lc_r", "lc_g", "lc_b"))
    single, _ = manager(TB, ti, device="cpu")
    single.process_all(seed=1)
    e_full = float(single.volumes[keep].lc_r.sum())
    e_sliced = float(tm.volumes[keep].lc_r.sum())
    assert e_full > 0 and abs(e_sliced - e_full) / e_full < 0.25
    tm.set_enabled(keep, False)
    assert not tm.composite().lc_r.any()
    tm.set_enabled(keep, True)
    _check_grid(tm.composite(), jm.composite(), fields=("lc_r",))
    for B in (JB, TB):
        m = B.BuildingIndirManager()
        for i in range(4):
            m.register_light(i, (0.0, 0.0, float(i)), (1, 1, 1))
        m.prioritize(3)
        assert list(m.queue) == [3, 0, 1, 2]

"""Torch port vs JAX package: the dense sweep solver (`lighting/sweep`) on
the CPU, on tests/test_lighting.py's 32x32x16 world and sweep scene (a
red floor slab and sphere), with and without a mesh.

`voxelize_scene`'s occupancy and albedo are exact; `hemisphere_dirs` and
the fill-not-wrap shifts are bitwise; both sweeps, direct and with the
diffuse bounce, are held at 1e-5 against the compiled JAX solver (XLA
contracts the shear's products into its sums; measured 2.4e-7)."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

import w3d  # noqa: F401
from w3d.lighting import lmap as JL, sweep as JS
from w3d.scene import cobj as JSC
from w3d.utils.constants import WorldConst as JWorld

from w3d_torch.lighting import lmap as TL, sweep as TS
from w3d_torch.scene import cobj as TSC
from w3d_torch.utils.constants import WorldConst as TWorld

from torch_port_util import np_tree
from torch_port_util import one_torch_thread  # noqa: F401  (autouse)

JW = JWorld(mesh_x=32, mesh_y=32, mesh_z=16)
TW = TWorld(mesh_x=32, mesh_y=32, mesh_z=16)


def _scene(SC):
    sp = SC.SceneParse()
    lay = SC.CobjLayer(elasticity=0.5, color=(0.8, 0.3, 0.2, 1.0))
    sp.cobjs.append(SC.RawCobj(SC.COLL_CUBE, (-4, -4, -3.95), (4, 4, -3.3), layer=lay))
    sp.cobjs.append(SC.RawCobj(SC.COLL_SPHERE, (0.0, 0.0, -2.0), r1=0.8, layer=lay))
    sp.cobjs.append(SC.RawCobj(SC.COLL_CYLINDER, (2.5, -2.0, -3.3), (2.5, -2.0, 1.0),
                               r1=0.4, r2=0.4,
                               layer=SC.CobjLayer(color=(0.2, 0.7, 0.3, 1.0))))
    return sp


def _inputs(with_mesh):
    jc = JSC.pack_cobjs(_scene(JSC))
    tc = TSC.pack_cobjs(_scene(TSC), device="cpu")
    mesh = None
    if with_mesh:
        y, x = np.mgrid[0:32, 0:32] / 32.0
        mesh = (-3.6 + 1.5 * x * y + 0.3 * np.sin(6 * x)).astype(np.float32)
    return jc, tc, mesh


def _grids():
    return JL.make_light_grid(JW, nz=16), TL.make_light_grid(TW, nz=16, device="cpu")


def _check(port, ref, fields, tol=1e-5):
    ref = np_tree(ref)
    for f in fields:
        np.testing.assert_allclose(getattr(port, f).numpy(), getattr(ref, f), rtol=0,
                                   atol=tol, err_msg=f)


@pytest.mark.parametrize("with_mesh", [False, True])
def test_voxelize_scene(with_mesh):
    jc, tc, mesh = _inputs(with_mesh)
    jg, tg = _grids()
    ref = JS.voxelize_for_grid(jg, jc, None if mesh is None else jnp.asarray(mesh), JW)
    out = TS.voxelize_for_grid(tg, tc, None if mesh is None else torch.as_tensor(mesh), TW)
    for a, b in zip(out, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    occ = np.asarray(ref[0])
    assert 0.05 < occ.mean() < 0.6
    assert (np.asarray(ref[2])[occ > 0] > 0.5).any()          # the green cylinder


def test_shifts_and_dirs():
    d1, w1 = JS.hemisphere_dirs(32)
    d2, w2 = TS.hemisphere_dirs(32)
    np.testing.assert_array_equal(d2, d1)
    np.testing.assert_array_equal(w2, w1)
    rg = np.random.default_rng(0)
    p = rg.uniform(0, 1, (3, 16, 20)).astype(np.float32)
    fill = torch.tensor([1.0, 0.0, 0.0]).view(3, 1, 1)
    for sx, sy in ((2.3, -1.7), (-0.4, 0.0), (5.0, 3.25), (-7.6, 12.1)):
        out = TS._shift2(torch.as_tensor(p), sx, sy, fill).numpy()
        for c, f in enumerate((1.0, 0.0, 0.0)):
            ref = np.asarray(JS._shift2(jnp.asarray(p[c]), sx, sy, fill=f))
            np.testing.assert_array_equal(out[c], ref)
    for k in (-3, 0, 2):
        out = TS._ishift(torch.as_tensor(p), k, 1, fill).numpy()
        np.testing.assert_array_equal(out[0], np.asarray(JS._ishift(jnp.asarray(p[0]), k, 0, 1.0)))


@pytest.mark.parametrize("with_mesh,bounce", [(False, False), (False, True), (True, True)])
def test_sky_sweep(with_mesh, bounce):
    jc, tc, mesh = _inputs(with_mesh)
    jg, tg = _grids()
    ref = JS.compute_sky_lighting_sweep(jg, jc, None if mesh is None else jnp.asarray(mesh),
                                        ndirs=12, world=JW, bounce=bounce)
    out = TS.compute_sky_lighting_sweep(tg, tc, None if mesh is None else torch.as_tensor(mesh),
                                        ndirs=12, world=TW, bounce=bounce)
    _check(out, ref, ("sc_r", "sc_g", "sc_b", "sv"))
    sv = out.sv.numpy()
    assert sv.max() > 0.9 and sv.min() < 0.05


@pytest.mark.parametrize("sun_dir,bounce", [((0.4, 0.0, -1.0), False), ((0.4, -0.3, -1.0), True),
                                            ((-0.2, 0.1, 0.8), True), ((1.0, 0.0, -0.01), True)])
def test_global_sweep(sun_dir, bounce):
    """A tilted sun, with the bounce, from below (upward sweep) and at the
    horizon (adds nothing); the voxelization shared through `vox`."""
    jc, tc, mesh = _inputs(True)
    jg, tg = _grids()
    jv = JS.voxelize_for_grid(jg, jc, jnp.asarray(mesh), JW)
    tv = TS.voxelize_for_grid(tg, tc, torch.as_tensor(mesh), TW)
    ref = JS.compute_global_lighting_sweep(jg, jc, jnp.asarray(mesh), sun_dir, world=JW,
                                           bounce=bounce, vox=jv)
    out = TS.compute_global_lighting_sweep(tg, tc, torch.as_tensor(mesh), sun_dir, world=TW,
                                           bounce=bounce, vox=tv)
    _check(out, ref, ("gc_r", "gc_g", "gc_b", "gv"))
    assert (float(out.gv.max()) > 0.9) == (abs(sun_dir[2]) > 0.1)

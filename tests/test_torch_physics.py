"""Torch port vs JAX package: type table, cobj packing and grouping, mesh
sampling, the grouped narrow phase, banded pairs, the x sort and the
physics frame (`step_objects` against the JAX banded pair path).

Tolerances: sample heights within 2 ulp of the mesh's scale (the JAX
one-hot contraction may fuse a multiply-add that the port rounds in two
steps), normals within 1e-6; narrow phase as tests/test_pallas.py holds the Pallas kernel (hit
mask equal, pen within 1e-5, winner fields within 1e-5 on lanes whose
argmax margin exceeds 1e-4); pairs within 1e-6 (tests/test_pallas.py's
bound); frame positions and velocities within 1e-5, status/flags/time
exact.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import w3d  # noqa: F401
from w3d.models import physics_model as JPM
from w3d.physics import cobjs as JC
from w3d.physics import step as JPS
from w3d.physics import types as JT
from w3d.scene import cobj as JSC
from w3d.utils.constants import WorldConst as JWorld

from w3d_torch import convert
from w3d_torch.models import physics_model as TPM
from w3d_torch.physics import cobjs as TC
from w3d_torch.physics import step as TPS
from w3d_torch.physics import types as TT
from w3d_torch.scene import cobj as TSC
from w3d_torch.utils.constants import WorldConst as TWorld

from torch_port_util import (bumpy_world, check_narrow, narrow_case, np_tree,
                             seven_shape_scene, ulp_diff)


def test_type_table_matches():
    ref = np_tree(JT.make_type_table(z_scene=4.0))
    out = TT.make_type_table(z_scene=4.0, device="cpu")
    for name in TT.ObjTypeTable._fields:
        np.testing.assert_array_equal(
            getattr(ref, name).astype(getattr(out, name).numpy().dtype),
            getattr(out, name).numpy(), err_msg=name)
    assert TT.type_id("BALL") == JT.type_id("BALL")


@pytest.mark.parametrize("scene", ["spheres", "seven_shapes"])
def test_pack_and_group_cobjs_match(scene):
    if scene == "spheres":
        jsp, tsp = JPM.SC.SceneParse(), TPM.spheres_scene()
        jsp.cobjs = tsp.cobjs   # same specs; JAX builds this one inline
    else:
        jsp, tsp = seven_shape_scene(JSC), seven_shape_scene(TSC)
    jg = np_tree(JC.group_cobjs(JSC.pack_cobjs(jsp)))
    tg = TC.group_cobjs(TSC.pack_cobjs(tsp, device="cpu"))
    assert tg.bounds == tuple(tuple(b) for b in jg.bounds)
    for name in TC.CobjSet._fields:
        a = getattr(jg.cobjs, name)
        b = getattr(tg.cobjs, name).numpy()
        np.testing.assert_array_equal(a.astype(b.dtype), b, err_msg=name)
    if scene == "spheres":
        assert tg.size == 112


def test_sample_mesh_matches():
    """Interior, border-clamped and off-mesh coordinates."""
    w = JWorld()
    rng = np.random.default_rng(11)
    mesh = rng.standard_normal((w.mesh_y, w.mesh_x)).astype(np.float32)
    n = 1500
    x = rng.uniform(-1.4 * w.x_scene, 1.4 * w.x_scene, n).astype(np.float32)
    y = rng.uniform(-1.4 * w.y_scene, 1.4 * w.y_scene, n).astype(np.float32)
    ref = [np.asarray(a) for a in JPS.sample_mesh(jnp.asarray(mesh),
                                                  jnp.asarray(x),
                                                  jnp.asarray(y), w)]
    out = [a.numpy() for a in TPS.sample_mesh(torch.as_tensor(mesh),
                                              torch.as_tensor(x),
                                              torch.as_tensor(y), TWorld())]
    # the JAX one-hot contraction may fuse the second tap's multiply-add;
    # the port rounds product and sum apart.  The difference is a rounding
    # of a tap term, so it is bounded by 2 ulp of the mesh's scale (it
    # shows as more ulp of a height that cancels near 0)
    assert np.abs(ref[0] - out[0]).max() <= 2 * np.spacing(np.abs(mesh).max())
    assert (ulp_diff(ref[0], out[0]) == 0).mean() > 0.8
    for a, b in zip(ref[1:], out[1:]):
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-6)


@pytest.mark.parametrize("case", ["base", "far", "ties", "wide"])
def test_deepest_hits_grouped_matches(case):
    """The seven-shape scene; objects far from every cobj (first dead slot
    wins); duplicated cobjs on different lanes of a team (first index on
    exact ties); the scene copied to 200 slots."""
    jsp, ins = narrow_case(case, JSC, 2048)
    tsp, _ = narrow_case(case, TSC, 2048)
    jg = JC.group_cobjs(JSC.pack_cobjs(jsp))
    tg = TC.group_cobjs(TSC.pack_cobjs(tsp, device="cpu"))
    ref = [np.asarray(a) for a in JC.deepest_hits_grouped(
        *(jnp.asarray(a) for a in ins), jg)]
    out = [a.numpy() for a in TC.deepest_hits_grouped(
        *(torch.as_tensor(a) for a in ins), tg)]
    pen_all = np.asarray(JC.sphere_cobj_test_grouped(
        *(jnp.asarray(a) for a in ins), jg)[0])
    check_narrow(case, out, ref, pen_all)


def _sorted_population(n=900):
    w = JWorld()
    sw = JPM.build_spheres_world(num_objects=n, world=w)
    st = np_tree(JPS.spatial_sort(sw.state, w))
    rg = np.random.default_rng(8)
    rad = np.full(n, 0.04, np.float32)
    mass = np.linspace(0.5, 2.0, n).astype(np.float32)
    elas = rg.uniform(0.3, 0.9, n).astype(np.float32)
    act = st.status > 0
    act[rg.integers(0, n, 40)] = False
    return (st.px, st.py, st.pz, st.vx, st.vy, st.vz, rad, mass, elas, act)


@pytest.mark.parametrize("window,i_limit", [(48, None), (160, None), (160, 700)])
def test_banded_pair_collisions_match(window, i_limit):
    ins = _sorted_population()
    ref = JPS.banded_pair_collisions(*(jnp.asarray(a) for a in ins),
                                     window=window, i_limit=i_limit)
    out = TPS.banded_pair_collisions(*(torch.as_tensor(a.copy()) for a in ins),
                                     window=window, i_limit=i_limit)
    assert float(np.abs(np.asarray(ref[0])).max()) > 1e-3   # pairs collide
    for a, b in zip(ref, out):
        assert np.abs(np.asarray(a) - b.numpy()).max() < 1e-6


def test_spatial_sort_alive_prefix():
    """Same order on the alive prefix; dead objects (keyed +inf) sort last
    in an unspecified order, as with the unstable lax.sort."""
    w = JWorld()
    sw = JPM.build_spheres_world(num_objects=500, world=w)
    status = np.ones(500, np.int32)
    status[np.random.default_rng(1).integers(0, 500, 60)] = 0
    jst = sw.state._replace(status=jnp.asarray(status))
    ref = np_tree(JPS.spatial_sort(jst, w))
    out = TPS.spatial_sort(convert.object_state(np_tree(jst), "cpu"))
    alive = int((status > 0).sum())
    for name in TPS.ObjectState._fields:
        a = getattr(ref, name)[:alive]
        b = getattr(out, name).numpy()[:alive]
        np.testing.assert_array_equal(a.astype(b.dtype), b, err_msg=name)
    assert (out.status.numpy()[alive:] == 0).all()


@pytest.mark.parametrize("pair_every", [1, 2])
@pytest.mark.parametrize("water", [True, False])
def test_step_objects_matches_jax_banded(pair_every, water):
    world, sw = bumpy_world(300, water)
    ref = np_tree(JPS.step_objects(sw.state, sw.env, sw.cobjs, sw.table,
                                   substeps=3, world=world,
                                   obj_collisions=True, pair_method="banded",
                                   pair_every=pair_every, water=water))
    tsw = convert.spheres_world(np_tree(sw), "cpu")
    out = TPS.step_objects(tsw.state, tsw.env, tsw.cobjs, tsw.table,
                           substeps=3, world=TWorld(), obj_collisions=True,
                           pair_every=pair_every, water=water)
    for name in ("px", "py", "pz", "vx", "vy", "vz"):
        a, b = getattr(ref, name), getattr(out, name).numpy()
        assert np.abs(a - b).max() < 1e-5, (name, float(np.abs(a - b).max()))
    for name in ("status", "flags", "time"):
        a, b = getattr(ref, name), getattr(out, name).numpy()
        np.testing.assert_array_equal(a.astype(b.dtype), b, err_msg=name)
    # the frame exercised contacts (and water), not just free fall
    assert ((ref.flags & int(JT.FL_STATIC_COBJ_COLL)) != 0).sum() > 10
    assert ((ref.flags & int(JT.FL_IN_WATER)) != 0).any() == water
    assert water or len(np.unique(ref.status)) > 1   # some come to rest

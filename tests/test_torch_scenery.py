"""Torch port vs JAX package: the scenery generators (`veg/scenery`:
`gen_logs`, `gen_plants`, `plant_leaf_points`, `gen_rocks`,
`scenery_cobjs`, `voxel_rock_mesh`) on a seeded 64^2 mesh.

Tolerances: placement, hashes, kinds, radii, heights, plant types and
every mesh sample equal (the hash keys truncate `x * 1000` toward zero,
negatives wrapping, in both packages); positions after a cosine or sine
(the logs' far ends and the leaf points) within 1e-6 (the port's are
float64-rounded, XLA's float32 ones an ulp off), the mesh height at a
log's far end within 1e-6 of the height scale; the packed cobj table
within 1e-6, and equal when packed from the JAX sets (`convert`).  The voxel rock's triangles equal given the JAX field (the
JAX function op by op), its field within 1e-5 (the 3-D sine sum contracts in another order; ROADMAP
Queue 3, "Voxel fields near the isolevel")."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import w3d  # noqa: F401
from w3d.veg import scenery as JVS
from w3d.ops import noise as JN
from w3d.utils.constants import WorldConst as JWorld

from w3d_torch import convert
from w3d_torch.veg import scenery as TVS
from w3d_torch.utils.constants import WorldConst as TWorld

from torch_port_util import one_torch_thread, same_tree  # noqa: F401

N = 64
JW, TW = JWorld(mesh_x=N, mesh_y=N), TWorld(mesh_x=N, mesh_y=N)


@pytest.fixture(scope="module")
def scene():
    """A bumpy 64^2 mesh with a water plane through it, scenery placed
    densely over it in both packages (the tile's cells offset by -N/2, so
    half the positions are negative)."""
    rng = np.random.default_rng(2)
    zv = (0.3 * rng.standard_normal((N, N))).astype(np.float32)
    nz = (rng.random((N, N)) > 0.1).astype(np.float32)
    jset = JVS.place_scenery(11, -N / 2, -N / 2, jnp.asarray(zv), jnp.asarray(nz),
                             JW, density=3.0, max_objs=256)
    tset = TVS.place_scenery(11, -N / 2, -N / 2, torch.as_tensor(zv),
                             torch.as_tensor(nz), TW, density=3.0, max_objs=256)
    return zv, jset, tset


def test_placement_matches(scene):
    zv, jset, tset = scene
    same_tree(tset, jset, 0.0, "scenery")
    v = np.asarray(jset.valid)
    kinds = np.asarray(jset.kind)[v]
    assert v.sum() > 100 and len(np.unique(kinds)) == 5
    assert (np.asarray(jset.x)[v] < 0).any()


def test_logs_match(scene):
    zv, jset, tset = scene
    ref = JVS.gen_logs(jset, jnp.asarray(zv), JW)
    out = TVS.gen_logs(tset, torch.as_tensor(zv), TW)
    assert bool(np.asarray(ref.valid).any())
    far = dict(x2=None, y2=None, z2=None)
    same_tree(out._replace(**far), ref._replace(**far), 0.0, "logs")
    for f in ("x2", "y2"):
        same_tree(getattr(out, f), getattr(ref, f), 1e-6, f)
    same_tree(out.z2, ref.z2, 1e-6 * float(np.abs(zv).max()), "z2")


def test_plants_match(scene):
    zv, jset, tset = scene
    ref = JVS.gen_plants(jset, jnp.asarray(zv), JW, water_z=0.0)
    out = TVS.gen_plants(tset, torch.as_tensor(zv), TW, water_z=0.0)
    same_tree(out, ref, 0.0, "plants")
    v = np.asarray(ref.valid)
    pt = np.asarray(ref.ptype)[v]
    assert (pt == JVS.NUM_PLANT_TYPES - 1).any() and (pt < JVS.NUM_PLANT_TYPES - 1).any()
    pts = TVS.plant_leaf_points(out, 3, 5)
    for a, b in zip(pts, JVS.plant_leaf_points(ref, 3, 5)):
        assert a.shape == b.shape
        same_tree(a, b, 1e-6, "leaf points")
    # x and y per leaf, z per ring (the JAX package's layout)
    assert pts[0].shape == (256, 15) and pts[2].shape == (256, 3)


def test_rocks_and_cobjs_match(scene):
    zv, jset, tset = scene
    ref = JVS.gen_rocks(jset, jnp.asarray(zv), JW)
    out = TVS.gen_rocks(tset, torch.as_tensor(zv), TW)
    same_tree(out, ref, 0.0, "rocks")
    jlogs = JVS.gen_logs(jset, jnp.asarray(zv), JW)
    jpl = JVS.gen_plants(jset, jnp.asarray(zv), JW)
    tlogs = TVS.gen_logs(tset, torch.as_tensor(zv), TW)
    tpl = TVS.gen_plants(tset, torch.as_tensor(zv), TW)
    jc = JVS.scenery_cobjs(jset, jlogs, jpl, ref)
    tc = TVS.scenery_cobjs(tset, tlogs, tpl, out, device="cpu")
    assert tc.shape.device.type == "cpu"
    same_tree(tc, jc, 1e-6, "cobjs")
    assert int((np.asarray(jc.shape) > 0).sum()) == int(np.asarray(jset.valid).sum())
    # the JAX sets carried across by `convert` pack to the JAX table exactly
    host = lambda t: jax.tree.map(np.asarray, t)
    cc = TVS.scenery_cobjs(convert.scenery_set(host(jset), "cpu"),
                           convert.log_set(host(jlogs), "cpu"),
                           convert.plant_set(host(jpl), "cpu"),
                           convert.rock_set(host(ref), "cpu"), device="cpu")
    same_tree(cc, jc, 0.0, "cobjs from the JAX sets")


def test_voxel_rock_matches():
    """The rock's triangles equal the JAX mesh given the JAX field, both
    run op by op (compiled, XLA contracts the edge interpolation into one
    rounding: an ulp of the vertices); the field itself within 1e-5."""
    seed, size, res = 5, 0.1, 16
    with jax.disable_jit():
        table = JN.gen_sine_table_3d(1.0, 4.0, seed + 1, seed + 2)
        field = JN.eval_sine3d_grid(table, (-1.0, -1.0, -1.0), (2.0 / (res - 1),) * 3,
                                    res, res, res)
        g = (jnp.arange(res, dtype=jnp.float32) / (res - 1) - 0.5) * 2.0
        r = jnp.sqrt(g[None, None, :] ** 2 + g[None, :, None] ** 2 + g[:, None, None] ** 2)
        jfield = np.array(0.4 * field + (r - 0.7) * 3.0)
        ref = JVS.voxel_rock_mesh(seed, size, res)
    tri = TVS.rock_triangles(torch.as_tensor(jfield), size)
    assert tri.shape == ref.shape and len(ref) > 200
    np.testing.assert_array_equal(tri, np.asarray(ref))
    tfield = TVS.rock_field(seed, res, device="cpu").numpy()
    np.testing.assert_allclose(tfield, jfield, rtol=0, atol=1e-5)
    own = TVS.voxel_rock_mesh(seed, size, res, device="cpu")
    assert own.shape[1:] == (3, 3) and np.abs(own).max() <= 0.12

"""Torch port vs JAX package on a cobj table wider than one shared-memory
chunk of kernels C and G (M = 536 slots, 384 rows a chunk): the grouped
narrow phase, one unfused `step_objects` frame (the JAX `_substep` takes
its XLA `deepest_hits_grouped` past the Pallas kernel's rows) and one
fused frame (the JAX `substep_pallas` in interpret mode); and the kernels'
table cache following edits of a scene.

The scene (`kernel_probe.wide_scene(8)`) has every shape group, dead
padding slots, and four spheres duplicated exactly under another layer,
so objects inside them tie on rows far apart in the table.

Tolerances, the reference's own: narrow phase hit mask and first index
exact, pen 1e-5 (`torch_port_util.check_narrow`); frames 1e-5 on
positions and velocities with status, flags and time exact.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import w3d  # noqa: F401
from w3d.physics import cobjs as JC
from w3d.physics import step as JPS
from w3d.physics import types as JT
from w3d.scene import cobj as JSC

from w3d_torch import convert
from w3d_torch.ops.cuda import narrow_kernel as NK
from w3d_torch.physics import cobjs as TC
from w3d_torch.physics import step as TPS
from w3d_torch.scene import cobj as TSC
from w3d_torch.utils.constants import WorldConst as TWorld

from torch_port_util import bumpy_world, check_narrow, np_tree, wide_scene

N = 128
COPIES = 8          # M = 536: two chunks of the kernels' 384 rows


def _scenes():
    """(JAX grouped cobjs, port grouped cobjs) of the wide scene, each
    package packing and grouping it itself."""
    jg = JC.group_cobjs(JSC.pack_cobjs(wide_scene(COPIES, JSC)))
    tg = TC.group_cobjs(TSC.pack_cobjs(wide_scene(COPIES, TSC), device="cpu"))
    assert tg.size == jg.size == 536 > NK.CHUNK_ROWS
    assert tg.bounds == tuple(tuple(b) for b in jg.bounds)
    return jg, tg


def test_deepest_hits_grouped_matches_wide():
    jg, tg = _scenes()
    rg = np.random.default_rng(6)
    ins = [rg.uniform(-2.5, 2.5, N).astype(np.float32) for _ in range(3)]
    ins.append(rg.uniform(0.02, 0.2, N).astype(np.float32))
    # a quarter of the objects inside the first duplicated sphere
    s = next(c for c in wide_scene(COPIES, TSC).cobjs if c.shape == TSC.COLL_SPHERE)
    for a in range(3):
        ins[a][:N // 4] = (s.p1[a] + rg.uniform(-0.5, 0.5, N // 4) * s.r1).astype(np.float32)
    ref = [np.asarray(a) for a in JC.deepest_hits_grouped(
        *(jnp.asarray(a) for a in ins), jg)]
    out = [a.numpy() for a in TC.deepest_hits_grouped(
        *(torch.as_tensor(a) for a in ins), tg)]
    pen_all = np.asarray(JC.sphere_cobj_test_grouped(
        *(jnp.asarray(a) for a in ins), jg)[0])
    check_narrow("wide", out, ref, pen_all)
    # the duplicated rows tie, and the first of them (the scene's own
    # layer, elasticity 0.8) wins in both packages
    top2 = -np.sort(-pen_all, axis=1)[:, :2]
    tie = ref[0] & (top2[:, 0] == top2[:, 1])
    assert tie.sum() > N // 8
    assert (ref[5][tie] == np.float32(0.8)).all()
    for k in (5, 6):
        np.testing.assert_array_equal(out[k][tie], ref[k][tie])
    # winners lie in both chunks
    win = np.argmax(pen_all, axis=1)[ref[0]]
    assert (win < NK.CHUNK_ROWS).any() and (win >= NK.CHUNK_ROWS).any()


def _wide_world(water):
    world, sw = bumpy_world(N, water)
    jg, tg = _scenes()
    sw = sw._replace(cobjs=jg)
    tsw = convert.spheres_world(np_tree(sw), "cpu")
    return world, sw, tsw


def _check_frame(ref, out):
    for name in ("px", "py", "pz", "vx", "vy", "vz"):
        a, b = getattr(ref, name), getattr(out, name).numpy()
        assert np.abs(a - b).max() < 1e-5, (name, float(np.abs(a - b).max()))
    for name in ("status", "flags", "time"):
        a, b = getattr(ref, name), getattr(out, name).numpy()
        np.testing.assert_array_equal(a.astype(b.dtype), b, err_msg=name)
    assert ((ref.flags & int(JT.FL_STATIC_COBJ_COLL)) != 0).sum() > 10


@pytest.mark.parametrize("water", [True, False])
def test_step_objects_wide_matches_jax(water):
    """The JAX frame runs op by op (`jax.disable_jit`): compiled, XLA's CPU
    fusion rounds the capsule formula's normal a few ulp apart, and an
    object deep inside a thin capsule (normal = offset / a small distance)
    turns that into 2.5e-5 of bounce velocity in the first substep."""
    world, sw, tsw = _wide_world(water)
    with jax.disable_jit():
        ref = np_tree(JPS.step_objects(sw.state, sw.env, sw.cobjs, sw.table,
                                       substeps=2, world=world,
                                       obj_collisions=True,
                                       pair_method="banded", water=water))
    out = TPS.step_objects(tsw.state, tsw.env, tsw.cobjs, tsw.table,
                           substeps=2, world=TWorld(), obj_collisions=True,
                           water=water)
    _check_frame(ref, out)


def test_step_objects_fused_wide_matches_jax():
    world, sw, tsw = _wide_world(True)
    ref = np_tree(JPS.step_objects_fused(
        sw.state, sw.env, sw.cobjs, sw.table, substeps=2, world=world,
        Nb=128, interpret=True))
    out = TPS.step_objects_fused(tsw.state, tsw.env, tsw.cobjs, tsw.table,
                                 substeps=2, world=TWorld())
    _check_frame(ref, out)


def _fresh(g, tabs):
    """`tabs` is a new packing of `g` as it stands now."""
    cf = NK.pack_cobj_fields(g)
    assert torch.equal(tabs[0], cf)
    assert torch.equal(tabs[2], NK.field_major(cf))
    assert tabs[1].tolist() == list(g.padded_starts)


@pytest.mark.parametrize("edit", ["in_place", "reassigned"])
def test_kernel_tables_follow_edits(edit):
    """The tables are reused while the scene is unchanged, and packed
    anew after an in-place edit of a cobj tensor or a reassignment of
    `g.cobjs`."""
    g = TC.group_cobjs(TSC.pack_cobjs(wide_scene(1, TSC), device="cpu"))
    old = NK.kernel_tables(g)
    assert NK.kernel_tables(g) is old
    before = old[0].clone()
    if edit == "in_place":
        g.cobjs.p1[3, 0] += 0.25            # a moving platform's kind of edit
    else:
        g.cobjs = g.cobjs._replace(elasticity=g.cobjs.elasticity * 0.5)
    new = NK.kernel_tables(g)
    assert new is not old and torch.equal(old[0], before)
    _fresh(g, new)
    assert not torch.equal(new[0], before)
    assert NK.kernel_tables(g) is new

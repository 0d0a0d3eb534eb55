"""Torch port vs JAX package: the fused physics substep (kernel G's plain
version `physics/fused.substep_plain` against the Pallas `substep_pallas`
in interpret mode), its inputs (`mesh_maps`, the packed cobj table), and
the fused frame `step_objects_fused`.

Tolerances: the map stack and the cobj table bitwise; a substep and a
frame within 1e-5 on positions and velocities (the JAX package's own
bound for the fused frame, tests/test_pallas.py) with status, flags and
time exact.  The JAX fused frame runs its pair pass on the block path off
the TPU and the port on the banded one; the two sum the same pair terms
in another order.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import jax.numpy as jnp
import torch

import w3d  # noqa: F401
from w3d.ops.pallas.physics_kernel import (mesh_maps as jax_mesh_maps,
                                           pack_cobj_fields as jax_pack,
                                           substep_pallas)
from w3d.physics import cobjs as JC
from w3d.physics import step as JPS
from w3d.physics import types as JT
from w3d.scene import cobj as JSC

from w3d_torch import convert
from w3d_torch.ops.cuda import narrow_kernel as NK
from w3d_torch.ops.cuda import physics_kernel as GK
from w3d_torch.physics.cobj_table import CF_COLUMNS, CF_INDEX, CF_PAD
from w3d_torch.physics import cobjs as TC
from w3d_torch.physics import fused as TF
from w3d_torch.physics import step as TPS
from w3d_torch.scene import cobj as TSC
from w3d_torch.utils.constants import WorldConst as TWorld

from torch_port_util import (bumpy_world, into_tied_sphere, np_tree,
                             seven_shape_scene, tied_spheres_scene)

N = 128
NAMES = ("px", "py", "pz", "vx", "vy", "vz", "status", "flags")


def _cobjs(scene):
    """(JAX grouped cobjs, port grouped cobjs) of one scene."""
    if scene == "spheres":
        _, sw = bumpy_world(8, False)
        jg = sw.cobjs
    elif scene == "tied_spheres":
        jg = JC.group_cobjs(JSC.pack_cobjs(tied_spheres_scene(JSC)[0]))
    else:
        jg = JC.group_cobjs(JSC.pack_cobjs(seven_shape_scene(JSC)))
    return jg, convert.grouped_cobjs(np_tree(jg), "cpu")


@pytest.mark.parametrize("scene", ["spheres", "seven_shapes"])
def test_mesh_maps_and_cobj_table_match(scene):
    world, sw = bumpy_world(8, False)
    mesh = np.asarray(sw.env.mesh_height)
    ref = np.asarray(jax_mesh_maps(jnp.asarray(mesh), world))
    out = GK.mesh_maps(convert.array(mesh, "cpu"), TWorld())
    np.testing.assert_array_equal(ref, out.numpy())
    jg, tg = _cobjs(scene)
    if scene == "seven_shapes":   # the port groups its own scene the same way
        tg = TC.group_cobjs(TSC.pack_cobjs(seven_shape_scene(TSC), device="cpu"))
    np.testing.assert_array_equal(np.asarray(jax_pack(jg)),
                                  NK.pack_cobj_fields(tg).numpy())


def _substep_inputs(water):
    """Bumpy-world positions and velocities with random status, flag bits
    and per-object params, so every branch of the substep sees objects."""
    world, sw = bumpy_world(N, water)
    st = np_tree(sw.state)
    rng = np.random.default_rng(5)
    status = rng.integers(0, 5, N).astype(np.int32)
    flags = rng.integers(0, 1 << 7, N).astype(np.int32)
    f32 = lambda lo, hi: rng.uniform(lo, hi, N).astype(np.float32)
    params = [f32(0.02, 0.1), f32(0.0, 0.3), f32(0.0, 1.3), f32(0.5, 1.5),
              f32(0.2, 1.0), f32(0.3, 2.0), f32(5.0, 30.0)]
    pz = st.pz - rng.choice(np.float32([0.0, 0.5]), N)   # some reach the mesh
    state = [st.px, st.py, pz, st.vx, st.vy, st.vz, status, flags]
    env = np.array([0.0035, 1.0, 0.4, 0.2, -0.1,
                    float(sw.env.water_plane_z), world.dx_inv, world.dy_inv,
                    world.x_scene, world.dx, world.dy, 0.0], np.float32)
    maps3 = np.asarray(jax_mesh_maps(sw.env.mesh_height, world))
    return state + params, maps3, env


def _check_substep(ins, maps3, env, jg, tg):
    """Hold `substep_plain` (and the wrapper on CPU tensors) against the JAX
    `substep_pallas` in interpret mode; returns the JAX outputs."""
    cf = np.asarray(jax_pack(jg))
    ref = [np.asarray(a) for a in substep_pallas(
        *(jnp.asarray(a) for a in ins), jnp.asarray(maps3), jnp.asarray(cf),
        jnp.asarray(env), Nb=128, interpret=True)]
    tabs = NK.kernel_tables(tg)
    targs = (*(convert.array(a, "cpu") for a in ins), convert.array(maps3, "cpu"))
    tenv = convert.array(env, "cpu")
    out = TF.substep_plain(*targs, tabs[0], tenv)
    for name, a, b in zip(NAMES, ref, out):
        if name in ("status", "flags"):
            np.testing.assert_array_equal(a, b.numpy(), err_msg=name)
        else:
            assert np.abs(a - b.numpy()).max() < 1e-5, (name, np.abs(a - b.numpy()).max())
    # the wrapper takes the plain version for CPU tensors
    for a, b in zip(out, GK.substep(*targs, tabs, tenv)):
        assert torch.equal(a, b)
    return ref


@pytest.mark.parametrize("water", [True, False])
@pytest.mark.parametrize("scene", ["spheres", "seven_shapes"])
def test_substep_plain_matches_pallas(scene, water):
    ins, maps3, env = _substep_inputs(water)
    ref = _check_substep(ins, maps3, env, *_cobjs(scene))
    # the substep exercised cobj hits, stops, rolling, kills and water
    # (when present)
    flags = ref[7]
    assert ((flags & int(JT.FL_STATIC_COBJ_COLL)) != 0).sum() > 10
    assert len(np.unique(ref[6])) >= 4
    wet = int(JT.FL_IN_WATER | JT.FL_UNDERWATER | JT.FL_FLOATING)
    assert bool((flags & ~ins[7] & wet).any()) == water   # objects entered water


def test_substep_plain_averages_tied_rows():
    """Half the objects inside three coincident spheres of different
    elasticity and friction: every such hit averages three rows tied at a
    positive pen, as the JAX kernel does."""
    ins, maps3, env = _substep_inputs(False)
    _, centre, radius = tied_spheres_scene(JSC)
    ins[:3] = into_tied_sphere(*ins[:3], centre, radius, N // 2)
    jg, tg = _cobjs("tied_spheres")
    ref = _check_substep(ins, maps3, env, jg, tg)
    # the three rows tie on every object inside the sphere
    pen = TF._narrow(NK.kernel_tables(tg)[0], *(convert.array(a, "cpu")[None, :]
                                                for a in (ins[0], ins[1], ins[2], ins[8])))[0]
    top = pen.max(dim=0).values
    ties = ((pen == top) & (top > 0)).sum(dim=0)[:N // 2]
    assert (ties == 3).all()
    hits = (ref[7][:N // 2] & int(JT.FL_STATIC_COBJ_COLL)) != 0
    assert hits.sum() > N // 4


# pair_every 2 over 2 substeps runs the pair pass on the first substep
# and skips it on the second, the cadence of the 10K fused frame
@pytest.mark.parametrize("obj_collisions,pair_every",
                         [(False, 1), (True, 1), (True, 2)])
def test_step_objects_fused_matches_jax(obj_collisions, pair_every):
    world, sw = bumpy_world(N, True)
    st = sw.state   # a tight pile, so the pair pass has contacts
    sw = sw._replace(state=st._replace(px=st.px * 0.1, py=st.py * 0.1))
    ref = np_tree(JPS.step_objects_fused(
        sw.state, sw.env, sw.cobjs, sw.table, substeps=2, world=world,
        obj_collisions=obj_collisions, Nb=128, interpret=True,
        pair_every=pair_every))
    tsw = convert.spheres_world(np_tree(sw), "cpu")
    out = TPS.step_objects_fused(tsw.state, tsw.env, tsw.cobjs, tsw.table,
                                 substeps=2, world=TWorld(),
                                 obj_collisions=obj_collisions,
                                 pair_every=pair_every)
    for name in ("px", "py", "pz", "vx", "vy", "vz"):
        a, b = getattr(ref, name), getattr(out, name).numpy()
        assert np.abs(a - b).max() < 1e-5, (name, float(np.abs(a - b).max()))
    for name in ("status", "flags", "time"):
        a, b = getattr(ref, name), getattr(out, name).numpy()
        np.testing.assert_array_equal(a.astype(b.dtype), b, err_msg=name)
    assert ((ref.flags & int(JT.FL_STATIC_COBJ_COLL)) != 0).sum() > 10
    assert ((ref.flags & int(JT.FL_IN_WATER)) != 0).any()
    if obj_collisions:   # the pair pass moved objects
        free = TPS.step_objects_fused(TPS.spatial_sort(tsw.state), tsw.env,
                                      tsw.cobjs, tsw.table, substeps=2,
                                      world=TWorld(), obj_collisions=False)
        assert int((free.px != out.px).sum()) > 10
    if pair_every == 2:   # the skipped pass changed the frame
        every = TPS.step_objects_fused(tsw.state, tsw.env, tsw.cobjs,
                                       tsw.table, substeps=2, world=TWorld())
        assert int((every.px != out.px).sum()) > 10


# C constant in csrc/cobj_shapes.cuh -> packed table column it names
_CUH_COLUMNS = {"C_SHAPE": "shape", "C_P1": "p1x", "C_P2": "p2x", "C_R1": "r1",
                "C_R2": "r2", "C_NPTS": "npts", "C_PTS": "pt0x", "C_PN": "pnx",
                "C_ELAS": "elas", "C_FRIC": "fric"}


def test_cobj_table_columns_match_cuda_header():
    src = (Path(GK.__file__).parents[2] / "csrc" / "cobj_shapes.cuh").read_text()
    consts = {k: int(v) for k, v in re.findall(r"\b(C_[A-Z0-9]+|CF) = (\d+)", src)}
    assert consts.pop("CF") == CF_PAD
    assert int(re.search(r"\bCF_USED = (\d+)", src).group(1)) == len(CF_COLUMNS)
    assert consts == {k: CF_INDEX[v] for k, v in _CUH_COLUMNS.items()}
    # the pt and pn blocks are contiguous xyz triples, as the kernels read them
    assert CF_INDEX["pt3z"] == CF_INDEX["pt0x"] + 11
    assert CF_INDEX["pnz"] == CF_INDEX["pnx"] + 2
    # and the packer writes the columns the names say, zeros after them
    c = _cobjs("seven_shapes")[1].cobjs
    tab = NK.pack_cobj_fields(c)
    assert tab.shape[1] == CF_PAD and not tab[:, len(CF_COLUMNS):].any()
    for name, col in (("r1", c.r1), ("elas", c.elasticity), ("fric", c.friction),
                      ("pt2y", c.pts[:, 2, 1]), ("pnz", c.pnorm[:, 2])):
        assert torch.equal(tab[:, CF_INDEX[name]], col), name
    # the narrow kernel's field-major copy: used columns as rows, padded to
    # a multiple of 4 rows
    fm = NK.field_major(tab[:-3])
    assert fm.shape == (len(CF_COLUMNS), c.size) and fm.is_contiguous()
    assert torch.equal(fm[:, :c.size - 3], tab[:-3, :len(CF_COLUMNS)].t())
    assert not fm[:, c.size - 3:].any()
    fm = NK.field_major(tab)
    assert fm.shape == (len(CF_COLUMNS), c.size) and fm.is_contiguous()
    assert torch.equal(fm[:, :c.size], tab[:, :len(CF_COLUMNS)].t())
    assert not fm[:, c.size:].any()
    # a table of several shared-memory chunks packs the same way
    wide = torch.arange(NK.CHUNK_ROWS * 4 + 1, dtype=torch.float32)[:, None] \
        + torch.zeros(CF_PAD)
    fm = NK.field_major(wide)
    assert fm.shape == (len(CF_COLUMNS), NK.CHUNK_ROWS * 4 + 4)
    assert torch.equal(fm[:, :wide.shape[0]], wide[:, :len(CF_COLUMNS)].t())
    assert not fm[:, wide.shape[0]:].any()

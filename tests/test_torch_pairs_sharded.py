"""Torch port vs JAX package: the pair pass across rank edges
(`w3d_torch/parallel/pairs.py`), the sharded frame with and without
collisions (`models/physics_model.make_sharded_frame_step`) and the
sharded combined step (`entry.make_sharded_combined_step`).

One 4-rank gloo group on the CPU (`torch_rank_cases.pair_cases`) runs
every case once, in a module fixture; the JAX side runs here on a
4-device mesh of conftest's virtual CPU devices, with the banded pair
pass (`method="banded"`, the one the port's kernel D replaces on the
TPU).  Bounds: pair deltas within rtol 1e-5, atol 1e-6
(tests/test_pairs_sharded.py); frames as tests/test_torch_physics.py
holds `step_objects` (positions and velocities within 1e-5, status, flags
and time exact) against the JAX sharded step compiled with
`jax_disable_most_optimizations`, and at tests/test_pairs_sharded.py's
bound for a sharded frame (rtol 2e-4, atol 2e-5) against the optimised
one: XLA's optimised CPU code rounds a few operations otherwise (measured:
one ball's vy 1.05e-5 from the port, which equals the JAX frame run op by
op there; unoptimised, 5.2e-6 at most); tiles within 1e-3 of the JAX tiles
at erode_amount 0.01 (test_torch_entry's bound) and bitwise the port's
single-rank call."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
from jax import shard_map
from jax.sharding import Mesh as JMesh, NamedSharding, PartitionSpec as P

import w3d  # noqa: F401
from w3d.models import physics_model as JPM
from w3d.models import terrain_model as JTM
from w3d.parallel.pairs import make_halo_pair_fn, make_step_objects_sharded
from w3d.physics import step as JPS
from w3d.terrain import mesh as JM
from w3d.utils.constants import WorldConst as JWorld

from w3d_torch import convert, entry
from w3d_torch.models import terrain_model as TTM
from w3d_torch.physics import step as TPS
from w3d_torch.parallel import launch
from w3d_torch.terrain import mesh as TTMESH
from w3d_torch.utils.constants import WorldConst as TWorld

import torch_rank_cases
from torch_port_util import jax_angle_tables, np_tree

RANKS = 4
N, WINDOW, SUBSTEPS, FRAMES = 1024, 64, 2, 2
JW, TW = JWorld(mesh_x=32, mesh_y=32), TWorld(mesh_x=32, mesh_y=32)
TILE_KW = dict(tile_size=32, erosion_iters_tt=150, erosion_batch=128, erosion_steps=8,
               use_pallas_erosion=False)


def _rand_cols(n, seed=0):
    """An x-sorted dense population with many contacts
    (tests/test_pairs_sharded.py's)."""
    rng = np.random.default_rng(seed)
    px = np.sort(rng.uniform(-0.35, 0.35, n)).astype(np.float32)
    py = rng.uniform(-0.35, 0.35, n).astype(np.float32)
    pz = rng.uniform(0.0, 0.3, n).astype(np.float32)
    vx, vy, vz = (rng.normal(0, 0.5, n).astype(np.float32) for _ in range(3))
    rad = rng.uniform(0.02, 0.04, n).astype(np.float32)
    mass = rng.uniform(0.5, 2.0, n).astype(np.float32)
    elas = rng.uniform(0.3, 0.9, n).astype(np.float32)
    act = rng.uniform(0, 1, n) > 0.05
    return (px, py, pz, vx, vy, vz, rad, mass, elas, act)


def _bumpy():
    """The JAX spheres world on the 32² world: N balls spawned close to a
    bumpy mesh, fast and mostly downward, so cobj and pair contacts happen
    in the first substeps (torch_port_util.bumpy_world's spawn)."""
    sw = JPM.build_spheres_world(num_objects=N, world=JW, seed=3)
    mesh = jnp.asarray(np.random.default_rng(3).standard_normal((32, 32))
                       .astype(np.float32) * 0.3 - 0.5)
    st = sw.state
    st = st._replace(pz=st.pz * 0.25 - 0.3, vx=st.vx * 12, vy=st.vy * 12,
                     vz=st.vz * 12 - 4.0)
    return sw._replace(env=sw.env._replace(mesh_height=mesh), state=st)


def _jmesh():
    return JMesh(np.array(jax.devices()[:RANKS]), axis_names=("objs",))


def _tile_args():
    jm = JTM.TileModelConfig(cfg=JM.TerrainConfig(erode_amount=0.01), **TILE_KW)
    tm = TTM.TileModelConfig(cfg=TTMESH.TerrainConfig(erode_amount=0.01), **TILE_KW)
    jargs = JTM.example_inputs(jm, JW, num_tiles=RANKS)
    targs = convert.tile_inputs(jax.tree.map(np.asarray, jargs[0]), *jargs[1:], "cpu")
    return (jm, jargs), (tm, (*targs, torch.as_tensor(jax_angle_tables(150, 128, 8))))


@pytest.fixture(scope="module")
def case():
    """(JAX world, port world, rank results): every rank's outputs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        jsw = _bumpy()
        tsw = convert.spheres_world(np_tree(jsw), "cpu")
        _, (tm, targs) = _tile_args()
        inp = dict(cols=tuple(torch.as_tensor(a) for a in _rand_cols(N)), window=WINDOW,
                   world=tsw, world_const=TW, substeps=SUBSTEPS, pair_every=1,
                   frames=FRAMES, combined=(tm, TW, tsw, targs))
        res = launch.run_ranks(torch_rank_cases.pair_cases, RANKS, "gloo", "cpu", inp)
        return jsw, tsw, [r.value for r in res]
    finally:
        torch.set_num_threads(n)


def _jax_frames(jsw, frames, optimised, env=None):
    """`frames` JAX sharded frames on the 4-device mesh, compiled with or
    without XLA's optimisations."""
    was = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", not optimised)
    try:
        step = make_step_objects_sharded(_jmesh(), axis="objs", substeps=SUBSTEPS, world=JW,
                                         window=WINDOW, method="banded")
        st, out = jsw.state, []
        with _jmesh():
            for _ in range(frames):
                st = step(st, env if env is not None else jsw.env, jsw.cobjs, jsw.table)
                out.append(np_tree(st))
        return out
    finally:
        jax.config.update("jax_disable_most_optimizations", was)


@pytest.fixture(scope="module")
def jax_frames(case):
    jsw = case[0]
    return {opt: _jax_frames(jsw, FRAMES, opt) for opt in (False, True)}


def _same_frame(ref, out, what, rtol=0.0, atol=1e-5):
    for name in ("px", "py", "pz", "vx", "vy", "vz"):
        a, b = np.asarray(getattr(ref, name)), getattr(out, name).numpy()
        err = np.abs(a - b) - rtol * np.abs(a)
        assert err.max() < atol, (what, name, float(np.abs(a - b).max()))
    for name in ("status", "flags", "time"):
        a, b = np.asarray(getattr(ref, name)), getattr(out, name).numpy()
        np.testing.assert_array_equal(a.astype(b.dtype), b, err_msg=f"{what} {name}")


def test_halo_pair_fn_matches_jax(case):
    """Gathered deltas against the JAX halo pair function under shard_map
    and against the single-device banded pass."""
    _, _, out = case
    cols = tuple(jnp.asarray(a) for a in _rand_cols(N))
    single = JPS.banded_pair_collisions(*cols, window=WINDOW)
    m = _jmesh()
    fn = make_halo_pair_fn("objs", RANKS, window=WINDOW, method="banded")
    sh = NamedSharding(m, P("objs"))

    @jax.jit
    def run(*cs):
        cs = [jax.lax.with_sharding_constraint(c, sh) for c in cs]
        return shard_map(fn, mesh=m, in_specs=P("objs"), out_specs=P("objs"),
                         check_vma=False)(*cs)

    sharded = run(*cols)
    assert float(np.abs(np.asarray(single[0])).max()) > 1e-3     # pairs collide
    for o in out:
        for ref_s, ref_j, got in zip(single, sharded, o["pairs"]):
            np.testing.assert_allclose(got.numpy(), np.asarray(ref_s), rtol=1e-5, atol=1e-6)
            np.testing.assert_allclose(got.numpy(), np.asarray(ref_j), rtol=1e-5, atol=1e-6)


def test_halo_pair_fn_cross_boundary_contacts_exist():
    """The population has contacts across every rank edge, so the halo
    carries pairs (else the equivalence proves nothing)."""
    px, py, pz, _, _, _, rad, _, _, act = _rand_cols(N)
    nl = N // RANKS
    for b in range(1, RANKS):
        lo, crossing = b * nl, 0
        for i in range(lo - WINDOW, lo):
            j = np.arange(lo, min(N, i + WINDOW + 1))
            d = np.sqrt((px[i] - px[j]) ** 2 + (py[i] - py[j]) ** 2 + (pz[i] - pz[j]) ** 2)
            crossing += int((act[i] & act[j] & (d < rad[i] + rad[j])).sum())
        assert crossing > 10, (b, crossing)


def test_window_wider_than_the_slab_is_refused(case):
    for o in case[2]:
        assert "needs window" in o["wide_window"] and "<= local slab (256)" in o["wide_window"]


@pytest.mark.parametrize("frame", range(FRAMES))
def test_sharded_frames_match_jax_and_single_rank(case, jax_frames, frame):
    """Frames with the halo pair pass against the JAX
    `make_step_objects_sharded(method="banded")` on a 4-device mesh, and
    against the port's single-rank `step_objects`."""
    _, tsw, out = case
    tst = tsw.state
    for _ in range(frame + 1):
        tst = TPS.step_objects(tst, tsw.env, tsw.cobjs, tsw.table, substeps=SUBSTEPS,
                               world=TW, obj_collisions=True, pair_window=WINDOW)
    ref, ref_opt = jax_frames[False][frame], jax_frames[True][frame]
    for o in out:
        _same_frame(ref, o["frames"][frame], "vs JAX sharded, unoptimised")
        _same_frame(ref_opt, o["frames"][frame], "vs JAX sharded", rtol=2e-4, atol=2e-5)
        _same_frame(convert.to_numpy(tst), o["frames"][frame], "vs port single rank")
    # the frames had pair and cobj contacts, and some objects came to rest
    assert (ref.status != 1).any()
    assert (ref.flags != 0).sum() > 50


def test_frame_without_collisions(case):
    """Each rank steps its slab alone: bitwise the port's single-rank frame,
    and within 1e-5 of the JAX sharded frame without collisions."""
    jsw, tsw, out = case
    with _jmesh():
        ref = np_tree(JPM.make_sharded_frame_step(_jmesh(), substeps=SUBSTEPS, world=JW,
                                                  obj_collisions=False)(jsw).state)
    single = TPS.step_objects(tsw.state, tsw.env, tsw.cobjs, tsw.table, substeps=SUBSTEPS,
                              world=TW, obj_collisions=False)
    for o in out:
        _same_frame(ref, o["free"], "vs JAX")
        for a, b in zip(single, o["free"]):
            assert torch.equal(a, b)


def test_sharded_combined_step(case):
    """The combined step over ranks: tiles bitwise the port's single-rank
    `combined_step` and within 1e-3 of the JAX tiles; the frame over tile 0
    (broadcast from rank 0) against the JAX sharded frame over the JAX
    tile 0 and against the port's single-rank `combined_step`."""
    jsw, tsw, out = case
    (jm, jargs), (tm, targs) = _tile_args()
    jtiles = JTM.tile_batch_step(*jargs, jm, JW)
    jst = _jax_frames(jsw, 1, False, jsw.env._replace(mesh_height=jtiles[0]))[0]
    tiles1, st1 = entry.combined_step(*targs, tsw.state, tsw, tm, TW, substeps=SUBSTEPS)
    for o in out:
        tiles, st = o["combined"]
        assert tiles.shape == (RANKS, 32, 32)
        assert torch.equal(tiles, tiles1)
        np.testing.assert_allclose(tiles.numpy(), np.asarray(jtiles), rtol=0, atol=1e-3)
        _same_frame(convert.to_numpy(st1), st, "vs port single rank")
    # the JAX frame ran over tiles a few ulp away: it is held where its mesh
    # does not matter (the balls stay over the ground cube, far above tile 0)
    assert float(np.asarray(jtiles[0]).max()) < -5.0
    _same_frame(jst, out[0]["combined"][1], "vs JAX sharded, unoptimised")

"""Torch port vs JAX package: the device mesh, ring shifts, the AO halo
context, the shadow scan across ranks (exact and carry) and the sharded
tile step (`w3d_torch/parallel/`, `models/terrain_model`).

One 4-rank gloo group on the CPU (`parallel.launch.run_ranks`, the rank
side in `torch_rank_cases.parallel_cases`) runs every case once, in a
module fixture; the JAX side runs here on a 4-device mesh of conftest's 8
virtual CPU devices.  Masks, shifts and halos exact; the sharded tile step
bitwise against the port's single-rank call and within 1e-3 of the JAX
sharded step at erode_amount 0.01 (the droplet walk turns the packages'
few-ulp height differences into branch flips: test_torch_terrain's
bound)."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
from jax.sharding import Mesh as JMesh, NamedSharding, PartitionSpec as P

import w3d  # noqa: F401
from w3d.models import terrain_model as JTM
from w3d.ops import shadows as JSH
from w3d.parallel import halo as JPH
from w3d.terrain import mesh as JM
from w3d.utils.constants import WorldConst as JWorld

from w3d_torch import convert
from w3d_torch.models import terrain_model as TTM
from w3d_torch.ops import shadows as TSH
from w3d_torch.parallel import launch, mesh as TMESH
from w3d_torch.physics import step as TPS, types as TT
from w3d_torch.terrain import mesh as TTMESH
from w3d_torch.utils.constants import WorldConst as TWorld

import torch_rank_cases
from torch_port_util import jax_angle_tables

RANKS = 4
CELL_W = 0.0625
AXIS = (-1.0, 0.0, 0.3)
DRIFT = (-1.0, 0.35, 0.3)


def _walls():
    """Flat tiles with two walls whose shadows cross rank edges, either way."""
    z = np.zeros((8, 32, 32), np.float32)
    z[2, :, 16] = 3.0
    z[5, :, 10] = 1.5
    return z


def _rough():
    return np.random.default_rng(11).uniform(0.0, 2.0, (8, 16, 16)).astype(np.float32)


SHADOW_CASES = {"walls_from_-x": (_walls, AXIS, "exact"),
                "walls_from_+x": (_walls, (1.0, 0.0, 0.3), "exact"),
                "rough_exact": (_rough, AXIS, "exact"),
                "rough_carry": (_rough, AXIS, "carry"),
                "rough_drift_exact": (_rough, DRIFT, "exact"),
                "rough_drift_carry": (_rough, DRIFT, "carry")}


def _jmesh():
    return JMesh(np.array(jax.devices()[:RANKS]), axis_names=("tiles",))


def _tile_setup():
    jw, tw = JWorld(mesh_x=32, mesh_y=32), TWorld(mesh_x=32, mesh_y=32)
    kw = dict(tile_size=32, erosion_iters_tt=150, erosion_batch=128, erosion_steps=8,
              use_pallas_erosion=False)
    jm = JTM.TileModelConfig(cfg=JM.TerrainConfig(erode_amount=0.01), **kw)
    tm = TTM.TileModelConfig(cfg=TTMESH.TerrainConfig(erode_amount=0.01), **kw)
    jargs = JTM.example_inputs(jm, jw, num_tiles=8)
    targs = convert.tile_inputs(jax.tree.map(np.asarray, jargs[0]), *jargs[1:], "cpu")
    ang = torch.as_tensor(jax_angle_tables(150, 128, 8))
    return (jm, jw, jargs), (tm, tw, (*targs, ang))


@pytest.fixture(scope="module")
def ranks():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        cases = {}
        for name, (make, light, mode) in SHADOW_CASES.items():
            z = torch.as_tensor(make())
            cases[name] = (z, light, mode, torch.full((z.shape[1],), TSH.MESH_MIN_Z))
        _, (tm, tw, targs) = _tile_setup()
        table = TT.make_type_table(device="cpu")
        pos = torch.as_tensor(np.random.default_rng(2).normal(size=(16, 3)).astype(np.float32))
        inp = dict(rows=torch.arange(48, dtype=torch.float32).reshape(16, 3),
                   state=TPS.make_state(pos, -pos, torch.arange(16) % 3, table),
                   halo=4, ctx_z=torch.arange(8 * 16 * 16, dtype=torch.float32).reshape(8, 16, 16),
                   shadow_cases=cases, cell_w=CELL_W, tile_cfg=(tm, tw), tile_args=targs)
        res = launch.run_ranks(torch_rank_cases.parallel_cases, RANKS, "gloo", "cpu", inp)
        return inp, [r.value for r in res]
    finally:
        torch.set_num_threads(n)


def test_mesh_blocks_and_gather(ranks):
    inp, out = ranks
    for r, o in enumerate(out):
        assert o["mesh"] == (r, RANKS, "gloo", "cpu")
        assert o["pad"] == TMESH.pad_to_multiple(10, RANKS) == 12
        assert torch.equal(o["block"], inp["rows"][4 * r:4 * r + 4])
        for name, a, b in zip(TPS.ObjectState._fields, o["gathered_state"], inp["state"]):
            assert a.dtype == b.dtype and torch.equal(a, b), name


def test_halo_shift_is_the_ring_ppermute(ranks):
    _, out = ranks
    for r, o in enumerate(out):
        for s, got in o["shift"].items():
            assert torch.equal(got, torch.full((3,), float((r - s) % RANKS))), (r, s)


def test_halo_context_matches_jax(ranks):
    inp, out = ranks
    halo, z = inp["halo"], inp["ctx_z"].numpy()
    m = _jmesh()
    with m:
        zs = jax.device_put(jnp.asarray(z), NamedSharding(m, P("tiles")))
        ref = np.asarray(JPH.make_halo_context(m, halo=halo)(zs))
    for o in out:
        np.testing.assert_array_equal(o["ctx"].numpy(), ref)
    ctx = out[0]["ctx"].numpy()
    assert ctx.shape == (8, 16, 16 + 2 * halo)
    np.testing.assert_array_equal(ctx[:, :, halo:halo + 16], z)
    # tile 2 is rank 1's first tile: its left halo is rank 0's last tile's edge
    np.testing.assert_array_equal(ctx[2, :, :halo], z[1, :, -halo:])
    np.testing.assert_array_equal(ctx[5, :, -halo:], z[6, :, :halo])


@pytest.mark.parametrize("case", list(SHADOW_CASES))
def test_shadow_scan_matches_jax(ranks, case):
    """The rank-split scan equals the JAX shard_map scan on a 4-device
    mesh; the wall cases also equal one scan over the whole strip (the
    port's and the JAX package's)."""
    inp, out = ranks
    z, light, mode, init = inp["shadow_cases"][case]
    m = _jmesh()
    with m:
        zs = jax.device_put(jnp.asarray(z.numpy()), NamedSharding(m, P("tiles")))
        ref = np.asarray(JPH.make_sharded_shadow_scan(m, light, CELL_W, mode=mode)(
            zs, jnp.full((z.shape[1],), JSH.MESH_MIN_Z)))
    got = out[0]["shadows"][case].numpy()
    assert got.dtype == np.bool_ and got.shape == z.shape
    np.testing.assert_array_equal(got, ref)
    for o in out[1:]:
        np.testing.assert_array_equal(o["shadows"][case].numpy(), got)
    if case.startswith("walls"):
        strip = torch.cat(list(z), dim=1)
        whole, _ = TSH.mesh_shadows(strip, light, cell_w=CELL_W)
        jwhole, _ = JSH.mesh_shadows(jnp.asarray(strip.numpy()), light, cell_w=CELL_W)
        np.testing.assert_array_equal(np.concatenate(list(got), axis=1), whole.numpy())
        np.testing.assert_array_equal(whole.numpy(), np.asarray(jwhole))
        assert got.any() and not got.all()
        # the shadow crosses a rank edge (ranks hold tiles 2r, 2r+1)
        lit_ranks = {t // 2 for t in range(8) if got[t].any()}
        assert len(lit_ranks) >= 2, lit_ranks


def test_carry_mode_axis_aligned_equals_exact(ranks):
    _, out = ranks
    sh = out[0]["shadows"]
    np.testing.assert_array_equal(sh["rough_carry"].numpy(), sh["rough_exact"].numpy())
    diff = (sh["rough_drift_carry"] != sh["rough_drift_exact"]).float().mean()
    assert float(diff) < 0.02


def test_sharded_tile_step(ranks):
    """Bitwise the port's single-rank `tile_batch_step`; within 1e-3 of the
    JAX `make_sharded_tile_step` on a 4-device mesh."""
    inp, out = ranks
    (jm, jw, jargs), (tm, tw, targs) = _tile_setup()
    tiles = out[0]["tiles"]
    assert tiles.shape == (8, 32, 32)
    single = TTM.tile_batch_step(*targs, tm, tw)
    for o in out:
        assert torch.equal(o["tiles"], single)
    m = _jmesh()
    with m:
        ref = np.asarray(JTM.make_sharded_tile_step(m, jm, jw)(*jargs))
    np.testing.assert_allclose(tiles.numpy(), ref, rtol=0, atol=1e-3)
    assert np.abs(ref - np.asarray(JTM._tile_heights(jargs[0], jargs[1], jargs[2], jm, jw,
                                                     jargs[3]))).max() > 1e-4


def test_run_ranks_fails_with_the_rank_traceback():
    with pytest.raises(RuntimeError, match="rank 1 of 2 failed(.|\n)*rank one fails"):
        launch.run_ranks(torch_rank_cases.fail_on_rank_one, 2, "gloo", "cpu")


def test_init_mesh_raises_rather_than_switching(monkeypatch):
    """No group and no torchrun environment; no card for the default
    device; nccl on the host: each raises and names the explicit option."""
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(RuntimeError, match="torchrun"):
        TMESH.init_mesh()
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "1")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            TMESH.init_mesh(backend="gloo")
    with pytest.raises(ValueError, match="gloo"):
        TMESH.init_mesh(backend="nccl", device="cpu")

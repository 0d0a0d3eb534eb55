"""The plain references against `w3d_torch` at small shapes on the CPU,
where the port's kernels take their plain versions, and the controls:
the reference in the next lower precision must read far off."""

import math

import torch

from w3d_torch.models import physics_model as PM
from w3d_torch.models import terrain_model as TMOD
from w3d_torch.terrain import mesh as TM
from w3d_torch.utils.constants import WorldConst

from benchmark import harness
from benchmark.reference import spheres as RS
from benchmark.reference import terrain as RT

SPHERES = harness.read_json(f"{harness.ROOT}/benchmark/configs/spheres_10k.json")
TILES = harness.read_json(f"{harness.ROOT}/benchmark/configs/tiled_terrain_128.json")


def _balls(n: int, seed: int):
    g = torch.Generator().manual_seed(seed)
    pos = torch.tensor([-3.0, -3.0, 0.5]) + torch.rand((n, 3), generator=g) \
        * torch.tensor([6.0, 6.0, 3.0])
    return pos, torch.randn((n, 3), generator=g) * 0.5


def test_frame_reference_matches_the_port_bit_for_bit():
    pos, vel = _balls(400, 1)
    w = PM.build_spheres_world(pos, vel, device="cpu")
    ref = RS.Frame(SPHERES, "cpu")
    s0 = RS.initial_state(pos, vel)
    assert all(torch.equal(getattr(w.state, f), s0[f]) for f in RS.FIELDS)
    for _ in range(5):
        s_in = {f: getattr(w.state, f) for f in RS.FIELDS}
        w = PM.frame_step(w, substeps=10, pair_every=5, water=False)
        r = RS.readings({f: getattr(w.state, f) for f in RS.FIELDS}, ref(s_in))
        assert all(v == 0.0 for v in r.values()), r


def test_frame_control_reads_far_off():
    pos, vel = _balls(400, 2)
    ref = RS.Frame(SPHERES, "cpu")
    s = RS.initial_state(pos, vel)
    for _ in range(3):
        s = ref(s)
    r = RS.readings(ref(s, dtype=torch.bfloat16), ref(s))
    assert r["pos_err_max"] > 1e-3 and r["balls_pos_off"] > 100


def _tile_inputs(cfg, tiles: int, seed: int):
    g = torch.Generator().manual_seed(seed)
    x0 = torch.arange(tiles, dtype=torch.float32) * cfg["tile_size"] + 3000.25
    y0 = torch.full((tiles,), -1500.25)
    nb = -(-cfg["erosion_iters_tt"] // cfg["erosion_batch"])
    ang = torch.rand((nb, cfg["erosion_steps"], cfg["erosion_batch"]), generator=g) \
        * (2.0 * math.pi)
    return x0, y0, ang


def _small_tiles():
    return dict(TILES, tile_size=48, erosion_iters_tt=96, erosion_batch=64, erosion_steps=24)


def test_tile_reference_matches_the_port_bit_for_bit():
    cfg = _small_tiles()
    world = WorldConst()
    tcfg = TM.TerrainConfig()
    mcfg = TMOD.TileModelConfig(tile_size=cfg["tile_size"], cfg=tcfg,
                                erosion_iters_tt=cfg["erosion_iters_tt"],
                                erosion_batch=cfg["erosion_batch"],
                                erosion_steps=cfg["erosion_steps"])
    x0, y0, ang = _tile_inputs(cfg, 3, 4)
    table = TM.gen_table_for(tcfg, world, device="cpu")
    ze, wpz = cfg["zmax_est"], cfg["water_plane_z"]
    z = TMOD.tile_batch_step(table, x0, y0, torch.tensor(ze), torch.tensor(wpz), ang,
                             mcfg, world)
    ref = RT.Tiles(cfg, "cpu")
    assert torch.equal(ref.table, torch.stack(list(table), 1))
    stats: dict = {}
    pre: list = []
    expect = ref(x0, y0, ang, ze, wpz, stats=stats, pre=pre)
    assert torch.equal(z, expect)
    assert int(stats["live"]) > 0 and int(stats["erode"]) > 0
    assert all(v == 0.0 for v in RT.readings(z, expect, pre[0]).values())
    # the heights before erosion, as the program makes them without it
    mcfg0 = TMOD.TileModelConfig(tile_size=cfg["tile_size"], cfg=tcfg)
    z0 = TMOD.tile_batch_step(table, x0, y0, torch.tensor(ze), torch.tensor(wpz), None,
                              mcfg0, world)
    assert torch.equal(pre[0], z0)
    assert RT.readings(z0, expect, pre[0])["erosion_gap"] == 1.0


def test_tile_control_reads_far_off():
    cfg = _small_tiles()
    x0, y0, ang = _tile_inputs(cfg, 2, 5)
    ref = RT.Tiles(cfg, "cpu")
    args = (x0, y0, ang, cfg["zmax_est"], cfg["water_plane_z"])
    pre: list = []
    r = RT.readings(ref(*args, tf32=True), ref(*args, pre=pre), pre[0])
    assert r["tile_median_err"] > 1e-5 and r["tile_share_off"] > 0.3


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2.0 ** -11, 1.0 + 2.0 ** -10 + 2.0 ** -12, -3.0])
    assert RT.to_tf32(x).tolist() == [1.0, 1.0 + 2.0 ** -10, 1.0 + 2.0 ** -10, -3.0]

"""The scene's lighting bake (`lighting/bake.LightBake`) on the CPU, on a
32x32x8 grid over a floor, a sphere and a mesh under them: 4,096 sky rays
in batches of 1,024.

A whole sky bake through `step()` equals `trace.compute_sky_lighting`
bit for bit, and a local part over point, spot, line and cube lights
`trace.compute_scene_lighting`; a light split over batches keeps its
weight and its line; the grid after each block is the same however the
blocks are cut; `load_scene` plans a bake from a config's
`num_light_rays`, its scene's lights and its `sun_rot`, and none without
`num_light_rays`; the app bakes before its first frame.  And the benchmark's plain reference of
the sky bake (`benchmark/reference/lighting.py`) agrees with the program
within the `lighting_bake.sky` cell's limits on the cell's scene at a
small grid, on seeds whose batches compact, while its bfloat16 control
does not.  This file imports no jax."""

import contextlib
import io
import json
import math
import os

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from w3d_torch import app as TAPP
from w3d_torch.lighting import bake as LB
from w3d_torch.lighting import lmap as LM
from w3d_torch.lighting import trace as LT
from w3d_torch.models import physics_model as PM
from w3d_torch.models import world as TWM
from w3d_torch.scene import cobj as SC
from w3d_torch.scene import loader as TL
from w3d_torch.utils import profiler as P
from w3d_torch.utils.constants import WorldConst

from benchmark import harness
from benchmark.reference import lighting as RL
from benchmark.systems import light_bake as SYS

from torch_port_util import cuda_device, one_torch_thread  # noqa: F401  (fixture, autouse)

W = WorldConst(mesh_x=32, mesh_y=32, mesh_z=8)
PARAMS = LB.PRODUCTION._replace(max_bounces=4)
RAYS = 4096
BATCH = 1024


def _scene(device="cpu"):
    sp = SC.SceneParse()
    lay = SC.CobjLayer(color=(0.9, 0.8, 0.7, 1.0))
    sp.cobjs.append(SC.RawCobj(SC.COLL_CUBE, (-4, -4, -0.6), (4, 4, -0.4), layer=lay))
    sp.cobjs.append(SC.RawCobj(SC.COLL_SPHERE, (1.5, 0.0, 0.5), r1=0.6, layer=lay))
    cobjs = SC.pack_cobjs(sp, device=device)
    mesh = torch.full((32, 32), -3.5, device=device)
    return cobjs, mesh


def _grid():
    return LM.make_light_grid(W, device="cpu")


def _bake(block_rays=2048, nlr=(64, 64, 0), **kw):
    cobjs, mesh = _scene()
    return LB.LightBake(_grid(), cobjs, mesh, nlr, world=W, seed=5, params=PARAMS,
                        block_rays=block_rays, batch_rays=BATCH, **kw)


def _equal(a: LM.LightGrid, b: LM.LightGrid):
    for f in a._fields:
        assert torch.equal(getattr(a, f), getattr(b, f)), f


def test_sky_bake_equals_compute_sky_lighting():
    bake = _bake()
    assert [len(b) for b in bake.blocks] == [2, 2] and not bake.done
    while not bake.done:
        bake.step()
    cobjs, mesh = _scene()
    want = LT.compute_sky_lighting(_grid(), cobjs, mesh, RAYS, seed=5, params=PARAMS, world=W,
                                   batch=BATCH)
    _equal(bake.grid, want)
    assert float(bake.grid.sv.sum()) > 0
    slots = LT.bounce_slots(BATCH, bake.params[LM.LIGHTING_SKY])
    assert bake.counts == {"blocks": 2, "batches": 4, "rays": RAYS,
                           "deposit_rays": 4 * sum(slots),
                           "deposit_samples": 4 * (8 * slots[0] + 4 * sum(slots[1:]))}


def _lights():
    """A point light, a spotlight with an inner radius and its own ray
    count, a line light, a cube light and an ambient light (not traced)."""
    L = SC.LightSpec
    return [L(size=0.5, pos=(0.0, 0.0, 0.5), color=(1.0, 0.9, 0.8, 1.0)),
            L(size=0.8, pos=(-1.0, 1.0, 1.0), color=(0.5, 0.6, 1.0, 0.7), dir=(0.2, 0.0, -1.0),
              beamwidth=0.3, r_inner=0.1, num_dlight_rays=512),
            L(size=0.4, pos=(-2.0, -2.0, 0.3), pos2=(2.0, -1.0, 0.3), is_line=True),
            L(size=0.3, pos=(0.5, 0.5, 0.2), pos2=(0.9, 1.1, 0.6), is_cube_light=True,
              color=(0.2, 1.0, 0.4, 1.0)),
            L(kind="ambient", size=1.0, pos=(0.0, 0.0, 2.0))]


def test_local_part_equals_compute_scene_lighting():
    """The local count is shared over the three lights without a ray count
    of their own; the spot traces its own 512."""
    bake = _bake(nlr=(0, 0, 3 * 1024), lights=_lights())
    assert [(b.ltype, b.stream, b.n) for b in bake.plan] == (
        [(LM.LIGHTING_LOCAL, (LT.SCENE_STREAM, i), n)
         for i, n in ((0, 1024), (1, 512), (2, 1024), (3, 1024))])
    bake.run()
    cobjs, mesh = _scene()
    want = LT.compute_scene_lighting(_grid(), cobjs, mesh, _lights(), 1024, seed=5,
                                     params=PARAMS, world=W)
    _equal(bake.grid, want)
    assert float(bake.grid.lc_r.sum()) > 0 and bake.seconds > 0


def test_parts_run_in_order_and_split_lights():
    """Sky, then global, then local; a light whose rays outgrow a batch is
    split; the dynamic count is not traced."""
    bake = _bake(nlr=(16, 64, 2500, 1024, 7), lights=_lights()[:1])
    assert [(b.ltype, b.stream[0], b.tail, b.n) for b in bake.plan] == (
        [(LM.LIGHTING_SKY, LT.SKY_STREAM, (), 1024),
         (LM.LIGHTING_GLOBAL, LT.GLOBAL_STREAM, (), 1024),
         (LM.LIGHTING_LOCAL, LT.SCENE_STREAM, (), 1024),
         (LM.LIGHTING_LOCAL, LT.SCENE_STREAM, (1,), 1024),
         (LM.LIGHTING_LOCAL, LT.SCENE_STREAM, (2,), 452)])
    grid = bake.run()
    for ch in ("sv", "gv", "lc_r"):
        assert float(getattr(grid, ch).sum()) > 0, ch


def test_a_split_light_keeps_its_weight_and_line():
    """A line light's 2,500 rays in batches of 1,024: each ray weighs
    1000 x alpha x radius / 2,500 and the origins run along the whole
    segment, as in one batch."""
    spec = _lights()[2]
    draws = LT.DrawSource("cpu")
    whole = LT.scene_light_rays(draws(1), spec, 2500, W)
    parts = [LT.scene_light_rays(draws(2 + j), spec, n, W, total=2500, first=first)
             for j, (first, n) in enumerate(LT._split(2500, 1024))]
    for k in (0, 1, 2, 6):      # the origins and the weight
        assert torch.equal(torch.cat([p[k] for p in parts]), whole[k]), k


def test_the_sun_follows_sun_rot():
    assert LB.sun_direction(None) == LB.SUN_DIR
    d = LB.sun_direction(0.5)
    assert d[0] == 0.0 and abs(d[1] + math.sin(0.5)) < 1e-12 and abs(d[2] + math.cos(0.5)) < 1e-12


@pytest.mark.parametrize("block_rays", [1024, 2048, 4096])
def test_blocks_cut_anywhere_give_the_same_grid(block_rays):
    whole = _bake(block_rays=1024)
    after = []
    while not whole.done:
        after.append(whole.step())
    bake = _bake(block_rays=block_rays)
    per = block_rays // BATCH
    k = 0
    while not bake.done:
        k += per
        _equal(bake.step(), after[k - 1])


CONFIG = "mesh_size 32 32 8\nrand_seed 3\nmesh_seed 3\nnum_dodgeballs 4\nmesh_gen_mode 1\n"


def test_load_scene_plans_the_bake(tmp_path):
    p = tmp_path / "cfg.txt"
    p.write_text(CONFIG)
    assert TL.load_scene(str(p), device="cpu").bake is None
    p.write_text(CONFIG + "num_light_rays 8 64 0 0\n")
    scene = TL.load_scene(str(p), device="cpu")
    bake = scene.bake
    assert isinstance(bake, LB.LightBake) and bake.grid is scene.light_grid
    assert [(b.ltype, b.n) for b in bake.plan] == [(LM.LIGHTING_SKY, 512)]
    assert bake.params[LM.LIGHTING_SKY].water_plane_z == float(scene.env.water_plane_z)
    assert scene.light_grid.shape == (8, 32, 32)


COBJS = """l 0.5 0.9 0.9 0.9 1.0 -1
B -4 4 -4 4 -0.6 -0.4
L 0.0 0.8  -1.0 1.0 1.0  0.5 0.6 1.0 0.7  0.2 0.0 -1.0  0.3 0.1
L 0.0 0.4  -2.0 -2.0 0.3  1.0 1.0 1.0 1.0  2.0 -1.0 0.3  1.0 0.0 1
L 0.5 0.0  0.0 0.0 2.0  1.0 1.0 1.0 1.0
"""


def test_load_scene_bakes_the_scene_lights_and_its_sun(tmp_path):
    """A scene with a spotlight, a line light and an ambient light: the
    bake's local part is `compute_scene_lighting` over the parsed lights,
    bit for bit, and its sun follows the config's `sun_rot`."""
    (tmp_path / "cobjs.txt").write_text(COBJS)
    p = tmp_path / "cfg.txt"
    p.write_text(CONFIG + "load_coll_objs 1\ncoll_obj_file cobjs.txt\nsun_rot 0.5\n"
                 "num_light_rays 8 64 2048 512\n")
    scene = TL.load_scene(str(p), device="cpu")
    bake = scene.bake
    kinds = [s.kind for s in scene.parse.lights]
    assert kinds == ["diffuse", "diffuse", "ambient"] and scene.parse.lights[1].is_line
    assert [(b.ltype, b.stream, b.n) for b in bake.plan] == [
        (LM.LIGHTING_SKY, (LT.SKY_STREAM, 0), 512),
        (LM.LIGHTING_GLOBAL, (LT.GLOBAL_STREAM, 0), 512),
        (LM.LIGHTING_LOCAL, (LT.SCENE_STREAM, 0), 1024),
        (LM.LIGHTING_LOCAL, (LT.SCENE_STREAM, 1), 1024)]
    assert bake.plan[1].rays.keywords["sun_dir"] == LB.sun_direction(0.5)
    grid = bake.run()
    want = LT.compute_scene_lighting(LM.make_light_grid(scene.world, device="cpu"), scene.cobjs,
                                     scene.terrain.mesh_height, scene.parse.lights, 1024,
                                     seed=scene.cfg.rand_seed,
                                     params=bake.params[LM.LIGHTING_LOCAL], world=scene.world)
    for f in ("lc_r", "lc_g", "lc_b"):
        assert torch.equal(getattr(grid, f), getattr(want, f)), f
    assert float(grid.lc_b.sum()) > 0 and float(grid.gv.sum()) > 0


def test_app_bakes_before_the_first_frame(tmp_path, monkeypatch):
    p = tmp_path / "cfg.txt"
    p.write_text(CONFIG + "num_light_rays 8 64 0 0\n")
    seen = []
    frame = TWM.ground_frame

    def first(scene):
        seen.append(scene.bake.done)
        return frame(scene)
    monkeypatch.setattr(TWM, "ground_frame", first)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        scene = TAPP.run_ground(str(p), 2, 4, chain=1, device="cpu")
    rows = [json.loads(line) for line in buf.getvalue().splitlines()]
    assert seen == [True, True] and [r["frame"] for r in rows] == [0, 1]
    assert all(set(r) == {"frame", "mode", "live", "player_z", "ms"} for r in rows)
    assert scene.bake.counts["rays"] == 512 and scene.bake.seconds > 0
    assert scene.light_grid.sv is scene.bake.work.sv and float(scene.light_grid.sv.sum()) > 0


@pytest.mark.gpu
def test_replayed_batches_are_eager_batches(cuda_device, monkeypatch):
    """On the card a bake's batches run eager, then capture and replay
    their CUDA graphs (`trace.BATCHES`), bit for bit the eager batches of a
    twin bake whose key is None; under a profiler a replay opens the
    bounce phases' spans, with CUDA events."""
    cobjs, mesh = _scene(cuda_device)

    def bake():
        return LB.LightBake(LM.make_light_grid(W, device=cuda_device), cobjs, mesh, (64, 64, 0),
                            world=W, seed=5, params=PARAMS, block_rays=2048, batch_rays=BATCH)
    monkeypatch.setattr(LT, "BATCHES", LT.CG.GraphCache("light"))
    with monkeypatch.context() as m:
        m.setattr(LT, "batch_key", lambda *args, **kw: None)
        want = bake().run()
    got = bake().run()
    assert [LT.BATCHES.counts[k] for k in
            ("graph_eager", "graph_captures", "graph_replays", "graph_failed")] == [5, 1, 3, 0]
    _equal(got, want)
    P.spans(clear=True)
    b = bake()
    with profile(activities=[ProfilerActivity.CUDA]):
        b.step()
    names = [s.name for s in P.spans(clear=True)]
    assert names[:3] == ["light.block", "light.graph", "light.intersect"]
    assert names.count("light.graph") == 2 and names.count("light.intersect") == 8
    assert LT.BATCHES.counts["graph_replays"] == 5


# ---------------------------------------------------------------------------
# the benchmark's reference of the sky bake
# ---------------------------------------------------------------------------

SMALL = {"mesh_x": 32, "mesh_y": 32, "light_layers": 8}


def _cell_config() -> dict:
    cfg = harness.read_json(os.path.join(harness.ROOT, "benchmark/configs/spheres_lighting.json"))
    return {**cfg, **SMALL}


@pytest.mark.parametrize("seed", [7, 2**31 + 11])
def test_reference_agrees_with_the_program(seed):
    """Two blocks of two 8,192-ray batches (compacted after bounces 0 and
    1) on the cell's scene: the program's grid moves as the reference
    deposits, within the cell's limits; the bfloat16 control fails."""
    cfg = _cell_config()
    world = WorldConst(mesh_x=32, mesh_y=32, mesh_z=8, x_scene=cfg["x_scene"],
                       y_scene=cfg["y_scene"], z_scene=cfg["z_scene"])
    cobjs = SC.pack_cobjs(PM.spheres_scene(), device="cpu")
    mesh = torch.full((32, 32), cfg["mesh_z"])
    rec = SYS.Recorder("cpu")
    bake = LB.LightBake(LM.make_light_grid(world, device="cpu"), cobjs, mesh, (64, 512),
                        world=world, seed=seed, block_rays=16384, batch_rays=8192, draws=rec)
    SYS._require(cfg, bake.params[LM.LIGHTING_SKY])
    sc = RL.Scene(cfg, "cpu")
    limits = cfg["check"]["limits"]
    before = None
    control_fails = False
    for _ in range(2):
        rec.clear()
        out = bake.step()
        after = torch.stack([getattr(out, f) for f in SYS.SKY])
        bs = SYS.batches(rec.clear())
        assert len(bs) == 2 and sorted(bs[0]["compact"]) == [0, 1]
        ref = RL.trace_block(sc, bs)
        delta = after.double() - (0.0 if before is None else before.double())
        args = (after, len(bs), cfg["check"]["rtol"], cfg["check"]["atol"])
        r = RL.readings(delta, ref, *args)
        assert all(r[k] <= lim for k, lim in limits.items()), r
        low = RL.readings(RL.trace_block(sc, bs, dtype=torch.bfloat16).double(), ref, *args)
        control_fails |= any(low[k] > lim for k, lim in limits.items())
        before = after
    assert control_fails

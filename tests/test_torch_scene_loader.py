"""Torch port vs JAX package: scene loading (`scene/loader.load_scene`),
the per-frame ground loop (`models/world.ground_frame`) and the app's
ground mode (`app.run_ground`).

Configs, scenes, images and material files are written to `tmp_path` (32²
meshes, 16-64 objects).  The JAX `load_scene` runs under
`jax.disable_jit()`: compiled, XLA rounds `gen_terrain`'s fused far-grid
arguments otherwise (tests/test_torch_fbm.py).  Every `GroundScene` field
is compared: tensors bitwise, except heights from the sine generator
(float32 sines and an einsum, tests/test_torch_fbm.py) and from erosion,
and the values read from them, within 1e-5 of the height scale; the host
specs (config, scene parse, sphere materials, trees) exactly.

Frames: the JAX `ground_frame` takes the block pair path on the CPU, so
with object collisions off the port is held against it, and with them on
against the same frame built from the JAX parts with
`pair_method="banded"`; 1e-5, status and flags exact."""

import contextlib
import copy
import dataclasses
import io
import json

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import w3d  # noqa: F401
from w3d import app as JAPP
from w3d.export import heightmap_io as JH
from w3d.models import world as JWM
from w3d.physics import platforms as JP
from w3d.physics import step as JPS
from w3d.scene import loader as JL
from w3d.utils.checkpoint import ModmapJournal as JJournal
from w3d.water import ripples as JWR

from w3d_torch import app as TAPP
from w3d_torch import convert
from w3d_torch.models import world as TWM
from w3d_torch.physics import types as TT
from w3d_torch.scene import loader as TL
from w3d_torch.terrain import mesh as TM

from torch_port_util import jax_angle_tables, np_tree

SCENE = """
l 0.7 0.6 0.6 0.6 1.0 -1
B -3 3 -3 3 -1.2 -0.9
n 1
B -0.5 0.5 -0.5 0.5 -1.2 -0.9
n 0
S 1.0 1.0 -0.5 0.3
C -1 1 -1.0  -1 1 -0.2  0.15 0.1
P 3  1 -1 -0.8  2 -1 -0.8  1 -2 -0.8  0.05
K 0.5 -1.5 -0.8  0.6 0 0  0 0
Q 1  1.5 1.5 0.0 0.1  0.4 0.0  0 0 0  0 0 1  0
B -2.0 -1.4 -2.0 -1.4 -0.9 -0.8
K
Q 1  2.0 2.0 0.0 0.0  0.3 0.0  0 0 0  1 0 0  1
B 1.4 2.0 1.4 2.0 -0.9 -0.8
Q 0
rand_spheres 6  0 0 -0.9  2.0 0.05 0.12
"""

MATERIALS = """
max_num_spheres 10
hardness 0.6
density 2.0
radius_scale 1.2
diffuse_color 1 0 0
add_material red rubber
hardness 0.9
density 0.5
radius_scale 0.8
metalness 1
add_material steel
"""

BASE = "mesh_size 32 32 8\nrand_seed 3\nmesh_seed 3\nnum_dodgeballs 16\n"
# an fBm generator (bitwise in both packages) with the water plane raised
# into the 32^2 map's height range: 30% of it under water
FBM = "mesh_gen_mode 2\nwater_h_off 0.053 0\n"
VOXEL = ("create_voxel_landscape 1\nvoxel xsize 32\nvoxel ysize 32\nvoxel zsize 16\n"
         "voxel isolevel 0.13\nvoxel z_gradient 1.5\nvoxel atten_at_edges 2\n")
CONFIGS = {
    "default": BASE,
    "ntrees": BASE + FBM + "ntrees 40\n",
    "scenery_off": BASE + "mesh_gen_mode 1\ndisable_scenery 1\n",
    "materials": BASE + FBM + "sphere_materials_fn mats.txt\n",
    "platforms": BASE + FBM + ("ntrees 12\nload_coll_objs 1\n"
                               "coll_obj_file scene.txt\nsphere_gen rand_seed 9\n"),
    # a voxel landscape: isolevel 0.13 keeps every cell of this field more
    # than 1e-4 from it (the field is held at 1e-5), so the masks, the top
    # surface and the fused heightfield are exact
    "voxel": BASE + FBM + VOXEL,
    "heightmap": ("mesh_size 32 32 8\nrand_seed 3\nnum_dodgeballs 16\n"
                  "read_heightmap 1\nmesh_height_image hm.png\n"
                  "read_hmap_modmap_filename hm.modmap\nerosion_iters 300\n"
                  "erode_amount 0.01\nwater_h_off -0.2 0\n"),
}
HEIGHT_FIELDS = {"terrain": ("mesh_height", "zbottom", "ztop", "height_histogram",
                             "zmin", "zmax", "zmax_est", "water_plane_z"),
                 "env": ("mesh_height", "water_plane_z", "zmin"),
                 "scenery": ("z",)}
ERODED = 300


def _write(tmp_path, name):
    (tmp_path / "cfg.txt").write_text(CONFIGS[name])
    (tmp_path / "scene.txt").write_text(SCENE)
    (tmp_path / "mats.txt").write_text(MATERIALS)
    if name == "heightmap":
        rg = np.random.default_rng(8)
        y, x = np.mgrid[0:32, 0:32] / 5.0
        f = np.sin(x + rg.uniform(0, 6)) * np.cos(0.7 * y + rg.uniform(0, 6)) + 0.3 * x / 6
        img = ((f - f.min()) / (f.max() - f.min()) * 60000 + 2000).astype(np.uint16)
        JH.write_png_gray(str(tmp_path / "hm.png"), img, bit_depth=16)
        j = JJournal()
        j.add(10, 12, 5, 0.2, 1)
        j.add(22, 8, 4, -0.15, 2)
        j.add(5, 25, 3, 0.1, 0)
        j.save(str(tmp_path / "hm.modmap"))
    return str(tmp_path / "cfg.txt")


def _jax_load(path, name, **kw):
    if name == "heightmap":     # no gen_terrain: the JAX code as its callers run it
        return JL.load_scene(path, **kw)
    with jax.disable_jit():
        return JL.load_scene(path, **kw)


def _port_load(monkeypatch, path, **kw):
    """The port's load_scene, eroding with the JAX package's angle draws."""
    def jax_angles(iters, device):
        assert iters == ERODED
        return torch.as_tensor(jax_angle_tables(ERODED, 1024, 256)).to(device)
    monkeypatch.setattr(TL, "erosion_angles", jax_angles)
    return TL.load_scene(path, device="cpu", **kw)


def _np_scene(js):
    """The JAX GroundScene with its arrays as numpy."""
    tensors = ("terrain", "cobjs", "table", "objects", "env", "ripples",
               "light_grid", "platforms", "triggers", "scenery")
    return dataclasses.replace(js, **{f: None if getattr(js, f) is None
                                      else np_tree(getattr(js, f)) for f in tensors})


def _close(a, b, tol, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, what
    if a.dtype.kind == "f" and tol:
        d = float(np.abs(a.astype(np.float64) - b).max()) if a.size else 0.0
        assert d <= tol, (what, d)
    else:
        np.testing.assert_array_equal(a.astype(b.dtype), b, err_msg=what)


def _check_scene(js, ts, height_tol):
    """Every field of two GroundScenes (js as numpy)."""
    assert vars(js.cfg) == vars(ts.cfg)
    assert dataclasses.asdict(js.world) == dataclasses.asdict(ts.world)
    assert dataclasses.asdict(js.sphere_mats) == dataclasses.asdict(ts.sphere_mats)
    assert dataclasses.asdict(js.parse) == dataclasses.asdict(ts.parse)
    assert js.mat_first == ts.mat_first and js.smoke_active == ts.smoke_active
    if js.voxel is None:
        assert ts.voxel is None
    else:
        iso = float(js.cfg.voxel["isolevel"])
        jv = np.asarray(js.voxel.values)
        assert ts.voxel.lo_pos == js.voxel.lo_pos and ts.voxel.vsz == js.voxel.vsz
        _close(jv, ts.voxel.values.numpy(), 1e-5, "voxel.values")
        _close(jv < iso, ts.voxel.values.numpy() < iso, 0.0, "voxel solid")
    if js.trees is None:
        assert ts.trees is None
    else:
        for a, b in zip(js.trees, ts.trees):
            _close(a, b, height_tol, "trees")
    for part in ("terrain", "cobjs", "table", "objects", "env", "ripples",
                 "light_grid", "platforms", "triggers", "scenery"):
        a, b = getattr(js, part), getattr(ts, part)
        if a is None:
            assert b is None, part
            continue
        assert a._fields == b._fields, part
        for name in b._fields:
            x, y = getattr(a, name), getattr(b, name)
            if x is None:
                assert y is None
                continue
            tol = height_tol if name in HEIGHT_FIELDS.get(part, ()) else 0.0
            _close(x, y.numpy(), tol, f"{part}.{name}")


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_load_scene_matches_jax(tmp_path, monkeypatch, name):
    path = _write(tmp_path, name)
    js = _np_scene(_jax_load(path, name))
    ts = _port_load(monkeypatch, path)
    zscale = float(js.terrain.zmax_est)
    tol = 1e-5 * zscale if name in ("default", "heightmap") else 0.0
    _check_scene(js, ts, tol)
    assert convert.ground_scene(js, "cpu").cobjs.size == ts.cobjs.size
    # what each config exercises happened
    live = int((ts.cobjs.shape != 0).sum())
    if name == "ntrees":
        n = len(ts.trees[0])
        assert 0 < n < 40 and live >= n      # some trees under water
    elif name == "scenery_off":
        assert ts.scenery is None and live == 0
    elif name == "materials":
        first = TT.NUM_TOT_OBJS          # one type row per material after the table
        assert ts.mat_first == first and ts.table.radius.shape == (first + 2,)
        assert sorted(set(ts.objects.otype.tolist())) == [first, first + 1]
    elif name == "platforms":
        assert ts.platforms.size == 2 and ts.triggers.x.shape == (1,)
        assert not ts.parse.skipped and live > 20
    elif name == "heightmap":
        assert float(ts.terrain.ztop - ts.terrain.zbottom) > 0.01
    elif name == "voxel":
        assert ts.voxel.shape == (16, 32, 32)
        assert np.abs(np.asarray(js.voxel.values) - 0.13).min() > 1e-4
        cfg = dataclasses.replace(ts.cfg, create_voxel_landscape=0)
        base = TM.gen_terrain(cfg.terrain_config()._replace(mesh_seed=3), ts.world,
                              device="cpu").mesh_height
        rise = ts.terrain.mesh_height - base
        assert float(rise.min()) == 0.0 and float(rise.max()) > 0.1   # fused surface
    if name != "scenery_off":
        assert bool(ts.scenery.valid.any())


def test_voxel_landscape_raises(tmp_path):
    """Voxel landscapes used to be refused with NotImplementedError; they
    are ported now, so neither `load_scene` nor `convert.ground_scene`
    raises for one, and a grid of the config's size rides on the scene."""
    (tmp_path / "cfg.txt").write_text(BASE + "create_voxel_landscape 1\nvoxel xsize 8\n")
    ts = TL.load_scene(str(tmp_path / "cfg.txt"), device="cpu")
    assert ts.voxel.shape == (32, 64, 8)
    with jax.disable_jit():
        js = JL.load_scene(str(tmp_path / "cfg.txt"))
    assert convert.ground_scene(_np_scene(js), "cpu").voxel.shape == (32, 64, 8)


def _drop_objects(js):
    """The loaded scene's objects thrown at the scene: half just above the
    ground cube and the platforms, fast and downward, two standing on the
    moving platforms' tops (status 4)."""
    st = js.objects
    n = st.px.shape[0]
    rg = np.random.default_rng(5)
    px = rg.uniform(-2.5, 2.5, n).astype(np.float32)
    py = rg.uniform(-2.5, 2.5, n).astype(np.float32)
    pz = rg.uniform(-0.85, -0.5, n).astype(np.float32)
    vz = rg.uniform(-6.0, -1.0, n).astype(np.float32)
    status = np.asarray(st.status).copy()
    rad = float(np.asarray(js.table.radius)[np.asarray(st.otype)[0]])
    for k, (x, y) in enumerate(((-1.7, -1.7), (1.7, 1.7))):
        px[k], py[k], pz[k], vz[k], status[k] = x, y, -0.8 + rad, 0.0, 4
    js.objects = st._replace(px=jnp.asarray(px), py=jnp.asarray(py),
                             pz=jnp.asarray(pz), vz=jnp.asarray(vz),
                             status=jnp.asarray(status))
    return js


def _jax_frame_banded(s, substeps=4):
    """The JAX ground_frame, with the banded pair pass the port takes."""
    s = copy.copy(s)
    st0 = s.objects
    trig = None
    if s.triggers is not None and s.triggers.x.shape[0] > 0:
        trig = JP.eval_triggers(s.triggers, st0.px, st0.py, st0.pz, s.platforms)
    plats, mx, my, mz = JP.advance_platforms(s.platforms, trig)
    rad = s.table.radius[st0.otype]
    dx, dy, dz = JP.rider_deltas(st0.px, st0.py, st0.pz, st0.status, s.cobjs,
                                 plats, mx, my, mz, rad)
    s.cobjs = JP.apply_platform_motion(s.cobjs, plats, mx, my, mz)
    s.objects = st0._replace(px=st0.px + dx, py=st0.py + dy, pz=st0.pz + dz)
    s.platforms = plats
    s.objects = JPS.step_objects(s.objects, s.env, s.cobjs, s.table,
                                 substeps=substeps, world=s.world,
                                 obj_collisions=True, pair_method="banded")
    wpz = s.env.water_plane_z
    s.ripples, _ = JWR.step_ripples(s.ripples, wpz > s.terrain.mesh_height,
                                    jnp.maximum(wpz - s.terrain.mesh_height, 0.0))
    return s


@pytest.mark.parametrize("obj_collisions", [False, True])
def test_ground_frame_matches_jax(tmp_path, obj_collisions):
    """Four frames on the platform scene, from one state."""
    path = _write(tmp_path, "platforms")
    with jax.disable_jit():
        js = _drop_objects(JL.load_scene(path, num_objects=48))
    ts = convert.ground_scene(_np_scene(js), "cpu")
    for _ in range(4):
        if obj_collisions:
            js = _jax_frame_banded(js)
        else:
            js = JWM.ground_frame(copy.copy(js), obj_collisions=False)
        ts = TWM.ground_frame(ts, obj_collisions=obj_collisions)
    r = _np_scene(js)
    for name in ("px", "py", "pz", "vx", "vy", "vz", "health"):
        _close(getattr(r.objects, name), getattr(ts.objects, name).numpy(), 1e-5, name)
    for name in ("status", "flags", "time", "otype"):
        _close(getattr(r.objects, name), getattr(ts.objects, name).numpy(), 0.0, name)
    for part in ("cobjs", "platforms", "ripples"):
        for name in getattr(ts, part)._fields:
            _close(getattr(getattr(r, part), name), getattr(getattr(ts, part), name).numpy(),
                   1e-5, f"{part}.{name}")
    assert float(np.abs(r.platforms.dist).max()) > 0.0        # platforms moved
    flags = r.objects.flags.astype(np.int64)
    assert ((flags & 2) != 0).sum() > 3                       # cobj contacts
    assert bool((r.objects.status == 4).any() or (r.objects.status == 2).any())


def _run(fn, *args, **kw):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args, **kw)
    return out, [json.loads(line) for line in buf.getvalue().splitlines()]


@pytest.mark.parametrize("name,chunk", [("ntrees", 1), ("ntrees", 4), ("platforms", 4)])
def test_run_ground_matches_jax(tmp_path, name, chunk):
    """8 frames: per frame (chunk 1, or a platform scene) or in chunks of 4
    chained frames; `live` after each printed frame equals the JAX frames'
    (built with the banded pair pass), and the lines keep the JAX keys."""
    path = _write(tmp_path, name)
    scene, rows = _run(TAPP.run_ground, path, 8, 24, chain=chunk, device="cpu")
    with jax.disable_jit():
        js = JL.load_scene(path, num_objects=24)
    live = []
    for _ in range(8):
        if js.platforms.size:
            js = _jax_frame_banded(js)
        else:
            js.objects = JPS.step_objects(js.objects, js.env, js.cobjs, js.table,
                                          substeps=4, world=js.world,
                                          obj_collisions=True, pair_method="banded")
        live.append(int(jnp.sum(js.objects.status > 0)))
    per_frame = name == "platforms" or chunk == 1
    assert [r["frame"] for r in rows] == (list(range(8)) if per_frame else [3, 7])
    assert [r["live"] for r in rows] == [live[r["frame"]] for r in rows]
    keys = {"frame", "mode", "live", "player_z", "ms"} | (set() if per_frame else {"chained"})
    assert all(set(r) == keys and r["mode"] == "ground" for r in rows)
    assert all(np.isfinite(r["player_z"]) for r in rows)
    _close(np.asarray(js.objects.pz), scene.objects.pz.numpy(), 1e-5, "pz")


@pytest.mark.parametrize("argv", [["--mode", "voxel"], ["--mode", "lighting", "--chunk", "4"],
                                  ["--mode", "menu", "--record", "x.json"],
                                  ["--mode", "universes", "--spectate"]])
def test_main_refuses_unported_modes(argv):
    """Every mode of the JAX app's `main` is ported (ground, tiled and,
    since universe mode runs, test_torch_universe_app, all three); a mode
    that neither app has is refused by both parsers, whatever flags come
    with it."""
    from w3d import app as JAPP
    for main in (TAPP.main, JAPP.main):
        with pytest.raises(SystemExit):
            main(argv)


def _jax_app_rows(monkeypatch, fn, *args, **kw):
    """Rows the JAX app prints: its scene loaded under `jax.disable_jit`
    (bitwise the port's), its per-frame `ground_frame` with the banded pair
    pass the port takes."""
    load = JL.load_scene

    def load_op_by_op(*a, **k):
        with jax.disable_jit():
            return load(*a, **k)

    monkeypatch.setattr(JL, "load_scene", load_op_by_op)
    monkeypatch.setattr(JWM, "ground_frame", _jax_frame_banded)
    return _run(fn, *args, **kw)[1]


def _no_ms(rows):
    return [{k: v for k, v in r.items() if k != "ms"} for r in rows]


def test_run_ground_per_frame_rows_match_jax_app(tmp_path, monkeypatch):
    """The per-frame path prints the JAX app's rows, `player_z` included:
    the JAX app steps the player there on the default world's grid
    (`app.py:49-50`), and so does the port.  At this mesh size (32^2) the
    scene's own grid gives other heights: the player, falling from z = 1
    onto the image terrain, lands about frame 39 (4 balls, one platform
    off the player's path)."""
    _write(tmp_path, "heightmap")            # the 16-bit image
    (tmp_path / "plat.txt").write_text(
        "Q 1  2.0 2.0 0.0 0.0  0.3 0.0  0 0 0  1 0 0  1\n"
        "B 1.4 2.0 1.4 2.0 -0.9 -0.8\nQ 0\n")
    (tmp_path / "cfg.txt").write_text(
        "mesh_size 32 32 8\nrand_seed 3\nnum_dodgeballs 4\nread_heightmap 1\n"
        "mesh_height_image hm.png\nwater_h_off -0.2 0\nload_coll_objs 1\n"
        "coll_obj_file plat.txt\n")
    path = str(tmp_path / "cfg.txt")
    jrows = _jax_app_rows(monkeypatch, JAPP.run_ground, path, 44, 4)
    _, trows = _run(TAPP.run_ground, path, 44, 4, chain=1, device="cpu")
    assert [r["frame"] for r in trows] == list(range(44))
    assert _no_ms(trows) == _no_ms(jrows)
    fall = [a["player_z"] - b["player_z"] for a, b in zip(trows, trows[1:])]
    assert fall[-1] < fall[-6]               # the fall slowed: it landed


def test_main_chains_ground_mode_whatever_the_chunk(tmp_path, monkeypatch):
    """`--chunk` is the tiled mode's: `main` runs ground mode on a scene
    without platforms in chained calls of 32 frames, as the JAX `main`
    does, so `--chunk 1` still prints chained rows in both packages."""
    path = _write(tmp_path, "ntrees")
    argv = ["--config", path, "--chunk", "1", "--frames", "6", "--objects", "16"]
    monkeypatch.delenv("W3D_PLATFORM", raising=False)
    jrows = _jax_app_rows(monkeypatch, JAPP.main, argv)
    monkeypatch.setenv("W3D_PLATFORM", "cpu")
    _, trows = _run(TAPP.main, argv)
    keys = ("frame", "mode", "chained", "player_z")
    assert [[r.get(k) for k in keys] for r in trows] == \
        [[r.get(k) for k in keys] for r in jrows] == [[5, "ground", 6, trows[0]["player_z"]]]


def test_run_ground_voxel_rows_match_jax_app(tmp_path, monkeypatch):
    """The app's ground mode on a voxel landscape: 12 frames of 16 balls
    falling onto the fused voxel surface, per frame and chained in 4s,
    print the JAX app's rows (every key but `ms`)."""
    path = _write(tmp_path, "voxel")
    jrows = _jax_app_rows(monkeypatch, JAPP.run_ground, path, 12, 16, chain=1)
    _, trows = _run(TAPP.run_ground, path, 12, 16, chain=1, device="cpu")
    assert [r["frame"] for r in trows] == list(range(12))
    assert _no_ms(trows) == _no_ms(jrows)
    _, crows = _run(TAPP.run_ground, path, 12, 16, chain=4, device="cpu")
    assert [r["live"] for r in crows] == [trows[f]["live"] for f in (3, 7, 11)]

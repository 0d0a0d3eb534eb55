"""Torch port vs JAX package: tiled mode's app loop (`app.run_tiled`,
`_world_hash`, `main --mode tiled`), with record, replay and spectate.

The port's `run_tiled` takes the JAX app's draws (`jax_tiled_draws`
replays its key chains) and the JAX tile manager's height range (the
JAX manager reads it from the compiled `gen_terrain`, see
test_torch_tiles).  Held: every printed key but `ms` and `hash` equal to
the JAX app's rows over 3 chunks; `_world_hash` of a state carried over
from JAX equal to the JAX hash; in the port alone, a replayed session
reproduces its recorded hashes and another seed does not; a spectated
session follows an agent."""

import contextlib
import io
import json

import numpy as np
import pytest
import jax
import torch

import w3d  # noqa: F401
from w3d import app as JAPP
from w3d.terrain import tiles as JTL, mesh as JM
from w3d.utils.constants import WorldConst as JWorld

from w3d_torch import app as TAPP, convert
from w3d_torch.terrain import tiles as TTL
from w3d_torch.utils.constants import WorldConst as TWorld

from torch_port_util import jax_tiled_draws, np_tree

FRAMES, CHUNK = 12, 4


def _rows(fn, *a, **k):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*a, **k)
    return out, [json.loads(line) for line in buf.getvalue().splitlines()]


@pytest.fixture
def jax_range(monkeypatch):
    """Port tile managers generate against the JAX manager's height range."""
    cache = {}
    post = TTL.TileManager.__post_init__

    def patched(self):
        post(self)
        seed = self.cfg.mesh_seed
        if seed not in cache:
            jm = JTL.TileManager(cfg=JM.TerrainConfig(mesh_seed=seed),
                                 world=JWorld(mesh_x=64, mesh_y=64), tile_size=64)
            cache[seed] = (jm.zmax_est, jm.water_plane_z)
        self.set_height_range(*cache[seed])
    monkeypatch.setattr(TTL.TileManager, "__post_init__", patched)


def _strip(rows):
    return [{k: v for k, v in r.items() if k not in ("ms", "hash")} for r in rows]


@pytest.mark.parametrize("spectate", [False, True])
def test_run_tiled_rows_match_jax(jax_range, spectate):
    jw, jrows = _rows(JAPP.run_tiled, FRAMES, 1, chunk=CHUNK, spectate=spectate)
    tw, trows = _rows(TAPP.run_tiled, FRAMES, 1, chunk=CHUNK, spectate=spectate,
                      device="cpu", draws=jax_tiled_draws(1))
    assert len(trows) == FRAMES // CHUNK
    assert [sorted(r) for r in trows] == [sorted(r) for r in jrows]
    assert _strip(trows) == _strip(jrows)
    assert trows[0]["created"] == 9 and trows[0]["fauna"] == [16, 16, 32]
    # the state behind the rows
    for a, b in ((tw.cars, jw.cars), (tw.peds, jw.peds)):
        a, b = convert.to_numpy(a), np_tree(b)
        for f in b._fields:
            x, y = np.asarray(getattr(a, f)), np.asarray(getattr(b, f))
            if y.dtype.kind == "f":
                np.testing.assert_allclose(x, y, rtol=0, atol=1e-5, err_msg=f)
            else:
                np.testing.assert_array_equal(x.astype(np.int64), y.astype(np.int64), err_msg=f)
    np.testing.assert_allclose(tw.last_probe, jw.last_probe, rtol=0, atol=1e-5)
    assert sorted(tw.tile_mgr.tiles) == sorted(jw.tile_mgr.tiles)
    if spectate:   # the camera followed an agent away from the default path
        assert sorted(tw.tile_mgr.tiles) != sorted(
            TTL.TileManager(world=TWorld(mesh_x=64, mesh_y=64), tile_size=64,
                            device="cpu").wanted_tiles(0.8 * FRAMES, 0.0))


def test_world_hash_of_jax_state_matches_jax_hash():
    jw, _ = _rows(JAPP.run_tiled, 8, 2, chunk=CHUNK)
    from types import SimpleNamespace
    port = SimpleNamespace(cars=convert.city_state(np_tree(jw.city._replace(key=None)),
                                                   "cpu").cars,
                           peds=convert.city_state(np_tree(jw.city._replace(key=None)),
                                                   "cpu").peds,
                           last_probe=np.asarray(jw.last_probe))
    assert TAPP._world_hash(port, jw.tile_mgr) == jw.frame_hashes[-1]


def test_record_replay_reproduces_hashes(tmp_path):
    journal = str(tmp_path / "session.uel")
    w1, rows = _rows(TAPP.run_tiled, 3 * CHUNK, 3, chunk=CHUNK, record=journal, device="cpu")
    rec = w1.frame_hashes
    assert len(rec) == 3 and len(set(rec)) == 3
    assert json.load(open(journal + ".hashes.json")) == rec
    w2, rows2 = _rows(TAPP.run_tiled, 3 * CHUNK, 999, chunk=CHUNK, replay=journal, device="cpu")
    assert w2.frame_hashes == rec
    assert _strip(rows2) == _strip(rows)
    w3, _ = _rows(TAPP.run_tiled, 3 * CHUNK, 4, chunk=CHUNK, device="cpu")
    assert w3.frame_hashes != rec


def test_main_tiled_runs_on_cpu(tmp_path, monkeypatch):
    """`main --mode tiled` with the JAX `main`'s flags under
    W3D_PLATFORM=cpu: rows with the JAX app's keys; record then replay
    reproduces the hashes; universe mode, which used to raise, runs too."""
    monkeypatch.setenv("W3D_PLATFORM", "cpu")
    j = str(tmp_path / "m.uel")
    _, rows = _rows(TAPP.main, ["--mode", "tiled", "--frames", "8", "--chunk", "4",
                                "--seed", "5", "--record", j])
    assert [r["frame"] for r in rows] == [3, 7]
    assert set(rows[0]) == {"frame", "mode", "chained", "tiles", "cars", "peds",
                            "bldg_people_acts", "fauna", "created", "deleted", "hash", "ms"}
    _, again = _rows(TAPP.main, ["--mode", "tiled", "--frames", "8", "--chunk", "4",
                                 "--replay", j])
    assert [r["hash"] for r in again] == [r["hash"] for r in rows]
    monkeypatch.setenv("W3D_ASSET_ROOT", str(tmp_path))     # no ship defs there
    _, urows = _rows(TAPP.main, ["--mode", "universe", "--frames", "4", "--chunk", "4"])
    assert [(r["mode"], r["frame"], r["ships_alive"]) for r in urows] == [("universe", 3, 64)]

"""A run whose timed path is broken underneath comes out not correct.

Each test skips the harness's look for a card and drives the rest of a
run on the CPU at a tiny size, with one fault planted in the program: a
step that returns its state unchanged, half of the batch left out, and
an answer altered where it is produced (a ball moved by a quarter of its
radius, a tile raised by 0.01); and in the tile call, an erosion walk
that changes nothing, one that walks half of its droplets and one that
erodes rock as dirt (`benchmark/faults.py`).  The limits are the cells'
own.  The clean run comes out correct.  (No cell spans chips, so no
exchange between chips can be left out.)"""

import pytest
import torch

from w3d_torch.models import physics_model as PM
from w3d_torch.models import terrain_model as TMOD

from benchmark import faults, harness

SPHERES = {"config": {"num_objects": 400},
           "traffic": {"settle_steps": 2, "check_from": 2, "check_sample": 1}}
TILES = {"config": {"tile_size": 24, "erosion_iters_tt": 48, "erosion_batch": 48,
                    "erosion_steps": 12},
         "traffic": {"tiles_per_call": 4, "block_tiles": 2, "origin_pool": 32,
                     "warm_steps": 1, "check_from": 2, "check_sample": 1}}


def _run(workload: str, overrides: dict) -> dict:
    return harness.run_cell(workload, 7, 0.3, False, device="cpu", overrides=overrides)


def _frame_unchanged(w, **kw):
    return w


def _frame_half(w, **kw):
    out = FRAME(w, **kw)
    n = out.state.px.shape[0] // 2
    return out._replace(state=out.state._replace(
        **{f: torch.cat([getattr(out.state, f)[:n], getattr(w.state, f)[n:]])
           for f in out.state._fields}))


def _frame_altered(w, **kw):
    out = FRAME(w, **kw)
    return out._replace(state=out.state._replace(px=out.state.px + torch.where(
        torch.arange(out.state.px.shape[0]) == 3, 0.01, 0.0)))


FRAME = PM.frame_step
LAST = {}


def _tiles_unchanged(*a, **kw):
    z = TILE(*a, **kw)
    out = LAST.get("z", z)
    LAST["z"] = z
    return out


def _tiles_half(*a, **kw):
    z = TILE(*a, **kw)
    h = z.shape[0] // 2
    return torch.cat([z[:h], z[:z.shape[0] - h]])


def _tiles_altered(*a, **kw):
    z = TILE(*a, **kw).clone()
    z[1] += 0.01
    return z


TILE = TMOD.tile_batch_step


def test_clean_runs_are_correct():
    assert _run("spheres_10k.pile", SPHERES)["correct"]
    assert _run("tiled_terrain_128.batch4096", TILES)["correct"]


@pytest.mark.parametrize("fault", [_frame_unchanged, _frame_half, _frame_altered])
def test_a_broken_frame_is_not_correct(monkeypatch, fault):
    monkeypatch.setattr(PM, "frame_step", fault)
    r = _run("spheres_10k.pile", SPHERES)
    assert not r["correct"] and r["failed"] >= 1


@pytest.mark.parametrize("fault", [_tiles_unchanged, _tiles_half, _tiles_altered])
def test_a_broken_tile_call_is_not_correct(monkeypatch, fault):
    LAST.clear()
    monkeypatch.setattr(TMOD, "tile_batch_step", fault)
    r = _run("tiled_terrain_128.batch4096", TILES)
    assert not r["correct"] and r["failed"] >= 1


@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
def test_a_broken_erosion_walk_is_not_correct(fault):
    with faults.planted(fault):
        r = _run("tiled_terrain_128.batch4096", TILES)
    assert not r["correct"] and r["failed"] >= 1

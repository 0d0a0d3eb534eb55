"""CUDA graphs of the physics frame (`w3d_torch/physics/graphs`).  This
file imports no jax.

On the CPU: `step_objects` never captures (its frames count as eager);
the key changes with the scene and the type table (identity and in-place
edits) and with the frame's options and the env's shapes, not with the
state's or the env's values.  The capture policy, through the frame's
wiring as through the tile batch's, is tested in `test_torch_cuda_graphs`.
On the card (`gpu`): replayed frames of the 10K pile, dry, in water and on
ice, are bit for bit eager frames and never alias; a capture that reads
the card falls back to eager frames; an edit of the scene
captures anew; the kernels' launch counts (B, C, D and the glue's) rise
as eager frames' do; a
profiled replay shows its span and the pair kernel.  A city frame
(`city/city_step.FRAMES`) launches the pedestrians' separation kernel
once, eager, captured or replayed, and `TiledWorld.counts` counts it.
"""

import numpy as np
import pytest
import torch

from w3d_torch.city import assemble as CA
from w3d_torch.city import city_step as CS
from w3d_torch.models import physics_model as PM
from w3d_torch.models import world as W
from w3d_torch.ops.cuda import glue_kernel as GL
from w3d_torch.ops.cuda import graphs as CG
from w3d_torch.ops.cuda import narrow_kernel as NK
from w3d_torch.ops.cuda import pairs_kernel as PK
from w3d_torch.ops.cuda import sample_kernel as SK
from w3d_torch.ops.cuda import separation_kernel as SEP
from w3d_torch.physics import cobjs as PC
from w3d_torch.physics import graphs as G
from w3d_torch.physics import types as T
from w3d_torch.utils import profiler as P
from w3d_torch.utils.constants import WorldConst

from torch_port_util import cuda_device  # noqa: F401

WORLD = WorldConst(mesh_x=32, mesh_y=32, x_scene=4.0, y_scene=4.0, z_scene=4.0)
OPTIONS = dict(tstep=0.007, substeps=4, world=WORLD, obj_collisions=True,
               pair_window=288, pair_every=2, water=False)


def _world(n=64, device="cpu", world=WORLD, seed=1):
    g = torch.Generator().manual_seed(seed)
    pos = torch.rand((n, 3), generator=g) * 4.0 - 2.0
    pos[:, 2] += 3.0
    vel = torch.randn((n, 3), generator=g) * 0.5
    return PM.build_spheres_world(pos.to(device), vel.to(device), world=world,
                                  obj_type="BALL", device=device)


def _key(w, **options):
    return G.frame_key(w.state, w.env, w.cobjs, w.table, **{**OPTIONS, **options})


@pytest.fixture
def frames(monkeypatch):
    """A fresh frame cache in place of the module's."""
    fg = CG.GraphCache("physics")
    monkeypatch.setattr(G, "FRAMES", fg)
    return fg


def test_cpu_frames_never_capture(frames):
    w = _world()
    for _ in range(3):
        w = PM.frame_step(w, substeps=4, world=WORLD, pair_every=2, water=False)
    assert not G.capturable(w.state, w.env)
    assert frames.counts == {**dict.fromkeys(CG.COUNTS, 0), "graph_eager": 3}
    assert not frames.graphs and frames.last is None


def _replace_scene(w):
    return w._replace(cobjs=PC.GroupedCobjs(w.cobjs.cobjs, w.cobjs.bounds))


def _replace_scene_tensors(w):
    w.cobjs.cobjs = w.cobjs.cobjs._replace()
    return w


def _edit_scene(w):
    w.cobjs.cobjs.elasticity.mul_(0.5)
    return w


def _edit_table(w):
    w.table.radius.add_(0.0)
    return w


def _replace_table(w):
    return w._replace(table=w.table._replace())


def _water_map(w):
    return w._replace(env=w.env._replace(water_height=torch.zeros_like(w.env.mesh_height)))


def _bigger_mesh(w):
    return w._replace(env=w.env._replace(mesh_height=torch.zeros(16, 32)))


def _more_balls(w):
    return w._replace(state=type(w.state)(*(torch.cat([t, t[:1]]) for t in w.state)))


@pytest.mark.parametrize("change", [
    _replace_scene, _replace_scene_tensors, _edit_scene, _edit_table, _replace_table,
    _water_map, _bigger_mesh, _more_balls,
    lambda w: dict(substeps=5), lambda w: dict(tstep=0.006),
    lambda w: dict(pair_every=1), lambda w: dict(pair_window=64),
    lambda w: dict(obj_collisions=False), lambda w: dict(water=True),
    lambda w: dict(world=WorldConst(mesh_x=64, mesh_y=32)),
], ids=["new scene", "new scene tensors", "scene edited", "table edited",
        "new table", "water map", "mesh shape", "population", "substeps", "tstep",
        "pair_every", "pair_window", "obj_collisions", "water", "world"])
def test_key_changes_with_what_a_capture_bakes_in(change):
    w = _world()
    k0 = _key(w)
    got = change(w)
    w2, opts = (w, got) if isinstance(got, dict) else (got, {})
    assert _key(w2, **opts) != k0
    assert _key(w) == _key(w) and hash(k0) is not None


@pytest.mark.parametrize("edit", ["state values", "env values", "new state", "new env"])
def test_key_holds_under_new_values(edit):
    w = _world()
    k0 = _key(w)
    if edit == "state values":
        w.state.px.add_(1.0)
        w.state.status.zero_()
    elif edit == "env values":
        w.env.mesh_height.add_(0.5)
        w.env.wind.mul_(2.0)
    elif edit == "new state":
        w = w._replace(state=type(w.state)(*(t.clone() for t in w.state)))
    else:
        w = w._replace(env=type(w.env)(*(None if t is None else t + 1 for t in w.env)))
    assert _key(w) == k0


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

PILE = WorldConst(mesh_x=128, mesh_y=128, x_scene=4.0, y_scene=4.0, z_scene=4.0)


def _pile(device, water=None):
    """The 10K pile; with `water` "water" or "ice", a water plane at z = 2
    under a per-cell level rising from 1.5 to 2.5 across x, liquid or
    frozen, so that half the balls start in it."""
    pos, vel = PM.spawn(10_000, torch.Generator(device=device).manual_seed(7), device=device)
    w = PM.build_spheres_world(pos, vel, world=PILE, device=device)
    if water:
        ramp = torch.linspace(1.5, 2.5, PILE.mesh_x, device=device)
        w = w._replace(env=w.env._replace(
            water_plane_z=torch.tensor(2.0, device=device),
            water_height=ramp.expand(PILE.mesh_y, -1).contiguous(),
            temperature=torch.tensor(20.0 if water == "water" else -5.0, device=device)))
    return w


def _step(w, water=None):
    return PM.frame_step(w, substeps=10, world=PILE, pair_every=5, water=bool(water))


def _chain(w, n, water=None):
    out = []
    for _ in range(n):
        w = _step(w, water)
        out.append(w)
    return out


def _launches():
    """B, C, D, then the glue's advance, contact, respond, apply_pairs,
    take_rows and age_objects."""
    return [SK.KERNEL.launches, NK.KERNEL.launches, PK.KERNEL.launches] + [
        k.launches for k in GL.KERNELS]


@pytest.mark.gpu
@pytest.mark.parametrize("water", [None, "water", "ice"])
def test_replayed_frames_are_eager_frames(cuda_device, frames, monkeypatch, water):
    with monkeypatch.context() as m:
        m.setattr(G, "capturable", lambda state, env: False)
        w0 = _chain(_pile(cuda_device, water), 5, water)[-1]
        eager = [w.state for w in _chain(w0, 20, water)]
    before = dict(frames.counts)
    got = [w.state for w in _chain(w0, 20, water)]
    assert (frames.counts["graph_captures"] - before["graph_captures"],
            frames.counts["graph_replays"] - before["graph_replays"]) == (1, 19)
    for a, b in zip(eager, got):            # after all 20: no frame was overwritten
        for f in a._fields:
            assert torch.equal(getattr(a, f), getattr(b, f)), f
    assert len({t.data_ptr() for s in got for t in s}) == 11 * len(got)
    if water:
        wet = T.FL_IN_WATER if water == "water" else T.FL_IS_ON_ICE
        assert int(((got[-1].flags & wet) != 0).sum()) > 100


@pytest.mark.gpu
def test_a_scene_edit_captures_anew(cuda_device, frames, monkeypatch):
    w = _chain(_pile(cuda_device), 3)[-1]
    w.cobjs.cobjs.elasticity.mul_(0.5)
    with monkeypatch.context() as m:
        m.setattr(G, "capturable", lambda state, env: False)
        eager = _chain(w, 3)[-1].state
    before = frames.counts["graph_captures"]
    got = _chain(w, 3)[-1].state
    assert frames.counts["graph_captures"] - before == 1 and len(frames.graphs) == 2
    assert all(torch.equal(a, b) for a, b in zip(eager, got))


@pytest.mark.gpu
def test_a_capture_that_syncs_falls_back(cuda_device):
    fg = CG.GraphCache("physics")
    w = _pile(cuda_device)

    def frame(b):
        state = b["state"]
        float(state.px.sum())           # a host read: no capture takes it
        b["state"] = state._replace(px=state.px + 1.0)

    outs = [fg.run(("k",), [(None, frame)], {"state": w.state, "env": w.env}, ("state",))[0]
            for _ in range(3)]
    assert fg.counts["graph_failed"] == 1 and list(fg.failed) == [("k",)] and not fg.graphs
    assert all(torch.equal(o.px, w.state.px + 1.0) for o in outs)
    assert _step(w).state.px.is_cuda      # the card still runs frames


@pytest.mark.gpu
def test_launch_counts_of_replayed_frames(cuda_device, frames):
    w = _pile(cuda_device)
    per = []
    for _ in range(5):
        c0 = _launches()
        w = _step(w)
        per.append([b - a for a, b in zip(c0, _launches())])
    assert frames.counts["graph_replays"] and per[0] == per[1] == per[2] == per[3] == per[4]
    assert per[0] == [10, 10, 2, 10, 10, 10, 2, 1, 1]


class _NoTiles:
    """A tile manager with nothing to stream: the city frame alone."""

    def update(self, cam_x, cam_y, max_tiles_per_frame=None):
        return [], []


@pytest.mark.gpu
def test_launch_counts_of_replayed_city_frames(cuda_device):
    cw = CA.build_city(np.zeros((128, 128), np.float32), num_cities=2, num_cars=64,
                       num_peds=256, num_helis=4, seed=3, device=cuda_device)
    w = W.make_tiled_world(_NoTiles(), cw, seed=3, chunk=1, device=cuda_device)
    before = dict(CS.FRAMES.counts)
    per = []
    for frames in (1, 1, 1, 1, 1, 1, 4, 4, 4):
        c0 = SEP.KERNEL.launches
        w.step_chunk(0.0, 0.0, frames=frames)
        per.append(SEP.KERNEL.launches - c0)
    assert [CS.FRAMES.counts[k] - before[k] for k in
            ("graph_eager", "graph_captures", "graph_replays", "graph_failed")] == [2, 2, 7, 0]
    assert per == [1] * 6 + [4] * 3 and w.counts["separation"] == 18


@pytest.mark.gpu
def test_profiled_replay_shows_its_span_and_kernels(cuda_device, frames):
    w = _chain(_pile(cuda_device), 3)[-1]     # captured before the profiler starts
    P.spans(clear=True)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        _chain(w, 3)
        torch.cuda.synchronize()
    tree = [(s.name, s.parent.name if s.parent else None) for s in P.spans(clear=True)
            if s.parent is None or s.parent.name == "frame"]
    assert tree == [("frame", None), ("physics.graph", "frame")] * 3
    names = [e.name() for e in prof.profiler.kineto_results.events()
             if e.device_type() == torch.autograd.DeviceType.CUDA]
    assert sum("banded_pairs_kernel" in n for n in names) >= 4

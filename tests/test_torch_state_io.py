"""Torch port vs JAX package: state and checkpoint I/O
(`terrain/state_io`, `utils/checkpoint.save_pytree`/`load_pytree`), the
timing profiler (`utils/profiler`) and the edit menus (`utils/edit_ui`).

All exact: a mesh or sim-state file either package writes is byte for
byte what the other writes and reads back equal in both; a checkpoint
the JAX package wrote for an `ObjectState` (and for a tree of dicts,
lists and None) loads into the port bitwise, its uint32 flags into the
port's int32 ones; the port's own checkpoints round-trip bitwise onto
the device of `like`; menus render the same rows after the same key
presses."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import w3d  # noqa: F401
from w3d.terrain import state_io as JSIO
from w3d.utils import checkpoint as JCK, profiler as JPROF, edit_ui as JUI
from w3d.physics import types as JPT, step as JPS

from w3d_torch import convert
from w3d_torch.terrain import state_io as TSIO
from w3d_torch.utils import checkpoint as TCK, profiler as TPROF, edit_ui as TUI
from w3d_torch.physics import types as TPT, step as TPS


def _sim_state(mod, table):
    return mod.SimState(2.5, 0.1, 1.2, (1.0, 2.0, 3.0), (0.0, 0.0, 0.5),
                        3, -2, 0, 0, 7, 40014, 40692, 128, 128, 9, 10, table)


def test_state_files_byte_equal(tmp_path):
    rng = np.random.default_rng(0)
    h = rng.standard_normal((12, 16)).astype(np.float32)
    table = rng.standard_normal((90, 5)).astype(np.float32)
    JSIO.write_mesh(str(tmp_path / "j_mesh.txt"), h)
    TSIO.write_mesh(str(tmp_path / "t_mesh.txt"), torch.as_tensor(h))
    assert (tmp_path / "j_mesh.txt").read_bytes() == (tmp_path / "t_mesh.txt").read_bytes()
    for kw in ({}, dict(expect_shape=(12, 16), mesh_file_scale=2.0, mesh_file_tz=1.0)):
        a = TSIO.read_mesh(str(tmp_path / "j_mesh.txt"), **kw)
        np.testing.assert_array_equal(a, JSIO.read_mesh(str(tmp_path / "t_mesh.txt"), **kw))
    for mod in (TSIO, JSIO):
        with pytest.raises(ValueError):
            mod.read_mesh(str(tmp_path / "t_mesh.txt"), expect_shape=(8, 8))
    JSIO.save_state(str(tmp_path / "j_state.txt"), _sim_state(JSIO, table))
    ts = convert.sim_state(_sim_state(JSIO, table), "cpu")
    assert isinstance(ts.sine_table, torch.Tensor)
    TSIO.save_state(str(tmp_path / "t_state.txt"), ts)
    assert (tmp_path / "j_state.txt").read_bytes() == (tmp_path / "t_state.txt").read_bytes()
    a = TSIO.load_state(str(tmp_path / "j_state.txt"), expect_dims=(128, 128, 9, 10))
    b = JSIO.load_state(str(tmp_path / "t_state.txt"), expect_dims=(128, 128, 9, 10))
    for f in TSIO.SimState._fields:
        np.testing.assert_array_equal(np.asarray(getattr(a, f)), np.asarray(getattr(b, f)))
    with pytest.raises(ValueError):
        TSIO.load_state(str(tmp_path / "j_state.txt"), expect_dims=(64, 64, 9, 10))


def _object_states(n=40):
    rng = np.random.default_rng(1)
    pos = rng.standard_normal((n, 3)).astype(np.float32)
    vel = rng.standard_normal((n, 3)).astype(np.float32)
    ot = rng.integers(0, 8, n).astype(np.int32)
    jst = JPS.make_state(pos, vel, ot, JPT.make_type_table())
    jst = jst._replace(flags=jnp.asarray(rng.integers(0, 2 ** 31, n).astype(np.uint32)),
                       status=jnp.asarray(rng.integers(0, 5, n).astype(np.int32)))
    return jst, convert.object_state(jax.tree.map(np.asarray, jst), "cpu")


def test_jax_checkpoint_loads_into_port(tmp_path):
    jst, tst = _object_states()
    p = str(tmp_path / "j.npz")
    JCK.save_pytree(p, jst)
    like = TPS.make_state(np.zeros((40, 3)), np.zeros((40, 3)), np.zeros(40, np.int32),
                          TPT.make_type_table(device="cpu"))
    out = TCK.load_pytree(p, like)
    for f in TPS.ObjectState._fields:
        a, b = getattr(out, f), getattr(tst, f)
        assert a.dtype == b.dtype and torch.equal(a, b), f
    # dict keys flatten sorted (not in insertion order), lists in order,
    # None dropped, in both packages
    jtree = {"zeta": jnp.arange(3.0), "alpha": [jnp.ones((2, 2)), None,
                                                jnp.asarray([7], jnp.int32)],
             "mid": {"b": jnp.zeros(4), "a": jnp.full((1,), 2.5)}}
    JCK.save_pytree(p, jtree)
    tlike = {"zeta": torch.zeros(3), "alpha": [torch.zeros(2, 2), None,
                                               torch.zeros(1, dtype=torch.int32)],
             "mid": {"b": torch.zeros(4), "a": torch.zeros(1)}}
    t = TCK.load_pytree(p, tlike)
    assert list(t) == ["zeta", "alpha", "mid"] and t["alpha"][1] is None
    np.testing.assert_array_equal(t["zeta"].numpy(), [0, 1, 2])
    np.testing.assert_array_equal(t["alpha"][2].numpy(), [7])
    assert float(t["mid"]["a"]) == 2.5 and t["alpha"][0].shape == (2, 2)
    with pytest.raises(ValueError, match="leaf"):
        TCK.load_pytree(p, {**tlike, "zeta": torch.zeros(4)})


def test_port_checkpoint_roundtrip(tmp_path):
    _, tst = _object_states()
    p = str(tmp_path / "t.npz")
    TCK.save_pytree(p, tst)
    out = TCK.load_pytree(p, tst)
    assert all(torch.equal(a, b) for a, b in zip(out, tst))
    tree = {"b": [tst.px, None, (tst.status, torch.tensor(3.5))], "a": tst.flags}
    TCK.save_pytree(p, tree)
    back = TCK.load_pytree(p, tree)
    assert torch.equal(back["b"][2][0], tst.status) and back["b"][1] is None
    assert float(back["b"][2][1]) == 3.5 and torch.equal(back["a"], tst.flags)
    # a structurally different tree with the same leaf count must raise
    other = {f"k{i}": torch.zeros(3) for i in range(len(TPS.ObjectState._fields))}
    TCK.save_pytree(p, tst)
    with pytest.raises(ValueError, match="treedef mismatch"):
        TCK.load_pytree(p, other)
    with pytest.raises(ValueError, match="leaf count"):
        TCK.load_pytree(p, {"x": torch.zeros(1)})


def test_profiler_matches():
    reports = []
    for mod in (TPROF, JPROF):
        prof = mod.TimingProfiler()
        for s in (0.002, 0.005, 0.001):
            prof.register("stage_a", s)
        prof.register("stage_b", 0.01)
        with prof.time("stage_c"):
            sum(range(100))
        prof.enabled = False
        prof.register("stage_a", 1.0)
        e = prof.entries["stage_a"]
        assert e.count == 3 and e.tmax == 0.005 and abs(e.avg - 0.008 / 3) < 1e-12
        reports.append([line for line in prof.report().splitlines()
                        if not line.startswith("stage_c")])
        prof.clear()
        assert not prof.entries
    assert reports[0] == reports[1]


def test_edit_menus_match():
    for name in JUI.ALL_MENUS:
        tm, jm = TUI.ALL_MENUS[name](), JUI.ALL_MENUS[name]()
        for key in ("increase", "select_next", "increase", "increase", "select_prev",
                    "decrease", "select_next", "select_next") + ("increase",) * 60 + (
                    "select_prev",) + ("decrease",) * 90:
            getattr(tm, key)()
            getattr(jm, key)()
            assert tm.render() == jm.render() and tm.values() == jm.values()
        assert all(0.0 <= c.slider_pos <= 1.0 for c in tm.controls)
    m = TUI.voxel_brush_menu()
    m.increase()
    assert m["mode"].text == "remove"
    with pytest.raises(KeyError):
        m["nope"]

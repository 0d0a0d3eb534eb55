"""Torch port vs JAX package: universe mode's world (`models/world.
UniverseWorld`) and app (`app.run_universe`, `main --mode universe`), on
the CPU.

The JAX draws are threefry: the tests replay the JAX app's key chains
through `jax_universe_draws` (the fleet from `key(seed)`, the combat
frames from the world's `key(1)` folded with the chunk's first frame).
The JAX side runs op by op (`jax.disable_jit`), for the reason given in
test_torch_ships.py.  World states: floats within 1e-5, integer and
boolean fields equal; the app's printed rows equal in every key but
`ms`."""

import contextlib
import io
import json
import sys

import numpy as np
import pytest
import jax
import jax.numpy as jnp

import w3d  # noqa: F401
from w3d import app as JAPP
from w3d.models import world as JW
from w3d.universe import gen as JG, ships as JSH, ship_config as JSC, combat as JCB

from w3d_torch import app as TAPP
from w3d_torch.models import world as TW
from w3d_torch.universe import gen as TG, ships as TSH, ship_config as TSC, combat as TCB
from w3d_torch.utils.kernel_probe import write_ship_defs

from torch_port_util import jax_fleet_draws, jax_universe_draws, same_tree


def _rows(fn, *a, **k):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*a, **k)
    return out, [json.loads(line) for line in buf.getvalue().splitlines()]


def _strip(rows):
    return [{k: v for k, v in r.items() if k != "ms"} for r in rows]


def test_world_fleet_branch_hazards_and_player():
    """The fleet branch over 3 chunks: a configured black hole beside the
    fleet and the stars of the galaxies the player reaches, a player ship
    steered by controls; ships near the hole flee it (-x velocity, as
    tests/test_universe.py:412-432 asserts of the JAX world)."""
    key = jax.random.key(2)
    jf = JSH.make_fleet(key, 8, num_teams=1, spread=0.01)
    tf = TSH.make_fleet(jax_fleet_draws(key, 8, num_teams=1, spread=0.01))
    holes = [((0.3, 0.0, 0.0), 0.02)]
    jw = JW.UniverseWorld(state=JG.UniverseState(), fleet=jf, black_holes=holes,
                          player_ship=JSH.make_player_ship(1, (0.0, 0.0, 0.0)))
    tw = TW.UniverseWorld(state=TG.UniverseState(), fleet=tf, black_holes=holes,
                          player_ship=TSH.make_player_ship(1, (0.0, 0.0, 0.0), device="cpu"))
    controls = [(JSH.MOVE_FRONT, 2.0, True), (JSH.MOVE_LEFT, 1.0, False)]
    with jax.disable_jit():
        for k in range(3):
            jr = jw.step_chunk((0.0, 0.0, 0.0), frames=2, controls=controls if k else ())
            tr = tw.step_chunk((0.0, 0.0, 0.0), frames=2, controls=controls if k else ())
            assert tr == jr
            same_tree(tw.fleet, jw.fleet)
            same_tree(tw.player_ship, jw.player_ship)
            jh, th = jw._hazards(), tw._hazards("cpu")
            for a, b in zip(th, jh):
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert bool(th[2][0]) and (tw.fleet.vx <= 0.0).all()
    assert tw.frame == jw.frame == 6 and float(tw.player_ship.px) > 0.0


def test_world_combat_branch(tmp_path):
    """The combat branch with the parsed tables: 2 chunks of 4 frames on
    the JAX world's draws, with the hazards of the generated cells."""
    path = write_ship_defs(str(tmp_path / "ship_defs.txt"))
    jd, td = JSC.parse_ship_defs(path), TSC.parse_ship_defs(path)
    jf, _jt, _o, _n = JSH.fleet_from_defs(jd, jax.random.key(3))
    # 30 ships of each fleet and 8 dead slots, the attackers moved in
    sel = np.r_[0:30, 55:85, 156:164]
    jp = JSH.FleetState(*(None if v is None else np.asarray(v)[sel] for v in
                          JCB.pad_fleet(jf, 164)))
    jp = jp._replace(px=np.where(jp.align == 5, jp.px - 0.2, jp.px).astype(np.float32))
    jct, tct = JCB.build_combat_tables(jd), TCB.build_combat_tables(td, device="cpu")
    jw = JW.UniverseWorld(state=JG.UniverseState(), fleet=jp,
                          combat=jax.tree.map(jnp.asarray, JCB.make_combat_state(jp, jct, 128)),
                          combat_tables=jct, black_holes=[((0.2, 0.1, 0.0), 0.01)])
    tw = TW.UniverseWorld(state=TG.UniverseState(), fleet=TSH.fleet_to(jp, "cpu"),
                          combat=TCB.make_combat_state(jp, tct, 128), combat_tables=tct,
                          black_holes=[((0.2, 0.1, 0.0), 0.01)], draws=jax_universe_draws(1))
    with jax.disable_jit():
        for k in range(2):
            assert tw.step_chunk((0.1 * k, 0.0, 0.0), frames=4) == \
                jw.step_chunk((0.1 * k, 0.0, 0.0), frames=4)
            same_tree(tw.combat, jw.combat)
    assert tw.fleet is tw.combat.fleet and bool(tw.fleet.attacked.any())


def _layout(tmp_path, kind):
    """A ship-defs directory for run_universe: none, the written defs,
    a config_universe.txt naming them, or only ship_defs_assault.txt."""
    d = tmp_path / "universe"
    d.mkdir()
    if kind == "defs":
        write_ship_defs(str(d / "ship_defs.txt"))
    elif kind == "config":
        write_ship_defs(str(d / "fight_defs.txt"))
        (d / "config_universe.txt").write_text(f"ship_def_file {d / 'fight_defs.txt'}\n")
    elif kind == "assault":
        write_ship_defs(str(d / "ship_defs_assault.txt"))
    return str(d / "ship_defs.txt")


@pytest.mark.parametrize("kind,frames,chunk", [("none", 40, 16), ("defs", 12, 6),
                                               ("config", 4, 4), ("assault", 4, 2)])
def test_run_universe_rows_match_jax_app(tmp_path, monkeypatch, kind, frames, chunk):
    """run_universe's printed rows equal the JAX app's in every key but
    `ms`, on the JAX draws: no defs (64 built-in ships, the fleet step),
    the written defs (the full weapon model), defs named by
    config_universe.txt, and the ship_defs_assault.txt fallback."""
    path = _layout(tmp_path, kind)
    # op by op the JAX app's host-built combat state must be JAX arrays
    # (compiled, the jit converts it).  The app reads `combat` off its
    # `universe` package at call time, which is another module object than
    # JCB once a test has imported the package's modules again under the
    # `w3d` name (tests/test_aux.py::test_import_every_module does), so
    # patch the one the app will take
    app_cb = sys.modules[JAPP.__package__ + ".universe"].combat
    make = app_cb.make_combat_state
    monkeypatch.setattr(app_cb, "make_combat_state",
                        lambda *a, **k: jax.tree.map(jnp.asarray, make(*a, **k)))
    with jax.disable_jit():
        jw, jrows = _rows(JAPP.run_universe, frames, 3, ship_defs=path, chunk=chunk)
    tw, trows = _rows(TAPP.run_universe, frames, 3, ship_defs=path, chunk=chunk,
                      device="cpu", draws=jax_universe_draws(3))
    assert _strip(trows) == _strip(jrows)
    assert len(trows) == -(-frames // chunk) and trows[0]["cells_created"] == 343
    if kind == "none":
        assert tw.combat is None and len(tw.fleet.px) == 64
        same_tree(tw.fleet, jw.fleet)
    else:
        assert tw.combat is not None and tw.combat.fleet.px.shape[0] == 156 + 39
        assert tw.combat.proj.px.shape[0] == 1024
        same_tree(tw.combat, jw.combat)


def test_main_runs_universe_mode(monkeypatch, tmp_path):
    """`main(["--mode", "universe", ...])` under W3D_PLATFORM=cpu no longer
    raises: it runs the chunks and prints one row each."""
    monkeypatch.setenv("W3D_PLATFORM", "cpu")
    monkeypatch.setenv("W3D_ASSET_ROOT", str(tmp_path))    # no universe/ there
    _, rows = _rows(TAPP.main, ["--mode", "universe", "--frames", "6", "--chunk", "4"])
    assert [r["frame"] for r in rows] == [3, 5]
    assert all(r["mode"] == "universe" and r["ships_alive"] == 64 for r in rows)

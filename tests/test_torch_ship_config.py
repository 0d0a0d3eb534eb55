"""Torch port vs JAX package: the ship-defs parser (`universe/ship_config`)
on the synthetic `$`-sectioned file of `kernel_probe.write_ship_defs`
(its weapons in an `$INCLUDE`d part), written to `tmp_path` and parsed by
both packages.  Host code in both: every parsed field, the tables and the
collision shapes equal."""

import dataclasses
import os

import numpy as np
import pytest

import w3d  # noqa: F401
from w3d.universe import ship_config as JSC

from w3d_torch.universe import ship_config as TSC
from w3d_torch.utils.kernel_probe import write_ship_defs


@pytest.fixture(params=[1, 8], ids=["x1", "x8"])
def parsed(request, tmp_path):
    path = write_ship_defs(str(tmp_path / "ship_defs.txt"), multiplier=request.param)
    return request.param, TSC.parse_ship_defs(path), JSC.parse_ship_defs(path)


def _plain(v):
    if dataclasses.is_dataclass(v):
        return {f.name: _plain(getattr(v, f.name)) for f in dataclasses.fields(v)}
    if isinstance(v, dict):
        return {k: _plain(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_plain(x) for x in v]
    return v


def test_every_parsed_field_matches_jax(parsed):
    """Classes (fields after the unit conversions, colors, explosions,
    loadouts with their firing points, collision shapes), weapons (with
    the beam's $WBEAM row), fleets, build lists and globals: equal."""
    mult, td, jd = parsed
    assert _plain(td) == _plain(jd)
    assert sorted(td.sclasses) == [0, 2, 3, 8, 9, 17, 28]
    assert len(td.weapons) == 6 and td.weapons[6].beam is not None
    assert [f.align for f in td.fleets] == [4, 5]
    assert sum(f.multiplier * sum(f.counts) for f in td.fleets) == 156 * mult
    assert td.globals["start_pos"] == (0.1, 0.0, 0.0)
    assert td.sclasses[9].cobjs == [("sphere", (0.5, 0.0, 0.0), 0.6, 1.0)]
    torpedo = td.weapons[TSC.WEAP_IDS.index("UWEAP_TORPEDO")].fields
    # $WEAP conversions: range = speed * lifetime, seek and contact radii
    # scaled by the projectile radius
    assert torpedo["range"] == pytest.approx(0.004 * 480.0)
    assert torpedo["seek_dist"] == pytest.approx(0.03)


def test_tables_match_jax(parsed):
    """ship_class_table, ship_part_geometry (4 and 8 parts),
    primary_fire_points and each class's primary weapon: equal."""
    _mult, td, jd = parsed
    np.testing.assert_array_equal(TSC.ship_class_table(td), JSC.ship_class_table(jd))
    for k in (4, 8):
        for a, b in zip(TSC.ship_part_geometry(td, k), JSC.ship_part_geometry(jd, k)):
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(TSC.primary_fire_points(td), JSC.primary_fire_points(jd))
    np.testing.assert_array_equal(TSC.primary_fire_points(td)[9],
                                  np.float32([0.8, 0.0, 0.0]))   # the torpedo's mount
    for sid in td.sclasses:
        tw = TSC.primary_weapon(td, td.sclasses[sid])
        jw = JSC.primary_weapon(jd, jd.sclasses[sid])
        assert (tw and tw.wclass) == (jw and jw.wclass)


def test_parser_errors_and_paths_match_jax(tmp_path, monkeypatch):
    """An unknown keyword, an unknown enum and an $ADD outside a loadout
    raise the same ValueError in both; shipped_defs_path follows
    W3D_ASSET_ROOT in both."""
    for text in ("$NOPE 1\n", '$SHIP USC_NOPE "x"\n', "$ADD UWEAP_EBEAM\n"):
        p = tmp_path / "bad.txt"
        p.write_text(text)
        with pytest.raises(ValueError) as te:
            TSC.parse_ship_defs(str(p))
        with pytest.raises(ValueError) as je:
            JSC.parse_ship_defs(str(p))
        assert str(te.value) == str(je.value)
    monkeypatch.setenv("W3D_ASSET_ROOT", str(tmp_path))
    assert TSC.shipped_defs_path() == JSC.shipped_defs_path() == \
        os.path.join(str(tmp_path), "universe", "ship_defs.txt")
    monkeypatch.setenv("W3D_ASSET_ROOT", "")
    assert TSC.shipped_defs_path("x.txt") == JSC.shipped_defs_path("x.txt") == \
        os.path.join("universe", "x.txt")

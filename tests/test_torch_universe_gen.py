"""Torch port vs JAX package: universe generation (`universe/gen`), the
asset root (`utils/assets`) and the names (`utils/names`).

Both packages' generators are the same host code over the same LCG, so
everything here is held bitwise: cells, galaxies and their lazily
generated systems, the paged 7^3 window over a camera path (the created
and freed cell lists in order), gravity, planet rings, orbital positions
and the body names.  Names are held under `W3D_ASSET_ROOT=""` (no asset
tree: the procedural fallbacks), with both packages' `names` reloaded so
that their import-time text-data directory follows it."""

import dataclasses
import importlib
import os

import pytest

import w3d  # noqa: F401
from w3d.universe import gen as JG
from w3d.utils import assets as JAS, names as JN

from w3d_torch.universe import gen as TG
from w3d_torch.utils import assets as TAS, names as TN


def _tree(v):
    """Dataclasses (Cells, Galaxies with their systems, Systems, Stars,
    Planets, Moons) as nested plain values."""
    if isinstance(v, (JG.Galaxy, TG.Galaxy)):
        d = {f.name: _tree(getattr(v, f.name)) for f in dataclasses.fields(v)
             if f.name != "_systems"}
        d["systems"] = _tree(v.systems)
        return d
    if dataclasses.is_dataclass(v):
        return {f.name: _tree(getattr(v, f.name)) for f in dataclasses.fields(v)}
    if isinstance(v, (list, tuple)):
        return [_tree(x) for x in v]
    return v


@pytest.fixture
def no_assets(monkeypatch):
    """W3D_ASSET_ROOT="" with both `names` modules reloaded; reloaded again
    after the test, under the environment it found."""
    monkeypatch.setenv("W3D_ASSET_ROOT", "")
    importlib.reload(JN)
    importlib.reload(TN)
    yield
    monkeypatch.undo()
    importlib.reload(JN)
    importlib.reload(TN)


@pytest.mark.parametrize("coords", [(0, 0, 0), (1, -2, 3), (-7, 5, 11), (40, -33, 2)])
def test_gen_cell_matches_jax(coords):
    """A cell, its galaxies and every galaxy's systems (generated on
    access): equal."""
    assert _tree(TG.gen_cell(coords)) == _tree(JG.gen_cell(coords))
    assert TG.gen_rand_seed1(coords) == JG.gen_rand_seed1(coords)
    assert TG.gen_rand_seed2(coords) == JG.gen_rand_seed2(coords)


def test_universe_paging_matches_jax():
    """UniverseState.update over a camera path crossing cells: the
    created and freed lists (in order), the window's cells and which
    galaxies generated their systems, equal; 343 cells at start, 49 per
    cell crossed."""
    js, ts = JG.UniverseState(), TG.UniverseState()
    path = [(0.0, 0.0, 0.0), (3.0, 0.0, 0.0), (6.0, 0.5, 0.0), (16.0, -4.0, 1.0),
            (16.0, -4.0, 1.0), (9.0, -12.0, 6.0)]
    counts = []
    for p in path:
        jc, jf = js.update(p)
        tc, tf = ts.update(p)
        assert tc == jc and tf == jf
        counts.append(len(tc))
        assert ts.num_systems() == js.num_systems()
        assert ts.num_generated() == js.num_generated()
        assert list(ts.cells) == list(js.cells)
        for k in js.cells:
            for jg, tg in zip(js.cells[k].galaxies, ts.cells[k].galaxies):
                assert tg.generated == jg.generated
                if jg.generated:
                    assert _tree(tg) == _tree(jg)
    assert counts[:2] == [343, 0] and counts[2] == 49
    assert ts.ensure_near((16.0, -4.0, 1.0), radius=20.0) == \
        js.ensure_near((16.0, -4.0, 1.0), radius=20.0)


def test_gravity_rings_and_orbits_match_jax():
    """get_gravity, gen_prings and the orbital positions of every planet
    and moon: equal (host float64 in both)."""
    jc, tc = JG.gen_cell((2, 1, -1)), TG.gen_cell((2, 1, -1))
    for pos in ((0.0, 0.0, 0.0), (21.3, 9.7, -8.2), tuple(jc.galaxies[0].pos)):
        assert TG.get_gravity(tc, pos) == JG.get_gravity(jc, pos)
    rings = 0
    for jgal, tgal in zip(jc.galaxies, tc.galaxies):
        for jsy, tsy in zip(jgal.systems, tgal.systems):
            for t in (0.0, 137.0, 4.5e4):
                assert TG.system_body_positions(tsy, t) == JG.system_body_positions(jsy, t)
            for jp, tp in zip(jsy.planets, tsy.planets):
                assert TG.gen_prings(tp) == JG.gen_prings(jp)
                rings += jp.has_rings
    assert rings > 0


def test_body_names_match_jax(no_assets):
    """The names of galaxies, systems, planets and moons: equal."""
    assert TN.TEXT_DATA_DIR == JN.TEXT_DATA_DIR == ""
    jc, tc = JG.gen_cell((3, -1, 4)), TG.gen_cell((3, -1, 4))
    names = 0
    for jgal, tgal in zip(jc.galaxies, tc.galaxies):
        assert TG.galaxy_name(tgal) == JG.galaxy_name(jgal)
        for jsy, tsy in zip(jgal.systems[:8], tgal.systems[:8]):
            assert TG.system_name(tsy) == JG.system_name(jsy)
            for jp, tp in zip(jsy.planets, tsy.planets):
                assert TG.planet_name(tp) == JG.planet_name(jp)
                names += 1
                for jm, tm in zip(jp.moons, tp.moons):
                    assert TG.moon_name(tm) == JG.moon_name(jm)
    assert names > 5


def test_names_match_jax(no_assets):
    """The name generators of `utils/names` without an asset tree: random
    names (universe and city phonemes, minimum lengths), person names
    (Markov over the fallback list), company, business and store names,
    and book titles: equal."""
    for seed in range(40):
        for uni in (False, True):
            for min_len in (0, 6):
                assert TN.gen_random_name(TN.RandGen(seed, 7 * seed + 1), min_len, uni) == \
                    JN.gen_random_name(JN.RandGen(seed, 7 * seed + 1), min_len, uni)
        for female in (False, True):
            assert TN.gen_person_name(seed, female) == JN.gen_person_name(seed, female)
        assert TN.gen_company_name(TN.RandGen(seed + 1, 3)) == \
            JN.gen_company_name(JN.RandGen(seed + 1, 3))
        for btype in ("office", "parking", "restaurant", "datacenter", "hotel", "mall"):
            assert TN.choose_business_name(TN.RandGen(seed + 5, 9), btype) == \
                JN.choose_business_name(JN.RandGen(seed + 5, 9), btype)
        assert TN.choose_store_name("food", TN.RandGen(seed + 2, 4)) == \
            JN.choose_store_name("food", JN.RandGen(seed + 2, 4))
        assert TN.choose_book_title(TN.RandGen(seed + 3, 5)) == \
            JN.choose_book_title(JN.RandGen(seed + 3, 5))
    assert TN._FALLBACK_NAMES == JN._FALLBACK_NAMES


def test_asset_root_matches_jax(monkeypatch, tmp_path):
    """asset_root and asset_path: none under W3D_ASSET_ROOT="", the given
    tree otherwise; equal in both packages."""
    monkeypatch.setenv("W3D_ASSET_ROOT", "")
    assert TAS.asset_root() is None and JAS.asset_root() is None
    assert TAS.asset_path("universe", "x.txt") is None
    monkeypatch.setenv("W3D_ASSET_ROOT", str(tmp_path))
    assert TAS.asset_root() == JAS.asset_root() == str(tmp_path)
    assert TAS.asset_path("text_data", "a.txt") == JAS.asset_path("text_data", "a.txt") \
        == os.path.join(str(tmp_path), "text_data", "a.txt")
    assert TAS._CONVENTIONAL == JAS._CONVENTIONAL


def test_names_reload_follows_the_environment(monkeypatch, tmp_path):
    """A text-data tree under W3D_ASSET_ROOT feeds the person and store
    names once `names` is reloaded: equal in both packages."""
    td = tmp_path / "text_data"
    td.mkdir()
    (td / "male_names.txt").write_text("Arthur\nBertram\nCedric\nDunstan\nEdmund\n")
    (td / "female_names.txt").write_text("Agatha\nBeatrix\nCordelia\nDelphine\n")
    (td / "store_names.txt").write_text("food:\nThe Pantry\nGreen Grocer\nclothing:\nThreads\n")
    (td / "book_titles.txt").write_text("A Tale\nAnother Tale\n# a comment\nThird\n")
    monkeypatch.setenv("W3D_ASSET_ROOT", str(tmp_path))
    try:
        for m in (JN, TN):
            importlib.reload(m)
        assert TN.TEXT_DATA_DIR == JN.TEXT_DATA_DIR == str(td)
        for seed in range(20):
            assert TN.gen_person_name(seed, seed % 2 == 0) == \
                JN.gen_person_name(seed, seed % 2 == 0)
            assert TN.choose_store_name("food", TN.RandGen(seed + 1, 2)) == \
                JN.choose_store_name("food", JN.RandGen(seed + 1, 2))
            assert TN.choose_book_title(TN.RandGen(seed + 1, 2)) == \
                JN.choose_book_title(JN.RandGen(seed + 1, 2))
        assert TN.book_titles() == ["A Tale", "Another Tale", "Third"]
    finally:
        monkeypatch.undo()
        for m in (JN, TN):
            importlib.reload(m)

"""Torch port vs JAX package: heightmap image I/O (`export/heightmap_io`),
the brush journal (`utils/checkpoint.ModmapJournal`) and the image-driven
mesh (`terrain/mesh.terrain_from_heightmap`).

Images are written to `tmp_path` from seeded numpy pixels.  Tolerances:
image bytes and pixels exact; the journal's replay 1e-6; the terrain
without erosion bitwise; with erosion, heights within 1e-5 (the port's
erosion against the JAX `erode` with the JAX angle draws, as
tests/test_torch_fbm.py holds `gen_terrain`), the other fields bitwise."""

import numpy as np
import pytest
import torch

import w3d  # noqa: F401
from w3d.export import heightmap_io as JH
from w3d.terrain import mesh as JM
from w3d.utils.checkpoint import ModmapJournal as JJournal
from w3d.utils.constants import WorldConst as JWorld

from w3d_torch.export import heightmap_io as TH
from w3d_torch.terrain import mesh as TMESH
from w3d_torch.utils.checkpoint import ModmapJournal as TJournal
from w3d_torch.utils.constants import WorldConst as TWorld

from torch_port_util import jax_angle_tables, np_tree


def _pixels(shape, bits, seed=4):
    rg = np.random.default_rng(seed)
    hi = 65535 if bits == 16 else 255
    return rg.integers(0, hi + 1, shape).astype(np.uint16 if bits == 16 else np.uint8)


@pytest.mark.parametrize("fmt", ["png8", "png16", "bmp"])
def test_image_round_trip_matches_jax(tmp_path, fmt):
    """The port's writer gives the JAX writer's bytes; each reader reads
    the other's file; heights and write_heightmap agree."""
    bits = 16 if fmt == "png16" else 8
    img = _pixels((21, 30), bits)      # odd width: BMP row padding
    ext = ".bmp" if fmt == "bmp" else ".png"
    jp, tp = str(tmp_path / f"j{ext}"), str(tmp_path / f"t{ext}")
    if fmt == "bmp":
        JH.write_bmp_gray(jp, img)
        TH.write_bmp_gray(tp, img)
    else:
        JH.write_png_gray(jp, img, bit_depth=bits)
        TH.write_png_gray(tp, img, bit_depth=bits)
    assert open(jp, "rb").read() == open(tp, "rb").read()
    for path in (jp, tp):
        a, b = JH.read_image_gray(path), TH.read_image_gray(path)
        assert a.dtype == b.dtype == img.dtype
        np.testing.assert_array_equal(a, img)
        np.testing.assert_array_equal(b, img)
        kw = dict(mesh_height_scale=1.5, invert=True)
        np.testing.assert_array_equal(JH.read_heightmap(path, **kw),
                                      TH.read_heightmap(path, **kw))
    h = JH.read_heightmap(jp)
    JH.write_heightmap(jp, h, bit_depth=bits)
    TH.write_heightmap(tp, h, bit_depth=bits)
    assert open(jp, "rb").read() == open(tp, "rb").read()


def test_png_filters_and_errors(tmp_path):
    """Every PNG scanline filter (types 0-4) the JAX reader undoes, the
    port undoes; malformed input raises ValueError."""
    rg = np.random.default_rng(5)
    raw = bytearray()
    for r in range(5):
        raw += bytes([r]) + rg.integers(0, 256, 16).astype(np.uint8).tobytes()
    raw = bytes(raw)
    for bpp in (1, 2):
        np.testing.assert_array_equal(
            np.frombuffer(JH._unfilter(raw, 5, 16, bpp), np.uint8),
            np.frombuffer(TH._unfilter(raw, 5, 16, bpp), np.uint8))
    bad = tmp_path / "bad.png"
    bad.write_bytes(b"not an image")
    with pytest.raises(ValueError, match="PNG"):
        TH.read_png_gray(str(bad))
    rgb = tmp_path / "rgb.png"
    TH.write_png_rgb(str(rgb), _pixels((4, 5, 3), 8))
    with pytest.raises(ValueError, match="grayscale"):
        TH.read_png_gray(str(rgb))
    np.testing.assert_array_equal(JH.read_image_rgb(str(rgb)), TH.read_image_rgb(str(rgb)))


def _journal(cls):
    j = cls()
    j.add(5, 7, 4, 0.3, 0)
    j.add(20, 11, 6, -0.5, 1)
    j.add(12, 25, 9, 0.25, 2)
    j.add(30, 2, 0, 1.0, 1)             # radius 0: max(r, 1) in the falloff
    j.add(1, 1, 3, 0.1, 5)
    j.add(9, 9, 2, 9.0, 0)
    j.undo()
    return j


def test_modmap_apply_matches_jax(tmp_path):
    """Shapes 0 (disc), 1 (linear), 2 (quadratic) at 1e-6; a journal
    saved by either package loads in the other."""
    hm = np.random.default_rng(6).standard_normal((28, 33)).astype(np.float32)
    jj, tj = _journal(JJournal), _journal(TJournal)
    ref = np.asarray(jj.apply(hm))
    out = tj.apply(torch.as_tensor(hm))
    assert out.dtype == torch.float32 and out.device.type == "cpu"
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-6)
    np.testing.assert_allclose(tj.apply(hm, device="cpu").numpy(), ref, rtol=0, atol=1e-6)
    assert np.abs(ref - hm).max() > 0.2
    jj.save(str(tmp_path / "j.modmap"))
    tj.save(str(tmp_path / "t.modmap"))
    assert open(tmp_path / "j.modmap", "rb").read() == open(tmp_path / "t.modmap", "rb").read()
    back = JJournal.load(str(tmp_path / "j.modmap")).edits   # float32 deltas
    assert TJournal.load(str(tmp_path / "j.modmap")).edits == back
    assert JJournal.load(str(tmp_path / "t.modmap")).edits == back
    assert back[1][:3] == (20, 11, 6) and len(back) == 5


def _write_hm(tmp_path, shape, seed=7):
    """A smooth 16-bit heightmap: a seeded bumpy field."""
    rg = np.random.default_rng(seed)
    y, x = np.mgrid[0:shape[0], 0:shape[1]] / 6.0
    f = sum(rg.uniform(0.5, 1.0) * np.sin(rg.uniform(0.5, 1.5) * x + rg.uniform(0, 6))
            * np.cos(rg.uniform(0.5, 1.5) * y + rg.uniform(0, 6)) for _ in range(4))
    img = ((f - f.min()) / (f.max() - f.min()) * 60000 + 2000).astype(np.uint16)
    path = str(tmp_path / "hm.png")
    TH.write_png_gray(path, img, bit_depth=16)
    return path


def _check_terrain(ref, out, height_tol):
    for name in TMESH.TerrainState._fields:
        a, b = getattr(ref, name), getattr(out, name).numpy()
        assert a.shape == b.shape, name
        if height_tol and name in ("mesh_height", "zbottom", "ztop", "height_histogram"):
            np.testing.assert_allclose(b, a, rtol=0, atol=height_tol, err_msg=name)
        else:
            np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.mark.parametrize("case", ["plain", "resized", "modmap", "inverted"])
def test_terrain_from_heightmap_matches_jax(tmp_path, case):
    """No erosion: bitwise, on a 32^2 image, a 41x27 one resized to the
    mesh (host bilinear resize), with a brush journal, and inverted."""
    shape = (27, 41) if case == "resized" else (32, 32)
    path = _write_hm(tmp_path, shape)
    jw, tw = JWorld(mesh_x=32, mesh_y=32), TWorld(mesh_x=32, mesh_y=32)
    kw = dict(water_h_off_rel=0.05, mesh_height_scale=2.0)
    modmap = case == "modmap"
    inv = case == "inverted"
    ref = np_tree(JM.terrain_from_heightmap(path, JM.TerrainConfig(**kw), jw,
                                            modmap=_journal(JJournal) if modmap else None,
                                            invert=inv))
    out = TMESH.terrain_from_heightmap(path, TMESH.TerrainConfig(**kw), tw,
                                       modmap=_journal(TJournal) if modmap else None,
                                       invert=inv, device="cpu")
    _check_terrain(ref, out, 0.0)
    assert float(ref.ztop - ref.zbottom) > 0.01


def test_terrain_from_heightmap_erosion_matches_jax(tmp_path):
    """With erosion (300 droplets, erode amount 0.01, a journal): heights
    within 1e-5 of the JAX package's with its angle draws; without the
    angles the port refuses."""
    path = _write_hm(tmp_path, (32, 32), seed=8)
    jw, tw = JWorld(mesh_x=32, mesh_y=32), TWorld(mesh_x=32, mesh_y=32)
    kw = dict(erosion_iters=300, erode_amount=0.01, water_h_off_rel=-0.2)
    ref = np_tree(JM.terrain_from_heightmap(path, JM.TerrainConfig(**kw), jw,
                                            modmap=_journal(JJournal)))
    flat = np_tree(JM.terrain_from_heightmap(path, JM.TerrainConfig(), jw,
                                             modmap=_journal(JJournal)))
    assert np.abs(ref.mesh_height - flat.mesh_height).max() > 1e-3   # it eroded
    ang = torch.as_tensor(jax_angle_tables(300, 1024, 256))
    tcfg = TMESH.TerrainConfig(**kw)
    out = TMESH.terrain_from_heightmap(path, tcfg, tw, modmap=_journal(TJournal),
                                       angles=ang, device="cpu")
    _check_terrain(ref, out, 1e-5)
    with pytest.raises(ValueError, match="angles"):
        TMESH.terrain_from_heightmap(path, tcfg, tw, device="cpu")

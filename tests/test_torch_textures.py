"""Torch port vs JAX package: procedural textures and DXT
(`export/textures`) and the named texture catalog
(`export/texture_catalog`), on the CPU.

Tolerances: the procedural textures and every catalog entry within 1
level of `texture_to_u8` (the float maps round a few ulp apart: XLA's
float32 sines and fused products against PyTorch's, which a u8 level's
boundary turns into one level); the white-noise texture exact (integer
hashing); DXT1/DXT5 encodings and decodings equal array for array (host
numpy in both).  No test reads an asset tree: the catalog modules are
imported with `W3D_ASSET_ROOT=""` and asset directories are `tmp_path`
or ``""``."""

import os

os.environ["W3D_ASSET_ROOT"] = ""

import numpy as np  # noqa: E402
import pytest  # noqa: E402

import w3d  # noqa: F401,E402
from w3d.export import textures as JTX, texture_catalog as JTC  # noqa: E402
from w3d.export import heightmap_io as JHIO  # noqa: E402

from w3d_torch.export import textures as TTX, texture_catalog as TTC  # noqa: E402

from torch_port_util import one_torch_thread  # noqa: F401,E402


def _within_one_level(a, b):
    d = np.abs(np.asarray(a).astype(np.int32) - np.asarray(b).astype(np.int32))
    assert d.max() <= 1, d.max()
    return (d > 0).mean()


@pytest.mark.parametrize("name", ["cloud", "marble", "plasma"])
def test_procedural_textures_match(name):
    jf, tf = getattr(JTX, f"{name}_texture"), getattr(TTX, f"{name}_texture")
    for n, seed in ((64, 5), (48, 0)):
        ref = JTX.texture_to_u8(jf(n, seed=seed))
        out = TTX.texture_to_u8(tf(n, seed=seed, device="cpu"))
        assert out.shape == ref.shape and out.dtype == np.uint8
        assert _within_one_level(out, ref) < 0.01
        assert out.std() > 5


def test_noise_texture_exact():
    np.testing.assert_array_equal(TTX.noise_texture(40, seed=9, device="cpu").numpy(),
                                  np.asarray(JTX.noise_texture(40, seed=9)))


def test_dxt_matches():
    rng = np.random.default_rng(0)
    x, y = np.meshgrid(np.arange(64), np.arange(64))
    smooth = np.stack([x * 4, y * 4, (x + y) * 2], -1).astype(np.uint8)
    noisy = rng.integers(0, 256, (32, 48, 3)).astype(np.uint8)
    flat = np.full((8, 8, 3), 128, np.uint8)
    for img in (smooth, noisy, flat):
        enc, jenc = TTX.dxt1_encode(img), JTX.dxt1_encode(img)
        for a, b in zip(enc, jenc):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(TTX.dxt1_decode(*enc), JTX.dxt1_decode(*jenc))
        alpha = rng.integers(0, 256, img.shape[:2]).astype(np.uint8)
        rgba = np.concatenate([img, alpha[..., None]], -1)
        enc5, jenc5 = TTX.dxt5_encode(rgba), JTX.dxt5_encode(rgba)
        for a, b in zip(enc5, jenc5):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(TTX.dxt5_decode(*enc5), JTX.dxt5_decode(*jenc5))


def test_catalog_matches():
    assert TTC.texture_names() == JTC.texture_names()
    assert TTC.REFERENCE_TEXTURES == JTC.REFERENCE_TEXTURES
    assert TTC.REFERENCE_ASSET_DIR == JTC.REFERENCE_ASSET_DIR == ""
    diff = []
    for name in TTC.texture_names():
        out = TTC.get_texture(name, 32, device="cpu")
        assert out.shape == (32, 32, 3) and out.dtype == np.uint8
        diff.append(_within_one_level(out, JTC.get_texture(name, 32)))
    assert np.mean(diff) < 0.01
    for name in TTC.REFERENCE_TEXTURES:
        assert TTC.resolve_texture_name(name) == JTC.resolve_texture_name(name)
        fam, kw = TTC._auto_entry(name)
        jfam, jkw = JTC._auto_entry(name)
        assert kw == jkw and fam.__name__ == jfam.__name__


def test_reference_textures_and_asset_override(tmp_path):
    """Reference ids resolve to the catalog or a name-hashed palette in
    both packages; an image file in `asset_dir` wins (an exact relative
    path, then the basename with another extension); an unreadable one
    falls back to the procedural texture."""
    names = ["grass.png", "@smoke", "skull.png", "bark/bark1.jpg", "hazard_stripes.jpg"]
    for name in names:
        _within_one_level(TTC.get_reference_texture(name, 16, asset_dir="", device="cpu"),
                          JTC.get_reference_texture(name, 16, asset_dir=""))
    img = (np.arange(8 * 8 * 3).reshape(8, 8, 3) % 251).astype(np.uint8)
    JHIO.write_png_rgb(str(tmp_path / "skull.png"), img)
    (tmp_path / "yuck.png").write_bytes(b"\x89PNG\r\n\x1a\nbroken")
    d = str(tmp_path)
    for name in ("skull.png", "skull.bmp", "yuck.png", "grass.png"):
        np.testing.assert_array_equal(
            TTC.get_reference_texture(name, 16, asset_dir=d, device="cpu"),
            JTC.get_reference_texture(name, 16, asset_dir=d))
    np.testing.assert_array_equal(TTC.get_reference_texture("skull.png", 16, asset_dir=d,
                                                            device="cpu"), img)
    TTC.get_texture.cache_clear()
    JHIO.write_png_rgb(str(tmp_path / "grass.png"), img)
    np.testing.assert_array_equal(TTC.get_texture("grass", 64, asset_dir=d, device="cpu"), img)
    with pytest.raises(KeyError):
        TTC.get_texture("no_such_texture", 16, device="cpu")

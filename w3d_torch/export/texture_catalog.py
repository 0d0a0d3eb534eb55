"""Named texture catalog (port of `3dworld_tpu/export/texture_catalog.py`).

The reference predefines 133 textures (Textures.cpp:30-170
`def_textures`) — mostly image files plus generated ones (plasma,
noise, smoke, sky gradients), looked up by id/name all over the engine
(landscape blending, buildings, trees, water...).

Asset files don't ship with this framework, so every named texture here
is procedural: a handful of parameterized generator families (fbm color
ramps, bricks/checkers/stripes, wood rings, speckle, gradients) cover
the catalog; `get_texture(name)` computes [N, N, 3] u8 on the given
device (the card unless told otherwise) and memoizes.  Divisions by a
constant round through `ops/fmath`, as the JAX package's do.  A
same-named image file on disk (scene asset packs) takes priority via the
PNG/BMP readers in heightmap_io.
"""

from __future__ import annotations

import functools
import os
import struct
import zlib

import numpy as np
import torch

from ..ops import fmath
from ..ops import noise as NZ
from ..utils import assets as _assets

_DEF_SIZE = 128
_div = fmath.div32
# what an unreadable or exotic image file raises (then the texture is
# procedural)
_IMAGE_ERRORS = (OSError, ValueError, IndexError, KeyError, struct.error,
                 zlib.error, ImportError)


def _grid(n, device):
    i = torch.arange(n, dtype=torch.float32, device=device)
    return torch.meshgrid(i, i, indexing="ij")


def _color(c, device):
    return torch.tensor(c, dtype=torch.float32, device=device)


def _fbm(n, scale, octaves, seed, device):
    y, x = _grid(n, device)
    v = NZ.fbm2d(x * (scale / n), y * (scale / n), rx=0.123 * seed,
                 ry=0.371 * seed + 1.7, octaves=octaves, seed=seed)
    lo, hi = v.min(), v.max()
    return (v - lo) / torch.clamp(hi - lo, min=1e-9)


def _ramp(t, c0, c1):
    t = t[..., None]
    return _color(c0, t.device) * (1.0 - t) + _color(c1, t.device) * t


def fbm_ramp(n, c0, c1, scale=6.0, octaves=5, seed=0, device="cuda"):
    """fBm-noise blend between two colors (grass/rock/dirt/sand family)."""
    return _ramp(_fbm(n, scale, octaves, seed, device), c0, c1)


def speckle(n, base, fleck, density=0.15, seed=0, device="cuda"):
    """Granite/asphalt-style speckle: thresholded high-frequency noise."""
    t = _fbm(n, n / 2.0, 2, seed, device)
    m = (t < density).to(torch.float32)
    return _ramp(m, base, fleck)


def bricks(n, mortar, brick, bw=16, bh=8, gap=1, seed=0, device="cuda"):
    """Brick courses with alternating row offset + per-brick tint."""
    y, x = _grid(n, device)
    row = torch.floor(_div(y, bh))
    xs = x + (row % 2) * (bw / 2)
    col = torch.floor(_div(xs, bw))
    in_gap = ((y % bh) < gap) | ((xs % bw) < gap)
    tint = 0.8 + 0.4 * _hash01(col * 131.0 + row * 31.0 + seed)
    c = _color(brick, device) * tint[..., None]
    return torch.where(in_gap[..., None], _color(mortar, device), c)


def _hash01(v):
    s = torch.sin(v * 12.9898) * 43758.5453
    return s - torch.floor(s)


def checker(n, c0, c1, size=16, device="cuda"):
    y, x = _grid(n, device)
    m = ((torch.floor(_div(x, size)) + torch.floor(_div(y, size))) % 2)
    return _ramp(m, c0, c1)


def stripes(n, c0, c1, size=8, horiz=False, device="cuda"):
    y, x = _grid(n, device)
    m = (torch.floor(_div(y if horiz else x, size)) % 2)
    return _ramp(m, c0, c1)


def wood_rings(n, c0, c1, rings=8.0, wobble=0.15, seed=0, device="cuda"):
    """Concentric rings + noise wobble (wood/bark/tree-end family)."""
    y, x = _grid(n, device)
    cx = cy = n / 2.0
    r = _div(fmath.sqrt32((x - cx) ** 2 + (y - cy) ** 2), n)
    w = wobble * _fbm(n, 8.0, 4, seed, device)
    t = 0.5 + 0.5 * torch.sin(2.0 * np.pi * rings * (r + w))
    return _ramp(t, c0, c1)


def vgradient(n, c0, c1, device="cuda"):
    y, _x = _grid(n, device)
    return _ramp(_div(y, n - 1.0), c0, c1)


def marble(n, c0, c1, scale=4.0, seed=0, device="cuda"):
    y, x = _grid(n, device)
    v = NZ.fbm2d(x * (scale / n), y * (scale / n), rx=0.123 * seed,
                 ry=0.371 * seed + 1.7, octaves=5, seed=seed)
    t = 0.5 + 0.5 * torch.sin(2.0 * np.pi * (_div(x, n) + 1.5 * v))
    return _ramp(t, c0, c1)


def windows(n, wall, glass, ww=24, wh=20, fw=8, fh=10, device="cuda"):
    """Building-facade window grid."""
    y, x = _grid(n, device)
    in_w = ((x % ww) < fw) & ((y % wh) < fh)
    return torch.where(in_w[..., None], _color(glass, device), _color(wall, device))


# color shorthands
_G = lambda *c: tuple(v / 255.0 for v in c)

# name -> (family, kwargs); ids follow the reference's texture names
# (Textures.cpp:36-170) with procedural stand-ins
CATALOG = {
    "grass":      (fbm_ramp, dict(c0=_G(40, 100, 30), c1=_G(90, 160, 60), scale=10, seed=11)),
    "ground":     (fbm_ramp, dict(c0=_G(80, 70, 40), c1=_G(130, 110, 70), seed=12)),
    "rock":       (fbm_ramp, dict(c0=_G(90, 88, 85), c1=_G(160, 155, 150), scale=5, seed=13)),
    "rock2":      (fbm_ramp, dict(c0=_G(70, 65, 60), c1=_G(140, 130, 120), scale=8, seed=14)),
    "dirt":       (fbm_ramp, dict(c0=_G(100, 75, 45), c1=_G(140, 110, 70), seed=15)),
    "sand":       (fbm_ramp, dict(c0=_G(194, 178, 128), c1=_G(230, 215, 170), scale=12, seed=16)),
    "snow":       (fbm_ramp, dict(c0=_G(225, 230, 240), c1=_G(255, 255, 255), scale=4, seed=17)),
    "ice":        (marble,   dict(c0=_G(180, 210, 235), c1=_G(235, 245, 255), seed=18)),
    "water":      (marble,   dict(c0=_G(20, 60, 110), c1=_G(60, 120, 180), scale=3, seed=19)),
    "lava":       (marble,   dict(c0=_G(140, 20, 5), c1=_G(255, 160, 20), scale=5, seed=20)),
    "cloud":      (fbm_ramp, dict(c0=_G(255, 255, 255), c1=_G(160, 170, 190), scale=4, octaves=6, seed=21)),
    "sky":        (vgradient, dict(c0=_G(120, 170, 240), c1=_G(30, 80, 180))),
    "smoke":      (fbm_ramp, dict(c0=_G(40, 40, 40), c1=_G(150, 150, 150), scale=5, octaves=6, seed=22)),
    "plasma":     (marble,   dict(c0=_G(200, 30, 180), c1=_G(40, 220, 250), scale=6, seed=23)),
    "noise":      (fbm_ramp, dict(c0=_G(0, 0, 0), c1=_G(255, 255, 255), scale=64, octaves=1, seed=24)),
    "stucco":     (speckle,  dict(base=_G(215, 205, 190), fleck=_G(180, 170, 155), density=0.3, seed=25)),
    "plaster":    (speckle,  dict(base=_G(230, 228, 220), fleck=_G(205, 200, 190), density=0.25, seed=26)),
    "concrete":   (speckle,  dict(base=_G(160, 160, 158), fleck=_G(120, 120, 118), density=0.2, seed=27)),
    "asphalt":    (speckle,  dict(base=_G(60, 60, 62), fleck=_G(110, 110, 112), density=0.1, seed=28)),
    "brick1":     (bricks,   dict(mortar=_G(190, 180, 170), brick=_G(150, 60, 45), seed=29)),
    "brick2":     (bricks,   dict(mortar=_G(180, 175, 165), brick=_G(120, 70, 55), bw=20, bh=10, seed=30)),
    "stone_wall": (bricks,   dict(mortar=_G(140, 135, 125), brick=_G(110, 105, 95), bw=24, bh=12, gap=2, seed=31)),
    "wood":       (wood_rings, dict(c0=_G(120, 80, 40), c1=_G(170, 120, 70), seed=32)),
    "bark":       (fbm_ramp, dict(c0=_G(70, 50, 30), c1=_G(120, 90, 60), scale=16, seed=33)),
    "tree_end":   (wood_rings, dict(c0=_G(140, 100, 60), c1=_G(190, 150, 100), rings=14, seed=34)),
    "panel":      (stripes,  dict(c0=_G(150, 110, 70), c1=_G(130, 95, 60), size=16)),
    "shingle":    (bricks,   dict(mortar=_G(60, 60, 65), brick=_G(90, 90, 100), bw=16, bh=6, seed=35)),
    "metal":      (vgradient, dict(c0=_G(170, 175, 185), c1=_G(120, 125, 135))),
    "rusty":      (fbm_ramp, dict(c0=_G(130, 70, 35), c1=_G(90, 55, 40), scale=7, seed=36)),
    "mossy":      (fbm_ramp, dict(c0=_G(60, 90, 45), c1=_G(110, 110, 80), scale=9, seed=37)),
    "leaves":     (fbm_ramp, dict(c0=_G(25, 80, 25), c1=_G(70, 140, 50), scale=20, seed=38)),
    "coniferous": (fbm_ramp, dict(c0=_G(20, 60, 30), c1=_G(50, 100, 55), scale=24, seed=39)),
    "checker":    (checker,  dict(c0=_G(20, 20, 20), c1=_G(235, 235, 235))),
    "camo":       (fbm_ramp, dict(c0=_G(60, 70, 40), c1=_G(130, 120, 80), scale=4, octaves=3, seed=40)),
    "window":     (windows,  dict(wall=_G(180, 175, 165), glass=_G(90, 130, 170))),
    "office_win": (windows,  dict(wall=_G(110, 115, 125), glass=_G(60, 90, 130), ww=20, wh=16, fw=12, fh=10)),
    "moon":       (speckle,  dict(base=_G(180, 180, 178), fleck=_G(120, 120, 118), density=0.12, seed=41)),
    "earth":      (fbm_ramp, dict(c0=_G(20, 60, 140), c1=_G(60, 130, 60), scale=3, octaves=6, seed=42)),
    "mars":       (fbm_ramp, dict(c0=_G(150, 75, 40), c1=_G(200, 120, 70), scale=5, seed=43)),
    "gravel":     (speckle,  dict(base=_G(120, 115, 110), fleck=_G(90, 85, 80), density=0.4, seed=44)),
    "carpet":     (speckle,  dict(base=_G(120, 50, 50), fleck=_G(100, 40, 40), density=0.5, seed=45)),
    "tile":       (checker,  dict(c0=_G(220, 220, 215), c1=_G(190, 195, 200), size=12)),
    "marble":     (marble,   dict(c0=_G(225, 222, 215), c1=_G(150, 145, 150), seed=46)),
}


def _to_u8(img: torch.Tensor) -> np.ndarray:
    return torch.clamp(img * 255.0, 0, 255).to(torch.uint8).cpu().numpy()


@functools.lru_cache(maxsize=None)
def get_texture(name: str, n: int = _DEF_SIZE,
                asset_dir: str | None = None, device="cuda") -> np.ndarray:
    """Named texture as [n, n, 3] uint8, generated on `device`.  A
    `<asset_dir>/<name>.png` or .bmp file overrides the procedural
    generator (the reference's type-0 file textures)."""
    if asset_dir:
        for ext, reader in (("png", "read_png"), ("bmp", "read_bmp_rgb")):
            p = os.path.join(asset_dir, f"{name}.{ext}")
            if os.path.exists(p):
                from . import heightmap_io as HIO
                img = getattr(HIO, reader)(p)
                return np.asarray(img)[..., :3]
    if name not in CATALOG:
        raise KeyError(f"unknown texture '{name}' "
                       f"({len(CATALOG)} in catalog)")
    fam, kw = CATALOG[name]
    return _to_u8(fam(n, **kw, device=device))


def texture_names():
    return sorted(CATALOG)


# ---------------------------------------------------------------------------
# full reference texture id coverage (Textures.cpp:36-170): every name in
# the reference's texture table resolves here — to a bespoke catalog
# entry where one exists, otherwise to a name-hashed procedural palette
# ---------------------------------------------------------------------------

REFERENCE_TEXTURES = (
    "grass.png rock.png water.jpg stucco.jpg sky.jpg brick1.jpg moon.jpg "
    "earth.png marble.jpg snow2.jpg leaves/green_maple_leaf.jpg bark2.jpg "
    "desert_sand.jpg rock2.png camoflage.jpg hedges.jpg brick1.bmp "
    "manhole.jpg leaves/palm_frond_diff.jpg @smoke @plasma @gen "
    "@landscape_tex @tree_end @tree_hemi shingles.jpg paneling.png "
    "cblock.png mj_leaf.jpg leaves/oak_leaf.png leaves/cherry_leaf.png "
    "leaves/birch_leaf.png plant1.jpg plant2.png plant3.png "
    "leaves/leaf_d.jpg fence.jpg skull.png radiation.png yuck.png "
    "sawblade.png sawblade_b.png blur.png blur_s.png pine2.jpg noise.png "
    "wood.jpg hb_brick.png particleb.png plaster.png tile.png "
    "CommandCAD.png @disint @blur_inv @hstripe @vstripe bcube.jpg "
    "atlas/explosion.png shiphull.jpg bcube2.jpg bcube_tactical.jpg "
    "rock_sphere.png papaya_leaf.png coffee_leaf.png smiley_skull.png "
    "ice.2.jpg rock.03.png black.png white.png atlas/fire.png "
    "snowflake.png @blur_center @gradient grass_blade.png @wind_texture "
    "mossy_rock.jpg bark/bark1.jpg bark/bark2.jpg bark/bark2-normal.jpg "
    "bark/bark_lendrick.jpg bark/bark_lylejk.png "
    "normal_maps/water_normal.tga normal_maps/ocean_water_normal.png "
    "caustics.jpg perlin_simplex.png @noise_gen @noise_gen_mipmap "
    "@noise_gen_sparse @player_bbb_tex pine_tree_leaves2.jpg flare1.jpg "
    "flare2.jpg Flare3.jpg flare4.jpg flare5b.jpg foam1.jpg "
    "bullet_hole/bullet_diffuse.jpg bullet_hole/bullet_alpha.jpg "
    "bullet_hole/bullet_normal.jpg normal_maps/sand_normal.jpg "
    "raindrop_dots.jpg spaceship1.jpg spaceship2.jpg atlas/blood.png "
    "lichen.jpg bark/palm_bark.jpg daisy.jpg lava.jpg smoke_puff.jpg "
    "bark/bark_birch.jpg bark/bark6.jpg ripple_map.png starburst.png "
    "normal_maps/rocks1.jpg normal_maps/rocks2.jpg normal_maps/rocks3.jpg "
    "normal_maps/dirt_normal.jpg cyan.png red.png hazard_stripes.jpg "
    "@windows @twindows keycard.png"
).split()

# recognizable reference names -> bespoke catalog entries
_ALIAS = {
    "grass.png": "grass", "rock.png": "rock", "rock2.png": "rock2",
    "rock.03.png": "rock2", "rock_sphere.png": "rock",
    "water.jpg": "water", "stucco.jpg": "stucco", "sky.jpg": "sky",
    "brick1.jpg": "brick1", "brick1.bmp": "brick1", "hb_brick.png": "brick2",
    "cblock.png": "stone_wall", "moon.jpg": "moon", "earth.png": "earth",
    "marble.jpg": "marble", "snow2.jpg": "snow", "bark2.jpg": "bark",
    "bark/bark1.jpg": "bark", "bark/bark2.jpg": "bark",
    "bark/bark_lendrick.jpg": "bark", "bark/bark_lylejk.png": "bark",
    "bark/bark_birch.jpg": "bark", "bark/bark6.jpg": "bark",
    "bark/palm_bark.jpg": "bark", "desert_sand.jpg": "sand",
    "camoflage.jpg": "camo", "hedges.jpg": "coniferous",
    "shingles.jpg": "shingle", "paneling.png": "panel",
    "plaster.png": "plaster", "tile.png": "tile", "wood.jpg": "wood",
    "noise.png": "noise", "@smoke": "smoke", "@plasma": "plasma",
    "@tree_end": "tree_end", "@windows": "window",
    "@twindows": "office_win", "@hstripe": "checker",
    "@vstripe": "checker", "@gradient": "sky", "lava.jpg": "lava",
    "mossy_rock.jpg": "mossy", "ice.2.jpg": "ice",
    "leaves/green_maple_leaf.jpg": "leaves", "mj_leaf.jpg": "leaves",
    "leaves/oak_leaf.png": "leaves", "leaves/cherry_leaf.png": "leaves",
    "leaves/birch_leaf.png": "leaves", "leaves/leaf_d.jpg": "leaves",
    "leaves/palm_frond_diff.jpg": "coniferous", "pine2.jpg": "coniferous",
    "pine_tree_leaves2.jpg": "coniferous", "grass_blade.png": "grass",
    "perlin_simplex.png": "noise", "@noise_gen": "noise",
    "@noise_gen_mipmap": "noise", "@noise_gen_sparse": "noise",
    "@landscape_tex": "ground", "asphalt": "asphalt",
}


def _auto_entry(name: str):
    """Name-hashed procedural palette for reference textures without a
    bespoke entry (deterministic per name)."""
    h = 2166136261
    for ch in name:
        h = ((h ^ ord(ch)) * 16777619) & 0xFFFFFFFF
    c0 = ((h & 0xFF) / 320 + 0.15, ((h >> 8) & 0xFF) / 320 + 0.15,
          ((h >> 16) & 0xFF) / 320 + 0.15)
    c1 = tuple(min(c + 0.3, 1.0) for c in c0)
    return (fbm_ramp, dict(c0=c0, c1=c1, scale=4 + (h >> 24) % 12,
                           seed=h % 1000))


def resolve_texture_name(name: str) -> str | None:
    """Reference file/id name -> catalog key (None if auto-generated)."""
    if name in CATALOG:
        return name
    return _ALIAS.get(name)


# the asset tree (W3D_ASSET_ROOT, default: the reference checkout when
# present) ships real texture images; when available it is the default
# asset source (Textures.cpp type-0 file textures)
REFERENCE_ASSET_DIR = _assets.asset_path("textures") or ""


def _find_asset(name: str, asset_dir: str) -> str | None:
    """Exact relative path first (incl. subdirectories like
    bark/bark1.jpg), then basename with common extensions."""
    if not asset_dir or name.startswith("@"):
        return None
    p = os.path.join(asset_dir, name)
    if os.path.exists(p):
        return p
    base = os.path.splitext(os.path.basename(name))[0]
    for ext in ("png", "bmp", "jpg", "jpeg", "tga"):
        p = os.path.join(asset_dir, f"{base}.{ext}")
        if os.path.exists(p):
            return p
    return None


@functools.lru_cache(maxsize=None)
def get_reference_texture(name: str, n: int = _DEF_SIZE,
                          asset_dir: str | None = None,
                          device="cuda") -> np.ndarray:
    """Any reference texture name (Textures.cpp table, incl. '@'
    procedural ids and subdirectory files) -> [H, W, 3] uint8.

    Resolution order matches the reference: the REAL shipped image file
    (from `asset_dir`, defaulting to the reference's own textures/ tree
    when present) wins; '@' generated ids and missing files fall to the
    bespoke procedural entries; name-hashed palettes cover the rest, so
    every reference texture id resolves."""
    if asset_dir is None and REFERENCE_ASSET_DIR \
            and os.path.isdir(REFERENCE_ASSET_DIR):
        asset_dir = REFERENCE_ASSET_DIR
    if asset_dir:
        p = _find_asset(name, asset_dir)
        if p is not None:
            from . import heightmap_io as HIO
            try:
                return HIO.read_image_rgb(p)[..., :3]
            except _IMAGE_ERRORS:
                pass        # unreadable/exotic format -> procedural
    key = resolve_texture_name(name)
    if key is not None:
        return get_texture(key, n, device=device)
    fam, kw = _auto_entry(name)
    return _to_u8(fam(n, **kw, device=device))

"""Procedural textures: clouds / marble / plasma / noise (port of
`3dworld_tpu/export/textures.py`).

The reference generates several built-in textures procedurally via
fractal noise (`gen_*_texture` in Textures.cpp: cloud, marble, plasma
fractal, smoke) among its ~300 named textures.  Here each generator is
tensor code on the given device returning [H, W] (or [3, H, W]) float
maps ready for image export or lookup tables; the DXT block codecs are
host numpy, copied, so their bytes are the JAX package's.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import fmath
from ..ops import noise as N


def _grid(n: int, scale: float, device):
    xi = torch.arange(n, dtype=torch.float32, device=device)[None, :] * scale
    yi = torch.arange(n, dtype=torch.float32, device=device)[:, None] * scale
    return torch.broadcast_to(xi, (n, n)), torch.broadcast_to(yi, (n, n))


def cloud_texture(n: int = 256, octaves: int = 6, seed: int = 0,
                  device="cuda") -> torch.Tensor:
    """Soft fBm cloud alpha map in [0, 1]."""
    x, y = _grid(n, 0.03, device)
    v = N.fbm2d(x, y, 1.1, 1.9, octaves=octaves, seed=seed)
    return torch.clamp(0.5 + 0.45 * v, 0.0, 1.0) ** 2


def marble_texture(n: int = 256, octaves: int = 5, seed: int = 1,
                   device="cuda") -> torch.Tensor:
    """Marble: sine bands warped by turbulence."""
    x, y = _grid(n, 0.04, device)
    turb = N.fbm2d(x, y, 1.7, 2.3, octaves=octaves, seed=seed)
    bands = torch.sin(0.35 * fmath.div32(x, 0.04) * 0.04 * 8.0 + 4.0 * turb)
    return 0.5 + 0.5 * bands


def plasma_texture(n: int = 256, octaves: int = 7, seed: int = 2,
                   device="cuda") -> torch.Tensor:
    """Plasma fractal: high-octave ridged fBm, colorized -> [3, n, n]."""
    x, y = _grid(n, 0.05, device)
    v = N.fbm2d(x, y, 1.3, 2.7, octaves=octaves, shape=N.SHAPE_RIDGED, seed=seed)
    t = torch.clamp(0.5 + 0.35 * v, 0.0, 1.0)
    r = torch.clamp(1.6 * t, 0.0, 1.0)
    g = torch.clamp(1.6 * t - 0.4, 0.0, 1.0)
    b = torch.clamp(1.6 * t - 0.9, 0.0, 1.0)
    return torch.stack([r, g, b])


def noise_texture(n: int = 256, seed: int = 3, device="cuda") -> torch.Tensor:
    """White-noise texture from the hash stream (gen_noise_texture)."""
    from ..utils import rng as w3d_rng
    idx = torch.arange(n * n, dtype=torch.int64, device=device)
    h = w3d_rng.xxhash_u32(idx, seed=seed)
    return ((h >> 8).to(torch.float32) / (1 << 24)).reshape(n, n)


def texture_to_u8(tex) -> np.ndarray:
    """A float texture (tensor on any device, or array) -> uint8 levels."""
    t = tex.detach().cpu().numpy() if isinstance(tex, torch.Tensor) else np.asarray(tex)
    return np.clip(t * 255.0, 0, 255).astype(np.uint8)


# ---------------------------------------------------------------------------
# DXT (S3TC) block compression — texture_utils.cpp's DXT1/DXT5 path
# ---------------------------------------------------------------------------
#
# The reference compresses textures to DXT for upload
# (texture_utils.cpp, 269 LoC; GL does the encode in some paths).  Here
# both encode and decode are fully vectorized array programs: all 4x4
# blocks at once — [NB, 16, 3] color tiles, endpoint selection by
# projection onto the per-block color axis, RGB565 quantization, 2-bit
# (DXT1) / 3-bit alpha (DXT5) index assignment by nearest palette entry.


def _to_blocks(img: np.ndarray):
    h, w = img.shape[:2]
    assert h % 4 == 0 and w % 4 == 0, "DXT needs 4-aligned dims"
    c = img.reshape(h // 4, 4, w // 4, 4, -1).swapaxes(1, 2)
    return c.reshape(-1, 16, img.shape[2] if img.ndim == 3 else 1), h, w


def _from_blocks(blocks: np.ndarray, h: int, w: int):
    c = blocks.reshape(h // 4, w // 4, 4, 4, -1).swapaxes(1, 2)
    return c.reshape(h, w, -1)


def _quant565(c):
    r = (c[..., 0].astype(np.uint16) >> 3).astype(np.uint16)
    g = (c[..., 1].astype(np.uint16) >> 2).astype(np.uint16)
    b = (c[..., 2].astype(np.uint16) >> 3).astype(np.uint16)
    packed = (r << 11) | (g << 5) | b
    back = np.stack([(r << 3) | (r >> 2), (g << 2) | (g >> 4),
                     (b << 3) | (b >> 2)], -1).astype(np.uint8)
    return packed, back


def dxt1_encode(rgb: np.ndarray):
    """[H,W,3] uint8 -> (c0 [NB] u16, c1 [NB] u16, idx [NB,16] u8).
    Opaque 4-color mode (c0 > c1 enforced by endpoint ordering)."""
    blocks, h, w = _to_blocks(rgb.astype(np.uint8))
    f = blocks.astype(np.float32)                       # [NB,16,3]
    lo = f.min(1)
    hi = f.max(1)
    axis = hi - lo
    al = np.maximum(np.linalg.norm(axis, axis=-1, keepdims=True), 1e-6)
    t = np.einsum("bkc,bc->bk", f - lo[:, None], axis / al)  # projection
    p_lo = lo + axis * 0.0
    p_hi = hi
    c0p, c0b = _quant565(p_hi)              # c0 = max endpoint
    c1p, c1b = _quant565(p_lo)
    # enforce c0 > c1 (equal would select the 3-color+transparent mode)
    swap = c0p <= c1p
    c0p2 = np.where(swap, c1p, c0p)
    c1p2 = np.where(swap, c0p, c1p)
    c0b2 = np.where(swap[:, None], c1b, c0b)
    c1b2 = np.where(swap[:, None], c0b, c1b)
    pal = np.stack([c0b2, c1b2,
                    ((2 * c0b2.astype(np.uint16) + c1b2) // 3).astype(np.uint8),
                    ((c0b2.astype(np.uint16) + 2 * c1b2) // 3).astype(np.uint8)],
                   1).astype(np.float32)                # [NB,4,3]
    d = ((f[:, :, None, :] - pal[:, None, :, :]) ** 2).sum(-1)  # [NB,16,4]
    idx = d.argmin(-1).astype(np.uint8)
    return c0p2, c1p2, idx, h, w


def dxt1_decode(c0p, c1p, idx, h, w):
    def unpack(p):
        r = ((p >> 11) & 0x1F).astype(np.uint16)
        g = ((p >> 5) & 0x3F).astype(np.uint16)
        b = (p & 0x1F).astype(np.uint16)
        return np.stack([(r << 3) | (r >> 2), (g << 2) | (g >> 4),
                         (b << 3) | (b >> 2)], -1).astype(np.uint8)
    c0b = unpack(c0p)
    c1b = unpack(c1p)
    pal = np.stack([c0b, c1b,
                    ((2 * c0b.astype(np.uint16) + c1b) // 3).astype(np.uint8),
                    ((c0b.astype(np.uint16) + 2 * c1b) // 3).astype(np.uint8)],
                   1)                                    # [NB,4,3]
    out = np.take_along_axis(pal, idx[:, :, None].astype(np.int64), 1)
    return _from_blocks(out, h, w)[..., :3]


def dxt5_alpha_encode(a: np.ndarray):
    """[H,W] uint8 alpha -> (a0, a1 [NB] u8, idx [NB,16] u8) — the BC3
    8-interpolant alpha block (a0 > a1 mode)."""
    blocks, h, w = _to_blocks(a[..., None].astype(np.uint8))
    blocks = blocks[..., 0].astype(np.float32)
    a0 = blocks.max(1)
    a1 = blocks.min(1)
    ramp = np.stack([a0, a1] + [((6 - i) * a0 + (i + 1) * a1) / 7.0
                                for i in range(6)], 1)   # [NB,8]
    d = np.abs(blocks[:, :, None] - ramp[:, None, :])
    idx = d.argmin(-1).astype(np.uint8)
    return a0.astype(np.uint8), a1.astype(np.uint8), idx, h, w


def dxt5_alpha_decode(a0, a1, idx, h, w):
    a0f = a0.astype(np.float32)
    a1f = a1.astype(np.float32)
    ramp = np.stack([a0f, a1f] + [((6 - i) * a0f + (i + 1) * a1f) / 7.0
                                  for i in range(6)], 1)
    out = np.take_along_axis(ramp, idx.astype(np.int64), 1)
    return _from_blocks(np.rint(out)[..., None].astype(np.uint8),
                        h, w)[..., 0]


def dxt5_encode(rgba: np.ndarray):
    """[H,W,4] uint8 -> (alpha block fields + DXT1 color fields)."""
    a0, a1, aidx, h, w = dxt5_alpha_encode(rgba[..., 3])
    c0, c1, cidx, _, _ = dxt1_encode(rgba[..., :3])
    return (a0, a1, aidx, c0, c1, cidx, h, w)


def dxt5_decode(a0, a1, aidx, c0, c1, cidx, h, w):
    rgb = dxt1_decode(c0, c1, cidx, h, w)
    a = dxt5_alpha_decode(a0, a1, aidx, h, w)
    return np.concatenate([rgb, a[..., None]], -1)

"""Heightmap image I/O: 8/16-bit grayscale PNG + 8-bit BMP, stdlib-only
(port of `3dworld_tpu/export/heightmap_io.py`; pure numpy).

The reference reads heightmaps from PNG/BMP/TIFF/JPEG/DDS images at 8 or
16 bits (`read_mesh_height_image` mesh_gen.cpp:135, image_io.cpp) and
writes PNG heightmaps (heightmap.cpp:375).  Height scaling follows
`scale_mh_texture_val` (mesh_gen.cpp:121-127):
    height = READ_MESH_H_SCALE * mesh_height_scale * mesh_file_scale * v
             + mesh_file_tz,  with READ_MESH_H_SCALE = 0.0008
(v the 0-255-range pixel value; 16-bit pixels are v/256).

PNG here is a minimal, dependency-free codec (zlib + struct) supporting
grayscale 8/16-bit — the formats the heightmap path uses.  JPEG, TGA,
TIFF and DDS go through Pillow, imported only when such a file is read.
Malformed or unsupported files raise ValueError.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

READ_MESH_H_SCALE = 0.0008  # mesh_gen.cpp:22


# ---------------------------------------------------------------------------
# PNG
# ---------------------------------------------------------------------------

def _png_chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def write_png_gray(path: str, img: np.ndarray, bit_depth: int = 16) -> None:
    """Write [h, w] uint8/uint16 grayscale PNG."""
    img = np.asarray(img)
    h, w = img.shape
    if bit_depth == 16:
        img = img.astype(">u2")
        raw = b"".join(b"\x00" + img[r].tobytes() for r in range(h))
    else:
        img = img.astype(np.uint8)
        raw = b"".join(b"\x00" + img[r].tobytes() for r in range(h))
    ihdr = struct.pack(">IIBBBBB", w, h, bit_depth, 0, 0, 0, 0)  # grayscale
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(_png_chunk(b"IHDR", ihdr))
        f.write(_png_chunk(b"IDAT", zlib.compress(raw, 6)))
        f.write(_png_chunk(b"IEND", b""))


def _unfilter(raw: bytes, h: int, stride: int, bpp: int) -> bytes:
    """Reverse PNG scanline filters (types 0-4) for bpp-byte pixels."""
    out = bytearray()
    prev = bytearray(stride)
    pos = 0
    for _ in range(h):
        ftype = raw[pos]
        line = bytearray(raw[pos + 1:pos + 1 + stride])
        pos += 1 + stride
        if ftype == 1:  # Sub
            for i in range(bpp, stride):
                line[i] = (line[i] + line[i - bpp]) & 0xFF
        elif ftype == 2:  # Up
            for i in range(stride):
                line[i] = (line[i] + prev[i]) & 0xFF
        elif ftype == 3:  # Average
            for i in range(stride):
                a = line[i - bpp] if i >= bpp else 0
                line[i] = (line[i] + ((a + prev[i]) >> 1)) & 0xFF
        elif ftype == 4:  # Paeth
            for i in range(stride):
                a = line[i - bpp] if i >= bpp else 0
                b = prev[i]
                c = prev[i - bpp] if i >= bpp else 0
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pr = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
                line[i] = (line[i] + pr) & 0xFF
        out += line
        prev = line
    return bytes(out)


def read_png_gray(path: str) -> np.ndarray:
    """Read a grayscale 8/16-bit PNG -> uint8/uint16 [h, w]."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError("not a PNG")
    pos = 8
    idat = b""
    w = h = depth = ctype = None
    while pos < len(data):
        (ln,) = struct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        chunk = data[pos + 8:pos + 8 + ln]
        pos += 12 + ln
        if tag == b"IHDR":
            w, h, depth, ctype = struct.unpack(">IIBB", chunk[:10])
        elif tag == b"IDAT":
            idat += chunk
        elif tag == b"IEND":
            break
    if ctype != 0:
        raise ValueError(f"only grayscale PNGs supported (color type {ctype})")
    raw = zlib.decompress(idat)
    bpp = 2 if depth == 16 else 1
    stride = w * bpp
    flat = _unfilter(raw, h, stride, bpp)
    dt = ">u2" if depth == 16 else np.uint8
    return np.frombuffer(flat, dtype=dt).reshape(h, w).astype(
        np.uint16 if depth == 16 else np.uint8)


# ---------------------------------------------------------------------------
# BMP (8-bit grayscale, palette)
# ---------------------------------------------------------------------------

def write_bmp_gray(path: str, img: np.ndarray) -> None:
    img = np.asarray(img, np.uint8)
    h, w = img.shape
    row = (w + 3) & ~3
    palette = b"".join(bytes((i, i, i, 0)) for i in range(256))
    pixel_off = 14 + 40 + 1024
    size = pixel_off + row * h
    hdr = struct.pack("<2sIHHI", b"BM", size, 0, 0, pixel_off)
    dib = struct.pack("<IiiHHIIiiII", 40, w, h, 1, 8, 0, row * h, 2835, 2835, 256, 0)
    with open(path, "wb") as f:
        f.write(hdr + dib + palette)
        pad = b"\x00" * (row - w)
        for r in range(h - 1, -1, -1):  # bottom-up
            f.write(img[r].tobytes() + pad)


def read_bmp_gray(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        data = f.read()
    if data[:2] != b"BM":
        raise ValueError("not a BMP")
    pixel_off = struct.unpack("<I", data[10:14])[0]
    w, h = struct.unpack("<ii", data[18:26])
    bpp = struct.unpack("<H", data[28:30])[0]
    if bpp != 8:
        raise ValueError(f"only 8-bit BMPs supported ({bpp})")
    row = (w + 3) & ~3
    img = np.zeros((abs(h), w), np.uint8)
    for r in range(abs(h)):
        src = pixel_off + r * row
        dst = (abs(h) - 1 - r) if h > 0 else r
        img[dst] = np.frombuffer(data[src:src + w], np.uint8)
    return img


# ---------------------------------------------------------------------------
# height scaling (terrain_hmap_manager_t semantics)
# ---------------------------------------------------------------------------

def pixels_to_heights(img: np.ndarray, mesh_height_scale: float = 1.0,
                      mesh_file_scale: float = 1.0, mesh_file_tz: float = 0.0,
                      mesh_scale_z_inv: float = 1.0, invert: bool = False) -> np.ndarray:
    """scale_mh_texture_val (mesh_gen.cpp:121): pixel -> world height."""
    v = img.astype(np.float32)
    if img.dtype == np.uint16:
        v = v / 256.0  # 16-bit images use the same 0-255 scale at 1/256 steps
    if invert:
        v = 255.0 - v
    return ((READ_MESH_H_SCALE * mesh_height_scale * mesh_file_scale) * v
            + mesh_file_tz) * mesh_scale_z_inv


def heights_to_pixels(heights: np.ndarray, bit_depth: int = 16,
                      mesh_height_scale: float = 1.0, mesh_file_scale: float = 1.0,
                      mesh_file_tz: float = 0.0, mesh_scale_z: float = 1.0) -> np.ndarray:
    """unscale_mh_texture_val (mesh_gen.cpp:122): world height -> pixel."""
    v = (np.asarray(heights, np.float32) * mesh_scale_z - mesh_file_tz) / (
        READ_MESH_H_SCALE * mesh_height_scale * mesh_file_scale)
    if bit_depth == 16:
        return np.clip(v * 256.0, 0, 65535).astype(np.uint16)
    return np.clip(v, 0, 255).astype(np.uint8)


_PIL_EXTS = (".jpg", ".jpeg", ".tga", ".tif", ".tiff", ".dds")


def read_image_gray(path: str) -> np.ndarray:
    """Grayscale pixels from any supported format: PNG/BMP through the
    native stdlib codecs, JPEG/TIFF/TGA/DDS through Pillow (the reference
    reads these through its image libraries too, image_io.cpp:12-21)."""
    lo = path.lower()
    if lo.endswith(".bmp"):
        return read_bmp_gray(path)
    if lo.endswith(_PIL_EXTS):
        from PIL import Image
        img = Image.open(path)
        if img.mode in ("I;16", "I;16L", "I;16B", "I"):
            return np.asarray(img.convert("I"), np.uint16)
        return np.asarray(img.convert("L"), np.uint8)
    return read_png_gray(path)


def read_image_rgb(path: str) -> np.ndarray:
    """[h, w, 3] uint8 from PNG/BMP (native) or JPEG/TIFF/TGA/DDS (PIL)."""
    lo = path.lower()
    if lo.endswith(".bmp"):
        return read_bmp_rgb(path)
    if lo.endswith(_PIL_EXTS):
        from PIL import Image
        return np.asarray(Image.open(path).convert("RGB"), np.uint8)
    return read_png(path)[..., :3]


def read_heightmap(path: str, **scale_kw) -> np.ndarray:
    return pixels_to_heights(read_image_gray(path), **scale_kw)


def write_heightmap(path: str, heights: np.ndarray, bit_depth: int = 16,
                    **scale_kw) -> None:
    px = heights_to_pixels(heights, bit_depth=bit_depth, **scale_kw)
    if path.lower().endswith(".bmp"):
        write_bmp_gray(path, px.astype(np.uint8))
    else:
        write_png_gray(path, px, bit_depth=bit_depth)


# ---------------------------------------------------------------------------
# color images (RGB/RGBA PNG + 24-bit BMP) — the reference reads/writes
# color textures through its image libraries (image_io.cpp); these cover
# the same formats with stdlib codecs
# ---------------------------------------------------------------------------

def write_png_rgb(path: str, img: np.ndarray) -> None:
    """Write [h, w, 3|4] uint8 RGB(A) PNG."""
    img = np.asarray(img, np.uint8)
    h, w, ch = img.shape
    if ch not in (3, 4):
        raise ValueError("RGB or RGBA")
    ctype = 2 if ch == 3 else 6
    raw = b"".join(b"\x00" + img[r].tobytes() for r in range(h))
    ihdr = struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(_png_chunk(b"IHDR", ihdr))
        f.write(_png_chunk(b"IDAT", zlib.compress(raw, 6)))
        f.write(_png_chunk(b"IEND", b""))


def read_png(path: str) -> np.ndarray:
    """Read any 8-bit PNG (gray/RGB/RGBA/gray+alpha, non-interlaced) ->
    [h, w] or [h, w, ch] uint8; 16-bit grayscale -> uint16 [h, w]."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError("not a PNG")
    pos = 8
    idat = b""
    w = h = depth = ctype = interlace = None
    while pos < len(data):
        (ln,) = struct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        chunk = data[pos + 8:pos + 8 + ln]
        pos += 12 + ln
        if tag == b"IHDR":
            w, h, depth, ctype, _c, _f, interlace = struct.unpack(
                ">IIBBBBB", chunk[:13])
        elif tag == b"IDAT":
            idat += chunk
        elif tag == b"IEND":
            break
    if interlace != 0:
        raise ValueError("interlaced PNGs not supported")
    nch = {0: 1, 2: 3, 4: 2, 6: 4}[ctype]
    if not (depth in (8, 16) and (depth == 8 or ctype == 0)):
        raise ValueError(f"unsupported depth/color combo ({depth}, {ctype})")
    bpp = nch * (depth // 8)
    stride = w * bpp
    flat = _unfilter(zlib.decompress(idat), h, stride, bpp)
    if depth == 16:
        return np.frombuffer(flat, dtype=">u2").reshape(h, w).astype(np.uint16)
    a = np.frombuffer(flat, dtype=np.uint8).reshape(h, w, nch)
    return a[:, :, 0] if nch == 1 else a


def write_bmp_rgb(path: str, img: np.ndarray) -> None:
    """Write [h, w, 3] uint8 as 24-bit BMP (BGR bottom-up rows)."""
    img = np.asarray(img, np.uint8)
    h, w, ch = img.shape
    if ch != 3:
        raise ValueError("RGB")
    row = (3 * w + 3) & ~3
    pixel_off = 14 + 40
    size = pixel_off + row * h
    hdr = struct.pack("<2sIHHI", b"BM", size, 0, 0, pixel_off)
    dib = struct.pack("<IiiHHIIiiII", 40, w, h, 1, 24, 0, row * h,
                      2835, 2835, 0, 0)
    with open(path, "wb") as f:
        f.write(hdr + dib)
        pad = b"\x00" * (row - 3 * w)
        for r in range(h - 1, -1, -1):
            f.write(img[r, :, ::-1].tobytes() + pad)


def read_bmp_rgb(path: str) -> np.ndarray:
    """Read a 24-bit BMP -> [h, w, 3] uint8 RGB."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:2] != b"BM":
        raise ValueError("not a BMP")
    pixel_off = struct.unpack("<I", data[10:14])[0]
    w, h = struct.unpack("<ii", data[18:26])
    bits = struct.unpack("<H", data[28:30])[0]
    if bits != 24:
        raise ValueError(f"only 24-bit color BMPs here (got {bits})")
    row = (3 * w + 3) & ~3
    out = np.zeros((abs(h), w, 3), np.uint8)
    for r in range(abs(h)):
        off = pixel_off + r * row
        line = np.frombuffer(data[off:off + 3 * w], np.uint8).reshape(w, 3)
        dst = (abs(h) - 1 - r) if h > 0 else r
        out[dst] = line[:, ::-1]
    return out

"""3DS model loader (port of `3dworld_tpu/scene/read_3ds.py`; pure host
code, copied).

The reference reads 3D Studio .3ds files with a hand-written chunk parser
(read_3ds.cpp:570).  The .3ds format is a public chunked binary format:
each chunk = u16 id + u32 length; we walk MAIN(0x4D4D) -> 3D_EDITOR
(0x3D3D) -> OBJECT(0x4000) -> MESH(0x4100) and read vertex (0x4110),
face (0x4120) and UV (0x4140) lists, merging all objects into one
`Model3d`.
"""

from __future__ import annotations

import struct

import numpy as np

from .model3d import Model3d

_MAIN = 0x4D4D
_EDITOR = 0x3D3D
_OBJECT = 0x4000
_MESH = 0x4100
_VERTS = 0x4110
_FACES = 0x4120
_UVS = 0x4140


def load_3ds(path: str) -> Model3d:
    with open(path, "rb") as f:
        data = f.read()
    pos_all, uv_all, face_all = [], [], []
    vert_base = 0

    def walk(start: int, end: int, depth: int):
        nonlocal vert_base
        p = start
        cur_verts = 0
        while p + 6 <= end:
            cid, clen = struct.unpack_from("<HI", data, p)
            if clen < 6 or p + clen > end:
                break
            body = p + 6
            if cid in (_MAIN, _EDITOR, _MESH):
                walk(body, p + clen, depth + 1)
            elif cid == _OBJECT:
                # skip the asciiz object name
                q = body
                while q < p + clen and data[q] != 0:
                    q += 1
                walk(q + 1, p + clen, depth + 1)
            elif cid == _VERTS:
                (n,) = struct.unpack_from("<H", data, body)
                v = np.frombuffer(data, "<f4", n * 3, body + 2).reshape(n, 3)
                vert_base = sum(len(a) for a in pos_all)
                cur_verts = n
                pos_all.append(v.copy())
            elif cid == _UVS:
                (n,) = struct.unpack_from("<H", data, body)
                uv_all.append(np.frombuffer(data, "<f4", n * 2, body + 2)
                              .reshape(n, 2).copy())
            elif cid == _FACES:
                (n,) = struct.unpack_from("<H", data, body)
                fd = np.frombuffer(data, "<u2", n * 4, body + 2).reshape(n, 4)
                face_all.append(fd[:, :3].astype(np.int32) + vert_base)
            p += clen

    walk(0, len(data), 0)
    pos = np.concatenate(pos_all) if pos_all else np.zeros((0, 3), np.float32)
    uvs = np.concatenate(uv_all) if uv_all else np.zeros((0, 2), np.float32)
    faces = np.concatenate(face_all) if face_all else np.zeros((0, 3), np.int32)
    fuv = faces if len(uvs) >= len(pos) and len(faces) else \
        -np.ones_like(faces)
    return Model3d(positions=pos.astype(np.float32), normals=np.zeros((0, 3), np.float32),
                   uvs=uvs.astype(np.float32), faces=faces,
                   face_normals=-np.ones_like(faces), face_uvs=fuv)


def write_3ds(path: str, model: Model3d) -> None:
    """Minimal 3DS writer (one mesh object) — used for cache/testing."""
    v = model.positions.astype("<f4")
    f = model.faces.astype("<u2")
    verts = struct.pack("<H", len(v)) + v.tobytes()
    faces4 = np.zeros((len(f), 4), "<u2")
    faces4[:, :3] = f
    faces = struct.pack("<H", len(f)) + faces4.tobytes()

    def chunk(cid, body):
        return struct.pack("<HI", cid, 6 + len(body)) + body

    mesh = chunk(_VERTS, verts) + chunk(_FACES, faces)
    obj = b"obj\x00" + chunk(_MESH, mesh)
    editor = chunk(_OBJECT, obj)
    main = chunk(_EDITOR, editor)
    with open(path, "wb") as fo:
        fo.write(chunk(_MAIN, main))

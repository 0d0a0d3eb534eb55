"""Model I/O: OBJ loading, binary model cache, cobj extraction (port of
`3dworld_tpu/scene/model3d.py`; pure host code).

The reference's `model3d` (model3d.h:539, model3d.cpp) holds per-material
indexed triangle meshes with a binary `.model3d` cache.  Here: `.obj`
files parse in Python (the JAX package may use its compiled `w3dnative`
parser for the same subset; the port never loads it), the binary cache is
the JAX package's `.model3d.npz` format next to the file, and cobj
extraction turns model triangles into COLL_POLYGON entries.  The other
formats read through `read_mesh_formats.load_model`.
"""

from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np


class Model3d(NamedTuple):
    """Indexed triangle mesh (SoA)."""

    positions: np.ndarray   # [V, 3] f32
    normals: np.ndarray     # [Nn, 3] f32 (may be empty)
    uvs: np.ndarray         # [Nt, 2] f32 (may be empty)
    faces: np.ndarray       # [F, 3] int32 vertex ids
    face_normals: np.ndarray  # [F, 3] int32 normal ids (-1 = none)
    face_uvs: np.ndarray    # [F, 3] int32 uv ids (-1 = none)

    @property
    def num_verts(self) -> int:
        return len(self.positions)

    @property
    def num_faces(self) -> int:
        return len(self.faces)

    def bounds(self):
        return self.positions.min(0), self.positions.max(0)


def _parse_obj_python(data: bytes) -> Model3d:
    """The .obj subset: v, vn, vt and f (polygons fan-split into
    triangles; negative indices count from the end)."""
    pos, nrm, uv = [], [], []
    fv, fn, ft = [], [], []

    def res(i, n):
        return i - 1 if i > 0 else (n + i if i < 0 else -1)

    for line in data.decode("utf-8", "replace").splitlines():
        t = line.split()
        if not t:
            continue
        if t[0] == "v":
            pos.append([float(t[1]), float(t[2]), float(t[3])])
        elif t[0] == "vn":
            nrm.append([float(t[1]), float(t[2]), float(t[3])])
        elif t[0] == "vt":
            uv.append([float(t[1]), float(t[2])])
        elif t[0] == "f":
            idx = []
            for w in t[1:]:
                parts = (w.split("/") + ["", ""])[:3]
                a = res(int(parts[0]), len(pos))
                b = res(int(parts[1]), len(uv)) if parts[1] else -1
                c = res(int(parts[2]), len(nrm)) if parts[2] else -1
                idx.append((a, b, c))
            for k in range(2, len(idx)):
                fv.append((idx[0][0], idx[k - 1][0], idx[k][0]))
                ft.append((idx[0][1], idx[k - 1][1], idx[k][1]))
                fn.append((idx[0][2], idx[k - 1][2], idx[k][2]))
    return Model3d(
        positions=np.asarray(pos, np.float32).reshape(-1, 3),
        normals=np.asarray(nrm, np.float32).reshape(-1, 3),
        uvs=np.asarray(uv, np.float32).reshape(-1, 2),
        faces=np.asarray(fv, np.int32).reshape(-1, 3),
        face_normals=np.asarray(fn, np.int32).reshape(-1, 3),
        face_uvs=np.asarray(ft, np.int32).reshape(-1, 3),
    )


def load_obj(path: str, use_cache: bool = True) -> Model3d:
    """Load an .obj model through the binary cache (.model3d.npz next to
    the file, the reference's .model3d cache), written after a parse."""
    cache = path + ".model3d.npz"
    if use_cache and os.path.exists(cache) and \
            os.path.getmtime(cache) >= os.path.getmtime(path):
        with np.load(cache) as z:
            return Model3d(**{k: z[k] for k in Model3d._fields})
    with open(path, "rb") as f:
        data = f.read()
    m = _parse_obj_python(data)
    if use_cache:
        try:
            np.savez_compressed(cache, **m._asdict())
        except OSError:
            pass
    return m


def compute_vertex_normals(m: Model3d) -> np.ndarray:
    """Area-weighted vertex normals when the model has none
    (model3d tangent/normal calc)."""
    vn = np.zeros_like(m.positions)
    a = m.positions[m.faces[:, 0]]
    b = m.positions[m.faces[:, 1]]
    c = m.positions[m.faces[:, 2]]
    fn = np.cross(b - a, c - a)
    for k in range(3):
        np.add.at(vn, m.faces[:, k], fn)
    ln = np.linalg.norm(vn, axis=1, keepdims=True)
    return vn / np.maximum(ln, 1e-12)


def model_to_cobjs(m: Model3d, max_tris: int | None = None):
    """Extract COLL_POLYGON cobjs from model triangles (the model cobj
    path), optionally only the first `max_tris`."""
    from . import cobj as SC

    sp = SC.SceneParse()
    lay = SC.CobjLayer()
    faces = m.faces if max_tris is None else m.faces[:max_tris]
    for f in faces:
        pts = tuple(tuple(map(float, m.positions[i])) for i in f)
        sp.cobjs.append(SC.RawCobj(SC.COLL_POLYGON, pts[0], r1=0.0, pts=pts,
                                   layer=lay))
    return sp

"""STL / PLY / OFF / DAE mesh loaders + the unified model dispatcher
(port of `3dworld_tpu/scene/read_mesh_formats.py`; pure host code, copied).

The reference reads everything beyond .obj/.3ds through Assimp
(model3d.cpp load path; Assimp covers STL/PLY/OFF/FBX/DAE/...).  Here
the common interchange formats get native stdlib readers, and
`load_model` dispatches by extension across every supported format
(.obj through `model3d.load_obj`, .3ds chunks, .gltf/.glb, .stl, .ply,
.off, .dae COLLADA geometry, binary .fbx via read_fbx).  A file written
by either package reads the same in both.
"""

from __future__ import annotations

import json
import os
import struct
import zlib

import numpy as np

from .model3d import Model3d

# what the readers raise on a truncated or malformed file: a scene's 'O'
# command and a city model row treat these as an unreadable model
LOAD_ERRORS = (ValueError, IndexError, KeyError, struct.error, zlib.error,
               OSError, UnicodeDecodeError, json.JSONDecodeError)


def _empty_aux(nf):
    return (np.zeros((0, 3), np.float32), np.zeros((0, 2), np.float32),
            -np.ones((nf, 3), np.int32), -np.ones((nf, 3), np.int32))


def load_stl(path: str) -> Model3d:
    """Binary or ASCII STL -> Model3d (vertices deduplicated)."""
    with open(path, "rb") as f:
        head = f.read(5)
    if head == b"solid":
        # could still be binary with a 'solid' header; sniff for 'facet'
        with open(path, "rb") as f:
            blob = f.read(1024)
        is_ascii = b"facet" in blob
    else:
        is_ascii = False

    tris = []
    if is_ascii:
        with open(path, "r", errors="replace") as f:
            cur = []
            for line in f:
                t = line.split()
                if t[:1] == ["vertex"]:
                    cur.append(tuple(float(v) for v in t[1:4]))
                    if len(cur) == 3:
                        tris.append(cur)
                        cur = []
    else:
        with open(path, "rb") as f:
            f.seek(80)
            (n,) = struct.unpack("<I", f.read(4))
            data = np.frombuffer(f.read(n * 50), dtype=np.uint8)
        if len(data) < n * 50:
            n = len(data) // 50
        rec = data[:n * 50].reshape(n, 50)
        v = rec[:, 12:48].copy().view("<f4").reshape(n, 3, 3)
        tris = v.tolist()
    tri = np.asarray(tris, np.float32).reshape(-1, 3, 3)
    flat = tri.reshape(-1, 3)
    verts, inv = np.unique(flat.round(6), axis=0, return_inverse=True)
    faces = inv.reshape(-1, 3).astype(np.int32)
    nn, uu, fn, fu = _empty_aux(len(faces))
    return Model3d(positions=verts.astype(np.float32), normals=nn, uvs=uu,
                   faces=faces, face_normals=fn, face_uvs=fu)


def load_ply(path: str) -> Model3d:
    """ASCII or binary_little_endian PLY (positions + faces; extra vertex
    properties are skipped)."""
    with open(path, "rb") as f:
        fmt = None
        nvert = nface = 0
        vprops = []
        in_vertex = False
        while True:
            line = f.readline().decode("ascii", "replace").strip()
            if line.startswith("format"):
                fmt = line.split()[1]
            elif line.startswith("element vertex"):
                nvert = int(line.split()[2])
                in_vertex = True
            elif line.startswith("element face"):
                nface = int(line.split()[2])
                in_vertex = False
            elif line.startswith("property") and in_vertex:
                vprops.append(line.split()[1:])
            elif line == "end_header":
                break

        tmap = {"float": ("f", 4), "float32": ("f", 4), "double": ("d", 8),
                "uchar": ("B", 1), "uint8": ("B", 1), "char": ("b", 1),
                "short": ("h", 2), "ushort": ("H", 2),
                "int": ("i", 4), "int32": ("i", 4),
                "uint": ("I", 4), "uint32": ("I", 4)}
        names = [p[-1] for p in vprops]
        if fmt == "ascii":
            verts = []
            for _ in range(nvert):
                vals = f.readline().split()
                d = dict(zip(names, vals))
                verts.append((float(d["x"]), float(d["y"]), float(d["z"])))
            faces = []
            for _ in range(nface):
                t = f.readline().split()
                k = int(t[0])
                idx = [int(v) for v in t[1:1 + k]]
                for j in range(1, k - 1):       # fan triangulation
                    faces.append((idx[0], idx[j], idx[j + 1]))
        else:
            codes = [tmap[p[0]][0] for p in vprops]
            sizes = [tmap[p[0]][1] for p in vprops]
            stride = sum(sizes)
            raw = f.read(nvert * stride)
            verts = []
            xi = names.index("x")
            yi = names.index("y")
            zi = names.index("z")
            offs = np.cumsum([0] + sizes[:-1])
            for i in range(nvert):
                base = i * stride
                def rd(j):
                    return struct.unpack_from("<" + codes[j], raw,
                                              base + offs[j])[0]
                verts.append((rd(xi), rd(yi), rd(zi)))
            faces = []
            for _ in range(nface):
                cnt_b = f.read(1)
                if not cnt_b:
                    break
                (k,) = struct.unpack("<B", cnt_b)
                idx = struct.unpack("<" + "i" * k, f.read(4 * k))
                for j in range(1, k - 1):
                    faces.append((idx[0], idx[j], idx[j + 1]))
        faces = np.asarray(faces, np.int32).reshape(-1, 3)
        nn, uu, fn, fu = _empty_aux(len(faces))
        return Model3d(positions=np.asarray(verts, np.float32), normals=nn,
                       uvs=uu, faces=faces, face_normals=fn, face_uvs=fu)


def load_off(path: str) -> Model3d:
    """OFF mesh -> Model3d."""
    with open(path) as f:
        toks = f.read().split()
    i = 0
    if toks[i] == "OFF":
        i += 1
    nv, nf = int(toks[i]), int(toks[i + 1])
    i += 3
    verts = np.asarray(toks[i:i + 3 * nv], np.float32).reshape(nv, 3)
    i += 3 * nv
    faces = []
    for _ in range(nf):
        k = int(toks[i])
        idx = [int(v) for v in toks[i + 1:i + 1 + k]]
        i += 1 + k
        for j in range(1, k - 1):
            faces.append((idx[0], idx[j], idx[j + 1]))
    faces = np.asarray(faces, np.int32).reshape(-1, 3)
    nn, uu, fn, fu = _empty_aux(len(faces))
    return Model3d(positions=verts, normals=nn, uvs=uu, faces=faces,
                   face_normals=fn, face_uvs=fu)


def load_model(path: str) -> Model3d:
    """Unified dispatcher across every supported mesh format (the
    reference's read_model_file extension switch, model3d.cpp)."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".obj":
        from .model3d import load_obj
        return load_obj(path)
    if ext == ".3ds":
        from .read_3ds import load_3ds
        return load_3ds(path)
    if ext in (".gltf", ".glb"):
        from .read_gltf import load_gltf
        m = load_gltf(path)
        return m if isinstance(m, Model3d) else m[0]
    if ext == ".stl":
        return load_stl(path)
    if ext == ".ply":
        return load_ply(path)
    if ext == ".off":
        return load_off(path)
    if ext == ".dae":
        return load_dae(path)
    if ext == ".fbx":
        from .read_fbx import load_fbx
        return load_fbx(path)
    raise ValueError(f"unsupported model format '{ext}' "
                     "(.obj/.3ds/.gltf/.glb/.stl/.ply/.off/.dae/.fbx)")


def load_dae(path: str) -> Model3d:
    """COLLADA (.dae) geometry: positions + triangulated faces from every
    <geometry> in the library, instanced un-transformed (the reference
    reads DAE through Assimp; this covers the mesh payload — node
    transforms and materials are ignored)."""
    import xml.etree.ElementTree as ET
    tree = ET.parse(path)
    root = tree.getroot()
    # namespace-agnostic tag matching
    def tag(e):
        return e.tag.rsplit("}", 1)[-1]

    def findall(e, name):
        return [c for c in e.iter() if tag(c) == name]

    all_pos = []
    all_faces = []
    voff = 0
    for geom in findall(root, "geometry"):
        for mesh in [c for c in geom if tag(c) == "mesh"]:
            sources = {}
            for src in [c for c in mesh if tag(c) == "source"]:
                arr = [c for c in src if tag(c) == "float_array"]
                if arr:
                    sources["#" + src.get("id")] = np.asarray(
                        arr[0].text.split(), np.float32)
            # vertices indirection: <vertices id> -> POSITION source
            vert_src = {}
            for v in [c for c in mesh if tag(c) == "vertices"]:
                for inp in [c for c in v if tag(c) == "input"]:
                    if inp.get("semantic") == "POSITION":
                        vert_src["#" + v.get("id")] = inp.get("source")
            for prim in [c for c in mesh if tag(c) in
                         ("triangles", "polylist")]:
                inputs = [c for c in prim if tag(c) == "input"]
                stride = 1 + max(int(i.get("offset", 0)) for i in inputs)
                pos_key = None
                pos_off = 0
                for i in inputs:
                    if i.get("semantic") == "VERTEX":
                        pos_key = vert_src.get(i.get("source"),
                                               i.get("source"))
                        pos_off = int(i.get("offset", 0))
                pos = sources[pos_key].reshape(-1, 3)
                p_el = [c for c in prim if tag(c) == "p"]
                if not p_el:
                    continue
                idx = np.asarray(p_el[0].text.split(), np.int64)
                vidx = idx.reshape(-1, stride)[:, pos_off]
                if tag(prim) == "triangles":
                    f = vidx.reshape(-1, 3)
                else:          # polylist: fan-triangulate via vcount
                    vc_el = [c for c in prim if tag(c) == "vcount"]
                    vcount = np.asarray(vc_el[0].text.split(), np.int64)
                    f = []
                    k = 0
                    for c in vcount:
                        for j in range(1, c - 1):
                            f.append((vidx[k], vidx[k + j], vidx[k + j + 1]))
                        k += c
                    f = np.asarray(f, np.int64).reshape(-1, 3)
                all_pos.append(pos)
                all_faces.append(f + voff)
                voff += len(pos)
    if not all_pos:
        raise ValueError(f"no geometry in {path}")
    P = np.concatenate(all_pos).astype(np.float32)
    F = np.concatenate(all_faces).astype(np.int32)
    nn, uu, fn, fu = _empty_aux(len(F))
    return Model3d(positions=P, normals=nn, uvs=uu, faces=F,
                   face_normals=fn, face_uvs=fu)

"""Binary FBX reader (geometry + skin weights); port of
`3dworld_tpu/scene/read_fbx.py` (pure host code, copied).

The reference imports FBX through Assimp (assimp_wrap.cpp:671, bones
<=4/vertex + animation channels per model3d.h:205-254).  This is a
native reader for the Kaydara binary FBX container: the node-record
tree with typed properties (7.x format; 32-bit records through 7.4 and
64-bit from 7.5), zlib-compressed ('d'-encoded) arrays, Geometry nodes
(Vertices + PolygonVertexIndex with negative end-of-polygon markers,
LayerElementNormal/UV), and Deformer SubDeformer Cluster skin weights.

ASCII FBX is detected and rejected with a clear error (the binary
container is what tools actually emit).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from .model3d import Model3d

_MAGIC = b"Kaydara FBX Binary  \x00"

_PRIM = {b"Y": ("<h", 2), b"C": ("<b", 1), b"I": ("<i", 4),
         b"F": ("<f", 4), b"D": ("<d", 8), b"L": ("<q", 8)}
_ARR = {b"f": np.float32, b"d": np.float64, b"l": np.int64,
        b"i": np.int32, b"b": np.bool_}


class _Node:
    __slots__ = ("name", "props", "children")

    def __init__(self, name, props):
        self.name = name
        self.props = props
        self.children = []

    def find(self, name):
        return [c for c in self.children if c.name == name]

    def first(self, name):
        for c in self.children:
            if c.name == name:
                return c
        return None


def _read_prop(buf, off):
    t = buf[off:off + 1]
    off += 1
    if t in _PRIM:
        fmt, sz = _PRIM[t]
        return struct.unpack_from(fmt, buf, off)[0], off + sz
    if t in _ARR:
        n, enc, clen = struct.unpack_from("<III", buf, off)
        off += 12
        raw = buf[off:off + clen]
        off += clen
        if enc == 1:
            raw = zlib.decompress(raw)
        return np.frombuffer(raw, _ARR[t], count=n), off
    if t == b"S" or t == b"R":
        n = struct.unpack_from("<I", buf, off)[0]
        off += 4
        val = buf[off:off + n]
        return (val.decode("utf-8", "replace") if t == b"S" else val), off + n
    raise ValueError(f"unknown FBX property type {t!r}")


def _read_node(buf, off, long_offsets):
    if long_offsets:
        end, nprops, _plen = struct.unpack_from("<QQQ", buf, off)
        off += 24
    else:
        end, nprops, _plen = struct.unpack_from("<III", buf, off)
        off += 12
    nlen = buf[off]
    off += 1
    name = buf[off:off + nlen].decode("utf-8", "replace")
    off += nlen
    if end == 0 and nprops == 0 and not name:
        return None, off                       # null terminator record
    props = []
    for _ in range(nprops):
        p, off = _read_prop(buf, off)
        props.append(p)
    node = _Node(name, props)
    while off < end:
        child, off = _read_node(buf, off, long_offsets)
        if child is None:
            break
    # _read_node appends to the enclosing list via return; collect here
        node.children.append(child)
    return node, max(off, end)


def _parse(buf):
    if buf[:len(_MAGIC)] != _MAGIC:
        if buf[:1] == b";" or b"FBXHeaderExtension" in buf[:2048]:
            raise ValueError("ASCII FBX not supported; export binary FBX")
        raise ValueError("not an FBX binary file")
    version = struct.unpack_from("<I", buf, 23)[0]
    long_offsets = version >= 7500
    off = 27
    root = _Node("", [])
    while off < len(buf):
        node, off = _read_node(buf, off, long_offsets)
        if node is None:
            break
        root.children.append(node)
    return root, version


def _tri_faces(poly_ix):
    """PolygonVertexIndex -> ([F,3] triangles of control-point ids,
    [F,3] polygon-vertex SLOTS for ByPolygonVertex attributes).
    Negative value = ~last index of the polygon; fan-triangulate."""
    tris, corners = [], []
    poly, slots = [], []
    for s, v in enumerate(poly_ix):
        if v < 0:
            poly.append(~int(v))
            slots.append(s)
            for k in range(1, len(poly) - 1):
                tris.append((poly[0], poly[k], poly[k + 1]))
                corners.append((slots[0], slots[k], slots[k + 1]))
            poly, slots = [], []
        else:
            poly.append(int(v))
            slots.append(s)
    return (np.asarray(tris, np.int32).reshape(-1, 3),
            np.asarray(corners, np.int32).reshape(-1, 3))


def _layer_attr_faces(layer, data_name, index_name, faces, corners):
    """Face-attribute indices for a LayerElement per its
    MappingInformationType / ReferenceInformationType: ByPolygonVertex
    indexes the per-corner slots; ByVertice the control points;
    IndexToDirect maps through the layer's index array."""
    def _str(node):
        v = node.props[0] if node and node.props else b""
        return v.decode() if isinstance(v, (bytes, bytearray)) else str(v)

    mapping = _str(layer.first("MappingInformationType")) or "ByPolygonVertex"
    ref = _str(layer.first("ReferenceInformationType")) or "Direct"
    if mapping.startswith("ByVert"):       # ByVertice/ByVertex
        fa = faces.copy()
    elif mapping == "ByPolygonVertex":
        fa = corners.copy()
    elif mapping == "AllSame":
        fa = np.zeros_like(faces)
    else:                                   # ByPolygon etc. unsupported
        return -np.ones_like(faces)
    if ref == "IndexToDirect":
        idx_node = layer.first(index_name)
        if idx_node is None:
            return -np.ones_like(faces)
        idx = np.asarray(idx_node.props[0], np.int64).astype(np.int32)
        fa = idx[np.clip(fa, 0, len(idx) - 1)]
    return fa.astype(np.int32)


def load_fbx(path: str) -> Model3d:
    """First Geometry node -> Model3d (positions/faces/normals/uvs)."""
    with open(path, "rb") as f:
        buf = f.read()
    root, _version = _parse(buf)
    objects = root and next((c for c in root.children
                             if c.name == "Objects"), None)
    if objects is None:
        raise ValueError("FBX: no Objects node")
    geom = None
    for g in objects.find("Geometry"):
        if g.first("Vertices") is not None:
            geom = g
            break
    if geom is None:
        raise ValueError("FBX: no Geometry with Vertices")
    verts = np.asarray(geom.first("Vertices").props[0],
                       np.float64).reshape(-1, 3).astype(np.float32)
    poly = np.asarray(geom.first("PolygonVertexIndex").props[0], np.int64)
    faces, corners = _tri_faces(poly)

    normals = np.zeros((0, 3), np.float32)
    face_normals = -np.ones((len(faces), 3), np.int32)
    ln = geom.first("LayerElementNormal")
    if ln is not None and ln.first("Normals") is not None:
        normals = np.asarray(ln.first("Normals").props[0],
                             np.float64).reshape(-1, 3).astype(np.float32)
        face_normals = _layer_attr_faces(ln, "Normals", "NormalsIndex",
                                         faces, corners)
    uvs = np.zeros((0, 2), np.float32)
    face_uvs = -np.ones((len(faces), 3), np.int32)
    lu = geom.first("LayerElementUV")
    if lu is not None and lu.first("UV") is not None:
        uvs = np.asarray(lu.first("UV").props[0],
                         np.float64).reshape(-1, 2).astype(np.float32)
        face_uvs = _layer_attr_faces(lu, "UV", "UVIndex", faces, corners)
    return Model3d(positions=verts, normals=normals, uvs=uvs,
                   faces=faces, face_normals=face_normals,
                   face_uvs=face_uvs)


def load_fbx_skins(path: str):
    """Skin clusters: list of (indexes [K] int32, weights [K] f32) per
    SubDeformer Cluster (bones <=4/vertex downstream, model3d.h:205)."""
    with open(path, "rb") as f:
        buf = f.read()
    root, _ = _parse(buf)
    objects = next((c for c in root.children if c.name == "Objects"), None)
    out = []
    if objects is None:
        return out
    for d in objects.find("Deformer"):
        ix = d.first("Indexes")
        w = d.first("Weights")
        if ix is not None and w is not None:
            out.append((np.asarray(ix.props[0], np.int64).astype(np.int32),
                        np.asarray(w.props[0], np.float64).astype(np.float32)))
    return out


# ---------------------------------------------------------------------------
# minimal binary writer (tests + cache export)
# ---------------------------------------------------------------------------

def _write_prop(v):
    if isinstance(v, str):
        b = v.encode()
        return b"S" + struct.pack("<I", len(b)) + b
    if isinstance(v, (int, np.integer)) and not isinstance(v, np.ndarray):
        return b"L" + struct.pack("<q", int(v))
    if isinstance(v, (float, np.floating)):
        return b"D" + struct.pack("<d", float(v))
    if isinstance(v, np.ndarray):
        code = {np.dtype(np.float64): b"d", np.dtype(np.float32): b"f",
                np.dtype(np.int64): b"l", np.dtype(np.int32): b"i"}[v.dtype]
        raw = v.tobytes()
        comp = zlib.compress(raw)
        return code + struct.pack("<III", v.size, 1, len(comp)) + comp
    raise TypeError(type(v))


def _write_node(name, props, children, base):
    nb = name.encode()
    pdata = b"".join(_write_prop(p) for p in props)
    body = bytearray()
    # children rendered after we know our own offset; compute inside-out
    cdata = bytearray()
    inner_off = base + 12 + 1 + len(nb) + len(pdata)
    for (cn, cp, cc) in children:
        blob = _write_node(cn, cp, cc, inner_off + len(cdata))
        cdata.extend(blob)
    if children:
        cdata.extend(b"\x00" * 13)            # null record terminator
    end = base + 12 + 1 + len(nb) + len(pdata) + len(cdata)
    body.extend(struct.pack("<III", end, len(props), len(pdata)))
    body.append(len(nb))
    body.extend(nb)
    body.extend(pdata)
    body.extend(cdata)
    return bytes(body)


def write_fbx(path: str, model: Model3d):
    """Minimal valid binary FBX (version 7400) holding one Geometry."""
    # faces -> PolygonVertexIndex with ~ on each triangle's last index
    poly = model.faces.astype(np.int64).copy()
    poly[:, 2] = ~poly[:, 2]
    children = [
        ("Vertices", [model.positions.astype(np.float64).ravel()], []),
        ("PolygonVertexIndex", [poly.ravel()], []),
    ]
    if len(model.normals):
        children.append(
            ("LayerElementNormal", [np.int64(0)],
             [("Normals", [model.normals.astype(np.float64).ravel()], [])]))
    if len(model.uvs):
        children.append(
            ("LayerElementUV", [np.int64(0)],
             [("UV", [model.uvs.astype(np.float64).ravel()], [])]))
    header = _MAGIC + b"\x1a\x00" + struct.pack("<I", 7400)
    base = len(header)
    objects = _write_node(
        "Objects", [],
        [("Geometry", [np.int64(1), "Geometry::mesh", "Mesh"], children)],
        base)
    blob = header + objects + b"\x00" * 13
    with open(path, "wb") as f:
        f.write(blob)

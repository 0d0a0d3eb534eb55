"""Torch port vs JAX package: the model formats (`scene/read_mesh_formats`:
STL, PLY, OFF, DAE and `load_model`; `read_3ds`, `read_gltf`,
`read_fbx`), the DSL's `O` command over every format, the outcome of a
model file that fails to parse, and city model rows over a glTF file.

Everything here is host numpy, so every result is exact: each loader's
`Model3d` fields (and the glTF skin: joints, weights, inverse binds,
animation channels; the FBX skin clusters) equal the JAX loader's on the
same file, the writers' bytes equal, and the scenes' `SceneParse`s and
packed cobj tables equal.  Each package reads its own copy of a file
(both write `<model>.model3d.npz` next to an OBJ).  The files are
written to `tmp_path` by `kernel_probe.write_model_files` or here."""

import base64
import dataclasses
import json
import shutil
import struct
import zlib

import numpy as np
import pytest

import w3d  # noqa: F401
from w3d.scene import cobj as JSC, read_mesh_formats as JRF, read_gltf as JGL
from w3d.scene import read_fbx as JFB, read_3ds as J3D
from w3d.city import model_instances as JMI

from w3d_torch.scene import cobj as TSC, read_mesh_formats as TRF, read_gltf as TGL
from w3d_torch.scene import read_fbx as TFB, read_3ds as T3D
from w3d_torch.scene.model3d import Model3d
from w3d_torch.city import model_instances as TMI
from w3d_torch.utils import kernel_probe as KP


def same_model(a, b):
    for f in Model3d._fields:
        x, y = np.asarray(getattr(a, f)), np.asarray(getattr(b, f))
        assert x.dtype == y.dtype and x.shape == y.shape, f
        np.testing.assert_array_equal(x, y, err_msg=f)


def same_skin(a, b):
    if b is None:
        assert a is None
        return
    assert set(a) == set(b)
    for k in ("joints", "weights", "inverse_bind"):
        if b[k] is None:
            assert a[k] is None
        else:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert a["animations"].keys() == b["animations"].keys()
    for name, chans in b["animations"].items():
        assert chans.keys() == a["animations"][name].keys()
        for j, ch in chans.items():
            assert ch.keys() == a["animations"][name][j].keys()
            for k, v in ch.items():
                np.testing.assert_array_equal(a["animations"][name][j][k], v)


def two_copies(tmp_path, files: dict):
    """Write {name: bytes | str} into a directory per package."""
    dirs = []
    for name in ("jax", "port"):
        d = tmp_path / name
        d.mkdir(parents=True, exist_ok=True)
        for fn, data in files.items():
            (d / fn).write_bytes(data if isinstance(data, bytes) else data.encode())
        dirs.append(d)
    return dirs


@pytest.fixture(scope="module")
def grid_files(tmp_path_factory):
    """A 12x8-cell grid model written in every format, twice."""
    root = tmp_path_factory.mktemp("formats")
    model = KP.grid_model(12, 8)
    KP.write_model_files(str(root), model)
    for name in ("jax", "port"):
        shutil.copytree(root, root / name, ignore=shutil.ignore_patterns("jax", "port"))
    return root, model


@pytest.mark.parametrize("fmt", KP.MODEL_FORMATS)
def test_load_model_matches_jax(grid_files, fmt):
    """Each format's file loads to the JAX `Model3d` and to the triangles
    the writer was given."""
    root, model = grid_files
    fn = f"model_{fmt}.{_ext(fmt)}"
    j = JRF.load_model(str(root / "jax" / fn))
    t = TRF.load_model(str(root / "port" / fn))
    same_model(t, j)
    np.testing.assert_array_equal(t.positions[t.faces], model.positions[model.faces])


def _ext(fmt):
    return fmt.split("_")[0]


def test_small_cases_match(tmp_path):
    """The JAX tests' tetrahedron cases: binary and ASCII STL, ASCII PLY
    with an extra property and a quad (fan split), binary PLY, OFF, a DAE
    with triangles and a polylist; the dispatcher refuses an unknown
    extension in both."""
    V = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1]], np.float32)
    F = np.array([[0, 1, 2], [0, 1, 3], [0, 2, 3], [1, 2, 3]], np.int32)
    stl = b"\x00" * 80 + struct.pack("<I", 4) + b"".join(
        struct.pack("<3f", 0, 0, 1) + b"".join(struct.pack("<3f", *V[v]) for v in tri)
        + struct.pack("<H", 0) for tri in F)
    ply = ("ply\nformat ascii 1.0\nelement vertex 4\nproperty float x\n"
           "property float y\nproperty float z\nproperty uchar red\nelement face 3\n"
           "property list uchar int vertex_indices\nend_header\n"
           + "".join("%f %f %f 255\n" % tuple(v) for v in V) + "3 0 1 2\n3 0 1 3\n4 0 1 2 3\n")
    plyb = (b"ply\nformat binary_little_endian 1.0\nelement vertex 4\n"
            b"property float x\nproperty float y\nproperty float z\n"
            b"property short s\nelement face 2\n"
            b"property list uchar int vertex_indices\nend_header\n"
            + b"".join(struct.pack("<3fh", *v, 7) for v in V)
            + b"".join(struct.pack("<B3i", 3, *t) for t in F[:2]))
    off = "OFF\n4 2 0\n" + "".join("%f %f %f\n" % tuple(v) for v in V) + "3 0 1 2\n4 0 1 2 3\n"
    dae = """<?xml version="1.0"?>
<COLLADA xmlns="http://www.collada.org/2005/11/COLLADASchema" version="1.4.1">
 <library_geometries>
  <geometry id="g1"><mesh>
   <source id="pos"><float_array id="pa" count="12">0 0 0  1 0 0  0 1 0  0 0 1</float_array></source>
   <source id="nrm"><float_array id="na" count="3">0 0 1</float_array></source>
   <vertices id="verts"><input semantic="POSITION" source="#pos"/></vertices>
   <triangles count="2"><input semantic="VERTEX" source="#verts" offset="0"/>
    <input semantic="NORMAL" source="#nrm" offset="1"/><p>0 0 1 0 2 0  0 0 1 0 3 0</p></triangles>
   <polylist count="1"><input semantic="VERTEX" source="#verts" offset="0"/>
    <vcount>4</vcount><p>0 1 2 3</p></polylist>
  </mesh></geometry>
 </library_geometries>
</COLLADA>"""
    files = {"t.stl": stl, "ta.stl": "solid t\n" + "".join(
        "facet normal 0 0 1\nouter loop\n" + "".join("vertex %f %f %f\n" % tuple(V[v])
                                                     for v in tri) + "endloop\nendfacet\n"
        for tri in F) + "endsolid t\n", "t.ply": ply, "tb.ply": plyb, "t.off": off,
        "m.dae": dae}
    dj, dt = two_copies(tmp_path, files)
    for fn, faces in (("t.stl", 4), ("ta.stl", 4), ("t.ply", 4), ("tb.ply", 2),
                      ("t.off", 3), ("m.dae", 4)):
        t = TRF.load_model(str(dt / fn))
        same_model(t, JRF.load_model(str(dj / fn)))
        assert t.num_faces == faces, fn
    for mod in (JRF, TRF):
        with pytest.raises(ValueError):
            mod.load_model(str(dt / "x.xyz"))


def _gltf_doc(blobs, accessors, **extra):
    offs, buf = [], b""
    for b in blobs:
        offs.append(len(buf))
        buf += b + b"\0" * (-len(b) % 4)
    doc = {"asset": {"version": "2.0"},
           "buffers": [{"byteLength": len(buf),
                        "uri": "data:application/octet-stream;base64,"
                               + base64.b64encode(buf).decode()}],
           "bufferViews": [{"buffer": 0, "byteOffset": offs[i], "byteLength": len(blobs[i])}
                           for i in range(len(blobs))],
           "accessors": accessors}
    doc.update(extra)
    return doc, buf


def _glb(doc, binchunk):
    doc = dict(doc, buffers=[{"byteLength": len(binchunk)}])
    js = json.dumps(doc).encode()
    js += b" " * (-len(js) % 4)
    return (struct.pack("<III", 0x46546C67, 2, 28 + len(js) + len(binchunk))
            + struct.pack("<II", len(js), 0x4E4F534A) + js
            + struct.pack("<II", len(binchunk), 0x004E4942) + binchunk)


def test_gltf_matches_jax(tmp_path):
    """glTF: the JAX test's skinned quad with a rotation channel (.gltf
    and .glb), mixed skinned and unskinned primitives with normalized
    ubyte weights and a column-major inverse bind, an interleaved buffer
    view (byteStride) with an accessor byteOffset and no indices, and a
    side .bin buffer with ushort weights."""
    pos = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [1, 1, 0]], np.float32)
    idx = np.array([0, 1, 2, 1, 3, 2], np.uint16)
    joints = np.zeros((4, 4), np.uint8)
    weights = np.tile(np.array([[1, 0, 0, 0]], np.float32), (4, 1))
    ibm = np.eye(4, dtype=np.float32)
    ibm[3, :3] = (2.0, 3.0, 4.0)
    at = np.array([0.0, 1.0], np.float32)
    ar = np.array([[0, 0, 0, 1], [0, 0.7071, 0, 0.7071]], np.float32)
    acc = [{"bufferView": 0, "componentType": 5126, "count": 4, "type": "VEC3"},
           {"bufferView": 1, "componentType": 5123, "count": 6, "type": "SCALAR"},
           {"bufferView": 2, "componentType": 5121, "count": 4, "type": "VEC4"},
           {"bufferView": 3, "componentType": 5126, "count": 4, "type": "VEC4"},
           {"bufferView": 4, "componentType": 5126, "count": 1, "type": "MAT4"},
           {"bufferView": 5, "componentType": 5126, "count": 2, "type": "SCALAR"},
           {"bufferView": 6, "componentType": 5126, "count": 2, "type": "VEC4"}]
    skinned, buf = _gltf_doc(
        [pos.tobytes(), idx.tobytes(), joints.tobytes(), weights.tobytes(),
         ibm.tobytes(), at.tobytes(), ar.tobytes()], acc,
        meshes=[{"primitives": [{"attributes": {"POSITION": 0, "JOINTS_0": 2,
                                                "WEIGHTS_0": 3}, "indices": 1}]}],
        nodes=[{"mesh": 0, "skin": 0}, {"name": "bone"}],
        skins=[{"joints": [1], "inverseBindMatrices": 4}],
        animations=[{"name": "wave", "channels": [
            {"sampler": 0, "target": {"node": 1, "path": "rotation"}},
            {"sampler": 1, "target": {"node": 1, "path": "translation"}}],
            "samplers": [{"input": 5, "output": 6}, {"input": 5, "output": 0}]}])
    wts_u8 = np.zeros((4, 4), np.uint8)
    wts_u8[:, 0] = 255
    mixed, _ = _gltf_doc(
        [pos.tobytes(), idx.tobytes(), joints.tobytes(), wts_u8.tobytes(), ibm.tobytes()],
        acc[:3] + [dict(acc[2], bufferView=3, normalized=True), acc[4]],
        meshes=[{"primitives": [{"attributes": {"POSITION": 0}, "indices": 1},
                                {"attributes": {"POSITION": 0, "JOINTS_0": 2,
                                                "WEIGHTS_0": 3}, "indices": 1},
                                {"attributes": {"POSITION": 0}, "mode": 1}]}],
        nodes=[{"mesh": 0, "skin": 0}, {"name": "bone"}],
        skins=[{"joints": [1], "inverseBindMatrices": 4}])
    # interleaved position + normal + uv, 32-byte stride, positions from
    # byte 0 and normals from byte 12 of the same view; no indices
    inter = np.zeros((6, 8), np.float32)
    inter[:, :3] = np.random.default_rng(0).random((6, 3))
    inter[:, 3:6] = (0, 0, 1)
    inter[:, 6:] = np.random.default_rng(1).random((6, 2))
    # (the readers take whole strides, so the view holds one more)
    strided, _ = _gltf_doc(
        [inter.tobytes() + bytes(32)],
        [{"bufferView": 0, "componentType": 5126, "count": 6, "type": "VEC3"},
         {"bufferView": 0, "byteOffset": 12, "componentType": 5126, "count": 6,
          "type": "VEC3"},
         {"bufferView": 0, "byteOffset": 24, "componentType": 5126, "count": 6,
          "type": "VEC2"}],
        meshes=[{"primitives": [{"attributes": {"POSITION": 0, "NORMAL": 1,
                                                "TEXCOORD_0": 2}}]}])
    strided["bufferViews"][0]["byteStride"] = 32
    wts_u16 = np.zeros((4, 4), np.uint16)
    wts_u16[:, :2] = (40000, 25535)
    side, side_buf = _gltf_doc(
        [pos.tobytes(), idx.tobytes(), joints.tobytes(), wts_u16.tobytes()],
        acc[:3] + [{"bufferView": 3, "componentType": 5123, "count": 4, "type": "VEC4",
                    "normalized": True}],
        meshes=[{"primitives": [{"attributes": {"POSITION": 0, "JOINTS_0": 2,
                                                "WEIGHTS_0": 3}, "indices": 1}]}],
        skins=[{"joints": [0]}])
    side["buffers"] = [{"byteLength": len(side_buf), "uri": "side.bin"}]
    files = {"skinned.gltf": json.dumps(skinned), "skinned.glb": _glb(skinned, buf),
             "mixed.gltf": json.dumps(mixed), "strided.gltf": json.dumps(strided),
             "side.gltf": json.dumps(side), "side.bin": side_buf}
    dj, dt = two_copies(tmp_path, files)
    for fn in ("skinned.gltf", "skinned.glb", "mixed.gltf", "strided.gltf", "side.gltf"):
        (tm, ts), (jm, js) = TGL.load_gltf(str(dt / fn)), JGL.load_gltf(str(dj / fn))
        same_model(tm, jm)
        same_skin(ts, js)
        same_model(TRF.load_model(str(dt / fn)), tm)
    _, ts = TGL.load_gltf(str(dt / "skinned.gltf"))
    np.testing.assert_array_equal(ts["animations"]["wave"][0]["rotation"][0], [1, 0, 0, 0])
    tm, ts = TGL.load_gltf(str(dt / "mixed.gltf"))
    assert tm.num_verts == 8 and (ts["weights"][:4] == 0).all()
    np.testing.assert_array_equal(ts["inverse_bind"][0][:3, 3], [2, 3, 4])
    tm, ts = TGL.load_gltf(str(dt / "strided.gltf"))
    assert ts is None and tm.num_faces == 2
    np.testing.assert_array_equal(tm.normals, inter[:, 3:6])
    _, ts = TGL.load_gltf(str(dt / "side.gltf"))
    np.testing.assert_allclose(ts["weights"][0, :2], (40000 / 65535, 25535 / 65535))


def _fbx7500(verts, poly, clusters=()):
    """A binary FBX of version 7500 (64-bit node offsets), its arrays
    stored uncompressed (encoding 0), the last one zlib-compressed."""
    def prop(v, compress=False):
        code = {np.dtype(np.float64): b"d", np.dtype(np.int32): b"i",
                np.dtype(np.int64): b"l"}[v.dtype]
        raw = v.tobytes()
        data = zlib.compress(raw) if compress else raw
        return code + struct.pack("<III", v.size, int(compress), len(data)) + data

    def node(name, props, children, base):
        nb = name.encode()
        head = 25 + len(nb) + len(props)
        out, off = b"", base + head
        for c in children:
            blob = c(off + len(out))
            out += blob
        if children:
            out += b"\x00" * 25
        end = base + head + len(out)
        return struct.pack("<QQQ", end, 1 if props else 0, len(props)) + bytes(
            [len(nb)]) + nb + props + out

    kids = [lambda b: node("Vertices", prop(verts), [], b),
            lambda b: node("PolygonVertexIndex", prop(poly, True), [], b)]
    geom = lambda b: node("Geometry", b"S" + struct.pack("<I", 4) + b"mesh", kids, b)
    defs = [lambda b, ix=ix, w=w: node(
        "Deformer", b"S" + struct.pack("<I", 2) + b"cl",
        [lambda bb: node("Indexes", prop(ix), [], bb),
         lambda bb: node("Weights", prop(w, True), [], bb)], b) for ix, w in clusters]
    header = TFB._MAGIC + b"\x1a\x00" + struct.pack("<I", 7500)
    objects = node("Objects", b"", [geom] + defs, len(header))
    return header + objects + b"\x00" * 25


def test_fbx_matches_jax(tmp_path):
    """FBX: the writer's bytes (normals and uvs, zlib arrays, version
    7400); a version-7500 file with 64-bit node offsets, raw and zlib
    arrays, a quad and a pentagon fanned from their negative end markers,
    and two skin clusters; ASCII FBX refused by both."""
    verts = np.array([(0, 0, 0), (1, 0, 0), (1, 1, 0), (0, 1, 0), (0.5, 0.5, 1)], np.float32)
    faces = np.array([(0, 1, 2), (0, 2, 3), (0, 1, 4), (1, 2, 4), (2, 3, 4), (3, 0, 4)],
                     np.int32)
    m = Model3d(positions=verts, normals=np.array([(0, 0, 1)] * 5, np.float32),
                uvs=np.array([(0, 0), (1, 0), (1, 1), (0, 1), (0.5, 0.5)], np.float32),
                faces=faces, face_normals=-np.ones((6, 3), np.int32),
                face_uvs=-np.ones((6, 3), np.int32))
    JFB.write_fbx(str(tmp_path / "j.fbx"), m)
    TFB.write_fbx(str(tmp_path / "t.fbx"), m)
    assert (tmp_path / "j.fbx").read_bytes() == (tmp_path / "t.fbx").read_bytes()
    same_model(TFB.load_fbx(str(tmp_path / "t.fbx")), JFB.load_fbx(str(tmp_path / "t.fbx")))
    poly = np.array([0, 1, 2, ~3, 4, 3, 2, 1, ~0], np.int32)
    clusters = [(np.array([0, 1, 4], np.int32), np.array([1.0, 0.5, 0.25])),
                (np.array([2, 3], np.int64), np.array([0.75, 1.0]))]
    (tmp_path / "v75.fbx").write_bytes(_fbx7500(verts.astype(np.float64).ravel(), poly,
                                                clusters))
    t, j = TFB.load_fbx(str(tmp_path / "v75.fbx")), JFB.load_fbx(str(tmp_path / "v75.fbx"))
    same_model(t, j)
    np.testing.assert_array_equal(t.faces, [(0, 1, 2), (0, 2, 3), (4, 3, 2), (4, 2, 1),
                                            (4, 1, 0)])
    ts, js = (mod.load_fbx_skins(str(tmp_path / "v75.fbx")) for mod in (TFB, JFB))
    assert len(ts) == len(js) == 2
    for (a, b), (c, d) in zip(ts, js):
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, d)
    (tmp_path / "a.fbx").write_text("; FBX 7.4.0 project file\nFBXHeaderExtension: {}\n")
    for mod in (TFB, JFB):
        with pytest.raises(ValueError, match="ASCII FBX"):
            mod.load_fbx(str(tmp_path / "a.fbx"))


def test_3ds_writer_matches_jax(tmp_path):
    model = KP.grid_model(6, 4)
    J3D.write_3ds(str(tmp_path / "j.3ds"), model)
    T3D.write_3ds(str(tmp_path / "t.3ds"), model)
    assert (tmp_path / "j.3ds").read_bytes() == (tmp_path / "t.3ds").read_bytes()
    same_model(T3D.load_3ds(str(tmp_path / "t.3ds")), J3D.load_3ds(str(tmp_path / "j.3ds")))


def _parse_both(tmp_path, src, files):
    out = []
    for (name, mod), d in zip((("jax", JSC), ("port", TSC)), two_copies(tmp_path, files)):
        (d / "scene.txt").write_text(src)
        out.append(mod.parse_coll_obj_file(str(d / "scene.txt")))
    return out


def _packed(jsp, tsp):
    jc, tc = JSC.pack_cobjs(jsp), TSC.pack_cobjs(tsp, device="cpu")
    for name in TSC.CobjSet._fields:
        a, b = np.asarray(getattr(jc, name)), getattr(tc, name).numpy()
        assert a.shape == b.shape, name
        np.testing.assert_array_equal(a.astype(b.dtype), b, err_msg=name)
    return tc


def test_dsl_models_every_format(tmp_path):
    """A scene whose `O` commands name one model in every format (each
    placed by a `Z` transform) parses and packs as the JAX scene does, and
    its table equals the same scene with OBJ files."""
    root = tmp_path / "files"
    root.mkdir()
    paths = KP.write_model_files(str(root), KP.grid_model(4, 3))
    files = {p.split("/")[-1]: open(p, "rb").read() for p in paths.values()}
    src = "".join(f"O {p.split('/')[-1]} 0 0 0\nZ 0  {i} 0 0.5\n"
                  for i, p in enumerate(paths.values()))
    src_obj = "".join(f"O model_obj.obj 0 0 0\nZ 0  {i} 0 0.5\n" for i in range(len(paths)))
    jsp, tsp = _parse_both(tmp_path / "all", src, files)
    assert dataclasses.asdict(jsp) == dataclasses.asdict(tsp)
    assert all(m.loaded for m in tsp.models) and len(tsp.models) == len(KP.MODEL_FORMATS)
    tc = _packed(jsp, tsp)
    _, osp = _parse_both(tmp_path / "obj", src_obj, files)
    oc = TSC.pack_cobjs(osp, device="cpu")
    for name in TSC.CobjSet._fields:
        np.testing.assert_array_equal(getattr(tc, name).numpy(), getattr(oc, name).numpy())
    assert int((tc.shape > 0).sum()) == 2 * len(KP.MODEL_FORMATS) * 24


def test_malformed_models_give_jax_outcome(tmp_path):
    """An OBJ cut inside its face list (the whole faces load), an OBJ whose
    vertex list was cut short (a face names a missing vertex), a truncated
    binary STL (its header counts more triangles than it holds), a glTF
    whose accessor names a missing buffer view and a GLB without chunks:
    `loaded`, the cobj count and the packed table as in the JAX package,
    and the scene loads."""
    root = tmp_path / "w"
    root.mkdir()
    p = KP.write_model_files(str(root), KP.grid_model(3, 2))
    stl_bytes = open(p["stl"], "rb").read()
    doc = json.load(open(p["gltf"]))
    doc["accessors"][1]["bufferView"] = 7
    tri = "v 0 0 0\nv 1 0 0\nv 1 1 0\nf 1 2 3\n"
    files = {"cut_face.obj": tri + "f 1 3",
             "short.obj": tri + "f 1 3 4\n",
             "cut.stl": stl_bytes[:84 + 50 * 5 + 20],
             "broken.gltf": json.dumps(doc),
             "notglb.glb": b"glTF\x02\x00\x00\x00junk"}
    src = "".join(f"O {fn} 0 0 0\n" for fn in files) + "S 0 0 0 1\n"
    jsp, tsp = _parse_both(tmp_path, src, files)
    assert dataclasses.asdict(jsp) == dataclasses.asdict(tsp)
    assert [m.loaded for m in tsp.models] == [True, False, True, False, False]
    tc = _packed(jsp, tsp)
    assert int((tc.shape > 0).sum()) == 1 + 5 + 1      # cut_face, 5 STL triangles, sphere


def test_obj_cut_in_a_vertex_line(tmp_path):
    """An OBJ cut inside a vertex line: the JAX package's Python parser
    raises on it (its compiled parser, when built, reads the missing
    coordinate as 0); the port parses in Python, so the model is left
    unloaded, with no cobjs, and the scene loads."""
    from w3d.scene import model3d as JM3
    text = "v 0 0 0\nv 1 0 0\nv 1 1"
    with pytest.raises(IndexError):
        JM3._parse_obj_python(text.encode())
    (tmp_path / "cut.obj").write_text(text)
    (tmp_path / "scene.txt").write_text("O cut.obj 0 0 0\nS 0 0 0 1\n")
    sp = TSC.parse_coll_obj_file(str(tmp_path / "scene.txt"))
    assert [m.loaded for m in sp.models] == [False] and len(sp.cobjs) == 1


def test_model_rows_load_any_format(tmp_path):
    """City model rows naming a glTF, an STL and an unreadable PLY: the
    readable ones load through `load_model` as in the JAX package, the
    unreadable one takes the procedural fallback in both, and a file
    that loads as an empty mesh raises in both."""
    root = tmp_path / "m"
    root.mkdir()
    p = KP.write_model_files(str(root), KP.grid_model(4, 3))
    files = {"cars/car.gltf": open(p["gltf"]).read(),
             "people/ped.stl": open(p["stl"], "rb").read(),
             "helis/heli.ply": "ply\nformat ascii 1.0\nelement vertex 3\nproperty float x\n"
                               "end_header\n1\n",
             "cars/empty.off": "OFF\n0 0 0\n"}
    cfg = ("city car_model cars/car.gltf 1 0 0  22 -1 90  1 1.0 1.0\n"
           "city ped_model people/ped.stl 1 0 1  -1 -1 0  1 1.0 1.0  0.7 1\n"
           "city helicopter_model helis/heli.ply 1 0 5  -1 -1 0  1 2.5 1.0  1\n"
           "city car_model cars/empty.off 1 0 0  22 -1 0  1 1.0 1.0\n")
    for d in two_copies(tmp_path, {}):
        for fn, data in files.items():
            (d / fn).parent.mkdir(parents=True, exist_ok=True)
            (d / fn).write_bytes(data if isinstance(data, bytes) else data.encode())
        (d / "config_city.txt").write_text(cfg)
    specs = [mod.parse_city_models(str(tmp_path / name / "config_city.txt"))
             for mod, name in ((JMI, "jax"), (TMI, "port"))]
    for kind, i in (("car", 0), ("ped", 0), ("helicopter", 0)):
        j = JMI._resolve_mesh_uncached(specs[0][kind][i], str(tmp_path / "jax"))
        t = TMI._resolve_mesh_uncached(specs[1][kind][i], str(tmp_path / "port"))
        same_model(t, j)
    assert TMI._resolve_mesh_uncached(specs[1]["car"][0], str(tmp_path / "port")).num_faces == 24
    for mod, i in ((JMI, 0), (TMI, 1)):
        with pytest.raises(ValueError):
            mod._resolve_mesh_uncached(specs[i]["car"][1],
                                       str(tmp_path / ("jax", "port")[i]))

"""glTF 2.0 loader (.gltf JSON + .bin, and .glb binary container); port of
`3dworld_tpu/scene/read_gltf.py` (pure host code, copied).

The reference routes "everything else" through Assimp, whose dominant
modern interchange format is glTF (model3d.h:205-254 consumes the same
data: positions/normals/uvs/indices + <=4-bone skins and animation
channels).  This is a dependency-free reader of the glTF subset those
structures need:

* meshes: POSITION / NORMAL / TEXCOORD_0 attributes + indices,
  triangles only, all primitives merged into one Model3d;
* skins: JOINTS_0 / WEIGHTS_0 (4 per vertex) + inverseBindMatrices,
  surfaced for scene/animation.py's LBS skinning;
* animations: translation/rotation/scale samplers per joint.

Component types and accessor layouts per the public glTF 2.0 spec.
A file that is not a GLB, or a GLB without a JSON chunk, raises
`ValueError` here (the JAX package asserts, or fails on the missing
document), so a scene's `O` command leaves such a model unloaded in both
packages.
"""

from __future__ import annotations

import base64
import json
import os
import struct

import numpy as np

from .model3d import Model3d

_COMP_DTYPE = {5120: np.int8, 5121: np.uint8, 5122: np.int16,
               5123: np.uint16, 5125: np.uint32, 5126: np.float32}
_TYPE_N = {"SCALAR": 1, "VEC2": 2, "VEC3": 3, "VEC4": 4, "MAT4": 16}


def _load_buffers(doc: dict, base_dir: str, glb_bin: bytes | None):
    bufs = []
    for b in doc.get("buffers", []):
        uri = b.get("uri")
        if uri is None:
            bufs.append(glb_bin)
        elif uri.startswith("data:"):
            bufs.append(base64.b64decode(uri.split(",", 1)[1]))
        else:
            with open(os.path.join(base_dir, uri), "rb") as f:
                bufs.append(f.read())
    return bufs


def _accessor(doc, bufs, idx):
    acc = doc["accessors"][idx]
    view = doc["bufferViews"][acc["bufferView"]]
    buf = bufs[view["buffer"]]
    dt = _COMP_DTYPE[acc["componentType"]]
    n = _TYPE_N[acc["type"]]
    count = acc["count"]
    offset = view.get("byteOffset", 0) + acc.get("byteOffset", 0)
    stride = view.get("byteStride", 0)
    itemsize = np.dtype(dt).itemsize * n
    if stride and stride != itemsize:   # interleaved
        raw = np.frombuffer(buf, np.uint8, count * stride, offset)
        raw = raw.reshape(count, stride)[:, :itemsize].tobytes()
        a = np.frombuffer(raw, dt)
    else:
        a = np.frombuffer(buf, dt, count * n, offset)
    return a.reshape(count, n) if n > 1 else a


def _parse_glb(data: bytes):
    magic, _ver, _length = struct.unpack("<III", data[:12])
    if magic != 0x46546C67:
        raise ValueError("not a GLB file")
    pos = 12
    doc = None
    binchunk = None
    while pos < len(data):
        clen, ctype = struct.unpack("<II", data[pos:pos + 8])
        chunk = data[pos + 8:pos + 8 + clen]
        pos += 8 + clen
        if ctype == 0x4E4F534A:          # 'JSON'
            doc = json.loads(chunk)
        elif ctype == 0x004E4942:        # 'BIN\0'
            binchunk = chunk
    if doc is None:
        raise ValueError("GLB file without a JSON chunk")
    return doc, binchunk


def load_gltf(path: str):
    """Load a .gltf/.glb -> (Model3d, skin_dict | None).

    skin_dict: {"joints": [V,4] int32, "weights": [V,4] f32,
    "inverse_bind": [J,4,4] f32, "animations": {name: {joint_ix:
    {"t": [K], "translation"/"rotation"/"scale": [K, .]}}}}.
    """
    base_dir = os.path.dirname(os.path.abspath(path))
    if path.endswith(".glb"):
        with open(path, "rb") as f:
            doc, glb_bin = _parse_glb(f.read())
    else:
        with open(path) as f:
            doc = json.load(f)
        glb_bin = None
    bufs = _load_buffers(doc, base_dir, glb_bin)

    pos_l, nrm_l, uv_l, fac_l = [], [], [], []
    joints_l, weights_l = [], []
    any_skinned = False
    voff = 0
    for mesh in doc.get("meshes", []):
        for prim in mesh.get("primitives", []):
            if prim.get("mode", 4) != 4:
                continue                 # triangles only
            att = prim["attributes"]
            any_skinned |= "JOINTS_0" in att
            p = _accessor(doc, bufs, att["POSITION"]).astype(np.float32)
            V = len(p)
            pos_l.append(p)
            nrm_l.append(_accessor(doc, bufs, att["NORMAL"])
                         .astype(np.float32) if "NORMAL" in att
                         else np.zeros((V, 3), np.float32))
            uv_l.append(_accessor(doc, bufs, att["TEXCOORD_0"])
                        .astype(np.float32) if "TEXCOORD_0" in att
                        else np.zeros((V, 2), np.float32))
            if "indices" in prim:
                ix = _accessor(doc, bufs, prim["indices"]).astype(np.int32)
            else:
                ix = np.arange(V, dtype=np.int32)
            fac_l.append(ix.reshape(-1, 3) + voff)
            if "JOINTS_0" in att:
                joints_l.append(_accessor(doc, bufs, att["JOINTS_0"])
                                .astype(np.int32))
                wacc = doc["accessors"][att["WEIGHTS_0"]]
                w = _accessor(doc, bufs, att["WEIGHTS_0"]).astype(np.float32)
                # normalized-integer weights (ubyte/ushort per spec)
                # need the normalization divide
                if wacc["componentType"] == 5121:
                    w = w / 255.0
                elif wacc["componentType"] == 5123:
                    w = w / 65535.0
                weights_l.append(w)
            else:
                # keep skin arrays ALIGNED with the merged vertex buffer:
                # unskinned primitives contribute zero weights
                joints_l.append(np.zeros((V, 4), np.int32))
                weights_l.append(np.zeros((V, 4), np.float32))
            voff += V

    positions = np.concatenate(pos_l) if pos_l else np.zeros((0, 3), np.float32)
    faces = np.concatenate(fac_l) if fac_l else np.zeros((0, 3), np.int32)
    model = Model3d(
        positions=positions,
        normals=np.concatenate(nrm_l) if nrm_l else np.zeros((0, 3), np.float32),
        uvs=np.concatenate(uv_l) if uv_l else np.zeros((0, 2), np.float32),
        faces=faces,
        face_normals=faces.copy(),     # per-vertex attrs share vertex ids
        face_uvs=faces.copy(),
    )

    skin = None
    if doc.get("skins") and any_skinned:
        sk = doc["skins"][0]
        # glTF MAT4 accessors are COLUMN-major; animation.py composes
        # row-major (world @ inv_bind), so transpose each matrix
        ibm = None
        if "inverseBindMatrices" in sk:
            ibm = _accessor(doc, bufs, sk["inverseBindMatrices"]) \
                .astype(np.float32).reshape(-1, 4, 4).transpose(0, 2, 1)
        skin = {
            "joints": np.concatenate(joints_l),
            "weights": np.concatenate(weights_l),
            "inverse_bind": ibm,
            "animations": {},
        }
        node_to_joint = {n: j for j, n in enumerate(sk.get("joints", []))}
        for anim in doc.get("animations", []):
            chans = {}
            for ch in anim.get("channels", []):
                tgt = ch["target"]
                j = node_to_joint.get(tgt.get("node"))
                if j is None:
                    continue
                samp = anim["samplers"][ch["sampler"]]
                t = _accessor(doc, bufs, samp["input"]).astype(np.float32)
                v = _accessor(doc, bufs, samp["output"]).astype(np.float32)
                if tgt["path"] == "rotation":
                    # glTF quats are (x,y,z,w); animation._quat_to_mat
                    # consumes (w,x,y,z)
                    v = v[:, [3, 0, 1, 2]]
                chans.setdefault(j, {})["t"] = t
                chans[j][tgt["path"]] = v
            skin["animations"][anim.get("name", f"anim{len(skin['animations'])}")] = chans
    return model, skin

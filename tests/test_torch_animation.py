"""Torch port vs JAX package: skeletal animation (`scene/animation`).

`make_simple_skeleton`, `sample_channel` and `evaluate_pose` are host
numpy in both packages and exact.  `skin_vertices` is tensor code: the
port gathers each influence's bone matrix by index (the JAX package
multiplies a one-hot matrix, which is exact in float32) and sums the
products in a fixed order, the JAX package in XLA's; held at atol 1e-6
against the compiled JAX function, with skins carried across by
`convert.skin_weights` and a glTF skin read by both packages."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

import w3d  # noqa: F401
from w3d.scene import animation as JA

from w3d_torch import convert
from w3d_torch.scene import animation as TA

from torch_port_util import one_torch_thread  # noqa: F401


def _channels(mod, nb, seed=0):
    """Keyframed channels on every other bone: 3 keys of translation,
    rotation (unit quaternions, one pair past 90 degrees apart so slerp
    flips a sign) and scale."""
    rng = np.random.default_rng(seed)
    out = {}
    for b in range(0, nb, 2):
        q = rng.standard_normal((3, 4)).astype(np.float32)
        q /= np.linalg.norm(q, axis=1, keepdims=True)
        q[2] = -q[1] + 0.01
        q[2] /= np.linalg.norm(q[2])
        out[b] = mod.AnimChannel(times=np.array([0.0, 0.5, 1.5], np.float32),
                                 trans=rng.uniform(-0.2, 0.2, (3, 3)).astype(np.float32),
                                 quats=q,
                                 scales=rng.uniform(0.8, 1.2, 3).astype(np.float32))
    return out


def test_skeleton_and_pose_match():
    nb = 12
    js, ts = JA.make_simple_skeleton(nb, 0.15), TA.make_simple_skeleton(nb, 0.15)
    for f in JA.Skeleton._fields:
        np.testing.assert_array_equal(getattr(ts, f), getattr(js, f))
    ts = convert.skeleton(js)
    jch, tch = _channels(JA, nb), {b: convert.anim_channel(c) for b, c in _channels(JA, nb).items()}
    for t in (-1.0, 0.0, 0.3, 0.5, 1.1, 2.0):
        for b in jch:
            for a, c in zip(TA.sample_channel(tch[b], t), JA.sample_channel(jch[b], t)):
                np.testing.assert_array_equal(np.asarray(a), np.asarray(c))
        out = TA.evaluate_pose(ts, tch, t, device="cpu")
        assert out.shape == (nb, 4, 4) and out.dtype == torch.float32
        np.testing.assert_array_equal(out.numpy(), np.asarray(JA.evaluate_pose(js, jch, t)))
    one = JA.AnimChannel(np.zeros(1, np.float32), np.ones((1, 3), np.float32),
                         np.array([[1, 0, 0, 0]], np.float32), np.ones(1, np.float32))
    assert all(np.array_equal(a, b) for a, b in zip(TA.sample_channel(one, 3.0),
                                                     JA.sample_channel(one, 3.0)))


@pytest.mark.parametrize("nb,nv", [(8, 1000), (32, 4096)])
def test_skin_vertices_match(nb, nv):
    rng = np.random.default_rng(nb)
    js = JA.make_simple_skeleton(nb)
    mats = np.asarray(JA.evaluate_pose(js, _channels(JA, nb, seed=nb), 0.7))
    pos = rng.uniform(-1, 1, (nv, 3)).astype(np.float32)
    ids = rng.integers(0, nb, (nv, 4)).astype(np.int32)
    w = rng.random((nv, 4)).astype(np.float32)
    w /= w.sum(1, keepdims=True)
    jsw = JA.SkinWeights(jnp.asarray(ids), jnp.asarray(w))
    ref = np.asarray(JA.skin_vertices(jnp.asarray(pos), jsw, jnp.asarray(mats)))
    tsw = convert.skin_weights(JA.SkinWeights(ids, w), "cpu")
    out = TA.skin_vertices(torch.as_tensor(pos), tsw, torch.as_tensor(mats))
    assert out.shape == (nv, 3)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-6)
    assert np.abs(ref - pos).max() > 0.05          # the pose moved the vertices


def test_gltf_skin_drives_skinning(tmp_path):
    """A glTF skin (two joints, normalized ubyte weights) read by both
    packages and skinned by each with the same pose."""
    import base64
    import json
    from w3d.scene.read_gltf import load_gltf as jload
    from w3d_torch.scene.read_gltf import load_gltf as tload

    pos = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [1, 1, 0]], np.float32)
    idx = np.array([0, 1, 2, 1, 3, 2], np.uint16)
    joints = np.array([[0, 1, 0, 0]] * 4, np.uint8)
    wts = np.array([[255, 0, 0, 0], [128, 127, 0, 0], [64, 191, 0, 0], [0, 255, 0, 0]],
                   np.uint8)
    blobs = [pos.tobytes(), idx.tobytes(), joints.tobytes(), wts.tobytes()]
    offs, buf = [], b""
    for b in blobs:
        offs.append(len(buf))
        buf += b + b"\0" * (-len(b) % 4)
    doc = {"asset": {"version": "2.0"},
           "buffers": [{"byteLength": len(buf), "uri": "data:application/octet-stream;base64,"
                        + base64.b64encode(buf).decode()}],
           "bufferViews": [{"buffer": 0, "byteOffset": o, "byteLength": len(b)}
                           for o, b in zip(offs, blobs)],
           "accessors": [{"bufferView": 0, "componentType": 5126, "count": 4, "type": "VEC3"},
                         {"bufferView": 1, "componentType": 5123, "count": 6, "type": "SCALAR"},
                         {"bufferView": 2, "componentType": 5121, "count": 4, "type": "VEC4"},
                         {"bufferView": 3, "componentType": 5121, "count": 4, "type": "VEC4",
                          "normalized": True}],
           "meshes": [{"primitives": [{"attributes": {"POSITION": 0, "JOINTS_0": 2,
                                                      "WEIGHTS_0": 3}, "indices": 1}]}],
           "nodes": [{"mesh": 0, "skin": 0}, {"name": "a"}, {"name": "b"}],
           "skins": [{"joints": [1, 2]}]}
    (tmp_path / "s.gltf").write_text(json.dumps(doc))
    jm, jskin = jload(str(tmp_path / "s.gltf"))
    tm, tskin = tload(str(tmp_path / "s.gltf"))
    js = JA.make_simple_skeleton(2, 0.5)
    ch = _channels(JA, 2, seed=3)
    mats = JA.evaluate_pose(js, ch, 0.9)
    ref = JA.skin_vertices(jnp.asarray(jm.positions),
                           JA.SkinWeights(jnp.asarray(jskin["joints"]),
                                          jnp.asarray(jskin["weights"])), mats)
    out = TA.skin_vertices(torch.as_tensor(tm.positions),
                           TA.SkinWeights(torch.as_tensor(tskin["joints"]),
                                          torch.as_tensor(tskin["weights"])),
                           TA.evaluate_pose(convert.skeleton(js), ch, 0.9, device="cpu"))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=1e-6)

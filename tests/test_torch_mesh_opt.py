"""Torch port vs JAX package: mesh optimization (`scene/mesh_opt`), host
numpy in both, every result exact: the ACMR, the min-index sort, Tipsify
(against the JAX package's Python walk and, where it is built, its
compiled one), `optimize_indices` and the half-edge collapse of
`simplify` and `simplify_model`, on shuffled grid meshes and a closed
one."""

import numpy as np
import pytest

import w3d  # noqa: F401
from w3d.scene import mesh_opt as JMO

from w3d_torch.scene import mesh_opt as TMO
from w3d_torch.utils import kernel_probe as KP


def _shuffled(cx, cy, seed):
    m = KP.grid_model(cx, cy)
    rng = np.random.default_rng(seed)
    return m._replace(faces=m.faces[rng.permutation(len(m.faces))])


def _closed():
    """An octahedron subdivided twice: no boundary vertices."""
    v = [(1, 0, 0), (-1, 0, 0), (0, 1, 0), (0, -1, 0), (0, 0, 1), (0, 0, -1)]
    f = [(0, 2, 4), (2, 1, 4), (1, 3, 4), (3, 0, 4), (2, 0, 5), (1, 2, 5), (3, 1, 5), (0, 3, 5)]
    verts = [np.array(p, np.float64) for p in v]
    for _ in range(2):
        mid, nf = {}, []

        def m(a, b):
            k = (min(a, b), max(a, b))
            if k not in mid:
                p = verts[a] + verts[b]
                verts.append(p / np.linalg.norm(p))
                mid[k] = len(verts) - 1
            return mid[k]
        for a, b, c in f:
            ab, bc, ca = m(a, b), m(b, c), m(c, a)
            nf += [(a, ab, ca), (ab, b, bc), (ca, bc, c), (ab, bc, ca)]
        f = nf
    return np.asarray(verts, np.float32), np.asarray(f, np.int32)


@pytest.mark.parametrize("seed", [0, 1])
def test_reorder_matches(seed):
    m = _shuffled(24, 16, seed)
    idx = m.faces.reshape(-1)
    nv = m.num_verts
    for cache in (16, 32):
        assert TMO.calc_acmr(idx, cache) == JMO.calc_acmr(idx, cache)
    np.testing.assert_array_equal(TMO.sort_by_min_ix(idx), JMO.sort_by_min_ix(idx))
    quads = idx[: (len(idx) // 4) * 4]
    np.testing.assert_array_equal(TMO.sort_by_min_ix(quads, 4), JMO.sort_by_min_ix(quads, 4))
    t = TMO.tipsify(idx, nv)
    np.testing.assert_array_equal(t, JMO.tipsify(idx, nv, use_native=False))
    np.testing.assert_array_equal(t, JMO.tipsify(idx, nv))
    assert TMO.calc_acmr(t) < TMO.calc_acmr(idx)
    for full in (True, False):
        a, b = TMO.optimize_indices(idx, nv, full_opt=full), JMO.optimize_indices(idx, nv, full_opt=full)
        np.testing.assert_array_equal(a[0], b[0])
        assert a[1:] == b[1:]
    # a stream too short to reorder comes back as it is
    a, b = TMO.optimize_indices(idx[:30], nv), JMO.optimize_indices(idx[:30], nv)
    np.testing.assert_array_equal(a[0], b[0])
    assert a[1:] == b[1:] == (0.0, 0.0)


@pytest.mark.parametrize("target", [0.3, 0.7])
def test_simplify_matches(target):
    m = _shuffled(20, 12, 3)
    a = TMO.simplify(m.positions, None, m.faces.reshape(-1), target)
    b = JMO.simplify(m.positions, None, m.faces.reshape(-1), target)
    np.testing.assert_array_equal(a, b)
    assert len(a) < m.faces.size
    pos, faces = _closed()
    nrm = pos.copy()
    a = TMO.simplify(pos, nrm, faces.reshape(-1), target)
    np.testing.assert_array_equal(a, JMO.simplify(pos, nrm, faces.reshape(-1), target))
    sm, jm = TMO.simplify_model(m, target), JMO.simplify_model(m, target)
    for f in sm._fields:
        np.testing.assert_array_equal(getattr(sm, f), getattr(jm, f))

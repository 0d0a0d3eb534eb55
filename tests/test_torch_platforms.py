"""Torch port vs JAX package: moving platforms and triggers
(`physics/platforms`).

A scene with continuous, triggered, rotating (spinning, and reversing),
never-reversing (`rdelay < 0`) and proximity-triggered (`act_dist`)
platforms is parsed by each package; `build_platforms` and
`triggers_from_specs` must give equal tensors.  Then 80 frames of the
ground frame's platform pass: `eval_triggers` (point and region triggers)
over objects that walk through the triggers, `advance_platforms` fed with
those activations, `rider_deltas` for objects standing on platform tops
(two tied translation cubes under one rider, two rotating cobjs under
another: the first contact wins) and `apply_platform_motion`.  The state
machine runs on its own in each package for all 80 frames (state ints
exact, times and distances 1e-6); motion and riders each frame from the
JAX package's inputs, 1e-6."""

import numpy as np
import jax.numpy as jnp
import torch

import w3d  # noqa: F401
from w3d.physics import platforms as JP
from w3d.scene import cobj as JSC

from w3d_torch import convert
from w3d_torch.physics import platforms as TP
from w3d_torch.scene import cobj as TSC

from torch_port_util import np_tree

SCENE = """
Q 1  2.0 2.0 0.1 0.2  1.0 0.0  0 0 0  0 0 1  1
B -1 -0.5 -1 -0.5 0 0.2
B -1 -0.5 -1 -0.5 0 0.2
K 1 1 0.5  0.4 0 0  0 0
K 0 0 0  0 0 0  0 0 -1  1.5 2.5 1.5 2.5 0 1
Q 1  1.0 1.5 0.0 0.5  0.5 0.0  0 0 0  1 0 0  0
B 0.5 1.0 0.5 1.0 0 0.2
K
Q 1  4.0 0.0 0.0 0.0  6.2831853 0.0  2.1 0 0.1  0 0 1  1 1
B 2.0 2.4 -0.2 0.2 0 0.2
P 3  2 0 0.3  2.5 0 0.3  2 0.5 0.3  0.05
Q 1  1.0 1.0 0.0 -1.0  0.3 0.0  0 0 0  0 1 0  1
B -2 -1.5 1 1.5 0 0.2
Q 1  3.2 3.2 0.05 0.1  1.0 0.0  2.3 0.1 0  1 0 0  1 1
B 2.1 2.5 -0.1 0.3 0 0.2
Q 1  1.0 1.0 0.0 0.0  0.4 0.6  3 3 0  0 0 1  0
B 2.8 3.2 2.8 3.2 0 0.2
Q 0
B -4 4 -4 4 -1 -0.5
"""
FRAMES = 80
RAD = 0.05


def _scene(tmp_path):
    (tmp_path / "scene.txt").write_text(SCENE)
    jsp = JSC.parse_coll_obj_file(str(tmp_path / "scene.txt"))
    tsp = TSC.parse_coll_obj_file(str(tmp_path / "scene.txt"))
    assert not tsp.skipped and len(tsp.platforms) == 6
    return jsp, tsp


def _close(a, b, tol, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, what
    assert a.dtype.kind != "f" or np.abs(a - b).max(initial=0.0) <= tol, \
        (what, np.abs(a - b).max())
    if a.dtype.kind != "f":
        np.testing.assert_array_equal(a, b.astype(a.dtype), err_msg=what)


def _objects(k):
    """Objects at frame k: 8 walkers crossing the triggers (the point
    trigger at (1, 1, 0.5), the region over [1.5, 2.5]^2, p5's act_dist
    sphere at (3, 3, 0)), then the riders on platform tops."""
    t = k / FRAMES
    walk_x = np.array([1.0, 1.0, 2.0, 3.0, -3.0, 0.0, 3.0, 2.9]) + 0.4 * np.sin(7 * t + np.arange(8))
    walk_y = np.array([1.0, 1.2, 2.0, 3.0, 3.0, 0.0, -3.0, 3.1]) + 0.4 * np.cos(5 * t + np.arange(8))
    walk_z = np.full(8, 0.5 if k % 20 < 10 else 3.0)
    riders = np.array([[-0.75, -0.75], [0.75, 0.75], [2.2, 0.0], [2.15, -0.15],
                       [-1.75, 1.25], [3.0, 3.0], [0.0, 0.0]])
    px = np.concatenate([walk_x, riders[:, 0]]).astype(np.float32)
    py = np.concatenate([walk_y, riders[:, 1]]).astype(np.float32)
    pz = np.concatenate([walk_z, np.full(len(riders), 0.2 + RAD)]).astype(np.float32)
    status = np.array([1] * 8 + [4, 2, 4, 4, 4, 2, 1], np.int32)
    return px, py, pz, status


def _on(c, i, x, y, z) -> bool:
    """Whether a rider at (x, y, z) stands on cobj i (rider_deltas' test)."""
    lo = np.minimum(np.asarray(c.p1)[i], np.asarray(c.p2)[i])
    hi = np.maximum(np.asarray(c.p1)[i], np.asarray(c.p2)[i])
    return bool(lo[0] <= x <= hi[0] and lo[1] <= y <= hi[1]
                and abs(z - RAD - hi[2]) < 0.05)


def test_build_matches_jax(tmp_path):
    jsp, tsp = _scene(tmp_path)
    for jv, tv in ((JP.build_platforms(jsp.platforms), TP.build_platforms(tsp.platforms, device="cpu")),
                   (JP.triggers_from_specs(jsp.platforms),
                    TP.triggers_from_specs(tsp.platforms, device="cpu"))):
        assert jv._fields == tv._fields
        for name in tv._fields:
            a, b = np.asarray(getattr(jv, name)), getattr(tv, name).numpy()
            assert a.dtype == b.dtype, name
            np.testing.assert_array_equal(a, b, err_msg=name)
    tr = TP.triggers_from_specs(tsp.platforms, device="cpu")
    assert tr.platform.tolist() == [1, 1, 5] and bool((tr.region[1] != 0).any())
    mp = (JP.make_platforms([0, 1], [[0, 0, 1], [2, 0, 0]], 0.05),
          TP.make_platforms([0, 1], [[0, 0, 1], [2, 0, 0]], 0.05, device="cpu"))
    for name in TP.PlatformSet._fields:
        a, b = np.asarray(getattr(mp[0], name)), getattr(mp[1], name).numpy()
        np.testing.assert_array_equal(a, b, err_msg=name)
    empty = TP.build_platforms([], device="cpu")
    assert empty.size == 0 and TP.triggers_from_specs([], device="cpu").x.shape == (0,)


def test_platform_frames_match_jax(tmp_path):
    jsp, tsp = _scene(tmp_path)
    jp, tp = JP.build_platforms(jsp.platforms), TP.build_platforms(tsp.platforms, device="cpu")
    jtr, ttr = JP.triggers_from_specs(jsp.platforms), TP.triggers_from_specs(tsp.platforms, device="cpu")
    jc = JSC.pack_cobjs(jsp)
    seen = {"fired": set(), "states": set(), "sum_tie": False, "rot_tie": False,
            "spun": False}
    for k in range(FRAMES):
        px, py, pz, status = _objects(k)
        jin = [jnp.asarray(a) for a in (px, py, pz)]
        tin = [torch.as_tensor(a) for a in (px, py, pz)]
        # triggers: bitwise
        jtrig = JP.eval_triggers(jtr, *jin, jp)
        ttrig = TP.eval_triggers(ttr, *tin, tp)
        np.testing.assert_array_equal(np.asarray(jtrig), ttrig.numpy(), err_msg=f"frame {k}")
        seen["fired"] |= set(np.flatnonzero(np.asarray(jtrig)).tolist())
        # the state machine, each package on its own state
        jp, jmx, jmy, jmz = JP.advance_platforms(jp, jtrig)
        tp, tmx, tmy, tmz = TP.advance_platforms(tp, ttrig)
        for name in ("state", "ns_time", "dist", "is_stopped", "active_time"):
            _close(getattr(jp, name), getattr(tp, name).numpy(), 1e-6, f"frame {k} {name}")
        for a, b, name in ((jmx, tmx, "mx"), (jmy, tmy, "my"), (jmz, tmz, "mz")):
            _close(a, b.numpy(), 1e-6, f"frame {k} {name}")
        seen["states"] |= set(np.asarray(jp.state).tolist())
        seen["spun"] |= bool(np.asarray(jp.dist)[2] < np.asarray(jmx)[2])
        # riders and motion from the JAX package's inputs
        tpk = convert.platform_set(np_tree(jp), "cpu")
        tck = convert.cobj_set(np_tree(jc), "cpu")
        mx3 = [convert.array(a, "cpu") for a in (jmx, jmy, jmz)]
        rad = np.full(len(px), RAD, np.float32)
        jd = JP.rider_deltas(*jin, jnp.asarray(status), jc, jp, jmx, jmy, jmz,
                             jnp.asarray(rad))
        td = TP.rider_deltas(*tin, torch.as_tensor(status), tck, tpk, *mx3,
                             torch.as_tensor(rad))
        for a, b, name in zip(jd, td, ("dx", "dy", "dz")):
            _close(a, b.numpy(), 1e-6, f"frame {k} rider {name}")
        seen["sum_tie"] |= bool(abs(float(jd[2][8]) - 2 * float(jmz[0])) < 1e-7
                                and float(jmz[0]) != 0.0)
        # rider 10 on p2's cube (cobj 3, spinning about z) and p4's (cobj 6,
        # about x): the first contact, p2's, moves it within its plane
        seen["rot_tie"] |= bool(_on(jc, 3, px[10], py[10], pz[10])
                                and _on(jc, 6, px[10], py[10], pz[10])
                                and float(jmx[4]) != 0.0 and float(jd[2][10]) == 0.0
                                and float(np.hypot(jd[0][10], jd[1][10])) > 0.0)
        jc = JP.apply_platform_motion(jc, jp, jmx, jmy, jmz)
        tc2 = TP.apply_platform_motion(tck, tpk, *mx3)
        for name in TSC.CobjSet._fields:
            _close(getattr(jc, name), getattr(tc2, name).numpy(), 1e-6, f"frame {k} cobj {name}")
    assert seen["fired"] == {1, 5}, seen["fired"]
    assert seen["states"] >= {JP.ST_WAIT, JP.ST_FWD, JP.ST_CHDIR, JP.ST_REV}
    assert seen["sum_tie"] and seen["rot_tie"] and seen["spun"], seen
    assert int(np.asarray(jp.state)[3]) == JP.ST_CHDIR      # rdelay < 0: parked
    moved = np.abs(np.asarray(jc.p1) - np.asarray(JSC.pack_cobjs(jsp).p1)).max()
    assert moved > 0.1


def test_eval_triggers_without_regions():
    """Point triggers only, several per platform, and a platform without
    any: bitwise; a platform fires when any of its triggers does."""
    rg = np.random.default_rng(3)
    x, y, z = (rg.uniform(-2, 2, 9).astype(np.float32) for _ in range(3))
    r = rg.uniform(0.2, 1.0, 9).astype(np.float32)
    plat = np.array([0, 0, 1, 1, 1, 3, 3, 0, 1], np.int32)
    px, py, pz = (rg.uniform(-2, 2, 40).astype(np.float32) for _ in range(3))
    jtr = JP.make_triggers(x, y, z, r, plat)
    ttr = TP.make_triggers(x, y, z, r, plat, device="cpu")
    jp = JP.make_platforms(range(4), np.ones((4, 3)), 0.1)
    tp = TP.make_platforms(range(4), np.ones((4, 3)), 0.1, device="cpu")
    for k in range(5):
        sl = slice(8 * k, 8 * k + 8)
        a = np.asarray(JP.eval_triggers(jtr, jnp.asarray(px[sl]), jnp.asarray(py[sl]),
                                        jnp.asarray(pz[sl]), jp))
        b = TP.eval_triggers(ttr, torch.as_tensor(px[sl]), torch.as_tensor(py[sl]),
                             torch.as_tensor(pz[sl]), tp).numpy()
        np.testing.assert_array_equal(a, b)
        assert not b[2]

"""Torch port vs JAX package: the scene-DSL parser (`scene/cobj`), CSG
(`scene/csg`), OBJ models (`scene/model3d`) and cobj packing.

Every source goes through both packages' `parse_coll_obj_file` from its
own directory (each package writes its own `.model3d.npz` cache next to
its own copy of a model).  The two `SceneParse`s must be equal as
`dataclasses.asdict` trees, `skipped` and `ignored` included, and
`pack_cobjs` bitwise.  The sources cover every command family: the
command semantics the JAX tests pin (tests/test_scene_dsl.py,
tests/test_gaps.py:152-159) and the rest of the command set."""

import dataclasses
import os

import numpy as np
import pytest

import w3d  # noqa: F401
from w3d.scene import cobj as JSC

from w3d_torch.scene import cobj as TSC
from w3d_torch.scene import csg as TCSG
from w3d_torch.scene import model3d as TM3

SOURCES = {
    "transforms": """
t 1 2 3
S 0 0 0 0.5
m 2.0
S 1 0 0 0.5
M 0
S 1 0 0 0.5
s 0 1
S 1 2 0 0.5
R
T 0 0 0
m 1.0
S 1 2 3 0.5
m 0
S 1 1 1 0.5
""",
    "shapes": """
B 0 1 0 2 0 3 0.25
B 0 1 0 1 0 1
cube 2 3 2 3 0 1
C 0 0 0  0 0 2  1.0 0.9
C 0 0 0  1 0 2  0.3 0.2
cylinder 5 5 0  5 5 1  0.2 0.2
k 0 0 0  0 1 1  0.2 0.1
capsule 1 1 1  2 2 2  0.1 0.1
z 0 0 1  0 0 2  0.5 0.1
torus 1 0 1  1 0 0  0.4 0.05
P 3  0 0 0  1 0 0  0 1 0  0.1
P 5  0 0 0  1 0 0  1 1 0  0.5 1.5 0  0 1 0  0.1 1
polygon 4  0 0 1  1 0 1  1 1 1  0 1 1  0.05
c 0 0 0  0 0 2  1.0 0.9  8
c 0 0 2  0 0 0  1.0 0.9  8 2 5
c 0 2 0  0 0 0  1.0 0.9  6
B 0 1 0 1 0 0.2
D 0.5 0 0.2 4
B 0 1 0 1 0 0.2
D 0 1 0 2  0.1 0 0
""",
    "csg_negative": """
B 0 4 0 4 0 1
n 1
B 1 3 1 3 0 1
S 2 2 2 0.5
n 0
B 0 1 0 1 2 3
""",
    "materials": """
l 0.8 0.5 0.6 0.7 1.0 -1 1 1.33 0.4 1
r 0.9 60.0
r 0.5 20.0 1 0.5 0.25
metalness 0.7
density 2.5
damage 10.0
destroy_prob 300
J steel
l 0.1 1 1 1 1 stone_tex 0
S 0 0 0 1
j steel
S 2 0 0 1
e 63
y 2.0
Y 0.5 0.25 1
X normal.png 1 0
a 2
d 1
movable 0
v 1
reflective 1
cube_map_ref 1
B 0 1 0 1 0 1
j missing
S 3 0 0 1
""",
    "lights": """
L 0.5 0.8  1 2 3  1.0 0.9 0.8 1.0
L 0.0 1.0  0 0 5  1 1 1 1  0 0 -1  0.3 0.1
L 0.0 1.0  0 0 1  1 0 0 1  4 0 1  1.0 0.0 1
V 1 2 3
L 0.2 1.0  0 0 2  1 1 1 1  0 0 0  1.0 0.1 0 2 64
light_rotate 0 0 1  2.5
dynamic_indir 1
outdoor_shadows 1
U group_a 0.5
L 0.0 1.0  3 3 3  1 1 1 1  0 1 0  0.5
light 0.0 0.5  1 1 1  1 1 1 1
bind_light 0 0 0
b 0 1 0 1 0 1  0.2 0.4 0.9  1.5 1000 0
b 0 1 0 1 0 1  0.2 0.4 0.9  1.5 1000 1 3
cube_light 0 1 0 1 0 1  0.5  1 1 1 1
indir_dlight_group group_b
""",
    "platforms_triggers": """
l 0.8 1.0 1.0 1.0 1.0 -1
sound_file click.wav
K 1 1 0.5  2.0 0.0 5.0  1 0
K 2 2 0.5  1.0 0.0 0.0  0 1 7  0 1 0 1 0 1
Q 1  1.0 1.0 0.0 0.0  2.0 0.0  0 0 0  0 0 1  0
B 0 1 0 1 0 0.2
L 0.0 1.0  0 0 1  1 1 1 1
K
Q 1  2.0 2.0 0.0 0.0  1.0 0.0  0 0 0  1 0 0  1
B 0.0 1.0 0.0 1.0 0.0 0.2
Q 1  0.5 0.0 1.0 -1.0  1.5 0.7  1 1 0  0 0 1  1 1 1 1
P 3  0 0 0  1 0 0  0 1 0  0.1
platform 0
trigger
sensor light 1 2 3 1 0.5
sensor timer
B 5.0 6.0 5.0 6.0 0.0 0.2
""",
    "gameplay": """
x 0 0 1  5 5 1  0.5 0 1
teleporter 1 1 1  2 2 2  0.2
jump_pad 1 1 0 0.4  0 0 3
A 1 2
A 1 2 3
p 1 0.5 0.5
p 2 0.5 0.5 1.5
I 3 1 10.0 1 1
I 3 1 10.0 1 1 0.5
keycard 2 1 0 0  3 3
popup_text "hello there" 1 1 0  2.0 5.0  0 0 1  1.5 1
f 0.5 0.1 1.0  2 2 0
w 1.0 1.0 0.25
w 1.0 1.0 0.25 0.5
w 1.0 1.0 0.25 0.5  0.1 0.2 0.3 0.05
W -1 1 -1 1 0.5 10.0
N 0 0 0  1 0 0  1 1 0  0 1 0
N 0 0 0  1 0 0  1 1 0  0 1 0  0 0 1
start_cobj_group
B 0 1 0 1 0 1
end_cobj_group
start_draw_group
B 2 3 0 1 0 1
end_draw_group
place_sound wind.wav 1 2 3
place_sound wind.wav 1 2 3 0.5 2.0
lighting_file_sky_model sky.bin 1 2 3 4
""",
    "vegetation": """
g 1.5 1.0 1.0 1
E 0 0 40 2
E 1 1 40 2 0.5 1
F 1 1 0.5 0.1 0
F 1 1 0.5 0.1 0 0.25
G 2 2 0.3 0.05 1
G 2 2 0.3 0.05 -2 0.1
H 3 3 0.5 0 4 20 0
H 3 3 0.5 0 4 20 0  0 1 0 1 0 1
""",
    "misc_and_unknown": """
/* block
comment */ S 0 0 0 1 # line comment
frobnicate 1 2
S 1 0 0
B 1 2 3
P 2  0 0 0  1 1 1  0.1
V 1 1 1
movable 1
S 2 0 0 1
q
S 9 9 9 1
""",
    "tj": """
tj 1
B 0 2 0 1 0 1
B 0 1 0 1 1 2
l 0.3 1 1 1 1 -1
B 5 6 5 6 0 1
B 5 7 5 6 1 2
S 0 0 5 0.5
""",
    "rand_spheres": """
t 5 0 0
m 2
rand_spheres 12  0 0 0  1.0 0.05 0.15
l 0.4 1 0 0 1 -1
rand_spheres 4  1 1 0  0.5 0.1 0.1
S 0 0 0 0.1
""",
}

# sphere_gen keywords for the rand_spheres source (config "sphere_gen k v")
SPHERE_GEN = {"rand_seed": "5", "enable_reflect": "1", "enable_transparent": "1",
              "enable_light_atten": "1", "metal_prob": "0.3",
              "emissive_prob": "0.4", "metal_white_prob": "0.5",
              "emiss_white_prob": "0.5", "max_light_atten": "0.6",
              "max_light_radius": "0.8"}


def _parse_both(tmp_path, src, files=None, **kw):
    """Write `src` (and `files`) into a directory per package and parse
    each with its own package."""
    out = []
    for name, mod in (("jax", JSC), ("port", TSC)):
        d = tmp_path / name
        d.mkdir(parents=True)
        for fn, text in (files or {}).items():
            (d / fn).write_text(text)
        (d / "scene.txt").write_text(src)
        out.append(mod.parse_coll_obj_file(str(d / "scene.txt"), **kw))
    return out


def _check_pack(jsp, tsp, **kw):
    jc = JSC.pack_cobjs(jsp, **kw)
    tc = TSC.pack_cobjs(tsp, device="cpu", **kw)
    for name in TSC.CobjSet._fields:
        a, b = np.asarray(getattr(jc, name)), getattr(tc, name).numpy()
        assert a.shape == b.shape, name
        np.testing.assert_array_equal(a.astype(b.dtype), b, err_msg=name)
    return tc


@pytest.mark.parametrize("name", sorted(SOURCES))
def test_parse_matches_jax(tmp_path, name):
    kw = dict(sphere_gen_seed=7, sphere_gen=SPHERE_GEN) if name == "rand_spheres" else {}
    jsp, tsp = _parse_both(tmp_path, SOURCES[name], **kw)
    assert dataclasses.asdict(jsp) == dataclasses.asdict(tsp)
    _check_pack(jsp, tsp)
    _check_pack(jsp, tsp, apply_csg=False)
    # what each source exercises happened
    if name == "misc_and_unknown":
        assert {"frobnicate", "S", "P", "V"} <= set(tsp.skipped)
        assert tsp.cobjs[-1].movable and tsp.cobjs[-1].p1 == (2.0, 0.0, 0.0)  # 'q' ended it
    elif name == "materials":
        assert tsp.skipped == {"j": 1} and tsp.cobjs[1].layer.elasticity == 0.8
    elif name == "transforms":
        assert tsp.skipped == {"m": 1} and tsp.cobjs[-1].r1 == 0.5
    elif name == "platforms_triggers":
        assert not tsp.skipped and len(tsp.platforms) == 3
        assert len(tsp.platforms[0].triggers) == 2 and tsp.platforms[1].triggers == ()
        assert tsp.platforms[0].light_ids == [0] and tsp.platforms[2].is_rot
    else:
        assert not tsp.skipped, tsp.skipped


def test_csg_and_tj_pinned(tmp_path):
    """Negative-cube CSG carves the hole; `tj 1` splits same-layer cubes
    at each other's faces (two layers, two groups)."""
    jsp, tsp = _parse_both(tmp_path, SOURCES["csg_negative"])
    tc = _check_pack(jsp, tsp)
    live = int((tc.shape != 0).sum())
    assert live == 5           # 4 side pieces of the carved cube + the far cube
    p1, p2 = tc.p1[:live].numpy(), tc.p2[:live].numpy()
    inside = ((p1[:, 0] < 2) & (p2[:, 0] > 2) & (p1[:, 1] < 2) & (p2[:, 1] > 2))
    assert not inside.any()
    jsp, tsp = _parse_both(tmp_path / "tj", SOURCES["tj"])
    cubes = [c for c in tsp.cobjs if c.shape == TSC.COLL_CUBE]
    assert len(cubes) == 6     # each bottom cube split at x = 1 (and 6)
    xs = sorted({c.p1[0] for c in cubes} | {c.p2[0] for c in cubes})
    assert xs == [0.0, 1.0, 2.0, 5.0, 6.0, 7.0]
    assert TCSG.merge_cubes(cubes)[0].p2[0] == 2.0   # merging undoes the split


def test_rand_spheres_pinned(tmp_path):
    """A `sphere_gen` seed makes the placements, radii and materials
    repeatable and independent of `sphere_gen_seed`; the materials vary
    (metal, emissive spheres with their lights)."""
    src = SOURCES["rand_spheres"]
    a = _parse_both(tmp_path / "a", src, sphere_gen_seed=7, sphere_gen=SPHERE_GEN)
    b = _parse_both(tmp_path / "b", src, sphere_gen_seed=99, sphere_gen=SPHERE_GEN)
    assert dataclasses.asdict(a[1]) == dataclasses.asdict(b[1])
    spheres = [c for c in a[1].cobjs if c.shape == TSC.COLL_SPHERE]
    assert len(spheres) == 17
    assert len({c.layer.metalness for c in spheres[:12]}) == 2
    assert any(l.kind == "diffuse" for l in a[1].lights)
    assert all(abs(c.p1[2] - 2.0 * c.r1 / 2.0) < 1e-9 for c in spheres[:12])


def test_models_match_jax(tmp_path):
    """`O` loads an OBJ (quads fan-split), `Z` and `transform_array_2d`
    place more instances, `model_occlusion_cube` and the model settings
    apply; a missing model is skipped by both packages."""
    obj = ("v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\nv 0.5 0.5 1\nvn 0 0 1\nvt 0 0\n"
           "f 1/1/1 2/1/1 3/1/1 4/1/1\nf -5 -4 -1\n")
    src = ("model3d_fit_to_scene 1\nmodel_lod_scale 0.5\nt 0 0 1\n"
           "O quad.obj 0 0 0 0.1\nmodel_occlusion_cube 0 1 0 1 0 1\n"
           "Z 0  10 0 0\nZ 1  0 5 0  2.0  0 0 1  90.0\n"
           "transform_array_2d 2 2  1 0 0  0 1 0\n"
           "O missing.obj 0 0 0\nZ 0  1 1 1\ntransform_array_1d 3  1 0 0\n")
    jsp, tsp = _parse_both(tmp_path, src, files={"quad.obj": obj})
    assert dataclasses.asdict(jsp) == dataclasses.asdict(tsp)
    _check_pack(jsp, tsp)
    assert not tsp.skipped and [m.loaded for m in tsp.models] == [True, False]
    polys = [c for c in tsp.cobjs if c.shape == TSC.COLL_POLYGON]
    assert len(polys) == 3 * (1 + 2 + 3)         # identity, Z x2, array x3
    assert os.path.exists(tmp_path / "port" / "quad.obj.model3d.npz")
    m = TM3.load_obj(str(tmp_path / "port" / "quad.obj"))   # from the cache
    assert m.num_faces == 3 and m.face_normals[0, 0] == 0
    vn = TM3.compute_vertex_normals(m)
    assert np.isfinite(vn).all() and np.allclose(np.linalg.norm(vn, axis=1), 1.0)


def test_other_model_format_raises(tmp_path):
    """Unreadable models in another format than OBJ and in OBJ no longer
    raise: as in the JAX package, each is left unloaded with no cobjs and
    the scene loads (every format reads through read_mesh_formats; the
    formats themselves are held in tests/test_torch_model_formats.py)."""
    files = {"ship.glb": "glTF\x02\x00\x00\x00junk", "bad.obj": "v 0 0\nf 1 2 3\n"}
    jsp, tsp = _parse_both(tmp_path, "O ship.glb 0 0 0\nO bad.obj 0 0 0\nS 0 0 0 1\n",
                           files=files)
    assert dataclasses.asdict(jsp) == dataclasses.asdict(tsp)
    assert [m.loaded for m in tsp.models] == [False, False] and len(tsp.cobjs) == 1
    _check_pack(jsp, tsp)


def test_include_carries_state(tmp_path):
    """Transforms and the layer propagate into an include, not back out;
    groups and materials saved inside persist."""
    files = {"inc.txt": "S 0 0 0 1\nl 0.2 1 1 1 1 -1\nJ inner\nstart_cobj_group\n"
                        "B 0 1 0 1 0 1\nt 5 5 5\n"}
    src = "t 10 0 0\nl 0.7 1 1 1 1 -1\ni inc.txt\nS 0 0 0 1\nj inner\nS 1 1 1 1\n"
    jsp, tsp = _parse_both(tmp_path, src, files=files)
    assert dataclasses.asdict(jsp) == dataclasses.asdict(tsp)
    assert not tsp.skipped and [c.p1[0] for c in tsp.cobjs] == [10.0, 10.0, 10.0, 11.0]
    assert [c.layer.elasticity for c in tsp.cobjs] == [0.7, 0.2, 0.7, 0.2]
    assert tsp.num_cobj_groups == 1 and tsp.cobjs[2].group_id == -1

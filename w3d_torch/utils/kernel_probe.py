"""Probe the erosion walk (A), the mesh sample (B), the narrow phase (C),
the banded pair pass (D), the fused substep (G), the tile noise (E) and
the substep glue's kernels on the GPU, and the timing, bound and scene
helpers that `chip_smoke.py` shares.

    python3 -m w3d_torch.utils.kernel_probe

Prints, at the main path's shapes (256 tiles of 128^2 with 512 droplets
and 64 steps; 10K balls in a dense x-sorted pile in the spheres scene,
M = 112 cobj slots, window 288; E on the terrain path's 256 tile origins
and on those of `chip_smoke.py`'s rate loop, shifted by RATE_SHIFT):

1. what `ptxas` reports for the six kernels (registers, shared memory,
   stack frame, spills), the shared-memory atomic instructions in the
   erosion kernel's SASS, and the local-memory instructions (`LDL`, `STL`:
   `sinf`'s slow path for arguments above 105,615) in the noise kernel's
   (`cuobjdump`);
2. each kernel's device-only time: one replay of a CUDA graph of 20
   launches between CUDA events, divided by 20; the floors, the same timer
   on one CTA's worth of work (B, C and G at N = 128, D at 32 ranks, A and
   E at one tile) or F on a (2, 8, 8) grid: launch plus fixed set-up; F on
   the light grid (32, 128, 128) by z block; A on the padded path's 136^2
   maps; C and G on `wide_scene` tables of M = 536 and 1,616 slots (two
   and five shared-memory chunks); the substep glue's six kernels on the
   dense pile, dry, beside their byte floors;
3. the phase splits of two variant libraries: `W3D_EROSION_PHASES`, whose
   thread 0 in each CTA sums the SM cycles between the step's barriers
   (read phase, write phase, combine), and `W3D_NOISE_PHASES` (table
   build, product, store), at both sets of E's origins, beside the share
   of E's sine arguments on `sinf`'s slow path;
4. A's and D's CUDA-event times around 20 back-to-back eager calls (for a
   kernel shorter than its wrapper's host work they time the host), beside
   their bounds.

With `--times` it prints only step 2's graph times and digests of E's
heights, of C's and G's outputs at M = 112 and 80 and of F's, through
wrappers that older checkouts of the port have too (what a checkout lacks,
the padded walk, wide tables, F's z block, it skips), so two versions can
be timed, and their outputs compared bit for bit, in one call on one card
(`cd <checkout> && PYTHONPATH=. python3 <this file> --times`).
`--phases` prints only step 3.

Needs a CUDA device and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import hashlib
import inspect
import os
import re
import statistics
import subprocess
import tempfile

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12    # H100 SXM device memory (data sheet)
FP32_OPS_PER_S = 67e12       # H100 SXM float32 outside the tensor cores
# chip_smoke.py's rate loop times the terrain call at x0 + (7 + g) * 256 *
# 128 for g < 5; E is also checked and timed at the last of those origins
RATE_SHIFT = 11 * 256 * 128
SINF_FAST_MAX = 105615.0     # |x| above which CUDA's sinf reduces slowly
LIGHT_GRID = (32, 128, 128)  # the smoke grid (mesh_z, mesh_y, mesh_x), lighting/lmap.py


def bound_ms(nbytes: float, nops: float) -> tuple[float, str]:
    """(least ms the card could take, "bytes" or "operations"): the larger
    of the bytes over the memory rate and the operations over the float32
    rate."""
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    to = nops / FP32_OPS_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def events_ms(fn, launches: int = 20, reps: int = 3, warm: bool = True) -> float:
    """ms per call: CUDA events around `launches` back-to-back calls,
    divided by the count; median of `reps` such runs (after a warm call)."""
    if warm:
        fn()
    out = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(launches):
            fn()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b) / launches)
    return statistics.median(out)


class GraphTimer:
    """Device-only ms per call of `fn`: `launches` calls captured in one
    CUDA graph, so no host work sits between them; `time()` replays the
    graph between CUDA events and divides by the count."""

    def __init__(self, fn, launches: int = 20):
        fn()
        torch.cuda.synchronize()
        self.launches = launches
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            for _ in range(launches):
                fn()
        self.graph.replay()
        torch.cuda.synchronize()

    def time(self) -> float:
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        self.graph.replay()
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / self.launches


# ---- main-path inputs ------------------------------------------------------

def erosion_case(dev, gen: torch.Generator, num_tiles: int = 256):
    """(hm, xi, zi, angles, params6): one erosion batch at the terrain
    path's shapes (tiles of 128^2, 512 droplets, 64 steps) on the path's
    own raw tile heights."""
    from w3d_torch.models import terrain_model as TMOD
    from w3d_torch.ops import erosion as E
    from w3d_torch.terrain import mesh as TM
    from w3d_torch.utils.constants import WorldConst
    world = WorldConst()
    mcfg = TMOD.TileModelConfig(tile_size=128, erosion_iters_tt=512,
                                erosion_batch=512, erosion_steps=64)
    table, x0, y0, ze, wpz, ang = TMOD.example_inputs(
        mcfg, world, gen, num_tiles=num_tiles, device=dev)
    hm = TMOD._tile_heights(table, x0, y0, mcfg, world, ze).contiguous()
    xi, zi = E.droplet_starts(512, 128, 128, device=dev)
    xi = xi.expand(num_tiles, 512).contiguous()
    zi = zi.expand(num_tiles, 512).contiguous()
    p6 = E.pack_params(E.ErosionParams(
        erode_amount=1.0, water_plane_z=wpz, half_dxy=world.half_dxy,
        zmin=-ze, zmax=ze, rock_thresh=TM.clip_hd1(mcfg.cfg)), dev)
    return hm, xi, zi, ang[0].contiguous(), p6


def padded_erosion_case(case):
    """`erosion_case`'s batch as the padded path walks it: the maps with a
    roam ring of `ops/erosion.PAD` edge-replicated cells (136^2 for 128^2
    tiles) and the droplets started PAD cells in."""
    from w3d_torch.ops import erosion as E
    hm, xi, zi, ang, p6 = case
    hp = torch.nn.functional.pad(hm[:, None], (E.PAD,) * 4, mode="replicate")[:, 0]
    return hp.contiguous(), (xi + E.PAD).contiguous(), (zi + E.PAD).contiguous(), ang, p6


def wide_cobjs(copies: int, dev):
    """The grouped `wide_scene(copies)` on `dev`."""
    from w3d_torch.physics import cobjs as PC
    from w3d_torch.scene import cobj as SC
    return PC.group_cobjs(SC.pack_cobjs(wide_scene(copies), device=dev))


def digest(*ts) -> str:
    """The first 16 hex digits of the sha256 of the tensors' bytes."""
    h = hashlib.sha256()
    for t in ts:
        h.update(t.cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def dense_pile(state, table, seed: int = 7):
    """`state` with its objects moved into a dense x-sorted pile in
    [-3,3]x[-3,3]x[0,0.3] (~140 per contact-wide x slab at 10K, inside the
    288 window), and (radius, elasticity, mass) per object."""
    from w3d_torch.physics import step as PS
    dev = state.px.device
    g = torch.Generator(device=dev).manual_seed(seed)
    u = torch.rand((state.px.shape[0], 3), generator=g, device=dev)
    dense = state._replace(
        px=(u[:, 0] * 6 - 3).contiguous(), py=(u[:, 1] * 6 - 3).contiguous(),
        pz=(u[:, 2] * 0.3).contiguous())
    dense = PS.spatial_sort(dense)
    rad, _, _, _, elas, _, _, mass, _ = PS._type_params(dense.otype, table)
    return dense, rad.contiguous(), elas.contiguous(), mass.contiguous()


def noise_args(dev, gen: torch.Generator, shift: float = 0.0,
               num_tiles: int = 256) -> tuple:
    """Kernel E's arguments (table, x0, y0, n, dx, dy, mesh_scale,
    mesh_scale_z_inv) at the terrain path's shapes: `num_tiles` tiles of
    128^2 at the path's origins, x0 shifted by `shift` grid units."""
    from w3d_torch.models import terrain_model as TMOD
    from w3d_torch.utils.constants import WorldConst
    world = WorldConst()
    mcfg = TMOD.TileModelConfig(tile_size=128, erosion_iters_tt=0)
    table, x0, y0, *_ = TMOD.example_inputs(mcfg, world, gen,
                                            num_tiles=num_tiles, device=dev)
    return (table, (x0 + shift).contiguous(), y0, 128, world.dx, world.dy,
            mcfg.cfg.mesh_scale, 1.0 / mcfg.cfg.mesh_scale_z)


def sine_arguments(table, x0, y0, n, dx, dy, mesh_scale, mszi) -> torch.Tensor:
    """[2, T, n, K] the arguments of kernel E's sines (x table, y table),
    op for op as the kernel and `ops/noise.tile_noise` form them."""
    f32 = lambda v: float(np.float32(v))
    i = torch.arange(n, dtype=torch.float32, device=x0.device)[None, :, None]
    out = []
    for o, d, freq, phase in ((x0, dx, table.freq_x, table.phase_x),
                              (y0, dy, table.freq_y, table.phase_y)):
        mult = f32(mesh_scale / d) * freq
        const = f32(0.5 * mesh_scale) * freq + phase + mult * (f32(d) * o[:, None])
        out.append(mult * f32(d) * i + const[:, None, :])
    return torch.stack(out)


def substep_tables(g):
    """Kernel G's cobj-table argument for `g`: the `narrow_kernel.
    kernel_tables` triple, or its row-major table alone for a checkout
    whose wrapper takes only that (`--times` against an older port)."""
    from w3d_torch.ops.cuda import narrow_kernel as NK
    from w3d_torch.ops.cuda import physics_kernel as GK
    tabs = NK.kernel_tables(g)
    return tabs if "tables" in inspect.signature(GK.substep).parameters else tabs[0]


def substep_args(dense, sw, world, water_z: float = -100.0) -> tuple:
    """Kernel G's arguments for one substep of the 10-substep frame on the
    objects of `dense` in `sw`'s scene (no water by default)."""
    from w3d_torch.ops.cuda import physics_kernel as GK
    from w3d_torch.physics import step as PS
    from w3d_torch.physics import types as PT
    par = PS._type_params(dense.otype, sw.table)[:7]
    env = torch.tensor([PT.DEF_TIMESTEP / 10, 1.0, 0.4, 0.2, 0.0, water_z,
                        world.dx_inv, world.dy_inv, world.x_scene, world.dx,
                        world.dy, 0.0], device=dense.px.device)
    return (dense.px, dense.py, dense.pz, dense.vx, dense.vy, dense.vz,
            dense.status, dense.flags, *(p.contiguous() for p in par),
            GK.mesh_maps(sw.env.mesh_height, world), substep_tables(sw.cobjs), env)


def seven_shape_scene(SC=None):
    """tests/test_pallas.py::test_pallas_narrow_phase_matches_xla's scene:
    every shape group plus dead padding slots, built with `SC`'s classes
    (the port's `w3d_torch.scene.cobj` by default; the tests pass the JAX
    package's too, so both packages pack the same scene)."""
    if SC is None:
        from w3d_torch.scene import cobj as SC
    sp = SC.SceneParse()
    lay = SC.CobjLayer(elasticity=0.8, friction=0.6)
    rg = np.random.default_rng(3)
    for _ in range(17):
        p = rg.uniform(-2, 2, 3)
        sp.cobjs.append(SC.RawCobj(SC.COLL_SPHERE, tuple(p),
                                   r1=float(rg.uniform(0.1, 0.5)), layer=lay))
    for _ in range(11):
        p = rg.uniform(-2, 2, 3)
        q = p + rg.uniform(0.2, 1.0, 3)
        sp.cobjs.append(SC.RawCobj(SC.COLL_CUBE, tuple(p), tuple(q), layer=lay))
    for shp, n in ((SC.COLL_CYLINDER, 7), (SC.COLL_CAPSULE, 6),
                   (SC.COLL_CYLINDER_ROT, 5), (SC.COLL_TORUS, 4)):
        for _ in range(n):
            p = rg.uniform(-2, 2, 3)
            q = p + rg.uniform(-0.8, 0.8, 3)
            if shp == SC.COLL_CYLINDER:
                q[0], q[1] = p[0], p[1]
            if shp == SC.COLL_TORUS:
                q = np.asarray([0.0, 0.0, 1.0])
            sp.cobjs.append(SC.RawCobj(shp, tuple(p), tuple(q),
                                       r1=float(rg.uniform(0.1, 0.4)),
                                       r2=float(rg.uniform(0.1, 0.4)),
                                       layer=lay))
    for _ in range(5):
        a = rg.uniform(-2, 2, 3)
        pts = (a, a + [1.0, 0.0, 0.0], a + [1.0, 1.0, 0.0], a + [0.0, 1.0, 0.0])
        sp.cobjs.append(SC.RawCobj(SC.COLL_POLYGON,
                                   pts=tuple(tuple(p) for p in pts),
                                   r1=0.05, layer=lay))
    # a negative cube carving the first positive cube (CSG at pack time)
    c0 = next(c for c in sp.cobjs if c.shape == SC.COLL_CUBE)
    mid = tuple(0.5 * (a + b) for a, b in zip(c0.p1, c0.p2))
    sp.cobjs.append(SC.RawCobj(SC.COLL_CUBE, mid, c0.p2, negative=True,
                               layer=lay))
    return sp


def wide_scene(copies: int, SC=None, seed: int = 5):
    """A table of many cobj slots: the seven-shape scene with its positive
    cobjs copied `copies` more times, each copy shifted by up to 0.6 on
    every axis, and its first four spheres duplicated exactly under another
    layer (elasticity 0.3, friction 0.2), so objects inside them tie on two
    rows that lie far apart in the packed sphere group.  Built with `SC`'s
    classes, as `seven_shape_scene`.  8 copies pack to M = 536 slots (two
    chunks of the kernels' 384 rows), 27 to M = 1,616 (five)."""
    sp = seven_shape_scene(SC)
    if SC is None:
        from w3d_torch.scene import cobj as SC
    rg = np.random.default_rng(seed)
    base = [c for c in sp.cobjs if not c.negative]
    for _ in range(copies):
        d = rg.uniform(-0.6, 0.6, 3)
        for c in base:
            sp.cobjs.append(dataclasses.replace(
                c, p1=tuple(np.asarray(c.p1) + d),
                # a torus's p2 is its axis, not a point
                p2=c.p2 if c.shape == SC.COLL_TORUS else tuple(np.asarray(c.p2) + d),
                pts=tuple(tuple(np.asarray(q) + d) for q in c.pts)))
    dup = SC.CobjLayer(elasticity=0.3, friction=0.2)
    for s in [c for c in base if c.shape == SC.COLL_SPHERE][:4]:
        sp.cobjs.append(SC.RawCobj(SC.COLL_SPHERE, s.p1, r1=s.r1, layer=dup))
    return sp


# The ground scene of chip_smoke.py's phase 3e (scene P): a ground plate with a carved hole, stepped rows of
# crates, pillars, posts, spheres, a capsule, a torus, ramps, a hollow
# cylinder, a lift under the hole triggered by K and a continuous slider,
# and 200 random spheres; scene C leaves out the platform block
SCENE_HEAD = """
l 0.7 0.55 0.5 0.45 1.0 -1
B -3.0 3.0 -3.0 3.0 -0.3 0.0
n 1
B -0.6 0.6 -0.6 0.6 -0.3 0.0
n 0
l 0.5 0.6 0.4 0.2 1.0 -1
B -2.8 -2.6 2.0 2.2 0.0 0.2
D 0.3 0 0 15
B -2.8 -2.6 -2.4 -2.2 0.0 0.2
D 0.3 0 0 15  0 0 0.02
l 0.9 0.8 0.8 0.8 1.0 -1
C 1.5 1.5 0.0  1.5 1.5 0.8  0.15 0.15
D 0 -0.6 0 5
C -1.5 -1.0 0.0  -1.0 -1.5 0.4  0.08 0.08
D 0 0.5 0 5
S 2.2 -2.2 0.3 0.3
D -0.6 0 0 6
k -2.0 0.5 0.1  -1.2 0.9 0.3  0.1 0.1
z 0.0 -2.0 0.2  0 0 1  0.35 0.06
P 4  -2.5 -0.5 0.0  -1.5 -0.5 0.6  -1.5 0.5 0.6  -2.5 0.5 0.0  0.05
P 3  2.0 0.0 0.0  2.8 0.0 0.0  2.4 0.6 0.5  0.05
c 0.0 2.6 0.0  0.0 2.6 0.6  0.4 0.35  12
"""
SCENE_PLATFORMS = """
K 0.0 0.0 0.3  1.5 0 0  0 0
Q 1  0.5 0.5 0.5 0.5  0.6 0.0  0 0 0  0 0 1  0
B -0.5 0.5 -0.5 0.5 -0.35 -0.3
K
Q 1  1.0 1.0 0.0 0.2  0.8 0.0  0 0 0  1 0 0  1
B 1.0 1.6 -0.4 0.2 0.0 0.1
Q 0
"""
SCENE_TAIL = "rand_spheres 200  0 0 0  2.8 0.03 0.08\n"
SPHERE_MATS = """hardness 0.6
density 2.0
radius_scale 1.2
diffuse_color 0.9 0.2 0.1
add_material rubber
hardness 0.9
density 0.5
radius_scale 0.8
metalness 1
add_material steel
"""


def write_ground_scene(dirname: str, name: str, platforms: bool = True,
                       objects: int = 2000, small: bool = False,
                       erosion_iters: int = 0) -> str:
    """Write the ground scene (with or without its platforms), its two
    sphere materials and a config that loads them into `dirname`; return
    the config's path.  The config: the default 128^2 x 32 sine mesh with
    40 trees, scenery and the water raised by "water_h_off 0.09 0"; or,
    `small`, a 32^2 fBm mesh (bitwise on the card and the CPU) with the
    water raised into its height range.  `erosion_iters` droplets erode
    the terrain at load (through kernel A on the card)."""
    def write(fn, text):
        path = os.path.join(dirname, fn)
        with open(path, "w") as f:
            f.write(text)
        return path

    write(f"scene_{name}.txt", SCENE_HEAD + (SCENE_PLATFORMS if platforms else "")
          + SCENE_TAIL)
    write("mats.txt", SPHERE_MATS)
    mesh = ("mesh_size 32 32 8\nmesh_gen_mode 2\nwater_h_off 0.053 0\n" if small
            else "mesh_size 128 128 32\nwater_h_off 0.09 0\n")
    if erosion_iters:
        mesh += f"erosion_iters {erosion_iters}\n"
    return write(f"cfg_{name}.txt", mesh + "rand_seed 1\nmesh_seed 1\nntrees 40\n"
                 f"num_dodgeballs {objects}\nsphere_materials_fn mats.txt\n"
                 f"load_coll_objs 1\ncoll_obj_file scene_{name}.txt\n")


def write_voxel_scene(dirname: str, small: bool = False, objects: int = 2000) -> str:
    """Write a voxel-landscape config into `dirname` and return its path:
    the shipped `config_voxels.txt` sizes (a 512x512x64 voxel grid, its
    other `voxel` keys at `voxel_params_from_config`'s defaults) over the
    default 128^2 x 32 sine mesh; or, `small`, a 32x32x16 grid over a 32^2
    fBm mesh with the isolevel (0.13), z gradient and edge attenuation of
    tests/test_torch_scene_loader.py, where no cell lies within 1e-4 of
    the isolevel, so the solid mask is the same on every device."""
    if small:
        text = ("mesh_size 32 32 8\nmesh_gen_mode 2\nwater_h_off 0.053 0\n"
                "voxel xsize 32\nvoxel ysize 32\nvoxel zsize 16\nvoxel isolevel 0.13\n"
                "voxel z_gradient 1.5\nvoxel atten_at_edges 2\n")
    else:
        text = "mesh_size 128 128 32\nvoxel xsize 512\nvoxel ysize 512\nvoxel zsize 64\n"
    path = os.path.join(dirname, "config_voxels_small.txt" if small else "config_voxels.txt")
    with open(path, "w") as f:
        f.write(text + f"create_voxel_landscape 1\nrand_seed 1\nmesh_seed 1\n"
                f"num_dodgeballs {objects}\n")
    return path


MODEL_FORMATS = ("obj", "stl", "stl_ascii", "ply", "ply_ascii", "off", "dae",
                 "3ds", "gltf", "glb", "fbx")


def grid_model(cells_x: int = 128, cells_y: int = 80):
    """A displaced grid of 2 x cells_x x cells_y triangles (20,480 at the
    defaults, 10,449 vertices) as a `Model3d`.  Every coordinate is a
    multiple of 1/64 below 16 in magnitude, so each text format writes it
    exactly and STL's 6-decimal vertex merge leaves it as it is."""
    from w3d_torch.scene.model3d import Model3d

    yi, xi = np.meshgrid(np.arange(cells_y + 1), np.arange(cells_x + 1), indexing="ij")
    z = np.round(16.0 * np.sin(0.11 * xi) * np.cos(0.07 * yi)) / 64.0
    pos = np.stack([(xi - cells_x / 2) / 16.0, (yi - cells_y / 2) / 16.0, z], -1)
    pos = pos.reshape(-1, 3).astype(np.float32)
    v = (yi[:-1, :-1] * (cells_x + 1) + xi[:-1, :-1]).reshape(-1)
    a, b, c, d = v, v + 1, v + cells_x + 2, v + cells_x + 1
    faces = np.stack([np.stack([a, b, c], 1), np.stack([a, c, d], 1)], 1)
    faces = faces.reshape(-1, 3).astype(np.int32)
    none = -np.ones_like(faces)
    return Model3d(positions=pos, normals=np.zeros((0, 3), np.float32),
                   uvs=np.zeros((0, 2), np.float32), faces=faces,
                   face_normals=none, face_uvs=none)


def write_model_files(dirname: str, model, stem: str = "model") -> dict:
    """Write `model`'s positions and triangles in every format
    `read_mesh_formats.load_model` reads (`MODEL_FORMATS`: OBJ, binary and
    ASCII STL, binary and ASCII PLY, OFF, COLLADA, 3DS, glTF with a data
    URI, GLB, binary FBX) into `dirname`; return {format: path}."""
    import base64
    import json
    import struct

    from w3d_torch.scene.read_3ds import write_3ds
    from w3d_torch.scene.read_fbx import write_fbx

    V = np.asarray(model.positions, np.float32)
    F = np.asarray(model.faces, np.int32)
    fmt = "%.9g %.9g %.9g"
    paths = {}

    def path(kind, ext):
        paths[kind] = os.path.join(dirname, f"{stem}_{kind}.{ext}")
        return paths[kind]

    with open(path("obj", "obj"), "w") as f:
        f.writelines(f"v {fmt % tuple(v)}\n" for v in V)
        f.writelines(f"f {a + 1} {b + 1} {c + 1}\n" for a, b, c in F)
    tri = V[F]                                              # [F, 3, 3]
    with open(path("stl", "stl"), "wb") as f:
        rec = np.zeros(len(F), [("n", "<f4", 3), ("v", "<f4", (3, 3)), ("a", "<u2")])
        rec["v"] = tri
        f.write(b"\x00" * 80 + struct.pack("<I", len(F)) + rec.tobytes())
    with open(path("stl_ascii", "stl"), "w") as f:
        f.write("solid m\n")
        for t in tri:
            f.write("facet normal 0 0 1\nouter loop\n")
            f.writelines(f"vertex {fmt % tuple(v)}\n" for v in t)
            f.write("endloop\nendfacet\n")
        f.write("endsolid m\n")
    head = ("ply\nformat {} 1.0\nelement vertex %d\nproperty float x\n"
            "property float y\nproperty float z\nelement face %d\n"
            "property list uchar int vertex_indices\nend_header\n") % (len(V), len(F))
    with open(path("ply", "ply"), "wb") as f:
        faces = np.zeros(len(F), [("k", "u1"), ("i", "<i4", 3)])
        faces["k"], faces["i"] = 3, F
        f.write(head.format("binary_little_endian").encode() + V.astype("<f4").tobytes()
                + faces.tobytes())
    with open(path("ply_ascii", "ply"), "w") as f:
        f.write(head.format("ascii"))
        f.writelines(f"{fmt % tuple(v)}\n" for v in V)
        f.writelines(f"3 {a} {b} {c}\n" for a, b, c in F)
    with open(path("off", "off"), "w") as f:
        f.write(f"OFF\n{len(V)} {len(F)} 0\n")
        f.writelines(f"{fmt % tuple(v)}\n" for v in V)
        f.writelines(f"3 {a} {b} {c}\n" for a, b, c in F)
    with open(path("dae", "dae"), "w") as f:
        f.write('<?xml version="1.0"?>\n<COLLADA xmlns="http://www.collada.org/'
                '2005/11/COLLADASchema" version="1.4.1"><library_geometries>'
                '<geometry id="g"><mesh><source id="pos"><float_array id="pa">'
                + " ".join("%.9g" % x for x in V.ravel())
                + '</float_array></source><vertices id="verts"><input '
                'semantic="POSITION" source="#pos"/></vertices><triangles><input '
                'semantic="VERTEX" source="#verts" offset="0"/><p>'
                + " ".join(map(str, F.ravel()))
                + "</p></triangles></mesh></geometry></library_geometries></COLLADA>\n")
    write_3ds(path("3ds", "3ds"), model)
    blob = V.tobytes() + F.astype("<u4").tobytes()
    doc = {"asset": {"version": "2.0"},
           "buffers": [{"byteLength": len(blob)}],
           "bufferViews": [{"buffer": 0, "byteOffset": 0, "byteLength": V.nbytes},
                           {"buffer": 0, "byteOffset": V.nbytes,
                            "byteLength": F.nbytes}],
           "accessors": [{"bufferView": 0, "componentType": 5126, "count": len(V),
                          "type": "VEC3"},
                         {"bufferView": 1, "componentType": 5125, "count": F.size,
                          "type": "SCALAR"}],
           "meshes": [{"primitives": [{"attributes": {"POSITION": 0}, "indices": 1}]}]}
    with open(path("glb", "glb"), "wb") as f:
        js = json.dumps(doc).encode()
        js += b" " * (-len(js) % 4)
        binc = blob + b"\x00" * (-len(blob) % 4)
        f.write(struct.pack("<III", 0x46546C67, 2, 28 + len(js) + len(binc))
                + struct.pack("<II", len(js), 0x4E4F534A) + js
                + struct.pack("<II", len(binc), 0x004E4942) + binc)
    doc["buffers"][0]["uri"] = ("data:application/octet-stream;base64,"
                                + base64.b64encode(blob).decode())
    with open(path("gltf", "gltf"), "w") as f:
        json.dump(doc, f)
    write_fbx(path("fbx", "fbx"), model)
    return paths


def lighting_bench_scene(SC=None):
    """The scene of scripts/lighting_bench.py, built with `SC`'s classes
    (default: the port's): a floor cube and 60 spheres of radius 0.1-0.4,
    one material."""
    if SC is None:
        from ..scene import cobj as SC
    sp = SC.SceneParse()
    lay = SC.CobjLayer(elasticity=0.5, color=(0.7, 0.6, 0.5, 1.0))
    sp.cobjs.append(SC.RawCobj(SC.COLL_CUBE, (-4, -4, -0.8), (4, 4, -0.55), layer=lay))
    rng = np.random.default_rng(3)
    for _ in range(60):
        p = rng.uniform(-2.5, 2.5, 3) * [1, 1, 0.3]
        sp.cobjs.append(SC.RawCobj(SC.COLL_SPHERE, tuple(p),
                                   r1=float(rng.uniform(0.1, 0.4)), layer=lay))
    return sp


# The synthetic ship-defs file of the universe tests and chip_smoke.py's
# phase 3h, in the reference's units (ship_config.cpp converts them):
# class rows (reference field order, ship_config.SHIP_FIELDS), weapon rows
# (WEAP_FIELDS) in an $INCLUDEd part, loadouts, one collision sphere and two
# fleets (55 RED defenders against 101 BLUE attackers per multiplier, the
# size of the reference's assault config)
DEFS_SHIPS = {
    # id: (name, fields, base color, explosion)
    "USC_FIGHTER": ("Fighter", dict(kcost=1, ncrew=1, nengines=1, radius=0.4, mass=1,
                                    accel=0.45, decel=0.45, roll_rate=2, max_speed=24,
                                    max_turn=4, max_shields=100, max_armor=50,
                                    shield_re=0.5, min_att_dist=4, stoppable=1),
                    "LT_GRAY", "ETYPE_PART_CLOUD"),
    # frigates regenerate no shields: a frigate whose shields fell stays
    # open to boarding
    "USC_FRIGATE": ("Frigate", dict(kcost=8, ncrew=12, nengines=2, radius=1.2, mass=20,
                                    accel=0.3, decel=0.3, max_speed=14, max_turn=2,
                                    max_shields=400, max_armor=300, min_att_dist=6,
                                    can_board=1),
                    "WHITE", "ETYPE_FIRE"),
    "USC_DESTROYER": ("Destroyer", dict(kcost=15, ncrew=60, nengines=2, radius=1.6,
                                        mass=50, accel=0.25, decel=0.25, max_speed=12,
                                        max_turn=1.5, max_shields=600, max_armor=500,
                                        shield_re=3, min_att_dist=8, can_board=1),
                      "LT_BLUE", "ETYPE_FIRE"),
    "USC_CARRIER": ("Carrier", dict(kcost=40, ncrew=200, nengines=4, radius=3.0,
                                    mass=300, accel=0.15, decel=0.15, max_speed=9,
                                    max_turn=0.8, max_shields=1200, max_armor=1000,
                                    shield_re=4, min_att_dist=12, fire_dist=0.3,
                                    regen_fighters=1),
                    "GRAY", "ETYPE_NUCLEAR"),
    "USC_ARMAGEDDON": ("Armageddon", dict(kcost=90, ncrew=500, nengines=6, radius=4.0,
                                          mass=800, accel=0.12, decel=0.12, max_speed=8,
                                          max_turn=0.5, max_shields=2000, max_armor=2000,
                                          shield_re=6, min_att_dist=10),
                       "DK_RED", "ETYPE_NUCLEAR"),
    "USC_BSHUTTLE": ("Boarding Shuttle", dict(kcost=2, ncrew=10, nengines=1, radius=0.5,
                                              mass=2, accel=0.5, decel=0.5, max_speed=20,
                                              max_turn=3, max_shields=50, max_armor=60,
                                              shield_re=0.5, for_boarding=1),
                     "BROWN", "ETYPE_FIRE"),
    "USC_ANTI_MISS": ("Anti-Missile", dict(kcost=6, ncrew=15, nengines=2, radius=1.0,
                                           mass=15, accel=0.3, decel=0.3, max_speed=14,
                                           max_turn=2, max_shields=300, max_armor=250,
                                           shield_re=2, min_att_dist=5),
                      "OLIVE", "ETYPE_FIRE"),
}
DEFS_WEAPONS = {
    # id: (name, fields, ammo, explosion)
    "UWEAP_PBEAM": ("Plasma Beam", dict(damage=1.5, fire_delay=0.1, range=25,
                                        is_beam=1), "UWEAP_NONE", "ETYPE_NONE"),
    "UWEAP_EBEAM": ("Energy Beam", dict(damage=4, range=40, is_beam=1),
                    "UWEAP_NONE", "ETYPE_NONE"),
    "UWEAP_TORPEDO": ("Torpedo", dict(radius=0.3, c_radius=2, bradius=3, damage=60,
                                      fire_delay=1, firing_error=0.1, speed=4,
                                      seek_dist=100, def_ammo=20, lifetime=12, armor=25,
                                      hit_proj=1),
                      "UWEAP_TORPEDO", "ETYPE_FIRE"),
    "UWEAP_PT_DEF": ("Point Defense", dict(damage=15, fire_delay=0.25, range=30,
                                           point_def=1), "UWEAP_NONE", "ETYPE_NONE"),
    "UWEAP_FIGHTER": ("Fighter Bay", dict(fire_delay=2, def_ammo=6, is_fighter=1,
                                          regen_time=20, do_regen=1),
                      "USC_FIGHTER", "ETYPE_NONE"),
    "UWEAP_B_BAY": ("Boarding Bay", dict(fire_delay=3, def_ammo=3, is_fighter=1),
                    "USC_BSHUTTLE", "ETYPE_NONE"),
}
DEFS_LOADOUTS = """
$SHIP_WEAP USC_FIGHTER
$ADD UWEAP_PBEAM
$SHIP_WEAP USC_FRIGATE
$ADD UWEAP_EBEAM 1
$ADD UWEAP_PT_DEF 1
$SHIP_WEAP USC_DESTROYER
$WEAP_PT 1.0 0.0 0.0  -0.5 0.0 0.0
$ADD UWEAP_EBEAM 2
$SHIP_WEAP USC_CARRIER
$ADD UWEAP_FIGHTER 2 6
$ADD UWEAP_B_BAY 1 3
$ADD UWEAP_PT_DEF 2
$SHIP_WEAP USC_ARMAGEDDON
$WEAP_PT 0.8 0.0 0.0
$ADD UWEAP_TORPEDO 2 20
$ADD UWEAP_EBEAM 1
$SHIP_WEAP USC_ANTI_MISS
$ADD UWEAP_PT_DEF 3
$SHIP_SPHERE USC_ARMAGEDDON  0.5 0.0 0.0  0.6
"""
# (fleet name, alignment, rgen_dist, position, {class: count}, flagship)
DEFS_FLEETS = (
    ("Defenders", "RED", 0.06, (0.0, 0.0, 0.0),
     dict(USC_FIGHTER=20, USC_FRIGATE=10, USC_DESTROYER=10, USC_CARRIER=3,
          USC_ARMAGEDDON=2, USC_BSHUTTLE=5, USC_ANTI_MISS=5), None),
    ("Attackers", "BLUE", 0.08, (0.25, 0.0, 0.0),
     dict(USC_FIGHTER=40, USC_FRIGATE=20, USC_DESTROYER=15, USC_CARRIER=4,
          USC_ARMAGEDDON=6, USC_BSHUTTLE=8, USC_ANTI_MISS=8), "100 USC_ARMAGEDDON"),
)


def write_ship_defs(path: str, multiplier: int = 1) -> str:
    """Write a `$`-sectioned ship-defs file to `path` (its weapons in a
    part beside it, pulled in by `$INCLUDE`) and return `path`: seven ship
    classes (fighter, frigate, destroyer, carrier, armageddon, boarding
    shuttle, anti-missile; frigates and destroyers can be boarded), six
    weapons (a beam, a plasma beam, a travelling and seeking torpedo with
    projectile armor, point defence, a fighter bay with regenerating ammo
    and a boarding-shuttle bay), loadouts with firing points, a collision
    sphere, $SPEED_SCALE, $START_POS and two fleets of 55 and 101 ships
    times `multiplier`."""
    from w3d_torch.universe import ship_config as SC
    part = os.path.splitext(path)[0] + "_weapons.txt"
    row = lambda names, vals: " ".join(f"{vals.get(k, 0)}" for k in names)
    with open(part, "w") as f:
        f.write("# weapons of the synthetic ship defs\n")
        for wid, (name, vals, ammo, exp) in DEFS_WEAPONS.items():
            f.write(f'$WEAP {wid} "{name}" {row(SC.WEAP_FIELDS, vals)} {ammo} {exp}\n')
        f.write("$WBEAM UWEAP_EBEAM  CYAN WHITE  0.2 0.8 1.0 1.0  BLUE  1.0  0 0 0 0 0\n")
    counts = lambda d: " ".join(str(d.get(k, 0)) for k in SC.SHIP_IDS)
    with open(path, "w") as f:
        f.write(f"$INCLUDE {os.path.basename(part)}\n$SPEED_SCALE 1.0\n"
                "$START_POS 0.1 0.0 0.0\n")
        for sid, (name, vals, color, exp) in DEFS_SHIPS.items():
            f.write(f'$SHIP {sid} "{name}" {row(SC.SHIP_FIELDS, vals)} {color} '
                    f"WHITE {exp} ETYPE_NONE\n")
        f.write(DEFS_LOADOUTS)
        for name, align, dist, pos, cnt, flag in DEFS_FLEETS:
            f.write(f'$FLEET "{name}" {multiplier} {align} AI_ATT_ENEMY TARGET_CLOSEST '
                    f"{dist} {pos[0]} {pos[1]} {pos[2]}  {counts(cnt)}"
                    f"{' ' + flag if flag else ''}\n")
        f.write("$END\n")
    return path


def pair_work(px, py, pz, radius, active, window: int,
              i_limit: int | None = None) -> tuple[int, int]:
    """(valid pairs in the band, overlapping pairs): the pair tests and
    the contacts that these inputs need."""
    n = px.shape[0]
    ilim = n if i_limit is None else min(i_limit, n)
    valid = hits = 0
    for d in range(1, min(window, n - 1) + 1):
        k = min(ilim, n - d)
        if k <= 0:
            break
        ok = active[:k] & active[d:d + k]
        ex, ey, ez = px[:k] - px[d:d + k], py[:k] - py[d:d + k], pz[:k] - pz[d:d + k]
        dist = torch.sqrt(torch.clamp(ex * ex + ey * ey + ez * ez, min=1e-12))
        valid += int(ok.sum())
        hits += int((ok & (dist < radius[:k] + radius[d:d + k])).sum())
    return valid, hits


# ops per unit of work, counted from the kernel sources (adds, multiplies,
# divides, square roots, min/max and compares each count one)
EROSION_OPS = {"live": 80,      # one droplet step's read and update
               "deposit": 14,   # a bilinear deposit's four taps
               "erode": 128}    # a 4x4 erosion stencil
PAIR_TEST_OPS = 12              # offsets, squared distance, sqrt, compare
PAIR_HIT_OPS = 50               # both sides' push and impulse terms


def erosion_bound(hm, xi, angles, stats: dict) -> tuple[float, str]:
    nbytes = 2 * hm.numel() * 4 + 2 * xi.numel() * 4 + angles.numel() * 4 + 24
    nops = sum(EROSION_OPS[k] * int(stats[k]) for k in EROSION_OPS)
    return bound_ms(nbytes, nops)


def pairs_bound(n: int, valid: int, hits: int) -> tuple[float, str]:
    nbytes = 9 * n * 4 + n + 6 * n * 4
    return bound_ms(nbytes, PAIR_TEST_OPS * valid + PAIR_HIT_OPS * hits)


# ---- the walk's pedestrians (tiled_city_128) --------------------------------

WALK_MAP, WALK_CITIES, WALK_CITY_SIZE, WALK_PEDS = 512, 8, 64, 10000
SEP_RADIUS = 0.15               # step_peds' separation radius
SEP_TEST_OPS = 7                # a pair test: two offsets, two squares, an add, two compares


def separation_bound(rows: int, n: int) -> tuple[float, str]:
    """The separation of `rows` pedestrians against `n` peers: their x, y
    read and the push written, a test per pair."""
    return bound_ms(16 * rows + 8 * n, SEP_TEST_OPS * rows * n)


def ped_draws(n: int, gen: torch.Generator):
    """One pedestrian frame's draws (`traffic.PedDraws`) from `gen`."""
    from w3d_torch.city import traffic as CT
    u = torch.rand((3, n), generator=gen, device=gen.device)
    side = torch.randint(0, 4, (n,), generator=gen, device=gen.device, dtype=torch.int32)
    return CT.PedDraws(u[0], side, u[1], u[2])


def walk_crowd(dev, frames: int = 2048, seed: int = 1, num_peds: int = WALK_PEDS):
    """The walk's crowd: `tiled_city_128`'s 8 cities of 64 cells on a flat
    512^2 map, `num_peds` pedestrians walked `frames` frames by `step_peds`
    with plot navigation and stoplights, so that some wait together at
    the crosswalks.  Returns (peds, nav, stoplights, the draws' generator)."""
    from w3d_torch.city import plots as CP
    from w3d_torch.city import roads as CR
    from w3d_torch.city import traffic as CT
    _hm, plots = CP.gen_cities(np.zeros((WALK_MAP, WALK_MAP), np.float32), -0.5,
                               num_cities=WALK_CITIES, city_size=WALK_CITY_SIZE, seed=seed)
    net = CR.gen_city_roads(plots)
    nav = CT.build_ped_nav(net, device=dev)
    sl = CT.build_stoplights(net, seed=seed, device=dev)
    peds = CT.make_peds(num_peds, net.blocks, seed=seed + 1, device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    for _ in range(frames):
        sl = CT.step_stoplights(sl)
        peds = CT.step_peds(peds, ped_draws(num_peds, gen), nav=nav, stoplights=sl)
    return peds, nav, sl, gen


def packed_crowd(peds, nav, count: int = 400, seed: int = 2):
    """(x, y) of `peds` with `count` of them packed into a 0.5 x 0.3
    rectangle at a crosswalk's curb: ~150 neighbours each within 0.15."""
    g = torch.Generator(device=peds.x.device).manual_seed(seed)
    u = torch.rand((2, count), generator=g, device=peds.x.device)
    at = int(torch.nonzero(nav.adj.flatten() >= 0)[0])      # the first real crossing
    cx, cy = nav.cross_x.flatten()[at], nav.cross_y.flatten()[at]
    x, y = peds.x.clone(), peds.y.clone()
    x[:count] = cx + (u[0] - 0.5) * 0.5
    y[:count] = cy + (u[1] - 0.5) * 0.3
    return x, y


# ---- probes ----------------------------------------------------------------

def _ptxas_and_sass() -> None:
    from w3d_torch.ops.cuda import build
    nvcc = build._nvcc()
    dump = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    # SASS opcodes counted per kernel: the erosion kernel's shared-memory
    # atomics and barriers, the noise kernel's local-memory traffic
    counted = {"erosion": r"\b(ATOMS\.[A-Z0-9.]+|ATOM\.[A-Z0-9.]+|RED\.[A-Z0-9.]+|BAR\.[A-Z0-9.]+)",
               "noise": r"\b(LDL(?:\.[A-Z0-9.]+)?|STL(?:\.[A-Z0-9.]+)?|CALL\.[A-Z0-9.]+)"}
    with tempfile.TemporaryDirectory() as tmp:
        for name in ("erosion", "pairs", "narrow", "sample", "substep", "noise"):
            src = os.path.join(build.CSRC, f"{name}.cu")
            cubin = os.path.join(tmp, f"{name}.cubin")
            res = subprocess.run([nvcc] + build.COMPILE_FLAGS
                                 + ["-Xptxas", "-v", "-cubin", "-o", cubin, src],
                                 capture_output=True, text=True, check=True)
            print(f"ptxas {name}.cu:\n" + "\n".join(
                ln for ln in (res.stdout + res.stderr).splitlines()
                if "registers" in ln or "spill" in ln or "Compiling" in ln))
            if name not in counted:
                continue
            sass = subprocess.run([dump, "-sass", cubin], capture_output=True,
                                  text=True, check=True).stdout
            ops: dict[str, int] = {}
            for op in re.findall(counted[name], sass):
                ops[op] = ops.get(op, 0) + 1
            print(f"{name}.cu SASS, static count of {counted[name]}: {ops}")
            if name == "noise":
                _sass_loops(sass)


def _sass_loops(sass: str) -> None:
    """Each loop of a SASS listing (a branch back to an earlier address):
    its instructions, FFMAs and shared loads, innermost loops first."""
    ins = [(int(a, 16), op.strip()) for a, op in
           re.findall(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", sass)]
    for addr, op in ins:
        m = re.search(r"BRA (0x[0-9a-f]+)", op)
        if m and int(m.group(1), 16) < addr:
            body = [o for a, o in ins if int(m.group(1), 16) <= a <= addr]
            print(f"    loop {m.group(1)}-{addr:#x}: {len(body)} instructions, "
                  f"{sum('FFMA' in o for o in body)} FFMA, "
                  f"{sum(o.startswith('LDS') for o in body)} LDS")


def _phases_library():
    """The library built with the erosion phase counters, and its walk."""
    from w3d_torch.ops.cuda import build
    lib = build.library(("W3D_EROSION_PHASES",))
    fn = lib.w3d_erosion_walk
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib, fn


def _launch(fn, hm, xi, zi, ang, p6):
    out = torch.empty_like(hm)
    T, ny, nx = hm.shape
    err = fn(hm.data_ptr(), xi.data_ptr(), zi.data_ptr(), ang.data_ptr(),
             p6.data_ptr(), out.data_ptr(), T, ny, nx, xi.shape[1],
             ang.shape[0], torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"erosion variant: CUDA error {err}")
    return out


def _phase_split(case, kernel_ms: float) -> None:
    hm, xi, zi, ang, p6 = case
    lib, fn = _phases_library()
    read = lib.w3d_erosion_phase_cycles
    read.argtypes = [ctypes.c_void_p]
    read.restype = ctypes.c_int
    cyc = (ctypes.c_ulonglong * 4)()
    _launch(fn, hm, xi, zi, ang, p6)
    torch.cuda.synchronize()
    read(cyc)                                    # clears the warm-up's sums
    ms = events_ms(lambda: _launch(fn, hm, xi, zi, ang, p6), launches=1, reps=1)
    torch.cuda.synchronize()
    if read(cyc):
        raise RuntimeError("erosion phase counters: CUDA error")
    T, steps = hm.shape[0], ang.shape[0]
    ncalls = 2                                   # events_ms: one warm call + one timed
    per = [c / (T * ncalls) for c in cyc]
    names = ("read phase + barrier", "write phase (atomics) + barrier",
             "combine pass + barrier")
    print(f"erosion phase split, {T} tiles, {steps} steps (SM cycles per CTA; "
          f"the instrumented kernel ran {ms:.4f} ms, the plain build "
          f"{kernel_ms:.4f} ms):")
    for name, c in zip(names, per[:3]):
        print(f"    {name}: {c / steps:10.1f} cycles/step, "
              f"{100 * c / per[3]:5.1f}% of the walk")
    print(f"    whole walk: {per[3]:.0f} cycles per CTA, "
          f"{per[3] / steps:.1f} cycles/step")


def _noise_launch(fn, table, x0, y0, n, dx, dy, mesh_scale, mszi):
    """One call of a variant library's `w3d_tile_noise`, with the arguments
    `ops/cuda/noise_kernel.tile_noise` gives it (all 90 terms)."""
    K = table.mag.shape[0]
    params = torch.stack(list(table)).contiguous()
    out = torch.empty((x0.shape[0], n, n), dtype=torch.float32, device=x0.device)
    f32 = lambda v: float(np.float32(v))
    err = fn(params.data_ptr(), K, 0, x0.data_ptr(), y0.data_ptr(), out.data_ptr(),
             x0.shape[0], n, f32(dx), f32(dy), f32(mesh_scale / dx),
             f32(mesh_scale / dy), f32(0.5 * mesh_scale), f32(mszi),
             torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"noise variant: CUDA error {err}")
    return out


def _noise_phase_split(cases: dict) -> None:
    """`sin_fast` against sinf on every float it takes, then E's SM cycles
    by phase, per CTA, for each named argument tuple."""
    from w3d_torch.ops.cuda import build
    from w3d_torch.ops.cuda import noise_kernel as NZK
    lib = build.library(("W3D_NOISE_PHASES",))
    fn = lib.w3d_tile_noise
    fn.argtypes = NZK.KERNEL.argtypes + [ctypes.c_void_p]   # the stream
    fn.restype = ctypes.c_int
    read = lib.w3d_noise_phase_cycles
    read.argtypes = [ctypes.c_void_p]
    read.restype = ctypes.c_int
    check = lib.w3d_sin_fast_mismatches
    check.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    check.restype = ctypes.c_int
    buf = torch.tensor([0, 0xffffffff], dtype=torch.int64, device="cuda")
    if check(buf.data_ptr(), torch.cuda.current_stream().cuda_stream):
        raise RuntimeError("sin_fast check: CUDA error")
    bad, first = buf.tolist()
    print(f"sin_fast vs sinf over every float below {SINF_FAST_MAX:.0f} in "
          f"magnitude: {bad} differ" + (f", first {first:#010x}" if bad else ""))
    cyc = (ctypes.c_ulonglong * 4)()
    for label, nargs in cases.items():
        _noise_launch(fn, *nargs)
        torch.cuda.synchronize()
        read(cyc)                                # clears the warm-up's sums
        reps = 5
        for _ in range(reps):
            _noise_launch(fn, *nargs)
        torch.cuda.synchronize()
        if read(cyc):
            raise RuntimeError("noise phase counters: CUDA error")
        ctas = reps * nargs[1].shape[0]
        per = [c / ctas for c in cyc]
        args = sine_arguments(*nargs)
        slow = float((args.abs() > SINF_FAST_MAX).float().mean())
        print(f"noise phase split, {label} ({nargs[1].shape[0]} tiles, x0 "
              f"{float(nargs[1].min()):.0f}..{float(nargs[1].max()):.0f}; "
              f"{100 * slow:.1f}% of the sine arguments above {SINF_FAST_MAX:.0f}, "
              f"max |arg| {float(args.abs().max()):.0f}); SM cycles per CTA, "
              f"thread 0's view:")
        for name, c in zip(("table build + barrier", "product", "store"), per[:3]):
            print(f"    {name}: {c:10.1f} cycles, {100 * c / per[3]:5.1f}% of the kernel")
        print(f"    whole kernel: {per[3]:.0f} cycles per CTA")


# bytes a row each substep-glue kernel reads and writes in the dry pile
# frame (grouped cobjs, no water map), each row read once: advance reads 6
# floats and 3 int32s and writes 9 floats, an int32 and 7 masks; contact
# reads 8 floats, 3 int32s and a mask and writes 6 floats, 2 int32s and 5
# masks; respond reads 11 floats, 3 int32s, 9 masks and C's 6 floats and
# mask (with D's inputs 2 floats and a mask more out, the off-mesh mask
# not read); apply_pairs reads 12 floats, an int32 and 3 masks and writes
# 6 floats and an int32; take_rows reads an int64 index and 11 words and
# writes 11; age_objects reads 3 int32s and writes 2
GLUE_ROW_BYTES = {"advance": 83, "contact": 82, "respond": 122,
                  "respond (pairs)": 130, "apply_pairs": 83, "take_rows": 96,
                  "age_objects": 20}


def _glue_times(times: dict, dense, sw, world, pin) -> dict:
    """Each substep-glue kernel's device-only time on the dense pile, dry,
    into `times`; returns each one's bytes (`GLUE_ROW_BYTES` rows)."""
    from w3d_torch.ops.cuda import glue_kernel as GL
    from w3d_torch.ops.cuda import narrow_kernel as NK
    from w3d_torch.ops.cuda import pairs_kernel as PK
    from w3d_torch.ops.cuda import sample_kernel as SK
    from w3d_torch.physics import types as T
    env, tab, n = sw.env, sw.table, dense.px.shape[0]
    dt = float(torch.tensor(T.DEF_TIMESTEP / 10, dtype=torch.float32))
    m = GL.advance(dense, env, tab, dt, world)
    surf = SK.sample_mesh(env.mesh_height, m.px, m.py, world)
    c = GL.contact(m, surf, None, dense.otype, env, tab, dt, world, False)
    hits = NK.deepest_hits(c.px, c.py, c.pz, c.rad, sw.cobjs)
    r, pr = GL.respond(c, dense.otype, hits, env, tab, dt, world, False, True)
    deltas = PK.banded_pairs(*(getattr(r, f) for f in ("px", "py", "pz", "vx", "vy", "vz",
                                                       "rad")), *pr, window=288)
    idx = torch.randperm(n, device=dense.px.device)
    fns = {"advance": lambda: GL.advance(dense, env, tab, dt, world),
           "contact": lambda: GL.contact(m, surf, None, dense.otype, env, tab, dt, world,
                                         False),
           "respond": lambda: GL.respond(c, dense.otype, hits, env, tab, dt, world,
                                         False, False),
           "respond (pairs)": lambda: GL.respond(c, dense.otype, hits, env, tab, dt, world,
                                                 False, True),
           "apply_pairs": lambda: GL.apply_pairs(r, pr[2], deltas, env),
           "take_rows": lambda: GL.take_rows(dense, idx),
           "age_objects": lambda: GL.age_objects(dense, tab)}
    for k, fn in fns.items():
        times[f"glue {k}"] = _graph_ms(fn)
    return {k: GLUE_ROW_BYTES[k] * n for k in fns}


def _graph_ms(fn) -> list[float]:
    """Five replays of a CUDA graph of 20 calls of `fn`: ms per call."""
    timer = GraphTimer(fn)
    return [timer.time() for _ in range(5)]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--times", action="store_true",
                    help="only the kernels' device-only times and floors (CUDA "
                         "graphs of 20 launches) and digests of E's, C's, G's and "
                         "F's outputs, through their public wrappers; runs against "
                         "another checkout too: cd <checkout> && PYTHONPATH=. "
                         "python3 <this file> --times")
    ap.add_argument("--phases", action="store_true",
                    help="only the phase splits of the erosion walk and the "
                         "tile noise (variant builds)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("kernel_probe: needs a CUDA device")
    from w3d_torch.models import physics_model as PM
    from w3d_torch.ops import erosion as E
    from w3d_torch.ops.cuda import build
    from w3d_torch.ops.cuda import erosion_kernel as EK
    from w3d_torch.ops.cuda import narrow_kernel as NK
    from w3d_torch.ops.cuda import noise_kernel as NZK
    from w3d_torch.ops.cuda import pairs_kernel as PK
    from w3d_torch.ops.cuda import physics_kernel as GK
    from w3d_torch.ops.cuda import sample_kernel as SK
    from w3d_torch.ops.cuda import stencil_kernel as FK
    from w3d_torch.physics import cobjs as PC
    from w3d_torch.scene import cobj as SC
    from w3d_torch.utils.constants import WorldConst
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,"
                          "clocks.max.sm", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"card: {smi}; package {os.path.dirname(E.__file__)}")
    if not (args.times or args.phases):
        _ptxas_and_sass()
    build.library()
    gen = torch.Generator(device=dev).manual_seed(1234)
    world = WorldConst()
    case = erosion_case(dev, gen)
    nargs = {"phase 4's origins": noise_args(dev, gen),
             "the rate loop's origins": noise_args(dev, gen, shift=RATE_SHIFT)}
    if args.phases:
        _phase_split(case, events_ms(lambda: EK.erosion_walk(*case)))
        _noise_phase_split(nargs)
        return

    times = {"erosion": _graph_ms(lambda: EK.erosion_walk(*case))}
    pos, vel = PM.spawn(10000, gen, device=dev)
    sw = PM.build_spheres_world(pos, vel, device=dev)
    dense, rad, elas, mass = dense_pile(sw.state, sw.table)
    act = (dense.status > 0) & (rad >= 0.01)
    pin = (dense.px, dense.py, dense.pz, dense.vx, dense.vy, dense.vz,
           rad, mass, elas, act)
    times["pairs"] = _graph_ms(lambda: PK.banded_pairs(*pin, window=288))
    gc = sw.cobjs
    nin = (dense.px, dense.py, dense.pz, rad)
    times["narrow"] = _graph_ms(lambda: NK.deepest_hits(*nin, gc))
    mesh = torch.rand((world.mesh_y, world.mesh_x), generator=gen, device=dev)
    sxy = (dense.px, dense.py)
    times["sample"] = _graph_ms(lambda: SK.sample_mesh(mesh, *sxy, world))
    gin = substep_args(dense, sw, world)
    times["substep"] = _graph_ms(lambda: GK.substep(*gin))
    for label, na in nargs.items():
        times[f"tile_noise at {label}"] = _graph_ms(lambda na=na: NZK.tile_noise(*na))
    # floors: one CTA's worth of objects, one tile
    nin128 = tuple(t[:128].contiguous() for t in nin)
    sxy128 = tuple(t[:128].contiguous() for t in sxy)
    gin128 = tuple(t[:128].contiguous() for t in gin[:15]) + gin[15:]
    na1 = nargs["phase 4's origins"]
    na1 = (na1[0], na1[1][:1].contiguous(), na1[2][:1].contiguous()) + na1[3:]
    times["narrow floor (N = 128)"] = _graph_ms(lambda: NK.deepest_hits(*nin128, gc))
    times["sample floor (N = 128)"] = _graph_ms(
        lambda: SK.sample_mesh(mesh, *sxy128, world))
    times["substep floor (N = 128)"] = _graph_ms(lambda: GK.substep(*gin128))
    times["tile_noise floor (1 tile)"] = _graph_ms(lambda: NZK.tile_noise(*na1))
    # A's floor at one tile (one CTA), D's at 32 ranks (one CTA)
    case1 = tuple(t[:1].contiguous() for t in case[:3]) + case[3:]
    times["erosion floor (1 tile)"] = _graph_ms(lambda: EK.erosion_walk(*case1))
    pin32 = tuple(t[:32].contiguous() for t in pin)
    times["pairs floor (N = 32)"] = _graph_ms(lambda: PK.banded_pairs(*pin32, window=288))
    # F on the light grid (by z block, where the wrapper takes one) and
    # its floor on a (2, 8, 8) grid
    smoke = torch.rand(LIGHT_GRID, generator=gen, device=dev) * 5
    times["diffuse_smoke"] = _graph_ms(lambda: FK.diffuse_smoke_open(smoke))
    if "zb" in inspect.signature(FK.diffuse_smoke_open).parameters:
        for zb in (1, 2, 4, 8, 32):
            times[f"diffuse_smoke zb={zb}"] = _graph_ms(
                lambda zb=zb: FK.diffuse_smoke_open(smoke, zb=zb))
    tiny = torch.rand((2, 8, 8), generator=gen, device=dev) * 5
    times["diffuse_smoke floor (2, 8, 8)"] = _graph_ms(lambda: FK.diffuse_smoke_open(tiny))
    # this checkout's padded erosion walk and wide cobj tables
    if hasattr(E, "PAD"):
        pcase = padded_erosion_case(case)
        times["erosion padded 136^2"] = _graph_ms(lambda: EK.erosion_walk(*pcase))
    g7 = PC.group_cobjs(SC.pack_cobjs(seven_shape_scene(), device=dev))
    gin7 = gin[:16] + (substep_tables(g7), gin[17])
    if hasattr(NK, "CHUNK_ROWS"):
        for copies in (8, 27):
            gw = wide_cobjs(copies, dev)
            ginw = gin[:16] + (substep_tables(gw), gin[17])
            times[f"narrow M = {gw.size}"] = _graph_ms(lambda gw=gw: NK.deepest_hits(*nin, gw))
            times[f"substep M = {gw.size}"] = _graph_ms(lambda a=ginw: GK.substep(*a))
    glue_bytes = _glue_times(times, dense, sw, world, pin)
    print(f"device-only ms (CUDA graph of 20 launches, 5 replays; 10K objects, "
          f"M = {gc.size}; 256 tiles of 128^2; smoke {LIGHT_GRID}): " + "; ".join(
              f"{k} median {statistics.median(v):.4f} {[round(t, 4) for t in v]}"
              for k, v in times.items()))
    for k, nbytes in glue_bytes.items():
        print(f"glue {k}: floor {bound_ms(nbytes, 0)[0]:.5f} ms ({nbytes} bytes at 3.35 TB/s)")
    for label, na in nargs.items():
        print(f"tile_noise heights at {label}: sha256 {digest(NZK.tile_noise(*na))}")
    print(f"narrow outputs, dense pile: M = {gc.size} sha256 "
          f"{digest(*NK.deepest_hits(*nin, gc))}, M = {g7.size} sha256 "
          f"{digest(*NK.deepest_hits(*nin, g7))}; substep outputs: M = {gc.size} "
          f"sha256 {digest(*GK.substep(*gin))}, M = {g7.size} sha256 "
          f"{digest(*GK.substep(*gin7))}; smoke sha256 "
          f"{digest(FK.diffuse_smoke_open(smoke))}")
    if args.times:
        return

    stats: dict = {}
    ref = E._walk_batch(*case, stats=stats)
    out = EK.erosion_walk(*case)
    print(f"erosion: bitwise equal to plain {bool(torch.equal(out, ref))}; work "
          f"{ {k: int(v) for k, v in stats.items()} }")
    a_ev = events_ms(lambda: EK.erosion_walk(*case))
    b, by = erosion_bound(case[0], case[1], case[3], stats)
    print(f"erosion: {a_ev:.4f} ms (events, 20 launches); bound {b:.4f} ms by {by}")
    _phase_split(case, a_ev)
    _noise_phase_split(nargs)
    valid, hits = pair_work(dense.px, dense.py, dense.pz, rad, act, 288)
    d_ev = events_ms(lambda: PK.banded_pairs(*pin, window=288))
    b, by = pairs_bound(10000, valid, hits)
    print(f"pairs: {valid} valid pairs, {hits} contacts; {d_ev:.4f} ms "
          f"(events, 20 launches; the wrapper's host work is longer than the "
          f"kernel); bound {b:.5f} ms by {by}")


if __name__ == "__main__":
    main()

"""Each hand-written CUDA kernel of the torch port against its plain
PyTorch version, on the card.  Every test here needs a CUDA device and
skips without one.  This file imports no jax, so the machine with the card
runs it without the JAX package's test configuration:

    PYTHONPATH=. python -m pytest --noconftest -p no:cacheprovider -m gpu \
        tests/test_torch_kernels.py

Tolerances: erosion bitwise, and bitwise from run to run (each step's
writes are summed in integer fixed point, whose order does not matter);
sample heights bitwise (same op order, no FMA contraction in either), normals
1e-6 (torch's CUDA rsqrt is not correctly rounded); narrow phase as the
CPU tests hold the JAX kernel (`torch_port_util.check_narrow`), with
first-index ties exact; pairs 1e-6, and bitwise from run to run
(no float atomics); the fused substep 1e-5 with
status and flags equal; tile noise 1e-3 (the kernel's own fused
multiply-add loop against a float32 einsum; at far origins its sines of
arguments above 105,615 reduce in double precision); smoke stencil
bitwise (the same sums in the same order, no contraction).  Kernels C
and G on tables of several shared-memory chunks: against their plain
versions as above, and bitwise equal to a one-chunk run (a variant build
with 64-row chunks against the 384-row build).  The asteroid field on the
card against the CPU: 1e-5 after 8 steps (the steps' other ops round
otherwise on the card).
"""

import numpy as np
import pytest
import torch

from w3d_torch import entry
from w3d_torch.models import physics_model as PM
from w3d_torch.ops import erosion as E
from w3d_torch.physics import cobjs as PC
from w3d_torch.physics import step as PS
from w3d_torch.scene import cobj as SC
from w3d_torch.utils.constants import WorldConst

from torch_port_util import (check_narrow, cuda_device,  # noqa: F401
                             into_tied_sphere, narrow_case, seven_shape_scene,
                             tied_spheres_scene, wide_scene)

pytestmark = pytest.mark.gpu


def test_erosion_kernel_matches_plain(cuda_device):
    from w3d_torch.ops.cuda import erosion_kernel as EK
    rng = np.random.default_rng(7)
    hm = torch.as_tensor(rng.standard_normal((4, 64, 64)).astype(np.float32)
                         * 0.5 + 1.0, device=cuda_device)
    xi, zi = E.droplet_starts(256, 64, 64, device=cuda_device)
    xi = xi.expand(4, 256).contiguous()
    zi = zi.expand(4, 256).contiguous()
    g = torch.Generator(device=cuda_device).manual_seed(0)
    ang = E.draw_angles(256, 256, 32, g, device=cuda_device)[0].contiguous()
    p6 = E.pack_params(E.ErosionParams(water_plane_z=0.0, half_dxy=0.06,
                                       zmin=-2.0, zmax=2.0, rock_thresh=0.75),
                       cuda_device)
    out = EK.erosion_walk(hm, xi, zi, ang, p6)
    ref = E._walk_batch(hm, xi, zi, ang, p6)
    assert ref.abs().max().item() > 1e-3                # the walk wrote
    assert torch.equal(out, ref)
    assert torch.equal(EK.erosion_walk(hm, xi, zi, ang, p6), out)


def test_sample_kernel_matches_plain(cuda_device):
    from w3d_torch.ops.cuda import sample_kernel as SK
    w = WorldConst()
    rng = np.random.default_rng(11)
    mesh = torch.as_tensor(rng.standard_normal((w.mesh_y, w.mesh_x))
                           .astype(np.float32), device=cuda_device)
    x, y = (torch.as_tensor(rng.uniform(-5.6, 5.6, 10000).astype(np.float32),
                            device=cuda_device) for _ in range(2))
    out = SK.sample_mesh(mesh, x, y, w)
    ref = PS.sample_mesh(mesh, x, y, w)
    assert torch.equal(out[0], ref[0])
    for a, b in zip(out[1:], ref[1:]):
        assert (a - b).abs().max().item() < 1e-6


@pytest.mark.parametrize("case,n", [("base", 10000), ("far", 10000),
                                    ("ties", 10000), ("wide", 10000),
                                    ("base", 4097)])
def test_narrow_kernel_matches_plain(cuda_device, case, n):
    """The CPU parity cases (tests/test_torch_physics.py) at 10K objects,
    among them a table of 200 slots, and a ragged N whose last team and CTA
    are partial."""
    from w3d_torch.ops.cuda import narrow_kernel as NK
    sp, ins = narrow_case(case, SC, n)
    g = PC.group_cobjs(SC.pack_cobjs(sp, device=cuda_device))
    ins = [torch.as_tensor(a, device=cuda_device) for a in ins]
    out = [a.cpu().numpy() for a in NK.deepest_hits(*ins, g)]
    ref = [a.cpu().numpy() for a in PC.deepest_hits_grouped(*ins, g)]
    pen_all = PC.sphere_cobj_test_grouped(*ins, g)[0].cpu().numpy()
    check_narrow(case, out, ref, pen_all)


def test_pairs_kernel_matches_plain(cuda_device):
    from w3d_torch.ops.cuda import pairs_kernel as PK
    g = torch.Generator(device=cuda_device).manual_seed(5)
    n = 4000
    u = torch.rand((n, 3), generator=g, device=cuda_device)
    pos = u * torch.tensor([3.0, 3.0, 0.3], device=cuda_device)
    vel = torch.randn((n, 3), generator=g, device=cuda_device)
    sw = PM.build_spheres_world(pos, vel, device=cuda_device)
    st = PS.spatial_sort(sw.state)
    rad, _, _, _, elas, _, _, mass, _ = PS._type_params(st.otype, sw.table)
    act = (torch.rand(n, generator=g, device=cuda_device) > 0.05)
    ins = (st.px, st.py, st.pz, st.vx, st.vy, st.vz, rad.contiguous(),
           mass.contiguous(), elas.contiguous(), act)
    # 1000 and 3000 run the window in several chunks; 3000 is too wide to
    # stage in shared memory and reads device memory
    for window, i_limit in ((48, None), (288, None), (160, 3000), (1000, 2500),
                            (3000, None)):
        out = PK.banded_pairs(*ins, window=window, i_limit=i_limit)
        ref = PS.banded_pair_collisions(*ins, window=window, i_limit=i_limit)
        assert int((ref[0] != 0).sum()) > 100
        for a, b in zip(out, ref):
            assert (a - b).abs().max().item() < 1e-6


def test_erosion_kernel_ragged_tiles(cuda_device):
    """3 non-square tiles of 48x64 with 200 droplets: bitwise equal to the
    plain version and to itself across two runs."""
    from w3d_torch.ops.cuda import erosion_kernel as EK
    rng = np.random.default_rng(11)
    hm = torch.as_tensor(rng.standard_normal((3, 48, 64)).astype(np.float32)
                         * 0.5 + 1.0, device=cuda_device)
    xi, zi = (t.expand(3, 200).contiguous()
              for t in E.droplet_starts(200, 64, 48, device=cuda_device))
    g = torch.Generator(device=cuda_device).manual_seed(4)
    ang = E.draw_angles(200, 200, 64, g, device=cuda_device)[0].contiguous()
    p6 = E.pack_params(E.ErosionParams(water_plane_z=0.0, half_dxy=0.06,
                                       zmin=-2.0, zmax=2.0, rock_thresh=0.75),
                       cuda_device)
    out = EK.erosion_walk(hm, xi, zi, ang, p6)
    ref = E._walk_batch(hm, xi, zi, ang, p6)
    assert ref.abs().max().item() > 1e-3
    assert torch.equal(out, ref)
    assert torch.equal(EK.erosion_walk(hm, xi, zi, ang, p6), out)


def test_pairs_kernel_ragged(cuda_device):
    """4,097 ranks, window 300, the i side limited to ranks below 3,001:
    within 1e-6 of the plain version and bitwise equal across two runs."""
    from w3d_torch.ops.cuda import pairs_kernel as PK
    g = torch.Generator(device=cuda_device).manual_seed(6)
    n = 4097
    u = torch.rand((n, 3), generator=g, device=cuda_device)
    pos = u * torch.tensor([2.5, 3.0, 0.3], device=cuda_device)
    vel = torch.randn((n, 3), generator=g, device=cuda_device)
    sw = PM.build_spheres_world(pos, vel, device=cuda_device)
    st = PS.spatial_sort(sw.state)
    rad, _, _, _, elas, _, _, mass, _ = PS._type_params(st.otype, sw.table)
    act = torch.rand(n, generator=g, device=cuda_device) > 0.05
    ins = (st.px, st.py, st.pz, st.vx, st.vy, st.vz, rad.contiguous(),
           mass.contiguous(), elas.contiguous(), act)
    out = PK.banded_pairs(*ins, window=300, i_limit=3001)
    ref = PS.banded_pair_collisions(*ins, window=300, i_limit=3001)
    assert int((ref[0] != 0).sum()) > 100
    for a, b, c in zip(out, ref, PK.banded_pairs(*ins, window=300, i_limit=3001)):
        assert (a - b).abs().max().item() < 1e-6
        assert torch.equal(a, c)


def _substep_inputs(n, g, dev, water_z=0.25):
    """Random objects over a bumpy mesh with random status, flag bits and
    params, so every branch of the fused substep sees objects."""
    from w3d_torch.ops.cuda import narrow_kernel as NK
    from w3d_torch.ops.cuda import physics_kernel as GK
    w = WorldConst()
    rng = np.random.default_rng(5)
    f32 = lambda lo, hi, k=n: torch.as_tensor(
        rng.uniform(lo, hi, k).astype(np.float32), device=dev)
    state = [f32(-2.5, 2.5), f32(-2.5, 2.5), f32(-1.0, 1.0),
             f32(-12, 12), f32(-12, 12), f32(-16, 8)]
    state += [torch.as_tensor(rng.integers(0, hi, n).astype(np.int32), device=dev)
              for hi in (5, 1 << 7)]
    params = [f32(0.02, 0.1), f32(0.0, 0.3), f32(0.0, 1.3), f32(0.5, 1.5),
              f32(0.2, 1.0), f32(0.3, 2.0), f32(5.0, 30.0)]
    mesh = torch.as_tensor(rng.standard_normal((w.mesh_y, w.mesh_x))
                           .astype(np.float32) * 0.3 - 0.5, device=dev)
    env = torch.tensor([0.0035, 1.0, 0.4, 0.2, -0.1, water_z, w.dx_inv,
                        w.dy_inv, w.x_scene, w.dx, w.dy, 0.0], device=dev)
    return [*state, *params, GK.mesh_maps(mesh, w), NK.kernel_tables(g), env]


def _substep_vs_plain(args):
    """Kernel G and its plain version on `args` (the wrapper's arguments):
    positions and velocities within 1e-5, status and flags equal.  Returns
    the plain version's outputs."""
    from w3d_torch.ops.cuda import physics_kernel as GK
    from w3d_torch.physics import fused as PF
    out = GK.substep(*args)
    ref = PF.substep_plain(*args[:-2], args[-2][0], args[-1])
    for a, b in zip(out[:6], ref[:6]):
        assert (a - b).abs().max().item() < 1e-5
    assert torch.equal(out[6], ref[6]) and torch.equal(out[7], ref[7])
    return ref


@pytest.mark.parametrize("scene", ["spheres", "seven_shapes", "tied_spheres"])
def test_substep_kernel_matches_plain(cuda_device, scene):
    """10K random objects; in the tied-spheres scene a quarter of them sit
    inside three coincident spheres on rows of lanes 0, 3 and 5 of a team,
    so their hits average three rows tied at a positive pen."""
    if scene == "spheres":
        sp = PM.spheres_scene()
    elif scene == "seven_shapes":
        sp = seven_shape_scene(SC)
    else:
        sp, centre, radius = tied_spheres_scene(SC)
    g = PC.group_cobjs(SC.pack_cobjs(sp, device=cuda_device))
    args = _substep_inputs(10000, g, cuda_device)
    if scene == "tied_spheres":
        args[:3] = (torch.as_tensor(a, device=cuda_device) for a in into_tied_sphere(
            *(t.cpu().numpy() for t in args[:3]), centre, radius, 2500))
        args[7] = args[7] & ~2          # so the cobj-hit bit shows this substep's
    ref = _substep_vs_plain(args)
    assert int(((ref[7] & 2) != 0).sum()) > 500     # cobj hits
    assert len(torch.unique(ref[6])) >= 4
    if scene == "tied_spheres":
        assert int(((ref[7][:2500] & 2) != 0).sum()) > 1500


@pytest.mark.parametrize("case,n", [("far", 10000), ("wide", 10000),
                                    ("base", 10001)])
def test_substep_kernel_edge_cases(cuda_device, case, n):
    """Objects farther than 1 from every cobj (the deepest pen is -1, tied
    over the dead slots and the missed polygons and cylinders, and never
    reaches an output), a table of 200 slots, and a ragged N whose last
    team and CTA are partial."""
    sp, ins = narrow_case(case, SC, n)
    g = PC.group_cobjs(SC.pack_cobjs(sp, device=cuda_device))
    args = _substep_inputs(n, g, cuda_device)
    args[:3] = (torch.as_tensor(a, device=cuda_device) for a in ins[:3])
    args[7] = args[7] & ~2              # so the cobj-hit bit shows this substep's
    ref = _substep_vs_plain(args)
    hits = int(((ref[7] & 2) != 0).sum())
    assert hits == 0 if case == "far" else hits > 300


@pytest.mark.parametrize("n,start_sin", [(128, 0), (100, 20), (200, 0)])
def test_tile_noise_kernel_matches_plain(cuda_device, n, start_sin):
    from w3d_torch.ops import noise as N
    from w3d_torch.ops.cuda import noise_kernel as EK
    w = WorldConst()
    table = N.gen_sine_table(w, mesh_seed=3, device=cuda_device)
    x0 = torch.arange(16, dtype=torch.float32, device=cuda_device) * n
    y0 = torch.full((16,), 64.0, device=cuda_device)
    out = EK.tile_noise(table, x0, y0, n, w.dx, w.dy, start_sin=start_sin)
    ref = N.tile_noise(table, x0, y0, n, w.dx, w.dy, start_sin=start_sin)
    assert ref.abs().max().item() > 1.0
    assert (out - ref).abs().max().item() < 1e-3


def test_tile_noise_kernel_far_origins(cuda_device):
    """256 tiles at the origins of chip_smoke.py's rate loop (x0 ~ 3.6e5
    grid units), where many sine arguments lie above 105,615."""
    from w3d_torch.ops import noise as N
    from w3d_torch.ops.cuda import noise_kernel as EK
    w = WorldConst()
    table = N.gen_sine_table(w, mesh_seed=3, device=cuda_device)
    x0 = torch.arange(256, dtype=torch.float32, device=cuda_device) * 128 + 360448.0
    y0 = torch.full((256,), 64.0, device=cuda_device)
    out = EK.tile_noise(table, x0, y0, 128, w.dx, w.dy)
    ref = N.tile_noise(table, x0, y0, 128, w.dx, w.dy)
    assert ref.abs().max().item() > 1.0
    assert (out - ref).abs().max().item() < 1e-3


@pytest.mark.parametrize("shape", [(32, 128, 128), (5, 7, 33), (5, 37, 61),
                                   (7, 9, 132)])
@pytest.mark.parametrize("zb", [None, 1, 3, 64])
def test_smoke_stencil_kernel_matches_plain(cuda_device, shape, zb):
    """F equal to its plain version to the bit, on float4 runs (nx % 4 ==
    0) and single cells, for the default z block and marches of 1, 3 (a
    ragged last block) and 64 layers (one block)."""
    from w3d_torch.ops.cuda import stencil_kernel as FK
    from w3d_torch.water import smoke as WS
    g = torch.Generator(device=cuda_device).manual_seed(2)
    s = torch.rand(shape, generator=g, device=cuda_device) * 5
    s[0, 0, 0], s[-1, -1, -1] = 150.0, -20.0     # both clamps
    assert torch.equal(FK.diffuse_smoke_open(s, zb=zb), WS.diffuse_smoke_open(s))


def _wide_narrow_inputs(copies, dev, n=10000):
    """The grouped wide scene and 10K objects uniform in [-2.5, 2.5]^3, a
    quarter of them inside its first duplicated sphere (exact ties on rows
    in different chunks)."""
    sp = wide_scene(copies, SC)
    g = PC.group_cobjs(SC.pack_cobjs(sp, device=dev))
    rg = np.random.default_rng(6)
    ins = [rg.uniform(-2.5, 2.5, n).astype(np.float32) for _ in range(3)]
    ins.append(rg.uniform(0.02, 0.2, n).astype(np.float32))
    s = next(c for c in sp.cobjs if c.shape == SC.COLL_SPHERE)
    for a in range(3):
        ins[a][:n // 4] = (s.p1[a] + rg.uniform(-0.5, 0.5, n // 4) * s.r1).astype(np.float32)
    return g, [torch.as_tensor(a, device=dev) for a in ins]


@pytest.mark.parametrize("copies,m", [(8, 536), (27, 1616)])
def test_narrow_kernel_wide_tables(cuda_device, copies, m):
    """C on tables of two and five 384-row chunks against its plain
    version, first index on ties that span chunks."""
    from w3d_torch.ops.cuda import narrow_kernel as NK
    g, ins = _wide_narrow_inputs(copies, cuda_device)
    assert g.size == m
    out = [a.cpu().numpy() for a in NK.deepest_hits(*ins, g)]
    ref = [a.cpu().numpy() for a in PC.deepest_hits_grouped(*ins, g)]
    pen_all = PC.sphere_cobj_test_grouped(*ins, g)[0].cpu().numpy()
    check_narrow("wide", out, ref, pen_all)
    top2 = -np.sort(-pen_all, axis=1)[:, :2]
    tie = ref[0] & (top2[:, 0] == top2[:, 1])
    assert tie.sum() > 1000
    for k in (5, 6):
        np.testing.assert_array_equal(out[k][tie], ref[k][tie])


@pytest.mark.parametrize("copies,m", [(8, 536), (27, 1616)])
def test_substep_kernel_wide_tables(cuda_device, copies, m):
    """G on tables of two and five chunks against its plain version, with
    tied rows in different chunks averaged."""
    g, ins = _wide_narrow_inputs(copies, cuda_device)
    assert g.size == m
    args = _substep_inputs(10000, g, cuda_device)
    args[:3] = ins[:3]
    args[7] = args[7] & ~2              # so the cobj-hit bit shows this substep's
    ref = _substep_vs_plain(args)
    assert int(((ref[7] & 2) != 0).sum()) > 3000


@pytest.mark.parametrize("scene", ["spheres", "seven_shapes"])
def test_narrow_and_substep_chunks_bitwise(cuda_device, scene):
    """The M = 112 and M = 80 scenes through a variant build whose chunks
    hold 64 rows (two chunks each) give C's and G's one-chunk outputs to
    the bit."""
    from w3d_torch.ops.cuda import narrow_kernel as NK
    from w3d_torch.ops.cuda import physics_kernel as GK
    sp = PM.spheres_scene() if scene == "spheres" else seven_shape_scene(SC)
    g = PC.group_cobjs(SC.pack_cobjs(sp, device=cuda_device))
    assert g.size == (112 if scene == "spheres" else 80)
    args = _substep_inputs(10000, g, cuda_device)
    nk64 = NK.KERNEL.variant("W3D_CHUNK_ROWS=64")
    gk64 = GK.KERNEL.variant("W3D_CHUNK_ROWS=64")
    nin = (*args[:3], args[8])
    for a, b in zip(NK.deepest_hits(*nin, g), NK.deepest_hits(*nin, g, kernel=nk64)):
        assert torch.equal(a, b)
    for a, b in zip(GK.substep(*args), GK.substep(*args, kernel=gk64)):
        assert torch.equal(a, b)
    assert nk64.launches == 1 and gk64.launches == 1


def test_erosion_kernel_padded_tiles(cuda_device):
    """The padded path's walk: 4 tiles of 128^2 with a roam ring of 4
    cells (136^2 maps, 221,952 bytes of shared memory a tile), 512
    droplets offset by the ring: bitwise equal to the plain version and to
    itself across two runs."""
    from w3d_torch.ops.cuda import erosion_kernel as EK
    rng = np.random.default_rng(8)
    hm = torch.as_tensor(rng.standard_normal((4, 128, 128)).astype(np.float32)
                         * 0.5 + 1.0, device=cuda_device)
    hm = torch.nn.functional.pad(hm[:, None], (E.PAD,) * 4, mode="replicate")[:, 0]
    hm = hm.contiguous()
    xi, zi = (t.expand(4, 512).contiguous()
              for t in E.droplet_starts(512, 128, 128, pad=E.PAD, device=cuda_device))
    g = torch.Generator(device=cuda_device).manual_seed(9)
    ang = E.draw_angles(512, 512, 64, g, device=cuda_device)[0].contiguous()
    p6 = E.pack_params(E.ErosionParams(water_plane_z=0.0, half_dxy=0.06,
                                       zmin=-2.0, zmax=2.0, rock_thresh=0.75),
                       cuda_device)
    out = EK.erosion_walk(hm, xi, zi, ang, p6)
    ref = E._walk_batch(hm, xi, zi, ang, p6)
    assert ref.abs().max().item() > 1e-3
    # droplets walked into the ring
    assert ref[:, :E.PAD].abs().max().item() > 0 or ref[:, -E.PAD:].abs().max().item() > 0
    assert torch.equal(out, ref)
    assert torch.equal(EK.erosion_walk(hm, xi, zi, ang, p6), out)


def test_fused_frame_runs_through_its_kernels(cuda_device):
    """step_objects_fused on the card: one substep launch per substep, the
    pair pass on every pair_every-th, no sample or narrow launch."""
    from w3d_torch.ops.cuda import (narrow_kernel, pairs_kernel,
                                    physics_kernel, sample_kernel)
    g = torch.Generator(device=cuda_device).manual_seed(0)
    pos, vel = PM.spawn(2048, g, device=cuda_device)
    sw = PM.build_spheres_world(pos, vel, device=cuda_device)
    ks = (physics_kernel.KERNEL, pairs_kernel.KERNEL, sample_kernel.KERNEL,
          narrow_kernel.KERNEL)
    before = [k.launches for k in ks]
    st = PS.step_objects_fused(sw.state, sw.env, sw.cobjs, sw.table,
                               substeps=4, pair_every=2)
    torch.cuda.synchronize()
    assert [k.launches - b for k, b in zip(ks, before)] == [4, 2, 0, 0]
    assert torch.isfinite(st.px).all() and int((st.status > 0).sum()) > 2000


def test_entry_runs_through_every_kernel(cuda_device):
    """entry()'s step on the card: finite tiles and state, every kernel
    launched."""
    from w3d_torch.ops.cuda import (erosion_kernel, sample_kernel,
                                    narrow_kernel, pairs_kernel)
    kernels = (erosion_kernel.KERNEL, sample_kernel.KERNEL,
               narrow_kernel.KERNEL, pairs_kernel.KERNEL)
    g = torch.Generator(device=cuda_device).manual_seed(0)
    fn, args = entry.entry(cuda_device, g, num_tiles=2, num_objects=512)
    before = [k.launches for k in kernels]
    tiles, st = fn(*args)
    torch.cuda.synchronize()
    assert all(k.launches > b for k, b in zip(kernels, before))
    assert torch.isfinite(tiles).all() and torch.isfinite(st.px).all()
    assert int((st.status > 0).sum()) > 400


def test_wrappers_reject_bad_input(cuda_device):
    from w3d_torch.ops.cuda import erosion_kernel as EK
    from w3d_torch.ops.cuda import sample_kernel as SK
    w = WorldConst()
    mesh = torch.zeros((128, 128), device=cuda_device)
    x = torch.zeros(10, device=cuda_device)
    with pytest.raises(ValueError):
        SK.sample_mesh(mesh, x.double(), x.double(), w)       # dtype
    with pytest.raises(ValueError):
        SK.sample_mesh(mesh.t(), x, x, w)                      # contiguity
    hm = torch.zeros((1, 16, 16), device=cuda_device)
    xi = torch.zeros((1, 2048), dtype=torch.int32, device=cuda_device)
    ang = torch.zeros((4, 2048), device=cuda_device)
    p6 = torch.zeros(6, device=cuda_device)
    with pytest.raises(ValueError):
        EK.erosion_walk(hm, xi, xi, ang, p6)                   # batch > 1024
    from w3d_torch.ops import noise as N
    from w3d_torch.ops.cuda import noise_kernel as NZ
    from w3d_torch.ops.cuda import physics_kernel as GK
    from w3d_torch.ops.cuda import stencil_kernel as FK
    table = N.gen_sine_table(w, device=cuda_device)
    with pytest.raises(ValueError):
        NZ.tile_noise(table, x, x, 512, w.dx, w.dy)            # tables > smem
    with pytest.raises(ValueError):
        FK.diffuse_smoke_open(mesh)                            # not 3-D
    g = PC.group_cobjs(SC.pack_cobjs(PM.spheres_scene(), device=cuda_device))
    from w3d_torch.ops.cuda import narrow_kernel as NK
    args = _substep_inputs(10, g, cuda_device)
    wide = torch.zeros((1000, 32), device=cuda_device)
    args[-2] = (wide, args[-2][1], NK.field_major(wide)[:, :-4])   # short copy
    with pytest.raises(ValueError):
        GK.substep(*args)


@pytest.mark.parametrize("kind", ["grouped", "plain"])
def test_player_kernels_match_plain(cuda_device, monkeypatch, kind):
    """step_player on the card takes kernel B (and C for a grouped scene)
    at N = 1; 60 ticks of falling, landing on the spheres scene's cobjs,
    walking and a jump, against the same ticks through the plain versions
    on the card (heights from B bitwise, C's pen 1e-5: 1e-5 on the
    state, on_ground equal), and against the CPU."""
    from w3d_torch.gameplay import player as PL
    from w3d_torch.ops.cuda import narrow_kernel as NK
    from w3d_torch.ops.cuda import sample_kernel as SK
    def scene(device):
        sc = SC.pack_cobjs(PM.spheres_scene(), device=device)
        return PC.group_cobjs(sc) if kind == "grouped" else sc

    cobjs = scene(cuda_device)
    rng = np.random.default_rng(8)
    mesh = torch.as_tensor(rng.standard_normal((128, 128)).astype(np.float32)
                           * 0.02 - 0.3, device=cuda_device)

    def run(cobjs, mesh, device):
        p = PL.make_player(0.4, -0.3, 1.0, device=device)
        out = []
        for i in range(60):
            p = PL.step_player(p, mesh, cobjs, np.cos(0.05 * i), np.sin(0.05 * i),
                               i == 45)
            out.append(torch.cat([p.x, p.y, p.z, p.vz, p.on_ground.float()]))
        return torch.stack(out).cpu()

    before = (SK.KERNEL.launches, NK.KERNEL.launches)
    kern = run(cobjs, mesh, cuda_device)
    assert SK.KERNEL.launches - before[0] == 60
    assert NK.KERNEL.launches - before[1] == (60 if kind == "grouped" else 0)
    cpu = run(scene("cpu"), mesh.cpu(), "cpu")
    monkeypatch.setattr(SK, "sample_mesh", PS.sample_mesh)
    monkeypatch.setattr(NK, "deepest_hits", lambda *a: PC.deepest_hits_grouped(*a))
    plain = run(cobjs, mesh, cuda_device)
    for ref in (plain, cpu):
        assert (kern[:, :4] - ref[:, :4]).abs().max().item() < 1e-5
        assert torch.equal(kern[:, 4], ref[:, 4])
    assert kern[:, 4].any()                                   # it stood


def test_gen_terrain_erosion_kernel_matches_plain(cuda_device, monkeypatch):
    """gen_terrain (simplex, 512 droplets) on the card erodes its padded
    136^2 map through kernel A: bitwise equal to the same call through
    A's plain version on the card."""
    from w3d_torch.ops.cuda import erosion_kernel as EK
    from w3d_torch.ops import noise as N
    from w3d_torch.terrain import mesh as TM
    cfg = TM.TerrainConfig(mode=N.MGEN_SIMPLEX, erosion_iters=512)
    g = torch.Generator(device=cuda_device).manual_seed(0)
    ang = E.draw_angles(512, 1024, 256, g, device=cuda_device)
    before = EK.KERNEL.launches
    out = TM.gen_terrain(cfg, angles=ang, device=cuda_device)
    assert EK.KERNEL.launches - before == 1
    flat = TM.gen_terrain(cfg._replace(erosion_iters=0), device=cuda_device)
    assert (out.mesh_height - flat.mesh_height).abs().max().item() > 1e-3
    monkeypatch.setattr(EK, "erosion_walk", E._walk_batch)
    ref = TM.gen_terrain(cfg, angles=ang, device=cuda_device)
    for a, b in zip(out, ref):
        assert torch.equal(a, b)


def test_ground_frames_run_through_their_kernels(cuda_device):
    """ground_frames_chained on the card: sample, narrow and pairs run on
    a grouped scene (narrow also for the player), sample and pairs on a
    plain CobjSet; `live` stays a device tensor."""
    from w3d_torch.gameplay import player as PL
    from w3d_torch.models import world as WM
    from w3d_torch.ops.cuda import narrow_kernel, pairs_kernel, sample_kernel
    from w3d_torch.water import ripples as WR
    ks = (sample_kernel.KERNEL, narrow_kernel.KERNEL, pairs_kernel.KERNEL)
    g = torch.Generator(device=cuda_device).manual_seed(0)
    pos, vel = PM.spawn(512, g, device=cuda_device)
    for group in (True, False):
        sw = PM.build_spheres_world(pos, vel, device=cuda_device, group_shapes=group)
        before = [k.launches for k in ks]
        st, rip, ply, live = WM.ground_frames_chained(
            sw.state, sw.env, sw.cobjs, sw.table,
            WR.make_ripples(128, 128, device=cuda_device),
            PL.make_player(device=cuda_device),
            torch.zeros((3, 2), device=cuda_device), WorldConst(), 3, substeps=2)
        got = [k.launches - b for k, b in zip(ks, before)]
        assert got == ([3 * 2 + 3, 3 * 2 + 3, 3 * 2] if group else [3 * 2 + 3, 0, 3 * 2])
        assert live.device.type == "cuda" and live.shape == (3,)
        assert torch.isfinite(st.px).all() and int(live[-1]) > 450


@pytest.mark.parametrize("n,radius", [(512, 10.0), (2048, 3.0)])
def test_asteroid_field_runs_through_the_pair_kernel(cuda_device, n, radius):
    """`step_asteroid_field` on the card launches kernel D once a step
    (window 32, the Morton-sorted field), and D agrees with its plain
    version on that field's order within 1e-6 and bit for bit from run to
    run; 8 steps on the card stay within 1e-5 of the same steps on the
    CPU."""
    from w3d_torch.ops.cuda import pairs_kernel as PK
    from w3d_torch.universe import asteroids as UA
    d = UA.draw_asteroid_field(n, torch.Generator().manual_seed(n), device="cpu")
    f_cpu = UA.gen_asteroid_field(d, radius)
    f = UA.gen_asteroid_field(UA.AsteroidDraws(*(t.to(cuda_device) for t in d)), radius)
    for a, b in zip(f, f_cpu):
        assert (a.cpu() - b).abs().max().item() <= 1e-5
    f = UA.AsteroidField(*(t.to(cuda_device) for t in f_cpu))    # the same start
    before = PK.KERNEL.launches
    for _ in range(8):
        f = UA.step_asteroid_field(f, radius, 1.0)
        f_cpu = UA.step_asteroid_field(f_cpu, radius, 1.0)
    assert PK.KERNEL.launches - before == 8
    for a, b in zip(f, f_cpu):
        if a.is_floating_point():
            assert (a.cpu() - b).abs().max().item() <= 1e-5
    order = torch.sort(PS.morton_key(f.px, f.py, 0.05 * radius, 2.0 * radius),
                       stable=True).indices
    ins = tuple(c[order].contiguous() for c in (f.px, f.py, f.pz, f.vx, f.vy, f.vz, f.radius))
    ins = ins + (ins[6] ** 3, torch.ones_like(ins[0]), torch.ones_like(ins[0], dtype=torch.bool))
    out = PK.banded_pairs(*ins, window=32)
    ref = PS.banded_pair_collisions(*ins, window=32)
    assert max((a - b).abs().max().item() for a, b in zip(out, ref)) <= 1e-6
    assert all(torch.equal(a, b) for a, b in zip(out, PK.banded_pairs(*ins, window=32)))

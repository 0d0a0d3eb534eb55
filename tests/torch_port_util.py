"""Shared helpers for the torch-port parity tests (tests/test_torch_*.py)."""

import numpy as np
import pytest
import torch


@pytest.fixture
def cuda_device():
    """The CUDA device for a kernel-vs-plain test; skips without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the GPU)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def np_tree(value):
    """JAX arrays -> numpy through NamedTuples / GroupedCobjs / tuples."""
    import jax
    return jax.tree.map(np.asarray, value)


def ulp_diff(a, b) -> np.ndarray:
    """Distance in float32 units in the last place, elementwise."""
    def ordered(x):
        i = np.asarray(x, np.float32).view(np.int32).astype(np.int64)
        return np.where(i < 0, -(i & 0x7FFFFFFF), i)
    return np.abs(ordered(a) - ordered(b))


def bumpy_world(n, water):
    """The JAX spheres world with `n` balls over a bumpy mesh, optionally
    with water.  Returns (world, SpheresWorld) with JAX arrays."""
    import jax.numpy as jnp
    from w3d.models import physics_model as JPM
    from w3d.utils.constants import WorldConst
    world = WorldConst()
    sw = JPM.build_spheres_world(num_objects=n, world=world)
    rng = np.random.default_rng(3)
    mesh = jnp.asarray(rng.standard_normal((world.mesh_y, world.mesh_x))
                       .astype(np.float32) * 0.3 - 0.5)
    env = sw.env._replace(mesh_height=mesh)
    if water:   # above the ground cube's top, so objects reach it
        env = env._replace(water_plane_z=jnp.float32(0.25))
    # spawn close to the ground, fast and mostly downward, so cobj, water
    # and pair contacts happen within 3 substeps.  Fast contacts bounce off;
    # a contact that comes to rest sits at zero penetration, where a single
    # rounding decides the next substep's collided flag.
    st = sw.state
    st = st._replace(pz=st.pz * 0.25 - 0.3, vx=st.vx * 12, vy=st.vy * 12,
                     vz=st.vz * 12 - 4.0)
    return world, sw._replace(env=env, state=st)


def jax_angle_tables(num_iters: int, batch_size: int, max_steps: int,
                     seed: int = 0) -> np.ndarray:
    """The JAX erosion paths' flat-spot draws, [num_batches, steps, B]:
    keys split from key(seed, 0xE05) per batch, one uniform row per step
    (ops/erosion.erode, erosion_kernel._angle_table)."""
    import jax
    from w3d.utils import rng as w3d_rng
    from w3d.ops.pallas.erosion_kernel import _angle_table
    nb = -(-num_iters // batch_size)
    keys = jax.random.split(w3d_rng.key(seed, 0xE05), nb)
    return np.stack([np.asarray(_angle_table(keys[b], max_steps, batch_size))
                     for b in range(nb)])


def seven_shape_scene(SC):
    """tests/test_pallas.py::test_pallas_narrow_phase_matches_xla's scene:
    every shape group plus dead padding slots, built with `SC`'s classes."""
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

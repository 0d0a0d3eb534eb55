"""Shared helpers for the torch-port parity tests (tests/test_torch_*.py)."""

import dataclasses

import numpy as np
import pytest
import torch

from w3d_torch.utils.kernel_probe import seven_shape_scene, wide_scene  # noqa: F401


@pytest.fixture
def cuda_device():
    """The CUDA device for a kernel-vs-plain test; skips without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the GPU)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One PyTorch intra-op thread for each test of a module that imports
    this fixture: the Tier-1 run puts six test processes on the machine's
    cores, and each process's spinning OpenMP threads oversubscribe them
    (measured: two such processes ran 16 tests in 453 s, in 29 s with one
    thread each)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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


def narrow_case(case: str, SC, n: int, seed: int = 3):
    """(scene, [px, py, pz, radius] float32 numpy) of one narrow-phase
    parity case, built with `SC`'s classes:

    - "base": the seven-shape scene, objects uniform in [-2.5, 2.5]^3;
    - "far": the same objects at z = 50, farther than 1 from every cobj, so
      each takes the first dead padding slot (pen -1, zero normal);
    - "ties": spheres 3 and 12 of the scene replaced by copies of spheres 0
      and 5 under another layer (elasticity 0.3, friction 0.2), so each pair
      ties exactly in pen and normal and the winner's elasticity shows which
      row won.  In the packed order the pairs are sphere-group rows 0 and 3
      (lanes 0 and 3 of an 8-lane team) and 5 and 12 (lane 5 of one pass,
      lane 4 of the next); a quarter of the objects sit inside them;
    - "wide": the scene's positive cobjs copied twice more, each copy
      shifted, so the table holds 129 to 384 slots (M = 200).
    """
    sp = seven_shape_scene(SC)
    rg = np.random.default_rng(seed)
    p = [rg.uniform(-2.5, 2.5, n).astype(np.float32) for _ in range(3)]
    rad = rg.uniform(0.02, 0.2, n).astype(np.float32)
    if case == "far":
        p[2] = np.full(n, 50.0, np.float32)
    elif case == "ties":
        spheres = [k for k, c in enumerate(sp.cobjs) if c.shape == SC.COLL_SPHERE]
        dup = SC.CobjLayer(elasticity=0.3, friction=0.2)
        for src, dst in ((0, 3), (5, 12)):
            s = sp.cobjs[spheres[src]]
            sp.cobjs[spheres[dst]] = SC.RawCobj(SC.COLL_SPHERE, s.p1, r1=s.r1,
                                                layer=dup)
        for k, src in enumerate((0, 5)):
            s = sp.cobjs[spheres[src]]
            sel = slice(k, n // 4, 2)
            for a in range(3):
                m = len(p[a][sel])
                p[a][sel] = (s.p1[a] + rg.uniform(-0.5, 0.5, m) * s.r1).astype(np.float32)
    elif case == "wide":
        base = [c for c in sp.cobjs if not c.negative]
        for k in (1, 2):
            d = np.asarray([0.31, -0.17, 0.23]) * k
            for c in base:
                sp.cobjs.append(dataclasses.replace(
                    c, p1=tuple(np.asarray(c.p1) + d),
                    # a torus's p2 is its axis, not a point
                    p2=c.p2 if c.shape == SC.COLL_TORUS else tuple(np.asarray(c.p2) + d),
                    pts=tuple(tuple(np.asarray(q) + d) for q in c.pts)))
    elif case != "base":
        raise ValueError(case)
    return sp, p + [rad]


# sphere-group rows of the three coincident spheres in `tied_spheres_scene`:
# lanes 0, 3 and 5 of an 8-lane team (row 13 in the team's second pass)
TIED_ROWS = (0, 3, 13)


def tied_spheres_scene(SC):
    """(scene, centre, radius), built with `SC`'s classes: a ground cube
    and 16 spheres, of which sphere-group rows `TIED_ROWS` share one centre
    and radius under three layers of different elasticity and friction, so
    an object inside that sphere penetrates three rows equally deep and the
    fused substep averages them."""
    sp = SC.SceneParse()
    sp.cobjs.append(SC.RawCobj(SC.COLL_CUBE, (-4.0, -4.0, -0.7), (4.0, 4.0, 0.0),
                               layer=SC.CobjLayer(elasticity=0.9)))
    rg = np.random.default_rng(4)
    lay = SC.CobjLayer(elasticity=0.7, friction=0.4)
    centre, radius = (0.3, -0.2, 1.2), 0.45
    tied = {TIED_ROWS[0]: SC.CobjLayer(elasticity=0.8, friction=0.6),
            TIED_ROWS[1]: SC.CobjLayer(elasticity=0.3, friction=0.2),
            TIED_ROWS[2]: SC.CobjLayer(elasticity=0.5, friction=1.3)}
    for k in range(16):
        if k in tied:
            sp.cobjs.append(SC.RawCobj(SC.COLL_SPHERE, centre, r1=radius,
                                       layer=tied[k]))
        else:
            p = (float(rg.uniform(-2.5, 2.5)), float(rg.uniform(-2.5, 2.5)),
                 float(rg.uniform(-0.5, 0.5)))
            sp.cobjs.append(SC.RawCobj(SC.COLL_SPHERE, p,
                                       r1=float(rg.uniform(0.1, 0.3)), layer=lay))
    return sp, centre, radius


def into_tied_sphere(px, py, pz, centre, radius, k: int, seed: int = 9):
    """px, py, pz (float32 numpy) with the first `k` objects moved to
    random points inside the tied sphere (within half its radius of the
    centre)."""
    rg = np.random.default_rng(seed)
    out = []
    for a, c in zip((px, py, pz), centre):
        a = np.array(a, np.float32)
        a[:k] = (c + rg.uniform(-0.5, 0.5, k) * radius).astype(np.float32)
        out.append(a)
    return out


def check_narrow(case: str, out, ref, pen_all) -> None:
    """Hold a narrow-phase result against its reference, both (hit, pen, nx,
    ny, nz, elas, fric) numpy arrays; `pen_all` [N, M] is the reference's
    pen on every slot.  Hit mask equal, pen within 1e-5 on every lane, the
    winner's fields within 1e-5 where the argmax margin exceeds 1e-4; per
    case, that the case happened: hits ("base"), the first dead slot on
    every lane ("far"), the first of two tied rows ("ties")."""
    n = len(ref[0])
    np.testing.assert_array_equal(out[0], ref[0])
    np.testing.assert_allclose(out[1], ref[1], rtol=0, atol=1e-5)
    top2 = -np.sort(-pen_all, axis=1)[:, :2]
    robust = ref[0] & ((top2[:, 0] - top2[:, 1]) > 1e-4)
    for a, b in zip(ref[2:], out[2:]):
        assert np.abs(np.where(robust, a - b, 0.0)).max() < 1e-5
    if case in ("base", "wide"):
        assert ref[0].sum() > 0.05 * n
    elif case == "far":
        assert not ref[0].any() and (ref[1] == -1.0).all()
        for a, b in zip(ref[2:], out[2:]):
            assert not a.any() and not b.any()
    else:
        tie = ref[0] & (top2[:, 0] == top2[:, 1])
        assert tie.sum() > 0.05 * n
        assert (ref[5][tie] == np.float32(0.8)).all()   # the first row's layer
        for k in (2, 3, 4):
            assert np.abs(out[k][tie] - ref[k][tie]).max() < 1e-5
        for k in (5, 6):
            np.testing.assert_array_equal(out[k][tie], ref[k][tie])


def jax_city_draws(key, frames: int, n_peds: int, n_helis: int = 0, n_pads: int = 1,
                   n_birds: int = 0, n_perches: int = 1):
    """The JAX city frame's threefry draws for `frames` frames from the
    city state's key (the JAX package's `city_step._one_frame`: split five ways a frame;
    `traffic.step_peds`, `step_helis`, `step_birds`), as the port's
    `CityDraws` on the CPU.  Returns (draws, the key after the chunk)."""
    import jax
    from w3d_torch.city.city_step import CityDraws
    r = jax.random
    rows = {f: [] for f in CityDraws._fields}
    for _ in range(frames):
        key, _k1, k2, k3, k4 = r.split(key, 5)
        a, b, c = r.split(k2, 3)
        rows["ped_u"].append(r.uniform(a, (n_peds,)))
        rows["ped_side"].append(r.randint(b, (n_peds,), 0, 4))
        rows["ped_u3"].append(r.uniform(c, (n_peds,)))
        rows["ped_u4"].append(r.uniform(r.fold_in(c, 1), (n_peds,)))
        if n_helis:
            rows["heli_pad"].append(r.randint(k3, (n_helis,), 0, n_pads))
            rows["heli_wait"].append(r.randint(r.fold_in(k3, 1), (n_helis,), 30, 120))
        if n_birds:
            rows["bird_perch"].append(r.randint(k4, (n_birds,), 0, n_perches))
            rows["bird_wait"].append(r.randint(r.fold_in(k4, 1), (n_birds,), 60, 400))
    t = lambda v: torch.as_tensor(np.stack([np.asarray(x) for x in v])) if v else None
    return CityDraws(**{f: t(v) for f, v in rows.items()}), key


def jax_fauna_draws(key, frames: int, n_birds: int, n_bfly: int, n_fish: int):
    """`veg/animals.step_tiled_fauna`'s threefry draws from its chunk key
    (`fold_in(key, i)` for frame i, then 1, 2, 3 for the birds, the
    butterflies and the fish), as the port's `FaunaDraws`."""
    import jax
    from w3d_torch.veg.animals import FaunaDraws
    r = jax.random
    rows = {f: [] for f in FaunaDraws._fields}
    for i in range(frames):
        kk = r.fold_in(key, i)
        k1, k2, k3 = r.split(r.fold_in(kk, 1), 3)
        rows["bird_turn"].append(r.uniform(k1, (n_birds,)))
        rows["bird_jx"].append(r.uniform(k2, (n_birds,), minval=-1.0, maxval=1.0))
        rows["bird_jy"].append(r.uniform(k3, (n_birds,), minval=-1.0, maxval=1.0))
        ks = r.split(r.fold_in(kk, 2), 6)
        rows["bfly_explore"].append(r.uniform(ks[0], (n_bfly,)))
        for name, k in (("bfly_fwd", ks[1]), ("bfly_rot", ks[2]), ("bfly_alt", ks[3])):
            rows[name].append(r.uniform(k, (n_bfly,), minval=-1.0, maxval=1.0))
        rows["bfly_rest"].append(r.uniform(ks[4], (n_bfly,)))
        k1, k2, k3 = r.split(r.fold_in(kk, 3), 3)
        rows["fish_rnd"].append(r.randint(k1, (n_fish,), 0, 128))
        rows["fish_jx"].append(r.uniform(k2, (n_fish,), minval=-1.0, maxval=1.0))
        rows["fish_jy"].append(r.uniform(k3, (n_fish,), minval=-1.0, maxval=1.0))
        rows["fish_ang"].append(r.uniform(r.fold_in(k1, 1), (n_fish,), minval=0.0,
                                          maxval=2 * np.pi))
    return FaunaDraws(**{f: torch.as_tensor(np.stack([np.asarray(x) for x in v]))
                         for f, v in rows.items()})


def jax_spawn_rows(key, kind: str, n: int, world=None) -> torch.Tensor:
    """The uniform rows the JAX spawners draw from `key`:
    `make_animals` (six, spread 1), `make_butterflies` or `gen_fish`
    (four), as the port's spawners take them."""
    import jax
    r = jax.random
    if kind == "animals":
        ks = r.split(key, 6)
        rng = ((-1.0, 1.0), (-1.0, 1.0), (-0.2, 0.2), (-0.01, 0.01), (-0.01, 0.01),
               (-0.002, 0.002))
    else:
        ks = r.split(key, 4)
        xy = ((-world.x_scene, world.x_scene), (-world.y_scene, world.y_scene))
        rng = xy + (((0.0, 2 * np.pi), (0.2, 0.8)) if kind == "butterflies"
                    else ((0.0, 1.0), (0.0, 2 * np.pi)))
    return torch.as_tensor(np.stack([np.asarray(r.uniform(k, (n,), minval=lo, maxval=hi))
                                     for k, (lo, hi) in zip(ks, rng)]))


def jax_tiled_draws(seed: int):
    """An `app.TiledDraws` that replays the JAX app's key chain: the city
    state's key(seed), and the fauna's key(seed ^ 0xFA0A) with its spawn
    folds 0, 1, 2 and chunk folds 100 + i.  The city draws must be asked
    for chunk by chunk, in order."""
    import jax
    from w3d_torch.app import TiledDraws

    class JaxTiledDraws(TiledDraws):
        def __init__(self, seed):
            super().__init__(seed)
            self.key = jax.random.key(seed)
            self.fk = jax.random.key(seed ^ 0xFA0A)

        def city(self, frame, frames, w):
            cs = w.city
            count = lambda v: 0 if v is None else v.shape[0]
            d, self.key = jax_city_draws(
                self.key, frames, cs.peds.x.shape[0], count(cs.helis and cs.helis.px),
                count(w.pads), count(cs.birds and cs.birds.px), count(w.perches))
            dev = cs.peds.x.device
            return type(d)(*(None if v is None else v.to(dev) for v in d))

        def fauna(self, frame, frames, n_birds, n_bfly, n_fish, device):
            d = jax_fauna_draws(jax.random.fold_in(self.fk, 100 + frame), frames,
                                n_birds, n_bfly, n_fish)
            return type(d)(*(v.to(device) for v in d))

        def fauna_birds(self, n, device):
            return jax_spawn_rows(self.fk, "animals", n).to(device)

        def butterflies(self, n, world, device):
            return jax_spawn_rows(jax.random.fold_in(self.fk, 1), "butterflies", n,
                                  world).to(device)

        def fish(self, n, world, device):
            return jax_spawn_rows(jax.random.fold_in(self.fk, 2), "fish", n,
                                  world).to(device)

    return JaxTiledDraws(seed)


# ---------------------------------------------------------------------------
# universe mode: the JAX package's threefry draws as the port's inputs
# ---------------------------------------------------------------------------

def jax_fleet_draws(key, n: int, num_teams: int = 2, spread: float = 2.0):
    """`universe/ships.make_fleet`'s draws from `key` (split six ways), as
    the port's `FleetDraws` on the CPU."""
    import jax
    from w3d_torch.universe.ships import FleetDraws
    r = jax.random
    ks = r.split(key, 6)
    u = lambda k: r.uniform(k, (n,), minval=-spread, maxval=spread)
    d = (r.randint(ks[0], (n,), 0, 4), u(ks[1]), u(ks[2]), u(ks[3]),
         r.randint(ks[4], (n,), 0, num_teams), r.uniform(ks[5], (n,)))
    return FleetDraws(*(torch.as_tensor(np.array(a)) for a in d))


def jax_combat_draws(key, frames: int, n: int, slots: int):
    """`universe/combat.combat_frames_chained`'s draws from `key` (split
    `frames` ways, then four ways a frame), as the port's `CombatDraws`
    with a leading [frames] axis on the CPU."""
    import jax
    from w3d_torch.universe.combat import CombatDraws
    r = jax.random
    rows = [[], [], [], []]
    for k in r.split(key, frames):
        ke, ks, k1, k2 = r.split(k, 4)
        rows[0].append(r.normal(ke, (n, slots, 3)))
        rows[1].append(r.normal(ks, (n * slots, 3)))
        rows[2].append(r.randint(k1, (n,), 0, 100))
        rows[3].append(r.randint(k2, (n,), 0, 100))
    return CombatDraws(*(torch.as_tensor(np.stack([np.asarray(x) for x in v])) for v in rows))


def jax_asteroid_draws(key, n: int):
    """`universe/asteroids.gen_asteroid_field`'s draws from `key` (split
    six ways, and `fold_in(key, 9)` for the model seeds), as the port's
    `AsteroidDraws` on the CPU."""
    import jax
    from w3d_torch.universe.asteroids import AsteroidDraws
    r = jax.random
    ks = r.split(key, 6)
    d = (r.uniform(ks[0], (n,)), r.uniform(ks[1], (n,), minval=-1.0, maxval=1.0),
         r.uniform(ks[2], (n,), minval=0.0, maxval=2 * np.pi), r.normal(ks[3], (3, n)),
         r.uniform(ks[4], (n,), minval=-1.2, maxval=0.8),
         r.uniform(ks[5], (n,), minval=-1.0, maxval=1.0),
         r.randint(r.fold_in(key, 9), (n,), 0, 1 << 30))
    return AsteroidDraws(*(torch.as_tensor(np.array(a)) for a in d))


def jax_fleet_positions(key):
    """`fleet_from_defs`' position draw from `key`: n -> [n, 3] uniform
    [-1, 1)."""
    import jax
    return lambda n: np.asarray(jax.random.uniform(key, (n, 3), minval=-1.0, maxval=1.0))


def jax_universe_draws(seed: int):
    """An `app.UniverseDraws` that replays the JAX app's key chain:
    `key(seed)` for the fleet, the world's `key(1)` folded with the
    chunk's first frame for the combat frames."""
    import jax
    from w3d_torch.app import UniverseDraws

    class JaxUniverseDraws(UniverseDraws):
        def fleet(self, n, device):
            d = jax_fleet_draws(jax.random.key(self.seed), n)
            return type(d)(*(t.to(device) for t in d))

        def fleet_positions(self, n):
            return jax_fleet_positions(jax.random.key(self.seed))(n)

        def combat(self, frame, frames, n, slots, device):
            d = jax_combat_draws(jax.random.fold_in(jax.random.key(1), frame), frames, n,
                                 slots)
            return type(d)(*(t.to(device) for t in d))

    return JaxUniverseDraws(seed)


def same_tree(port, ref, tol: float = 1e-5, what: str = "") -> None:
    """A port value (tensors in NamedTuples, None fields allowed) against a
    JAX one: floats within `tol` (infinities equal), every other field
    equal."""
    from w3d_torch import convert
    port, ref = convert.to_numpy(port), np_tree(ref)
    if hasattr(ref, "_fields"):
        for f in ref._fields:
            same_tree(getattr(port, f), getattr(ref, f), tol, f"{what}.{f}")
        return
    if ref is None:
        assert port is None, what
        return
    a, b = np.asarray(port), np.asarray(ref)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    if b.dtype.kind == "f":
        np.testing.assert_array_equal(np.isinf(a), np.isinf(b), err_msg=what)
        fin = np.isfinite(b)
        np.testing.assert_allclose(a[fin], b[fin], rtol=0, atol=tol, err_msg=what)
    else:
        np.testing.assert_array_equal(a.astype(np.int64), b.astype(np.int64), err_msg=what)


# ---------------------------------------------------------------------------
# lighting: the JAX tracer's threefry draws as the port's TraceDraws
# ---------------------------------------------------------------------------

def jax_trace_draws(key, device="cpu"):
    """A `lighting.trace.TraceDraws` that replays the draws the JAX
    package takes from `key`: ray generation from its split (6 ways for
    sky rays, 2 global, 3 local, 8 scene lights), bounce b from
    `split(key, max_bounces)[b]` (`fold_in(key, b)` on the compact path),
    then `fold_in(., 7)` for the branch pick, split 3 ways (the first
    split again for the scatter pair, the others for the jitter, and
    `fold_in(k3, 2)` for the specular pick); compaction after bounce b
    from `fold_in(key, 0x707 + b)`."""
    import jax
    from w3d_torch.lighting.trace import TraceDraws, BounceDraws
    r = jax.random
    t = lambda a: torch.as_tensor(np.array(a)).to(device)

    class JaxTraceDraws(TraceDraws):
        def __init__(self):
            self.device = torch.device(device)

        def rays(self, splits, i, shape, kind="uniform", lo=0.0, hi=1.0):
            k = r.split(key, splits)[i]
            if kind == "uniform":
                return t(r.uniform(k, shape, minval=lo, maxval=hi))
            if kind == "normal":
                return t(r.normal(k, shape))
            return t(r.randint(k, shape, 0, hi)).to(torch.int64)

        def bounce(self, b, n, params):
            kd = r.fold_in(key, b) if params.compact else r.split(key, params.max_bounces)[b]
            u_t = t(r.uniform(r.fold_in(kd, 7), (n,))) if params.transmission else None
            k1, k2, k3 = r.split(kd, 3)
            ku, kv = r.split(k1)
            u, v = t(r.uniform(ku, (n,))), t(r.uniform(kv, (n,)))
            if not params.specular_enabled:
                return BounceDraws(u_t, u, v, None, None, None)
            return BounceDraws(u_t, u, v, t(r.uniform(k2, (n,))), t(r.uniform(k3, (n,))),
                               t(r.uniform(r.fold_in(k3, 2), (n,))))

        def compact(self, b, n):
            return t(r.uniform(r.fold_in(key, 0x707 + b), (n,)))

    return JaxTraceDraws()


def jax_draw_source(device="cpu"):
    """A `lighting.trace.DrawSource` that replays the JAX key of each
    stream: `key(s)` for a one-integer stream (platform deltas, dlight
    groups, building lights), `fold_in(w3d_rng.key(seed, tag, i), part)`
    for a driver's (seed, tag, i, part)."""
    import jax
    from w3d.utils import rng as w3d_rng
    from w3d_torch.lighting.trace import DrawSource

    class JaxDrawSource(DrawSource):
        def __call__(self, *parts):
            if len(parts) == 1:
                return jax_trace_draws(jax.random.key(parts[0]), device)
            return jax_trace_draws(jax.random.fold_in(w3d_rng.key(*parts[:3]), parts[3]),
                                   device)

    return JaxDrawSource(device)


# ---------------------------------------------------------------------------
# vegetation and building animals: the JAX threefry draws as the port's inputs
# ---------------------------------------------------------------------------

def jax_tree_draws(key, t: int):
    """`veg/trees.gen_trees`' draws for t trees from `key` (split 8 ways;
    the branch keys 3 and 4 split 4 ways, the leaf key 5 three ways), as
    the port's `TreeDraws` on the CPU."""
    import jax
    from w3d_torch.veg.trees import (TreeDraws, TREE_DRAW_RANGES, _tree_draw_shapes)
    r = jax.random
    ks = r.split(key, 8)
    keys = [ks[0], ks[1], ks[2], *r.split(ks[3], 4), *r.split(ks[4], 4), *r.split(ks[5], 3)]
    out = []
    for k, shape, rng in zip(keys, _tree_draw_shapes(t), TREE_DRAW_RANGES):
        v = r.normal(k, shape) if rng is None else r.uniform(k, shape, minval=rng[0],
                                                              maxval=rng[1])
        out.append(torch.as_tensor(np.array(v)))
    return TreeDraws(*out)


def jax_small_tree_draws(key, n: int):
    """`gen_small_trees`' draws from `key` (split 3 ways) as `SmallTreeDraws`."""
    import jax
    from w3d_torch.veg.trees import SmallTreeDraws
    r = jax.random
    k1, k2, k3 = r.split(key, 3)
    return SmallTreeDraws(*(torch.as_tensor(np.array(v)) for v in (
        r.uniform(k1, (n,), minval=0.8, maxval=1.4), r.uniform(k2, (n,), minval=0.8, maxval=1.2),
        r.uniform(k3, (n,)))))


def jax_uniform_rows(key, splits: int, n: int, ranges) -> torch.Tensor:
    """A spawner's [len(ranges), n] uniform rows from `key` split `splits`
    ways (`make_spiders`: 6 ways, 5 used; `make_snakes`: 4; `make_animals`:
    6)."""
    import jax
    ks = jax.random.split(key, splits)
    return torch.as_tensor(np.stack([np.asarray(jax.random.uniform(k, (n,), minval=lo,
                                                                   maxval=hi))
                                     for k, (lo, hi) in zip(ks, ranges)]))


def jax_building_animal_draws(keys, n_spiders: int, n_snakes: int, n_flies: int,
                              ceil_z: float = 0.5):
    """The building animals' step draws from one key a tick
    (`step_spiders`: split 3 ways; `step_snakes`: 2; `step_flies`: 3
    normals), as the port's `BuildingAnimalDraws` [K, ...]: `keys` is a
    list of (spider_key, snake_key, fly_key) per tick."""
    import jax
    from w3d_torch.veg.animals import BuildingAnimalDraws
    r = jax.random
    rows = {f: [] for f in BuildingAnimalDraws._fields}
    for ks, kn, kf in keys:
        k1, k2, k3 = r.split(ks, 3)
        rows["spider_turn"].append(r.uniform(k1, (n_spiders,)))
        rows["spider_ang"].append(r.uniform(k2, (n_spiders,), minval=0.0, maxval=2.0 * np.pi))
        rows["spider_tz"].append(r.uniform(k3, (n_spiders,), minval=0.0, maxval=ceil_z))
        k1, k2 = r.split(kn)
        rows["snake_turn"].append(r.uniform(k1, (n_snakes,)))
        rows["snake_dth"].append(r.uniform(k2, (n_snakes,), minval=-0.8, maxval=0.8))
        rows["fly_jitter"].append(np.stack([np.asarray(r.normal(k, (n_flies,)))
                                            for k in r.split(kf, 3)]))
    return BuildingAnimalDraws(**{f: torch.as_tensor(np.stack([np.asarray(x) for x in v]))
                                  for f, v in rows.items()})


def jax_world_draws():
    """A `full_world.WorldDraws` that replays the JAX example's keys: the
    erosion's key 0 (`jax_angle_tables`), `fold_in(key(0), 100 + i)` for
    helicopter step i, the city state's key(4), the spheres world's
    key(1) (split 3 ways for the positions, `fold_in(., 9)` for the
    velocities) and key(0) for the bake (`jax_trace_draws`, and its sky
    rays as the JAX package makes them)."""
    import jax
    from w3d_torch.full_world import WorldDraws, EROSION_BATCH, EROSION_STEPS
    r = jax.random

    class JaxWorldDraws(WorldDraws):
        def erosion_angles(self, iters, device):
            return torch.as_tensor(jax_angle_tables(iters, EROSION_BATCH,
                                                    EROSION_STEPS)).to(device)

        def helis(self, steps, n_helis, n_pads, device):
            pad, wait = [], []
            for i in range(steps):
                k = r.fold_in(r.key(0), 100 + i)
                pad.append(np.asarray(r.randint(k, (n_helis,), 0, n_pads)))
                wait.append(np.asarray(r.randint(r.fold_in(k, 1), (n_helis,), 30, 120)))
            return (torch.as_tensor(np.stack(pad)).to(device),
                    torch.as_tensor(np.stack(wait)).to(device))

        def city(self, frames, n_peds, device):
            d, _ = jax_city_draws(r.key(4), frames, n_peds)
            return type(d)(*(None if v is None else v.to(device) for v in d))

        def spawn(self, n, device):
            k = r.key(1)
            k1, k2, k3 = r.split(k, 3)
            pos = np.stack([np.asarray(r.uniform(k1, (n,), np.float32, -3.0, 3.0)),
                            np.asarray(r.uniform(k2, (n,), np.float32, -3.0, 3.0)),
                            np.asarray(r.uniform(k3, (n,), np.float32, 0.5, 3.5))], axis=-1)
            vel = np.asarray(r.normal(r.fold_in(k, 9), (n, 3))) * np.float32(0.5)
            return torch.as_tensor(pos).to(device), torch.as_tensor(vel).to(device)

        def trace(self, device):
            return jax_trace_draws(r.key(0), device)

        def bake_rays(self, td, n, world):
            # the JAX rays, made op by op: the port's sines and cosines round
            # an ulp from XLA's, which moves a sample into the next cell
            from w3d.lighting import trace as JT
            from w3d.utils.constants import WorldConst as JWorld
            with jax.disable_jit():
                rays = JT.sky_rays(r.key(0), n, JWorld(mesh_x=world.mesh_x,
                                                       mesh_y=world.mesh_y))
            return tuple(torch.as_tensor(np.asarray(v)).to(td.device) for v in rays)

    return JaxWorldDraws()

"""Torch port vs JAX package: trees (`veg/trees`), grass, flowers and the
ground fire (`veg/grass`), and the building animals (`veg/animals`:
spiders, snakes, flies, tank fish), on seeded numpy inputs with the JAX
threefry draws fed to the port (`torch_port_util.jax_tree_draws`,
`jax_building_animal_draws`).

Tolerances: tree geometry, leaf colors and the animals within 1e-5 (the
port's sines and cosines are float64-rounded, XLA's float32 ones differ
by an ulp, which a 0.3-unit branch scales to ~1e-7); tree placement,
grass and flower masks, hashes and integer fields equal; grass, flower
and fire floats within 1e-5."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import w3d  # noqa: F401
from w3d.veg import trees as JVT, grass as JVG, animals as JVA
from w3d.terrain import tiles as JTL, mesh as JM
from w3d.utils.constants import WorldConst as JWorld

from w3d_torch import convert
from w3d_torch.veg import trees as TVT, grass as TVG, animals as TVA
from w3d_torch.terrain import tiles as TTL, mesh as TM
from w3d_torch.utils.constants import WorldConst as TWorld

from torch_port_util import (one_torch_thread, same_tree, jax_tree_draws,  # noqa: F401
                             jax_small_tree_draws, jax_uniform_rows,
                             jax_building_animal_draws)

JW, TW = JWorld(), TWorld()


def _field(seed, shape, lo=0.0, hi=1.0):
    return (lo + (hi - lo) * np.random.default_rng(seed).random(shape)).astype(np.float32)


def _biomes(seed, n):
    """Random biome weights [5, n, n] summing to 1."""
    w = _field(seed, (5, n, n)) ** 3
    return (w / w.sum(0, keepdims=True)).astype(np.float32)


def _t(a):
    return torch.as_tensor(np.asarray(a))


@pytest.fixture(scope="module")
def trees():
    """Eight trees of every type at seeded bases, from the JAX draws."""
    n = 8
    bx, by, bz = (_field(s, (n,), -2.0, 2.0) for s in (1, 2, 3))
    tid = (np.arange(n) % JVT.NUM_TREE_TYPES).astype(np.int32)
    key = jax.random.key(11)
    ref = JVT.gen_trees(key, jnp.asarray(bx), jnp.asarray(by), jnp.asarray(bz),
                        jnp.asarray(tid), height_scale=1.3)
    out = TVT.gen_trees(jax_tree_draws(key, n), _t(bx), _t(by), _t(bz), _t(tid),
                        height_scale=1.3)
    return ref, out, tid


def test_gen_trees_matches(trees):
    ref, out, _ = trees
    same_tree(out, ref, 1e-5, "trees")


def test_small_trees_match():
    n = 16
    x = _field(4, (n,))
    key = jax.random.key(5)
    ref = JVT.gen_small_trees(key, jnp.asarray(x), jnp.asarray(x), jnp.asarray(x))
    out = TVT.gen_small_trees(jax_small_tree_draws(key, n), _t(x), _t(x), _t(x))
    same_tree(out, ref, 1e-6, "small trees")


def test_leaf_dynamics_match(trees):
    """init, drop (with a frame long enough to drop), burn above the leaf
    temperature and a blast among the leaves, each on the JAX draws;
    then spraypaint.  The blast and the spray take the JAX trees' leaves,
    and the JAX blast runs op by op: near the blast's edge 1 - |d| / r
    cancels, so an ulp of the squared distance (a leaf an ulp away, or
    XLA's fused multiply-adds) moves a leaf's color by ~0.003 of its
    0-1000 scale.  Op by op the JAX function multiplies the Python scalars
    1e-4 * damage in float64, the port (like the compiled function) in
    float32, so colors agree within 2 ulp of that scale (1.2e-4)."""
    jt, _, tid = trees
    tt = TVT.TreeSet(*(_t(f) for f in jt))
    r = jax.random
    T, L = jt.leaf_x.shape
    k0 = r.key(21)
    jls = JVT.init_leaves(k0, jnp.asarray(tid), deadness=0.3, coherence=0.2)
    k1, _ = r.split(k0)
    tls = TVT.init_leaves(_t(r.normal(k1, (T, JVT.MAX_LEAVES, 3))), _t(tid),
                          deadness=0.3, coherence=0.2)
    same_tree(tls, jls, 1e-6, "init")
    kd = r.key(22)
    a, b = r.split(kd)
    jls2, jfell = JVT.drop_leaves(jls, kd, fticks=5000.0)
    _, tfell = TVT.drop_leaves(tls, _t(r.randint(a, (T, 1), 0, JVT.LEAF_GEN_RAND1)),
                               _t(r.uniform(b, (T, L))), fticks=5000.0)
    np.testing.assert_array_equal(tfell.numpy(), np.asarray(jfell))
    assert tfell.any()
    kb = r.key(23)
    jb_, jch = JVT.burn_leaves(jls, kb, 290.0)
    tb_, tch = TVT.burn_leaves(tls, _t(r.uniform(kb, (T, L))), 290.0)
    same_tree(tb_, jb_, 1e-5, "burn")
    np.testing.assert_array_equal(tch.numpy(), np.asarray(jch))
    bx, by, bz = (float(v) for v in (jt.leaf_x[0, 7], jt.leaf_y[0, 7], jt.leaf_z[0, 7]))
    kx = r.key(24)
    with jax.disable_jit():     # compiled, XLA fuses the squares into FMAs
        jx_, jf = JVT.blast_damage_leaves(jls, jt, kx, bx, by, bz, 0.3, 80.0)
    tx_, tf = TVT.blast_damage_leaves(tls, tt, _t(r.uniform(kx, (T, L))), bx, by, bz,
                                      0.3, 80.0)
    same_tree(tx_._replace(lcolor=None), jx_._replace(lcolor=None), 1e-5, "blast")
    np.testing.assert_allclose(tx_.lcolor.numpy(), np.asarray(jx_.lcolor), rtol=0, atol=1.2e-4)
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    assert int((tx_.lcolor == -1000.0).sum()) > 0
    col = (0.9, 0.1, 0.2)
    same_tree(TVT.spraypaint_leaves(tls, tt, bx, by, bz, 0.2, col),
              JVT.spraypaint_leaves(jls, jt, bx, by, bz, 0.2, jnp.asarray(col)), 0.0, "spray")


@pytest.mark.parametrize("seed", [3, 12])
def test_place_trees_on_tile_matches(seed):
    """Valid rows equal (positions, heights, types), the mask equal, on
    random heights, slopes and biome weights; the seed's uint32 offset
    wraps (seed * 2654435761 mod 2^31 past 2^32 - cells)."""
    n = 48
    z, nz, w = _field(seed, (n, n), -1, 1), _field(seed + 1, (n, n), 0.4, 1.0), _biomes(seed, n)
    ref = JVT.place_trees_on_tile(seed, -2.0, 3.0, jnp.asarray(z), jnp.asarray(nz),
                                  jnp.asarray(w), JW, density=4.0)
    out = TVT.place_trees_on_tile(seed, -2.0, 3.0, _t(z), _t(nz), _t(w), TW, density=4.0)
    valid = np.asarray(ref[4])
    assert valid.sum() > 10
    np.testing.assert_array_equal(out[4].numpy(), valid)
    for a, b in zip(out[:4], ref[:4]):
        np.testing.assert_array_equal(a.numpy()[valid], np.asarray(b)[valid])


def test_grass_and_flowers_match():
    """A grass block (4 blades a cell), wind sway, burn and cut; flowers at
    two densities: within 1e-5, masks and colors equal."""
    n = 24
    z, gw = _field(7, (n, n), -1, 1), _field(8, (n, n))
    ref = JVG.gen_grass_block(77, 5.0, -3.0, jnp.asarray(z), jnp.asarray(gw), JW)
    out = TVG.gen_grass_block(77, 5.0, -3.0, _t(z), _t(gw), TW)
    same_tree(out, ref, 1e-5, "grass")
    np.testing.assert_array_equal((out.height > 0).numpy(), np.asarray(ref.height) > 0)
    cx, cy = float(ref.x[100]), float(ref.y[100])
    for port, jax_ in ((TVG.wind_sway(out, 0.7, -0.4, 3.25),
                        JVG.wind_sway(ref, 0.7, -0.4, 3.25)),
                       (TVG.burn_grass_at(out, cx, cy, 0.1, 0.6),
                        JVG.burn_grass_at(ref, cx, cy, 0.1, 0.6)),
                       (TVG.cut_grass_at(out, cx, cy, 0.08),
                        JVG.cut_grass_at(ref, cx, cy, 0.08))):
        same_tree(tuple(port), tuple(jax_), 1e-5, "grass ops")
    for dens in (1.0, 2.0):
        fr = JVG.gen_flowers(91, -4.0, 2.0, jnp.asarray(z), jnp.asarray(gw), JW,
                             flower_density=dens)
        fo = TVG.gen_flowers(91, -4.0, 2.0, _t(z), _t(gw), TW, flower_density=dens)
        same_tree(fo, fr, 1e-5, "flowers")
        assert fo.alive.any()


def test_grass_for_tile_on_jax_matched_tile():
    """`TileManager.grass_for_tile` and `flowers_for_tile` on the JAX
    manager's own tiles (carried across by `convert.tile`): the tile
    seeds and origins are the JAX ones, so the blades and flowers equal
    the JAX manager's within 1e-5 (masks equal)."""
    jw, tw = JWorld(mesh_x=64, mesh_y=64), TWorld(mesh_x=64, mesh_y=64)
    jm = JTL.TileManager(cfg=JM.TerrainConfig(mesh_seed=3), world=jw, tile_size=16)
    jm.update(0.0, 0.0)
    tm = TTL.TileManager(cfg=TM.TerrainConfig(mesh_seed=3), world=tw, tile_size=16,
                         device="cpu")
    tm.tiles = {k: convert.tile(t, "cpu") for k, t in jm.tiles.items()}
    assert len(tm.tiles) >= 9
    for k in sorted(tm.tiles)[:4]:
        same_tree(tm.grass_for_tile(k), jm.grass_for_tile(k), 1e-5, f"grass {k}")
        same_tree(tm.flowers_for_tile(k, 1.5), jm.flowers_for_tile(k, 1.5), 1e-5,
                  f"flowers {k}")


def test_ground_fire_matches():
    """Ignite, 40 spread ticks in a cross wind over patchy fuel, then
    scorch a grass block from the field: within 1e-5."""
    fuel = _field(13, (48, 48))
    fuel[:, 30:] = 0.0
    jf = JVG.ignite_at(JVG.make_ground_fire(fuel), 8, 20, 2.0)
    tf = TVG.ignite_at(TVG.make_ground_fire(fuel, device="cpu"), 8, 20, 2.0)
    for i in range(40):
        wx, wy = 1.5, -0.5 if i % 2 else 0.25
        jf = JVG.step_ground_fire(jf, jnp.float32(wx), jnp.float32(wy))
        tf = TVG.step_ground_fire(tf, wx, wy)
        same_tree(tf, jf, 1e-5, f"fire {i}")
    assert float(tf.intensity.max()) > 0.1
    w = TWorld(mesh_x=48, mesh_y=48)
    z, ones = np.zeros((16, 16), np.float32), np.ones((16, 16), np.float32)
    jb = JVG.scorch_grass(JVG.gen_grass_block(3, -8.0, -8.0, jnp.asarray(z), jnp.asarray(ones),
                                              JWorld(mesh_x=48, mesh_y=48)),
                          jf, JWorld(mesh_x=48, mesh_y=48))
    tb = TVG.scorch_grass(TVG.gen_grass_block(3, -8.0, -8.0, _t(z), _t(ones), w), tf, w)
    same_tree(tb, jb, 1e-5, "scorch")
    assert float(tb.burn.max()) > 0


def test_building_animals_match():
    """Spiders (one squished), snakes, a fly swarm and tank fish for 16
    ticks on the JAX draws: within 1e-5."""
    r = jax.random
    b, tank, center = (0.0, 0.0, 1.2, 0.9), (0.2, 0.1, 0.0, 0.7, 0.6, 0.4), (0.6, 0.4, 0.3)
    key = r.key(31)
    ks, kn, kf, kfish = r.split(key, 4)
    two_pi = 2.0 * np.pi
    js = JVA.make_spiders(ks, 24, b)
    ts = TVA.make_spiders(jax_uniform_rows(ks, 6, 24, ((0.0, two_pi), (0.0, 1.2), (0.0, 0.9),
                                                       (0.0, 0.5), (0.5, 1.0))))
    same_tree(ts, js, 1e-6, "spiders")
    js = JVA.squish_spiders(js, float(js.px[0]), float(js.py[0]))
    ts = TVA.squish_spiders(ts, float(ts.px[0]), float(ts.py[0]))
    jn = JVA.make_snakes(kn, 6, b, num_segs=8)
    tn = TVA.make_snakes(jax_uniform_rows(kn, 4, 6, ((0.0, two_pi), (0.0, 1.2), (0.0, 0.9),
                                                     (0.5, 1.0))), num_segs=8)
    same_tree(tn, jn, 1e-6, "snakes")
    jfl = JVA.make_flies(kf, 20, center)
    spread = ((-0.05, 0.05), (-0.05, 0.05), (-0.01, 0.01), (-0.01, 0.01), (-0.01, 0.01),
              (-0.002, 0.002))
    tfl = TVA.make_flies(jax_uniform_rows(kf, 6, 20, spread), center)
    same_tree(tfl, jfl, 1e-6, "flies")
    jfish = JVA.make_animals(kfish, 12, JVA.A_FISH, center=(0.45, 0.35, 0.2), spread=0.1)
    fr = ((-0.1, 0.1), (-0.1, 0.1), (-0.02, 0.02), (-0.01, 0.01), (-0.01, 0.01),
          (-0.002, 0.002))
    tfish = TVA.make_animals(jax_uniform_rows(kfish, 6, 12, fr), TVA.A_FISH,
                             center=(0.45, 0.35, 0.2))
    ticks = 16
    keys = [(r.fold_in(ks, i), r.fold_in(kn, i), r.fold_in(kf, i)) for i in range(ticks)]
    for i, (a, c, d) in enumerate(keys):
        js = JVA.step_spiders(js, a, b)
        jn = JVA.step_snakes(jn, c, b)
        jfl = JVA.step_flies(jfl, d, jnp.asarray(center))
        jfish = JVA.step_tank_fish(jfish, tank)
    draws = jax_building_animal_draws(keys, 24, 6, 20)
    ts, tn, tfl, tfish = TVA.step_building_animals(ts, tn, tfl, tfish, draws, b, center,
                                                   tank, ticks)
    for port, ref, what in ((ts, js, "spiders"), (tn, jn, "snakes"), (tfl, jfl, "flies"),
                            (tfish, jfish, "tank fish")):
        same_tree(port, ref, 1e-5, what)
    assert bool(ts.squished[0]) and float(ts.pz.max()) > 0.0

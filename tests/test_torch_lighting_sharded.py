"""Torch port vs JAX package: the lighting bake over ranks
(`w3d_torch/lighting/parallel.py`) on tests/test_lighting_sharded.py's
32x32x16 world, floor scene and `P3` params.

One 4-rank gloo group on the CPU (`torch_rank_cases.lighting_cases`) runs
every bake once, in a module fixture: a sky bake, a global bake onto its
result (a non-zero grid), a ray count that is not a multiple of the ranks
(per rank 320 rays in batches of 256 and 64), and the sky bake again.

Each rank's draws replay the JAX chain of `compute_*_lighting_sharded`:
`key(uint32(seed * 0x9E3779B1 & 0x7FFFFFFF) + rank)`, `fold_in(batch)`,
`fold_in(1)` for the rays and `fold_in(2)` for the trace
(`torch_port_util.jax_trace_draws`), recorded here and replayed in the
ranks (`torch_rank_cases.TapeSource`).  The JAX side is each rank's chain
of `trace_batch` run op by op (`jax.disable_jit`, as
tests/test_torch_lighting.py runs the tracer: compiled, XLA rounds the
cell-index products otherwise), summed over the ranks, at that file's
bound for bakes: rtol 3e-5, atol 1e-6.  It traces the rays the port made
from the same draws, which are held against the JAX `sky_rays` and
`global_rays` at test_ray_generation's 1e-6: the two packages' sin and cos
differ by an ulp, and in these bakes that moved one deposit sample of rank
0's sky rays into the next cell (measured), which the bound for a
reordered deposit does not cover.  The port's bake equals, bit for bit,
the rank-order sum of the same chains traced in one process, and itself
from run to run."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import w3d  # noqa: F401
from w3d.lighting import lmap as JL, trace as JT
from w3d.scene import cobj as JSC
from w3d.utils.constants import WorldConst as JWorld

from w3d_torch.lighting import lmap as TL, trace as TT
from w3d_torch.lighting.parallel import ACCUM_FIELDS
from w3d_torch.parallel import launch
from w3d_torch.scene import cobj as TSC
from w3d_torch.utils.constants import WorldConst as TWorld

import torch_rank_cases
from torch_port_util import jax_trace_draws

RANKS = 4
JW, TW = JWorld(mesh_x=32, mesh_y=32, mesh_z=16), TWorld(mesh_x=32, mesh_y=32, mesh_z=16)
P3 = dict(max_bounces=3, samples_per_segment=6, mesh_steps=12)
SUN = (0.3, 0.2, -0.9)
# name: (kind, num_rays, batch, seed, the bake whose grid it starts from)
BAKES = {"sky": ("sky", RANKS * 256, 256, 1, None),
         "global_on_sky": ("global", RANKS * 256, 256, 2, "sky"),
         "odd": ("sky", RANKS * 320 - 3, 256, 9, None),
         "sky_again": ("sky", RANKS * 256, 256, 1, None)}


def _floor_scene(SC):
    sp = SC.SceneParse()
    lay = SC.CobjLayer(elasticity=0.5, color=(0.7, 0.6, 0.5, 1.0))
    sp.cobjs.append(SC.RawCobj(SC.COLL_CUBE, (-2, -2, -0.8), (2, 2, -0.55), layer=lay))
    sp.cobjs.append(SC.RawCobj(SC.COLL_SPHERE, (0.3, 0.0, 0.0), r1=0.4, layer=lay))
    return sp


def _sizes(num_rays, batch):
    per_rank = -(-num_rays // RANKS)
    return [min(batch, per_rank - i * batch) for i in range(-(-per_rank // batch))]


def _key(seed, rank, i, part):
    base = jnp.uint32((seed * 0x9E3779B1) & 0x7FFFFFFF) + jnp.uint32(rank)
    return jax.random.fold_in(jax.random.fold_in(jax.random.key(base), i), part)


def _channels(grid):
    return np.stack([np.asarray(getattr(grid, f)) for f in ACCUM_FIELDS])


def _port_bake(kind, num_rays, batch, seed, base, src, cobjs, hf, params):
    """The bake as ranks traced one after another in one process: each
    rank's chain into a zero volume, summed in rank order, added to `base`.
    Returns it and the rays of each (rank, batch)."""
    ltype = TL.LIGHTING_SKY if kind == "sky" else TL.LIGHTING_GLOBAL
    vols, rays = [], {}
    for r in range(RANKS):
        local = TL.make_light_grid(TW, device="cpu")
        for i, n in enumerate(_sizes(num_rays, batch)):
            if kind == "sky":
                rays[r, i] = TT.sky_rays(src(seed, r, i, 1), n, TW, ray_weight=float(n))
            else:
                rays[r, i] = TT.global_rays(src(seed, r, i, 1), n, SUN, TW, ray_weight=float(n))
            local = TT.trace_batch(local, cobjs, hf, *rays[r, i], src(seed, r, i, 2),
                                   ltype=ltype, params=params, world=TW)
        vols.append(torch.stack([getattr(local, f) for f in ACCUM_FIELDS]))
    total = vols[0]
    for v in vols[1:]:
        total = total + v
    return base._replace(**{f: getattr(base, f) + total[k]
                            for k, f in enumerate(ACCUM_FIELDS)}), rays


def _jax_bake(kind, num_rays, batch, seed, base, cobjs, hf, params, rays):
    """Each rank's JAX trace chain op by op over `rays`, summed over the
    ranks, plus `base`; the JAX rays of the same draws are held within 1e-6
    of `rays`."""
    ltype = JL.LIGHTING_SKY if kind == "sky" else JL.LIGHTING_GLOBAL
    total = 0.0
    for r in range(RANKS):
        local = JL.make_light_grid(JW)
        for i, n in enumerate(_sizes(num_rays, batch)):
            if kind == "sky":
                jrays = JT.sky_rays(_key(seed, r, i, 1), n, JW, ray_weight=float(n))
            else:
                jrays = JT.global_rays(_key(seed, r, i, 1), n, SUN, JW, ray_weight=float(n))
            for a, b in zip(rays[r, i], jrays):
                np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-6)
            with jax.disable_jit():
                local = JT.trace_batch(local, cobjs, hf, *(jnp.asarray(a.numpy()) for a in rays[r, i]),
                                       _key(seed, r, i, 2), ltype=ltype, params=params, world=JW)
        total = total + _channels(local)
    return base + total


@pytest.fixture(scope="module")
def bakes():
    """{name: (rank results, the one-process port bake, the JAX bake)}."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        jc, tc = JSC.pack_cobjs(_floor_scene(JSC)), TSC.pack_cobjs(_floor_scene(TSC), device="cpu")
        jhf = jnp.full((32, 32), -0.6, jnp.float32)
        thf = torch.full((32, 32), -0.6)
        jp = JT._auto_transmission(JT.TraceParams(**P3), jc)
        tp = TT._auto_transmission(TT.TraceParams(**P3), tc)
        src = torch_rank_cases.TapeSource(make=lambda *parts: jax_trace_draws(_key(*parts)))
        port, ref = {}, {}
        for name, (kind, num_rays, batch, seed, base) in BAKES.items():
            tbase = TL.make_light_grid(TW, device="cpu") if base is None else port[base]
            jbase = 0.0 if base is None else ref[base]
            port[name], rays = _port_bake(kind, num_rays, batch, seed, tbase, src, tc, thf, tp)
            if name == "sky_again":
                continue
            ref[name] = _jax_bake(kind, num_rays, batch, seed, jbase, jc, jhf, jp, rays)
        inp = dict(tapes=src.tapes, params=TT.TraceParams(**P3), world=TW, cobjs=tc,
                   mesh_hf=thf, sun_dir=SUN, bakes=BAKES)
        res = launch.run_ranks(torch_rank_cases.lighting_cases, RANKS, "gloo", "cpu", inp)
        return [r.value for r in res], port, ref
    finally:
        torch.set_num_threads(n)


@pytest.mark.parametrize("name", ["sky", "global_on_sky", "odd"])
def test_sharded_bake_matches_jax_ranks(bakes, name):
    out, port, ref = bakes
    for o in out:
        got = o[name]
        for f in ACCUM_FIELDS:       # every rank holds the merged volume, bit for bit
            assert torch.equal(getattr(got, f), getattr(out[0][name], f)), f
            assert torch.equal(getattr(got, f), getattr(port[name], f)), f
        np.testing.assert_allclose(_channels(got), ref[name], rtol=3e-5, atol=1e-6)
    lit = "sv" if BAKES[name][0] == "sky" else "gv"
    assert float(getattr(out[0][name], lit).sum()) > 0


def test_bake_onto_a_lit_grid_adds_the_delta(bakes):
    """The global bake starts from the sky bake's grid: its sky channels
    pass through unchanged, and its global channels hold one delta."""
    out, _, _ = bakes
    sky, both = out[0]["sky"], out[0]["global_on_sky"]
    for f in ("sc_r", "sc_g", "sc_b", "sv"):
        assert torch.equal(getattr(sky, f), getattr(both, f)), f
    assert float(both.gv.sum()) > 0 and float(sky.gv.sum()) == 0.0


def test_ray_count_not_a_multiple_of_the_ranks(bakes):
    """1,277 rays over 4 ranks: 320 a rank (1,280 in all) in batches of 256
    and the exact remainder 64, each batch weighted by its size."""
    assert _sizes(RANKS * 320 - 3, 256) == [256, 64]
    out, _, ref = bakes
    sky = out[0]["sky"]
    odd = out[0]["odd"]
    assert not torch.equal(odd.sv, sky.sv)
    # per-ray weight 1: total sky weight within Monte Carlo noise of 320/256
    # times the sky bake's (the same scene), not 2 x 256 / 256
    ratio = float(odd.sv.sum()) / float(sky.sv.sum())
    assert 1.1 < ratio < 1.4, ratio


def test_bake_is_bitwise_run_to_run(bakes):
    out, _, _ = bakes
    for o in out:
        for f in ACCUM_FIELDS:
            assert torch.equal(getattr(o["sky"], f), getattr(o["sky_again"], f)), f
        calls, nbytes = o["traffic"]
        # one gather of the 12 channels a bake: 3 of 4 ranks' volumes received
        assert calls == len(BAKES)
        assert nbytes == len(BAKES) * 3 * 12 * 16 * 32 * 32 * 4

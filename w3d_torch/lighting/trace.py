"""Batched path tracer into the light volume (port of
`3dworld_tpu/lighting/trace.py`).

The reference's `cast_light_ray` (ray_trace.cpp:256-490) recursively
bounces single rays on N CPU threads; here a whole flat ray batch advances
in lockstep through the bounces, each:

  intersect (dense cobj test + stepped heightfield, kernel B on the card)
  -> deposit the lit path into the lmcell volume (fixed samples per
  segment, a fixed-order sum: `lmap.cell_sums`) -> surface interaction
  (albedo, water attenuation, weight-threshold kill) -> cosine-hemisphere
  (or shine-blurred specular) scatter.

Constants as the reference's: DIFFUSE_REFL 0.9, SPEC_REFL 1.0,
WEIGHT_THRESH 0.01 (ray_trace.cpp:16-26).  Sky / global / local ray
generation mirrors trace_ray_block_{sky,global,local}.

The JAX package draws its randoms from threefry keys; here every draw
comes from a `TraceDraws` (by default a seeded `torch.Generator` on the
bake's device), asked for by the JAX key's place in its chain, so a test
can replay the JAX draws.  The same seed gives the same draws, and every
deposit is a fixed-order sum, so a bake is the same bit for bit run to
run, and (its sines, cosines, square roots and divisions rounded as
`ops/fmath`'s) the same on the card as on the CPU given the same draws.
A batch's deposits (all bounces) are summed in a private volume and
added to the grid once, so a batch of negated weights adds the exact
negation (the platform delta of `accum` cancels to zero).

The JAX `lax.scan`s over bounces and batches are Python loops with the
same key schedule.  Compaction's slot counts follow the static schedule
N >> (b+1+shift) (at least 1,024; `bounce_slots`), so no count is read
on the host.

A batch is a list of phases (`batch_phases`), each bounce three, in the
spans (`utils/profiler.span`, CUDA events on a card) `light.intersect`
(the cobj and heightfield tests, the hit selection, the water crossing),
`light.deposit` (the segments' cell sums; once a batch the sums'
addition to the grid's channels) and `light.scatter` (the surface
interaction with the transmitted chord's deposit, the new directions, the
compaction).  Its draws are made first (`_trace_draws`, in the order the
bounces use them).  On a card every batch goes through `BATCHES`
(`ops/cuda/graphs`): a key seen twice in a row captures one CUDA graph a
phase, and later batches replay them, bit for bit the eager batch; a
batch is some 4,600 small launches, which the host's dispatch would
otherwise pace.
"""

from __future__ import annotations

import hashlib
from functools import partial
from typing import Callable, NamedTuple

import numpy as np
import torch

from ..utils.constants import WorldConst, DEFAULT_WORLD
from ..physics.cobjs import CobjSet
from ..ops import ray as R
from ..ops.cuda import graphs as CG
from ..ops.cuda import sample_kernel as SK
from ..ops.fmath import cos32, div32, exp32, sin32, sqrt32
from . import lmap as L

DIFFUSE_REFL = 0.9   # ray_trace.cpp:18
SPEC_REFL = 1.0
WEIGHT_THRESH = 0.01
SNOW_ALBEDO = 0.9    # ray_trace.cpp:20
ICE_ALBEDO = 0.8     # ray_trace.cpp:21
ICE_C = (0.65, 0.65, 1.0)          # 3DWorld.h:1297
WATER_C = (0.4, 0.4, 1.0)          # 3DWorld.h:1296
UW_ATTEN_SCALE = (0.9, 1.0, 1.5)   # get_underwater_atten_color(0,0),
                                   # edit_ui.cpp:330-336; max = WHITE
W_FREEZE_POINT = -0.1              # 3DWorld.h:90
LT_DIR_FALLOFF = 0.005             # lightmap.h:15
MESH_ALBEDO = (0.55, 0.45, 0.30)  # fallback landscape color when no
# land_color map is supplied (get_landscape_texture_color)

# mean colors of the 5 biome texture layers {sand, dirt, grass, rock,
# snow} (stand-ins for the reference's texture-average colors)
LAYER_COLORS = ((0.76, 0.70, 0.50),   # sand
                (0.45, 0.33, 0.20),   # dirt
                (0.30, 0.52, 0.20),   # grass
                (0.52, 0.50, 0.48),   # rock
                (0.93, 0.93, 1.00))   # snow

SKY_STREAM = 0x5C1        # the drivers' stream tags (the JAX package's
LOCAL_STREAM = 0x10CA1    # w3d_rng.key(seed, tag, i) tags)
SCENE_STREAM = 0x5CE7E
GLOBAL_STREAM = 0x610BA1  # the port's own: the JAX package traces no sun part


class TraceParams(NamedTuple):
    max_bounces: int = 8
    samples_per_segment: int = 16
    line_length: float = 32.0
    water_plane_z: float = -1.0e9
    specular_enabled: bool = True
    mesh_steps: int = 24           # heightfield-march samples per ray
    exact_mesh: bool = False       # DDA cell-walking intersect
    temperature: float = 20.0      # <= W_FREEZE_POINT -> water becomes ice
    transmission: bool = True      # alpha<1 cobj refraction/transmission
    compact: bool = False          # Russian-roulette population control:
                                   # shrink the ray array as rays die
    samples_later: int = 0         # segment samples for bounces >= 1
                                   # (0 = samples_per_segment); compact
                                   # path only
    deposit_shards: int = 0        # TPU scatter scheduling in the JAX
                                   # package; accepted, changes nothing
    cobj_types: tuple = ()         # static shape-type presence for the
                                   # intersect (ops.ray.present_types);
                                   # () = unknown -> every family tested
    uniform_color0: bool = False   # promise: every input ray carries the
                                   # SAME (cr,cg,cb): bounce 0 deposits
                                   # the weight only, color recovered at
                                   # the end.  compact path only
    sorted_deposit: bool = False   # TPU scatter scheduling in the JAX
                                   # package; accepted, changes nothing
    compact_shift: int = 0         # tighten the RR population schedule
                                   # by this many halvings: slots after
                                   # bounce b = N >> (b+1+shift)


# ---------------------------------------------------------------------------
# draws
# ---------------------------------------------------------------------------

class BounceDraws(NamedTuple):
    """One bounce's uniform draws [N], each in [0, 1): the transmission
    branch pick, the cosine-hemisphere pair, and the specular jitter pair
    and pick (None where the bounce does not draw them)."""

    u_t: torch.Tensor | None
    u: torch.Tensor
    v: torch.Tensor
    ju: torch.Tensor | None
    jv: torch.Tensor | None
    u_spec: torch.Tensor | None


def stream_seed(*parts: int) -> int:
    """A 63-bit generator seed for a stream named by integers."""
    h = hashlib.blake2b(repr(tuple(int(p) for p in parts)).encode(), digest_size=8)
    return int.from_bytes(h.digest(), "little") & (2 ** 63 - 1)


class TraceDraws:
    """The randoms of one ray batch (its ray generation or its trace),
    drawn in call order from a `torch.Generator` seeded with `seed` on
    `gen_device` (default: `device`, the bake's) and used on `device`.
    The same seed and the same calls give the same draws.  The methods
    name each draw by its place in the JAX package's key chain (which
    split of the batch key, which bounce), which this class ignores and a
    test's subclass uses to replay the JAX draws."""

    def __init__(self, seed: int, device: torch.device | str = "cuda",
                 gen_device: torch.device | str | None = None):
        self.device = torch.device(device)
        self.gen_device = torch.device(gen_device) if gen_device is not None else self.device
        self.gen = torch.Generator(device=self.gen_device).manual_seed(int(seed))

    def _draw(self, fn, *args) -> torch.Tensor:
        t = fn(*args, generator=self.gen, device=self.gen_device)
        return t.to(self.device, non_blocking=True)

    def rays(self, splits: int, i: int, shape, kind: str = "uniform",
             lo: float = 0.0, hi: float = 1.0):
        """Ray-generation draw `i` of `splits` (the JAX split of the batch
        key): "uniform" in [lo, hi), "normal", or "randint" in [0, hi)."""
        del splits, i
        if kind == "uniform":
            return _ranged(self._draw(torch.rand, shape), lo, hi)
        if kind == "normal":
            return self._draw(torch.randn, shape)
        return self._draw(torch.randint, 0, int(hi), shape)

    def bounce(self, b: int, n: int, params: TraceParams) -> BounceDraws:
        """Bounce `b`'s draws for `n` rays (the branch pick only with
        transmission, the jitter only with specular scatter)."""
        u = lambda: self._draw(torch.rand, n)
        u_t = u() if params.transmission else None
        uu, vv = u(), u()
        if params.specular_enabled:
            return BounceDraws(u_t, uu, vv, u(), u(), u())
        return BounceDraws(u_t, uu, vv, None, None, None)

    def compact(self, b: int, n: int) -> torch.Tensor:
        """The survivor-pick uniforms of the compaction after bounce `b`."""
        return self._draw(torch.rand, n)


def _ranged(u: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """A [0, 1) draw mapped to [lo, hi): u * (hi - lo) + lo in float32, at
    least lo (threefry's `uniform(minval, maxval)` map)."""
    if (lo, hi) == (0.0, 1.0):
        return u
    lo32, hi32 = np.float32(lo), np.float32(hi)
    return torch.clamp(u * float(hi32 - lo32) + float(lo32), min=float(lo32))


class DrawSource:
    """Makes the `TraceDraws` of each stream a driver asks for: a stream is
    named by integers (the JAX package's key arguments, e.g. (seed,
    SKY_STREAM, batch, 1) for a sky batch's rays and (..., 2) for its
    trace).  `gen_device` draws elsewhere than `device` (the CPU, to give
    two devices the same draws)."""

    def __init__(self, device: torch.device | str = "cuda",
                 gen_device: torch.device | str | None = None):
        self.device = device
        self.gen_device = gen_device

    def __call__(self, *parts: int) -> TraceDraws:
        return TraceDraws(stream_seed(*parts), self.device, self.gen_device)


# ---------------------------------------------------------------------------
# deposits
# ---------------------------------------------------------------------------

def _luminance(r, g, b):
    return 0.299 * r + 0.587 * g + 0.114 * b  # colorRGBA::get_luminance


def landscape_color_map(mesh: torch.Tensor, world: WorldConst, biome_noise=None):
    """[my, mx, 3] landscape albedo from the biome weight layers —
    get_landscape_texture_color(xpos, ypos) equivalent (the 5-layer biome
    weights blend the layers' mean colors)."""
    from ..terrain import biomes as B
    dzdx = (torch.roll(mesh, -1, 1) - torch.roll(mesh, 1, 1)) * (0.5 * world.dx_inv)
    dzdy = (torch.roll(mesh, -1, 0) - torch.roll(mesh, 1, 0)) * (0.5 * world.dy_inv)
    nz = torch.rsqrt(dzdx * dzdx + dzdy * dzdy + 1.0)
    w = B.biome_weights(mesh, nz, mesh.min(), mesh.max(), biome_noise=biome_noise)
    cols = torch.tensor(LAYER_COLORS, dtype=torch.float32, device=mesh.device)
    return torch.einsum("lyx,lc->yxc", w, cols)


def _segment_samples(grid, ox, oy, oz, dx, dy, dz, t_hit, w, S, world):
    """S samples per ray placed on the sub-range of [0, t_hit] inside the
    light volume's AABB (sky-dome segments start far outside it); each
    sample's weight carries the (t1-t0)/t_hit range compensation, so the
    per-cell expectation is the uniform estimator's.  Returns (flat idx
    [N*S] with dropped samples at n_cells, wv [N*S])."""
    nz, ny, nx = grid.shape
    hx = 0.5 * nx * world.dx
    hy = 0.5 * ny * world.dy

    def axis_range(o, d, lo, hi):
        dsafe = torch.where(torch.abs(d) < 1e-12, 1e-12, d)
        ta = (lo - o) / dsafe
        tb = (hi - o) / dsafe
        return torch.minimum(ta, tb), torch.maximum(ta, tb)

    t0x, t1x = axis_range(ox, dx, -hx, hx)
    t0y, t1y = axis_range(oy, dy, -hy, hy)
    t0z, t1z = axis_range(oz, dz, grid.z0, grid.z0 + nz * grid.dz)
    t0 = torch.maximum(torch.maximum(t0x, t0y), torch.clamp(t0z, min=0.0))
    t1 = torch.minimum(torch.minimum(t1x, t1y), torch.minimum(t1z, t_hit))
    span = torch.clamp(t1 - t0, min=0.0)
    fr = div32(torch.arange(S, dtype=torch.float32, device=ox.device)[None, :] + 0.5, S)
    ts = t0[:, None] + fr * span[:, None]                          # [N,S]
    px = ox[:, None] + ts * dx[:, None]
    py = oy[:, None] + ts * dy[:, None]
    pz = oz[:, None] + ts * dz[:, None]
    idx, ok = L.cell_index(grid, px.reshape(-1), py.reshape(-1), pz.reshape(-1), world)
    comp = span / torch.clamp(t_hit, min=1e-12)        # range compensation
    wv = div32(w * comp, S)[:, None].expand(ts.shape).reshape(-1)
    return torch.where(ok, idx, nz * ny * nx), wv


def _segment_sums(grid, ltype, ox, oy, oz, dx, dy, dz, t_hit, w, cr, cg, cb, S, world):
    """Walk each ray's segment [0, t_hit] with S samples: per-cell sums
    [n_cells, K] of color*weight/S (and the weight for sky/global),
    add_path_to_lmcs."""
    idx, wv = _segment_samples(grid, ox, oy, oz, dx, dy, dz, t_hit, w, S, world)
    rep = lambda c: c[:, None].expand(c.shape[0], S).reshape(-1)
    vals = L.deposit_values(ltype, rep(cr), rep(cg), rep(cb), wv)
    return L.cell_sums(idx, vals, int(np.prod(grid.shape)))


def _weight_sums(grid, ox, oy, oz, dx, dy, dz, t_hit, w, S, world):
    """Weight-only segment sums [n_cells]: when every ray in the batch
    carries the same color (bounce 0 of every driver), the color channels
    are color x (weight sum), recovered by one multiply at the end."""
    idx, wv = _segment_samples(grid, ox, oy, oz, dx, dy, dz, t_hit, w, S, world)
    return L.cell_sums(idx, wv[:, None], int(np.prod(grid.shape)))[:, 0]


# ---------------------------------------------------------------------------
# the bounce loop
# ---------------------------------------------------------------------------

def _intersect_phase(b: dict, params: TraceParams, cobjs, mesh, world) -> None:
    """`light.intersect`: the nearest hit of each ray of the state `st`."""
    st = b["st"]
    b["near"] = _nearest_hit(st["ox"], st["oy"], st["oz"], st["dx"], st["dy"], st["dz"],
                             cobjs, mesh, params, world)


def _deposit_phase(b: dict, shape, ltype, S: int, w_only: bool, world) -> None:
    """`light.deposit`: the lit segments' cell sums, added to the batch's
    private sums (weights alone where `w_only`)."""
    st, near = b["st"], b["near"]
    grid = _Geo(shape, b["z0"], b["dz"])
    contrib = st["alive"] & near["hit"]   # un-hit rays deposit nothing (ray_trace.cpp:341)
    wc = st["w"] * contrib.to(torch.float32)
    seg = (grid, st["ox"], st["oy"], st["oz"], st["dx"], st["dy"], st["dz"], near["t"])
    if w_only:
        st["wsum"] = st["wsum"] + _weight_sums(*seg, wc, S, world)
    else:
        st["sums"] = st["sums"] + _segment_sums(grid, ltype, *seg[1:], wc, st["r"], st["g"],
                                                st["b"], S, world)
    near["contrib"] = contrib


def _scatter_phase(b: dict, bounce: int, shape, ltype, S: int, params: TraceParams, cobjs,
                   mesh, world, land_color, snow_depth) -> None:
    """`light.scatter`: the surface interaction and the new directions."""
    grid = _Geo(shape, b["z0"], b["dz"])
    b["st"] = _scatter(b["st"], b[f"bounce{bounce}"], grid, ltype, cobjs, mesh, params, world,
                       land_color, snow_depth, S, **b.pop("near"))


def _compact_phase(b: dict, bounce: int, keep: int) -> None:
    """`light.scatter`: the compaction after the bounce."""
    b["st"] = _compact_rays(b["st"], b[f"compact{bounce}"], keep)


def _nearest_hit(ox, oy, oz, dx, dy, dz, cobjs, mesh, params: TraceParams, world) -> dict:
    """Each ray's nearest hit, cobj or mesh, and its crossing of the water
    plane: `hit`, `t` (`line_length` where nothing is hit), `use_mesh`,
    the cobj's normal (`cnx`, `cny`, `cnz`), slot (`cidx`) and exit
    (`ct_exit`), `ice_coll` and `water_coll`."""
    N = ox.shape[0]
    dev = ox.device
    LL = params.line_length
    frozen = params.temperature <= W_FREEZE_POINT
    water_on = params.water_plane_z > -1.0e8
    tmax = torch.full((N,), LL, dtype=torch.float32, device=dev)
    present = params.cobj_types or None
    if params.transmission:
        chit, ct, cnx, cny, cnz, cidx, ct_exit = R.ray_cobjs_nearest(
            ox, oy, oz, dx, dy, dz, tmax, cobjs, with_exit=True, present=present)
    else:
        chit, ct, cnx, cny, cnz, cidx = R.ray_cobjs_nearest(
            ox, oy, oz, dx, dy, dz, tmax, cobjs, with_exit=False, present=present)
        ct_exit = ct
    if params.exact_mesh:
        mhit, mt = R.ray_heightfield_dda(ox, oy, oz, dx, dy, dz, tmax, mesh, world,
                                         max_cells=4 * params.mesh_steps)
    else:
        mhit, mt = R.ray_heightfield(ox, oy, oz, dx, dy, dz, tmax, mesh, world,
                                     num_steps=params.mesh_steps)
    use_mesh = mhit & (~chit | (mt < ct))
    hit = chit | mhit
    t = torch.where(use_mesh, mt, ct)
    t = torch.where(hit, t, LL)

    # water / ice crossing (ray_trace.cpp:296-309): a hit below the water
    # plane from above stops at the ice surface (frozen) or attenuates
    # through the water volume
    wpz = params.water_plane_z
    no = torch.zeros(N, dtype=torch.bool, device=dev)
    ice_coll = water_coll = no
    if water_on:
        crossed = hit & (oz >= wpz) & ((oz + t * dz) < wpz)
        if frozen:
            t = torch.where(crossed, (wpz - oz) / torch.where(torch.abs(dz) < 1e-9, -1e-9, dz), t)
            ice_coll = crossed
        else:
            water_coll = crossed
    return dict(hit=hit, t=t, use_mesh=use_mesh, cnx=cnx, cny=cny, cnz=cnz, cidx=cidx,
                ct_exit=ct_exit, ice_coll=ice_coll, water_coll=water_coll)


def _scatter(st: dict, bd: BounceDraws, grid, ltype, cobjs, mesh, params: TraceParams,
             world, land_color, snow_depth, S: int, contrib, hit, t, use_mesh, cnx, cny,
             cnz, cidx, ct_exit, ice_coll, water_coll) -> dict:
    """The surface interaction at each hit and the ray's next segment (the
    interior chord's deposit, with transmission, included)."""
    ox, oy, oz = st["ox"], st["oy"], st["oz"]
    dx, dy, dz = st["dx"], st["dy"], st["dz"]
    N = ox.shape[0]
    dev = ox.device
    water_on = params.water_plane_z > -1.0e8
    wpz = params.water_plane_z
    no = torch.zeros(N, dtype=torch.bool, device=dev)
    w_init = st["w0"]

    # hit point + normal (ice: always +z, ray_trace.cpp:301)
    hx = ox + t * dx
    hy = oy + t * dy
    hz = oz + t * dz
    _, mx_, my_, mz_ = SK.sample_mesh(mesh, hx, hy, world)
    nx = torch.where(ice_coll, 0.0, torch.where(use_mesh, mx_, cnx))
    ny = torch.where(ice_coll, 0.0, torch.where(use_mesh, my_, cny))
    nz = torch.where(ice_coll, 1.0, torch.where(use_mesh, mz_, cnz))

    # water volume attenuation (ray_trace.cpp:347-365)
    if water_on:
        dzc = torch.where(torch.abs(dz) < 1e-6, -1e-6, dz)
        wdist = torch.where(water_coll, -2.0 * torch.clamp(wpz - hz, min=0.0) / dzc, 0.0)
        wr, wg, wb = (WATER_C[c] * 0.95 * (1.0 - torch.clamp(UW_ATTEN_SCALE[c] * 0.8 * wdist,
                                                             max=1.0)) for c in range(3))
        too_shallow = water_coll & (dz > -1e-6)
        wlum = torch.where(water_coll, _luminance(wr, wg, wb), 1.0)
        watt_r = torch.where(water_coll, wr, 1.0)
        watt_g = torch.where(water_coll, wg, 1.0)
        watt_b = torch.where(water_coll, wb, 1.0)
    else:
        too_shallow = no
        wlum = watt_r = watt_g = watt_b = 1.0

    # albedo + material attributes of the nearest slot (slot 0 where
    # nothing is hit, as the JAX one-hot row of an all-miss argmin)
    attr = torch.stack([cobjs.color_r, cobjs.color_g, cobjs.color_b, cobjs.specular,
                        cobjs.shine, cobjs.alpha, cobjs.refract_ix, cobjs.light_atten],
                       1)[cidx]
    acr, acg, acb = attr[:, 0], attr[:, 1], attr[:, 2]
    aspec, ashine = attr[:, 3], attr[:, 4]
    calpha, cref_ix, catten = attr[:, 5], attr[:, 6], attr[:, 7]
    my, mx = mesh.shape
    gy = torch.clamp(torch.round(hy * world.dy_inv + my // 2), 0, my - 1).to(torch.int64)
    gx = torch.clamp(torch.round(hx * world.dx_inv + mx // 2), 0, mx - 1).to(torch.int64)
    if land_color is not None:
        lc = land_color[gy, gx]
        lcr, lcg, lcb = lc[:, 0], lc[:, 1], lc[:, 2]
    else:
        lcr, lcg, lcb = MESH_ALBEDO
    acr = torch.where(use_mesh, lcr, acr)
    acg = torch.where(use_mesh, lcg, acg)
    acb = torch.where(use_mesh, lcb, acb)
    aspec = torch.where(use_mesh, 0.0, aspec)

    # ice override (ray_trace.cpp:371-376)
    acr = torch.where(ice_coll, ICE_ALBEDO * ICE_C[0], acr)
    acg = torch.where(ice_coll, ICE_ALBEDO * ICE_C[1], acg)
    acb = torch.where(ice_coll, ICE_ALBEDO * ICE_C[2], acb)
    aspec = torch.where(ice_coll, 0.5, aspec)
    ashine = torch.where(ice_coll, 60.0, ashine)

    # snow override (ray_trace.cpp:313-327,366-370): upward-facing hits
    # under snow cover reflect SNOW_ALBEDO white
    if snow_depth is not None:
        snow_coll = hit & ~water_coll & ~ice_coll & (nz > 0.0) & (snow_depth[gy, gx] > 0.0)
        acr = torch.where(snow_coll, SNOW_ALBEDO, acr)
        acg = torch.where(snow_coll, SNOW_ALBEDO, acg)
        acb = torch.where(snow_coll, SNOW_ALBEDO, acb)
        aspec = torch.where(snow_coll, 0.5, aspec)
        ashine = torch.where(snow_coll, 50.0, ashine)

    lum = _luminance(acr, acg, acb)
    refl = DIFFUSE_REFL * (1.0 - aspec) + SPEC_REFL * aspec
    r = st["r"] * acr * watt_r
    g = st["g"] * acg * watt_g
    b = st["b"] * acb * watt_b

    # transmission through alpha<1 cobjs (ray_trace.cpp:407-458): the
    # incident-direction chord [t, t_exit] stands for the refracted path,
    # attenuated by exp(-light_atten * chord); one branch per ray, picked
    # stochastically with importance-compensated weights
    cobj_coll = hit & ~use_mesh & ~ice_coll
    if params.transmission:
        semi = cobj_coll & (calpha < 1.0)
        # Fresnel reflected fraction (get_fresnel_reflection, n1=1)
        n2 = torch.clamp(cref_ix, min=1.0)
        cos_i = torch.abs(dx * nx + dy * ny + dz * nz)
        sin_i = sqrt32(torch.clamp(1.0 - cos_i * cos_i, min=0.0))
        val = sin_i / n2
        cos_t = sqrt32(torch.clamp(1.0 - val * val, min=0.0))
        rs = (cos_i - n2 * cos_t) / torch.clamp(cos_i + n2 * cos_t, min=1e-9)
        rp = (cos_t - n2 * cos_i) / torch.clamp(cos_t + n2 * cos_i, min=1e-9)
        fres = 0.5 * (rs * rs + rp * rp)
        # get_reflected_weight (Math3d.cpp:58): alpha when ix == 1
        rweight = torch.where(cref_ix != 1.0,
                              calpha + (1.0 - calpha) * torch.clamp(fres, 0.0, 1.0), calpha)
        chord = torch.clamp(ct_exit - t, min=0.0)
        transmit_atten = torch.where(semi & (catten > 0.0), exp32(-catten * chord), 1.0)
        w_lum = st["w"] * lum * wlum        # weight *= cobj luminance
        w_t = torch.where(semi, (1.0 - rweight) * w_lum * transmit_atten, 0.0)
        w_r = w_lum * torch.where(semi, rweight, 1.0) * refl
        # deposit the interior chord (add_path_to_lmcs(p2, p_int))
        t_chord = torch.where(semi, chord, 0.0)
        keep_t = torch.abs(w_t) > WEIGHT_THRESH * torch.abs(w_init)
        st["sums"] = st["sums"] + _segment_sums(
            grid, ltype, hx, hy, hz, dx, dy, dz, t_chord,
            w_t * (contrib & keep_t).to(torch.float32), r, g, b, S, world)
        # a branch gated off entirely has probability zero (else the other
        # branch is over-compensated: a biased estimator)
        p_t = torch.abs(w_t) / torch.clamp(torch.abs(w_t) + torch.abs(w_r), min=1e-12)
        p_t = torch.where(semi & keep_t, p_t, 0.0)
        take_t = semi & keep_t & (bd.u_t < p_t)
        w = torch.where(take_t, w_t / torch.clamp(p_t, min=1e-6),
                        w_r / torch.clamp(1.0 - p_t, min=1e-6))
    else:
        take_t = no
        w = st["w"] * lum * refl * wlum
    w = torch.where(too_shallow, 0.0, w)
    alive = contrib & (torch.abs(w) >= WEIGHT_THRESH * torch.abs(w_init))

    # scatter: cosine hemisphere, or shine-blurred mirror for specular
    sdx, sdy, sdz = R.cosine_hemisphere_dirs(bd.u, bd.v, nx, ny, nz)
    if params.specular_enabled:
        vdotn = dx * nx + dy * ny + dz * nz
        rx_ = dx - 2.0 * vdotn * nx
        ry_ = dy - 2.0 * vdotn * ny
        rz_ = dz - 2.0 * vdotn * nz
        # random unit vector from 2 draws (cylinder map)
        jz = 2.0 * bd.ju - 1.0
        jang = (2.0 * np.pi) * bd.jv
        jr = sqrt32(torch.clamp(1.0 - jz * jz, min=0.0))
        blur = 1.0 / sqrt32(torch.clamp(ashine, min=1.0))
        spx = rx_ + blur * jr * cos32(jang)
        spy = ry_ + blur * jr * sin32(jang)
        spz = rz_ + blur * jz
        spl = sqrt32(spx * spx + spy * spy + spz * spz) + 1e-9
        do_spec = (aspec > 0.0) & (ashine > 1.0) & (bd.u_spec < aspec)
        sdx = torch.where(do_spec, spx / spl, sdx)
        sdy = torch.where(do_spec, spy / spl, sdy)
        sdz = torch.where(do_spec, spz / spl, sdz)

    # transmitted rays continue straight from the chord exit point
    eps = 1e-4
    adv = torch.clamp(ct_exit - t, min=0.0) + eps
    return dict(st,
                ox=hx + torch.where(take_t, adv * dx, eps * nx),
                oy=hy + torch.where(take_t, adv * dy, eps * ny),
                oz=hz + torch.where(take_t, adv * dz, eps * nz),
                dx=torch.where(take_t, dx, sdx), dy=torch.where(take_t, dy, sdy),
                dz=torch.where(take_t, dz, sdz),
                w=w, r=r, g=g, b=b, alive=alive)


_RAY_FIELDS = ("ox", "oy", "oz", "dx", "dy", "dz", "w", "w0", "r", "g", "b", "alive")


def _compact_rays(st: dict, u: torch.Tensor, keep: int) -> dict:
    """Shrink the ray state to `keep` slots: a uniformly random subset of
    the alive rays first (a stable sort of the draws, dead rays keyed at
    2.0, fill any remaining slots), survivors upweighted by n_alive/keep
    when clipping occurred (the alive count stays on the device)."""
    alive = st["alive"]
    order = torch.argsort(torch.where(alive, u, 2.0), stable=True)[:keep]
    scale = torch.clamp(div32(alive.sum().to(torch.float32), keep), min=1.0)
    out = dict(st, **{k: st[k][order] for k in _RAY_FIELDS})
    boost = torch.where(out["alive"], scale, 1.0)
    out["w"] = out["w"] * boost
    out["w0"] = out["w0"] * boost
    return out


def trace_batch(grid: L.LightGrid, cobjs: CobjSet, mesh: torch.Tensor,
                ox, oy, oz, dx, dy, dz,        # [N] ray origins + unit directions
                w0, cr, cg, cb,                # [N] initial weight and color
                draws: TraceDraws,
                ltype: int = L.LIGHTING_SKY,
                params: TraceParams = TraceParams(),
                world: WorldConst = DEFAULT_WORLD,
                land_color=None,               # [my,mx,3] landscape albedo (else const)
                snow_depth=None,               # [my,mx] snow cover (enables snow coll)
                ) -> L.LightGrid:
    """Trace one flat ray batch to completion, accumulating into `grid`.

    Surface interaction chain as cast_light_ray (ray_trace.cpp:256-490):
    water attenuation / ice / snow overrides, landscape-texture albedo for
    mesh hits, cobj color + specular, and Fresnel-weighted transmission
    through alpha<1 cobjs.  The reference forks reflected + transmitted
    recursions; this lockstep tracer keeps one ray per slot and picks a
    branch stochastically with importance-compensated weights, after
    depositing the interior chord deterministically."""
    N = ox.shape[0]
    chans = L.channels(ltype)
    b = {"rays": (ox, oy, oz, dx, dy, dz, w0, cr, cg, cb),
         "lit": tuple(getattr(grid, f) for f in chans), "z0": grid.z0, "dz": grid.dz,
         **_trace_draws(draws, N, params)}
    phases = batch_phases(N, ltype, params, tuple(grid.shape), cobjs, mesh, world,
                          land_color, snow_depth)
    (lit,) = BATCHES.run(batch_key(b, ltype, params, cobjs, mesh, world, land_color,
                                   snow_depth),
                         phases, b, ("lit",), refs=(cobjs, mesh, land_color, snow_depth))
    return grid._replace(**dict(zip(chans, lit)))


class _Geo(NamedTuple):
    """The light grid's geometry, all the deposit reads of it."""

    shape: tuple
    z0: torch.Tensor
    dz: torch.Tensor


def _trace_draws(draws: TraceDraws, n: int, params: TraceParams) -> dict:
    """A batch's trace draws, made in the order the bounces use them: each
    bounce's (`bounce<b>`) and each compaction's keys (`compact<b>`), on
    the static schedule of `n` rays."""
    out = {}
    for b, (slots, keep) in enumerate(compact_schedule(n, params)):
        out[f"bounce{b}"] = draws.bounce(b, slots, params)
        if keep < slots:
            out[f"compact{b}"] = draws.compact(b, slots)
    return out


def batch_phases(n: int, ltype: int, params: TraceParams, shape: tuple, cobjs, mesh,
                 world: WorldConst, land_color=None, snow_depth=None) -> list:
    """`trace_batch`'s program as `ops/cuda/graphs` phases over a dict of
    its rays (`rays`), the grid's channels of `ltype` (`lit`), `z0` and
    `dz`, and its draws (`_trace_draws`): per bounce `light.intersect`,
    `light.deposit`, `light.scatter`, each compaction a `light.scatter`,
    and last a `light.deposit` that adds the batch's per-cell sums to the
    channels, the new ones under `lit` (`lmap.add_sums`' additions).

    Population control: after each bounce the ray array shrinks on a
    fixed schedule; when more rays are alive than slots, a random subset
    survives with weight x (n_alive / kept) — Russian-roulette population
    control, unbiased in expectation.  w0 scales with w, so the relative
    termination threshold is unchanged.  With `uniform_color0` bounce 0
    sums weights alone, and its colour channels are recovered at the end
    (every planned batch has one colour)."""
    n_cells = int(np.prod(shape))
    k = len(L.channels(ltype))
    weights0 = params.compact and params.uniform_color0

    def start(b):
        ox, oy, oz, dx, dy, dz, w0, cr, cg, cb = b["rays"]
        dev = ox.device
        b["st"] = dict(ox=ox, oy=oy, oz=oz, dx=dx, dy=dy, dz=dz, w=w0, w0=w0, r=cr, g=cg,
                       b=cb, alive=torch.ones(n, dtype=torch.bool, device=dev),
                       sums=torch.zeros((n_cells, k), dtype=torch.float32, device=dev))
        if weights0:
            b["st"]["wsum"] = torch.zeros(n_cells, dtype=torch.float32, device=dev)

    def finish(b):
        sums = b["st"]["sums"]
        if weights0:
            # recover bounce 0's color channels: color x (weight sum)
            ws = b["st"]["wsum"]
            _, _, _, _, _, _, _, cr, cg, cb = b["rays"]
            cols = [cr[0] * ws, cg[0] * ws, cb[0] * ws] + ([ws] if k == 4 else [])
            sums = sums + torch.stack(cols, 1)
        b["lit"] = tuple(ch + sums[:, c].reshape(shape) for c, ch in enumerate(b["lit"]))

    phases = [(None, start)]
    for bn, (slots, keep) in enumerate(compact_schedule(n, params)):
        S = segment_samples(bn, params)
        phases += [
            ("light.intersect", partial(_intersect_phase, params=params, cobjs=cobjs,
                                        mesh=mesh, world=world)),
            ("light.deposit", partial(_deposit_phase, shape=shape, ltype=ltype, S=S,
                                      w_only=weights0 and bn == 0, world=world)),
            ("light.scatter", partial(_scatter_phase, bounce=bn, shape=shape, ltype=ltype,
                                      S=S, params=params, cobjs=cobjs, mesh=mesh, world=world,
                                      land_color=land_color, snow_depth=snow_depth))]
        if keep < slots:
            phases.append(("light.scatter", partial(_compact_phase, bounce=bn, keep=keep)))
    phases.append(("light.deposit", finish))
    return phases


def batch_key(b: dict, ltype: int, params: TraceParams, cobjs, mesh, world: WorldConst,
              land_color=None, snow_depth=None) -> tuple | None:
    """Everything a capture of a batch bakes in, hashable: the device, the
    inputs' shapes and dtypes, the lighting type, the params and world,
    and the scene (cobjs, mesh, land colour, snow) by identity and by its
    tensors' `_version`s; None off a card, where a batch never captures."""
    dev = b["rays"][0].device
    if dev.type != "cuda":
        return None
    shapes = tuple((k, tuple(None if t is None else (tuple(t.shape), t.dtype)
                             for t in ((v,) if isinstance(v, torch.Tensor) else v)))
                   for k, v in b.items())
    return (dev, shapes, ltype, params, world) + tuple(
        CG.tensors_key(x) for x in (cobjs, mesh, land_color, snow_depth))


BATCHES = CG.GraphCache("light")


def segment_samples(b: int, params: TraceParams) -> int:
    """The samples a segment of bounce `b` deposits."""
    if params.compact and b > 0 and params.samples_later:
        return params.samples_later
    return params.samples_per_segment


def compact_slots(n: int, b: int, slots: int, params: TraceParams) -> int:
    """The slot count the compaction after bounce `b` aims at, for a batch
    of `n` rays now in `slots` slots (it shrinks only when that is fewer):
    n >> (b + 1 + shift), the shift capped at 4 more halvings, at least
    1,024."""
    sh = params.compact_shift
    return max(min(n >> min(b + 1 + sh, 4 + sh), slots), 1024)


def compact_schedule(n: int, params: TraceParams) -> list:
    """(slots, kept) for each bounce of a batch of `n` rays: the slots it
    traces and the slots the compaction after it keeps (fewer: it runs).
    The static schedule `trace_batch` follows, so a caller counts the work
    without a read of the device."""
    out, slots = [], n
    for b in range(params.max_bounces):
        keep = compact_slots(n, b, slots, params) if params.compact else slots
        out.append((slots, keep))
        slots = min(slots, keep)
    return out


def bounce_slots(n: int, params: TraceParams) -> list:
    """Each bounce's slot count for a batch of `n` rays (`compact_schedule`)."""
    return [slots for slots, _ in compact_schedule(n, params)]


# ---------------------------------------------------------------------------
# ray generation for the lighting types (trace_ray_block_* semantics)
# ---------------------------------------------------------------------------

def _full(n: int, v, device) -> torch.Tensor:
    return torch.full((n,), float(v), dtype=torch.float32, device=device)


def sky_rays(draws: TraceDraws, n: int, world: WorldConst, sky_color=(0.7, 0.8, 1.0),
             ray_weight: float = 1.0):
    """Hemisphere dome points aimed at random scene points
    (trace_ray_block_sky, ray_trace.cpp:830+), on the draws' device."""
    dev = draws.device
    dome_r = 2.5 * max(world.x_scene, world.y_scene)
    u = draws.rays(6, 0, (n,))
    phi = draws.rays(6, 1, (n,), lo=0.0, hi=2 * np.pi)
    cos_t = sqrt32(u)  # bias toward zenith
    sin_t = sqrt32(1.0 - u)
    ox = dome_r * sin_t * cos32(phi)
    oy = dome_r * sin_t * sin32(phi)
    oz = dome_r * cos_t + 0.1
    tx = draws.rays(6, 2, (n,), lo=-world.x_scene, hi=world.x_scene)
    ty = draws.rays(6, 3, (n,), lo=-world.y_scene, hi=world.y_scene)
    tz = draws.rays(6, 4, (n,), lo=-world.z_scene, hi=0.5 * world.z_scene)
    dx, dy, dz = tx - ox, ty - oy, tz - oz
    dl = sqrt32(dx * dx + dy * dy + dz * dz)
    c = sky_color
    return (ox, oy, oz, dx / dl, dy / dl, dz / dl, _full(n, ray_weight / n, dev),
            _full(n, c[0], dev), _full(n, c[1], dev), _full(n, c[2], dev))


def global_rays(draws: TraceDraws, n: int, sun_dir, world: WorldConst,
                sun_color=(1.0, 0.95, 0.85), ray_weight: float = 1.0):
    """Directional sun/moon rays over the scene footprint
    (trace_ray_block_global)."""
    dev = draws.device
    tx = draws.rays(2, 0, (n,), lo=-world.x_scene, hi=world.x_scene)
    ty = draws.rays(2, 1, (n,), lo=-world.y_scene, hi=world.y_scene)
    sd = np.asarray(sun_dir, np.float32)
    sd = sd / np.linalg.norm(sd)   # direction FROM sun TOWARD scene
    dome = 4.0 * max(world.x_scene, world.y_scene)
    ox = tx - float(sd[0] * dome)
    oy = ty - float(sd[1] * dome)
    oz = torch.zeros(n, dtype=torch.float32, device=dev) - float(sd[2] * dome)
    return (ox, oy, oz, _full(n, sd[0], dev), _full(n, sd[1], dev), _full(n, sd[2], dev),
            _full(n, ray_weight / n, dev), _full(n, sun_color[0], dev),
            _full(n, sun_color[1], dev), _full(n, sun_color[2], dev))


def _unit_normals(draws: TraceDraws, splits: int, first: int, n: int):
    vx, vy, vz = (draws.rays(splits, first + i, (n,), "normal") for i in range(3))
    vl = sqrt32(vx * vx + vy * vy + vz * vz) + 1e-9
    return vx, vy, vz, vl


def local_rays(draws: TraceDraws, n: int, light_pos, light_color, world: WorldConst,
               ray_weight: float = 1.0):
    """Uniform sphere rays from one point light (trace_ray_block_local)."""
    dev = draws.device
    vx, vy, vz, vl = _unit_normals(draws, 3, 0, n)
    p, c = light_pos, light_color
    return (_full(n, p[0], dev), _full(n, p[1], dev), _full(n, p[2], dev),
            vx / vl, vy / vl, vz / vl, _full(n, ray_weight / n, dev),
            _full(n, c[0], dev), _full(n, c[1], dev), _full(n, c[2], dev))


def scene_light_rays(draws: TraceDraws, spec, n: int, world: WorldConst,
                     total: int | None = None, first: int = 0):
    """Rays for one scene-DSL LightSpec ('L'/'V'/'U' commands) —
    ray_trace_local_light_source equivalent (ray_trace.cpp:889-981):
    point / line / spot / cube lights.

    ray weight = 1000 * alpha * radius / N (ray_trace.cpp:897);
    spotlights modulate per-ray weight by get_dir_intensity
    (light_source.cpp:86-92); line lights space origins along the
    segment; r_inner offsets the origin along a random direction.  A light
    traced in several batches gives N as `total` and each batch's rays
    their place `first` among them."""
    dev = draws.device
    cr, cg, cb = spec.color[0], spec.color[1], spec.color[2]
    alpha = spec.color[3] if len(spec.color) > 3 else 1.0
    radius = max(spec.size, 1e-3)
    total = total or n
    ray_wt = 1000.0 * alpha * radius / total
    vx, vy, vz, vl = _unit_normals(draws, 8, 0, n)
    dx, dy, dz = vx / vl, vy / vl, vz / vl
    f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=dev)

    if getattr(spec, "is_cube_light", False):
        # emit outward from the faces of the cube [pos, pos2]
        lo = torch.minimum(f32(spec.pos), f32(spec.pos2))
        hi = torch.maximum(f32(spec.pos), f32(spec.pos2))
        p = lo + draws.rays(8, 3, (n, 3)) * (hi - lo)
        face = draws.rays(8, 4, (n,), "randint", hi=6)
        axis = face // 2
        sgn = torch.where(face % 2 == 1, 1.0, -1.0)
        fpos = torch.where(sgn > 0, hi[axis], lo[axis])
        rows = torch.arange(n, device=dev)
        p[rows, axis] = fpos + 1e-5 * radius * sgn
        nrm = torch.zeros((n, 3), dtype=torch.float32, device=dev)
        nrm[rows, axis] = sgn
        flip = (dx * nrm[:, 0] + dy * nrm[:, 1] + dz * nrm[:, 2]) < 0
        dx, dy, dz = (torch.where(flip, -d, d) for d in (dx, dy, dz))
        ox_, oy_, oz_ = p[:, 0], p[:, 1], p[:, 2]
        w = _full(n, ray_wt, dev)
    else:
        p0 = f32(spec.pos)
        ox_, oy_, oz_ = (p0[a].expand(n) for a in range(3))
        if getattr(spec, "is_line", False):
            fr = (torch.arange(first, first + n, dtype=torch.float32, device=dev)
                  / max(total - 1, 1))
            p1 = f32(spec.pos2)
            ox_, oy_, oz_ = (p0[a] + fr * (p1[a] - p0[a]) for a in range(3))
        if spec.r_inner > 0.0:
            mx, my, mz, ml = _unit_normals(draws, 8, 5, n)
            s = torch.where((dx * mx + dy * my + dz * mz) < 0, -spec.r_inner, spec.r_inner)
            ox_ = ox_ + s * mx / ml
            oy_ = oy_ + s * my / ml
            oz_ = oz_ + s * mz / ml
        w = _full(n, ray_wt, dev)
        bw = float(spec.beamwidth)
        ld = np.asarray(spec.dir, np.float32)
        if bw < 1.0 and float(np.linalg.norm(ld)) > 1e-6:
            # get_dir_intensity(-dir): dp in [-1,1] -> dp_norm [0,1]
            ld = ld / np.linalg.norm(ld)
            dp = dx * float(ld[0]) + dy * float(ld[1]) + dz * float(ld[2])
            dp_norm = 0.5 * (dp + 1.0)
            inten = torch.clamp(2.0 * (dp_norm + bw + LT_DIR_FALLOFF - 1.0) / LT_DIR_FALLOFF,
                                0.0, 1.0)
            w = w * inten
    return (ox_.contiguous(), oy_.contiguous(), oz_.contiguous(), dx, dy, dz, w,
            _full(n, cr, dev), _full(n, cg, dev), _full(n, cb, dev))


# ---------------------------------------------------------------------------
# static gates (read the scene on the host once per bake)
# ---------------------------------------------------------------------------

def _auto_transmission(params: TraceParams, cobjs) -> TraceParams:
    """Gate the transmission branch off when NO cobj is semi-transparent:
    with every alpha == 1 the branch deposits exact zeros and always takes
    the reflected path, so skipping it changes nothing."""
    if params.transmission and not bool((cobjs.alpha < 1.0).any()):
        return params._replace(transmission=False)
    return params


def _auto_specular(params: TraceParams, cobjs, snow_depth=None) -> TraceParams:
    """Gate the specular scatter off when nothing can be specular: no cobj
    with specular > 0, no ice, no snow cover."""
    if not params.specular_enabled:
        return params
    if params.temperature <= W_FREEZE_POINT or snow_depth is not None:
        return params
    if bool((cobjs.specular > 0.0).any()):
        return params
    return params._replace(specular_enabled=False)


def _auto_types(params: TraceParams, cobjs) -> TraceParams:
    """Record the scene's shape-type presence so the intersect skips
    absent formula families."""
    if params.cobj_types:
        return params
    return params._replace(cobj_types=R.present_types(cobjs))


def _auto_gates(params: TraceParams, cobjs, snow_depth=None) -> TraceParams:
    """All static scene-derived gates in one call.  Every driver here
    generates uniform-color ray batches, so the bounce-0 weight-only
    deposit is enabled too (compact path only)."""
    params = _auto_transmission(params, cobjs)
    params = _auto_specular(params, cobjs, snow_depth)
    if params.compact:
        params = params._replace(uniform_color0=True)
    return _auto_types(params, cobjs)


# ---------------------------------------------------------------------------
# bakes: each plans its batches, `trace_batches` traces them
# ---------------------------------------------------------------------------

class RayBatch(NamedTuple):
    """One batch of a bake: its lighting type, its ray count, its draw
    stream after the seed (the ray draws (*stream, 1, *tail), the trace
    draws (*stream, 2, *tail)) and `rays`, which makes its rays from its
    ray draws."""

    ltype: int
    n: int
    stream: tuple
    tail: tuple
    rays: Callable


def _split(total: int, batch: int | None) -> list:
    """(first ray, rays) of each batch of at most `batch` rays."""
    batch = batch or max(total, 1)
    return [(i, min(batch, total - i)) for i in range(0, total, batch)]


def sky_batches(num_rays: int, batch: int, world: WorldConst = DEFAULT_WORLD) -> list:
    """The sky part: batch i draws from (SKY_STREAM, i); every ray weighs
    1, whatever its batch's size (a partial final batch must not
    over-weight its rays)."""
    return [RayBatch(L.LIGHTING_SKY, n, (SKY_STREAM, i), (),
                     partial(sky_rays, n=n, world=world, ray_weight=float(n)))
            for i, (_, n) in enumerate(_split(num_rays, batch))]


def global_batches(num_rays: int, batch: int, sun_dir,
                   world: WorldConst = DEFAULT_WORLD) -> list:
    """The sun's part: batch i draws from (GLOBAL_STREAM, i); every ray
    weighs 1."""
    return [RayBatch(L.LIGHTING_GLOBAL, n, (GLOBAL_STREAM, i), (),
                     partial(global_rays, n=n, sun_dir=sun_dir, world=world,
                             ray_weight=float(n)))
            for i, (_, n) in enumerate(_split(num_rays, batch))]


def local_batches(lights, rays_per_light: int, world: WorldConst = DEFAULT_WORLD) -> list:
    """One batch a (pos, color) point light, drawing from (LOCAL_STREAM,
    light); every ray weighs 1."""
    return [RayBatch(L.LIGHTING_LOCAL, rays_per_light, (LOCAL_STREAM, li), (),
                     partial(local_rays, n=rays_per_light, light_pos=pos, light_color=color,
                             world=world, ray_weight=float(rays_per_light)))
            for li, (pos, color) in enumerate(lights)]


def scene_light_batches(light_specs, rays_per_light: int, world: WorldConst = DEFAULT_WORLD,
                        batch: int | None = None) -> list:
    """The scene-DSL lights' part: light i (its place in `light_specs`)
    traces its `num_dlight_rays`, else `rays_per_light`, in batches of at
    most `batch` (one batch by default); its batch j draws from
    (SCENE_STREAM, i) with j after the 1 | 2 where j > 0.  Ambient lights
    tint the base lmap and are not traced."""
    out = []
    for li, spec in enumerate(light_specs):
        if getattr(spec, "kind", "diffuse") == "ambient":
            continue
        total = spec.num_dlight_rays or rays_per_light
        out += [RayBatch(L.LIGHTING_LOCAL, n, (SCENE_STREAM, li), (j,) if j else (),
                         partial(scene_light_rays, spec=spec, n=n, world=world, total=total,
                                 first=first))
                for j, (first, n) in enumerate(_split(total, batch))]
    return out


def gated_params(params: TraceParams, cobjs, snow_depth=None) -> dict:
    """Each lighting type's parameters: the scene's static gates
    (`_auto_gates`, read once), and for the sky a compaction shift of at
    least 1, since sky-dome populations collapse fast (most rays escape
    upward)."""
    gated = _auto_gates(params, cobjs, snow_depth)
    sky = gated
    if sky.compact and sky.compact_shift == 0:
        sky = sky._replace(compact_shift=1)
    return {L.LIGHTING_SKY: sky, L.LIGHTING_GLOBAL: gated, L.LIGHTING_LOCAL: gated}


def trace_batches(grid, cobjs, mesh, batches, seed: int, params: dict,
                  world: WorldConst = DEFAULT_WORLD, land_color=None, snow_depth=None,
                  draws: DrawSource | None = None):
    """Trace planned `batches` in order into `grid`, each with its type's
    `params` (`gated_params`) and the draws of its stream."""
    draws = draws or DrawSource(grid.sv.device)
    for b in batches:
        rays = b.rays(draws(seed, *b.stream, 1, *b.tail))
        grid = trace_batch(grid, cobjs, mesh, *rays, draws(seed, *b.stream, 2, *b.tail),
                           ltype=b.ltype, params=params[b.ltype], world=world,
                           land_color=land_color, snow_depth=snow_depth)
    return grid


def compute_sky_lighting(grid, cobjs, mesh, num_rays: int, seed: int = 0,
                         params: TraceParams = TraceParams(),
                         world: WorldConst = DEFAULT_WORLD,
                         batch: int = 65536, land_color=None, snow_depth=None,
                         draws: DrawSource | None = None):
    """compute_ray_trace_lighting(LIGHTING_SKY) equivalent: batched
    (`sky_batches`).  Returns the RAW accumulated grid — `final_color`
    consumes it directly and incremental cobj-accum deltas compose
    linearly on it.  `draws` makes each batch's draws (default: generators
    on the grid's device)."""
    return trace_batches(grid, cobjs, mesh, sky_batches(num_rays, batch, world), seed,
                         gated_params(params, cobjs, snow_depth), world, land_color,
                         snow_depth, draws)


def compute_local_lighting(grid, cobjs, mesh, lights, rays_per_light: int,
                           seed: int = 0, params: TraceParams = TraceParams(),
                           world: WorldConst = DEFAULT_WORLD,
                           land_color=None, snow_depth=None,
                           draws: DrawSource | None = None):
    """LIGHTING_LOCAL: one batch per configured (pos, color) light."""
    return trace_batches(grid, cobjs, mesh, local_batches(lights, rays_per_light, world), seed,
                         gated_params(params, cobjs, snow_depth), world, land_color,
                         snow_depth, draws)


def compute_scene_lighting(grid, cobjs, mesh, light_specs, rays_per_light: int,
                           seed: int = 0, params: TraceParams = TraceParams(),
                           world: WorldConst = DEFAULT_WORLD,
                           land_color=None, snow_depth=None,
                           draws: DrawSource | None = None):
    """LIGHTING_LOCAL over the scene-DSL light list (SceneParse.lights:
    point, line, spot and cube-shaped `LightSpec`s): the path from
    'L'/'V'/'U' commands to the volume, one batch a light.  The 'b' cube
    volumes of SceneParse.cube_lights are not traced."""
    return trace_batches(grid, cobjs, mesh, scene_light_batches(light_specs, rays_per_light,
                                                                world),
                         seed, gated_params(params, cobjs, snow_depth), world, land_color,
                         snow_depth, draws)

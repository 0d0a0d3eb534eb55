"""Procedural trees: batched branch generation + placement (port of
`3dworld_tpu/veg/trees.py`).

The reference builds each deciduous tree by per-tree recursive cylinder
branching with 4 levels and per-type parameters (tree_type table
Tree.cpp:37-44; builder `tree_builder_t` Tree.cpp), and places trees by
density/slope-thresholded noise sampling (Tree.cpp:2214+,
tree_density_thresh / tree_slope_thresh); pine/palm "small trees" are
instanced cone+cylinder pairs (sm_tree.cpp).

Generation is level-parallel: level k's cylinders for ALL trees at once,
elementwise over [T, ...] tensors, instead of walking each tree's
recursion.  The JAX package draws threefry streams keyed by (seed, tree,
branch); here the draws are inputs: `TreeDraws` and `SmallTreeDraws`
(made by `draw_trees` / `draw_small_trees` from a CPU generator), and the
leaf dynamics take their uniform or normal tensors.  Sines and cosines go
through `ops/fmath`, so the card and the CPU give the same bits.

Placement (`place_trees_on_tile`) hashes each cell; the JAX package sorts
the uint32 score with a stable argsort, every rejected cell tying at
0xFFFFFFFF; the port sorts an int64 copy stably, and keeps the uint32
seed arithmetic in int64 masked to 32 bits.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops.fmath import cos32, div32, sin32, sqrt32
from ..utils import rng as w3d_rng

# tree_type table (Tree.cpp:37-44):
# (branch_size, branch_radius, leaf_size, height_scale, branch_break_off)
TREE_TYPES = np.array([
    # bsize brad  lsize hscale break_off
    (1.0, 0.7, 1.0, 1.0, 1.0),
    (1.0, 1.0, 1.0, 1.0, 1.0),
    (1.0, 1.0, 1.0, 2.0, 0.5),
    (1.0, 0.7, 1.5, 1.0, 1.0),   # birch
    (1.0, 1.0, 1.0, 2.0, 2.0),   # papaya
], np.float32)
NUM_TREE_TYPES = len(TREE_TYPES)

TRUNK_SEGS = 4
NUM_B1 = 10      # first-level branches
NUM_B2 = 4       # second-level per branch
LEAVES_PER_B2 = 4
MAX_CYLINS = TRUNK_SEGS + NUM_B1 + NUM_B1 * NUM_B2
MAX_LEAVES = NUM_B1 * NUM_B2 * LEAVES_PER_B2
_U32 = 0xFFFFFFFF


class TreeSet(NamedTuple):
    """Batched tree geometry, SoA (all [T, MAX_CYLINS] / [T, MAX_LEAVES])."""

    cyl_x1: torch.Tensor
    cyl_y1: torch.Tensor
    cyl_z1: torch.Tensor
    cyl_x2: torch.Tensor
    cyl_y2: torch.Tensor
    cyl_z2: torch.Tensor
    cyl_r1: torch.Tensor
    cyl_r2: torch.Tensor
    cyl_level: torch.Tensor    # 0=trunk, 1, 2
    leaf_x: torch.Tensor
    leaf_y: torch.Tensor
    leaf_z: torch.Tensor
    leaf_size: torch.Tensor


class TreeDraws(NamedTuple):
    """`gen_trees`' draws for T trees, each uniform already in its range
    (the JAX key chain: split 8 ways; the level-1 and level-2 branch keys
    split 4 ways, the leaf key 3 ways)."""

    height: torch.Tensor    # [T] U(0.8, 1.2)
    lean_x: torch.Tensor    # [T, TRUNK_SEGS] normal
    lean_y: torch.Tensor    # [T, TRUNK_SEGS] normal
    attach1: torch.Tensor   # [T, NUM_B1] U(0.35, 0.95)
    phi1: torch.Tensor      # [T, NUM_B1] U(0, 2 pi)
    theta1: torch.Tensor    # [T, NUM_B1] U(0.35 pi, 0.55 pi)
    len1: torch.Tensor      # [T, NUM_B1] U(0.7, 1.3)
    attach2: torch.Tensor   # [T, NUM_B1, NUM_B2] U(0.3, 1.0)
    phi2: torch.Tensor      # [T, NUM_B1, NUM_B2] U(0, 2 pi)
    theta2: torch.Tensor    # [T, NUM_B1, NUM_B2] U(0.2 pi, 0.6 pi)
    len2: torch.Tensor      # [T, NUM_B1, NUM_B2] U(0.6, 1.2)
    leaf_t: torch.Tensor    # [T, NUM_B1, NUM_B2, LEAVES_PER_B2] U(0.5, 1.0)
    leaf_jx: torch.Tensor   # [T, NUM_B1, NUM_B2, LEAVES_PER_B2] normal
    leaf_jy: torch.Tensor   # [T, NUM_B1, NUM_B2, LEAVES_PER_B2] normal


# each uniform field's range, in TreeDraws order (None: standard normal)
TREE_DRAW_RANGES = ((0.8, 1.2), None, None, (0.35, 0.95), (0.0, 2 * np.pi),
                    (0.35 * np.pi, 0.55 * np.pi), (0.7, 1.3), (0.3, 1.0),
                    (0.0, 2 * np.pi), (0.2 * np.pi, 0.6 * np.pi), (0.6, 1.2),
                    (0.5, 1.0), None, None)


def _tree_draw_shapes(t: int):
    sh1, sh2 = (t, NUM_B1), (t, NUM_B1, NUM_B2)
    shl = sh2 + (LEAVES_PER_B2,)
    return ((t,), (t, TRUNK_SEGS), (t, TRUNK_SEGS), sh1, sh1, sh1, sh1,
            sh2, sh2, sh2, sh2, shl, shl, shl)


def _uniform(g: torch.Generator, shape, lo: float, hi: float) -> torch.Tensor:
    """Uniform float32 in [lo, hi): u * (hi - lo) + lo, at least lo
    (threefry's `uniform(minval, maxval)` map)."""
    u = torch.rand(shape, generator=g, dtype=torch.float32)
    lo32, hi32 = np.float32(lo), np.float32(hi)
    return torch.clamp(u * float(hi32 - lo32) + float(lo32), min=float(lo32))


def draw_trees(n: int, generator: torch.Generator,
               device: torch.device | str = "cuda") -> TreeDraws:
    """`TreeDraws` for n trees from a CPU generator, copied to `device`."""
    out = []
    for shape, rng in zip(_tree_draw_shapes(n), TREE_DRAW_RANGES):
        v = (torch.randn(shape, generator=generator, dtype=torch.float32)
             if rng is None else _uniform(generator, shape, *rng))
        out.append(v.to(device))
    return TreeDraws(*out)


def _unit_from_angles(theta, phi):
    st = sin32(theta)
    return st * cos32(phi), st * sin32(phi), cos32(theta)


def _type_rows(type_id: torch.Tensor, table: np.ndarray) -> torch.Tensor:
    return torch.as_tensor(table, device=type_id.device)[type_id.long()]


def gen_trees(draws: TreeDraws, base_x, base_y, base_z, type_id,
              height_scale=1.0) -> TreeSet:
    """Generate T trees at base positions [T] with per-tree type ids, on
    the draws' device; deterministic per (draws, tree index)."""
    T = base_x.shape[0]
    tt = _type_rows(type_id, TREE_TYPES)
    b_size, b_rad, l_size = tt[:, 0], tt[:, 1], tt[:, 2]
    h_scale = tt[:, 3] * height_scale
    dev = base_x.device

    height = 0.35 * h_scale * draws.height
    trunk_r = 0.035 * b_rad * height / torch.tensor(0.35, device=dev)

    # trunk: TRUNK_SEGS stacked segments with slight lean
    seg_h = height / torch.tensor(float(TRUNK_SEGS), device=dev)
    seg_dx = torch.cumsum(0.08 * draws.lean_x, 1) * seg_h[:, None]
    seg_dy = torch.cumsum(0.08 * draws.lean_y, 1) * seg_h[:, None]
    s = torch.arange(TRUNK_SEGS, dtype=torch.float32, device=dev)
    t_z1 = base_z[:, None] + s[None, :] * seg_h[:, None]
    t_z2 = t_z1 + seg_h[:, None]
    shift = lambda a: torch.nn.functional.pad(a, (1, 0))[:, :TRUNK_SEGS]
    t_x1 = base_x[:, None] + shift(seg_dx)
    t_y1 = base_y[:, None] + shift(seg_dy)
    t_x2 = base_x[:, None] + seg_dx
    t_y2 = base_y[:, None] + seg_dy
    taper = 1.0 - 0.18 * s[None, :]
    t_r1 = trunk_r[:, None] * taper
    t_r2 = trunk_r[:, None] * (taper - 0.18)

    # level-1 branches off the upper trunk
    attach = draws.attach1
    blen1 = 0.45 * height[:, None] * b_size[:, None] * draws.len1 * (1.2 - 0.5 * attach)
    ax = base_x[:, None] + attach * seg_dx[:, -1:]
    ay = base_y[:, None] + attach * seg_dy[:, -1:]
    az = base_z[:, None] + attach * height[:, None]
    d1x, d1y, d1z = _unit_from_angles(draws.theta1, draws.phi1)
    b1_x2 = ax + blen1 * d1x
    b1_y2 = ay + blen1 * d1y
    b1_z2 = az + blen1 * d1z
    b1_r1 = 0.4 * trunk_r[:, None] * (1.2 - 0.6 * attach)
    b1_r2 = 0.35 * b1_r1

    # level-2 branches off each level-1 branch
    sh2 = (T, NUM_B1, NUM_B2)
    attach2 = draws.attach2
    blen2 = 0.45 * blen1[..., None] * draws.len2
    a2x = ax[..., None] + attach2 * (b1_x2 - ax)[..., None]
    a2y = ay[..., None] + attach2 * (b1_y2 - ay)[..., None]
    a2z = az[..., None] + attach2 * (b1_z2 - az)[..., None]
    d2x, d2y, d2z = _unit_from_angles(draws.theta2, draws.phi2)
    b2_x2 = a2x + blen2 * d2x
    b2_y2 = a2y + blen2 * d2y
    b2_z2 = a2z + blen2 * d2z
    b2_r1 = 0.4 * b1_r1[..., None].expand(sh2)
    b2_r2 = 0.3 * b2_r1

    # leaves at the ends of level-2 branches
    lt = draws.leaf_t
    jx = 0.03 * draws.leaf_jx
    jy = 0.03 * draws.leaf_jy
    leaf_x = (a2x[..., None] + lt * (b2_x2 - a2x)[..., None] + jx).reshape(T, -1)
    leaf_y = (a2y[..., None] + lt * (b2_y2 - a2y)[..., None] + jy).reshape(T, -1)
    leaf_z = (a2z[..., None] + lt * (b2_z2 - a2z)[..., None]).reshape(T, -1)
    leaf_size = (0.02 * l_size)[:, None].expand(T, MAX_LEAVES)

    cat = lambda *a: torch.cat([x.reshape(T, -1) for x in a], dim=1)
    level = torch.cat([torch.zeros(TRUNK_SEGS), torch.ones(NUM_B1),
                       torch.full((NUM_B1 * NUM_B2,), 2.0)]).to(torch.int32)
    return TreeSet(
        cyl_x1=cat(t_x1, ax * torch.ones_like(b1_x2), a2x),
        cyl_y1=cat(t_y1, ay * torch.ones_like(b1_y2), a2y),
        cyl_z1=cat(t_z1, az * torch.ones_like(b1_z2), a2z),
        cyl_x2=cat(t_x2, b1_x2, b2_x2),
        cyl_y2=cat(t_y2, b1_y2, b2_y2),
        cyl_z2=cat(t_z2, b1_z2, b2_z2),
        cyl_r1=cat(t_r1, b1_r1, b2_r1),
        cyl_r2=cat(t_r2, b1_r2, b2_r2),
        cyl_level=level.to(dev)[None].expand(T, MAX_CYLINS),
        leaf_x=leaf_x, leaf_y=leaf_y, leaf_z=leaf_z, leaf_size=leaf_size,
    )


def place_trees_on_tile(seed: int, tile_x0: float, tile_y0: float,
                        zvals, norm_z, weights, world,
                        density: float = 0.5, max_trees: int = 256,
                        slope_thresh: float = 0.6):
    """Density/slope-gated tree placement on a tile (the `regen_trees` /
    tiled tree distribution semantics: hashed per-cell Bernoulli draws
    modulated by vegetation density on grass/dirt, rejected on steep or
    snowy cells), on `zvals`' device.  Returns (x, y, z, type_id, valid)
    [max_trees]."""
    from ..terrain import biomes as B

    my, mx = zvals.shape
    cell = torch.arange(my * mx, dtype=torch.int64, device=zvals.device)
    off = (seed * 2654435761 % (1 << 31)) & _U32
    h = w3d_rng.xxhash_u32((cell + off) & _U32, seed=seed)   # int64 in [0, 2^32)
    u = (h >> 8).to(torch.float32) / float(1 << 24)
    veg_w = (weights[B.GRASS] + 0.5 * weights[B.DIRT]).reshape(-1)
    ok = (u < density * veg_w * 0.1) & (norm_z.reshape(-1) > slope_thresh)
    # order cells by hash, take first max_trees accepted (deterministic)
    score = torch.where(ok, h, _U32)
    order = torch.argsort(score, stable=True)[:max_trees]
    valid = ok[order]
    cy = torch.div(order, mx, rounding_mode="floor").to(torch.float32)
    cx = (order % mx).to(torch.float32)
    x = (tile_x0 + cx) * world.dx - world.x_scene * 0.0
    y = (tile_y0 + cy) * world.dy
    z = zvals.reshape(-1)[order]
    tid = (h[order] % NUM_TREE_TYPES).to(torch.int32)
    return x, y, z, tid, valid


class SmallTreeSet(NamedTuple):
    """Pine/palm instances (sm_tree.cpp): trunk cylinder + cone levels."""

    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor
    height: torch.Tensor
    width: torch.Tensor
    kind: torch.Tensor   # 0=pine, 1=palm


class SmallTreeDraws(NamedTuple):
    """`gen_small_trees`' draws for n trees (the JAX key split 3 ways)."""

    height: torch.Tensor   # [n] U(0.8, 1.4)
    width: torch.Tensor    # [n] U(0.8, 1.2)
    kind_u: torch.Tensor   # [n] U(0, 1)


def draw_small_trees(n: int, generator: torch.Generator,
                     device: torch.device | str = "cuda") -> SmallTreeDraws:
    g = generator
    return SmallTreeDraws(*(v.to(device) for v in (
        _uniform(g, (n,), 0.8, 1.4), _uniform(g, (n,), 0.8, 1.2),
        _uniform(g, (n,), 0.0, 1.0))))


def gen_small_trees(draws: SmallTreeDraws, x, y, z, kind=None) -> SmallTreeSet:
    height = 0.2 * draws.height
    width = 0.35 * height * draws.width
    if kind is None:
        kind = (draws.kind_u < 0.8).to(torch.int32)  # mostly pine
    return SmallTreeSet(x=x, y=y, z=z, height=height, width=width, kind=kind)


# ---------------------------------------------------------------------------
# leaf dynamics (Tree.cpp:588-830): per-leaf color/health, temperature
# leaf fall, burning, blast damage, spraypaint
# ---------------------------------------------------------------------------

LEAF_GEN_RAND1 = 16      # every Nth leaf considered (Tree.cpp:21)
LEAF_GEN_RAND2 = 200000  # larger is fewer leaves falling (Tree.cpp:22)
LEAF_DAM_SCALE = 0.0001  # blast -> leaf damage (Gameplay LEAF_DAM_SCALE)

# per-type base leaf colors (tree_type color entries; birch lighter)
LEAF_BASE_COLORS = np.array([
    (0.20, 0.55, 0.15), (0.16, 0.50, 0.13), (0.22, 0.60, 0.20),
    (0.35, 0.60, 0.22), (0.25, 0.58, 0.18)], np.float32)


class LeafState(NamedTuple):
    """Batched per-leaf dynamics ([T, MAX_LEAVES]): lcolor is the
    reference's 0..1000 health/greenness (<= 0 black, -1000 destroyed);
    damage [T] is the tree's accumulated damage fraction."""

    lcolor: torch.Tensor    # [T, L]
    r: torch.Tensor         # [T, L] display colors (lcolor-blended)
    g: torch.Tensor
    b: torch.Tensor
    damage: torch.Tensor    # [T]


def init_leaves(jitter: torch.Tensor, type_id, deadness: float = 0.0,
                coherence: float = 0.5) -> LeafState:
    """gen_leaf_color / create_init_color (Tree.cpp:87-150): per-leaf
    color jitter around the type base (`jitter` [T, MAX_LEAVES, 3]
    standard normal), reduced by `coherence`; global `deadness` browns
    and lowers initial lcolor."""
    T = type_id.shape[0]
    dev = jitter.device
    base = _type_rows(type_id, LEAF_BASE_COLORS)        # [T, 3]
    jit_amt = 0.12 * (1.0 - coherence)
    jr = jit_amt * jitter
    lcolor = torch.full((T, MAX_LEAVES), 1000.0 * (1.0 - 0.7 * deadness),
                        dtype=torch.float32, device=dev)
    col = torch.clamp(base[:, None, :] + jr, 0.0, 1.0)
    dead_mix = deadness * 0.6
    brown = torch.tensor([0.35, 0.22, 0.08], device=dev)
    col = (1 - dead_mix) * col + dead_mix * brown
    return LeafState(lcolor=lcolor, r=col[..., 0], g=col[..., 1],
                     b=col[..., 2], damage=torch.zeros((T,), device=dev))


def drop_leaves(ls: LeafState, stride_off: torch.Tensor, u: torch.Tensor,
                temperature=20.0, fticks=1.0):
    """tree::drop_leaves (Tree.cpp:807-829): every LEAF_GEN_RAND1-th
    leaf falls with probability 1/rmod (`stride_off` [T, 1] int in
    [0, LEAF_GEN_RAND1), `u` [T, L] uniform).  Quirk preserved: the
    reference's temp0 = max(1.0, min(0.3, (20-T)/30)) collapses to 1.0 for
    every temperature (swapped max/min), so temperature does not actually
    modulate leaf fall.  Returns (ls, fell [T, L]) — the caller spawns
    LEAF physics objects at the fallen leaves' positions."""
    T, L = ls.lcolor.shape
    temp0 = 1.0    # reference quirk (see docstring)
    rmod = float(np.clip(np.float32(temp0 * LEAF_GEN_RAND2) / np.float32(max(fticks, 1e-3)),
                         1.0, LEAF_GEN_RAND2 / 10.0))
    lanes = torch.arange(L, device=u.device)[None, :]
    stride_ok = (lanes + stride_off) % LEAF_GEN_RAND1 == 0
    fell = stride_ok & (u < float(np.float32(1.0) / np.float32(rmod))) & (ls.lcolor > 0) \
        & (ls.damage[:, None] < 1.0)
    return ls, fell


def burn_leaves(ls: LeafState, u: torch.Tensor, temperature, max_t: float = 60.0):
    """tree::burn_leaves (Tree.cpp:666-685): above the leaf max
    temperature, up to 5 random leaves per tree char per frame (lcolor
    drops; destroyed at 0), accumulating tree damage (`u` [T, L]
    uniform)."""
    T, L = ls.lcolor.shape
    over = np.float32(max(float(temperature) - max_t, 0.0))
    num_burn = np.clip(np.float32(5.0) * over / np.float32(max_t), 0.0, 5.0)
    p_burn = float(np.float32(num_burn) / np.float32(L))
    burn = (u < p_burn) & (ls.lcolor > -1000)
    lcolor = torch.where(burn, torch.clamp(ls.lcolor - 250.0, min=0.0), ls.lcolor)
    charred = burn & (lcolor <= 0.0)
    dmg = ls.damage + (1.0 - ls.damage) * div32(burn.sum(1).to(torch.float32), L)
    fade = torch.clamp(div32(lcolor, 1000.0), 0.0, 1.0)
    return ls._replace(
        lcolor=torch.where(charred, -1000.0, lcolor),
        r=torch.where(burn, ls.r * fade, ls.r),
        g=torch.where(burn, ls.g * fade, ls.g),
        b=torch.where(burn, ls.b * fade, ls.b),
        damage=torch.clamp(dmg, 0.0, 1.0)), charred


def _f32(v, device) -> torch.Tensor:
    """A scalar argument as a float32 tensor: the JAX functions take them
    traced, so their products round in float32."""
    return torch.as_tensor(v, dtype=torch.float32, device=device)


def blast_damage_leaves(ls: LeafState, trees: TreeSet, u: torch.Tensor,
                        bx, by, bz, bradius, bdamage):
    """tree::blast_damage + damage_leaf (Tree.cpp:707-760): leaves
    within the blast radius take distance-scaled damage; heavy damage
    destroys the leaf outright, and destroyed leaves have a 25% chance
    of falling as physics objects (`u` [T, L] uniform).  Returns (ls,
    fell)."""
    bx, by, bz, bradius, bdamage = (_f32(v, u.device) for v in (bx, by, bz, bradius, bdamage))
    d2 = ((trees.leaf_x - bx) ** 2 + (trees.leaf_y - by) ** 2
          + (trees.leaf_z - bz) ** 2)
    in_r = d2 < bradius * bradius
    dist_scale = 1.0 - sqrt32(d2) / torch.clamp(bradius, min=1e-6)
    done = torch.where(in_r, LEAF_DAM_SCALE * bdamage * dist_scale * 1e4, 0.0)
    heavy = done > 4.0
    lcolor = torch.where(in_r, torch.clamp(ls.lcolor - 300.0 * done, min=0.0), ls.lcolor)
    destroyed = (heavy | (in_r & (lcolor <= 0.0))) & (ls.lcolor > -1000)
    fell = destroyed & (u < 0.25)
    dmg = ls.damage + div32(destroyed.sum(1).to(torch.float32), ls.lcolor.shape[1])
    fade = torch.clamp(div32(lcolor, 1000.0), 0.2, 1.0)
    return ls._replace(
        lcolor=torch.where(destroyed, -1000.0, lcolor),
        r=torch.where(in_r, ls.r * fade, ls.r),
        g=torch.where(in_r, ls.g * fade, ls.g),
        b=torch.where(in_r, ls.b * fade, ls.b),
        damage=torch.clamp(dmg, 0.0, 1.0)), fell


def spraypaint_leaves(ls: LeafState, trees: TreeSet, px, py, pz, radius,
                      color):
    """tree::spraypaint_leaves (Tree.cpp:631-663): recolor live leaves
    within the spray radius."""
    px, py, pz, radius = (_f32(v, ls.r.device) for v in (px, py, pz, radius))
    d2 = ((trees.leaf_x - px) ** 2 + (trees.leaf_y - py) ** 2
          + (trees.leaf_z - pz) ** 2)
    hit = (d2 < radius * radius) & (ls.lcolor > -1000)
    return ls._replace(r=torch.where(hit, float(color[0]), ls.r),
                       g=torch.where(hit, float(color[1]), ls.g),
                       b=torch.where(hit, float(color[2]), ls.b))

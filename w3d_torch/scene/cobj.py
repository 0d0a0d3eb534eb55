"""Cobj scene specs and packing into the physics SoA (port of the packing
half of `3dworld_tpu/scene/cobj.py`).

Host-side: `RawCobj` specs with their `CobjLayer` material collect in a
`SceneParse`; `pack_cobjs` applies CSG subtraction of negative cubes and
packs the specs into a padded `physics.cobjs.CobjSet` on a device.  The
scene-file parser (the reference's `read_coll_obj_file` DSL) is not
ported yet; scenes are built in code, as the spheres scene is.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace

import numpy as np
import torch

from ..physics.cobjs import (  # noqa: F401  (shape ids are part of the scene API)
    CobjSet, COLL_CUBE, COLL_SPHERE, COLL_CYLINDER, COLL_CYLINDER_ROT,
    COLL_POLYGON, COLL_CAPSULE, COLL_TORUS,
)

_CSG_EPS = 1e-6


@dataclass
class CobjLayer:
    """Current material (cobj_params; 'l' build_world.cpp:1950-1963)."""

    elasticity: float = 0.5
    color: tuple = (1.0, 1.0, 1.0, 1.0)
    tid: int = -1
    tex_name: str = ""
    draw: bool = True
    refract_ix: float = 1.0
    light_atten: float = 0.0
    emissive: bool = False
    specular: float = 0.0           # scalar intensity (spec_color mean)
    spec_color: tuple = (0.0, 0.0, 0.0)
    shininess: float = 1.0
    friction: float = 0.0           # per-surface default, not in 'l'
    density: float = 1.0
    metalness: float = 0.0
    damage: float = 0.0
    destroy_prob: int = 0
    surfs: int = 0                  # 'e' skip-draw edges bitmask
    tscale: float = 1.0             # 'y'
    tdx: float = 0.0                # 'Y'
    tdy: float = 0.0
    swap_txy: bool = False
    normal_map: str = ""            # 'X'
    reflective: int = 0             # 0=none 1=planar 2=cube map
    is_voxel: bool = False          # 'v'


@dataclass
class RawCobj:
    shape: int
    p1: tuple = (0.0, 0.0, 0.0)
    p2: tuple = (0.0, 0.0, 0.0)
    r1: float = 0.0
    r2: float = 0.0
    pts: tuple = ()
    layer: CobjLayer = field(default_factory=CobjLayer)
    platform_id: int = -1
    group_id: int = -1
    draw_group_id: int = -1
    negative: bool = False
    movable: bool = False
    destroy: int = 0                # 'a' destroyability level
    corner_radius: float = 0.0      # cube optional


@dataclass
class SceneParse:
    """Parsed scene; only the cobj specs are carried so far."""

    cobjs: list = field(default_factory=list)


def _poly_normal(pts):
    a, b, c = (np.asarray(p) for p in pts[:3])
    n = np.cross(b - a, c - a)
    l = np.linalg.norm(n)
    return tuple(n / l) if l > 0 else (0.0, 0.0, 1.0)


def _cube_bounds(c: RawCobj):
    lo = tuple(min(c.p1[d], c.p2[d]) for d in range(3))
    hi = tuple(max(c.p1[d], c.p2[d]) for d in range(3))
    return lo, hi


def subtract_cube(pos: RawCobj, neg: RawCobj) -> list:
    """Subtract a negative cube from a positive cube -> up to 6 sub-cubes
    (csg subtract_cube)."""
    lp, hp = _cube_bounds(pos)
    ln, hn = _cube_bounds(neg)
    if any(hn[d] <= lp[d] + _CSG_EPS or ln[d] >= hp[d] - _CSG_EPS
           for d in range(3)):
        return [pos]
    ln = tuple(max(ln[d], lp[d]) for d in range(3))
    hn = tuple(min(hn[d], hp[d]) for d in range(3))
    pieces = []

    def emit(lo, hi):
        if all(hi[d] - lo[d] > _CSG_EPS for d in range(3)):
            pieces.append(replace(pos, p1=tuple(lo), p2=tuple(hi)))

    # slab decomposition: below/above in z, then y, then x
    emit((lp[0], lp[1], lp[2]), (hp[0], hp[1], ln[2]))
    emit((lp[0], lp[1], hn[2]), (hp[0], hp[1], hp[2]))
    emit((lp[0], lp[1], ln[2]), (hp[0], ln[1], hn[2]))
    emit((lp[0], hn[1], ln[2]), (hp[0], hp[1], hn[2]))
    emit((lp[0], ln[1], ln[2]), (ln[0], hn[1], hn[2]))
    emit((hn[0], ln[1], ln[2]), (hp[0], hn[1], hn[2]))
    return pieces


def _resolve_shape_groups(parse: SceneParse) -> list:
    """Apply CSG negative-shape subtraction (csg.cpp semantics) before
    packing: negative cubes carve positive cubes."""
    negatives = [c for c in parse.cobjs if c.negative]
    if not negatives:
        return list(parse.cobjs)
    out = []
    for c in parse.cobjs:
        if c.negative:
            continue
        pieces = [c]
        for neg in negatives:
            if neg.shape != COLL_CUBE or c.shape != COLL_CUBE:
                continue
            pieces = [q for p in pieces for q in subtract_cube(p, neg)]
        out.extend(pieces)
    return out


def pack_cobjs(parse: SceneParse, capacity: int | None = None,
               apply_csg: bool = True,
               device: torch.device | str = "cuda") -> CobjSet:
    """Pack parsed cobjs into the padded SoA (capacity a multiple of 128,
    as the JAX package pads)."""
    cobj_list = _resolve_shape_groups(parse) if apply_csg else \
        [c for c in parse.cobjs if not c.negative]
    n = len(cobj_list)
    if capacity is None:
        capacity = max(128, -(-n // 128) * 128)
    shape = np.zeros(capacity, np.int32)
    p1 = np.zeros((capacity, 3), np.float32)
    p2 = np.zeros((capacity, 3), np.float32)
    r1 = np.zeros(capacity, np.float32)
    r2 = np.zeros(capacity, np.float32)
    npts = np.zeros(capacity, np.int32)
    pts = np.zeros((capacity, 4, 3), np.float32)
    pnorm = np.zeros((capacity, 3), np.float32)
    elas = np.zeros(capacity, np.float32)
    fric = np.zeros(capacity, np.float32)
    col = np.ones((capacity, 4), np.float32)
    spec = np.zeros(capacity, np.float32)
    shine = np.ones(capacity, np.float32)
    movable = np.zeros(capacity, bool)
    platform_id = np.full(capacity, -1, np.int32)
    density = np.ones(capacity, np.float32)
    metalness = np.zeros(capacity, np.float32)
    damage = np.zeros(capacity, np.float32)
    light_atten = np.zeros(capacity, np.float32)
    refract_ix = np.ones(capacity, np.float32)
    destroy = np.zeros(capacity, np.int32)
    for i, c in enumerate(cobj_list[:capacity]):
        shape[i] = c.shape
        p1[i] = c.p1
        r1[i] = c.r1
        r2[i] = c.r2
        elas[i] = c.layer.elasticity
        fric[i] = c.layer.friction
        col[i] = c.layer.color
        spec[i] = c.layer.specular
        shine[i] = c.layer.shininess
        movable[i] = c.movable
        platform_id[i] = c.platform_id
        density[i] = c.layer.density
        metalness[i] = c.layer.metalness
        damage[i] = c.layer.damage
        light_atten[i] = c.layer.light_atten
        refract_ix[i] = c.layer.refract_ix
        destroy[i] = c.destroy
        if c.shape == COLL_POLYGON:
            npts[i] = len(c.pts)
            for k, p in enumerate(c.pts[:4]):
                pts[i, k] = p
            pnorm[i] = _poly_normal(c.pts)
        elif c.shape == COLL_TORUS:
            d = np.asarray(c.p2)
            l = np.linalg.norm(d)
            p2[i] = d / l if l > 0 else (0.0, 0.0, 1.0)
        else:
            p2[i] = c.p2
    cols = (shape, p1, p2, r1, r2, npts, pts, pnorm, elas, fric, movable,
            col[:, 0].copy(), col[:, 1].copy(), col[:, 2].copy(),
            col[:, 3].copy(), spec, shine, platform_id, density, metalness,
            damage, light_atten, refract_ix, destroy)
    return CobjSet(*(torch.as_tensor(a, device=device) for a in cols))

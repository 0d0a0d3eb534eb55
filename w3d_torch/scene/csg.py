"""CSG preprocessing of cobj scenes (port of `3dworld_tpu/scene/csg.py`;
pure host code).

The reference preprocesses coll objects before registration: merges
adjacent/coplanar cubes, subtracts "negative" shapes from positive cubes
(splitting into sub-cubes), and removes T-junctions (csg.cpp, flags at
csg.cpp:1-20).  Host-side, runs once at scene build.
"""

from __future__ import annotations

from dataclasses import replace

from .cobj import RawCobj, SceneParse
from ..physics.cobjs import COLL_CUBE

_EPS = 1e-6


def _cube_bounds(c: RawCobj):
    lo = tuple(min(c.p1[d], c.p2[d]) for d in range(3))
    hi = tuple(max(c.p1[d], c.p2[d]) for d in range(3))
    return lo, hi


def _try_merge(a: RawCobj, b: RawCobj):
    """Merge two cubes sharing a full face into one (merge_cubes)."""
    la, ha = _cube_bounds(a)
    lb, hb = _cube_bounds(b)
    share = [abs(la[d] - lb[d]) < _EPS and abs(ha[d] - hb[d]) < _EPS
             for d in range(3)]
    if sum(share) != 2:
        return None
    d = share.index(False)
    if abs(ha[d] - lb[d]) < _EPS or abs(hb[d] - la[d]) < _EPS:
        lo = tuple(min(la[k], lb[k]) for k in range(3))
        hi = tuple(max(ha[k], hb[k]) for k in range(3))
        return replace(a, p1=lo, p2=hi)
    return None


def merge_cubes(cobjs: list) -> list:
    """Repeatedly merge face-adjacent same-layer cubes."""
    out = list(cobjs)
    changed = True
    while changed:
        changed = False
        for i in range(len(out)):
            if out[i] is None or out[i].shape != COLL_CUBE:
                continue
            for j in range(i + 1, len(out)):
                if out[j] is None or out[j].shape != COLL_CUBE:
                    continue
                # compare layers by VALUE: the parser gives every cobj a
                # fresh layer copy, so identity would never match and
                # merging would be a silent no-op on parsed scenes
                if out[i].layer != out[j].layer:
                    continue
                m = _try_merge(out[i], out[j])
                if m is not None:
                    out[i] = m
                    out[j] = None
                    changed = True
        out = [c for c in out if c is not None]
    return out


def subtract_cube(pos: RawCobj, neg: RawCobj) -> list:
    """Subtract a negative cube from a positive cube -> up to 6 sub-cubes
    (csg subtract_cube)."""
    lp, hp = _cube_bounds(pos)
    ln, hn = _cube_bounds(neg)
    # no overlap -> unchanged
    if any(hn[d] <= lp[d] + _EPS or ln[d] >= hp[d] - _EPS for d in range(3)):
        return [pos]
    # clamp the negative region to the positive cube
    ln = tuple(max(ln[d], lp[d]) for d in range(3))
    hn = tuple(min(hn[d], hp[d]) for d in range(3))
    pieces = []

    def emit(lo, hi):
        if all(hi[d] - lo[d] > _EPS for d in range(3)):
            pieces.append(replace(pos, p1=tuple(lo), p2=tuple(hi)))

    # slab decomposition: below/above in z, then y, then x
    emit((lp[0], lp[1], lp[2]), (hp[0], hp[1], ln[2]))
    emit((lp[0], lp[1], hn[2]), (hp[0], hp[1], hp[2]))
    emit((lp[0], lp[1], ln[2]), (hp[0], ln[1], hn[2]))
    emit((lp[0], hn[1], ln[2]), (hp[0], hp[1], hn[2]))
    emit((lp[0], ln[1], ln[2]), (ln[0], hn[1], hn[2]))
    emit((hn[0], ln[1], ln[2]), (hp[0], hn[1], hn[2]))
    return pieces


def process_csg(parse: SceneParse, negative_ids: set = frozenset()) -> SceneParse:
    """Full CSG pass: subtract negative cubes from positive ones, then
    merge adjacent cubes (the reference's cobj preprocessing order)."""
    pos = [c for i, c in enumerate(parse.cobjs) if i not in negative_ids]
    neg = [c for i, c in enumerate(parse.cobjs) if i in negative_ids]
    for n in neg:
        if n.shape != COLL_CUBE:
            continue
        nxt = []
        for p in pos:
            if p.shape == COLL_CUBE:
                nxt.extend(subtract_cube(p, n))
            else:
                nxt.append(p)
        pos = nxt
    out = SceneParse(cobjs=merge_cubes(pos), skipped=dict(parse.skipped),
                     layers=list(parse.layers))
    return out


def subdiv_cubes(cobjs: list, toler: float = 1e-6) -> list:
    """Remove T-junctions within each same-layer cube group
    (coll_obj_group::subdiv_cubes, csg.cpp:1027-1092).

    The union of all face coordinates in a group forms a 3-D split grid;
    every cube is replaced by its grid cells, so any two touching cubes
    meet edge-to-edge (no hanging vertices).  Near-equal split values
    (within `toler`) collapse to one.
    """
    from collections import defaultdict

    from dataclasses import astuple

    groups = defaultdict(list)
    passthrough = []
    for c in cobjs:
        if c.shape == COLL_CUBE:
            # group by layer VALUE (parsed cobjs each carry a fresh copy)
            groups[astuple(c.layer)].append(c)
        else:
            passthrough.append(c)
    out = list(passthrough)
    for _gid, v in groups.items():
        if len(v) == 1:
            out.extend(v)
            continue
        svals = []
        for d in range(3):
            vals = sorted({_cube_bounds(c)[e][d] for c in v for e in range(2)})
            merged = [vals[0]]
            for s in vals[1:]:
                if s - merged[-1] > toler:
                    merged.append(s)
            svals.append(merged)

        def closest(val, vals):
            best = min(range(len(vals)), key=lambda i: abs(vals[i] - val))
            return best

        for c in v:
            lo, hi = _cube_bounds(c)
            b = [(closest(lo[d], svals[d]), closest(hi[d], svals[d]))
                 for d in range(3)]
            tot = 1
            for d in range(3):
                tot *= max(b[d][1] - b[d][0], 0)
            if tot <= 1:
                out.append(c)
                continue
            for x in range(b[0][0], b[0][1]):
                for y in range(b[1][0], b[1][1]):
                    for z in range(b[2][0], b[2][1]):
                        lo2 = (svals[0][x], svals[1][y], svals[2][z])
                        hi2 = (svals[0][x + 1], svals[1][y + 1], svals[2][z + 1])
                        out.append(replace(c, p1=lo2, p2=hi2))
    return out

"""Isosurface extraction by marching tetrahedra (port of
`3dworld_tpu/voxel/mc.py`).

The reference extracts isosurfaces with classic marching cubes
(marching_cubes.h:9+, voxels.h:188 add_triangles_for_voxel; the port of
that path is `voxel/mc256`).  Here each cell is decomposed into 6
tetrahedra and polygonised per tet with a 16-case table derived in code,
at most 2 triangles per tet, so the output has a fixed shape.

Output is padded [T, 2, 3(vert)] per coordinate + a validity mask;
`compact_triangles` compacts on the host.  The JAX package selects the
table rows and edge vertices with one-hot products; here they are
gathers, which pick the same values exactly.
"""

from __future__ import annotations

import numpy as np
import torch

# cube corner offsets (x, y, z)
_CORNERS = np.array([
    (0, 0, 0), (1, 0, 0), (1, 1, 0), (0, 1, 0),
    (0, 0, 1), (1, 0, 1), (1, 1, 1), (0, 1, 1),
], np.int32)

# 6-tetrahedra decomposition around the 0-6 diagonal
_TETS = np.array([
    (0, 5, 1, 6), (0, 1, 2, 6), (0, 2, 3, 6),
    (0, 3, 7, 6), (0, 7, 4, 6), (0, 4, 5, 6),
], np.int32)

# tet edges: endpoints (local tet vertex ids 0-3)
_EDGE_A = np.array([0, 0, 0, 1, 1, 2], np.int32)  # e01 e02 e03 e12 e13 e23
_EDGE_B = np.array([1, 2, 3, 2, 3, 3], np.int32)


def _build_tet_table() -> np.ndarray:
    """[16, 2, 3] triangle edge-index table, -1 = unused: for each
    inside-vertex bitmask, the crossed edges are those with exactly one
    endpoint inside; 1 or 2 inside vertices give a triangle or a quad
    (split into two triangles)."""
    table = -np.ones((16, 2, 3), np.int32)
    edges = list(zip(_EDGE_A, _EDGE_B))

    def crossed(mask):
        return [e for e, (a, b) in enumerate(edges)
                if ((mask >> a) & 1) != ((mask >> b) & 1)]

    def shares(e1, e2):
        return bool(set(edges[e1]) & set(edges[e2]))

    for mask in range(1, 15):
        ce = crossed(mask)
        if len(ce) == 3:
            table[mask, 0] = ce
            continue
        # 4 crossed edges: order them around the quad (consecutive edges
        # share a tet vertex)
        e0, rest = ce[0], ce[1:]
        e1 = next(e for e in rest if shares(e0, e))
        rest.remove(e1)
        e2 = next(e for e in rest if shares(e1, e))
        rest.remove(e2)
        table[mask, 0] = (e0, e1, e2)
        table[mask, 1] = (e0, e2, rest[0])
    return table


_TET_TABLE = _build_tet_table()          # [16,2,3]


def marching_tets(values: torch.Tensor, isolevel: float = 0.0,
                  lo_pos=(0.0, 0.0, 0.0), vsz=(1.0, 1.0, 1.0)):
    """Extract the isosurface of a [nz, ny, nx] field.

    Returns (verts_x, verts_y, verts_z, valid): verts_* [C*6, 2, 3]
    world-space triangle vertex coordinates per (cell, tet) with up to 2
    triangles of 3 vertices each; valid [C*6, 2] bool.  "Solid" is values
    < isolevel (pass -values to flip)."""
    nz, ny, nx = values.shape
    cz, cy, cx = nz - 1, ny - 1, nx - 1
    C = cz * cy * cx
    dev = values.device
    corner_vals = torch.stack([values[oz:oz + cz, oy:oy + cy, ox:ox + cx].reshape(C)
                               for (ox, oy, oz) in _CORNERS.tolist()])   # [8, C]
    ar = lambda n: torch.arange(n, dtype=torch.float32, device=dev)
    zi, yi, xi = torch.meshgrid(ar(cz), ar(cy), ar(cx), indexing="ij")
    bx = lo_pos[0] + xi.reshape(C) * vsz[0]
    by = lo_pos[1] + yi.reshape(C) * vsz[1]
    bz = lo_pos[2] + zi.reshape(C) * vsz[2]
    inside = corner_vals < isolevel                                      # [8, C]
    tet_tab = torch.as_tensor(_TET_TABLE.reshape(16, 6), device=dev).to(torch.int64)

    out_x, out_y, out_z, out_valid = [], [], [], []
    for tet in _TETS.tolist():
        case = (inside[tet[0]].to(torch.int64) + 2 * inside[tet[1]].to(torch.int64)
                + 4 * inside[tet[2]].to(torch.int64) + 8 * inside[tet[3]].to(torch.int64))
        eidx = tet_tab[case]                                             # [C, 6]
        valid = eidx[:, ::3] >= 0                                        # [C, 2]
        co = _CORNERS[tet]                                               # [4, 3]
        cp = [torch.stack([b + float(co[i, a]) * vsz[a] for i in range(4)])
              for a, b in enumerate((bx, by, bz))]                       # 3 x [4, C]
        tvs = corner_vals[tet]                                           # [4, C]
        ev = [[], [], []]
        for e in range(6):
            va, vb = tvs[_EDGE_A[e]], tvs[_EDGE_B[e]]
            t = torch.clamp((isolevel - va) / torch.where(torch.abs(vb - va) < 1e-12,
                                                          1e-12, vb - va), 0.0, 1.0)
            for a in range(3):
                pa, pb = cp[a][_EDGE_A[e]], cp[a][_EDGE_B[e]]
                ev[a].append(pa + t * (pb - pa))
        sel = torch.clamp(eidx, 0, 5)                                    # [C, 6]
        for a, out in enumerate((out_x, out_y, out_z)):
            evs = torch.stack(ev[a], 1)                                  # [C, 6]
            out.append(evs.gather(1, sel).reshape(C, 2, 3))
        out_valid.append(valid)
    return (torch.cat(out_x), torch.cat(out_y), torch.cat(out_z),
            torch.cat(out_valid))


def compact_triangles(vx, vy, vz, valid) -> np.ndarray:
    """Host-side compaction to a dense [T, 3, 3] float32 triangle array."""
    vx, vy, vz, valid = (a.cpu().numpy() for a in (vx, vy, vz, valid))
    tris = np.stack([vx.reshape(-1, 3), vy.reshape(-1, 3), vz.reshape(-1, 3)],
                    axis=-1)  # [N, 3verts, 3xyz]
    return tris[valid.reshape(-1)]


def triangle_count(valid) -> int:
    return int(valid.sum())


def marching_tets_lod(values: torch.Tensor, isolevel=0.0,
                      lo_pos=(0.0, 0.0, 0.0), vsz=(1.0, 1.0, 1.0),
                      levels: int = 3):
    """LOD triangle lists (voxels.h:188 per-block LOD tri lists): level k
    extracts the isosurface from the field subsampled by stride 2^k.
    Returns a list of (vx, vy, vz, valid) per level (level 0 = full res)."""
    out = []
    for k in range(levels):
        st = 1 << k
        sub = values[::st, ::st, ::st]
        if min(sub.shape) < 2:
            break
        svsz = (vsz[0] * st, vsz[1] * st, vsz[2] * st)
        out.append(marching_tets(sub, isolevel, lo_pos=lo_pos, vsz=svsz))
    return out


def lod_triangle_counts(lods) -> list:
    """Triangle count per LOD level (coarser levels must not exceed finer
    ones for well-formed fields)."""
    return [int(valid.sum()) for (_x, _y, _z, valid) in lods]

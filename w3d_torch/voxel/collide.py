"""Voxel collision: direct field tests and per-block surface cobjs (port of
`3dworld_tpu/voxel/collide.py`).

The reference's voxel_model keeps per-block collision objects rebuilt for
dirty blocks after edits (voxels.cpp `update_voxel_sphere_region` ->
per-block `add_cobjs`/BVH rebuild).  Here, as in the JAX package:

* the fast path collides spheres directly against the density field — a
  trilinear sample and a central-difference gradient give penetration
  depth and normal without triangles;
* the export path extracts each block's isosurface triangles into polygon
  cobjs, rebuilt only for the blocks an edit touched.  The JAX package
  extracts block by block; `VoxelCollider.rebuild` here extracts the
  dirty blocks in batched marching-cubes passes (`mc256.cell_triangles`),
  each block in its own cell units, so every block's triangles are those
  of the one-block extraction.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from ..ops.fmath import div32, sqrt32
from . import mc as MC
from . import mc256 as M256
from . import grid as VG


def sphere_vs_field(values, origin, spacing, isolevel, px, py, pz, rad):
    """Collide [N] spheres against the voxel density field.

    values [nz, ny, nx] (solid where value < isolevel); returns (hit [N],
    pen [N], nx, ny, nz) with the normal along +gradient (toward air).
    Penetration is the field value over the local gradient magnitude
    (first-order distance) subtracted from the radius."""
    nz, ny, nx = values.shape
    gx = div32(px - origin[0], spacing)
    gy = div32(py - origin[1], spacing)
    gz = div32(pz - origin[2], spacing)

    def tri_sample(v, gx, gy, gz):
        x0 = torch.clamp(torch.floor(gx).to(torch.int64), 0, nx - 2)
        y0 = torch.clamp(torch.floor(gy).to(torch.int64), 0, ny - 2)
        z0 = torch.clamp(torch.floor(gz).to(torch.int64), 0, nz - 2)
        fx = torch.clamp(gx - x0.to(torch.float32), 0.0, 1.0)
        fy = torch.clamp(gy - y0.to(torch.float32), 0.0, 1.0)
        fz = torch.clamp(gz - z0.to(torch.float32), 0.0, 1.0)

        def at(dx, dy, dz):
            return v[z0 + dz, y0 + dy, x0 + dx]
        c000, c100 = at(0, 0, 0), at(1, 0, 0)
        c010, c110 = at(0, 1, 0), at(1, 1, 0)
        c001, c101 = at(0, 0, 1), at(1, 0, 1)
        c011, c111 = at(0, 1, 1), at(1, 1, 1)
        lo = (c000 * (1 - fx) + c100 * fx) * (1 - fy) \
            + (c010 * (1 - fx) + c110 * fx) * fy
        hi = (c001 * (1 - fx) + c101 * fx) * (1 - fy) \
            + (c011 * (1 - fx) + c111 * fx) * fy
        return lo * (1 - fz) + hi * fz

    val = tri_sample(values, gx, gy, gz)
    h = 0.5
    dvx = tri_sample(values, gx + h, gy, gz) - tri_sample(values, gx - h, gy, gz)
    dvy = tri_sample(values, gx, gy + h, gz) - tri_sample(values, gx, gy - h, gz)
    dvz = tri_sample(values, gx, gy, gz + h) - tri_sample(values, gx, gy, gz - h)
    gmag = div32(sqrt32(dvx * dvx + dvy * dvy + dvz * dvz), spacing)
    gmag = torch.clamp(gmag, min=1e-6)
    sdf = (val - isolevel) / gmag          # approx signed distance (air > 0)
    pen = rad - sdf
    inv = 1.0 / torch.clamp(sqrt32(dvx * dvx + dvy * dvy + dvz * dvz), min=1e-12)
    return pen > 0.0, pen, dvx * inv, dvy * inv, dvz * inv


@dataclass
class VoxelCollider:
    """Per-block isosurface triangle store with dirty-block rebuilds.

    Mirrors the reference's block-partitioned voxel cobjs: each edit marks
    the blocks it touches; only those re-extract triangles.  `tris` maps
    (bx, by) to a host float32 [T, 3, 3] array in world units."""

    params: VG.VoxelParams
    spacing: float = 1.0
    origin: tuple = (0.0, 0.0, 0.0)
    block: int = 8                     # cells per block edge (xy)
    max_tris_per_block: int = 4096
    tris: dict = field(default_factory=dict)     # (bx, by) -> [T, 3, 3]
    # "mc": true 256-case marching cubes (voxel.mc256, the reference's
    # topology, marching_cubes.h:9); "tets": marching-tetrahedra fallback
    method: str = "mc"
    device: torch.device | str = "cuda"

    def _block_field(self, values, bx: int, by: int):
        b = self.block
        return values[:, by * b:(by + 1) * b + 1, bx * b:(bx + 1) * b + 1]

    def _to_world(self, t: np.ndarray, bx: int, by: int) -> np.ndarray:
        b, sp = self.block, self.spacing
        ox, oy, oz = self.origin
        out = np.empty_like(t)
        out[..., 0] = (t[..., 0] + bx * b) * sp + ox
        out[..., 1] = (t[..., 1] + by * b) * sp + oy
        out[..., 2] = t[..., 2] * sp + oz
        return out

    def _extract_tets(self, values, bx: int, by: int) -> np.ndarray:
        vx, vy, vz, valid = MC.marching_tets(self._block_field(values, bx, by),
                                             self.params.isolevel)
        t = torch.stack([vx, vy, vz], -1)[valid][:self.max_tris_per_block]
        return self._to_world(t.cpu().numpy(), bx, by)

    def rebuild(self, values, dirty=None):
        """Extract triangles for dirty blocks (None = all).  `dirty` is an
        iterable of (bx, by) block coords."""
        values = torch.as_tensor(values, device=self.device)
        _nz, ny, nx = values.shape
        nbx = (nx - 1) // self.block
        nby = (ny - 1) // self.block
        if dirty is None:
            dirty = [(bx, by) for by in range(nby) for bx in range(nbx)]
        dirty = list(dirty)
        if self.method != "mc":
            for (bx, by) in dirty:
                self.tris[(bx, by)] = self._extract_tets(values, bx, by)
            return self
        step = M256.blocks_per_pass(self.block * self.block * (values.shape[0] - 1))
        for k in range(0, len(dirty), step):
            part = dirty[k:k + step]
            subs = torch.stack([self._block_field(values, bx, by).permute(2, 1, 0)
                                for (bx, by) in part])
            pos, tvalid, _ = M256.cell_triangles(subs, self.params.isolevel)
            counts = tvalid.sum((1, 2)).tolist()
            flat = pos[tvalid].cpu().numpy()
            start = 0
            for (bx, by), n in zip(part, counts):
                t = flat[start:start + min(n, self.max_tris_per_block)]
                start += n
                self.tris[(bx, by)] = self._to_world(t, bx, by)
        return self

    def dirty_blocks_for_edit(self, cx, cy, radius):
        """Blocks intersecting an edit sphere (update_voxel_sphere_region's
        region->block mapping)."""
        sp = self.spacing
        ox, oy, _oz = self.origin
        b = self.block * sp
        lo_x = int((cx - radius - ox) // b)
        hi_x = int((cx + radius - ox) // b)
        lo_y = int((cy - radius - oy) // b)
        hi_y = int((cy + radius - oy) // b)
        return [(bx, by) for by in range(max(lo_y, 0), hi_y + 1)
                for bx in range(max(lo_x, 0), hi_x + 1)
                if (bx, by) in self.tris or not self.tris]

    def to_cobjs(self):
        """All blocks' triangles as thin polygon cobjs (SceneParse)."""
        from ..scene import cobj as SC
        sp = SC.SceneParse()
        lay = SC.CobjLayer(elasticity=0.2, color=(0.55, 0.5, 0.45, 1.0))
        thick = 0.5 * self.spacing
        for t in self.tris.values():
            for tri in t:
                pts = tuple(tuple(float(c) for c in p) for p in tri)
                sp.cobjs.append(SC.RawCobj(SC.COLL_POLYGON, pts[0], r1=thick,
                                           pts=pts, layer=lay))
        return sp

    @property
    def num_tris(self):
        return sum(len(t) for t in self.tris.values())

"""Spray paint tool (port of `3dworld_tpu/gameplay/spray.py`;
spray_paint.cpp).

The reference sprays color decals along the camera view ray onto the
mesh / flat cobjs.  Here, as in the JAX package: cast the view ray with
the exact cell-walking mesh intersect and the cobj ray, and record the
splat as a decal in the decal pool, plus a paint stamp on a per-scene
paint grid for a mesh hit.  One host read decides whether and where the
ray hit.
"""

from __future__ import annotations

import torch

from ..utils.constants import WorldConst, DEFAULT_WORLD
from ..ops.ray import ray_heightfield_dda, ray_cobjs_nearest
from ..physics import particles as PT

PAINT_COLORS = (
    (1.0, 0.0, 0.0), (0.0, 0.6, 0.0), (0.1, 0.3, 1.0), (1.0, 1.0, 0.0),
    (1.0, 0.5, 0.0), (0.6, 0.0, 0.8), (1.0, 1.0, 1.0), (0.1, 0.1, 0.1),
)


def make_paint_grid(world: WorldConst = DEFAULT_WORLD,
                    device: torch.device | str = "cuda") -> torch.Tensor:
    """[my, mx, 4] RGBA paint overlay (alpha 0 = unpainted)."""
    return torch.zeros((world.mesh_y, world.mesh_x, 4), dtype=torch.float32,
                       device=device)


def spray_paint(paint_grid, decals, mesh, cobjs, cam_pos, view_dir,
                color_ix: int = 0, radius: float = 0.06,
                world: WorldConst = DEFAULT_WORLD, max_range: float = 8.0):
    """One spray: returns (paint_grid, decals, hit: bool).  Mesh hits stamp
    the paint grid and spawn a decal; cobj hits spawn a decal on the
    surface with its contact normal and the cobj's index."""
    dev = mesh.device
    o = torch.as_tensor(cam_pos, dtype=torch.float32, device=dev)
    d = torch.as_tensor(view_dir, dtype=torch.float32, device=dev)
    d = d / torch.clamp(torch.linalg.norm(d), min=1e-9)
    one = lambda v: torch.as_tensor(v, dtype=torch.float32, device=dev).reshape(1)
    tmax = one(max_range)
    ray = (one(o[0]), one(o[1]), one(o[2]), one(d[0]), one(d[1]), one(d[2]), tmax)
    mhit, mt = ray_heightfield_dda(*ray, mesh, world, max_cells=128)
    chit, ct, cnx, cny, cnz, cidx = ray_cobjs_nearest(*ray, cobjs)
    use_mesh = mhit & (~chit | (mt < ct))
    t = torch.where(use_mesh, mt, ct)
    p = o + t * d
    hit, use_mesh, p_h, n_h, cid = (
        bool((mhit | chit)[0]), bool(use_mesh[0]), p.cpu(),
        torch.stack([cnx[0], cny[0], cnz[0]]).cpu(), int(cidx[0]))
    if not hit:
        return paint_grid, decals, False
    r, g, b = PAINT_COLORS[color_ix % len(PAINT_COLORS)]
    if use_mesh:
        my, mx = mesh.shape
        gx = min(max(int((p[0] * world.dx_inv + mx // 2).to(torch.int32)), 0), mx - 1)
        gy = min(max(int((p[1] * world.dy_inv + my // 2).to(torch.int32)), 0), my - 1)
        paint_grid = paint_grid.clone()
        paint_grid[gy, gx] = torch.tensor([r, g, b, 1.0], dtype=torch.float32, device=dev)
        nx, ny, nz = 0.0, 0.0, 1.0
        cid = -1
    else:
        nx, ny, nz = (float(v) for v in n_h)
    i32 = lambda v: torch.tensor([v], dtype=torch.int32, device=dev)
    decals = PT.spawn_decals(
        decals, one(float(p_h[0])), one(float(p_h[1])), one(float(p_h[2])),
        one(nx), one(ny), one(nz), one(radius), one(1.0), i32(cid), i32(100000))
    return paint_grid, decals, True

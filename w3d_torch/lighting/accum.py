"""Platform (cobj-accum) and dynamic-group lighting volumes (port of
`3dworld_tpu/lighting/accum.py`).

LIGHTING_COBJ_ACCUM (ray_trace.cpp:829-885,1030-1070): sky rays whose
paths cross a *platform* cobj's bounds are recorded at bake time; when the
platform moves, only the rays whose blocked status changed re-cast, with
negated weight for newly blocked rays — an incremental delta of the light
volume instead of a full re-trace.

LIGHTING_DYNAMIC (lightmap.cpp:430-500 light_volume_local /
indir_dlight_group_manager_t): named dlight groups each own a local
indirect volume; its intensity scales by the enabled/total light ratio.

A delta re-traces the full recorded ray set (unchanged rays at weight 0)
with draws from the recorded seed, and a batch's deposit is a fixed-order
sum added once (`trace.trace_batch`), so the delta of a move B->A is the
exact negation of the delta of A->B: from an empty volume the two cancel
to exactly zero.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import NamedTuple

import torch

from ..utils.constants import WorldConst, DEFAULT_WORLD
from . import lmap as L
from . import trace as TR


class AccumRays(NamedTuple):
    """Recorded sky-ray set for one platform cobj (merged_accum_map)."""

    ox: torch.Tensor
    oy: torch.Tensor
    oz: torch.Tensor
    dx: torch.Tensor
    dy: torch.Tensor
    dz: torch.Tensor
    w: torch.Tensor
    cr: torch.Tensor
    cg: torch.Tensor
    cb: torch.Tensor
    seed: int


def segment_hits_cube(ox, oy, oz, dx, dy, dz, t_len, lo, hi):
    """check_line_clip: [N] segment vs one AABB -> [N] bool (slab test)."""
    t0 = torch.zeros_like(ox)
    t1 = torch.full_like(ox, t_len)
    for o, d, a, b in ((ox, dx, lo[0], hi[0]), (oy, dy, lo[1], hi[1]),
                       (oz, dz, lo[2], hi[2])):
        dinv = 1.0 / torch.where(torch.abs(d) < 1e-12, 1e-12, d)
        ta = (a - o) * dinv
        tb = (b - o) * dinv
        t0 = torch.maximum(t0, torch.minimum(ta, tb))
        t1 = torch.minimum(t1, torch.maximum(ta, tb))
    return t0 <= t1


def _box(v, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.float32, device=like.device)


def record_platform_rays(draws: TR.TraceDraws, n: int, cobj_lo, cobj_hi,
                         world: WorldConst = DEFAULT_WORLD,
                         line_length: float = 32.0,
                         sky_color=(0.7, 0.8, 1.0), seed: int = 0) -> AccumRays:
    """Bake step: generate the sky-ray population from `draws` and keep
    those whose unblocked path crosses the platform cobj's bounds (the
    rays the platform can affect), compacted on the host.

    Per-ray weight is 1.0, the weight `compute_sky_lighting` bakes with,
    so a delta re-cast cancels exactly what the bake deposited.  `seed`
    keys every future delta re-cast of this ray set."""
    rays = TR.sky_rays(draws, n, world, sky_color=sky_color, ray_weight=float(n))
    ox = rays[0]
    hit = segment_hits_cube(*rays[:6], line_length, _box(cobj_lo, ox), _box(cobj_hi, ox))
    return AccumRays(*(a[hit] for a in rays), seed=seed)


def update_platform_lighting(grid: L.LightGrid, rays: AccumRays, cobjs, mesh,
                             prev_lo, prev_hi, cur_lo, cur_hi,
                             params: TR.TraceParams = TR.TraceParams(),
                             world: WorldConst = DEFAULT_WORLD,
                             draws: TR.DrawSource | None = None) -> L.LightGrid:
    """Incremental delta update after a platform move
    (trace_ray_block_cobj_accum_single_update, ray_trace.cpp:850-885).

    Rays blocked in both or neither position are skipped (weight 0);
    newly blocked rays re-cast with negated weight, newly unblocked with
    positive weight.  `cobjs` should hold the scene WITHOUT the platform
    cobj.  The batch traces the full recorded ray set with the draws of
    the recorded seed's stream (`draws(rays.seed)`), never a caller's, so
    moving a platform away and back subtracts exactly what was added."""
    draws = draws or TR.DrawSource(rays.ox.device)
    LL = params.line_length
    seg = (rays.ox, rays.oy, rays.oz, rays.dx, rays.dy, rays.dz, LL)
    cur = segment_hits_cube(*seg, _box(cur_lo, rays.ox), _box(cur_hi, rays.ox))
    prev = segment_hits_cube(*seg, _box(prev_lo, rays.ox), _box(prev_hi, rays.ox))
    sign = torch.where(cur, -1.0, 1.0)          # newly blocked -> subtract
    w = rays.w * sign * (cur != prev).to(torch.float32)
    return TR.trace_batch(grid, cobjs, mesh, rays.ox, rays.oy, rays.oz,
                          rays.dx, rays.dy, rays.dz, w, rays.cr, rays.cg, rays.cb,
                          draws(rays.seed), ltype=L.LIGHTING_SKY, params=params,
                          world=world)


# ---------------------------------------------------------------------------
# dynamic dlight-group volumes
# ---------------------------------------------------------------------------

@dataclass
class DlightGroup:
    """indir_dlight_group_manager_t group: named set of dlights sharing one
    local indirect volume (lightmap.cpp:452-500)."""

    name: str
    scale: float = 1.0
    dlight_ixs: list = field(default_factory=list)
    is_dynamic: bool = False
    base: L.LightGrid | None = None    # traced at full enablement


@dataclass
class DlightGroupManager:
    groups: dict = field(default_factory=dict)

    def get_group(self, name: str, scale: float = 1.0) -> DlightGroup:
        if name in ("", "none", "null"):
            name = "__none__"
        g = self.groups.get(name)
        if g is None:
            g = DlightGroup(name=name, scale=scale)
            self.groups[name] = g
        elif g.scale != scale:
            g.scale = scale                # reference warns; last wins
        return g

    def add_dlight(self, name: str, dlight_ix: int, scale: float = 1.0,
                   is_dynamic: bool = False):
        g = self.get_group(name, scale)
        g.dlight_ixs.append(dlight_ix)
        g.is_dynamic |= is_dynamic

    def gen_group_volume(self, g: DlightGroup, cobjs, mesh, lights,
                         rays_per_light: int, world: WorldConst,
                         seed: int = 0, params: TR.TraceParams = TR.TraceParams(),
                         draws: TR.DrawSource | None = None):
        """Trace the group's lights into a fresh LOCAL volume on the mesh's
        device (light_volume_local::gen_data); light k's rays and trace
        take the draws of stream seed * 1000 + 31 k + 7."""
        draws = draws or TR.DrawSource(mesh.device)
        grid = L.make_light_grid(world, device=mesh.device)
        for k, ix in enumerate(g.dlight_ixs):
            d = draws(seed * 1000 + 31 * k + 7)
            pos, color = lights[ix]
            rays = TR.local_rays(d, rays_per_light, pos, color, world)
            grid = TR.trace_batch(grid, cobjs, mesh, *rays, d, ltype=L.LIGHTING_LOCAL,
                                  params=params, world=world)
        g.base = grid
        return grid

    def group_scale(self, g: DlightGroup, enabled_mask) -> float:
        """scale * enabled/total (lightmap.cpp:494)."""
        if not g.dlight_ixs:
            return 0.0
        en = sum(1 for ix in g.dlight_ixs if enabled_mask[ix])
        return g.scale * en / len(g.dlight_ixs)

    def scaled_volume(self, g: DlightGroup, enabled_mask):
        """The group's contribution at the current enable state — a pure
        rescale of the baked volume (no re-trace unless is_dynamic)."""
        s = self.group_scale(g, enabled_mask)
        b = g.base
        return b._replace(lc_r=b.lc_r * s, lc_g=b.lc_g * s, lc_b=b.lc_b * s)

"""Building indirect lighting manager (port of
`3dworld_tpu/lighting/building_indir.py`).

building_indir_light_mgr_t (building_lighting.cpp:837-1110): one room
light is traced at a time on a background thread fed by a job queue; each
light's rays accumulate into the building-local light map, merged
incrementally so gameplay sees lighting appear light by light; toggling or
moving a light invalidates and re-enqueues it.

Here the "background thread" is the asynchronous device: each
`process_one` call launches one light's batched trace (lighting/trace)
into that light's own cached volume; `composite` sums the enabled lights'
volumes (linear, so per-light caching gives exact incremental updates and
instant enable/disable).
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field

import torch

from ..utils.constants import WorldConst, DEFAULT_WORLD
from . import lmap as L
from . import trace as TR


def building_local_setup(interior, bbox, res: int = 32,
                         device: torch.device | str = "cuda"):
    """Building-local lighting volume setup (building_lighting.cpp:837-1110):
    a WorldConst sized to the building bbox (so the tracer's world->cell
    mapping spans just this building), the offset that recenters the
    building at the origin, and the building's own occluder set (interior
    wall segments — door cutouts already split the walls, so light leaks
    room to room only through doorways — plus per-floor slabs and an
    exterior shell).

    Returns (world_local, offset, cobjs, mesh) on `device`, ready for
    BuildingIndirManager(world=world_local) with light positions
    translated by -offset."""
    from ..scene import cobj as SC

    x1, y1, z1, x2, y2, z2 = bbox
    cx, cy, cz = 0.5 * (x1 + x2), 0.5 * (y1 + y2), 0.5 * (z1 + z2)
    hx, hy, hz = 0.5 * (x2 - x1), 0.5 * (y2 - y1), 0.5 * (z2 - z1)
    nz = max(res // 2, 4)
    lw = WorldConst(mesh_x=res, mesh_y=res, mesh_z=nz,
                    x_scene=1.1 * hx + 1e-3, y_scene=1.1 * hy + 1e-3,
                    z_scene=1.1 * hz + 1e-3)
    off = (cx, cy, cz)

    sp = SC.SceneParse()
    lay = SC.CobjLayer(color=(0.7, 0.7, 0.7, 1.0))

    def add_cube(a1, b1, c1, a2, b2, c2):
        sp.cobjs.append(SC.RawCobj(SC.COLL_CUBE, (a1 - cx, b1 - cy, c1 - cz),
                                   (a2 - cx, b2 - cy, c2 - cz), layer=lay))

    for (wx1, wy1, wz1, wx2, wy2, wz2) in interior.walls:
        add_cube(wx1, wy1, wz1, wx2, wy2, wz2)
    fh = interior.floor_height
    th = 0.02 * fh
    for f in range(interior.num_floors + 1):
        zf = interior.z1 + f * fh
        add_cube(x1, y1, zf - th, x2, y2, zf)      # floor/ceiling slabs
    # exterior shell so rays bounce indoors instead of escaping
    add_cube(x1 - th, y1, z1, x1, y2, z2)
    add_cube(x2, y1, z1, x2 + th, y2, z2)
    add_cube(x1, y1 - th, z1, x2, y1, z2)
    add_cube(x1, y2, z1, x2, y2 + th, z2)
    cobjs = SC.pack_cobjs(sp, device=device)
    mesh = torch.full((lw.mesh_y, lw.mesh_x), -10.0 * lw.z_scene, dtype=torch.float32,
                      device=device)
    return lw, off, cobjs, mesh


@dataclass
class BuildingIndirManager:
    """Queue-driven per-room-light indirect volumes on `device`.  Light
    `ix`'s slice that starts after `done` of its rays takes the draws of
    stream seed * 7919 + ix * 131 + done (`draws`, default generators on
    `device`)."""

    world: WorldConst = DEFAULT_WORLD
    rays_per_light: int = 1024
    slice_rays: int = 0        # rays per process_one call (0 = all at
    # once).  With a slice budget, a light's volume builds up
    # incrementally across calls — the reference's background thread
    # merges partial ray blocks the same way (building_lighting.cpp:1040)
    params: TR.TraceParams = TR.TraceParams(max_bounces=3, samples_per_segment=8,
                                            mesh_steps=8)
    lights: dict = field(default_factory=dict)    # ix -> (pos, color)
    enabled: dict = field(default_factory=dict)   # ix -> bool
    volumes: dict = field(default_factory=dict)   # ix -> LightGrid
    remaining: dict = field(default_factory=dict)  # ix -> rays left
    queue: deque = field(default_factory=deque)
    device: torch.device | str = "cuda"
    draws: TR.DrawSource | None = None
    cobjs: object = None        # the building's own geometry (for_building)
    mesh: object = None
    offset: tuple = (0.0, 0.0, 0.0)

    def register_light(self, ix: int, pos, color, enabled: bool = True):
        """Add/replace a room light; a changed light drops its cached
        volume and re-enqueues (the reference's invalidation path)."""
        changed = ix in self.lights and self.lights[ix] != (tuple(pos), tuple(color))
        self.lights[ix] = (tuple(pos), tuple(color))
        self.enabled[ix] = enabled
        if changed or ix not in self.volumes:
            self.volumes.pop(ix, None)
            self.remaining[ix] = self.rays_per_light
            self.enqueue(ix)

    def enqueue(self, ix: int):
        if ix not in self.queue:
            self.queue.append(ix)

    def prioritize(self, ix: int):
        """Front-queue one light — the reference traces the player's
        CURRENT room light before the backlog (building_lighting.cpp:900+)."""
        if ix in self.queue:
            self.queue.remove(ix)
        self.queue.appendleft(ix)

    def set_enabled(self, ix: int, enabled: bool):
        """Toggling costs nothing — the cached volume joins/leaves the
        composite."""
        self.enabled[ix] = enabled

    @property
    def pending(self) -> int:
        return len(self.queue)

    def process_one(self, cobjs, mesh, seed: int = 0) -> int | None:
        """Trace the next queued light's next ray slice, ACCUMULATING into
        its cached volume; a light with budget left re-enqueues so big
        bakes interleave.  Returns the light ix processed (None if idle)."""
        while self.queue:
            ix = self.queue.popleft()
            if ix in self.lights and self.remaining.get(ix, self.rays_per_light) > 0:
                break        # skip stale/exhausted entries (prioritize()
        else:                # on a finished light must not zero-trace)
            return None
        pos, color = self.lights[ix]
        left = self.remaining.get(ix, self.rays_per_light)
        n = min(self.slice_rays, left) if self.slice_rays else left
        done_so_far = self.rays_per_light - left
        draws = self.draws or TR.DrawSource(self.device)
        d = draws(seed * 7919 + ix * 131 + done_so_far)
        # every ray carries weight 1/rays_per_light exactly like the
        # single-shot bake, so the slices sum to the full bake in expectation
        rays = TR.local_rays(d, n, pos, color, self.world,
                             ray_weight=float(n) / self.rays_per_light)
        grid = self.volumes.get(ix)
        if grid is None:
            grid = L.make_light_grid(self.world, device=self.device)
        self.volumes[ix] = TR.trace_batch(grid, cobjs, mesh, *rays, d,
                                          ltype=L.LIGHTING_LOCAL, params=self.params,
                                          world=self.world)
        self.remaining[ix] = left - n
        if self.remaining[ix] > 0:
            self.enqueue(ix)
        return ix

    @classmethod
    def for_building(cls, interior, bbox, res: int = 32, rays_per_light: int = 2048,
                     device: torch.device | str = "cuda"):
        """Manager over a building-local volume with the interior's own
        ceiling lights registered (positions recentred)."""
        lw, off, cobjs, mesh = building_local_setup(interior, bbox, res, device=device)
        mgr = cls(world=lw, rays_per_light=rays_per_light, device=device,
                  cobjs=cobjs, mesh=mesh, offset=off)
        for ix, (lx, ly, lz, _fl) in enumerate(getattr(interior, "lights", ()) or ()):
            mgr.register_light(ix, (lx - off[0], ly - off[1], lz - off[2]),
                               (1.0, 0.95, 0.8))
        return mgr

    def process_all(self, seed: int = 0) -> int:
        """Drain the queue against the building's own geometry."""
        n = 0
        while self.pending:
            self.process_one(self.cobjs, self.mesh, seed=seed + n)
            n += 1
        return n

    def composite(self) -> L.LightGrid:
        """Sum of all enabled lights' cached volumes."""
        out = L.make_light_grid(self.world, device=self.device)
        lr, lg, lb = out.lc_r, out.lc_g, out.lc_b
        for ix, vol in self.volumes.items():
            if self.enabled.get(ix, False):
                lr = lr + vol.lc_r
                lg = lg + vol.lc_g
                lb = lb + vol.lc_b
        return out._replace(lc_r=lr, lc_g=lg, lc_b=lb)

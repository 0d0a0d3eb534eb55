"""The scene's lighting bake, a block of rays at a time (3DWorld's
`compute_ray_trace_lighting`, ray_trace.cpp:1032).

A scene config's `num_light_rays npts nrays local [global [dynamic]]` is
the bake's budget.  3DWorld traces it at load on every CPU thread, each
thread into a temporary lmap that is merged when all are done
(`thread_manager_t`, ray_trace.cpp:516-618; `update_lmap_from_temp_copy`).
`LightBake` plans the same budget as the batches of `trace`'s
`compute_*_lighting`, in the reference's order:

- sky: npts x nrays rays, each a dome point aimed at a scene point
  (`trace.sky_batches`); the port draws a dome point per ray where the
  reference shares npts points over nrays directions;
- global: the `global` count of rays from the sun (`trace.global_batches`),
  placed by the config's `sun_rot` (`sun_direction`); the moon is not
  traced;
- local: the scene's lights (`SceneParse.lights`) as
  `trace.compute_scene_lighting` traces them (`trace.scene_light_batches`:
  point, line, spot and cube lights, the weight 1000 x alpha x radius / N,
  a light's own `num_dlight_rays`, ambient lights skipped); the `local`
  count is shared evenly over the lights that set none, and with no
  lights nothing is traced.  The 'b' cube volumes (`.cube_lights`), which
  light the sky and global channels in 3DWorld, are not traced;
- dynamic: parsed, not traced (the reference bakes it per dynamic light
  group; `lighting/dlights` builds those volumes).

`step()` traces the next block (batches of at most `batch_rays` rays, up
to `block_rays` rays a block) into a private grid, the temporary lmap, and
returns it; after the last block the private grid's lit channels replace
the scene grid's (`grid`).  Each batch draws from the streams of its
`compute_*_lighting` (`trace.RayBatch`), so a whole sky bake equals
`trace.compute_sky_lighting(num_rays=npts * nrays, batch=batch_rays)` bit
for bit, and a local part whose lights each fit a batch equals
`trace.compute_scene_lighting`.

`counts` holds host integers, read without the device: `blocks`,
`batches`, `rays`, and from the static compaction schedule
(`trace.bounce_slots`) `deposit_rays` (slots summed over bounces) and
`deposit_samples` (slots x samples a segment).  `step()` runs inside the
host span `light.block`.  Reading and writing `lighting_file_*` is not
done here.
"""

from __future__ import annotations

import math
import time

import torch

from ..utils.constants import WorldConst, DEFAULT_WORLD
from ..utils.profiler import span
from . import lmap as L
from . import trace as T

# the production parameters of the bakes on the card (compaction, 8
# samples a segment at bounce 0 and 4 after it, 8 bounces)
PRODUCTION = T.TraceParams(compact=True, samples_per_segment=8, samples_later=4)
SUN_DIR = (-0.4, -0.3, -0.8)    # from the sun toward the scene: the port's default sun
ACCUM_FIELDS = ("sc_r", "sc_g", "sc_b", "sv", "gc_r", "gc_g", "gc_b",
                "gv", "lc_r", "lc_g", "lc_b")
COUNTS = ("blocks", "batches", "rays", "deposit_rays", "deposit_samples")


def sun_direction(sun_rot: float | None) -> tuple:
    """The direction from the sun toward the scene for a config's
    `sun_rot`: the sun at the zenith turned `sun_rot` radians about the
    axis (-1, 0, 0), as `update_sun_and_moon` (shadows.cpp:21-31) places
    it; the port's default sun (`SUN_DIR`) where the config sets none."""
    if sun_rot is None:
        return SUN_DIR
    return (0.0, -math.sin(sun_rot), -math.cos(sun_rot))


class LightBake:
    """The bake of `num_light_rays` over a scene: `cobjs`, the heightfield
    `mesh` and `world`, into `grid` (the scene's light grid), with the sun
    at `sun_rot` and the scene-DSL `lights`.  `draws` makes each batch's
    draws (a `trace.DrawSource`, by default generators on the grid's
    device)."""

    def __init__(self, grid: L.LightGrid, cobjs, mesh: torch.Tensor, num_light_rays,
                 world: WorldConst = DEFAULT_WORLD, sun_rot: float | None = None,
                 lights=(), seed: int = 0, params: T.TraceParams = PRODUCTION,
                 block_rays: int = 1_000_000, batch_rays: int = 125_000,
                 draws: T.DrawSource | None = None):
        self.grid = grid
        self.cobjs, self.mesh, self.world = cobjs, mesh, world
        self.seed = int(seed)
        self.draws = draws or T.DrawSource(grid.sv.device)
        self.params = T.gated_params(params, cobjs)     # reads the scene once
        npts, nrays, local, glob = (tuple(int(v) for v in num_light_rays) + (0,) * 4)[:4]
        traced = [s for s in lights if s.kind != "ambient"]
        shared = sum(1 for s in traced if not s.num_dlight_rays)
        self.plan = (T.sky_batches(npts * nrays, batch_rays, world)
                     + T.global_batches(glob, batch_rays, sun_direction(sun_rot), world)
                     + (T.scene_light_batches(lights, local // max(shared, 1), world, batch_rays)
                        if local else []))
        self.blocks = []
        for b in self.plan:
            if not self.blocks or sum(x.n for x in self.blocks[-1]) + b.n > block_rays:
                self.blocks.append([])
            self.blocks[-1].append(b)
        self.next = 0
        self.work = grid._replace(**{f: torch.zeros_like(getattr(grid, f))
                                     for f in ACCUM_FIELDS})
        self.counts = dict.fromkeys(COUNTS, 0)
        self.seconds = 0.0

    @property
    def done(self) -> bool:
        return self.next >= len(self.blocks)

    def step(self) -> L.LightGrid:
        """Trace the next block into the private grid and return it; after
        the last, the scene's grid takes its lit channels."""
        with span("light.block"):
            block = self.blocks[self.next]
            self.work = T.trace_batches(self.work, self.cobjs, self.mesh, block, self.seed,
                                        self.params, self.world, draws=self.draws)
            for b in block:
                self._count(b)
            self.next += 1
            self.counts["blocks"] += 1
            if self.done:
                self.grid = self.grid._replace(**{f: getattr(self.work, f)
                                                  for f in ACCUM_FIELDS})
        return self.work

    def run(self) -> L.LightGrid:
        """Every block left, then the host read of the sky-weight total;
        adds the time to `seconds` and returns the scene's finished grid."""
        t0 = time.perf_counter()
        while not self.done:
            self.step()
        float(self.work.sv.sum())
        self.seconds += time.perf_counter() - t0
        return self.grid

    def _count(self, b: T.RayBatch) -> None:
        params = self.params[b.ltype]
        slots = T.bounce_slots(b.n, params)
        segs = 2 if params.transmission else 1
        c = self.counts
        c["batches"] += 1
        c["rays"] += b.n
        c["deposit_rays"] += segs * sum(slots)
        c["deposit_samples"] += segs * sum(n * T.segment_samples(k, params)
                                           for k, n in enumerate(slots))

"""Exact pair collisions across ranks (port of
`3dworld_tpu/parallel/pairs.py`): x-slab domain decomposition with a
`window`-rank halo.

The single-device frame sorts the whole population on x once a frame;
every contact then lies within PAIR_WINDOW ranks of the sorted order.
That bound is the halo a domain decomposition needs: split the sorted
order into contiguous slabs, one a rank, and every pair across ranks
straddles one slab edge by fewer than `window` ranks.

Per substep with pairs, on each rank:

  1. the first `window` rows of the slab (10 columns stacked, one
     exchange) go to the left neighbour;
  2. the banded pass runs over [slab | halo] with ``i_limit`` = the slab
     size: halo rows take part only as the j side of a pair, so no pair is
     evaluated on two ranks (kernel D on the card);
  3. the j-side deltas of the halo rows go back to their owner, the right
     neighbour, which adds them onto its first `window` rows.

Once a frame the state is gathered, sorted (stably, the same on every
rank) and split again: the "occasional re-partition".  Positions drift
less than the window's slack within one frame, as on one device.
"""

from __future__ import annotations

import torch

from ..ops.cuda import glue_kernel as GL
from ..ops.cuda import pairs_kernel as PK
from ..physics import step as PS
from ..physics import types as T
from ..utils.constants import WorldConst, DEFAULT_WORLD
from .halo import permute
from .mesh import Mesh, gather_leading, local_block


def make_halo_pair_fn(mesh: Mesh, window: int = PS.PAIR_WINDOW):
    """The pair-delta function of a rank's slab of the globally x-sorted
    population, for `physics/step._substep`'s `pair_fn`: local slab plus a
    `window`-rank halo from the next rank, the banded pass with `i_limit`,
    the halo rows' deltas returned to their owner.  Needs window <= slab
    size (a halo from one neighbour)."""
    n, r = mesh.size, mesh.rank
    left = r - 1 if r > 0 else None
    right = r + 1 if r < n - 1 else None

    def pair_fn(px, py, pz, vx, vy, vz, rad, mass, elas, act):
        nl = px.shape[0]
        if window > nl:
            raise ValueError(
                f"halo pair pass needs window ({window}) <= local slab ({nl}); "
                "use fewer devices or more objects")
        cols = (px, py, pz, vx, vy, vz, rad, mass, elas, act.to(px.dtype))
        if n > 1:
            # one exchange for the whole halo: the 10 columns stacked; the
            # last rank's halo arrives as zeros (inactive rows)
            halos = permute(torch.stack([c[:window] for c in cols]), mesh, left, right)
            ext = [torch.cat([c, halos[i]]) for i, c in enumerate(cols)]
        else:
            ext = list(cols)
        active = ext[9] > 0
        # pad inactive rows' masses to 1.0: a masked pair of two empty halo
        # rows would otherwise divide 0 by 0 before its mask drops it
        ext[7] = torch.where(active, ext[7], 1.0)
        deltas = PK.banded_pairs(*ext[:9], active, window=window, i_limit=nl)
        if n == 1:
            return deltas
        returned = permute(torch.stack([d[nl:] for d in deltas]), mesh, right, left)
        out = []
        for i, d in enumerate(deltas):
            d = d[:nl].clone()
            d[:window] += returned[i]
            out.append(d)
        return tuple(out)

    return pair_fn


def make_step_objects_sharded(mesh: Mesh, substeps: int = 4,
                              world: WorldConst = DEFAULT_WORLD,
                              tstep: float = T.DEF_TIMESTEP,
                              window: int = PS.PAIR_WINDOW,
                              pair_every: int = 1,
                              water: bool = True):
    """The frame step with pair collisions over the mesh's ranks.

    Returns ``step(slab, env, cobjs, table) -> slab``: `slab` is the rank's
    block of the object state (`local_block` of the population); the scene
    (env, cobjs, table) is whole on every rank.  Each frame gathers the
    population, sorts it on x, takes the rank's slab of the sorted order
    and runs `substeps` substeps with the halo pair pass on substeps 0,
    pair_every, 2*pair_every, ... (as `physics/step.step_objects`), then
    the frame's bookkeeping."""
    pair_fn = make_halo_pair_fn(mesh, window)
    dt = float(torch.tensor(tstep / substeps, dtype=torch.float32))

    def step(slab: PS.ObjectState, env: PS.PhysicsEnv, cobjs,
             table: T.ObjTypeTable) -> PS.ObjectState:
        state = PS.spatial_sort(gather_leading(slab, mesh))
        slab = local_block(state, mesh)
        for k in range(substeps):
            run_pairs = pair_every <= 1 or k % pair_every == 0
            slab = PS._substep(slab, env, cobjs, table, dt, world, run_pairs,
                               pair_window=window, water=water,
                               pair_fn=pair_fn if run_pairs else None)
        return GL.age_objects(slab, table)

    return step

"""Game frame update: the explosion/damage loop (port of
`3dworld_tpu/gameplay/frame.py`).

The reference's `update_game_frame` + collision callbacks
(build_world.cpp:359-376, Gameplay.cpp): projectiles with EXPL_ON_COLL
explode on contact, dealing blast damage to objects, destroying
destroyable cobjs, spawning fragments, and marking smoke/decals.

One pass per frame over the object SoA: find the exploding projectiles
(one host read of their fields), then a host loop over at most
`MAX_EXPLOSIONS_PER_FRAME` booms, each a blast and a cobj destruction on
the device; the booms' cobj-hit flags stay on the device and are read
back once at the end, as in the JAX package.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..physics import types as T
from ..physics.step import ObjectState
from ..physics.cobjs import CobjSet
from ..physics import destroy as PD
from . import game as GG

MAX_EXPLOSIONS_PER_FRAME = 8
BLAST_RADIUS_SCALE = 8.0  # blast radius = scale * object radius


class GameFrameResult(NamedTuple):
    state: ObjectState
    cobjs: CobjSet
    explosions: np.ndarray   # [K, 4] x y z radius (for smoke/decals/fx)


def find_explosions(state: ObjectState, table: T.ObjTypeTable) -> np.ndarray:
    """Objects that explode this frame: EXPL types that collided
    (EXPL_ON_COLL) or died of lifetime (grenade timers).  Reads the state
    back (one host copy of its integer fields)."""
    otype = state.otype.cpu().numpy()
    flags, status, time = (a.cpu().numpy() for a in (state.flags, state.status, state.time))
    tflags = table.flags.cpu().numpy()[otype]
    is_expl = (tflags & T.OBJ_FLAG_EXPL) != 0
    expl_on_coll = (tflags & T.OBJ_FLAG_EXPL_COLL) != 0
    collided = (flags & T.FL_COLLIDED) != 0
    alive = status > 0
    life = table.lifetime.cpu().numpy()[otype]
    expired = alive & (life > 0) & (time >= life - 1)
    stopped = alive & (status >= 2)
    boom = is_expl & alive & ((expl_on_coll & (collided | stopped)) | expired)
    return np.where(boom)[0]


def update_game_frame(state: ObjectState, cobjs: CobjSet,
                      destroy_state: PD.DestroyState, table: T.ObjTypeTable,
                      seed: int = 0) -> GameFrameResult:
    """One gameplay frame: process up to MAX_EXPLOSIONS_PER_FRAME booms.
    `seed` seeds the fragments' velocity draws (`spawn_fragments`)."""
    idx = find_explosions(state, table)[:MAX_EXPLOSIONS_PER_FRAME]
    expl = []
    hit_flags = []
    if len(idx):
        dam = table.damage.cpu().numpy()
        rad = table.radius.cpu().numpy()
        it = torch.as_tensor(idx, device=state.px.device)
        # one bulk device->host pull for the blast centers
        px, py, pz, ot_all = (a[it].cpu().numpy()
                              for a in (state.px, state.py, state.pz, state.otype))
        for k in range(len(idx)):
            ot = int(ot_all[k])
            x, y, z = float(px[k]), float(py[k]), float(pz[k])
            r = BLAST_RADIUS_SCALE * rad[ot]
            d = max(dam[ot], 1.0)
            state = GG.apply_blast(state, x, y, z, r, d)
            cobjs, hit = PD.destroy_coll_objs(cobjs, destroy_state, x, y, z, r)
            hit_flags.append(torch.any(hit))   # stays on the device until the end
            expl.append((x, y, z, r))
        # all exploding projectiles die: one indexed write
        status = state.status.clone()
        status[it] = 0
        state = state._replace(status=status)
        # one deferred read of all the cobj-hit flags
        hits = torch.stack(hit_flags).cpu().numpy()
        centers = [e[:3] for e, h in zip(expl, hits) if h]
        if centers:
            state = PD.spawn_fragments(state, table, centers, seed=seed)
    return GameFrameResult(state=state, cobjs=cobjs,
                           explosions=np.asarray(expl, np.float32).reshape(-1, 4))

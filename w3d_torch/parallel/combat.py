"""The ship-sharded combat frame (the JAX dry run's phase 7, where GSPMD
splits the unchanged `combat_frames_chained` over a `ships` axis).

A rank owns a contiguous slab of the fleet's ships (with their [N, S]
cooldowns and ammo, crew and captured flags) and of the projectile pool
(`shard_combat`).  The frame is `universe/combat.step_combat` with this
rank's `Slabs`: `mesh.gather_packed` as its gather, five collectives a
frame, each stage computing the rank's rows or columns of every pairwise
block (see `step_combat`).

The frame comes out bit for bit that of one rank, but for one sum.  The
column sums over shooters (beam damage, boarding attempts) and over ships
(PD damage onto projectiles) add in row order on any set of columns
(`_columns`), so they keep their bits.  The impact sums onto a rank's
ships reduce its [k, P] rows where one rank reduces [N, P]: they may
round apart when a ship takes more than one non-dyadic hit in a frame,
and they reach its shields and armor.
"""

from __future__ import annotations

from ..universe import combat as UC
from ..universe.ships import _filled
from .mesh import Mesh, gather_packed, shard_leading, unshard_leading


def _sizes(cs: UC.CombatState) -> tuple:
    return (cs.fleet.px.shape[0], cs.proj.px.shape[0])


def shard_combat(cs: UC.CombatState, mesh: Mesh) -> UC.CombatState:
    """The rank's share of a whole `CombatState`: its slab of the ships
    (every [N, ...] leaf) and of the projectile pool (every [P] leaf).
    N and P must split over the ranks."""
    cs = cs._replace(fleet=_filled(cs.fleet))
    return shard_leading(cs, mesh, _sizes(cs))


def unshard_combat(cs: UC.CombatState, mesh: Mesh) -> UC.CombatState:
    """Inverse of `shard_combat`: the whole state on every rank."""
    n, p = _sizes(cs)
    return unshard_leading(cs, mesh, (n * mesh.size, p * mesh.size))


def make_sharded_combat_frames(mesh: Mesh, ct: UC.CombatTables):
    """`frames(cs, draws, k, counts=None) -> cs`: `k` chained combat frames
    of the rank's share (`shard_combat`) on the chunk's whole `CombatDraws`
    (the same on every rank, [k, ...] leaves), as `combat_frames_chained`
    on one device.  `counts` (a dict), when given, adds up the chunk's
    events on this rank (`universe.combat.COUNTS`)."""
    slabs = UC.Slabs(mesh.rank, mesh.size, lambda leaves: gather_packed(leaves, mesh))

    def frames(cs: UC.CombatState, draws: UC.CombatDraws, k: int,
               counts: dict | None = None) -> UC.CombatState:
        return UC.combat_frames_chained(cs, draws, k, ct, slabs, counts)

    return frames

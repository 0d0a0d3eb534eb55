"""The agent-sharded city frame (the JAX dry run's phase 6, where GSPMD
splits the unchanged `city_frames_chained` over an `agents` axis).

A rank owns a contiguous slab of the cars and of the pedestrians
(`mesh.shard_leading` of `state.cars` and `state.peds`); everything else
of the `CityState` (stoplights, building people, elevator cars,
helicopters, birds, trains) reads no car or pedestrian, so every rank
steps it whole and identically.  Two updates read other agents:

* car headway reads every car's previous segment, end, parameter and
  parked flag (a rank's [n_local, n] block), and the turn hash and the
  self test take the global index `first + i`;
* pedestrian separation reads every pedestrian's previous x and y (the
  rank's [n_local, n] rows, each summed over all n columns as on one
  device).

So each frame gathers those six leaves once, in one collective (13 bytes
a car, 8 a pedestrian), and runs the single-device frame on the slab
(`city_step.city_frames_chained` with the exchange).  Every other update
is per agent, so a slab comes out as the same rows of the one-rank call.
"""

from __future__ import annotations

from ..city import city_step as CS
from ..city import traffic as CT
from .mesh import Mesh, gather_packed, local_block, shard_leading, unshard_leading


def shard_city(cs: CS.CityState, mesh: Mesh) -> CS.CityState:
    """The rank's share of a whole `CityState`: its slab of the cars and of
    the pedestrians, the rest whole.  The counts must split over the ranks
    (nothing is padded: a padded car or pedestrian would take part in
    headway and separation)."""
    nc, npd = cs.cars.t.shape[0], cs.peds.x.shape[0]
    return cs._replace(cars=shard_leading(cs.cars, mesh, (nc,)),
                       peds=shard_leading(cs.peds, mesh, (npd,)))


def unshard_city(cs: CS.CityState, mesh: Mesh) -> CS.CityState:
    """Inverse of `shard_city`: the whole state on every rank."""
    kc, kp = cs.cars.t.shape[0], cs.peds.x.shape[0]
    return cs._replace(cars=unshard_leading(cs.cars, mesh, (kc * mesh.size,)),
                       peds=unshard_leading(cs.peds, mesh, (kp * mesh.size,)))


def make_sharded_city_frames(mesh: Mesh):
    """`frames(cs, graph, nav, pads, perches, k, draws, rail=None) -> cs`:
    `k` chained city frames of the rank's share (`shard_city`), on the
    chunk's whole `CityDraws` (the same on every rank; the rank takes its
    pedestrians' columns)."""

    def exchange(cars: CT.CarState, peds: CT.PedState):
        seg, end, t, parked, x, y = gather_packed(
            [cars.seg, cars.end, cars.t, cars.parked, peds.x, peds.y], mesh)
        return (CT.CarPeers(seg, end, t, parked, mesh.rank * cars.t.shape[0]),
                CT.PedPeers(x, y, mesh.rank * peds.x.shape[0]))

    def frames(cs: CS.CityState, graph, nav, pads, perches, k: int,
               draws: CS.CityDraws, rail=None) -> CS.CityState:
        npd = cs.peds.x.shape[0] * mesh.size
        if draws.ped_u.shape[1] != npd:
            raise ValueError(f"sharded city: draws for {draws.ped_u.shape[1]} "
                             f"pedestrians, the crowd has {npd}")
        cols = lambda t: local_block(t.T, mesh).T
        draws = draws._replace(ped_u=cols(draws.ped_u), ped_side=cols(draws.ped_side),
                               ped_u3=cols(draws.ped_u3), ped_u4=cols(draws.ped_u4))
        return CS.city_frames_chained(cs, graph, nav, pads, perches, k, draws, rail=rail,
                                      exchange=exchange)

    return frames

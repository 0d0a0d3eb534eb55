"""The combined world step: the port's counterpart of the JAX package's
`__graft_entry__.entry()`.

One step generates a batch of terrain tiles (sine noise, glaciation,
droplet erosion) and advances the spheres population one physics frame
over the first tile.  On a CUDA device every hand-written kernel of the
port runs in it: erosion, mesh sampling, the narrow phase and the banded
pair pass.

`make_sharded_combined_step` is the same step over the ranks of a
`parallel.mesh.Mesh`: the tiles split over the ranks, the population in
slabs of its sorted order with the halo pair pass.
"""

from __future__ import annotations

import torch

from .utils.constants import WorldConst, DEFAULT_WORLD
from .models import terrain_model as TMOD
from .models import physics_model as PM
from .physics import step as PS
from .parallel.mesh import Mesh, broadcast
from .parallel.pairs import make_step_objects_sharded


def combined_step(table, x0, y0, zmax_est, wpz, angles,
                  state: PS.ObjectState, sw: PM.SpheresWorld,
                  mcfg: TMOD.TileModelConfig,
                  world: WorldConst = DEFAULT_WORLD,
                  substeps: int = 4):
    """(tiles [T, n, n], state after one frame with mesh_height = tiles[0]).
    Tiles must be world-sized (tile_size == world.mesh_x == mesh_y)."""
    tiles = TMOD.tile_batch_step(table, x0, y0, zmax_est, wpz, angles,
                                 mcfg, world)
    env = sw.env._replace(mesh_height=tiles[0])
    st = PS.step_objects(state, env, sw.cobjs, sw.table, substeps=substeps,
                         world=world, obj_collisions=True)
    return tiles, st


def entry(device: torch.device | str, generator: torch.Generator,
          num_tiles: int = 8, num_objects: int = 2048):
    """(fn, args) at the JAX `entry()`'s shapes: 8 tiles of 128^2 with 512
    droplets in batches of 128 for 64 steps, and 2048 balls for a 4-substep
    frame; `fn(*args)` runs `combined_step`.  The tiles erode without the
    roam ring (`use_pallas_erosion=True`, the JAX TPU path's walk)."""
    world = WorldConst()
    mcfg = TMOD.TileModelConfig(tile_size=128, erosion_iters_tt=512,
                                erosion_batch=128, erosion_steps=64,
                                use_pallas_erosion=True)
    pos, vel = PM.spawn(num_objects, generator, device=device)
    sw = PM.build_spheres_world(pos, vel, world=world, device=device)
    targs = TMOD.example_inputs(mcfg, world, generator, num_tiles=num_tiles,
                                device=device)

    def fn(table, x0, y0, zmax_est, wpz, angles, state):
        return combined_step(table, x0, y0, zmax_est, wpz, angles, state, sw,
                             mcfg, world)

    return fn, (*targs, sw.state)


def make_sharded_combined_step(mesh: Mesh, mcfg: TMOD.TileModelConfig,
                               world: WorldConst = DEFAULT_WORLD,
                               substeps: int = 4, window: int = PS.PAIR_WINDOW):
    """`combined_step` over the mesh's ranks.  Returns ``step(table, x0, y0,
    zmax_est, wpz, angles, slab, sw) -> (tiles, slab)``: the whole [T]
    origins in and the rank's block of the tiles out; `slab` the rank's
    block of the population, `sw` the scene (whole on every rank).  The
    frame runs over tile 0, which rank 0 computes and broadcasts."""
    tile_step = TMOD.make_sharded_tile_step(mesh, mcfg, world)
    frame = make_step_objects_sharded(mesh, substeps=substeps, world=world, window=window)

    def step(table, x0, y0, zmax_est, wpz, angles, slab: PS.ObjectState,
             sw: PM.SpheresWorld):
        tiles = tile_step(table, x0, y0, zmax_est, wpz, angles)
        env = sw.env._replace(mesh_height=broadcast(tiles[0], mesh, 0))
        return tiles, frame(slab, env, sw.cobjs, sw.table)

    return step

"""Flagship physics model (port of `3dworld_tpu/models/physics_model.py`):
the `config_spheres.txt`-class scenario — N dynamic balls over a static
cobj scene — and its frame step.

This is the re-expression of `process_groups` (build_world.cpp:310-600) at
the reference's ">10K dynamic objects" scale (README.md:18).  The JAX
package spawns the balls with threefry draws, which torch cannot
reproduce, so `build_spheres_world` takes the spawn positions and
velocities; `spawn` draws them from a `torch.Generator`.
`make_sharded_frame_step` splits the population over the ranks of a
`parallel.mesh.Mesh`.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..utils.constants import WorldConst, DEFAULT_WORLD
from ..utils.rng import RandGen
from ..physics import types as PT, step as PS, cobjs as PC
from ..scene import cobj as SC
from ..parallel.mesh import Mesh
from ..parallel.pairs import make_step_objects_sharded


class SpheresWorld(NamedTuple):
    state: PS.ObjectState
    env: PS.PhysicsEnv
    cobjs: PC.GroupedCobjs | PC.CobjSet
    table: PT.ObjTypeTable


def spheres_scene() -> SC.SceneParse:
    """Default scene ~ coll_objs/spheres.txt: a ground cube and 100 random
    spheres from the reference LCG."""
    sp = SC.SceneParse()
    lay = SC.CobjLayer(elasticity=0.9)
    sp.cobjs.append(SC.RawCobj(SC.COLL_CUBE, (-4.0, -4.0, -0.7), (4.0, 4.0, 0.0),
                               layer=lay))
    rg = RandGen(7, 3)
    for _ in range(100):
        r = rg.rand_uniform(0.1, 0.25)
        x = rg.rand_uniform(-2.5, 2.5)
        y = rg.rand_uniform(-2.5, 2.5)
        sp.cobjs.append(SC.RawCobj(SC.COLL_SPHERE, (x, y, r), r1=r, layer=lay))
    return sp


def spawn(num_objects: int, generator: torch.Generator,
          device: torch.device | str = "cuda"):
    """Spawn draws for N balls: positions uniform in [-3,3]x[-3,3]x[0.5,3.5]
    and velocities normal with sigma 0.5 (the JAX package's distributions);
    returns (pos [N,3], vel [N,3])."""
    kw = dict(generator=generator, dtype=torch.float32, device=device)
    lo = torch.tensor([-3.0, -3.0, 0.5], device=device)
    span = torch.tensor([6.0, 6.0, 3.0], device=device)
    pos = lo + torch.rand((num_objects, 3), **kw) * span
    vel = torch.randn((num_objects, 3), **kw) * 0.5
    return pos, vel


def build_spheres_world(
    pos: torch.Tensor,
    vel: torch.Tensor,
    world: WorldConst = DEFAULT_WORLD,
    obj_type: str = "BALL",
    mesh_height: torch.Tensor | None = None,
    device: torch.device | str = "cuda",
    group_shapes: bool = True,
) -> SpheresWorld:
    """Assemble the scenario: a flat mesh at -0.7 (config_spheres disables
    the drawn mesh and uses a ground-plane cube), the spheres scene (shape
    grouped, or a plain CobjSet with `group_shapes=False`), and balls at
    pos/vel [N, 3]."""
    table = PT.make_type_table(z_scene=world.z_scene, device=device)
    cobjs = SC.pack_cobjs(spheres_scene(), device=device)
    if group_shapes:
        cobjs = PC.group_cobjs(cobjs)
    if mesh_height is None:
        mesh_height = torch.full((world.mesh_y, world.mesh_x), -0.7,
                                 dtype=torch.float32, device=device)
    f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=device)
    env = PS.PhysicsEnv(
        mesh_height=mesh_height,
        water_plane_z=f32(-100.0),  # disable_water 1
        wind=f32([0.4, 0.2, 0.0]),
        temperature=f32(20.0),
        base_gravity=f32(1.0),
        zmin=f32(-world.z_scene),
    )
    n = pos.shape[0]
    otype = torch.full((n,), PT.type_id(obj_type), dtype=torch.int32)
    st = PS.make_state(pos, vel, otype, table)
    return SpheresWorld(state=st, env=env, cobjs=cobjs, table=table)


def frame_step(w: SpheresWorld, substeps: int = 4,
               world: WorldConst = DEFAULT_WORLD,
               obj_collisions: bool = True,
               pair_every: int = 1,
               water: bool = True) -> SpheresWorld:
    st = PS.step_objects(w.state, w.env, w.cobjs, w.table,
                         substeps=substeps, world=world,
                         obj_collisions=obj_collisions,
                         pair_every=pair_every, water=water)
    return w._replace(state=st)


def make_sharded_frame_step(mesh: Mesh, substeps: int, world: WorldConst,
                            obj_collisions: bool = True,
                            pair_window: int | None = None):
    """Object-axis data parallelism: ``step(w) -> w`` where `w.state` is the
    rank's slab of the population (`parallel.mesh.local_block`) and the
    scene is whole on every rank.  With collisions on (the default) the
    exact banded pair pass runs domain-decomposed: slabs of the globally
    sorted order with a `pair_window`-rank halo (`parallel/pairs.py`);
    without, each rank steps its slab alone."""
    if obj_collisions:
        inner = make_step_objects_sharded(mesh, substeps=substeps, world=world,
                                          window=pair_window or PS.PAIR_WINDOW)

        def step(w: SpheresWorld) -> SpheresWorld:
            return w._replace(state=inner(w.state, w.env, w.cobjs, w.table))
        return step

    def step(w: SpheresWorld) -> SpheresWorld:
        return w._replace(state=PS.step_objects(w.state, w.env, w.cobjs, w.table,
                                                substeps=substeps, world=world,
                                                obj_collisions=False))
    return step

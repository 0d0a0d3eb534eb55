"""The multi-device dry run: the port's `dryrun_multichip`
(`__graft_entry__.py:80-255`), phases 1-7 at that function's sizes.

    python -m w3d_torch.dryrun --ranks 4                 # nccl, a card a rank
    python -m w3d_torch.dryrun --ranks 4 --backend gloo --share-card
    python -m w3d_torch.dryrun --ranks 4 --cpu           # gloo on the host
    torchrun --nproc-per-node 4 -m w3d_torch.dryrun      # ranks from torchrun

Without torchrun's environment the command spawns the ranks itself
(`parallel.launch.run_ranks`).  Phases, each asserting what the JAX phase
asserts:

  1. the combined step sharded: 2 tiles a rank (32², 32 droplets) and 128
     balls a rank, 2 substeps, the halo pair pass at window 64;
  2. the sharded tile step;
  3. the object-axis frame with pairs (`make_sharded_frame_step`);
  4. the directional-shadow chain across ranks (16² tiles, a wall);
  5. the sky bake, 256 rays a rank, merged in rank order;
  6. the fused city frame (2 chained frames) on a flat 64² map with 8 cars
     and 16 pedestrians a rank, sharded on an `agents` axis
     (`parallel/city`);
  7. 2 combat frames under the full weapon model over 16 ships a rank (4
     toy classes: beam, torpedo, point defence, beam) and a projectile
     pool of 16 a rank, sharded on a `ships` axis (`parallel/combat`).

Rank 0 prints one line with the shapes when every phase passed.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

from .city import assemble as CA
from .city import city_step as CS
from .entry import make_sharded_combined_step
from .lighting import lmap as LM
from .lighting import parallel as LPAR
from .models import physics_model as PM
from .models import terrain_model as TMOD
from .ops import shadows as SH
from .parallel import city as PCITY
from .parallel import combat as PCOMBAT
from .parallel import halo as PH
from .parallel.launch import run_ranks
from .parallel.mesh import Mesh, gather_leading, init_mesh, local_block
from .scene import cobj as SC
from .universe import combat as UCB
from .universe import ships as USH
from .utils.constants import WorldConst


def _check(cond, what: str) -> None:
    if not cond:
        raise RuntimeError(f"dryrun check failed: {what}")


def _finite(t: torch.Tensor) -> bool:
    return bool(torch.isfinite(t).all())


def toy_combat_tables(device) -> UCB.CombatTables:
    """The dry run's synthetic combat tables (`__graft_entry__.py`'s
    `_toy_combat_tables`): 8 classes, 4 weapons, 2 slots; classes 0, 1, 2
    and 3 (mod 4) carry a beam, a torpedo, point defence and a beam."""
    C, W, S = 8, 4, 2
    cls_tbl = np.zeros((C, 9), np.float32)
    cls_tbl[:, 0] = 0.001     # accel
    cls_tbl[:, 1] = 0.01      # vmax
    cls_tbl[:, 2] = 100.0     # armor
    cls_tbl[:, 3] = 50.0      # shields
    cls_tbl[:, 7] = 0.01      # radius
    aux = np.zeros((C, UCB.NUM_CA), np.float32)
    aux[:, UCB.CA_NCREW] = 4.0
    aux[:, UCB.CA_CAN_BOARD] = 1.0
    w = np.zeros((W, UCB.NUM_WF), np.float32)
    w[:, UCB.WF_AMMO_CLASS] = -1.0
    w[1] = 0  # UWEAP-style rows: 1=beam, 2=torpedo, 3=PD
    w[1, UCB.WF_DAMAGE] = 2.0
    w[1, UCB.WF_RANGE] = 0.5
    w[1, UCB.WF_FIRE_DELAY] = 1.0
    w[1, UCB.WF_NSHOTS] = 1.0
    w[2, UCB.WF_DAMAGE] = 20.0
    w[2, UCB.WF_RANGE] = 0.8
    w[2, UCB.WF_SPEED] = 0.005
    w[2, UCB.WF_SEEK_DIST] = 0.3
    w[2, UCB.WF_LIFETIME] = 200.0
    w[2, UCB.WF_FIRE_DELAY] = 20.0
    w[2, UCB.WF_CRADIUS] = 0.005
    w[2, UCB.WF_PROJ_ARMOR] = 10.0
    w[2, UCB.WF_NSHOTS] = 1.0
    w[3, UCB.WF_DAMAGE] = 6.0
    w[3, UCB.WF_RANGE] = 0.2
    w[3, UCB.WF_PT_DEF] = 1.0
    w[3, UCB.WF_FIRE_DELAY] = 4.0
    w[3, UCB.WF_NSHOTS] = 1.0
    slot_wid = np.zeros((C, S), np.int32)
    slot_wid[0::4, 0] = 1     # beams
    slot_wid[1::4, 0] = 2     # torpedoes
    slot_wid[2::4, 0] = 3     # point defense
    slot_wid[3::4, 0] = 1
    t = lambda a: torch.as_tensor(a, device=device)
    return UCB.CombatTables(cls_tbl=t(cls_tbl), cls_aux=t(aux), w_tbl=t(w),
                            slot_wid=t(slot_wid), slot_num=t(np.ones((C, S), np.float32)),
                            slot_ammo0=t(np.full((C, S), np.inf, np.float32)),
                            slot_pt=t(np.zeros((C, S, 3), np.float32)))


def city_inputs(n: int, gen: torch.Generator, device):
    """Phase 6's whole city (`build_city` on a flat 64² map, 8n cars, 16n
    pedestrians, one elevator car and nothing else) with its road graph,
    pedestrian nav and 2 frames of draws."""
    cw = CA.build_city(np.zeros((64, 64), np.float32), num_cities=1, num_cars=8 * n,
                       num_peds=16 * n, num_helis=0, seed=1, device=device)
    cs = CS.CityState(stoplights=cw.stoplights, cars=cw.cars, peds=cw.peds, people=None,
                      elev=CS.make_elevator_bank(1, device=device), helis=None, birds=None)
    return cs, cw.graph, cw.ped_nav, CS.draw_city(2, 16 * n, 0, 0, 0, 0, gen, device=device)


def combat_inputs(n: int, gen: torch.Generator, device):
    """Phase 7's whole combat state (16n ships of 2 teams, classes i mod 4,
    a pool of 16n), its tables and 2 frames of draws."""
    ct = toy_combat_tables(device)
    fl = USH.make_fleet(USH.draw_fleet(16 * n, gen, num_teams=2, device=device))
    fl = fl._replace(cls=torch.arange(16 * n, dtype=torch.int32, device=device) % 4)
    cs = UCB.make_combat_state(fl, ct, pool_size=16 * n)
    draws = UCB.draw_combat(2, 16 * n, ct.slot_wid.shape[1], gen)
    return cs, ct, UCB.CombatDraws(*(t.to(device) for t in draws))


def run(mesh: Mesh) -> str:
    """Phases 1-7 on this rank; the summary line."""
    n, dev = mesh.size, mesh.device
    if dev.type == "cpu":                       # the ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // n))
    gen = torch.Generator().manual_seed(0)      # the same draws on every rank
    world = WorldConst(mesh_x=32, mesh_y=32)
    mcfg = TMOD.TileModelConfig(tile_size=32, erosion_iters_tt=32, erosion_batch=32,
                                erosion_steps=8)
    table, *targs = TMOD.example_inputs(mcfg, world, gen, num_tiles=2 * n, device="cpu")
    table = type(table)(*(t.to(dev) for t in table))
    targs = [t.to(dev) for t in targs]
    pos, vel = PM.spawn(128 * n, gen, device="cpu")
    sw = PM.build_spheres_world(pos.to(dev), vel.to(dev), world=world, device=dev)
    slab = local_block(sw.state, mesh)

    # 1. the combined step: tiles and objects split over the same ranks
    step = make_sharded_combined_step(mesh, mcfg, world, substeps=2, window=64)
    tiles, st = step(table, *targs, slab, sw)
    tiles = gather_leading(tiles, mesh)
    _check(tuple(tiles.shape) == (2 * n, 32, 32), f"combined tiles {tuple(tiles.shape)}")
    _check(_finite(tiles) and _finite(st.pz), "combined step finite")

    # 2. the sharded tile step
    out = gather_leading(TMOD.make_sharded_tile_step(mesh, mcfg, world)(table, *targs), mesh)
    _check(tuple(out.shape) == (2 * n, 32, 32) and _finite(out), "tile step")

    # 3. the object-axis frame, collisions on
    fstep = PM.make_sharded_frame_step(mesh, substeps=2, world=world, pair_window=64)
    sw2 = fstep(sw._replace(state=slab))
    _check(_finite(sw2.state.pz), "sharded frame finite")

    # 4. shadows chained across ranks
    z = torch.zeros((2 * n, 16, 16), dtype=torch.float32, device=dev)
    z[0, :, 8] = 2.0
    run_scan = PH.make_sharded_shadow_scan(mesh, (-1.0, 0.0, 0.3), 0.0625)
    sh = gather_leading(run_scan(local_block(z, mesh),
                                 torch.full((16,), SH.MESH_MIN_Z, device=dev)), mesh)
    _check(tuple(sh.shape) == (2 * n, 16, 16), f"shadows {tuple(sh.shape)}")

    # 5. the sky bake over the ranks
    lw = WorldConst(mesh_x=16, mesh_y=16, mesh_z=8)
    sp = SC.SceneParse()
    sp.cobjs.append(SC.RawCobj(SC.COLL_CUBE, (-1, -1, -0.5), (1, 1, -0.4),
                               layer=SC.CobjLayer(elasticity=0.5,
                                                  color=(0.7, 0.6, 0.5, 1.0))))
    lgrid = LPAR.compute_sky_lighting_sharded(
        mesh, LM.make_light_grid(lw, device=dev), SC.pack_cobjs(sp, device=dev),
        torch.full((lw.mesh_y, lw.mesh_x), -0.6, dtype=torch.float32, device=dev),
        num_rays=n * 256, batch=256, seed=1, world=lw)
    _check(_finite(lgrid.sv) and float(lgrid.sv.sum()) > 0.0, "sky bake lit and finite")

    # 6. the city frame, cars and pedestrians split over the ranks
    ccs, graph, nav, cdraws = city_inputs(n, gen, dev)
    cities = PCITY.make_sharded_city_frames(mesh)
    c2 = PCITY.unshard_city(cities(PCITY.shard_city(ccs, mesh), graph, nav, None, None, 2,
                                   cdraws), mesh)
    _check(_finite(c2.cars.t) and _finite(c2.peds.x), "city frame finite")

    # 7. the combat frame, ships and projectiles split over the ranks
    ucs, ct, udraws = combat_inputs(n, gen, dev)
    battle = PCOMBAT.make_sharded_combat_frames(mesh, ct)
    c3 = PCOMBAT.unshard_combat(battle(PCOMBAT.shard_combat(ucs, mesh), udraws, 2), mesh)
    _check(_finite(c3.fleet.px) and _finite(c3.proj.px), "combat frame finite")

    return (f"dryrun({n}) phases 1-7 ok: combined {tuple(tiles.shape)} + tiles {tuple(out.shape)} + "
            f"physics {tuple(sw2.state.px.shape)} a rank (pair collisions on, halo "
            f"decomposed) + shadow halo {tuple(sh.shape)} + sky bake {tuple(lgrid.sv.shape)} "
            f"+ city frame (cars {tuple(c2.cars.t.shape)}, peds {tuple(c2.peds.x.shape)}) + "
            f"combat ({c3.fleet.px.shape[0]} ships, projectile pool "
            f"{tuple(c3.proj.px.shape)}) over {n} ranks ({mesh.backend}, {dev})")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ranks", type=int, default=None,
                    help="ranks to spawn (default: one a CUDA device); ignored under torchrun")
    ap.add_argument("--backend", choices=("nccl", "gloo"), default=None,
                    help="default nccl, or gloo with --cpu")
    ap.add_argument("--share-card", action="store_true",
                    help="every rank on cuda:0 (needs --backend gloo)")
    ap.add_argument("--cpu", action="store_true", help="every rank on the host (gloo)")
    args = ap.parse_args(argv)
    backend = args.backend or ("gloo" if args.cpu else "nccl")
    if args.cpu and backend != "gloo":
        ap.error("--cpu runs on gloo")
    device = "cpu" if args.cpu else ("cuda:0" if args.share_card else None)
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:      # under torchrun
        if args.share_card and backend == "nccl" and int(os.environ["WORLD_SIZE"]) > 1:
            ap.error("nccl refuses two ranks on one card: --share-card needs --backend gloo")
        mesh = init_mesh(backend=backend, device=device)
        try:
            line = run(mesh)
        finally:
            dist.destroy_process_group()
        if mesh.rank == 0:
            print(line, flush=True)
        return 0
    ranks = args.ranks or torch.cuda.device_count()
    if ranks < 1:
        ap.error("no CUDA device: pass --cpu, or --ranks with --share-card on a card")
    if args.share_card and backend == "nccl" and ranks > 1:
        ap.error("nccl refuses two ranks on one card: --share-card needs --backend gloo")
    results = run_ranks(run, ranks, backend, device)
    print(results[0].value, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

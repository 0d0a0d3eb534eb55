"""Where the time goes on the GPU: trace the main path's two halves, the
fused frame, the chained ground frame and game mode.

    python3 -m w3d_torch.utils.profile_step [--table PATH]

Runs one 256-tile terrain call, 10K-ball physics frames (10 substeps,
pair pass every 5th and every substep, no water), 10K-ball fused frames
(`step_objects_fused`, pair pass every 5th) at the main path's shapes, and
8 chained ground frames (`ground_frames_chained`, 2,000 balls, 4
substeps) on the grouped spheres world with smoke and on the eroded
simplex terrain with the plain CobjSet of `kernel_probe.wide_scene(8)`
(the ungrouped narrow phase), and 4 frames of `ground_frame` on the
loaded ground scene of `chip_smoke.py`'s phase 3e (scene P:
`kernel_probe.write_ground_scene`, 2,000 material spheres, 384 cobj slots,
two moving platforms), under `torch.profiler`, after two warm-up calls
each; then game mode on `chip_smoke.py`'s phase 3f scene (scene P eroded
by 1,024 droplets, 8 smileys): one whole game frame of
`app._run_ground_game`, and its parts, `ground_frame`, the AI step
(`gameplay/ai.step_smileys_ai`) and `gameplay/frame.update_game_frame`;
last tiled mode at `bench.py`'s `bench_live_tiled` settings (`tiled_world`):
one chunk of 32 frames (`TiledWorld.step_chunk`: tiles, the chained city
frames, the reroute, as the bench times it) with the fauna's 32 frames,
and its parts, the chained city frames alone and the fauna alone; and
universe mode on the fleets of `kernel_probe.write_ship_defs` (156 ships
in 195 slots, a projectile pool of 1,024): one chunk of 32 frames of
`UniverseWorld.step_chunk` through the full weapon model.
For each it prints the host wall time per call, the device-busy time per call (the
union of the CUDA kernel intervals in the trace) and its share of the
wall, the kernels launched per call, and the kernels that take the most
device time.  `--table` writes the profiler's full operator tables to a file.
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import tempfile
import time

import torch
from torch.profiler import ProfilerActivity, profile

from ..gameplay import player as PL
from ..models import physics_model as PM
from ..models import terrain_model as TMOD
from ..models import world as WM
from ..ops import erosion as E
from ..ops import noise as N
from ..ops.cuda import build
from ..physics import step as PS
from ..scene import cobj as SC
from ..scene import loader as SL
from ..terrain import mesh as TM
from ..water import ripples as WR
from .constants import WorldConst
from .kernel_probe import LIGHT_GRID, wide_scene, write_ground_scene


def device_busy(prof) -> tuple[float, int, list]:
    """(ms the device ran any kernel, kernel count, [(name, count, ms)]
    sorted by ms) over a finished trace."""
    ks = [e for e in prof.events()
          if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us, end = 0.0, None
    for s, e in sorted((k.time_range.start, k.time_range.end) for k in ks):
        if end is None or s > end:
            busy_us += e - s
            end = e
        elif e > end:
            busy_us += e - end
            end = e
    by: dict[str, list] = {}
    for k in ks:
        acc = by.setdefault(k.name, [0, 0.0])
        acc[0] += 1
        acc[1] += (k.time_range.end - k.time_range.start) / 1e3
    top = sorted(((n, c, ms) for n, (c, ms) in by.items()), key=lambda t: -t[2])
    return busy_us / 1e3, len(ks), top


def trace(label: str, fn, reps: int, tables: list) -> dict:
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    busy, nk, top = device_busy(prof)
    print(f"{label}: wall {wall / reps:.3f} ms/call, device busy "
          f"{busy / reps:.3f} ms/call ({100 * busy / wall:.1f}% of wall), "
          f"{nk / reps:.0f} kernels/call", flush=True)
    for name, count, ms in top[:8]:
        print(f"    {ms / reps:8.3f} ms {count // reps:6d}x  {name[:90]}", flush=True)
    tables.append(f"==== {label}\n" + prof.key_averages().table(
        sort_by="self_cuda_time_total", row_limit=30))
    return {"wall_ms": wall / reps, "busy_ms": busy / reps, "kernels": nk / reps}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--table", help="file for the full profiler tables")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_step: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    build.library()
    world = WorldConst()
    gen = torch.Generator(device=dev).manual_seed(1234)
    tables: list[str] = []

    trace_frames(dev, world, gen, tables)
    trace_game(dev, tables)
    trace_tiled(dev, tables)
    with tempfile.TemporaryDirectory() as tmp:
        trace_universe(dev, tables, tmp)
    if args.table:
        with open(args.table, "w") as f:
            f.write("\n\n".join(tables) + "\n")


def trace_game(dev, tables: list) -> None:
    """A game frame and its parts on phase 3f's scene."""
    import contextlib
    import io
    from .. import app as APP
    from ..gameplay import ai as AI
    from ..gameplay import frame as GF
    from ..physics import destroy as PD
    with tempfile.TemporaryDirectory() as tmp:
        cfg = write_ground_scene(tmp, "g", erosion_iters=1024)
        box = [SL.load_scene(cfg, device=dev)]
    draws = APP.GameDraws()
    sm = draws.smileys(8, dev)
    d0 = draws.ai(0, 8, dev)
    ds = PD.make_destroy_state(box[0].cobjs)

    def game_frame():
        with contextlib.redirect_stdout(io.StringIO()):
            box[0] = APP._run_ground_game(box[0], None, 1, 8, draws=draws)
    trace(f"game frame, scene P eroded, 2,000 objects, 8 smileys, "
          f"{box[0].cobjs.size} slots", game_frame, 4, tables)

    def frame():
        box[0] = WM.ground_frame(box[0])
    trace("  its ground_frame", frame, 4, tables)
    trace("  its AI step (72 line-of-sight rays, every shape family)",
          lambda: AI.step_smileys_ai(sm, d0, box[0].cobjs), 4, tables)
    trace("  its update_game_frame (nothing exploding)",
          lambda: GF.update_game_frame(box[0].objects, box[0].cobjs, ds, box[0].table),
          4, tables)


def trace_frames(dev, world, gen, tables: list) -> None:
    """The main path, the fused frame and the ground frames."""
    mcfg = TMOD.TileModelConfig(tile_size=128, erosion_iters_tt=512,
                                erosion_batch=512, erosion_steps=64,
                                use_pallas_erosion=True)
    targs = TMOD.example_inputs(mcfg, world, gen, num_tiles=256, device=dev)
    trace("terrain 256 tiles",
          lambda: TMOD.tile_batch_step(*targs, mcfg, world), 3, tables)

    pos, vel = PM.spawn(10000, gen, device=dev)
    sw0 = PM.build_spheres_world(pos, vel, world=world, device=dev)

    for pe in (5, 1):
        box = [sw0]

        def one(pe=pe):
            box[0] = PM.frame_step(box[0], substeps=10, world=world,
                                   pair_every=pe, water=False)
        trace(f"physics 10K pair_every={pe}", one, 4, tables)

    box = [sw0.state]

    def fused():
        box[0] = PS.step_objects_fused(box[0], sw0.env, sw0.cobjs, sw0.table,
                                       substeps=10, world=world, pair_every=5)
    trace("physics 10K fused, pair_every=5", fused, 8, tables)

    gpos, gvel = PM.spawn(2000, gen, device=dev)
    gsw = PM.build_spheres_world(gpos, gvel, world=world, device=dev)
    smoke = torch.zeros(LIGHT_GRID, device=dev)
    smoke[4, 64, 64] = 50.0
    ter = TM.gen_terrain(TM.TerrainConfig(mode=N.MGEN_SIMPLEX, erosion_iters=512,
                                          water_h_off_rel=0.09), world,
                         angles=E.draw_angles(512, 1024, 256, gen, device=dev),
                         device=dev)
    f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=dev)
    fenv = PS.PhysicsEnv(mesh_height=ter.mesh_height, water_plane_z=ter.water_plane_z,
                         wind=f32([0.4, 0.2, 0.0]), temperature=f32(20.0),
                         base_gravity=f32(1.0), zmin=ter.zmin)
    mv = torch.zeros((8, 2), device=dev)
    for label, env, cobjs, smk in (
            ("grouped spheres world, smoke", gsw.env, gsw.cobjs, smoke),
            ("simplex terrain, plain CobjSet wide_scene(8)", fenv,
             SC.pack_cobjs(wide_scene(8), device=dev), None)):
        box = [gsw.state]

        def chunk(env=env, cobjs=cobjs, smk=smk):
            box[0] = WM.ground_frames_chained(
                box[0], env, cobjs, gsw.table,
                WR.make_ripples(world.mesh_y, world.mesh_x, device=dev),
                PL.make_player(device=dev), mv, world, 8, smoke=smk)[0]
        trace(f"ground 2,000 balls x 8 chained frames, {label}", chunk, 2, tables)
    with tempfile.TemporaryDirectory() as tmp:
        box = [SL.load_scene(write_ground_scene(tmp, "p"), device=dev)]

        def frame():
            box[0] = WM.ground_frame(box[0])
        trace("ground_frame, loaded scene P (2,000 material spheres, "
              f"{box[0].cobjs.size} slots, two platforms)", frame, 4, tables)


if __name__ == "__main__":
    main()


def tiled_world(dev, seed: int = 1, chunk: int = 32):
    """The world of `bench.py`'s `bench_live_tiled` (and of `app.run_tiled`):
    64^2 tiles, one 128^2 city with 64 cars and 128 pedestrians, a
    furnished 3-floor tower with 48 people, 8 birds, 2 trains."""
    import numpy as np
    from ..city import assemble as CA
    from ..city import floorplan as CF
    from ..city import room_content as CRC
    from ..terrain.tiles import TileManager
    tm = TileManager(cfg=TM.TerrainConfig(mesh_seed=seed),
                     world=WorldConst(mesh_x=64, mesh_y=64), tile_size=64, device=dev)
    cw = CA.build_city(np.zeros((128, 128), np.float32), num_cities=1, num_cars=64,
                       num_peds=128, seed=seed, device=dev)
    interior = CF.gen_interior((0.0, 0.0, 0.0, 1.2, 0.9, 0.4), 3, 0.08, seed=seed)
    objs = CRC.furnish_rooms(interior, 0.08, seed=seed)
    return WM.make_tiled_world(tm, cw, builders=[(interior, 48, objs)], seed=seed,
                               chunk=chunk, num_birds=8, num_trains=2, device=dev)


def trace_tiled(dev, tables: list, chunk: int = 32) -> dict:
    """A tiled-mode chunk and its parts; returns the whole chunk's
    {"wall_ms", "busy_ms", "kernels"} (per chunk)."""
    from .. import app as APP
    from ..city import city_step as CS
    from ..veg import animals as VA
    w = tiled_world(dev, chunk=chunk)
    draws = APP.TiledDraws(1)
    wl = WorldConst(mesh_x=64, mesh_y=64)
    fa = [VA.make_animals(draws.fauna_birds(16, dev)),
          VA.make_butterflies(draws.butterflies(16, wl, dev)), None]
    cam = [0.0]

    def fauna(c):
        tm = w.tile_mgr
        mesh = tm.tiles[tm.camera_tile(c, 0.0)].zvals[:64, :64].contiguous()
        if fa[2] is None:
            fa[2] = VA.gen_fish(draws.fish(32, wl, dev), mesh, APP.FAUNA_WATER_Z, wl)
        fa[:] = VA.step_tiled_fauna(*fa, draws.fauna(w.frame, chunk, 16, 16, 32, dev),
                                    mesh, wl, APP.FAUNA_WATER_Z, c, 0.0, frames=chunk)

    def step():
        w.step_chunk(cam[0], 0.0, frames=chunk)
        fauna(cam[0])
        cam[0] += 0.8 * chunk
    out = trace(f"tiled chunk of {chunk} frames (tiles, city, reroute, fauna)", step, 4,
                tables)
    d = draws.city(0, chunk, w)
    trace(f"  its {chunk} chained city frames",
          lambda: CS.city_frames_chained(w.city, w.road_graph, w.ped_nav, w.pads,
                                         w.perches, chunk, d, rail=w.rail), 4, tables)
    trace(f"  its {chunk} fauna frames", lambda: fauna(cam[0] - 0.8 * chunk), 4, tables)
    return out


def universe_world(dev, dirname: str, multiplier: int = 1):
    """The world of `app.run_universe` on the ship defs that
    `kernel_probe.write_ship_defs` writes into `dirname` (156 ships per
    multiplier, padded by a quarter, a projectile pool of 1,024), before
    its first frame."""
    import contextlib
    import io
    import os
    from .. import app as APP
    from .kernel_probe import write_ship_defs
    path = write_ship_defs(os.path.join(dirname, f"ship_defs_x{multiplier}.txt"), multiplier)
    with contextlib.redirect_stdout(io.StringIO()):
        return APP.run_universe(0, 1, ship_defs=path, device=dev)


def trace_universe(dev, tables: list, dirname: str, chunk: int = 32) -> dict:
    """A universe-mode chunk through the full weapon model; returns its
    {"wall_ms", "busy_ms", "kernels"} (per chunk)."""
    w = universe_world(dev, dirname)
    pos = [0.0]

    def step():
        w.step_chunk((pos[0], 0.0, 0.0), frames=chunk)
        pos[0] += 0.5 * chunk
    return trace(f"universe chunk of {chunk} frames (156 ships, full weapon model)",
                 step, 2, tables)

"""Chip smoke test of the PyTorch + CUDA port (`w3d_torch`) on one GPU.

    python3 chip_smoke.py

Phases, each fatal on failure (no phase hides an error):

1. Device: the card's name and power limit (nvidia-smi), torch and CUDA
   versions.  Without a CUDA device the script exits nonzero at once.
2. Build: compiles every kernel from `w3d_torch/csrc/` (nvcc, sm_90a) and
   prints the build time.
3. The paths, through the port's own entry points, each with every kernel
   launch counter set to 0 just before it and read just after:
   a. the main path: 256 terrain tiles of 128^2 (512 droplets per tile,
      batch 512, 64 steps) on the kernel path's walk without a roam ring
      (`use_pallas_erosion=True`, the rate kept comparable with earlier
      runs), then on the padded path (`use_pallas_erosion=False`, the
      default: 136^2 maps), its rate on its own line; 10K-object spheres
      frames (10 substeps, window 288, no water) with the pair pass every
      5th substep and every substep, in which the substep glue's kernels
      (`ops/cuda/glue_kernel`) must launch `advance`, `contact` and
      `respond` once a substep, `apply_pairs` once a pair substep and
      `take_rows` and `age_objects` once a frame; one combined step at
      `w3d_torch.entry.entry()`'s shapes;
   b. the fused frame (`step_objects_fused`) on the same 10K balls: 10
      substeps, pair pass every 5th; the substep kernel must launch 10
      times and the pair kernel 2 times per frame, sample and narrow never;
   c. the fused tile noise at the terrain path's shapes (256 tiles of
      128^2), held against the terrain path's own noise, and 10 steps of
      the smoke stencil on the default light grid (32, 128, 128), held
      against the gated smoke path.
   d. ground mode: `gen_terrain` on the default 128^2 mesh in three
      configurations (sine; simplex with 512 droplets through A and the
      water raised by `water_h_off_rel` 0.09; domain warp), ms per call
      and the heights' range; then two runs of 2 x 32 chained ground
      frames (`models/world.ground_frames_chained`, 4 substeps) with 2,000
      balls: the grouped spheres world with a smoke source (B, C, D; B and
      C for the player at N = 1), and the eroded simplex terrain with the
      scene loader's env and spawn and the plain CobjSet of
      `kernel_probe.wide_scene(8)` (B, D and the ungrouped narrow phase);
      ms per frame, kernel launches per frame, live balls and the
      player's z; the ungrouped narrow phase's device-only time at those
      shapes; A in `gen_terrain` bitwise against its plain walk; and on a
      32^2 world, 4 chained frames (grouped and plain scenes) and 60
      player ticks on the card against the same calls on the CPU.
   e. scene loading and the ground app loop (`w3d_torch.app.run_ground`)
      at its defaults (2,000 objects, 32 frames a chained call, the 128^2
      x 32 mesh), from config and scene files written to a temporary
      directory: scene P, a DSL scene of ~350 cobjs (a carved plate,
      crates, pillars, spheres, ramps, a hollow cylinder, 200 random
      spheres, a continuous and a K-triggered platform) with 40 trees,
      scenery, two sphere materials and the water raised into the map
      ("water_h_off 0.09 0"): `load_scene`'s time, then 64 frames of the
      per-frame path (ms per frame, the median of the second 32; launches
      per frame; live; the platforms' travel); scene C, the same without
      the platforms, 2 x 32 chained frames; scene H, a seeded 16-bit PNG
      heightmap with a three-brush journal eroded by 2,000 droplets
      (`load_scene`'s time, A bitwise against its plain walk); and scene
      P at 32^2 with 64 balls loaded on the card and on the CPU (every
      tensor bitwise), then 4 `ground_frame`s on each (1e-5, status and
      flags equal).
   f. FPS game mode and valley water: `app.run_ground(game=True)` at the
      app's defaults (2,000 objects, 8 smileys, 64 frames) on scene P
      eroded at load by 1,024 droplets (A at load; B and D every frame):
      ms per frame (the median of frames 32-63), launches per frame,
      shots (projectiles spawned, hitscan shots), explosions, smileys
      alive and live objects; if those draws fired no projectile, no
      hitscan shot or no explosion, a scripted match (a rocket, a bat and
      an m16 on the floor plate) that makes them happen, reported apart;
      `fill_valleys` on scene P's mesh with rain collected into its
      basins (its time and the labels' apart, the wet share) and 8
      `ground_frame`s over that water; and at 32^2, the card against the
      CPU: 8 game frames with 64 objects and 4 smileys on the same draws,
      from the config and on an armed scene (free slots, a grenade about
      to go off, smileys with m16s and rockets in range) that must fire
      projectiles and hitscan shots and explode (objects 1e-5, status,
      flags, types, ages and the rows' shots, explosions, smileys and live
      equal), the valley fill bitwise, and the local wind, movable push
      and settle, one step of each particle pool, a group spawn, a blast,
      cobj destruction, fragments and stepped heightfield rays within
      1e-6.
   g. tiled mode: `app.run_tiled` at the app's and `bench.py`'s
      `bench_live_tiled` settings (seed 1, 64^2 tiles, a 128^2 city with
      64 cars, 128 pedestrians, 48 building people, 8 birds, 2 trains,
      fauna 16 + 16 + 32; 6 chunks of 32 frames, the camera moving 0.8 a
      frame): ms per frame, tiles resident, created and deleted, fauna,
      launches per frame (B twice a frame from the fauna, A never);
      `live_tiled_city_ms_per_frame` from `bench_live_tiled`'s own loop
      (`step_chunk`, the median of chunks 3-6) and one chunk under the
      profiler (the device-busy share); a 4-chunk session recorded and
      replayed on the card (hashes equal); a tile manager at tile 128
      eroding 512 droplets a tile along a camera path (ms per creating
      update, A twice per update; two deferred updates run with
      `torch.cuda.set_sync_debug_mode("error")`); A bitwise against its
      plain walk on 8 tile maps of 72^2 and 136^2 (256 droplets, 96
      steps); and 2 chunks of 8 frames on the card against the CPU (rows
      but ms and hash and integer fields equal, the city's floats 1e-5,
      tile heights 1e-4; over one mesh birds and butterflies 1e-5 and
      fish 2e-3: a fish's cruise speed rounds onto either side of the
      drag threshold, so an ulp of cos or sin slows it by 4% a frame).
   h. universe mode: `app.run_universe` at the app's sizes, 6 chunks of 32
      frames with the camera moving 0.5 a frame: without ship defs (64
      built-in ships, the fleet step; ms per frame, the first chunk's time
      as the time to the first universe frame, cells created and freed,
      galaxies generated, ships alive), on the ship defs of
      `kernel_probe.write_ship_defs` (156 ships in 195 slots, a projectile
      pool of 1,024, 8 weapon slots, the full weapon model: ms per frame,
      ships alive, projectiles live, captures) and at 8 times its fleets
      (1,248 ships in 1,560 slots); one defs chunk under the profiler
      (kernels per frame, device-busy share) and one with
      `torch.cuda.set_sync_debug_mode("error")`; scripted scenes that make a
      beam hit, a torpedo fly and hit, point defence shoot one down, a bay
      launch fighters and a shuttle capture a ship; 8 ships beside a
      configured black hole fleeing it while the player ship steers;
      `gen_asteroid_field` with 512 asteroids at radius 10 and 64
      `step_asteroid_field` steps (D once a step; ms per step), 8,192
      asteroids for D's time at window 32, D against its plain version on
      both fields' Morton order (1e-6, bitwise run to run); planet surfaces
      at 64x128 and 256x512 with craters and colors (ms per call); and the
      card against the CPU on the same draws: 2 chunks of 8 combat frames
      of 68 slots, 16 default frames (rows and paging equal) and 8
      asteroid steps (floats 1e-5, integer and bool fields equal).
   i. voxel landscapes: `kernel_probe.write_voxel_scene`'s config at the
      shipped config_voxels.txt sizes (512x512x64 voxels over the default
      128^2 x 32 mesh, the other `voxel` keys at their defaults): the
      load's time (the field, the flood fills, the top surface fused into
      the heightfield), the fused mesh's rise over the base terrain, and
      `app.run_ground` at the app's defaults (2,000 balls, 2 chained calls
      of 32 frames: ms per frame of the second call, launches per frame, B
      and D every frame, live); `VoxelCollider.rebuild` over the whole
      field (3,969 blocks) and a dirty rebuild, `marching_cubes_blocks`
      (12^2 blocks, cap 4,096), a brush and `settle_unanchored`, each
      timed; and a 32x32x16 landscape on a 32^2 mesh on the card against
      the CPU (field 1e-5; solid and outside masks, top surface, fused
      mesh and 8 frame rows equal).
   j. lighting at scripts/lighting_bench.py's scene and sizes (a floor
      cube and 60 spheres, the mesh at -0.6, the 32x128x128 light grid):
      1,048,576 sky rays a bake with the default `TraceParams` (batch
      65,536) and the production ones (compact, 8 then 4 samples a
      segment, batch 131,072), rays per second, two bakes of one seed
      bitwise equal, B in every bounce; one batch under the profiler (the
      device-busy share); the sky sweep (32 directions and the bounce) and
      the global sweep; 4 scene point lights of 65,536 rays; a platform
      delta on 65,536 recorded rays, moved A->B (its time) and back: from
      an empty volume the two deltas cancel to exactly 0, as does A->A;
      `BuildingIndirManager.for_building` at res 32 over a port-built
      3-floor interior, 8 slices of 8,192 rays; and a 32x32x16 grid on the
      card against the CPU on the same draws, the default and production
      parameters within rtol 3e-5, atol 1e-6, and the sky sweep 1e-5.
   k. the full-world build (`w3d_torch.full_world`, the port's counterpart
      of the JAX package's examples/full_world.py) at the example's sizes:
      `main` end to end (a 128^2 world eroded by 20,000 droplets through A,
      `num_cities` 2 of size 20 with interiors, walkers and a basement
      tunnel network, 32 cars over 30 steps, `trains` 2, 4 helicopters, a
      16-frame chained city frame with instanced models, trees, 2,000 balls
      over 5 frames of 4 substeps through B, C and D, a 512-ray bake
      through B, an 8-direction sweep at nz 16, a named star system, both
      PNGs read back): each section's time and launches and the stats line.
      The eroded map of the default draws holds one city site, so one
      city, no connector road and no trains are built; the city and
      traffic sections then run again on the uneroded map, where both
      cities, a connector route, the rail and both trains are built, card
      vs CPU.  A against its plain walk at the terrain's shape (20 batches
      of 1,024 droplets x 256 steps, bitwise); the uneroded terrain card vs
      CPU (bitwise); and `main` again on the CPU on the same draws, held
      against the card's own build: the stats, terrain, city, tunnels,
      first building, trees, star system and map image equal; walkers,
      traffic and the city frame 1e-5; physics 1e-5 with status equal; the
      bake per cell within rtol 3e-5, atol 1e-6, the sweep per cell 1e-5,
      sky energy and mean visibility within rtol 3e-5.
   l. a building session at the tiled app's city size (`build_city` on a
      128^2 flat map, one city, with interiors): tunnels and manholes and
      the walk-area clamp; street objects, perches on them and 32 chained
      city frames with 16 birds; a `BuildingPeopleSim` of 48 people for 64
      steps with its elevator calls; clocks; a furnished mall and a
      backrooms basement walked; a flooded basement; light switches feeding
      `BuildingIndirManager` (B in its bakes); pickups, a throw and 64
      ticks of zombie mode; spiders, snakes, flies and tank fish for 64
      ticks; model instances from config rows written to a temporary
      directory; grass and flowers on every resident tile of a phase-3g
      tile manager (64^2 tiles, 4 blades a cell) over tile (12, 8).  Each
      part timed and held on the card against the CPU (host results equal,
      floats 1e-5).
   m. scenery, weather, model formats and textures, on 3e's scene P (the
      128^2 mesh, 384 cobj slots): scenery at the loader's placement, the
      four generators and `scenery_cobjs`, then 4,096 objects over a
      seeded 512^2 mesh (`scenery_gen_ms`), card vs CPU bitwise; a snow
      map of 1,048,576 rays in 16 batches (`snow_rays_per_sec`), 2
      batches of 4,096 flakes on the same draws card vs CPU (cells,
      heights and the map bitwise) and a sky bake of 131,072 rays at
      3j's default `TraceParams` with the map as `snow_depth`;
      precipitation on 10,240 slots holding 2,000 balls, 512 drops a
      frame (rain and snow in turns) stepped by `step_objects` (4
      substeps, B and D), accumulated, retired and melted at 2.0 degrees
      for 64 frames (`precip_ms_per_frame`), and 8 frames of 1,024 slots
      card vs CPU (accumulation, rain and statuses equal, floats 1e-5);
      a 128^2 cloud layer at 32 times and the local wind at 10,000
      positions (1e-6); one 20,480-triangle mesh written in every format
      (OBJ, binary and ASCII STL and PLY, OFF, DAE, 3DS, glTF, GLB, FBX)
      and loaded (`model_load_ms`, host; each the OBJ's triangles), a DSL
      scene naming every format (its table equal to the OBJ scene's) and
      its narrow phase on the card (plain and kernel C against the CPU);
      `skin_vertices` of 65,536 vertices over 32 bones (`skin_ms`, 1e-6);
      the procedural textures at 256^2 (within 1 u8 level, the noise
      texture equal) and DXT1/DXT5 of them; a checkpoint of the 10,240
      slots from the card (bitwise) and the mesh and sim-state text
      files.  Each part's seconds print as `(part <s> s)`.
   3n. The multi-device layer (`w3d_torch/parallel/`, `lighting/parallel`,
      the sharded steps): four ranks spawned by `parallel.launch.run_ranks`,
      all on this card over gloo (collectives staged through the host; NCCL
      refuses two ranks on one card), the kernels built here first.  The
      sharded 10K frame (10,240 balls, 10 substeps, window 288, pairs every
      5th substep: D with `i_limit` = the 2,560-ball slab on every rank) for
      3 frames against single-rank `step_objects` (status and flags equal,
      positions and velocities within rtol 2e-4, atol 2e-5); the sharded
      tile step (256 tiles of 128^2, 64 a rank) bitwise against one call;
      the sharded combined step at `entry()`'s shapes (8 tiles, 2,048
      balls) against `combined_step`; the shadow chain over 16 tiles of
      128^2 (exact bitwise one scan of the strip, carry bitwise exact for
      axis-aligned lights); the AO halo context at halo 36; the sky bake on
      3j's scene, 65,536 rays a rank, bitwise run to run and bitwise the
      rank-order sum of four single-rank `trace_batch` chains on the same
      draws.  Then one rank over NCCL: the sharded frame and the bake
      against the unsharded calls.  Prints ms per sharded frame, tiles/s,
      rays/s and the bytes exchanged a frame, each labelled "4 ranks on one
      card, gloo through the host", and every rank's launches.
   3o. The agent-sharded city frame and the ship-sharded combat frame
      (`parallel/city`, `parallel/combat`), four gloo ranks on this card,
      then one rank over NCCL.  The city of 3g's `bench_live_tiled` world
      after its first chunk (64 cars and 128 pedestrians, 16 and 32 a rank;
      8 birds, 2 trains, 4 helicopters and the tower's 48 people
      replicated): one chunk of 32 chained frames on the chunk's draws,
      twice, bit for bit the single-rank `city_frames_chained`.  Combat at
      3h's scale point (the x8 defs: 1,248 ships in 1,560 slots, 390 a
      rank; a pool of 1,024, 256 a rank; 8 weapon slots), the fleets
      brought 0.17 closer: 32 chained frames, twice, bit for bit the
      single-rank `combat_frames_chained`; the first chunk counts the
      projectile spawns, fighter launches, PD shots, impacts and captures
      (each also where its other end lies on another rank) and needs each
      non-zero, the second (timed) counts nothing.  The same chunk with
      every weapon's damage 1.1 times as much (damages whose sums round
      by their order): shields and armor (the impact sums over the pool)
      within 1e-5 of the single-rank chain, every other field bit for
      bit; and how many of 1,560 one-hot column sums a rank's quarter
      rounds apart from the whole block, by `torch.sum` and by the
      row-order scan the frame uses (none).  A scripted
      boarding of a disabled frigate on rank 0 by a shuttle on rank 1
      always runs beside it.  The dry run's seven
      phases on the four ranks (`dryrun.run`).  Over NCCL, one rank: the
      dry run's seven phases, and phases 6-7 at the 4-rank sizes bit for
      bit the unsharded calls.  Prints ms per frame (median over ranks of
      the host clock between barriers), the bytes received a frame, and
      the single process's ms per frame in the same call.  The city and
      combat frames launch none of the kernels; the dry runs' phases 1-5
      launch A-D, counted in the kernels line.
   Prints time to first result, tiles/s and frames/s, each phase's seconds
   and the script's total, and fails if a kernel was never launched or a
   value is not finite.  D's launches in
   the kernels line include 3h's, and its entry carries a `universe` row
   (8,192 asteroids, window 32: device-only and plain ms, bound).
4. Each kernel against its plain PyTorch version on the card, at its
   path's shapes: max difference and mismatch counts; erosion and pairs
   also bitwise from run to run and at one ragged shape each (3 tiles of
   48x64 with 200 droplets; 4,097 ranks, window 300, `i_limit` 3,001);
   narrow and the substep also on the seven-shape scene (every shape
   group, dead padding slots), on wide tables of M = 536 and 1,616 slots
   (two and five of the kernels' 384-row shared-memory chunks) over the
   dense pile, and on the M = 112 and 80 scenes bitwise against a variant
   build whose chunks hold 64 rows; erosion also on the padded path's
   136^2 maps; the tile noise also at the origins of 3a's
   rate loop (x0 + 11 * 256 * 128, sine arguments past sinf's fast
   reduction); the substep glue's six kernels bitwise against their plain
   phases on the dense pile, dry, under a water map and on ice, each fed
   the plain phase before it (`respond` also with the pair pass's inputs),
   timed on the dry pile.  Times in turns (plain, kernel, kernel, plain,
   ...): the kernel device-only, a CUDA graph of 20 launches replayed
   between CUDA events; the plain version, CUDA events around
   back-to-back calls.  Beside each, its bound: the larger of the bytes
   it must move over 3.35 TB/s and the operations it does on these inputs
   over 67 TFLOP/s (float32); beside each, its floor: the same graph
   timer at one CTA's worth of work (128 objects for sample, narrow, the
   substep and the glue, 32 ranks for the pairs, one tile for the erosion
   walk and the tile noise), or at a (2, 8, 8) smoke grid, the launch plus
   fixed set-up.
5. The combined step and a small fused frame on a small input on the card
   against the same steps on the CPU (plain versions).

The line before the last is a JSON object with one entry per kernel; the
last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

NUM_TILES = 256
NUM_OBJS = 10000
SUBSTEPS = 10
WINDOW = 288
LIGHT_GRID = (32, 128, 128)   # (mesh_z, mesh_y, mesh_x), lighting/lmap.py
FLOOR_N = 128            # objects in B's, C's and G's floor runs: one CTA's worth
PAIRS_FLOOR_N = 32       # ranks in D's floor run: one CTA's worth
SMOKE_FLOOR = (2, 8, 8)  # F's floor grid
WIDE_COPIES = (8, 27)    # kernel_probe.wide_scene copies: M = 536 and 1,616
GROUND_OBJS = 2000       # app.py's --objects default for the ground loop
GROUND_CHAIN = 32        # app.py run_ground's frames per chained call
GROUND_DROPLETS = 512    # the tile path's droplet count, for gen_terrain
GROUND_WATER_REL = 0.09  # "water_h_off 0.09 0": a third of the map under water
# ops per unit of work for the bounds, counted from the kernel sources
# (adds, multiplies, divides, square roots, min/max, compares: one each);
# the erosion and pair counts are in w3d_torch/utils/kernel_probe.py
SAMPLE_OPS = 60          # per object: four taps, bilinear height, normal
COBJ_TEST_OPS = 20       # per object and live cobj slot
SUBSTEP_OBJ_OPS = 200    # per object: integrate, mesh, water, bounces
SIN_TERM_OPS = 20        # per table entry: one sinf and its argument
STENCIL_CELL_OPS = 17    # per smoke cell
TOLS = {"erosion": "bitwise equal to the plain version and across two runs",
        "sample": "heights within 2 ulp of the mesh scale, normals 1e-6",
        "narrow": "hit mask equal, pen 1e-5, winner fields 1e-5 on lanes "
                  "with argmax margin > 1e-4",
        "pairs": "1e-6, bitwise across two runs",
        "substep": "1e-5, status and flags equal",
        "tile_noise": "1e-3",
        "diffuse_smoke": "bitwise equal to the plain version"}
# the substep glue's kernels (ops/cuda/glue_kernel), under their phases' names
GLUE = ("advance", "contact", "respond", "apply_pairs", "take_rows", "age_objects")
TOLS.update(dict.fromkeys(GLUE, "bitwise equal to the plain phase, dry, in water "
                                "and on ice"))


SCENE_FRAMES = 64
SHARD_RANKS = 4
SHARD_OBJS = 10240       # the sharded frame's balls: 2,560 a rank
SHARD_RAYS = 65536       # the sharded bake's rays a rank


def log(*a):
    print(*a, flush=True)


def need(cond, what: str) -> None:
    """Fail the run unless `cond` holds."""
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def run_scene_phase(tmp: str, dev, kernels: dict, reset_counts, read_counts) -> dict:
    """Phase 3e in the directory `tmp`: scenes P, C and H and the card
    against the CPU.  Returns the metrics and the kernel launches."""
    from w3d_torch import app as APP
    from w3d_torch.export import heightmap_io as HIO
    from w3d_torch.models import world as WM
    from w3d_torch.ops import erosion as E
    from w3d_torch.ops.cuda import erosion_kernel as EK
    from w3d_torch.physics import cobjs as PC
    from w3d_torch.scene import loader as SL
    from w3d_torch.terrain import mesh as TM
    from w3d_torch.utils import kernel_probe as KP
    from w3d_torch.utils.checkpoint import ModmapJournal

    def write(name, text):
        path = os.path.join(tmp, name)
        with open(path, "w") as f:
            f.write(text)
        return path

    cfg_p = KP.write_ground_scene(tmp, "p", objects=GROUND_OBJS)
    cfg_c = KP.write_ground_scene(tmp, "c", platforms=False, objects=GROUND_OBJS)
    out = {"launches": {n: 0 for n in kernels}}

    def counted(label, required, fn):
        reset_counts()
        result = fn()
        torch.cuda.synchronize()
        c = read_counts(label, required)
        for n in c:
            out["launches"][n] += c[n]
        return result, c

    def app_rows(cfg, chain):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            scene = APP.run_ground(cfg, SCENE_FRAMES, GROUND_OBJS, chain=chain,
                                   device=dev)
        return scene, [json.loads(line) for line in buf.getvalue().splitlines()]

    def check_objects(label, st):
        for name in ("px", "py", "pz", "vx", "vy", "vz"):
            need(bool(torch.isfinite(getattr(st, name)).all()), f"{label}: {name} finite")
        live = int((st.status > 0).sum())
        need(live > GROUND_OBJS // 2 and int(st.time.min()) == SCENE_FRAMES,
             f"{label}: half the objects alive, every one aged {SCENE_FRAMES} frames")
        return live

    # scene P: the load (host work, the time to the first frame), then 64
    # frames of the per-frame path through the app
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sp = SL.load_scene(cfg_p, device=dev)
    torch.cuda.synchronize()
    load_p = time.perf_counter() - t0
    slots, live_c = sp.cobjs.size, int((sp.cobjs.shape != 0).sum())
    log(f"scene P: load_scene {load_p:.3f} s; {live_c} cobjs in {slots} slots, "
        f"{sp.platforms.size} platforms, {sp.triggers.x.shape[0]} triggers, "
        f"{len(sp.trees[0])} trees, {int(sp.scenery.valid.sum())} scenery objects, "
        f"material types {sp.mat_first}..{sp.table.radius.shape[0] - 1} "
        f"({[m.name for m in sp.sphere_mats.materials]}), parse skipped "
        f"{sp.parse.skipped}")
    need(sp.platforms.size == 2 and sp.triggers.x.shape[0] == 1 and 250 < live_c <= slots
         and not sp.parse.skipped and sp.mat_first > 0,
         "scene P: two platforms, one trigger, a few hundred cobjs, materials")
    (scene, rows), cp = counted("scene P app path", ("sample", "pairs"),
                                lambda: app_rows(cfg_p, GROUND_CHAIN))
    need(len(rows) == SCENE_FRAMES and "chained" not in rows[0],
         "scene P: the platform scene runs frame by frame")
    ms_p = statistics.median(r["ms"] for r in rows[SCENE_FRAMES // 2:])
    live_p = check_objects("scene P", scene.objects)
    travel = [round(float(v), 4) for v in scene.platforms.dist.cpu()]
    states = scene.platforms.state.tolist()
    log(f"scene P: {ms_p:.3f} ms per frame (median of frames 32-63, per-frame "
        f"path), kernel launches per frame "
        f"{ {n: c / SCENE_FRAMES for n, c in cp.items() if c} }, live {live_p} of "
        f"{GROUND_OBJS} (rows: {rows[-1]['live']}), player z {rows[-1]['player_z']}, "
        f"platform travel {travel}, states {states}")
    need(rows[-1]["live"] == live_p and travel[1] > 0.0,
         "scene P: the printed live count, the continuous platform moved")
    # the plain narrow phase at scene P's shapes, device-only
    st = scene.objects
    nin = (st.px, st.py, st.pz, scene.table.radius[st.otype.long()])
    narrow_ms = statistics.median(
        KP.GraphTimer(lambda: PC.deepest_hits(*nin, scene.cobjs)).time() for _ in range(5))
    log(f"scene P: ungrouped deepest_hits, N = {GROUND_OBJS}, M = {scene.cobjs.size} "
        f"slots: device-only {narrow_ms:.4f} ms (CUDA graph of 20), 4 a frame: "
        f"{100 * 4 * narrow_ms / ms_p:.1f}% of the frame's wall")

    # scene C: the chained path, 2 x 32 frames
    (scene, rows), cc = counted("scene C app path", ("sample", "pairs"),
                                lambda: app_rows(cfg_c, GROUND_CHAIN))
    need([r.get("chained") for r in rows] == [GROUND_CHAIN] * 2,
         "scene C: two chained calls of 32 frames")
    live_cc = check_objects("scene C", scene.objects)
    ms_c = rows[1]["ms"]
    log(f"scene C: {ms_c:.3f} ms per frame (second chained call of "
        f"{GROUND_CHAIN}), kernel launches per frame "
        f"{ {n: c / SCENE_FRAMES for n, c in cc.items() if c} }, live {live_cc} "
        f"(rows: {[r['live'] for r in rows]}), {scene.cobjs.size} slots")
    need(rows[-1]["live"] == live_cc, "scene C: the printed live count")

    # scene H: a seeded 128^2 16-bit PNG and a journal of three brushes,
    # eroded by 2,000 droplets (two batches through A)
    rg = np.random.default_rng(7)
    yy, xx = np.mgrid[0:128, 0:128] / 16.0
    f = sum(rg.uniform(0.5, 1.0) * np.sin(rg.uniform(0.5, 1.5) * xx + rg.uniform(0, 6))
            * np.cos(rg.uniform(0.5, 1.5) * yy + rg.uniform(0, 6)) for _ in range(5))
    img = ((f - f.min()) / (f.max() - f.min()) * 60000 + 2000).astype(np.uint16)
    HIO.write_png_gray(os.path.join(tmp, "hm.png"), img, bit_depth=16)
    journal = ModmapJournal()
    for brush in ((40, 50, 12, 0.3, 0), (90, 30, 20, -0.4, 1), (64, 100, 16, 0.25, 2)):
        journal.add(*brush)
    journal.save(os.path.join(tmp, "hm.modmap"))
    cfg_h = write("cfg_h.txt", "mesh_size 128 128 32\nrand_seed 1\n"
                  f"num_dodgeballs {GROUND_OBJS}\nread_heightmap 1\n"
                  "mesh_height_image hm.png\nread_hmap_modmap_filename hm.modmap\n"
                  "erosion_iters 2000\nwater_h_off -0.1 0\n")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sh, ch = counted("scene H load", ("erosion",), lambda: SL.load_scene(cfg_h, device=dev))
    load_h = time.perf_counter() - t0
    walk = EK.erosion_walk
    EK.erosion_walk = E._walk_batch
    try:
        href = SL.load_scene(cfg_h, device=dev)
    finally:
        EK.erosion_walk = walk
    flat = TM.terrain_from_heightmap(os.path.join(tmp, "hm.png"),
                                     sh.cfg.terrain_config()._replace(erosion_iters=0),
                                     sh.world, modmap=journal, device=dev)
    same = all(torch.equal(a, b) for a, b in zip(sh.terrain, href.terrain))
    deroded = float((sh.terrain.mesh_height - flat.mesh_height).abs().max())
    log(f"scene H: load_scene {load_h:.3f} s (PNG read, journal, 2,000 droplets "
        f"through A: {ch['erosion']} launches); A's map vs its plain walk "
        f"bitwise {same}, max |eroded - uneroded| {deroded:.3g}")
    need(same and deroded > 1e-3 and ch["erosion"] == 2,
         "scene H: " + TOLS["erosion"].split(" and ")[0] + ", two batches")

    # scene P at 32^2 with 64 balls, the card against the CPU: the fBm
    # generator (elementwise, bitwise on both devices; the sine generator's
    # einsum sums in another order on the card) with the water raised into
    # the map
    cfg_s = KP.write_ground_scene(tmp, "s", objects=64, small=True)
    on = {d: SL.load_scene(cfg_s, device=d) for d in ("cpu", dev)}

    def tensors(s):
        return [(f"{part}.{name}", v) for part in ("terrain", "cobjs", "table", "objects",
                                                   "env", "ripples", "light_grid",
                                                   "platforms", "triggers", "scenery")
                for name, v in getattr(s, part)._asdict().items() if v is not None]

    unequal = [k for (k, a), (_, b) in zip(tensors(on["cpu"]), tensors(on[dev]))
               if not torch.equal(a, b.cpu())]
    for _ in range(4):
        for d in on:
            on[d] = WM.ground_frame(on[d])
    a, b = on["cpu"].objects, on[dev].objects
    worst = max(float((getattr(a, n) - getattr(b, n).cpu()).abs().max())
                for n in ("px", "py", "pz", "vx", "vy", "vz"))
    exact = all(torch.equal(getattr(a, n), getattr(b, n).cpu()) for n in ("status", "flags"))
    plat = max(float((x.double() - y.cpu().double()).abs().max())
               for x, y in zip(on["cpu"].platforms, on[dev].platforms))
    live_s = (int((a.status > 0).sum()), int((b.status > 0).sum()))
    log(f"scene P at 32^2, 64 balls, card vs CPU: load bitwise {not unequal} "
        f"(unequal: {unequal}); 4 ground_frames: max diff {worst:.3g}, platforms "
        f"{plat:.3g}, status and flags equal {exact}, live {live_s}")
    need(not unequal and worst <= 1e-5 and plat <= 1e-5 and exact
         and live_s[0] == live_s[1], "scene P at 32^2, card vs CPU: load bitwise, "
         "frames 1e-5, status and flags equal")
    out.update(scene_load_s=load_p, scene_load_s_heightmap=load_h,
               ground_ms_per_frame_scene=ms_p, ungrouped_narrow_ms_scene=narrow_ms,
               ground_ms_per_frame_scene_chained=ms_c)
    return out


GAME_FRAMES = 64         # game mode at the app's defaults: 64 frames,
GAME_SMILEYS = 8         # app.py's --smileys default
GAME_EROSION = 1024      # droplets eroding scene P at load (one batch through A)
FORCED_FRAMES = 48       # the scripted match of two smileys, if needed
VALLEY_FRAMES = 8        # ground frames over the valley water
VALLEY_RAIN = 0.05       # rain per cell collected into the basins (scene units)
SMALL_GAME = (64, 4, 8)  # objects, smileys and frames of the card-vs-CPU game


def run_game_phase(tmp: str, dev, kernels: dict, reset_counts, read_counts) -> dict:
    """Phase 3f in the directory `tmp`: FPS game mode at the app's defaults
    on scene P (eroded at load through A), a scripted match if the default
    draws fire no projectile, no hitscan shot or no explosion, valley water
    with ground frames over it, and the card against the CPU at 32^2.
    Returns the metrics and the kernel launches."""
    from w3d_torch import app as APP
    from w3d_torch.gameplay import ai as AI
    from w3d_torch.gameplay import game as GG
    from w3d_torch.models import world as WM
    from w3d_torch.ops import ray as RAY
    from w3d_torch.physics import destroy as PD
    from w3d_torch.physics import groups as PG
    from w3d_torch.physics import movable as MV
    from w3d_torch.physics import particles as PPT
    from w3d_torch.physics import step as PS
    from w3d_torch.physics import types as PT
    from w3d_torch.physics.cobjs import empty_cobjs, COLL_CUBE
    from w3d_torch.scene import loader as SL
    from w3d_torch.utils import kernel_probe as KP
    from w3d_torch.utils.constants import WorldConst
    from w3d_torch.water import valleys as WV

    out = {"launches": {n: 0 for n in kernels}}
    fired = {"projectile": 0, "hitscan": 0}
    fire_weapon, fire_hitscan = GG.fire_weapon, GG.fire_hitscan

    def counted_weapon(state, free_slots, *a, **k):
        fired["projectile"] += min(GG.WEAPONS[a[0]][5], len(free_slots))
        return fire_weapon(state, free_slots, *a, **k)

    def counted_hitscan(*a, **k):
        fired["hitscan"] += 1
        return fire_hitscan(*a, **k)

    def rows_of(fn, *a, **k):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            result = fn(*a, **k)
        return result, [json.loads(line) for line in buf.getvalue().splitlines()]

    def add_counts(c):
        for n in c:
            out["launches"][n] += c[n]

    cfg_g = KP.write_ground_scene(tmp, "g", objects=GROUND_OBJS, erosion_iters=GAME_EROSION)
    GG.fire_weapon, GG.fire_hitscan = counted_weapon, counted_hitscan
    try:
        # game mode at the app's defaults: load (A) and 64 frames
        GG.reset_fire_stream(0)
        reset_counts()
        scene, rows = rows_of(APP.run_ground, cfg_g, GAME_FRAMES, GROUND_OBJS, game=True,
                              num_smileys=GAME_SMILEYS, device=dev)
        torch.cuda.synchronize()
        cg = read_counts("game path (load and 64 frames)", ("erosion", "sample", "pairs"))
        add_counts(cg)
        need(len(rows) == GAME_FRAMES and rows[0]["mode"] == "ground-game",
             "game mode: one row a frame")
        ms_game = statistics.median(r["ms"] for r in rows[GAME_FRAMES // 2:])
        per_frame = {n: c / GAME_FRAMES for n, c in cg.items() if c and n != "erosion"}
        booms = sum(r["explosions"] for r in rows)
        live = int((scene.objects.status > 0).sum())
        for name in ("px", "py", "pz", "vx", "vy", "vz"):
            need(bool(torch.isfinite(getattr(scene.objects, name)).all()),
                 f"game mode: {name} finite")
        log(f"game mode, scene P eroded by {GAME_EROSION} droplets, {GROUND_OBJS} "
            f"objects, {GAME_SMILEYS} smileys: {ms_game:.3f} ms per frame (median of "
            f"frames 32-63), kernel launches per frame {per_frame}, A at load "
            f"{cg['erosion']}; shots {rows[-1]['shots']} (projectiles spawned "
            f"{fired['projectile']}, hitscan {fired['hitscan']}), explosions {booms}, "
            f"smileys alive {rows[-1]['smileys']}, live objects {rows[-1]['live']}")
        need(cg["erosion"] >= 1 and per_frame.get("sample", 0) > 0
             and per_frame.get("pairs", 0) > 0 and rows[-1]["live"] == live,
             "game mode: A at load, B and D every frame, the printed live count")
        # the AI step alone on the scene's cobjs (every shape family of
        # 72 line-of-sight rays over the slots): host clock around
        # synchronised calls, and device-only (it syncs nothing, so a CUDA
        # graph holds it)
        sm0 = APP.GameDraws().smileys(GAME_SMILEYS, dev)
        d0 = APP.GameDraws().ai(0, GAME_SMILEYS, dev)
        ai_host = []
        for _ in range(11):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            AI.step_smileys_ai(sm0, d0, scene.cobjs)
            torch.cuda.synchronize()
            ai_host.append((time.perf_counter() - t0) * 1e3)
        ai_ms = statistics.median(ai_host[1:])
        ai_dev = statistics.median(KP.GraphTimer(
            lambda: AI.step_smileys_ai(sm0, d0, scene.cobjs)).time() for _ in range(3))
        log(f"game mode: the AI step ({GAME_SMILEYS} smileys, {scene.cobjs.size} slots) "
            f"{ai_ms:.3f} ms host clock, {ai_dev:.4f} ms device-only (CUDA graph of 20): "
            f"{100 * ai_ms / ms_game:.1f}% of the game frame's wall")
        out.update(ground_ms_per_frame_game=ms_game, game_shots=rows[-1]["shots"],
                   game_explosions=booms, game_ai_ms=ai_ms, game_ai_device_ms=ai_dev)

        if not (fired["projectile"] and fired["hitscan"] and booms):
            # a scripted match over the scene's floor plate (top z = 0), at
            # the first spots of a grid that see each other: smiley A (team
            # 0) fires rockets at B (team 1, a bat, out of its reach) 0.5
            # away, aimed down at B's feet so they strike the plate (a cobj
            # collision); C (team 0) fires an m16 at B from the side (a
            # hitscan ray at A would pass A's muzzle and shoot its rockets
            # down); a tenth of the objects dead (free slots)
            sc = SL.load_scene(cfg_g, num_objects=GROUND_OBJS, device=dev)
            st = sc.objects
            sc.objects = st._replace(status=torch.where(
                torch.arange(GROUND_OBJS, device=dev) >= GROUND_OBJS * 9 // 10, 0, st.status))
            gy, gx = torch.meshgrid(torch.arange(-2.5, 1.51, 0.25, device=dev),
                                    torch.arange(-2.5, 1.91, 0.25, device=dev), indexing="ij")
            ax, ay = gx.reshape(-1), gy.reshape(-1)
            by, cx = ay + 0.5, ax + 0.6
            za, zb = torch.full_like(ax, 0.35), torch.full_like(ax, 0.07)
            seen = (AI.los_visible(sc.cobjs, ax, ay, za, ax, by, zb)
                    & AI.los_visible(sc.cobjs, ax, by, zb, ax, ay, za)
                    & AI.los_visible(sc.cobjs, cx, by, za, ax, by, zb)
                    & ((ax.abs() > 0.8) | ((by - 0.25).abs() > 1.2)))   # off the hole
            need(bool(seen.any()), "scripted match: three spots in sight of each other")
            k = int(torch.nonzero(seen)[0])
            spots = torch.stack([torch.stack([ax[k], ay[k]]), torch.stack([ax[k], by[k]]),
                                 torch.stack([cx[k], by[k]])])

            class Scripted(APP.GameDraws):
                def smileys(self, n, device):
                    sm = AI.make_ai_smileys(spots[:, 0], spots[:, 1], [0, 1, 0], device=device)
                    return sm._replace(
                        z=torch.tensor([0.3, 0.02, 0.3], device=device),
                        weapon=torch.tensor([GG.WEAPON_INDEX[w] for w in ("rocket", "bbbat", "m16")],
                                            dtype=torch.int32, device=device))

                def ai(self, frame, n, device):
                    d = super().ai(frame, n, device)
                    return d._replace(cadence=torch.ones_like(d.cadence))  # keep weapons

            before = dict(fired)
            reset_counts()
            _, frows = rows_of(APP._run_ground_game, sc, None, FORCED_FRAMES, 3,
                               draws=Scripted(5))
            torch.cuda.synchronize()
            add_counts(read_counts("scripted match", ("sample", "pairs")))
            fbooms = sum(r["explosions"] for r in frows)
            log(f"scripted match (rocket, bat, m16 at {spots.tolist()}, {FORCED_FRAMES} "
                f"frames): shots "
                f"{frows[-1]['shots']} (projectiles spawned "
                f"{fired['projectile'] - before['projectile']}, hitscan "
                f"{fired['hitscan'] - before['hitscan']}), explosions {fbooms}, smileys "
                f"alive {frows[-1]['smileys']}, live objects {frows[-1]['live']}")
            booms += fbooms
        need(fired["projectile"] > 0 and fired["hitscan"] > 0 and booms > 0,
             "game mode: a projectile, a hitscan shot and an explosion")
    finally:
        GG.fire_weapon, GG.fire_hitscan = fire_weapon, fire_hitscan

    # valley water on scene P's mesh: rain collected into the basins; the
    # labels and `fill_valleys` (which labels the mesh itself, as
    # `with_valley_water` does) timed apart
    mesh = scene.env.mesh_height
    my, mx = mesh.shape

    def timed_ms(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        return r, (time.perf_counter() - t0) * 1e3

    labels, label_ms = timed_ms(lambda: WV.watershed_labels(mesh))
    vols = WV.add_rain_volume(torch.zeros(my * mx, device=dev), labels, my, mx,
                              VALLEY_RAIN, scene.world)
    (lab, zval, water, wet), fill_ms = timed_ms(lambda: WV.fill_valleys(mesh, vols, scene.world))
    wet_share = float(wet.float().mean())
    nbasins = int(torch.unique(lab).numel())
    scene = WM.with_valley_water(scene, vols)
    reset_counts()
    t0 = time.perf_counter()
    for _ in range(VALLEY_FRAMES):
        scene = WM.ground_frame(scene)
    live = int((scene.objects.status > 0).sum())
    valley_ms = (time.perf_counter() - t0) * 1e3 / VALLEY_FRAMES
    cv = read_counts("valley-water frames", ("sample", "pairs"))
    add_counts(cv)
    in_water = int(((scene.objects.flags & PT.FL_IN_WATER) != 0).sum())
    log(f"valley water on scene P's mesh ({nbasins} basins, rain {VALLEY_RAIN} a cell): "
        f"watershed_labels {label_ms:.3f} ms, fill_valleys {fill_ms:.3f} ms, wet share "
        f"{100 * wet_share:.1f}%; {VALLEY_FRAMES} ground frames over it {valley_ms:.3f} ms "
        f"a frame, launches per frame "
        f"{ {n: c / VALLEY_FRAMES for n, c in cv.items() if c} }, live {live}, in water "
        f"{in_water}")
    need(0.0 < wet_share < 1.0 and bool(torch.isfinite(scene.objects.pz).all()),
         "valley water: part of the map wet, objects finite")
    out.update(fill_valleys_ms=fill_ms, watershed_labels_ms=label_ms, valley_wet_share=wet_share)

    # the card against the CPU at 32^2: game mode with the same draws, the
    # valley fill, and the small modules on small inputs
    nobj, nsm, nfr = SMALL_GAME
    cfg_s = KP.write_ground_scene(tmp, "gs", objects=nobj, small=True)

    class Armed(APP.GameDraws):
        """Smileys within 0.6 of the middle, m16 and rocket in turns, their
        weapons kept: hitscan shots and projectiles in the first frames."""
        def smileys(self, n, device):
            x, y, team = AI.draw_spawn(n, self._gen(0), spread=0.6)
            sm = AI.make_ai_smileys(x, y, team, device=device)
            return sm._replace(weapon=torch.tensor(
                [GG.WEAPON_INDEX[("m16", "rocket")[k % 2]] for k in range(n)],
                dtype=torch.int32, device=device))

        def ai(self, frame, n, device):
            d = super().ai(frame, n, device)
            return d._replace(cadence=torch.ones_like(d.cadence))

    def armed(d):
        """The loaded 32^2 scene with a third of its objects dead (free
        slots) and a grenade at slot 0 whose timer runs out in the first
        frame (an explosion among the smileys), then the game loop."""
        sc = SL.load_scene(cfg_s, num_objects=nobj, device=d)
        st, i = sc.objects, torch.arange(nobj, device=d)
        gren, first = PT.type_id("GRENADE"), i == 0
        sc.objects = st._replace(
            status=torch.where((i >= nobj // 3) & (i < 2 * nobj // 3), 0, st.status),
            otype=torch.where(first, gren, st.otype),
            time=torch.where(first, int(sc.table.lifetime[gren]) - 2, st.time),
            px=torch.where(first, 0.2, st.px), py=torch.where(first, 0.0, st.py))
        return APP._run_ground_game(sc, None, nfr, nsm, draws=Armed(5))

    # the app from the config (the default draws), then the armed scene
    res, armed_fired = {}, {}
    GG.fire_weapon, GG.fire_hitscan = counted_weapon, counted_hitscan
    try:
        for d in ("cpu", dev):
            GG.reset_fire_stream(0)
            res[d] = rows_of(APP.run_ground, cfg_s, nfr, nobj, game=True, num_smileys=nsm,
                             device=d)
            GG.reset_fire_stream(0)
            before = dict(fired)
            res["armed", d] = rows_of(armed, d)
            armed_fired[d] = {k: fired[k] - before[k] for k in fired}
    finally:
        GG.fire_weapon, GG.fire_hitscan = fire_weapon, fire_hitscan
    keys = ("shots", "explosions", "smileys", "live")
    worst, exact, same_rows = 0.0, True, True
    for ka, kb in (("cpu", dev), (("armed", "cpu"), ("armed", dev))):
        (a, ra), (b, rb) = res[ka], res[kb]
        a, b = a.objects, b.objects
        worst = max([worst] + [float((getattr(a, n) - getattr(b, n).cpu()).abs().max())
                               for n in ("px", "py", "pz", "vx", "vy", "vz", "health")])
        exact &= all(torch.equal(getattr(a, n), getattr(b, n).cpu())
                     for n in ("status", "flags", "otype", "time"))
        same_rows &= [[r[k] for k in keys] for r in ra] == [[r[k] for k in keys] for r in rb]
    ra, rarm = res["cpu"][1], res["armed", dev][1]
    armed_booms = sum(r["explosions"] for r in rarm)
    need(rarm[-1]["shots"] > 0 and armed_booms > 0 and armed_fired[dev]["projectile"] > 0
         and armed_fired[dev]["hitscan"] > 0 and armed_fired[dev] == armed_fired["cpu"],
         "game mode at 32^2, armed: projectiles, hitscan shots and an explosion on both devices")
    vout = {d: WV.fill_valleys(res[d][0].env.mesh_height,
                               WV.add_rain_volume(torch.zeros(32 * 32, device=d),
                                                  WV.watershed_labels(res[d][0].env.mesh_height),
                                                  32, 32, VALLEY_RAIN, res[d][0].world),
                               res[d][0].world) for d in ("cpu", dev)}
    valley_bitwise = all(torch.equal(x, y.cpu()) for x, y in zip(vout["cpu"][:3], vout[dev][:3]))

    def small_modules(d):
        """local wind, movable push and settle, one step of each particle
        pool and one group spawn on seeded inputs, on device `d`."""
        rg = np.random.default_rng(12)
        t = lambda v: torch.as_tensor(np.asarray(v, np.float32), device=d)
        w = WorldConst(mesh_x=32, mesh_y=32)
        mesh32 = t(0.2 * rg.standard_normal((32, 32)))
        p3 = [t(rg.uniform(-3.5, 3.5, 256)) for _ in range(2)] + [t(rg.uniform(-0.5, 1.5, 256))]
        o = list(PS.local_wind_field(*p3, t([0.4, -0.2, 0.1]), mesh32, w, -1.0, 2.0,
                                     t_offset=1.3, seed=3))
        c = empty_cobjs(8, device=d)
        lo = np.array([[0, 0, 0], [1.005, 0, 0], [0, 0, 1.2], [3, 3, 0.5]], np.float32)
        hi = lo + np.array([[1, 1, 1], [1, 1, 1], [1, 1, 0.5], [0.5, 0.5, 0.5]], np.float32)
        p1, p2 = c.p1.clone(), c.p2.clone()
        p1[:4], p2[:4] = t(lo), t(hi)
        c = c._replace(shape=torch.where(torch.arange(8, device=d) < 4, COLL_CUBE, 0)
                       .to(torch.int32), p1=p1, p2=p2,
                       is_movable=torch.arange(8, device=d) < 4)
        c = MV.push_movable_cobjs(c, t([0.04, 0.0, 0.03, -0.05] + [0] * 4),
                                  t([0.01, 0.0, 0.0, 0.02] + [0] * 4))
        c = MV.settle_movable_cobjs(c, 0.0)
        o += [c.p1, c.p2]
        g = torch.Generator().manual_seed(4)
        n = 32
        b8 = PPT.spawn_bubbles(PPT.make_bubbles(n, device=d), *(t(rg.uniform(-1, 1, 24))
                                                                 for _ in range(5)))
        o += list(PPT.step_bubbles(b8, t(0.025), t(0.2), t(10.0), 4.0)[0])
        cl = PPT.spawn_clouds(PPT.make_clouds(n, device=d),
                              *(t(rg.uniform(0, 0.2, 24)) for _ in range(10)))
        o += list(PPT.step_clouds(cl, t(0.025), t([0.1, 0.0, 0.05]), t(-10.0), 1.0))
        fi = PPT.spawn_fires(PPT.make_fires(n, device=d),
                             *(t(rg.uniform(0, 0.2, 24)) for _ in range(4)))
        fo, sd, sm = PPT.step_fires(fi, PPT.draw_fires(n, g, device=d), t(0.025),
                                    t([0.1, 0.0, 0.0]), t(-10.0),
                                    torch.zeros((32, 32), device=d), w)
        o += list(fo) + [sd, sm]
        de = PPT.spawn_decals(PPT.make_decals(n, device=d),
                              *(t(rg.uniform(0, 1, 24)) for _ in range(8)),
                              torch.zeros(24, dtype=torch.int32, device=d),
                              torch.full((24,), 3, dtype=torch.int32, device=d))
        o += list(PPT.step_decals(de))
        table = PT.make_type_table(device=d)
        st = PS.make_state(rg.uniform(-1, 1, (96, 3)), rg.normal(0, 1, (96, 3)),
                           np.full(96, PT.type_id("BALL")), table)
        st = st._replace(status=t(rg.uniform(size=96) > 0.5).to(torch.int32),
                         time=t(rg.integers(0, 50, 96)).to(torch.int32))
        o += list(PG.spawn_into_group(st, table, PG.draw_group(96, g, device=d),
                                      PT.type_id("SAND"), 16))
        # a blast over the four cubes, all destroyable, and their fragments
        st = GG.apply_blast(st, 0.5, 0.5, 0.5, 1.6, 40.0)
        c, hit = PD.destroy_coll_objs(c, PD.make_destroy_state(c, [PD.DESTROYABLE] * 8),
                                      0.5, 0.5, 0.5, 1.6)
        centers = 0.5 * (c.p1 + c.p2)[hit.cpu().numpy().nonzero()[0]].cpu().numpy()
        o += [c.shape, hit.int()] + list(PD.spawn_fragments(st, table, centers, seed=77))
        # stepped heightfield rays (the mesh sampler over [N, S] points)
        rays = [t(rg.uniform(-3, 3, 256)), t(rg.uniform(-3, 3, 256)), t(rg.uniform(0.5, 2, 256))]
        dirs = [t(rg.uniform(-1, 1, 256)), t(rg.uniform(-1, 1, 256)), t(rg.uniform(-1, -0.2, 256))]
        hit_h, t_h = RAY.ray_heightfield(*rays, *dirs, t(np.full(256, 8.0)), mesh32, w)
        return o + [hit_h.int(), t_h]

    smods = [small_modules(d) for d in ("cpu", dev)]
    mod_err = max(float((x.double() - y.cpu().double()).abs().max())
                  for x, y in zip(*smods))
    log(f"game mode at 32^2, {nobj} objects, {nsm} smileys, {nfr} frames, card vs CPU, "
        f"from the config and armed: objects max diff {worst:.3g}, status, flags, types "
        f"and ages equal {exact}, rows (shots, explosions, smileys, live) equal {same_rows} "
        f"(shots {[r['shots'] for r in ra]}; armed {[r['shots'] for r in rarm]}, projectiles "
        f"{armed_fired[dev]['projectile']}, hitscan {armed_fired[dev]['hitscan']}, "
        f"explosions {armed_booms}); fill_valleys labels, levels and water bitwise "
        f"{valley_bitwise}; wind, movable, particle pools, group spawn, blast, destroy, "
        f"fragments and heightfield rays max diff {mod_err:.3g}")
    need(worst <= 1e-5 and exact and same_rows and valley_bitwise and mod_err <= 1e-6,
         "game mode at 32^2, card vs CPU: objects 1e-5, status, flags, types, ages and "
         "rows equal, valleys bitwise, small modules 1e-6")
    return out


TILED_CHUNK = 32         # bench_live_tiled's chunk (app.py --chunk default)
TILED_CHUNKS = 6         # bench_live_tiled's chunks; the metric is the median of 3-6
TILED_EROSION = 512      # droplets per tile of the eroding tile manager (2 batches)
TILED_EROSION_TILE = 128


def run_tiled_phase(dev, kernels: dict, reset_counts, read_counts) -> dict:
    """Phase 3g: tiled mode on the card.  `app.run_tiled` at the app's and
    `bench_live_tiled`'s settings (seed 1, 6 chunks of 32 frames, the
    camera moving 0.8 a frame), the bench's own loop for
    `live_tiled_city_ms_per_frame`, a chunk under the profiler, a recorded
    session replayed on the card, an eroding tile manager at tile 128 (A,
    and `update` checked to never wait for the card), A bitwise against its
    plain walk at the tile paths' shapes, and a short session on the card
    against the CPU.  Returns the metrics and the kernel launches."""
    from w3d_torch import app as APP
    from w3d_torch import convert
    from w3d_torch.ops import erosion as E
    from w3d_torch.ops.cuda import erosion_kernel as EK
    from w3d_torch.terrain import mesh as TM
    from w3d_torch.terrain import tiles as TL
    from w3d_torch.utils import profile_step as PROF
    from w3d_torch.utils.constants import WorldConst

    out = {"launches": {n: 0 for n in kernels}}

    def rows_of(fn, *a, **k):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            result = fn(*a, **k)
        return result, [json.loads(line) for line in buf.getvalue().splitlines()]

    def add_counts(c):
        for n in c:
            out["launches"][n] += c[n]

    # the app: 6 chunks of 32 frames, every row's keys, B twice a frame
    frames = TILED_CHUNK * TILED_CHUNKS
    reset_counts()
    w, rows = rows_of(APP.run_tiled, frames, 1, chunk=TILED_CHUNK, device=dev)
    torch.cuda.synchronize()
    ct = read_counts("tiled app path (6 chunks of 32 frames)", ("sample",))
    add_counts(ct)
    need(len(rows) == TILED_CHUNKS and all(r["mode"] == "tiled" for r in rows),
         "tiled app: one row a chunk")
    need(ct["sample"] == 2 * frames + 1 and ct["erosion"] == 0,
         "tiled app: B twice a frame (butterflies, fish) and once for the fish spawn; A never")
    row_ms = statistics.median(sorted(r["ms"] for r in rows[2:]))
    created = sum(r["created"] for r in rows)
    deleted = sum(r["deleted"] for r in rows)
    for part in (w.cars, w.peds, w.city.people) + tuple(w.fauna):
        for v in part:
            if isinstance(v, torch.Tensor) and v.is_floating_point():
                need(bool(torch.isfinite(v).all()), "tiled app: state finite")
    log(f"tiled app, seed 1, {TILED_CHUNKS} x {TILED_CHUNK} frames: {row_ms:.3f} ms per "
        f"frame (rows' median of chunks 3-6, fauna included), {len(w.tile_mgr.tiles)} "
        f"tiles resident, {created} created, {deleted} deleted, fauna {rows[-1]['fauna']}, "
        f"building people by activity {rows[-1]['bldg_people_acts']}, launches per frame "
        f"{ {n: c / frames for n, c in ct.items() if c} }")

    # bench_live_tiled's loop on the port: step_chunk alone, 6 chunks of 32
    tw = PROF.tiled_world(dev, chunk=TILED_CHUNK)
    cam, times = 0.0, []
    for _ in range(TILED_CHUNKS):
        t0 = time.perf_counter()
        tw.step_chunk(cam, 0.0, frames=TILED_CHUNK)
        cam += 0.8 * TILED_CHUNK
        times.append((time.perf_counter() - t0) / TILED_CHUNK)
    times = sorted(times[2:])
    live_ms = times[len(times) // 2] * 1e3
    # the chained city frames and the fauna queue without waiting for the
    # card: one chunk of each with syncs raising (the chunk's draws are
    # made and copied before)
    from w3d_torch.city import city_step as CS
    from w3d_torch.veg import animals as VA
    d = tw.draws.city(tw.frame, TILED_CHUNK, tw)
    wl = WorldConst(mesh_x=64, mesh_y=64)
    tile = tw.tile_mgr.tiles[tw.tile_mgr.camera_tile(cam - 0.8 * TILED_CHUNK, 0.0)]
    mesh = tile.zvals[:64, :64].contiguous()
    fd = APP.TiledDraws(1)
    fa = (VA.make_animals(fd.fauna_birds(16, dev)), VA.make_butterflies(fd.butterflies(16, wl, dev)),
          VA.gen_fish(fd.fish(32, wl, dev), mesh, APP.FAUNA_WATER_Z, wl))
    fdr = fd.fauna(0, TILED_CHUNK, 16, 16, 32, dev)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        CS.city_frames_chained(tw.city, tw.road_graph, tw.ped_nav, tw.pads, tw.perches,
                               TILED_CHUNK, d, rail=tw.rail)
        VA.step_tiled_fauna(*fa, fdr, mesh, wl, APP.FAUNA_WATER_Z, 0.0, 0.0,
                            frames=TILED_CHUNK)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    prof = PROF.trace_tiled(dev, [], chunk=TILED_CHUNK)
    busy = prof["busy_ms"] / prof["wall_ms"]
    log(f"live_tiled_city_ms_per_frame {live_ms:.3f} (bench_live_tiled's loop: "
        f"step_chunk, median of chunks 3-6, ms per frame; chunks {[round(t * 1e3, 3) for t in times]}); "
        f"a chunk with the fauna under the profiler: {prof['wall_ms']:.1f} ms wall, device "
        f"busy {prof['busy_ms']:.2f} ms ({100 * busy:.1f}%), {prof['kernels']:.0f} kernels; "
        f"{TILED_CHUNK} chained city frames and {TILED_CHUNK} fauna frames ran with syncs "
        f"raising")
    out.update(live_tiled_city_ms_per_frame=live_ms, tiled_app_ms_per_frame=row_ms,
               tiled_chunk_device_busy_share=busy,
               tiled_chunk_kernels=prof["kernels"])

    # record 4 chunks on the card, replay them there (another seed given)
    with tempfile.TemporaryDirectory() as tmp:
        journal = os.path.join(tmp, "session.uel")
        w1, _ = rows_of(APP.run_tiled, 4 * 16, 3, chunk=16, record=journal, device=dev)
        w2, _ = rows_of(APP.run_tiled, 4 * 16, 999, chunk=16, replay=journal, device=dev)
    need(w2.frame_hashes == w1.frame_hashes and len(set(w1.frame_hashes)) == 4,
         "tiled replay on the card: the recorded hashes, bit for bit")
    log(f"tiled record/replay on the card, 4 chunks of 16: hashes equal "
        f"({w1.frame_hashes[-1]})")

    # an eroding tile manager at tile 128 along a camera path: A twice per
    # creating update; one deferred update run with syncs raising
    wl = WorldConst(mesh_x=64, mesh_y=64)
    tm = TL.TileManager(cfg=TM.TerrainConfig(mesh_seed=1), world=wl,
                        tile_size=TILED_EROSION_TILE, erosion_iters_tt=TILED_EROSION,
                        device=dev)
    tile_w = TILED_EROSION_TILE * wl.dx
    reset_counts()
    upd_ms, host_ms = [], []
    for i in range(8):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        new, _ = tm.update(0.5 * tile_w * i, 0.0)
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        if new:
            upd_ms.append((time.perf_counter() - t0) * 1e3)
            host_ms.append((t1 - t0) * 1e3)
    ce = read_counts("eroding tile manager (tile 128, 512 droplets)", ("erosion",))
    add_counts(ce)
    need(ce["erosion"] == 2 * len(upd_ms), "eroding tiles: A twice per creating update")
    torch.cuda.set_sync_debug_mode("error")
    try:
        tm.update(0.5 * tile_w * 8, 0.0, max_tiles_per_frame=3)
        tm.update(0.5 * tile_w * 9, 0.0, max_tiles_per_frame=3)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    tm.flush()
    z = torch.stack([t.zvals for t in tm.tiles.values()])
    need(bool(torch.isfinite(z).all()), "eroding tiles: heights finite")
    log(f"eroding tile manager, tile {TILED_EROSION_TILE}, {TILED_EROSION} droplets: "
        f"{statistics.median(upd_ms):.3f} ms per creating update to the card's finish "
        f"(median of {len(upd_ms)}; host part {statistics.median(host_ms):.3f} ms), "
        f"A {ce['erosion']} launches; two deferred updates ran with syncs raising")
    out.update(eroding_tile_update_ms=statistics.median(upd_ms))

    # A at the tile paths' shapes (72^2 and 136^2 padded maps, 256 droplets,
    # 96 steps) bitwise against its plain walk on the same inputs
    gen = torch.Generator().manual_seed(11)
    for stride in (64, TILED_EROSION_TILE):
        tmx = TL.TileManager(cfg=TM.TerrainConfig(mesh_seed=1), world=wl, tile_size=stride,
                             device=dev)
        txs = torch.arange(8, dtype=torch.float32, device=dev)
        h = 36
        zv = TL.tile_context(tmx.table, txs, txs * 0, tmx._zmax_t, tmx.cfg, wl,
                             stride)[:, h:h + stride, h:h + stride]
        hm = torch.nn.functional.pad(zv[:, None], (E.PAD,) * 4, mode="replicate")[:, 0].contiguous()
        xi, zi = E.droplet_starts(TL.EROSION_BATCH, stride, stride, pad=E.PAD, device=dev)
        xi = xi.expand(8, -1).contiguous()
        zi = zi.expand(8, -1).contiguous()
        ang = E.draw_angles(TL.EROSION_BATCH, TL.EROSION_BATCH, TL.EROSION_STEPS, gen,
                            device="cpu")[0].to(dev)
        p6 = E.pack_params(E.ErosionParams(
            erode_amount=1.0, water_plane_z=tmx._wpz_t, half_dxy=wl.half_dxy,
            zmin=-tmx._zmax_t, zmax=tmx._zmax_t, rock_thresh=TM.clip_hd1(tmx.cfg)), dev)
        k1 = EK.erosion_walk(hm, xi, zi, ang, p6)
        k2 = EK.erosion_walk(hm, xi, zi, ang, p6)
        plain = E._walk_batch(hm, xi, zi, ang, p6)
        n = hm.shape[-1]
        need(torch.equal(k1, k2) and torch.equal(k1, plain),
             f"A at {n}^2 tile maps: bitwise equal to its plain walk and run to run")
        log(f"A on 8 padded tile maps of {n}^2, {TL.EROSION_BATCH} droplets, "
            f"{TL.EROSION_STEPS} steps: bitwise equal to its plain walk and run to run "
            f"(max |delta| {float(k1.abs().max()):.4g})")

    # a short session on the card against the CPU: the same draws (CPU
    # generators), 2 chunks of 8 frames.  The tiles' noise sums in another
    # order on the card (cuBLAS), so the fauna, which samples the tile
    # mesh, is also held on one mesh: the CPU's camera tile on both devices
    res = {}
    for d in ("cpu", dev):
        res[d] = rows_of(APP.run_tiled, 16, 3, chunk=8, device=d)
    (wc, rc), (wg, rg) = res["cpu"], res[dev]
    strip = lambda rows: [{k: v for k, v in r.items() if k not in ("ms", "hash")} for r in rows]
    same_rows = strip(rc) == strip(rg)

    def diff(a, b):
        worst, exact = 0.0, True
        for x, y in zip(_leaves(convert.to_numpy(a)), _leaves(convert.to_numpy(b))):
            if x.dtype.kind == "f":
                worst = max(worst, float(np.abs(x - y).max()) if x.size else 0.0)
            else:
                exact &= bool(np.array_equal(x, y))
        return worst, exact
    city_d, city_exact = diff(wc.city, wg.city)
    sess_fauna_d, sess_fauna_exact = diff(wc.fauna, wg.fauna)
    tz = max(float((wc.tile_mgr.tiles[k].zvals - wg.tile_mgr.tiles[k].zvals.cpu()).abs().max())
             for k in wc.tile_mgr.tiles)
    from w3d_torch.veg import animals as VA
    wl = WorldConst(mesh_x=64, mesh_y=64)
    mesh = wc.tile_mgr.tiles[(0, 0)].zvals[:64, :64].contiguous()
    draws = APP.TiledDraws(3)
    fauna = {}
    for d in ("cpu", dev):
        m = mesh.to(d)
        f = (VA.make_animals(draws.fauna_birds(16, d)),
             VA.make_butterflies(draws.butterflies(16, wl, d)),
             VA.gen_fish(draws.fish(32, wl, d), m, APP.FAUNA_WATER_Z, wl))
        fauna[d] = VA.step_tiled_fauna(*f, draws.fauna(0, 16, 16, 16, 32, d), m, wl,
                                       APP.FAUNA_WATER_Z, 0.3, 0.1, frames=16)
    # per population: a fish's cruise speed sqrt(vx^2 + vy^2) of
    # (0.002 cos a, 0.002 sin a) rounds onto either side of fish_t's drag
    # threshold (speed > FISH_SPEED), so one ulp of cos or sin decides
    # whether it slows by 4% a frame: 1.3e-3 of drift after 16 frames
    per = [diff(a, b) for a, b in zip(fauna["cpu"], fauna[dev])]
    fauna_exact = all(e for _d, e in per)
    log(f"tiled session, 2 chunks of 8, card vs CPU: rows equal but ms and hash {same_rows}; "
        f"city state floats max diff {city_d:.3g}, integer fields equal {city_exact}; tile "
        f"heights max diff {tz:.3g}; the session's fauna (over each device's tiles) max "
        f"diff {sess_fauna_d:.3g}, kinds and flags equal {sess_fauna_exact}; 16 fauna "
        f"frames over one mesh: birds {per[0][0]:.3g}, butterflies {per[1][0]:.3g}, fish "
        f"{per[2][0]:.3g}, kinds and flags equal {fauna_exact}; hashes card "
        f"{rg[-1]['hash']} CPU {rc[-1]['hash']}")
    need(same_rows and city_exact and city_d <= 1e-5 and tz <= 1e-4 and fauna_exact
         and per[0][0] <= 1e-5 and per[1][0] <= 1e-5 and per[2][0] <= 2e-3,
         "tiled session, card vs CPU: rows and integer fields equal, city floats 1e-5, "
         "tile heights 1e-4; over one mesh birds and butterflies 1e-5, fish 2e-3")
    out.update(tiled_card_vs_cpu_city_max_diff=city_d,
               tiled_card_vs_cpu_fauna_max_diff=[d for d, _e in per])
    return out


UNIVERSE_CHUNK = 32      # app.py's --chunk default
UNIVERSE_CHUNKS = 6      # the metric is the median of chunks 3-6, as in 3g
ASTEROIDS = 512          # gen_asteroid_field's default field
ASTEROID_RADIUS = 10.0   # the JAX package's field radius
ASTEROID_STEPS = 64
ASTEROIDS_BIG = 8192     # D's time at this path's window
ASTEROID_WINDOW = 32     # step_asteroid_field's window
SCALE_MULTIPLIER = 8     # 1,248 ships: the [n, n] targeting at a size the card works at


def run_universe_phase(dev, kernels: dict, reset_counts, read_counts) -> dict:
    """Phase 3h: universe mode on the card.  `app.run_universe` without
    ship defs (64 built-in ships) and on the written defs (156 ships in
    195 slots, the full weapon model) and at 8 times their fleets; one
    defs chunk under the profiler and one with syncs raising; scripted
    scenes for each weapon event; the hazards and the player; the asteroid
    field through D; the planet surfaces; and the card against the CPU.
    Returns the metrics, the kernel launches and D's universe row."""
    from w3d_torch import app as APP
    from w3d_torch import convert
    from w3d_torch.models import world as WM
    from w3d_torch.ops.cuda import pairs_kernel as PK
    from w3d_torch.physics import step as PS
    from w3d_torch.universe import asteroids as UA, combat as UCB, gen as UG
    from w3d_torch.universe import ship_config as USC, ships as USH, surface as USF
    from w3d_torch.utils import kernel_probe as KP
    from w3d_torch.utils import profile_step as PROF

    out = {"launches": {n: 0 for n in kernels}}

    def rows_of(fn, *a, **k):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            result = fn(*a, **k)
        return result, [json.loads(line) for line in buf.getvalue().splitlines()]

    def add_counts(c):
        for n in c:
            out["launches"][n] += c[n]

    def finite(state, what):
        for v in _leaves(convert.to_numpy(state)):
            if v.dtype.kind == "f":
                need(bool(np.isfinite(v[np.abs(v) < 1e17]).all()), f"{what}: finite")

    frames = UNIVERSE_CHUNK * UNIVERSE_CHUNKS
    tmp = tempfile.mkdtemp()
    try:
        # the default path: no ship defs, 64 built-in ships, no combat
        reset_counts()
        w, rows = rows_of(APP.run_universe, frames, 1, os.path.join(tmp, "none.txt"),
                          chunk=UNIVERSE_CHUNK, device=dev)
        add_counts(read_counts("universe default path (6 chunks of 32 frames)", ()))
        need(len(rows) == UNIVERSE_CHUNKS and rows[0]["cells_created"] == 343
             and all(r["cells_created"] % 49 == 0 for r in rows[1:])
             and sum(r["cells_created"] for r in rows[1:]) > 0,
             "universe default path: 343 cells at start, 49 per cell crossing")
        finite(w.fleet, "universe default fleet")
        default_ms = statistics.median(r["ms"] for r in rows[2:])
        first_s = rows[0]["ms"] * rows[0]["chained"] / 1e3
        created = sum(r["cells_created"] for r in rows)
        freed = sum(r["cells_freed"] for r in rows)
        log(f"universe default path, 64 ships, {UNIVERSE_CHUNKS} x {UNIVERSE_CHUNK} frames: "
            f"{default_ms:.3f} ms per frame (rows' median of chunks 3-6), first chunk "
            f"{first_s:.3f} s, cells created {created} and freed {freed}, galaxies "
            f"generated {w.state.num_generated()} of "
            f"{sum(len(c.galaxies) for c in w.state.cells.values())}, ships alive "
            f"{rows[-1]['ships_alive']}")
        out.update(universe_ms_per_frame_default=default_ms,
                   time_to_first_universe_frame_s=first_s)

        # the defs path: 156 ships in 195 slots, the full weapon model
        udir = os.path.join(tmp, "universe")
        os.makedirs(udir)
        path = KP.write_ship_defs(os.path.join(udir, "ship_defs.txt"))
        reset_counts()
        w, rows = rows_of(APP.run_universe, frames, 1, path, chunk=UNIVERSE_CHUNK, device=dev)
        add_counts(read_counts("universe defs path (6 chunks of 32 frames)", ()))
        cs = w.combat
        n_slots, slots = cs.cool.shape
        need(n_slots == 195 and slots == 8 and cs.proj.px.shape[0] == 1024,
             "universe defs path: 156 ships in 195 slots, 8 weapon slots, a pool of 1,024")
        finite(cs, "universe defs combat state")
        defs_ms = statistics.median(r["ms"] for r in rows[2:])
        alive = rows[-1]["ships_alive"]
        proj = int(cs.proj.alive.sum())
        caps = int(cs.captured.sum())
        spawned = int(cs.fleet.alive[156:].sum())
        ct = w.combat_tables
        ammo_used = (ct.slot_ammo0[cs.fleet.cls.long()] - cs.ammo)[:156]
        wid = ct.slot_wid[cs.fleet.cls.long()][:156]
        bays = int(((wid == 20) & (ammo_used > 0)).sum())
        torps = int(((wid == 15) & (ammo_used > 0)).sum())
        log(f"universe defs path, {n_slots} slots, {UNIVERSE_CHUNKS} x {UNIVERSE_CHUNK} "
            f"frames: {defs_ms:.3f} ms per frame (rows' median of chunks 3-6), ships alive "
            f"{[r['ships_alive'] for r in rows]}, projectiles live {proj}, captures {caps}, "
            f"fighters alive in the reserve slots {spawned}, carriers that launched {bays}, "
            f"armageddons that fired torpedoes {torps}, attacked ships "
            f"{int(cs.fleet.attacked.sum())}")
        need(not bool(cs.fleet.alive[:156].all()) and bool(cs.fleet.attacked.any()),
             "universe defs path: a battle (ships of the fleets died)")
        out.update(universe_ms_per_frame=defs_ms, universe_defs_ships_alive=alive,
                   universe_defs_projectiles_live=proj, universe_defs_captures=caps)

        # one chunk under the profiler, one chunk with syncs raising
        prof = PROF.trace_universe(dev, [], tmp)
        busy = prof["busy_ms"] / prof["wall_ms"]
        w2 = PROF.universe_world(dev, tmp)
        w2.step_chunk((0.0, 0.0, 0.0), frames=UNIVERSE_CHUNK)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            w2.step_chunk((16.0, 0.0, 0.0), frames=UNIVERSE_CHUNK)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        log(f"universe defs chunk of {UNIVERSE_CHUNK} under the profiler: "
            f"{prof['wall_ms']:.1f} ms wall, device busy {prof['busy_ms']:.2f} ms "
            f"({100 * busy:.1f}%), {prof['kernels'] / UNIVERSE_CHUNK:.0f} kernels per frame; "
            f"a chunk ran with syncs raising")
        out.update(universe_chunk_device_busy_share=busy,
                   universe_kernels_per_frame=prof["kernels"] / UNIVERSE_CHUNK)

        # the scale point: 8 times the fleets (1,248 ships in 1,560 slots)
        big = KP.write_ship_defs(os.path.join(udir, "ship_defs_x8.txt"), SCALE_MULTIPLIER)
        w, rows = rows_of(APP.run_universe, frames, 1, big, chunk=UNIVERSE_CHUNK, device=dev)
        need(w.combat.cool.shape[0] == 1560, "universe scale point: 1,560 slots")
        finite(w.combat, "universe scale point")
        big_ms = statistics.median(r["ms"] for r in rows[2:])
        log(f"universe scale point, 1,248 ships in 1,560 slots: {big_ms:.3f} ms per frame, "
            f"ships alive {[r['ships_alive'] for r in rows]}, projectiles live "
            f"{int(w.combat.proj.alive.sum())}, captures {int(w.combat.captured.sum())}")
        out.update(universe_ms_per_frame_x8=big_ms)

        # scripted scenes: each weapon event, on the card
        defs = USC.parse_ship_defs(path)
        ct = UCB.build_combat_tables(defs, device=dev)
        tbl = USC.ship_class_table(defs)
        gen = torch.Generator().manual_seed(5)

        def scene(rows_, frames_, ct_=ct, pad=0, **fields):
            cls = np.array([r[0] for r in rows_], np.int32)
            pos = np.array([r[2] for r in rows_], np.float32)
            z = np.zeros(len(rows_), np.float32)
            f = USH.FleetState(px=pos[:, 0], py=pos[:, 1], pz=pos[:, 2], vx=z, vy=z, vz=z,
                               cls=cls, align=np.array([r[1] for r in rows_], np.int32),
                               armor=tbl[cls, 2], shields=tbl[cls, 3], cooldown=z,
                               alive=np.ones(len(rows_), bool))._replace(**fields)
            s = UCB.make_combat_state(UCB.pad_fleet(f, len(rows_) + pad), ct_, pool_size=64)
            hist = []
            for _ in range(frames_):
                d = UCB.draw_combat(1, *s.cool.shape, gen)
                s = UCB.step_combat(s, UCB.CombatDraws(*(t[0].to(dev) for t in d)), ct_)
                hist.append(s)
            return hist

        def only(cls_id, wid, ct_=ct):
            sw = ct_.slot_wid.clone()
            sw[cls_id] = torch.where(sw[cls_id] == wid, sw[cls_id], 0)
            return ct_._replace(slot_wid=sw)

        none = np.array([USH.AI_ATT_ENEMY, USH.AI_NONE], np.int32)
        beam = scene([(3, 0, (0, 0, 0)), (2, 1, (0.03, 0, 0))], 1, only(3, 6), ai=none)
        beam_hit = float(beam[0].fleet.shields[1]) < tbl[2, 3]
        torp = scene([(9, 0, (0, 0, 0)), (2, 1, (0.05, 0, 0))], 60, only(9, 15), ai=none)
        torp_flew = int(torp[2].proj.alive.sum()) >= 1 and float(torp[2].fleet.shields[1]) == tbl[2, 3]
        torp_hit = float(torp[-1].fleet.shields[1]) < tbl[2, 3]
        pd = scene([(9, 0, (0, 0, 0)), (2, 1, (0.04, 0, 0))]
                   + [(28, 1, (0.04 + 0.004 * k, 0.004, 0)) for k in range(4)], 24,
                   only(28, 17, only(9, 15)))
        pd_fired = any(bool((s.cool[2:, 0] > 0).any()) for s in pd)
        pd_saved = float(pd[-1].fleet.shields[1]) == tbl[2, 3]
        bay = scene([(8, 0, (0, 0, 0)), (2, 1, (0.25, 0, 0))], 12, only(8, 20), pad=8)
        launched = int(bay[-1].fleet.alive[2:].sum())
        gap = 0.8 * UCB.BOARD_REACH * (tbl[17, 7] + tbl[2, 7])
        board = scene([(2, 1, (gap, 0, 0)), (17, 0, (0, 0, 0))], 24,
                      ai=np.array([USH.AI_NONE, USH.AI_ATT_ENEMY], np.int32),
                      shields=np.float32([0.0, tbl[17, 3]]),
                      armor=np.float32([0.2 * tbl[2, 2], tbl[17, 2]]))
        captured = int(board[-1].fleet.align[0]) == 0 and bool(board[-1].captured[0])
        log(f"scripted scenes on the card: beam hit on frame 1 {beam_hit}; torpedo in flight "
            f"on frame 3 with no damage yet {torp_flew}, a hit by frame 60 {torp_hit}; point "
            f"defence fired {pd_fired} and the target kept its shields {pd_saved}; bay "
            f"launched {launched} fighters; boarding capture {captured}")
        need(beam_hit and torp_flew and torp_hit and pd_fired and pd_saved and launched >= 1
             and captured, "scripted universe scenes: beam, torpedo, point defence, bay, capture")

        # hazards and the player: a fleet parked beside a configured black
        # hole flees it; the player ship under controls
        fl = USH.make_fleet(USH.draw_fleet(8, torch.Generator().manual_seed(2), num_teams=1,
                                           spread=0.01, device=dev))
        hw = WM.UniverseWorld(state=UG.UniverseState(), fleet=fl,
                              black_holes=[((0.3, 0.0, 0.0), 0.02)],
                              player_ship=USH.make_player_ship(1, device=dev))
        hw.step_chunk((0.0, 0.0, 0.0), frames=2,
                      controls=[(USH.MOVE_FRONT, 2.0, True), (USH.MOVE_LEFT, 1.0, False)])
        hw.step_chunk((0.0, 0.0, 0.0), frames=2, controls=[(USH.MOVE_FRONT, 1.0, False)])
        flee = bool((hw.fleet.vx <= 0.0).all())
        player_x = float(hw.player_ship.px)
        log(f"hazards: 8 ships beside a black hole all flee it (-x) {flee}; the player ship "
            f"moved to x {player_x:.4f}")
        need(flee and player_x > 0.0, "universe hazards: ships flee the hole, the player moves")

        # the asteroid field: D once a step
        agen = torch.Generator().manual_seed(9)
        field = UA.gen_asteroid_field(UA.draw_asteroid_field(ASTEROIDS, agen, device=dev),
                                      ASTEROID_RADIUS)
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        for _ in range(ASTEROID_STEPS):
            field = UA.step_asteroid_field(field, ASTEROID_RADIUS, 1.0)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3 / ASTEROID_STEPS
        ca = read_counts(f"asteroid field ({ASTEROIDS} asteroids, {ASTEROID_STEPS} steps)",
                         ("pairs",))
        add_counts(ca)
        need(ca["pairs"] == ASTEROID_STEPS, "asteroid field: D once a step")
        finite(field, "asteroid field")
        bf = UA.gen_asteroid_field(UA.draw_asteroid_field(ASTEROIDS_BIG, agen, device=dev),
                                   ASTEROID_RADIUS)
        big_step_ms = KP.events_ms(lambda: UA.step_asteroid_field(bf, ASTEROID_RADIUS, 1.0),
                                   launches=8)

        # D on the field's Morton order against its plain version
        def d_inputs(f):
            order = torch.sort(PS.morton_key(f.px, f.py, 0.05 * ASTEROID_RADIUS,
                                             2.0 * ASTEROID_RADIUS), stable=True).indices
            c = [t[order].contiguous() for t in (f.px, f.py, f.pz, f.vx, f.vy, f.vz, f.radius)]
            return (*c, c[6] ** 3, torch.ones_like(c[0]), torch.ones_like(c[0], dtype=torch.bool))
        pair_err = 0.0
        for f in (field, bf):
            ins = d_inputs(f)
            k1 = PK.banded_pairs(*ins, window=ASTEROID_WINDOW)
            k2 = PK.banded_pairs(*ins, window=ASTEROID_WINDOW)
            ref = PS.banded_pair_collisions(*ins, window=ASTEROID_WINDOW)
            err = max(float((a - b).abs().max()) for a, b in zip(k1, ref))
            need(err <= 1e-6 and all(torch.equal(a, b) for a, b in zip(k1, k2)),
                 "D on the asteroid field: " + TOLS["pairs"])
            pair_err = max(pair_err, err)
        ins = d_inputs(bf)
        valid, hits = KP.pair_work(*ins[:3], ins[6], ins[9], ASTEROID_WINDOW)
        timer = KP.GraphTimer(lambda: PK.banded_pairs(*ins, window=ASTEROID_WINDOW))
        plain = lambda: PS.banded_pair_collisions(*ins, window=ASTEROID_WINDOW)
        d_ms, d_plain = [], []
        for i in range(4):
            d_ms.append(timer.time())
            d_plain.append(KP.events_ms(plain, 1, reps=1, warm=i == 0))
        bound = KP.pairs_bound(ASTEROIDS_BIG, valid, hits)
        out["pairs_universe"] = dict(
            n=ASTEROIDS_BIG, window=ASTEROID_WINDOW, ms=statistics.median(d_ms),
            plain_ms=statistics.median(d_plain), bound_ms=bound[0], bound_by=bound[1],
            launches=ca["pairs"], max_abs_err=pair_err, valid_pairs=valid, contacts=hits)
        log(f"asteroid field: {ASTEROIDS} asteroids, {ASTEROID_STEPS} steps, "
            f"{step_ms:.3f} ms per step (host clock, synchronised), D {ca['pairs']} launches; "
            f"{ASTEROIDS_BIG} asteroids {big_step_ms:.3f} ms per step (CUDA events); D at "
            f"window {ASTEROID_WINDOW} on {ASTEROIDS_BIG}: {out['pairs_universe']['ms']:.4f} ms "
            f"device-only, plain {out['pairs_universe']['plain_ms']:.4f} ms, bound "
            f"{bound[0]:.5f} ms by {bound[1]} ({valid} pair tests, {hits} contacts); max "
            f"|kernel - plain| {pair_err:.3g} on both fields, bitwise run to run")
        out.update(asteroid_step_ms=step_ms, asteroid_step_ms_8192=big_step_ms)

        # the planet surfaces
        surf = {}
        for nlat, nlon in ((64, 128), (256, 512)):
            def gen_s():
                h, m = USF.gen_planet_surface(12345, nlat, nlon, water_level=0.1, device=dev)
                return USF.surface_color(USF.add_craters(h, seed=7), m, 30.0)
            col = gen_s()
            need(col.shape == (3, nlat, nlon) and bool(torch.isfinite(col).all()),
                 "planet surface: finite colors")
            ts_ = []
            for _ in range(5):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                gen_s()
                torch.cuda.synchronize()
                ts_.append((time.perf_counter() - t0) * 1e3)
            surf[f"{nlat}x{nlon}"] = statistics.median(ts_)
        log(f"planet surfaces (gen_planet_surface + 24 craters + colors), ms per call "
            f"(median of 5, host clock, synchronised): {surf}")
        out.update(planet_surface_ms=surf)

        # the card against the CPU: combat frames of a small armed fleet,
        # the paging, asteroid steps
        jf, _t, _o, _n = USH.fleet_from_defs(defs, APP.UniverseDraws(1).fleet_positions)
        sel = np.r_[0:30, 55:85, 156:164]
        small = USH.FleetState(*(None if v is None else np.asarray(v)[sel]
                                 for v in UCB.pad_fleet(jf, 164)))
        small = small._replace(px=np.where(small.align == 5, small.px - 0.2,
                                           small.px).astype(np.float32))
        res = {}
        for d_ in ("cpu", dev):
            ctd = UCB.build_combat_tables(defs, device=d_)
            s = UCB.make_combat_state(small, ctd, pool_size=128)
            draws = APP.UniverseDraws(1)
            for k in range(2):
                s = UCB.combat_frames_chained(s, draws.combat(8 * k, 8, 68, 8, d_), 8, ctd)
            res[d_] = convert.to_numpy(s)
        worst, exact = 0.0, True
        for a, b in zip(_leaves(res["cpu"]), _leaves(res[dev])):
            if a.dtype.kind == "f":
                fin = np.isfinite(a)
                exact &= bool(np.array_equal(fin, np.isfinite(b)))
                worst = max(worst, float(np.abs(a[fin] - b[fin]).max()) if fin.any() else 0.0)
            else:
                exact &= bool(np.array_equal(a, b))
        page = {}
        for d_ in ("cpu", dev):
            wd, rws = rows_of(APP.run_universe, 16, 1, os.path.join(tmp, "none.txt"), chunk=8,
                              device=d_)
            page[d_] = (wd, [{k: v for k, v in r.items() if k != "ms"} for r in rws])
        paging_equal = page["cpu"][1] == page[dev][1] and \
            list(page["cpu"][0].state.cells) == list(page[dev][0].state.cells) and \
            page["cpu"][0].state.num_generated() == page[dev][0].state.num_generated()
        fleet_d = max(float(np.abs(a - b).max()) for a, b in zip(
            _leaves(convert.to_numpy(page["cpu"][0].fleet)),
            _leaves(convert.to_numpy(page[dev][0].fleet))) if a.dtype.kind == "f")
        fc = UA.gen_asteroid_field(UA.draw_asteroid_field(ASTEROIDS, torch.Generator()
                                                          .manual_seed(4), device="cpu"),
                                   ASTEROID_RADIUS)
        fg = UA.AsteroidField(*(t.to(dev) for t in fc))
        for _ in range(8):
            fc = UA.step_asteroid_field(fc, ASTEROID_RADIUS, 1.0)
            fg = UA.step_asteroid_field(fg, ASTEROID_RADIUS, 1.0)
        ast_d = max(float((a.cpu() - b).abs().max()) for a, b in zip(fg, fc))
        log(f"universe, card vs CPU: 2 chunks of 8 combat frames on 68 slots: floats max diff "
            f"{worst:.3g}, integer and bool fields equal {exact}; 16 default frames: rows "
            f"and paging equal {paging_equal}, fleet max diff {fleet_d:.3g}; 8 asteroid "
            f"steps max diff {ast_d:.3g}")
        need(exact and worst <= 1e-5 and paging_equal and fleet_d <= 1e-5 and ast_d <= 1e-5,
             "universe, card vs CPU: integer fields and paging equal, floats 1e-5")
        out.update(universe_card_vs_cpu_max_diff=max(worst, fleet_d, ast_d))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


VOXEL_SHAPE = (64, 512, 512)   # config_voxels.txt's grid (zsize, ysize, xsize)
VOXEL_FRAMES = 64        # 2 chained calls of 32 at the app's defaults
VOXEL_SMALL_FRAMES = 8   # the 32^2 card-vs-CPU run, frame by frame


def run_voxel_phase(dev, kernels: dict, reset_counts, read_counts) -> dict:
    """Phase 3i: a voxel landscape at the shipped config_voxels.txt sizes
    (`kernel_probe.write_voxel_scene`: 512x512x64 voxels over the default
    128^2 x 32 mesh) through `load_scene` and `app.run_ground` at the
    app's defaults; the collider rebuild, the block marching cubes and a
    brush edit with `settle_unanchored` over the same field; and the small
    landscape on the card against the CPU.  Returns the metrics and the
    kernel launches."""
    from w3d_torch import app as APP
    from w3d_torch.scene import loader as SL
    from w3d_torch.terrain import mesh as TM
    from w3d_torch.utils import kernel_probe as KP
    from w3d_torch.voxel import collide as VC, edit as VE, grid as VG, mc256 as M256

    out = {"launches": {n: 0 for n in kernels}}

    def app_rows(path, frames, objects, chain, device):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            scene = APP.run_ground(path, frames, objects, chain=chain, device=device)
        return scene, [json.loads(line) for line in buf.getvalue().splitlines()]

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        return r, time.perf_counter() - t0

    tmp = tempfile.mkdtemp()
    try:
        path = KP.write_voxel_scene(tmp, objects=GROUND_OBJS)
        reset_counts()
        scene, load_s = timed(lambda: SL.load_scene(path, device=dev))
        load_c = read_counts("voxel scene load", ())
        vox = scene.voxel
        vp = SL.voxel_params_from_config(scene.cfg)
        need(tuple(vox.shape) == VOXEL_SHAPE and bool(torch.isfinite(vox.values).all()),
             "voxel scene: a finite 512x512x64 field")
        solid = float((vox.values < vp.isolevel).float().mean())
        tcfg = scene.cfg.terrain_config()._replace(mesh_seed=scene.cfg.rand_seed)
        base = TM.gen_terrain(tcfg, scene.world, device=dev).mesh_height
        rise = scene.terrain.mesh_height - base
        need(float(rise.min()) >= 0.0 and float(rise.max()) > 0.0,
             "voxel scene: the fused heightfield rises over the base terrain")
        log(f"voxel scene: load_scene {load_s:.3f} s (512x512x64 voxels, solid share "
            f"{solid:.3f}); fused mesh rise over the base terrain: max "
            f"{float(rise.max()):.3f}, mean {float(rise.mean()):.3f}, columns raised "
            f"{int((rise > 0).sum())} of {rise.numel()}")

        # the app loop at its defaults: 2 chained calls of 32 frames
        reset_counts()
        (scene2, rows), _ = timed(lambda: app_rows(path, VOXEL_FRAMES, GROUND_OBJS,
                                                   GROUND_CHAIN, dev))
        c = read_counts("voxel app path (load + 64 frames)", ("sample", "pairs"))
        per_frame = {n: (c[n] - load_c[n]) / VOXEL_FRAMES for n in c if c[n] - load_c[n]}
        for n in c:
            out["launches"][n] += c[n] + load_c[n]
        st = scene2.objects
        for name in ("px", "py", "pz", "vx", "vy", "vz"):
            need(bool(torch.isfinite(getattr(st, name)).all()), f"voxel app: {name} finite")
        live = int((st.status > 0).sum())
        need(len(rows) == 2 and rows[-1]["live"] == live and live > GROUND_OBJS // 2
             and per_frame.get("sample", 0) > 0 and per_frame.get("pairs", 0) > 0,
             "voxel app: two chained calls, half the balls alive, B and D every frame")
        ms = rows[1]["ms"]
        log(f"voxel app: {ms:.3f} ms per frame (second chained call of {GROUND_CHAIN}), "
            f"first call {rows[0]['ms']:.3f} ms per frame, launches per frame {per_frame}, "
            f"live {live} of {GROUND_OBJS}, player z {rows[-1]['player_z']}")

        # the collider over the whole field, then a dirty-block rebuild
        vc = VC.VoxelCollider(vp, spacing=vox.vsz[0], origin=vox.lo_pos, device=dev)
        _, rebuild_s = timed(lambda: vc.rebuild(vox.values))
        ntri = vc.num_tris
        dirty = vc.dirty_blocks_for_edit(0.0, 0.0, 0.2)
        _, dirty_s = timed(lambda: vc.rebuild(vox.values, dirty))
        nblocks = ((VOXEL_SHAPE[1] - 1) // 8) * ((VOXEL_SHAPE[2] - 1) // 8)
        need(ntri > 0 and vc.num_tris == ntri and len(vc.tris) == nblocks,
             "voxel collider: triangles in 3,969 blocks, a dirty rebuild keeps them")
        (mv, mvalid, mcount), mc_s = timed(lambda: M256.marching_cubes_blocks(
            vox.values.permute(2, 1, 0), vp.isolevel, num_blocks=vp.num_blocks,
            tri_cap=4096))
        kept = int(mvalid.sum())
        need(kept > 0 and kept <= int(mcount.sum()) and bool(torch.isfinite(mv).all()),
             "voxel marching cubes: finite triangles within the block budgets")
        log(f"voxel collider: rebuild {1e3 * rebuild_s:.1f} ms, {ntri} triangles in "
            f"{len(vc.tris)} blocks of 8^2 columns; dirty rebuild of {len(dirty)} blocks "
            f"{1e3 * dirty_s:.1f} ms; marching_cubes_blocks ({vp.num_blocks}^2 blocks, cap "
            f"4,096): {1e3 * mc_s:.1f} ms, {kept} triangles kept of {int(mcount.sum())} "
            f"(blocks over budget {int((mcount > 4096).sum())})")

        # a brush carves a hole, then the unanchored chunks settle
        def edit():
            v = VE.apply_brush(vox.values, vox.lo_pos, vox.vsz, (0.5, -0.5, 1.0), 0.6, -2.0,
                               VE.VB_SHAPE_QUADRATIC)
            return VE.settle_unanchored(v, vp.isolevel)
        (settled, steps), edit_s = timed(edit)
        left = int(VE.falling_mask(settled, vp.isolevel).sum())
        need(bool(torch.isfinite(settled).all()) and (left == 0 or int(steps) == 64),
             "voxel edit: settled (nothing left unanchored, or every tick used)")
        log(f"voxel edit: brush + settle_unanchored {1e3 * edit_s:.1f} ms, {int(steps)} "
            f"drop ticks, unanchored voxels left {left}")
        out.update(voxel_scene_load_s=load_s, ground_ms_per_frame_voxel=ms,
                   voxel_collider_rebuild_ms=1e3 * rebuild_s, voxel_collider_tris=ntri,
                   voxel_marching_cubes_ms=1e3 * mc_s, voxel_brush_settle_ms=1e3 * edit_s)

        # the small landscape on the card and on the CPU
        small = KP.write_voxel_scene(tmp, small=True, objects=64)
        sc, sg = SL.load_scene(small, device="cpu"), SL.load_scene(small, device=dev)
        fd = float((sg.voxel.values.cpu() - sc.voxel.values).abs().max())
        iso = SL.voxel_params_from_config(sc.cfg).isolevel
        masks = (torch.equal(sg.voxel.values.cpu() < iso, sc.voxel.values < iso)
                 and torch.equal(VG.classify_outside(sg.voxel.values, iso).cpu(),
                                 VG.classify_outside(sc.voxel.values, iso)))
        surf = (torch.equal(VG.top_surface(sg.voxel, iso).cpu(), VG.top_surface(sc.voxel, iso))
                and torch.equal(sg.terrain.mesh_height.cpu(), sc.terrain.mesh_height))
        _, rc = app_rows(small, VOXEL_SMALL_FRAMES, 64, 1, "cpu")
        _, rg = app_rows(small, VOXEL_SMALL_FRAMES, 64, 1, dev)
        strip = lambda rows: [{k: v for k, v in r.items() if k != "ms"} for r in rows]
        log(f"voxel 32^2, card vs CPU: field max diff {fd:.3g}, solid and outside masks "
            f"equal {masks}, top surface and fused mesh equal {surf}, "
            f"{VOXEL_SMALL_FRAMES} frame rows equal {strip(rg) == strip(rc)}")
        need(fd <= 1e-5 and masks and surf and strip(rg) == strip(rc),
             "voxel 32^2, card vs CPU: field 1e-5; masks, surfaces and rows equal")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


LIGHT_RAYS = 1 << 20          # scripts/lighting_bench.py's rays per bake
PLATFORM_RAYS = 65536         # recorded rays of the platform delta
INDIR_SLICE = 8192            # rays per building-lighting slice


def run_lighting_phase(dev, kernels: dict, reset_counts, read_counts) -> dict:
    """Phase 3j: the lighting bakes at scripts/lighting_bench.py's scene and
    sizes (the default world's 32x128x128 light grid, a floor cube and 60
    spheres, the mesh at -0.6): 1,048,576 sky rays with the default
    `TraceParams` and with the production ones, twice each from one seed
    (bitwise equal), one batch under the profiler, both sweeps, the scene
    lights, a platform delta and building lighting; and a small grid on
    the card against the CPU.  Returns the metrics and the launches."""
    from w3d_torch.city import floorplan as CF
    from w3d_torch.lighting import accum as LA, building_indir as LB, lmap as LM
    from w3d_torch.lighting import sweep as LS, trace as LT
    from w3d_torch.scene import cobj as SC
    from w3d_torch.utils import kernel_probe as KP
    from w3d_torch.utils import profile_step as PROF
    from w3d_torch.utils.constants import WorldConst

    out = {"launches": {n: 0 for n in kernels}}
    world = WorldConst()
    cobjs = SC.pack_cobjs(KP.lighting_bench_scene(), device=dev)
    mesh = torch.full((world.mesh_y, world.mesh_x), -0.6, dtype=torch.float32, device=dev)

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        return r, time.perf_counter() - t0

    def same(a, b):
        return all(torch.equal(x, y) for x, y in zip(a, b))

    reset_counts()
    rates = {}
    for label, params, batch in (("default", LT.TraceParams(), 65536),
                                 ("compact", LT.TraceParams(compact=True, samples_per_segment=8,
                                                            samples_later=4), 131072)):
        def bake(seed):
            return LT.compute_sky_lighting(LM.make_light_grid(world, device=dev), cobjs, mesh,
                                           LIGHT_RAYS, seed=seed, params=params, world=world,
                                           batch=batch)
        _, first_s = timed(lambda: bake(1))
        (ga, ta), (gb, tb) = timed(lambda: bake(7)), timed(lambda: bake(7))
        need(same(ga, gb), f"lighting {label} bake: two bakes of one seed bitwise equal")
        need(all(bool(torch.isfinite(t).all()) for t in ga) and float(ga.sv.sum()) > 0,
             f"lighting {label} bake: finite, lit")
        rates[label] = LIGHT_RAYS / statistics.median([ta, tb])
        log(f"lighting {label} bake ({batch} a batch): {rates[label] / 1e6:.3f} M rays/s "
            f"({1e3 * ta:.1f} and {1e3 * tb:.1f} ms per 1,048,576 rays; first bake "
            f"{first_s:.3f} s), two bakes of seed 7 bitwise equal; sky weight total "
            f"{float(ga.sv.sum()):.1f}, lit cells {int((ga.sv > 0).sum())} of {ga.sv.numel()}")
    c = read_counts("lighting bakes", ("sample",))
    for n in c:
        out["launches"][n] += c[n]
    prof = PROF.trace_lighting_batch(dev, [])
    busy = prof["busy_ms"] / prof["wall_ms"]
    log(f"lighting batch under the profiler (65,536 rays, default params): "
        f"{prof['wall_ms']:.2f} ms wall, device busy {prof['busy_ms']:.2f} ms "
        f"({100 * busy:.1f}%), {prof['kernels']:.0f} kernels")

    # the sweeps: 32 directions and the bounce, the global sun
    grid = LM.make_light_grid(world, device=dev)
    vox, vox_s = timed(lambda: LS.voxelize_for_grid(grid, cobjs, mesh, world))
    sky = lambda: LS.compute_sky_lighting_sweep(grid, cobjs, mesh, ndirs=32, world=world,
                                                vox=vox)
    timed(sky)
    gs, sweep_s = timed(sky)
    gg, glob_s = timed(lambda: LS.compute_global_lighting_sweep(
        grid, cobjs, mesh, (0.3, -0.2, -1.0), world=world, vox=vox))
    need(all(bool(torch.isfinite(t).all()) for t in gs + gg) and float(gs.sv.max()) > 0.9
         and float(gg.gv.max()) > 0.9, "sweeps: finite, open sky reaches weight 1")
    log(f"sweeps: voxelize {1e3 * vox_s:.1f} ms, sky sweep (32 directions + bounce) "
        f"{1e3 * sweep_s:.1f} ms, global sweep (+ bounce) {1e3 * glob_s:.1f} ms")

    # scene lights: four point lights of 65,536 rays
    specs = [SC.LightSpec(size=0.5, pos=p, color=(1.0, 0.9, 0.8, 1.0))
             for p in ((0.0, 0.0, 0.5), (-2.0, 1.5, 0.8), (2.0, -1.0, 1.2), (1.0, 2.0, 0.3))]
    reset_counts()
    gl, scene_s = timed(lambda: LT.compute_scene_lighting(
        LM.make_light_grid(world, device=dev), cobjs, mesh, specs, 65536, world=world))
    c = read_counts("scene lighting", ("sample",))
    for n in c:
        out["launches"][n] += c[n]
    need(bool(torch.isfinite(gl.lc_r).all()) and float(gl.lc_r.sum()) > 0,
         "scene lighting: finite, lit")
    log(f"scene lighting: 4 point lights x 65,536 rays {scene_s:.3f} s")

    # a platform delta on 65,536 recorded rays, moved A -> B -> A
    lo_a, hi_a = (-1.5, -1.5, 0.6), (1.5, 1.5, 0.8)
    lo_b, hi_b = (0.0, 0.0, 0.6), (3.0, 3.0, 0.8)
    rec = LA.record_platform_rays(LT.DrawSource(dev)(5), LIGHT_RAYS, lo_a, hi_a, world,
                                  seed=3)
    need(rec.ox.shape[0] >= PLATFORM_RAYS, "platform: 65,536 rays recorded")
    rays = LA.AccumRays(*(a[:PLATFORM_RAYS].contiguous() for a in rec[:-1]), seed=3)
    zero = LM.make_light_grid(world, device=dev)
    upd = lambda g, a, b: LA.update_platform_lighting(g, rays, cobjs, mesh, *a, *b,
                                                      world=world)
    timed(lambda: upd(zero, (lo_a, hi_a), (lo_b, hi_b)))
    ab, delta_s = timed(lambda: upd(zero, (lo_a, hi_a), (lo_b, hi_b)))
    aba = upd(ab, (lo_b, hi_b), (lo_a, hi_a))
    still = upd(zero, (lo_a, hi_a), (lo_a, hi_a))
    moved = float(ab.sv.abs().sum())
    need(moved > 0 and not any(bool(getattr(aba, f).any()) or bool(getattr(still, f).any())
                               for f in LM.CHANNELS[LM.LIGHTING_SKY]),
         "platform: A->B changes the volume, A->B->A and A->A add exactly zero")
    log(f"platform delta: {PLATFORM_RAYS} recorded rays (of {rec.ox.shape[0]}), "
        f"{1e3 * delta_s:.1f} ms; |A->B| weight {moved:.3f}; A->B->A and A->A exactly 0")

    # building indirect lighting at res 32, sliced
    bbox = (0.0, 0.0, 0.0, 1.2, 0.9, 0.4)
    interior = CF.gen_interior(bbox, 3, 0.12, seed=3)
    mgr = LB.BuildingIndirManager.for_building(interior, bbox, res=32,
                                               rays_per_light=4 * INDIR_SLICE, device=dev)
    mgr.slice_rays = INDIR_SLICE
    last = len(interior.lights) - 1
    mgr.prioritize(last)
    slice_ms, order = [], []
    for i in range(8):
        ix, s = timed(lambda: mgr.process_one(mgr.cobjs, mgr.mesh, seed=i))
        order.append(ix)
        slice_ms.append(1e3 * s)
    comp = mgr.composite()
    need(order == [last] + list(range(7)) and len(mgr.volumes) == 8
         and bool(torch.isfinite(comp.lc_r).all()) and float(comp.lc_r.sum()) > 0,
         "building lighting: the prioritized light first, then the queue, lit")
    indir_ms = statistics.median(slice_ms[1:])
    log(f"building lighting: {len(interior.lights)} room lights, {len(interior.walls)} "
        f"walls, res 32: {indir_ms:.2f} ms a slice of {INDIR_SLICE} rays (median of "
        f"slices 2-8; first {slice_ms[0]:.1f} ms), lights sliced {order}")
    out.update(sky_rays_per_sec=rates["default"], sky_rays_per_sec_compact=rates["compact"],
               lighting_batch_device_busy_share=busy, sweep_ms=1e3 * sweep_s,
               global_sweep_ms=1e3 * glob_s, scene_lighting_s=scene_s,
               platform_delta_ms=1e3 * delta_s, building_indir_slice_ms=indir_ms)

    # a small grid on the card against the CPU, on the same draws
    sw_ = WorldConst(mesh_x=32, mesh_y=32, mesh_z=16)
    sp = SC.SceneParse()
    lay = SC.CobjLayer(color=(0.9, 0.9, 0.9, 1.0))
    sp.cobjs.append(SC.RawCobj(SC.COLL_CUBE, (-4, -4, -0.6), (4, 4, -0.4), layer=lay))
    sp.cobjs.append(SC.RawCobj(SC.COLL_SPHERE, (1.5, 0.0, 0.5), r1=0.6, layer=lay))
    worst, outside, cells = 0.0, 0, 0
    for params in (LT.TraceParams(max_bounces=3, samples_per_segment=6, line_length=16.0,
                                  mesh_steps=12),
                   LT.TraceParams(compact=True, samples_per_segment=8, samples_later=4)):
        res = []
        for d, src in (("cpu", LT.DrawSource("cpu")), (dev, LT.DrawSource(dev, "cpu"))):
            res.append(LT.compute_sky_lighting(
                LM.make_light_grid(sw_, device=d), SC.pack_cobjs(sp, device=d),
                torch.full((32, 32), -3.5, device=d), 4096, seed=2, params=params,
                world=sw_, batch=2048, draws=src))
        for a, b in zip(res[0], res[1]):
            b = b.cpu()
            outside += int((~torch.isclose(b, a, rtol=3e-5, atol=1e-6)).sum())
            cells += a.numel()
            worst = max(worst, float(((b - a).abs() / (a.abs() + 1e-6)).max()))
    cpu_sw = LS.compute_sky_lighting_sweep(LM.make_light_grid(sw_, device="cpu"),
                                           SC.pack_cobjs(sp, device="cpu"), None, ndirs=12,
                                           world=sw_)
    gpu_sw = LS.compute_sky_lighting_sweep(LM.make_light_grid(sw_, device=dev),
                                           SC.pack_cobjs(sp, device=dev), None, ndirs=12,
                                           world=sw_)
    sd = max(float((b.cpu() - a).abs().max()) for a, b in zip(cpu_sw, gpu_sw))
    log(f"lighting 32x32x16, card vs CPU on the same draws (default and production "
        f"params): worst relative difference {worst:.3g}, values outside rtol 3e-5, atol "
        f"1e-6: {outside} of {cells}; sky sweep max diff {sd:.3g}")
    need(outside == 0, "lighting 32x32x16, card vs CPU: rtol 3e-5, atol 1e-6")
    need(sd <= 1e-5, "sweep 32x32x16, card vs CPU: 1e-5")
    out.update(lighting_card_vs_cpu_max_rel=worst)
    return out


# ---- 3k / 3l: the full-world build and a building session ---------------

def _same_dataclasses(a, b) -> bool:
    import dataclasses
    return [dataclasses.asdict(x) for x in a] == [dataclasses.asdict(x) for x in b]


def _max_diff(a, b) -> float:
    """Largest float difference over two NamedTuple trees of tensors (None
    fields skipped); inf if an integer or bool field differs, or if the
    trees differ in shape (a field None on one side only)."""
    from w3d_torch import convert
    xs, ys = _leaves(convert.to_numpy(a)), _leaves(convert.to_numpy(b))
    if len(xs) != len(ys) or any(x.shape != y.shape for x, y in zip(xs, ys)):
        return float("inf")
    worst = 0.0
    for x, y in zip(xs, ys):
        if x.dtype.kind == "f":
            worst = max(worst, float(np.abs(x - y).max()) if x.size else 0.0)
        elif not np.array_equal(x, y):
            return float("inf")
    return worst


def run_full_world_phase(tmp: str, dev, kernels: dict, reset_counts, read_counts) -> dict:
    """Phase 3k: `w3d_torch.full_world` at the JAX example's sizes on the
    card: `main` end to end (each section's time and launches: A in the
    terrain; B, C and D in the physics; B in the bake; the stats line,
    both PNGs read back); A against its plain walk at the terrain's own
    shape, bitwise; the uneroded terrain card vs CPU, bitwise, and the
    city and traffic sections on it (both cities, a connector route, the
    rail and the trains) card vs CPU; then `main` on the CPU on the
    same draws, held against the card's build: the terrain, city, tunnels,
    first building, trees, star system and map image equal; walkers,
    traffic and the city frame within 1e-5; the physics state within 1e-5
    with status equal; the bake per cell within rtol 3e-5, atol 1e-6; the
    sweep per cell within 1e-5, sky energy and mean visibility within
    rtol 3e-5."""
    from w3d_torch import convert, full_world as FW
    from w3d_torch.export import heightmap_io as HIO
    from w3d_torch.ops import erosion as E
    from w3d_torch.ops.cuda import erosion_kernel as EK
    from w3d_torch.utils.constants import WorldConst

    sizes = FW.WorldSizes()
    out = {"launches": {n: 0 for n in kernels}}
    draws = FW.WorldDraws()
    world = WorldConst(mesh_x=sizes.mesh, mesh_y=sizes.mesh)
    cpu = torch.device("cpu")

    by_section = {}

    def after_section(name):         # the launches of each section of main
        by_section[name] = {n: k.launches for n, k in kernels.items() if k.launches}
        reset_counts()

    fw_dir = os.path.join(tmp, "full_world")
    reset_counts()
    t0 = time.perf_counter()
    stats, fw = FW.main(fw_dir, sizes=sizes, draws=draws, device=dev,
                        after_section=after_section)           # prints the stats line
    wall = time.perf_counter() - t0
    log(f"full-world launches by section of main: {by_section}")
    for name, need_k in (("terrain", ("erosion",)), ("physics", ("sample", "narrow", "pairs")),
                         ("lighting", ("sample",))):
        missing = [n for n in need_k if not by_section[name].get(n)]
        need(not missing, f"full world: kernels {missing} launched in main's {name} section")
    for c in by_section.values():
        for n, v in c.items():
            out["launches"][n] += v
    keys = {"terrain", "first_building", "city", "traffic", "city_frame", "vegetation",
            "physics", "lighting", "sweep_lighting", "universe", "artifacts", "seconds"}
    need(keys <= set(stats), f"full world: the example's keys {sorted(keys - set(stats))}")
    need(stats["physics"]["live"] > 0 and stats["lighting"]["sky_energy"] > 0
         and stats["vegetation"]["trees"] > 0 and stats["city"]["buildings"] >= 1,
         "full world: live balls, a lit bake, trees, buildings")
    sizes_png = {n: os.path.getsize(os.path.join(fw_dir, n)) for n in stats["artifacts"]}
    png_h = HIO.read_png_gray(os.path.join(fw_dir, "world_height.png"))
    png_map = HIO.read_image_rgb(os.path.join(fw_dir, "world_map.png"))
    need(np.array_equal(png_h, HIO.heights_to_pixels(fw.city.hm.cpu().numpy()))
         and np.array_equal(png_map, fw.map_rgb)
         and fw.map_rgb.shape == (sizes.mesh, sizes.mesh, 3),
         "full world: both PNGs read back equal to the heightmap's pixels and the map")
    secs = stats["section_seconds"]
    log(f"full world on the card: {wall:.2f} s wall, sections (s): "
        + ", ".join(f"{k} {v:.3f}" for k, v in secs.items()) + f"; PNG bytes {sizes_png}, "
        f"height pixels {int(png_h.min())}..{int(png_h.max())}; city plots "
        f"{stats['city']['plots']} of {sizes.num_cities}, trains {stats['traffic']['trains']}")
    out.update(full_world_s=wall, full_world_section_s=secs)

    # A against its plain walk at the terrain's shape, on the card
    walk = EK.erosion_walk
    EK.erosion_walk = E._walk_batch
    try:
        ts_plain, _ = FW.terrain_section(sizes, draws, world, dev)
    finally:
        EK.erosion_walk = walk
    same_walk = all(torch.equal(a, b) for a, b in zip(fw.terrain, ts_plain))
    # the uneroded terrain, card vs CPU
    flat = sizes._replace(erosion_iters=0)
    flat_g, _ = FW.terrain_section(flat, draws, world, dev)
    flat_c, _ = FW.terrain_section(flat, draws, world, cpu)
    flat_cells = int((flat_g.mesh_height.cpu() != flat_c.mesh_height).sum())
    same_flat = flat_cells == 0 and all(torch.equal(a.cpu(), b) for a, b in zip(flat_g, flat_c))
    shape = (f"{-(-sizes.erosion_iters // FW.EROSION_BATCH)} batches of "
             f"{FW.EROSION_BATCH} x {FW.EROSION_STEPS} steps on {sizes.mesh}^2")
    log(f"full-world terrain: A vs plain walk on the card, {shape}, bitwise {same_walk}; "
        f"uneroded card vs CPU bitwise {same_flat} ({flat_cells} of "
        f"{flat_c.mesh_height.numel()} cells differ)")
    need(same_walk, f"full world: A equals its plain walk bitwise, {shape}")
    need(same_flat, "full world: the uneroded terrain equal on the card and the CPU")
    # the city and its traffic on the uneroded map, where both cities fit
    # (the eroded one of these draws holds one): the connector road, the
    # rail and the trains on the card, against the CPU
    cb2, cs2 = FW.city_section(flat_g.mesh_height, flat_g.water_plane_z, sizes, world, dev)
    tr2, trs2 = FW.traffic_section(cb2, sizes, draws, dev)
    cb2c, cs2c = FW.city_section(flat_c.mesh_height, flat_c.water_plane_z, sizes, world, cpu)
    tr2c, trs2c = FW.traffic_section(cb2c, sizes, draws, cpu)
    same2 = (cs2 == cs2c and trs2 == trs2c
             and [tuple(p) for p in cb2.plots] == [tuple(p) for p in cb2c.plots]
             and cb2.net.segs == cb2c.net.segs and cb2.routes == cb2c.routes
             and torch.equal(cb2.hm.cpu(), cb2c.hm)
             and _same_dataclasses(cb2.buildings, cb2c.buildings))
    d2 = max(_max_diff(getattr(tr2, f), getattr(tr2c, f))
             for f in ("cars", "trains", "rail", "helis"))
    log(f"full-world city on the uneroded map: {cs2['city']}, traffic {trs2}, "
        f"{len(cb2.routes)} connector routes; card vs CPU host results equal {same2}, "
        f"cars, rail, trains and helicopters max diff {d2:.3g}")
    need(cs2["city"]["plots"] == sizes.num_cities and trs2["trains"] == sizes.trains > 0
         and len(cb2.routes) > 0,
         f"full world, uneroded map: {sizes.num_cities} cities, a connector route and "
         f"{sizes.trains} trains")
    need(same2 and d2 <= 1e-5,
         "full world, uneroded map, card vs CPU: city equal, traffic 1e-5")

    # main on the CPU, on the same draws, against the card's build
    t0 = time.perf_counter()
    stats_c, fc = FW.main(os.path.join(tmp, "full_world_cpu"), sizes=sizes, draws=draws,
                          device=cpu)
    cpu_s = time.perf_counter() - t0
    timing = ("seconds", "section_seconds")
    same_stats = ({k: v for k, v in stats.items() if k not in timing}
                  == {k: v for k, v in stats_c.items() if k not in timing})
    ter_cells = int((fw.terrain.mesh_height.cpu() != fc.terrain.mesh_height).sum())
    same_ter = ter_cells == 0 and all(torch.equal(a.cpu(), b)
                                      for a, b in zip(fw.terrain, fc.terrain))
    cb, cbc = fw.city, fc.city
    same_city = ([tuple(p) for p in cb.plots] == [tuple(p) for p in cbc.plots]
                 and cb.net.segs == cbc.net.segs and cb.routes == cbc.routes
                 and cb.bridges == cbc.bridges and cb.tunnels == cbc.tunnels
                 and torch.equal(cb.hm.cpu(), cbc.hm)
                 and _same_dataclasses(cb.buildings, cbc.buildings)
                 and _same_dataclasses(cb.bsegs, cbc.bsegs))
    same_trees = all(torch.equal(a.cpu(), b) for a, b in zip(fw.trees, fc.trees))
    same_sky = repr(fw.system) == repr(fc.system)
    same_map = bool(np.array_equal(fw.map_rgb, fc.map_rgb))
    walk_d = _max_diff(cb.people, cbc.people)
    tr, trc = fw.traffic, fc.traffic
    traffic = max(_max_diff(tr.cars, trc.cars), _max_diff(tr.trains, trc.trains),
                  _max_diff(tr.helis, trc.helis), _max_diff(fw.city_state, fc.city_state))
    inst_d = (max((float(np.abs(a.transforms - b.transforms).max())
                   for a, b in zip(fw.instances, fc.instances)), default=0.0)
              if [(a.kind, a.transforms.shape) for a in fw.instances]
              == [(b.kind, b.transforms.shape) for b in fc.instances] else float("inf"))
    st, stc = convert.to_numpy(fw.spheres.state), convert.to_numpy(fc.spheres.state)
    phys = max(float(np.abs(getattr(st, f) - getattr(stc, f)).max())
               for f in ("px", "py", "pz", "vx", "vy", "vz"))
    same_status = bool(np.array_equal(st.status, stc.status))
    bake_out, bake_rel = 0, 0.0
    for f in ("sc_r", "sc_g", "sc_b", "sv"):
        g, c = getattr(fw.bake, f).cpu().numpy(), getattr(fc.bake, f).numpy()
        bake_out += int((np.abs(g - c) > 1e-6 + 3e-5 * np.abs(c)).sum())
        bake_rel = max(bake_rel, float((np.abs(g - c) / np.maximum(np.abs(c), 1e-30)).max()))
    sweep_d = float((fw.sweep.sv.cpu() - fc.sweep.sv).abs().max())
    sky_g, sky_c = float(fw.bake.sc_r.sum()), float(fc.bake.sc_r.sum())
    vis_g, vis_c = float(fw.sweep.sv.mean()), float(fc.sweep.sv.mean())
    sky_rel = abs(sky_g - sky_c) / max(abs(sky_c), 1e-30)
    vis_rel = abs(vis_g - vis_c) / max(abs(vis_c), 1e-30)
    log(f"full world on the CPU, same draws: {cpu_s:.1f} s; card vs CPU: stats equal "
        f"{same_stats}, eroded terrain equal {same_ter} ({ter_cells} cells differ), "
        f"city/tunnels/first building equal {same_city}, trees equal {same_trees}, star "
        f"system equal {same_sky}, map image equal {same_map}; walkers max diff "
        f"{walk_d:.3g}, traffic and city frame {traffic:.3g}, instances {inst_d:.3g}; "
        f"physics max diff {phys:.3g}, status equal {same_status}; bake cells outside rtol "
        f"3e-5, atol 1e-6: {bake_out} (max rel {bake_rel:.3g}), sweep max diff "
        f"{sweep_d:.3g}; sky energy {sky_g!r} vs {sky_c!r} (rel {sky_rel:.3g}), sweep mean "
        f"visibility {vis_g!r} vs {vis_c!r} (rel {vis_rel:.3g})")
    need(same_stats and same_ter and same_city and same_trees and same_sky and same_map,
         "full world, card vs CPU: stats, terrain, city, tunnels, first building, trees, "
         "star system and map image equal")
    need(max(walk_d, traffic, inst_d) <= 1e-5,
         "full world, card vs CPU: walkers, traffic, city frame 1e-5")
    need(phys <= 1e-5 and same_status, "full world, card vs CPU: physics 1e-5, status equal")
    need(bake_out == 0 and sweep_d <= 1e-5,
         "full world, card vs CPU: the bake per cell within rtol 3e-5, atol 1e-6, the "
         "sweep per cell 1e-5")
    need(sky_rel <= 3e-5 and vis_rel <= 3e-5,
         "full world, card vs CPU: sky energy and sweep visibility within rtol 3e-5")
    out.update(full_world_card_vs_cpu_physics_max_diff=phys, full_world_cpu_s=cpu_s)
    return out


GRASS_BLADES = 4       # blades a cell, as the tile manager's default
GRASS_CAMERA = (100.0, 68.0)   # over tile (12, 8): the tiled app's terrain
# (mesh seed 1) is beach sand around the origin, grass here


def run_building_phase(tmp: str, dev, kernels: dict, reset_counts, read_counts) -> dict:
    """Phase 3l: a building session at the tiled app's city size
    (`build_city` on a 128^2 flat map, one city, with interiors):
    tunnels, manholes and walk-area clamps; street objects and perches,
    32 chained city frames with birds on them; a `BuildingPeopleSim` of
    48 people for 64 steps; clocks; a furnished mall and a backrooms
    basement walked; a flooded basement; light switches feeding
    `BuildingIndirManager`; pickups and 64 ticks of zombie mode; spiders,
    snakes, flies and tank fish for 64 ticks; model instances from config
    rows written here; grass and flowers on every resident tile of a
    phase-3g-size tile manager.  Each part timed, and held on the card
    against the CPU on the same draws (host results equal, floats 1e-5)."""
    from w3d_torch.city import assemble as CA, buildings as CB, bldg_gameplay as BG, bldg_interact as BX
    from w3d_torch.city import building_water as BW, city_step as CST, clocks as CK
    from w3d_torch.city import floorplan as CF, mall_backrooms as MB
    from w3d_torch.city import model_instances as MI, objects as CO, people as PE
    from w3d_torch.city import room_content as RC, traffic as CT, tunnels as TN
    from w3d_torch.lighting import building_indir as LB, trace as LT
    from w3d_torch.physics import step as PS, types as PT
    from w3d_torch.scene import cobj as SC
    from w3d_torch.terrain import mesh as TM, tiles as TL
    from w3d_torch.utils.constants import WorldConst
    from w3d_torch.utils.rng import RandGen
    from w3d_torch.veg import animals as VA

    cpu = torch.device("cpu")
    out = {"launches": {n: 0 for n in kernels}}
    times = {}

    def timed(name, fn):
        if dev.type == "cuda":
            torch.cuda.synchronize()
        t = time.perf_counter()
        r = fn()
        if dev.type == "cuda":
            torch.cuda.synchronize()
        times[name] = time.perf_counter() - t
        return r

    reset_counts()
    # the city with interiors, tunnels and manholes
    kw = dict(num_cities=1, num_cars=64, num_peds=128, seed=1, interiors=True)
    cw = timed("build_city", lambda: CA.build_city(np.zeros((128, 128), np.float32),
                                                    device=dev, **kw))
    cwc = CA.build_city(np.zeros((128, 128), np.float32), device=cpu, **kw)
    segs_all = [s for _, s in cw.tunnels]
    need(len(segs_all) > 0 and len(cw.manholes) > 0, "building: tunnels and manholes grown")
    need([(i, [vars(t) for t in s]) for i, s in cw.tunnels]
         == [(i, [vars(t) for t in s]) for i, s in cwc.tunnels]
         and cw.manholes == cwc.manholes and _same_dataclasses(cw.buildings, cwc.buildings),
         "building: interiors, tunnels and manholes equal card vs CPU")
    fh = CB.BuildingParams().floor_height
    timed("tunnel_gen", lambda: [TN.gen_tunnels(b, cw.buildings, fh, seed=1 + bi)
                                 for bi, b in enumerate(cw.buildings)])
    tunnel_gen_ms = 1e3 * times["tunnel_gen"] / max(len(cw.buildings), 1)
    segs = max(segs_all, key=len)
    rng = np.random.default_rng(5)
    lo = np.min([s.bcube()[:3] for s in segs], axis=0)
    hi = np.max([s.bcube()[3:] for s in segs], axis=0)
    pts = (lo + (hi - lo) * rng.random((4096, 3))).astype(np.float32)
    packed = TN.pack_tunnels(segs, device=dev)
    clamp = lambda: TN.clamp_to_walk_area(torch.as_tensor(pts, device=dev), 0.02, packed)
    timed("clamp", clamp)
    cl_g = timed("clamp", clamp)
    cl_c = TN.clamp_to_walk_area(torch.as_tensor(pts), 0.02, TN.pack_tunnels(segs, device="cpu"))
    clamp_d = float((cl_g.cpu() - cl_c).abs().max())
    moved = int(((cl_c - torch.as_tensor(pts)).abs().amax(1) > 1e-6).sum())
    log(f"building: build_city with interiors {times['build_city']:.3f} s, "
        f"{len(cw.buildings)} buildings, {len(cw.tunnels)} tunnel networks "
        f"({sum(len(s) for s in segs_all)} segments), {len(cw.manholes)} manholes; "
        f"gen_tunnels {tunnel_gen_ms:.3f} ms a building; walk-area clamp of 4,096 points "
        f"over {len(segs)} segments {1e3 * times['clamp']:.3f} ms ({moved} clamped), card "
        f"vs CPU max diff {clamp_d:.3g}")
    need(clamp_d <= 1e-6 and moved > 0, "walk-area clamp, card vs CPU: 1e-6")

    # street objects, perches on them, 32 chained frames with birds
    objs = CO.place_city_objects(cw.net, cw.buildings, seed=1)
    perches = CT.bird_perches(objs, cw.buildings)
    need(len(perches) > len(cw.buildings), "building: perches on street objects")
    g = torch.Generator().manual_seed(31)
    n_birds = 16
    draws = CST.draw_city(32, 128, 0, 0, n_birds, len(perches), g, device="cpu")

    def city_run(w, device):
        st = CST.CityState(stoplights=w.stoplights, cars=w.cars, peds=w.peds, people=None,
                           elev=CST.make_elevator_bank(1, device=device), helis=None,
                           birds=CT.make_birds(n_birds, perches, seed=2, device=device))
        d = CST.CityDraws(*(None if v is None else v.to(device) for v in draws))
        return CST.city_frames_chained(st, w.graph, w.ped_nav, None,
                                       torch.as_tensor(perches, device=device), 32, d)
    cs_g = timed("city_birds", lambda: city_run(cw, dev))
    cs_c = city_run(cwc, cpu)
    birds_d = _max_diff(cs_g, cs_c)
    log(f"street objects: {len(objs.x)} placed, {len(perches)} perches; 32 chained city "
        f"frames with {n_birds} birds {1e3 * times['city_birds'] / 32:.3f} ms a frame, card "
        f"vs CPU max diff {birds_d:.3g}")
    need(birds_d <= 1e-5, "city frames with birds, card vs CPU: 1e-5")

    # a tower's people with elevators: 48 people, 64 host-driven steps
    part = (0.0, 0.0, 0.0, 1.2, 0.9, 0.4)
    tower = CF.gen_interior(part, 3, 0.08, seed=7)
    tobjs = RC.furnish_rooms(tower, 0.08, seed=7)
    sims = [PE.BuildingPeopleSim(tower, 48, seed=5, room_objs=tobjs, device=d)
            for d in (dev, cpu)]
    calls = 0
    step_ms = []
    for _ in range(64):
        t = time.perf_counter()
        sims[0].step()
        step_ms.append(1e3 * (time.perf_counter() - t))
        sims[1].step()
        calls += sum(len(c) for c in PE.elevator_calls(sims[0].people, len(sims[0].cars)))
    ppl_d = _max_diff(sims[0].people, sims[1].people)
    same_cars = [(c.z, c.state) for c in sims[0].cars] == [(c.z, c.state) for c in sims[1].cars]
    building_people_step_ms = statistics.median(step_ms)
    log(f"BuildingPeopleSim: 48 people, {len(sims[0].cars)} elevator cars, 64 steps, "
        f"{building_people_step_ms:.3f} ms a step (median), {calls} elevator calls; card vs "
        f"CPU max diff {ppl_d:.3g}, cars equal {same_cars}")
    need(ppl_d <= 1e-5 and same_cars and calls > 0,
         "building people, card vs CPU: 1e-5, cars equal; elevator calls made")

    # clocks: every second of a day on a 7-segment display
    secs = torch.arange(86400, dtype=torch.int32)
    disp = timed("clocks", lambda: CK.display_state(secs.to(dev), show_seconds=True))
    disp_c = CK.display_state(secs, show_seconds=True)
    need(torch.equal(disp[0].cpu(), disp_c[0]) and torch.equal(disp[1].cpu(), disp_c[1]),
         "clocks: display state equal card vs CPU")
    log(f"clocks: 86,400 displays {1e3 * times['clocks']:.3f} ms, equal card vs CPU")

    # a furnished mall and a backrooms basement, walked by people
    mall = MB.gen_mall((0.0, 0.0, 4.0, 2.0), 2, 0.12, seed=4)
    mobjs, names = MB.furnish_mall(mall, 0.12, seed=4)
    back = MB.gen_backrooms((0.0, 0.0, 3.0, 2.0), 0.12, seed=3)
    walked = []
    for inter in (mall, back):
        runs = []
        for d in (dev, cpu):
            p = PE.make_people(PE.build_nav_graph(inter), 24, seed=1, device=d)
            for _ in range(64):
                p = PE.step_people(p)
            runs.append(p)
        walked.append(_max_diff(*runs))
    log(f"mall: {len(mall.rooms)} rooms, {len(mobjs.kinds)} objects, "
        f"{sum(1 for n in names if n)} named stores; backrooms: {len(back.walls)} walls; "
        f"24 people 64 steps in each, card vs CPU max diff {max(walked):.3g}")
    need(max(walked) <= 1e-5, "mall and backrooms walkers, card vs CPU: 1e-5")

    # a flooded basement
    base = CF.gen_interior(part, 2, 0.08, seed=7, has_basement=True)
    bw = BW.BasementWater(floor_height=0.08, basement_z1=-0.08, num_levels=1, leak_rate=0.002)
    sm = BW.SplashManager()
    splashes = 0
    for _ in range(48):
        bw.step()
        splashes += bool(BW.check_for_water_splash(base, bw, sm, 0.3, 0.3, -0.06))
        sm.next_frame(1.0)
    vols = BW.room_fill_geometry(base, bw)
    need(len(vols) > 0 and bw.is_underwater(-0.06), "flooded basement: rooms filled")
    log(f"flooded basement: level {bw.level:.4f}, floor below water {bw.floor_below_water()}, "
        f"{len(vols)} filled room volumes, {splashes} splashes, wade factor "
        f"{bw.wade_factor(-0.07, 0.02):.3f}")

    # light switches feeding building lighting
    kinds = np.asarray(tobjs.kinds)
    lw = WorldConst(mesh_x=16, mesh_y=16, mesh_z=8)
    mgrs = []
    for d in (dev, cpu):
        m = LB.BuildingIndirManager(world=lw, rays_per_light=2048, device=d,
                                    draws=LT.DrawSource(d, "cpu"))
        mgrs.append(m)
    lights = np.where(kinds == RC.F_CEIL_LIGHT)[0][:8]
    for li in lights:
        c = np.asarray(tobjs.cubes[li], np.float32)
        pos = tuple(float(v) for v in 0.5 * (c[:3] + c[3:]))
        for m in mgrs:
            m.register_light(int(li), pos, (1.0, 0.9, 0.8))
    empty = [SC.pack_cobjs(SC.SceneParse(), device=d) for d in (dev, cpu)]
    mesh = [torch.full((16, 16), -5.0, device=d) for d in (dev, cpu)]

    def bake(k):
        while mgrs[k].process_one(empty[k], mesh[k]) is not None:
            pass
    timed("indir", lambda: bake(0))
    bake(1)
    st = BX.make_interact_state(tobjs, len(tower.rooms))
    cent = BX._centers(tobjs)
    changed = 0
    for i in np.where(kinds == RC.F_LIGHT_SWITCH)[0][:6]:
        BX.interact_at(tobjs, st, *(float(v) for v in cent[i]), reach=0.01)
        for m in mgrs:
            changed += BX.apply_room_lights(m, tobjs, st)
    comp = [m.composite() for m in mgrs]
    indir_d = float((comp[0].lc_r.cpu() - comp[1].lc_r).abs().max())
    need(mgrs[0].enabled == mgrs[1].enabled and changed > 0 and indir_d <= 1e-5,
         "light switches: enabled maps equal, composite 1e-5 card vs CPU")
    log(f"light switches: {len(lights)} room lights baked ({1e3 * times['indir']:.1f} ms on "
        f"the card), 6 switches toggled, {changed // 2} lights changed state; composite card "
        f"vs CPU max diff {indir_d:.3g}")

    # pickups, a throw and 64 ticks of zombie mode
    def zombie_run(d):
        inv = BG.PlayerInventory()
        taken = sum(BG.loot_room(tobjs, r, inv) for r in sorted(set(tobjs.rooms))[:8])
        tab = PT.make_type_table(device=d)
        z3 = torch.zeros((8, 3), device=d)
        ost = PS.make_state(z3, z3, torch.full((8,), PT.type_id("BALL"), dtype=torch.int32), tab)
        ost, ok = BG.throw_object(inv, ost, tab, (0.5, 0.5, 0.15), (1, 0, 0.2), 3)
        graph = PE.build_nav_graph(tower)
        ppl = PE.make_people(graph, 24, seed=2, device=d)
        rg = RandGen(3, 7)
        ai, alert, pinv = BG.ZombieAI(), BG.SoundAlert(), BG.PlayerInventory()
        px, py, pf = (float(v) for v in graph.centers[2])
        hits, tick_ms = 0, []
        for k in range(64):
            t = time.perf_counter()
            if k % 16 == 0:
                alert.register(0.3, (px, py, 0.0))
                xs, ys, fs = (v.cpu().numpy() for v in (ppl.x, ppl.y, ppl.floor))
                cur = [int(np.argmin((graph.centers[:, 0] - x) ** 2 + (graph.centers[:, 1] - y) ** 2
                                     + 1e6 * (graph.centers[:, 2] - round(float(f))) ** 2))
                       for x, y, f in zip(xs, ys, fs)]
                ppl = ai.update(ppl, graph, cur, 2, (px, py), pf, alert, 1, rg)
            ppl = PE.step_people(ppl)
            hits += BG.zombie_attack_tick(ppl, pinv, (px, py), pf)
            alert.tick()
            pinv.tick(1.0)
            tick_ms.append(1e3 * (time.perf_counter() - t))
            if k == 48:
                px, py, pf = float(ppl.x[0]), float(ppl.y[0]), float(ppl.floor[0])
        return taken, ok, ost, ppl, hits, pinv, ai.states, tick_ms
    zg, zc = zombie_run(dev), zombie_run(cpu)
    zombie_tick_ms = statistics.median(zg[7])
    zd = max(_max_diff(zg[2], zc[2]), _max_diff(zg[3], zc[3]))
    same_z = zg[0] == zc[0] and zg[4] == zc[4] and zg[6] == zc[6] and \
        vars(zg[5]) == vars(zc[5])
    log(f"zombie mode: {zg[0]} objects looted, throw {zg[1]}, 64 ticks of 24 zombies "
        f"{zombie_tick_ms:.3f} ms a tick (median), {zg[4]} attacks, player health "
        f"{zg[5].health:.3f}; card vs CPU max diff {zd:.3g}, host state equal {same_z}")
    need(zg[1] and zd <= 1e-5 and same_z, "zombie mode, card vs CPU: 1e-5, host state equal")

    # building animals, 64 ticks
    room = (0.0, 0.0, 1.2, 0.9)
    tank = (0.2, 0.1, 0.0, 0.7, 0.6, 0.4)

    def animals(d):
        gg = torch.Generator().manual_seed(41)
        sp = VA.make_spiders(VA.draw_spiders(64, room, gg).to(d))
        sn = VA.make_snakes(VA.draw_snakes(16, room, gg).to(d))
        fl = VA.make_flies(VA.draw_animals(64, gg, spread=0.05).to(d), (0.6, 0.4, 0.3))
        fi = VA.make_animals(VA.draw_animals(32, gg, spread=0.1).to(d), VA.A_FISH,
                             center=(0.45, 0.35, 0.2))
        dr = VA.draw_building_animals(64, 64, 16, 64, gg, device=d)
        return VA.step_building_animals(sp, sn, fl, fi, dr, room, (0.6, 0.4, 0.3), tank, 64)
    ag = timed("animals", lambda: animals(dev))
    ad = max(_max_diff(a, b) for a, b in zip(ag, animals(cpu)))
    log(f"building animals: 64 spiders, 16 snakes, 64 flies, 32 tank fish, 64 ticks "
        f"{1e3 * times['animals']:.1f} ms; card vs CPU max diff {ad:.3g}")
    need(ad <= 1e-5, "building animals, card vs CPU: 1e-5")

    # model instances from config rows written here
    mdir = os.path.join(tmp, "models")
    os.makedirs(os.path.join(mdir, "cars"), exist_ok=True)
    with open(os.path.join(mdir, "cars", "box.obj"), "w") as f:
        f.write("v -1 -0.5 0\nv 1 -0.5 0\nv 1 0.5 0\nv -1 0.5 0\nv 0 0 0.8\n"
                "f 1 2 3 4\nf 1 2 5\nf 2 3 5\nf 3 4 5\nf 4 1 5\n")
    cfg = os.path.join(mdir, "config_city.txt")
    with open(cfg, "w") as f:
        f.write("city car_model cars/box.obj 1 0 0  22 -1 90  1 1.0 1.0  20 22\n"
                "city car_model cars/missing.obj 1 0 5  3 -2 0.1 0.3 0.3 1.0  0  3 1.5 1.0\n"
                "city ped_model people/missing.obj 1 0 1  -1 -1 0  1 1.0 1.0  0.7 1\n"
                "city toilet_model cars/box.obj 1 0 0  -1 -1 0  1 1.0 1.0\n")
    specs = MI.parse_city_models(cfg)
    inst = [MI.city_instances(cars=w.cars, graph=w.graph, peds=w.peds, helis=w.helis,
                              specs=specs, base_dir=mdir, seed=4) for w in (cw, cwc)]
    rinst = MI.room_object_instances(tobjs, specs=specs, base_dir=mdir)
    inst_d = max(float(np.abs(a.transforms - b.transforms).max())
                 for a, b in zip(*inst))
    log(f"model instances: {len(inst[0])} sets, "
        f"{sum(s.transforms.shape[0] for s in inst[0])} instances, {len(rinst)} room "
        f"object sets; card vs CPU max diff {inst_d:.3g}")
    need(len(inst[0]) == len(inst[1]) and inst_d <= 1e-5, "model instances, card vs CPU: 1e-5")

    # grass and flowers on every resident tile of a phase-3g-size manager
    tm = TL.TileManager(cfg=TM.TerrainConfig(mesh_seed=1), world=WorldConst(mesh_x=64, mesh_y=64),
                        tile_size=64, device=dev)
    tm.update(*GRASS_CAMERA)
    tm.flush()
    tile_ms, blades, flowers, worst = [], 0, 0, 0.0
    cpu_tm = TL.TileManager(cfg=TM.TerrainConfig(mesh_seed=1),
                            world=WorldConst(mesh_x=64, mesh_y=64), tile_size=64, device="cpu")
    for k in sorted(tm.tiles):
        if dev.type == "cuda":
            torch.cuda.synchronize()
        t = time.perf_counter()
        gb = tm.grass_for_tile(k, blades_per_cell=GRASS_BLADES)
        fs = tm.flowers_for_tile(k)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        tile_ms.append(1e3 * (time.perf_counter() - t))
        blades += int((gb.height > 0).sum())
        flowers += int(fs.alive.sum())
        tl = tm.tiles[k]
        cpu_tm.tiles[k] = TL.Tile(tx=tl.tx, ty=tl.ty, zvals=tl.zvals.cpu(), ao=tl.ao.cpu(),
                                  smask_sun=tl.smask_sun.cpu(), weights=tl.weights.cpu())
        worst = max(worst, _max_diff(gb, cpu_tm.grass_for_tile(k, GRASS_BLADES)),
                    _max_diff(fs, cpu_tm.flowers_for_tile(k)))
    grass_tile_ms = statistics.median(tile_ms)
    log(f"grass and flowers: {len(tm.tiles)} resident 64^2 tiles, {GRASS_BLADES} blades a "
        f"cell: {grass_tile_ms:.3f} ms a tile (median), {blades} blades standing, {flowers} "
        f"flowers; card vs CPU on the card's tiles max diff {worst:.3g}")
    need(worst <= 1e-5 and blades > 0 and flowers > 0,
         "grass and flowers, card vs CPU: 1e-5, masks equal; blades and flowers standing")
    c = read_counts("building session", ())
    for n in c:
        out["launches"][n] += c[n]
    out.update(tunnel_gen_ms=tunnel_gen_ms, building_people_step_ms=building_people_step_ms,
               zombie_tick_ms=zombie_tick_ms, grass_tile_ms=grass_tile_ms)
    return out


SNOW_RAYS = 1_048_576      # the snow map: 16 batches
SNOW_BATCH = 65_536
SNOW_CHECK = (2, 4096)     # batches and flakes a batch held card vs CPU (the CPU's
                           # ray test costs ~1.6 ms a flake on the card's host)
SNOW_BAKE_RAYS = 131_072   # the sky bake over the snow map, 2 batches of 65,536
SCENERY_BIG = (512, 4096)  # mesh side and objects of the large scenery run
PRECIP = (10_240, GROUND_OBJS, 512, 64)   # slots, balls, drops a frame, frames
PRECIP_CHECK = (1024, 128, 128, 8)        # the same, card vs CPU
PRECIP_TEMPERATURE = 2.0   # the melt's temperature
CLOUDS = (128, 32, 10_000)  # layer side, times, local-wind positions
MODEL_GRID = (128, 80)     # kernel_probe.grid_model cells: 20,480 triangles
SCENE_MODEL_GRID = (16, 10)  # 320 triangles a format in the DSL scene
SKIN = (65_536, 32)        # vertices, bones
TEXTURE_N = 256


def run_weather_phase(tmp: str, dev, kernels: dict, reset_counts, read_counts) -> dict:
    """Phase 3m in the directory `tmp`: scenery, weather, model formats,
    skinning, textures and state I/O.

    Scenery on phase 3e's scene P (128^2 mesh, 384 cobj slots) at the
    loader's placement, the four generators and `scenery_cobjs`; then
    4,096 objects over a 512^2 mesh (`scenery_gen_ms`).  A snow map of
    1,048,576 rays in 16 batches over scene P (`snow_rays_per_sec`), a
    sky bake with it as `snow_depth`, and 2 batches of 4,096 flakes on
    the same draws.  Precipitation on scene P: 10,240 slots holding 2,000
    balls, 512 drops a frame (rain and snow frames in turns) stepped by
    `step_objects` (4 substeps), then accumulation, retirement and melt
    at 2.0 degrees, 64 frames (`precip_ms_per_frame`).  A 128^2 cloud
    layer at 32 times and the local wind at 10,000 positions.  One
    20,480-triangle mesh written in every format and loaded
    (`model_load_ms`, host), and a DSL scene naming every format, its
    narrow phase on the card (plain and kernel C).  Skinning of 65,536
    vertices over 32 bones (`skin_ms`).  The procedural textures at 256^2
    and DXT1/DXT5 of them.  A checkpoint of the 10,240-slot state from
    the card and the mesh and sim-state text files.  Every part is held
    on the card against the CPU: scenery, snow flakes and map,
    accumulation and statuses bitwise; precipitation floats 1e-5;
    clouds, wind and skinning 1e-6; textures within 1 u8 level."""
    from w3d_torch import convert
    from w3d_torch.export import textures as TX
    from w3d_torch.lighting import lmap as LM, trace as LT
    from w3d_torch.ops import noise as N
    from w3d_torch.ops.cuda import narrow_kernel as NK
    from w3d_torch.physics import cobjs as PC, step as PS
    from w3d_torch.scene import animation as AN, cobj as SC, loader as SL
    from w3d_torch.scene import read_mesh_formats as RF
    from w3d_torch.terrain import state_io as SIO
    from w3d_torch.utils import checkpoint as CK, kernel_probe as KP
    from w3d_torch.utils.constants import WorldConst
    from w3d_torch.veg import scenery as VS
    from w3d_torch.water import clouds as WC, precip as WP, snow as WSN

    cpu = torch.device("cpu")
    out = {"launches": {n: 0 for n in kernels}}
    clock = {"t": time.perf_counter()}

    def lap() -> str:
        """The seconds since the last lap, for a part's log line."""
        now = time.perf_counter()
        dt, clock["t"] = now - clock["t"], now
        return f"(part {dt:.1f} s)"

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    def timed(fn, reps: int = 1):
        """(result, median seconds of `reps` calls)."""
        ts = []
        for _ in range(reps):
            sync()
            t = time.perf_counter()
            r = fn()
            sync()
            ts.append(time.perf_counter() - t)
        return r, statistics.median(ts)

    def host(v):
        return convert.to_numpy(v)

    def same(a, b) -> bool:
        return all(np.array_equal(x, y, equal_nan=x.dtype.kind == "f")
                   for x, y in zip(_leaves(host(a)), _leaves(host(b))))

    def on_cpu(v):
        return type(v)(*(t.cpu() if isinstance(t, torch.Tensor) else t for t in v))

    reset_counts()
    scene = SL.load_scene(KP.write_ground_scene(tmp, "p", objects=GROUND_OBJS), device=dev)
    world, mesh, cobjs = scene.world, scene.terrain.mesh_height, scene.cobjs
    wz = float(scene.env.water_plane_z)

    # ---- scenery ----------------------------------------------------------
    def generate(s, m, w):
        plants = VS.gen_plants(s, m, w, water_z=wz)
        return (VS.gen_logs(s, m, w), plants, VS.gen_rocks(s, m, w),
                VS.plant_leaf_points(plants))

    parts = generate(scene.scenery, mesh, world)
    table = VS.scenery_cobjs(scene.scenery, *parts[:3], device=dev)
    cparts = generate(on_cpu(scene.scenery), mesh.cpu(), world)
    ctable = VS.scenery_cobjs(on_cpu(scene.scenery), *cparts[:3], device=cpu)
    kinds = np.bincount(host(scene.scenery.kind)[host(scene.scenery.valid)], minlength=5)
    need(same(parts, cparts) and same(table, ctable),
         "scenery on scene P: generators and packed cobjs bitwise card vs CPU")
    side, nobj = SCENERY_BIG
    big_world = WorldConst(mesh_x=side, mesh_y=side)
    rng = np.random.default_rng(3)
    zbig = (0.3 * rng.standard_normal((side, side))).astype(np.float32)
    nzbig = (rng.random((side, side)) > 0.05).astype(np.float32)

    def big(d):
        zt, nt = torch.as_tensor(zbig, device=d), torch.as_tensor(nzbig, device=d)
        s = VS.place_scenery(3, -side // 2, -side // 2, zt, nt, big_world, density=1.0,
                             max_objs=nobj)
        return (s,) + generate(s, zt, big_world)

    big(dev)
    gbig, t_big = timed(lambda: big(dev), reps=5)
    scenery_gen_ms = 1e3 * t_big
    need(same(gbig, big(cpu)) and int(gbig[0].valid.sum()) == nobj,
         f"scenery, {nobj} objects over {side}^2: bitwise card vs CPU, all placed")
    log(f"scenery: scene P's {int(kinds.sum())} objects (kinds {kinds.tolist()}), "
        f"{int((table.shape != 0).sum())} cobjs packed; {nobj} objects over a {side}^2 "
        f"mesh: placement and the four generators {scenery_gen_ms:.3f} ms (median of 5); "
        f"card vs CPU bitwise {lap()}")

    # ---- snow ---------------------------------------------------------------
    wind = (0.4, 0.2, 0.0)
    WSN.create_snow_map(mesh, cobjs, SNOW_BATCH, wind=wind, world=world, seed=1,
                        batch=SNOW_BATCH)
    (snow_z, cover), t_snow = timed(lambda: WSN.create_snow_map(
        mesh, cobjs, SNOW_RAYS, wind=wind, world=world, seed=1, batch=SNOW_BATCH))
    snow_rays_per_sec = SNOW_RAYS / t_snow
    need(bool(torch.isfinite(snow_z).all()) and float(cover.sum()) > 0.9 * SNOW_RAYS,
         "snow map: finite, most flakes on the map")
    nb, fb = SNOW_CHECK
    src = WSN.SnowDrawSource(2)
    n_cells = world.mesh_x * world.mesh_y
    sums = {"card": 0.0, "cpu": 0.0}
    moved = zdiff = 0
    cmesh, ccobjs = mesh.cpu(), on_cpu(cobjs)
    for i in range(nb):
        res = {}
        for name, d, m, c in (("card", dev, mesh, cobjs), ("cpu", cpu, cmesh, ccobjs)):
            res[name] = WSN.snow_batch(src.batch(i, fb, world, d), m, c,
                                       torch.tensor(wind, device=d), world)
            cell, z, ok = res[name]
            vals = torch.stack([torch.where(ok, z, 0.0), ok.to(torch.float32)], 1)
            sums[name] = sums[name] + LM.cell_sums(cell.long(), vals, n_cells).cpu()
        moved += int((res["card"][0].cpu() != res["cpu"][0]).sum())
        zdiff += int((res["card"][1].cpu() != res["cpu"][1]).sum())
    maps = {k: torch.where(v[:, 1] > 0, v[:, 0] / torch.clamp(v[:, 1], min=1.0),
                           cmesh.reshape(-1)) for k, v in sums.items()}
    own = WSN.create_snow_map(mesh, cobjs, nb * fb, wind=wind, world=world, batch=fb,
                              draws=src)
    log(f"snow: {SNOW_RAYS} rays in {SNOW_RAYS // SNOW_BATCH} batches over scene P "
        f"({cobjs.size} slots): {snow_rays_per_sec / 1e6:.3f} M rays/s "
        f"({t_snow:.3f} s), {int((cover > 0).sum())} of {n_cells} cells covered; card vs "
        f"CPU on {nb} batches of {fb}: {moved} of {nb * fb} flakes in another cell, "
        f"{zdiff} landing heights not equal, maps equal "
        f"{torch.equal(maps['card'], maps['cpu']) and torch.equal(sums['card'], sums['cpu'])} "
        f"{lap()}")
    need(moved == 0 and zdiff == 0 and torch.equal(sums["card"], sums["cpu"])
         and torch.equal(maps["card"], maps["cpu"])
         and torch.equal(own[0].reshape(-1).cpu(), maps["card"]),
         "snow: flakes and map bitwise card vs CPU on the same draws")
    depth = cover / cover.max()
    grid, t_bake = timed(lambda: LT.compute_sky_lighting(
        LM.make_light_grid(world, device=dev), cobjs, mesh, SNOW_BAKE_RAYS, seed=1,
        params=LT.TraceParams(), world=world, batch=SNOW_BATCH, snow_depth=depth))
    need(all(bool(torch.isfinite(t).all()) for t in grid) and float(grid.sv.sum()) > 0,
         "snow: the sky bake over the snow map is finite and lit")
    log(f"snow: sky bake of {SNOW_BAKE_RAYS} rays with the map as snow_depth "
        f"{1e3 * t_bake:.1f} ms, sky weight total {float(grid.sv.sum()):.1f} {lap()}")

    # ---- precipitation ------------------------------------------------------
    cloud_z = float(mesh.max()) + 0.2

    def precip_state(slots, balls, d, m):
        st = on_cpu(scene.objects) if d == cpu else scene.objects
        st = PS.ObjectState(*(a[:balls] for a in st))
        dead = PS.make_state(np.zeros((slots - balls, 3), np.float32),
                             np.zeros((slots - balls, 3), np.float32),
                             np.zeros(slots - balls, np.int32), m)
        dead = dead._replace(status=torch.zeros_like(dead.status))
        return PS.ObjectState(*(torch.cat([a, b]) for a, b in zip(st, dead)))

    def precip_run(st, env, c, tab, drops, frames, d):
        acc = torch.zeros((world.mesh_y, world.mesh_x), device=d)
        rain = torch.zeros((), device=d)
        landed_n = torch.zeros((), dtype=torch.int64, device=d)
        for f in range(frames):
            draws = WP.draw_precip(drops, torch.Generator().manual_seed(7000 + f), world, d)
            st = WP.spawn_precip(st, draws, "RAIN" if f % 2 == 0 else "SNOW", world,
                                 cloud_z=cloud_z)
            st = PS.step_objects(st, env, c, tab, substeps=4, world=world)
            acc, rv, landed = WP.accumulate_landed(acc, st, None, world)
            st = WP.retire_landed(st, landed)
            acc = WP.melt_accumulation(acc, PRECIP_TEMPERATURE)
            rain = rain + rv
            landed_n = landed_n + landed.sum()
        return st, acc, rain, landed_n

    slots, balls, drops, frames = PRECIP
    (pst, pacc, prain, plnd), t_pr = timed(lambda: precip_run(
        precip_state(slots, balls, dev, scene.table), scene.env, cobjs, scene.table,
        drops, frames, dev))
    precip_ms_per_frame = 1e3 * t_pr / frames
    need(int(plnd) > 0 and float(pacc.sum()) > 0 and float(prain) > 0
         and all(bool(torch.isfinite(getattr(pst, f)).all()) for f in ("px", "py", "pz")),
         "precipitation: drops landed, snow piled up, rain collected, finite")
    cs, cb, cd, cf = PRECIP_CHECK
    cenv, ctab = on_cpu(scene.env), on_cpu(scene.table)
    gres = precip_run(precip_state(cs, cb, dev, scene.table), scene.env, cobjs,
                      scene.table, cd, cf, dev)
    cres = precip_run(precip_state(cs, cb, cpu, ctab), cenv, ccobjs, ctab, cd, cf, cpu)
    fdiff = max(float((getattr(gres[0], f).cpu() - getattr(cres[0], f)).abs().max())
                for f in ("px", "py", "pz", "vx", "vy", "vz"))
    exact = all(torch.equal(getattr(gres[0], f).cpu(), getattr(cres[0], f))
                for f in ("status", "otype", "time", "flags"))
    log(f"precipitation: {slots} slots, {balls} balls, {drops} drops a frame, {frames} "
        f"frames of 4 substeps: {precip_ms_per_frame:.3f} ms a frame, {int(plnd)} drops "
        f"landed, snow {float(pacc.sum()):.1f}, rain volume {float(prain):.2f}, live "
        f"{int((pst.status > 0).sum())}; card vs CPU over {cf} frames ({cs} slots): "
        f"accumulation equal {torch.equal(gres[1].cpu(), cres[1])}, rain equal "
        f"{torch.equal(gres[2].cpu(), cres[2])}, landed {int(gres[3])}/{int(cres[3])}, "
        f"statuses equal {exact}, floats max diff {fdiff:.3g} {lap()}")
    need(torch.equal(gres[1].cpu(), cres[1]) and torch.equal(gres[2].cpu(), cres[2])
         and int(gres[3]) == int(cres[3]) and int(cres[3]) > 0 and exact and fdiff <= 1e-5,
         "precipitation, card vs CPU: accumulation, rain, statuses equal, floats 1e-5")

    # ---- clouds and wind ----------------------------------------------------
    n, times_n, npts = CLOUDS

    def layers(d):
        return torch.stack([WC.cloud_layer(float(t), 0.4, 0.2, n, n, device=d)
                            for t in range(times_n)])

    layers(dev)
    gl, t_cl = timed(lambda: layers(dev))
    cdiff = float((gl.cpu() - layers(cpu)).abs().max())
    pts = np.random.default_rng(4).uniform(-4, 4, (3, npts)).astype(np.float32)
    gw = WC.local_wind(*(torch.as_tensor(a, device=dev) for a in pts), (0.4, 0.2, 0.05), 3.0)
    cw = WC.local_wind(*(torch.as_tensor(a) for a in pts), (0.4, 0.2, 0.05), 3.0)
    wdiff = max(float((a.cpu() - b).abs().max()) for a, b in zip(gw, cw))
    log(f"clouds: {times_n} layers of {n}^2 {1e3 * t_cl:.2f} ms, cover mean "
        f"{float(gl.mean()):.3f}, card vs CPU max diff {cdiff:.3g}; local wind at {npts} "
        f"positions card vs CPU max diff {wdiff:.3g} {lap()}")
    need(cdiff <= 1e-6 and wdiff <= 1e-6 and 0 < float(gl.mean()) < 1,
         "clouds and wind, card vs CPU: 1e-6")

    # ---- model formats ------------------------------------------------------
    mdir = os.path.join(tmp, "models")
    os.makedirs(mdir)
    model = KP.grid_model(*MODEL_GRID)
    ref = model.positions[model.faces]
    paths = KP.write_model_files(mdir, model)
    model_load_ms = {}
    for fmt, path in paths.items():
        m, t_load = timed(lambda: RF.load_model(path))
        model_load_ms[fmt] = 1e3 * t_load
        need(np.array_equal(m.positions[m.faces], ref), f"model {fmt}: the OBJ's triangles")
    sdir = os.path.join(tmp, "scene_models")
    os.makedirs(sdir)
    spaths = KP.write_model_files(sdir, KP.grid_model(*SCENE_MODEL_GRID))
    place = [f"Z 0  {2.0 * (i % 4) - 3.0} {2.0 * (i // 4) - 3.0} 0.5\n"
             for i in range(len(spaths))]
    texts = {"all": "".join(f"O {os.path.basename(p)} 0 0 0\n" + z
                            for p, z in zip(spaths.values(), place)),
             "obj": "".join(f"O {os.path.basename(spaths['obj'])} 0 0 0\n" + z
                            for z in place)}
    packed = {}
    for k, text in texts.items():
        with open(os.path.join(sdir, f"scene_{k}.txt"), "w") as f:
            f.write(text)
        sp = SC.parse_coll_obj_file(os.path.join(sdir, f"scene_{k}.txt"))
        need(all(m.loaded for m in sp.models), f"DSL scene {k}: every model loaded")
        packed[k] = SC.pack_cobjs(sp, device=dev)
    need(same(packed["all"], packed["obj"]), "DSL scene: every format's table equals OBJ's")
    prng = np.random.default_rng(6)
    bx = prng.uniform(-4, 4, (3, GROUND_OBJS)).astype(np.float32)
    bx[2] = 0.5 + 0.4 * bx[2] / 4
    balls_g = [torch.as_tensor(a, device=dev) for a in bx] + [
        torch.full((GROUND_OBJS,), 0.05, device=dev)]
    hits_g = PC.deepest_hits(*balls_g, packed["all"])
    hits_c = PC.deepest_hits(*(b.cpu() for b in balls_g), on_cpu(packed["all"]))
    hits_k = NK.deepest_hits(*balls_g, PC.group_cobjs(packed["all"]))
    pen_d = float((hits_g[1].cpu() - hits_c[1]).abs().max())
    pen_k = float((hits_k[1] - hits_g[1]).abs().max())
    nhit = int(hits_g[0].sum())
    log(f"model formats: a {len(model.faces)}-triangle mesh in {len(paths)} formats, "
        f"load ms (host): " + ", ".join(f"{k} {v:.1f}" for k, v in model_load_ms.items())
        + f"; every format's triangles equal the OBJ's; a DSL scene naming every format "
        f"({int((packed['all'].shape != 0).sum())} cobjs) packs equal to the OBJ scene; "
        f"its narrow phase on the card: {nhit} of {GROUND_OBJS} balls hit, plain card vs "
        f"CPU pen max diff {pen_d:.3g}, kernel C vs plain {pen_k:.3g} {lap()}")
    need(nhit > 0 and torch.equal(hits_g[0].cpu(), hits_c[0]) and pen_d <= 1e-5
         and torch.equal(hits_k[0], hits_g[0]) and pen_k <= 1e-5,
         "DSL model scene narrow phase: hits equal, pen 1e-5 (card, CPU, kernel C)")

    # ---- skinning -----------------------------------------------------------
    nv, nbones = SKIN
    srng = np.random.default_rng(8)
    skel = AN.make_simple_skeleton(nbones)
    chans = {}
    for b in range(0, nbones, 2):
        q = srng.standard_normal((3, 4)).astype(np.float32)
        chans[b] = AN.AnimChannel(np.array([0.0, 0.5, 1.5], np.float32),
                                  srng.uniform(-0.2, 0.2, (3, 3)).astype(np.float32),
                                  q / np.linalg.norm(q, axis=1, keepdims=True),
                                  srng.uniform(0.8, 1.2, 3).astype(np.float32))
    mats = AN.evaluate_pose(skel, chans, 0.7, device=dev)
    w = srng.random((nv, 4)).astype(np.float32)
    sargs = (srng.uniform(-1, 1, (nv, 3)).astype(np.float32),
             srng.integers(0, nbones, (nv, 4)).astype(np.int32), w / w.sum(1, keepdims=True))

    def skin_args(d, m):
        pos, ids, wt = (torch.as_tensor(a, device=d) for a in sargs)
        return pos, AN.SkinWeights(ids, wt), m

    gargs = skin_args(dev, mats)
    sk_g = AN.skin_vertices(*gargs)
    skin_ms = KP.events_ms(lambda: AN.skin_vertices(*gargs), launches=20)
    sdiff = float((sk_g.cpu() - AN.skin_vertices(*skin_args(cpu, mats.cpu()))).abs().max())
    log(f"skinning: {nv} vertices over {nbones} bones {skin_ms:.4f} ms (CUDA events "
        f"around 20 calls), card vs CPU max diff {sdiff:.3g} {lap()}")
    need(sdiff <= 1e-6 and bool(torch.isfinite(sk_g).all()), "skinning, card vs CPU: 1e-6")

    # ---- textures -----------------------------------------------------------
    tex = {}
    worst = 0
    for name in ("cloud", "marble", "plasma", "noise"):
        fn = getattr(TX, f"{name}_texture")
        tex[name] = TX.texture_to_u8(fn(TEXTURE_N, device=dev))
        d = np.abs(tex[name].astype(np.int32)
                   - TX.texture_to_u8(fn(TEXTURE_N, device=cpu)).astype(np.int32))
        worst = max(worst, int(d.max()))
        need(int(d.max()) <= (0 if name == "noise" else 1),
             f"texture {name}, card vs CPU: within 1 u8 level (noise equal)")
    rgb = np.repeat(tex["cloud"][..., None], 3, -1)
    rgba = np.concatenate([tex["plasma"].transpose(1, 2, 0), tex["marble"][..., None]], -1)
    e1, e5 = TX.dxt1_encode(rgb), TX.dxt5_encode(rgba)
    same_bytes = all(np.array_equal(a, b) for a, b in zip(e1, TX.dxt1_encode(rgb))) and \
        all(np.array_equal(a, b) for a, b in zip(e5, TX.dxt5_encode(rgba)))
    err1 = float(np.abs(TX.dxt1_decode(*e1).astype(int) - rgb.astype(int)).mean())
    err5 = float(np.abs(TX.dxt5_decode(*e5)[..., 3].astype(int)
                        - rgba[..., 3].astype(int)).mean())
    log(f"textures: cloud, marble, plasma and noise at {TEXTURE_N}^2, card vs CPU at most "
        f"{worst} u8 level apart; DXT1 of the cloud texture (mean error {err1:.2f} "
        f"levels) and DXT5 of the plasma texture with the marble texture as alpha (alpha "
        f"error {err5:.2f}), "
        f"bytes equal on a second encode {same_bytes} {lap()}")
    need(same_bytes and err1 < 6.0 and err5 < 12.0, "DXT1/DXT5: bytes equal, errors bounded")

    # ---- state and checkpoint I/O -------------------------------------------
    ck = os.path.join(tmp, "state.npz")
    CK.save_pytree(ck, pst)
    back = CK.load_pytree(ck, pst)
    need(all(torch.equal(a, b) and a.device == b.device for a, b in zip(back, pst)),
         "checkpoint of the 10,240-slot state: bitwise after the round trip, on the card")
    mpath = os.path.join(tmp, "mesh.txt")
    SIO.write_mesh(mpath, mesh)
    hback = SIO.read_mesh(mpath, expect_shape=tuple(mesh.shape))
    st_path = os.path.join(tmp, "state.txt")
    table_t = torch.stack(list(N.gen_sine_table(world, device=dev)), 1)
    SIO.save_state(st_path, SIO.SimState(2.5, 0.1, 1.2, (1.0, 2.0, 3.0), (0.0, 0.0, 0.5),
                                         0, 0, 0, 0, 7, 40014, 40692, world.mesh_x,
                                         world.mesh_y, 9, 10, table_t))
    sback = SIO.load_state(st_path, expect_dims=(world.mesh_x, world.mesh_y, 9, 10))
    mdiff = float(np.abs(hback - host(mesh)).max())
    tdiff = float(np.abs(sback.sine_table - host(table_t)).max())
    log(f"state: checkpoint of {slots} slots bitwise; mesh text file round trip max diff "
        f"{mdiff:.3g}, sine table {tdiff:.3g} (6 decimals in the file) {lap()}")
    need(mdiff <= 1.5e-6 and tdiff <= 1e-6 * max(1.0, float(table_t.abs().max())),
         "state text files: within their 6 decimals")

    c = read_counts("scenery, weather and formats", ("sample", "narrow", "pairs"))
    for k in c:
        out["launches"][k] += c[k]
    out.update(scenery_gen_ms=scenery_gen_ms, snow_rays_per_sec=snow_rays_per_sec,
               precip_ms_per_frame=precip_ms_per_frame, model_load_ms=model_load_ms,
               skin_ms=skin_ms, snow_flakes_moved=moved)
    return out


def _sharded_inputs():
    """The inputs of phase 3n, made on the host from fixed seeds (the same
    for the ranks and for this process's single-rank references)."""
    from w3d_torch.models import physics_model as PM
    from w3d_torch.models import terrain_model as TMOD
    from w3d_torch.utils.constants import WorldConst

    world = WorldConst()
    gen = torch.Generator().manual_seed(77)
    pos, vel = PM.spawn(SHARD_OBJS, gen, device="cpu")
    tcfg = TMOD.TileModelConfig(tile_size=128, erosion_iters_tt=512, erosion_batch=512,
                                erosion_steps=64, use_pallas_erosion=True)
    tiles = TMOD.example_inputs(tcfg, world, gen, num_tiles=NUM_TILES, device="cpu")
    ecfg = TMOD.TileModelConfig(tile_size=128, erosion_iters_tt=512, erosion_batch=128,
                                erosion_steps=64, use_pallas_erosion=True)
    etiles = TMOD.example_inputs(ecfg, world, gen, num_tiles=8, device="cpu")
    epos, evel = PM.spawn(2048, gen, device="cpu")
    walls = torch.zeros((16, 128, 128))
    walls[3, :, 100] = 12.0      # from -x its shadow runs 640 cells: ranks 0 -> 2
    walls[12, :, 30] = 6.0       # from +x 320 cells: rank 3 -> 2
    rough = torch.rand((16, 128, 128), generator=gen) * 2.0
    return dict(world=world, pos=pos, vel=vel, tcfg=tcfg, tiles=tiles, ecfg=ecfg,
                etiles=etiles, epos=epos, evel=evel, walls=walls, rough=rough)


def _to(value, dev):
    """Tensors of a (nested) tuple or dict onto `dev`."""
    if isinstance(value, torch.Tensor):
        return value.to(dev)
    if isinstance(value, dict):
        return {k: _to(v, dev) for k, v in value.items()}
    if isinstance(value, tuple):
        items = [_to(v, dev) for v in value]
        return type(value)(*items) if hasattr(value, "_fields") else tuple(items)
    return value


SHADOW_LIGHTS = {"from_-x": (-1.0, 0.0, 0.3), "from_+x": (1.0, 0.0, 0.3)}


def rank_3n(mesh, inp: dict) -> dict:
    """One rank of phase 3n (spawned by `run_ranks`; every rank on the
    card).  Rank 0 returns the gathered results, every rank its timings,
    launches and bytes received."""
    from w3d_torch import entry as EN
    from w3d_torch.lighting import lmap as LM, parallel as LPAR, trace as LT
    from w3d_torch.models import physics_model as PM
    from w3d_torch.models import terrain_model as TMOD
    from w3d_torch.ops import shadows as SH
    from w3d_torch.ops.cuda import pairs_kernel as PK
    from w3d_torch.parallel import halo as PH, launch as LA
    from w3d_torch.parallel.mesh import all_gather_stack, barrier, gather_leading, local_block
    from w3d_torch.parallel.pairs import make_step_objects_sharded
    from w3d_torch.scene import cobj as SC
    from w3d_torch.utils import kernel_probe as KP

    dev, world = mesh.device, inp["world"]
    out, keep = {}, {}

    def timed(fn):
        barrier(mesh)
        t0 = time.perf_counter()
        r = fn()
        barrier(mesh)
        return r, time.perf_counter() - t0

    # the sharded 10K frame; D's calls recorded (rows, i_limit)
    calls = []
    plain_pairs = PK.banded_pairs

    def spy(*a, **kw):
        calls.append((a[0].shape[0], kw.get("i_limit")))
        return plain_pairs(*a, **kw)
    PK.banded_pairs = spy
    sw = PM.build_spheres_world(inp["pos"].to(dev), inp["vel"].to(dev), world=world, device=dev)
    step = make_step_objects_sharded(mesh, substeps=SUBSTEPS, world=world, window=WINDOW,
                                     pair_every=5, water=False)
    slab = local_block(sw.state, mesh)
    frames, frame_s, frame_bytes, frame_d = [], [], [], []
    for _ in range(3):
        mesh.traffic.reset()
        c0 = LA.launch_counts()["pairs"]
        slab, dt = timed(lambda: step(slab, sw.env, sw.cobjs, sw.table))
        frame_s.append(dt)
        frame_bytes.append(mesh.traffic.bytes)
        frame_d.append(LA.launch_counts()["pairs"] - c0)
        frames.append(gather_leading(slab, mesh))
    PK.banded_pairs = plain_pairs
    out.update(frame_s=frame_s, frame_bytes=frame_bytes, frame_d=frame_d,
               d_calls=sorted(set(calls)), slab=slab.px.shape[0])
    keep["frames"] = frames

    # the sharded tile step, 64 tiles a rank
    table, x0, y0, ze, wpz, ang = _to(inp["tiles"], dev)
    tstep = TMOD.make_sharded_tile_step(mesh, inp["tcfg"], world)
    c0 = LA.launch_counts()["erosion"]
    tiles, t_first = timed(lambda: tstep(table, x0, y0, ze, wpz, ang))
    _, t_tiles = timed(lambda: tstep(table, x0, y0, ze, wpz, ang))
    out.update(tile_s=(t_first, t_tiles), tile_a=LA.launch_counts()["erosion"] - c0)
    keep["tiles"] = gather_leading(tiles, mesh)

    # the sharded combined step at entry()'s shapes
    esw = PM.build_spheres_world(inp["epos"].to(dev), inp["evel"].to(dev), world=world,
                                 device=dev)
    cstep = EN.make_sharded_combined_step(mesh, inp["ecfg"], world, substeps=4)
    (ctiles, cst), t_comb = timed(lambda: cstep(*_to(inp["etiles"], dev),
                                                local_block(esw.state, mesh), esw))
    out["combined_s"] = t_comb
    keep["combined"] = (gather_leading(ctiles, mesh), gather_leading(cst, mesh))

    # shadows across ranks and the AO halo context
    walls, rough = inp["walls"].to(dev), inp["rough"].to(dev)
    init = torch.full((128,), SH.MESH_MIN_Z, device=dev)
    keep["shadows"], out["shadow_s"] = {}, {}
    for name, light in SHADOW_LIGHTS.items():
        for mode in ("exact", "carry"):
            run = PH.make_sharded_shadow_scan(mesh, light, 0.0625, mode=mode)
            sh, dt = timed(lambda: run(local_block(walls, mesh), init))
            keep["shadows"][name, mode] = gather_leading(sh, mesh)
            out["shadow_s"][name, mode] = dt
    ctx, out["halo_s"] = timed(lambda: PH.make_halo_context(mesh, 36)(local_block(rough, mesh)))
    keep["halo"] = gather_leading(ctx, mesh)

    # the sky bake, 65,536 rays a rank, twice
    cobjs = SC.pack_cobjs(KP.lighting_bench_scene(), device=dev)
    hf = torch.full((world.mesh_y, world.mesh_x), -0.6, device=dev)
    c0 = LA.launch_counts()["sample"]
    mesh.traffic.reset()

    def bake():
        return LPAR.compute_sky_lighting_sharded(
            mesh, LM.make_light_grid(world, device=dev), cobjs, hf, SHARD_RANKS * SHARD_RAYS,
            seed=7, params=LT.TraceParams(), world=world, batch=SHARD_RAYS)
    ga, ta = timed(bake)
    gb, tb = timed(bake)
    out.update(bake_s=(ta, tb), bake_b=LA.launch_counts()["sample"] - c0, bake_bytes=mesh.traffic.bytes,
               bake_same=all(torch.equal(a, b) for a, b in zip(ga, gb)))
    # the merge alone: the all_gather of the 12 channels, staged through the host
    vol = torch.zeros((len(LPAR.ACCUM_FIELDS),) + tuple(ga.sv.shape), device=dev)
    _, out["merge_s"] = timed(lambda: all_gather_stack(vol, mesh))
    keep["bake"] = ga
    if mesh.rank == 0:
        out.update(keep)
    return out


def rank_3n_nccl(mesh, inp: dict) -> dict:
    """Phase 3n on one rank over NCCL: the sharded 10K frame (3 frames) and
    the sky bake, for comparison with the unsharded calls."""
    from w3d_torch.lighting import lmap as LM, parallel as LPAR, trace as LT
    from w3d_torch.models import physics_model as PM
    from w3d_torch.parallel.mesh import gather_leading, local_block
    from w3d_torch.parallel.pairs import make_step_objects_sharded
    from w3d_torch.scene import cobj as SC
    from w3d_torch.utils import kernel_probe as KP

    dev, world = mesh.device, inp["world"]
    sw = PM.build_spheres_world(inp["pos"].to(dev), inp["vel"].to(dev), world=world, device=dev)
    step = make_step_objects_sharded(mesh, substeps=SUBSTEPS, world=world, window=WINDOW,
                                     pair_every=5, water=False)
    slab, frames = local_block(sw.state, mesh), []
    for _ in range(3):
        slab = step(slab, sw.env, sw.cobjs, sw.table)
        frames.append(gather_leading(slab, mesh))
    grid = LPAR.compute_sky_lighting_sharded(
        mesh, LM.make_light_grid(world, device=dev),
        SC.pack_cobjs(KP.lighting_bench_scene(), device=dev),
        torch.full((world.mesh_y, world.mesh_x), -0.6, device=dev), SHARD_RAYS, seed=7,
        params=LT.TraceParams(), world=world, batch=SHARD_RAYS)
    return {"frames": frames, "bake": grid, "backend": mesh.backend}


def run_sharded_phase(dev, smi: str) -> dict:
    """Phase 3n: the multi-device layer, four ranks sharing this card over
    gloo, then one rank over NCCL, each against the single-rank calls here.
    Returns the metrics and the launches summed over the ranks."""
    from w3d_torch import entry as EN
    from w3d_torch.lighting import lmap as LM, parallel as LPAR, trace as LT
    from w3d_torch.models import physics_model as PM
    from w3d_torch.models import terrain_model as TMOD
    from w3d_torch.ops import shadows as SH
    from w3d_torch.parallel import launch as LA
    from w3d_torch.physics import step as PS
    from w3d_torch.scene import cobj as SC
    from w3d_torch.utils import kernel_probe as KP

    label = f"4 ranks on one card, gloo through the host; {smi}"
    inp = _sharded_inputs()
    world = inp["world"]
    t0 = time.perf_counter()
    ranks = LA.run_ranks(rank_3n, SHARD_RANKS, "gloo", "cuda:0", inp, timeout=600)
    log(f"3n: {SHARD_RANKS} gloo ranks on cuda:0 ran in {time.perf_counter() - t0:.1f} s "
        f"(spawn and CUDA start included)")
    r0 = ranks[0].value
    for r, res in enumerate(ranks):
        v = res.value
        log(f"3n rank {r}: launches {res.launches}; D launches a frame {v['frame_d']}, "
            f"calls (rows, i_limit) {v['d_calls']}; A launches {v['tile_a']}; B in the bakes "
            f"{v['bake_b']}")
        need(all(d > 0 for d in v["frame_d"]), f"3n rank {r}: D launched in every frame")
        need(v["d_calls"] == [(v["slab"] + WINDOW, v["slab"])],
             f"3n rank {r}: D over slab + halo rows with i_limit = the slab")
        need(v["slab"] < SHARD_OBJS, "3n: i_limit below n")
        for k in ("erosion", "sample", "narrow", "pairs"):
            need(res.launches[k] > 0, f"3n rank {r}: {k} launched")
        need(v["bake_same"], f"3n rank {r}: two bakes of one seed bitwise equal")

    # the sharded 10K frame against single-rank step_objects
    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        return r, time.perf_counter() - t0

    sw = PM.build_spheres_world(inp["pos"].to(dev), inp["vel"].to(dev), world=world, device=dev)
    st, singles, single_s = sw.state, [], []
    for _ in range(3):
        st, dt = timed(lambda: PS.step_objects(
            st, sw.env, sw.cobjs, sw.table, substeps=SUBSTEPS, world=world, obj_collisions=True,
            pair_window=WINDOW, pair_every=5, water=False))
        singles.append(st)
        single_s.append(dt)
    for f, (a, b) in enumerate(zip(singles, r0["frames"])):
        need(torch.equal(a.status.cpu(), b.status) and torch.equal(a.flags.cpu(), b.flags),
             f"3n frame {f}: status and flags equal to single-rank step_objects")
        errs = {}
        for name in ("px", "py", "pz", "vx", "vy", "vz"):
            x, y = getattr(a, name).cpu(), getattr(b, name)
            errs[name] = float((x - y).abs().max())
            need(bool(((x - y).abs() <= 2e-5 + 2e-4 * x.abs()).all()),
                 f"3n frame {f}: {name} within rtol 2e-4, atol 2e-5")
        log(f"3n sharded 10K frame {f} vs single rank: max |diff| "
            + ", ".join(f"{k} {v:.3g}" for k, v in errs.items())
            + f"; bitwise {all(torch.equal(getattr(a, k).cpu(), getattr(b, k)) for k in PS.ObjectState._fields)}")
    alive = int((r0["frames"][-1].status > 0).sum())
    need(alive > 0.9 * SHARD_OBJS, f"3n: alive {alive}")
    frame_ms = [1e3 * statistics.median(res.value["frame_s"][f] for res in ranks)
                for f in range(3)]
    frame_bytes = [sum(res.value["frame_bytes"][f] for res in ranks) for f in range(3)]
    log(f"3n sharded 10K frame ({label}): ms per frame {[round(x, 3) for x in frame_ms]}, "
        f"bytes received a frame over all ranks {frame_bytes}; one process here, the same "
        f"frames: {[round(1e3 * x, 3) for x in single_s]} ms")

    # the tile step against one call
    targs = _to(inp["tiles"], dev)
    tiles1 = TMOD.tile_batch_step(*targs, inp["tcfg"], world)
    _, t_one = timed(lambda: TMOD.tile_batch_step(*targs, inp["tcfg"], world))
    need(torch.equal(tiles1.cpu(), r0["tiles"]), "3n sharded tile step bitwise the single call")
    t_tiles = statistics.median(res.value["tile_s"][1] for res in ranks)
    log(f"3n sharded tile step ({label}): 256 tiles in {1e3 * t_tiles:.1f} ms, "
        f"{NUM_TILES / t_tiles:.1f} tiles/s (first call "
        f"{1e3 * r0['tile_s'][0]:.1f} ms); bitwise equal to the single-rank call, which took "
        f"{1e3 * t_one:.1f} ms here ({NUM_TILES / t_one:.1f} tiles/s)")

    # the combined step against combined_step
    esw = PM.build_spheres_world(inp["epos"].to(dev), inp["evel"].to(dev), world=world,
                                 device=dev)
    etiles, est = EN.combined_step(*_to(inp["etiles"], dev), esw.state, esw, inp["ecfg"],
                                   world, substeps=4)
    ctiles, cst = r0["combined"]
    need(torch.equal(etiles.cpu(), ctiles), "3n combined step: tiles bitwise")
    need(torch.equal(est.status.cpu(), cst.status), "3n combined step: status equal")
    cerr = max(float((getattr(est, k).cpu() - getattr(cst, k)).abs().max())
               for k in ("px", "py", "pz", "vx", "vy", "vz"))
    need(all(bool(((getattr(est, k).cpu() - getattr(cst, k)).abs()
                   <= 2e-5 + 2e-4 * getattr(est, k).cpu().abs()).all())
             for k in ("px", "py", "pz", "vx", "vy", "vz")),
         "3n combined step: objects within rtol 2e-4, atol 2e-5")
    log(f"3n sharded combined step (entry shapes, {label}): {1e3 * r0['combined_s']:.1f} ms, "
        f"tiles bitwise, objects max |diff| {cerr:.3g}")

    # shadows and the halo context
    walls = inp["walls"].to(dev)
    strip = torch.cat(list(walls), dim=1)
    for name, light in SHADOW_LIGHTS.items():
        whole, _ = SH.mesh_shadows(strip, light, cell_w=0.0625)
        exact = r0["shadows"][name, "exact"]
        need(torch.equal(torch.cat(list(exact), dim=1), whole.cpu()),
             f"3n shadows {name}: exact bitwise one scan of the strip")
        need(torch.equal(r0["shadows"][name, "carry"], exact), f"3n shadows {name}: carry == exact")
        crossing = sorted({t // 4 for t in range(16) if bool(exact[t].any())})
        need(len(crossing) >= 2, f"3n shadows {name}: the shadow crosses ranks")
        log(f"3n shadows {name}: exact {1e3 * r0['shadow_s'][name, 'exact']:.1f} ms, carry "
            f"{1e3 * r0['shadow_s'][name, 'carry']:.1f} ms ({label}); bitwise the strip scan, "
            f"shadowed ranks {crossing}")
    rough = inp["rough"]
    left = torch.cat([rough[:1, :, :36], rough[:-1, :, -36:]])
    right = torch.cat([rough[1:, :, :36], rough[-1:, :, -36:]])
    need(torch.equal(r0["halo"], torch.cat([left, rough, right], -1)),
         "3n AO halo context: every tile's 36-column halos")
    log(f"3n AO halo context, halo 36, 16 tiles: {1e3 * r0['halo_s']:.1f} ms; exact")

    # the bake against four single-rank chains, summed in rank order
    cobjs = SC.pack_cobjs(KP.lighting_bench_scene(), device=dev)
    hf = torch.full((world.mesh_y, world.mesh_x), -0.6, device=dev)
    params = LT._auto_transmission(LT.TraceParams(), cobjs)
    draws = LT.DrawSource(dev)
    vols, chain_s = [], []
    for r in range(SHARD_RANKS):
        def chain():
            local = LM.make_light_grid(world, device=dev)
            rays = LT.sky_rays(draws(7, r, 0, 1), SHARD_RAYS, world,
                               ray_weight=float(SHARD_RAYS))
            return LT.trace_batch(local, cobjs, hf, *rays, draws(7, r, 0, 2),
                                  ltype=LM.LIGHTING_SKY, params=params, world=world)
        local, dt = timed(chain)
        chain_s.append(dt)
        vols.append(torch.stack([getattr(local, f) for f in LPAR.ACCUM_FIELDS]))
    total = vols[0]
    for v in vols[1:]:
        total = total + v
    bake = r0["bake"]
    need(all(torch.equal(getattr(bake, f), total[i].cpu())
             for i, f in enumerate(LPAR.ACCUM_FIELDS)),
         "3n sky bake bitwise the rank-order sum of four single-rank chains")
    need(float(bake.sv.sum()) > 0 and bool(torch.isfinite(bake.sv).all()), "3n bake lit")
    t_bake = statistics.median(res.value["bake_s"][1] for res in ranks)
    rays_s = SHARD_RANKS * SHARD_RAYS / t_bake
    log(f"3n sharded sky bake ({label}): {SHARD_RANKS} x {SHARD_RAYS} rays in "
        f"{1e3 * t_bake:.1f} ms, {rays_s / 1e6:.3f} M rays/s (first bake "
        f"{1e3 * r0['bake_s'][0]:.1f} ms), bytes received over all ranks "
        f"{sum(res.value['bake_bytes'] for res in ranks)} for two bakes, the merge alone "
        f"{1e3 * statistics.median(res.value['merge_s'] for res in ranks):.1f} ms; bitwise run "
        f"to run and equal to the rank-order sum of four single-rank chains, which took "
        f"{[round(1e3 * x, 1) for x in chain_s]} ms here one after another "
        f"({SHARD_RANKS * SHARD_RAYS / sum(chain_s) / 1e6:.3f} M rays/s)")

    # one rank over NCCL against the unsharded calls
    t0 = time.perf_counter()
    one = LA.run_ranks(rank_3n_nccl, 1, "nccl", None, inp, timeout=300)[0]
    v = one.value
    need(v["backend"] == "nccl", "3n: the one-rank group runs NCCL")
    same = [all(torch.equal(getattr(a, k).cpu(), getattr(b, k)) for k in PS.ObjectState._fields)
            for a, b in zip(singles, v["frames"])]
    for f, (a, b) in enumerate(zip(singles, v["frames"])):
        need(torch.equal(a.status.cpu(), b.status), f"3n nccl frame {f}: status equal")
        for k in ("px", "py", "pz", "vx", "vy", "vz"):
            x, y = getattr(a, k).cpu(), getattr(b, k)
            need(bool(((x - y).abs() <= 2e-5 + 2e-4 * x.abs()).all()),
                 f"3n nccl frame {f}: {k} within rtol 2e-4, atol 2e-5")
    bake_same = all(torch.equal(getattr(v["bake"], f), vols[0][i].cpu())
                    for i, f in enumerate(LPAR.ACCUM_FIELDS))
    need(float(v["bake"].sv.sum()) > 0, "3n nccl bake lit")
    log(f"3n one rank over NCCL ({time.perf_counter() - t0:.1f} s): frames bitwise "
        f"single-rank step_objects {same}; bake bitwise rank 0's single chain {bake_same}; "
        f"launches {one.launches}")
    launches = {n: sum(res.launches[n] for res in ranks) + one.launches[n]
                for n in ranks[0].launches}
    return {"launches": launches,
            "sharded_ms_per_frame_10k_4ranks_1card": statistics.median(frame_ms),
            "sharded_bytes_per_frame_10k": statistics.median(frame_bytes),
            "sharded_tiles_per_sec_4ranks_1card": NUM_TILES / t_tiles,
            "sharded_sky_rays_per_sec_4ranks_1card": rays_s}


# ---- 3o: the agent-sharded city frame and the ship-sharded combat frame ----

AGENT_FRAMES = 32        # one chunk of chained frames (bench_live_tiled's, app.py's)


def _agent_inputs(dev, tmp: str) -> dict:
    """The inputs of phase 3o on the host: 3g's tiled world's city after its
    first chunk with the next chunk's draws, and 3h's scale point's combat
    state (the fleets 0.17 closer) with 32 frames of draws."""
    from w3d_torch.universe import combat as UCB, ship_config as USC, ships as USH
    from w3d_torch.utils import kernel_probe as KP
    from w3d_torch.utils import profile_step as PROF

    tw = PROF.tiled_world(dev, chunk=AGENT_FRAMES)
    tw.step_chunk(0.0, 0.0)
    city = dict(cs=tw.city, graph=tw.road_graph, nav=tw.ped_nav, pads=tw.pads,
                perches=tw.perches, rail=tw.rail,
                draws=tw.draws.city(tw.frame, AGENT_FRAMES, tw))
    defs = USC.parse_ship_defs(KP.write_ship_defs(os.path.join(tmp, "ship_defs_x8.txt"),
                                                  SCALE_MULTIPLIER))
    ct = UCB.build_combat_tables(defs, device="cpu")
    rng = np.random.default_rng(5)
    fl, _t, _o, _n = USH.fleet_from_defs(
        defs, lambda n: rng.uniform(-1.0, 1.0, (n, 3)).astype(np.float32))
    n0 = len(fl.px)
    cs = UCB.make_combat_state(UCB.pad_fleet(fl, n0 + max(16, n0 // 4)), ct, pool_size=1024)
    cs = cs._replace(fleet=cs.fleet._replace(px=cs.fleet.px - 0.17 * (cs.fleet.align == 5)))
    draws = UCB.draw_combat(AGENT_FRAMES, *cs.cool.shape, torch.Generator().manual_seed(9))
    # a shuttle in slot 4 (rank 1) boards the disabled frigate in slot 0 (rank 0)
    tbl = USC.ship_class_table(defs)
    gap = 0.8 * UCB.BOARD_REACH * (tbl[17, 7] + tbl[2, 7])
    rows = np.zeros(16, np.int32)
    rows[0], rows[4] = 2, 17
    z = np.zeros(16, np.float32)
    px = z.copy()
    px[0] = gap
    alive = np.zeros(16, bool)
    alive[[0, 4]] = True
    ai = np.full(16, USH.AI_ATT_ENEMY, np.int32)
    ai[0] = USH.AI_NONE
    sh, ar = tbl[rows, 3].copy(), tbl[rows, 2].copy()
    sh[0], ar[0] = 0.0, 0.2 * tbl[2, 2]
    bf = USH.FleetState(px=px, py=z, pz=z, vx=z, vy=z, vz=z, cls=rows,
                        align=(np.arange(16) == 0).astype(np.int32), armor=ar, shields=sh,
                        cooldown=z, alive=alive, ai=ai)
    board = UCB.make_combat_state(bf, ct, pool_size=16)
    bdraws = UCB.draw_combat(12, 16, ct.slot_wid.shape[1], torch.Generator().manual_seed(10))
    return _to(dict(city=city, combat=(cs, ct, draws), board=(board, bdraws)), "cpu")


def _non_dyadic(ct):
    """The combat tables with every weapon's damage 1.1 times as much: beam,
    PD and impact damages whose sums round by their order."""
    from w3d_torch.universe import combat as UCB
    w = ct.w_tbl.clone()
    w[:, UCB.WF_DAMAGE] *= 1.1
    return ct._replace(w_tbl=w)


def _column_sum_rounding(dev) -> dict:
    """Of N = 1,560 one-hot column sums (each ship's target among N,
    non-dyadic amounts), how many a rank's [N, N/4] block rounds apart from
    the [N, N] one on `dev`, summed by `torch.sum` and by the row-order
    scan of `universe.combat._columns`, rank by rank."""
    from w3d_torch.universe import combat as UCB
    n = 1560
    gen = torch.Generator().manual_seed(3)
    idx = torch.randint(0, n, (n,), generator=gen).to(dev)
    amt = (1.1 * torch.randint(1, 64, (n,), generator=gen).float()).to(dev)
    cols = torch.arange(n, device=dev)

    def by_sum(c):
        oh = (idx.long()[:, None] == c[None, :]).to(torch.float32)
        return torch.sum(oh * amt[:, None], dim=0)

    out = {}
    for name, fn in (("torch.sum", by_sum), ("row-order scan", lambda c: UCB._columns(idx, amt, c))):
        whole = fn(cols)
        part = torch.cat([fn(c) for c in cols.chunk(SHARD_RANKS)])
        out[name] = int((whole != part).sum())
    return out


def _city_chunk(frames_of, loc, c):
    return frames_of(loc, c["graph"], c["nav"], c["pads"], c["perches"], AGENT_FRAMES,
                     c["draws"], rail=c["rail"])


def rank_3o(mesh, inp: dict) -> dict:
    """One rank of phase 3o: the sharded city chunk and combat chunk, each
    twice, the scripted boarding and the dry run.  Rank 0 returns the
    gathered states; every rank its timings, bytes and counts."""
    from w3d_torch import dryrun as DR
    from w3d_torch.parallel import city as PCITY, combat as PCOMBAT
    from w3d_torch.parallel.mesh import barrier

    dev = mesh.device
    out, keep = {}, {}

    def timed(fn):
        barrier(mesh)
        t0 = time.perf_counter()
        r = fn()
        barrier(mesh)
        return r, time.perf_counter() - t0

    c = _to(inp["city"], dev)
    frames_of = PCITY.make_sharded_city_frames(mesh)
    loc0 = PCITY.shard_city(c["cs"], mesh)
    out["city_s"], out["city_bytes"], keep["city"] = [], [], []
    for _ in range(2):
        mesh.traffic.reset()
        loc, dt = timed(lambda: _city_chunk(frames_of, loc0, c))
        out["city_s"].append(dt)
        out["city_bytes"].append(mesh.traffic.bytes)
        keep["city"].append(PCITY.unshard_city(loc, mesh))

    cs, ct, draws = _to(inp["combat"], dev)
    battle = PCOMBAT.make_sharded_combat_frames(mesh, ct)
    loc0 = PCOMBAT.shard_combat(cs, mesh)
    out["combat_s"], out["combat_bytes"], keep["combat"] = [], [], []
    # the first chunk counts the events, the second (timed) counts nothing
    for counts in ({}, None):
        mesh.traffic.reset()
        loc, dt = timed(lambda: battle(loc0, draws, AGENT_FRAMES, counts))
        out["combat_s"].append(dt)
        out["combat_bytes"].append(mesh.traffic.bytes)
        if counts is not None:
            out["counts"] = counts
        keep["combat"].append(PCOMBAT.unshard_combat(loc, mesh))
    keep["combat_nd"] = PCOMBAT.unshard_combat(PCOMBAT.make_sharded_combat_frames(
        mesh, _non_dyadic(ct))(loc0, draws, AGENT_FRAMES), mesh)

    board, bdraws = _to(inp["board"], dev)
    out["board_counts"] = {}
    keep["board"] = PCOMBAT.unshard_combat(
        battle(PCOMBAT.shard_combat(board, mesh), bdraws, bdraws.board1.shape[0],
               out["board_counts"]), mesh)
    out["dryrun"] = DR.run(mesh)
    if mesh.rank == 0:
        out.update(keep)
    return out


def rank_3o_nccl(mesh, inp: dict) -> dict:
    """Phase 3o on one rank over NCCL: the dry run's seven phases, and its
    phases 6 and 7 at the 4-rank sizes (2 frames each), sharded over this
    one rank."""
    from w3d_torch import dryrun as DR
    from w3d_torch.parallel import city as PCITY, combat as PCOMBAT

    dev = mesh.device
    cs, graph, nav, cdraws = _to(inp["city"], dev)
    city = PCITY.unshard_city(PCITY.make_sharded_city_frames(mesh)(
        PCITY.shard_city(cs, mesh), graph, nav, None, None, 2, cdraws), mesh)
    ucs, ct, udraws = _to(inp["combat"], dev)
    combat = PCOMBAT.unshard_combat(PCOMBAT.make_sharded_combat_frames(mesh, ct)(
        PCOMBAT.shard_combat(ucs, mesh), udraws, 2), mesh)
    return {"line": DR.run(mesh), "city": city, "combat": combat, "backend": mesh.backend}


def _max_field_diff(a, b) -> dict:
    """{field path: max |a - b|} over the tensors of two state trees that
    differ in a bit (empty when they are equal bit for bit)."""
    out = {}

    def walk(x, y, path):
        if x is None:
            return
        if isinstance(x, tuple):
            for name, u, v in zip(x._fields, x, y):
                walk(u, v, f"{path}.{name}")
            return
        x, y = x.cpu(), y.cpu()
        if x.dtype != y.dtype or x.shape != y.shape:
            out[path] = "dtype or shape"
        elif x.numpy().tobytes() != y.numpy().tobytes():
            out[path] = float((x.double() - y.double()).abs().max())
    walk(a, b, "")
    return out


def run_agent_sharded_phase(dev, smi: str) -> dict:
    """Phase 3o: the agent-sharded city and ship-sharded combat frames over
    four gloo ranks on this card and one NCCL rank, each against the
    single-rank calls here.  Returns the metrics and the launches summed
    over the ranks (the dry run's phases 1-5 launch A-D)."""
    from w3d_torch import dryrun as DR
    from w3d_torch.city import city_step as CS
    from w3d_torch.parallel import launch as LA
    from w3d_torch.universe import combat as UCB

    label = f"4 ranks on one card, gloo through the host; {smi}"
    with tempfile.TemporaryDirectory() as tmp:
        inp = _agent_inputs(dev, tmp)
    t0 = time.perf_counter()
    ranks = LA.run_ranks(rank_3o, SHARD_RANKS, "gloo", "cuda:0", inp, timeout=300)
    log(f"3o: {SHARD_RANKS} gloo ranks on cuda:0 ran in {time.perf_counter() - t0:.1f} s "
        f"(spawn and CUDA start included); launches {[r.launches for r in ranks]}")
    r0 = ranks[0].value

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        return r, time.perf_counter() - t0

    # the city chunk against one process's city_frames_chained
    c = _to(inp["city"], dev)
    single_city_s = []
    for _ in range(2):
        ref, dt = timed(lambda: CS.city_frames_chained(
            c["cs"], c["graph"], c["nav"], c["pads"], c["perches"], AGENT_FRAMES, c["draws"],
            rail=c["rail"]))
        single_city_s.append(dt)
    for k, got in enumerate(r0["city"]):
        diff = _max_field_diff(got, ref)
        need(not diff, f"3o city chunk {k}: bit for bit the single-rank chain (differs: {diff})")
    cars = r0["city"][0].cars
    need(bool(torch.isfinite(cars.t).all()) and bool(torch.isfinite(r0["city"][0].peds.x).all()),
         "3o city finite")
    city_ms = 1e3 * statistics.median(res.value["city_s"][1] for res in ranks) / AGENT_FRAMES
    city_bytes = sum(res.value["city_bytes"][1] for res in ranks) / AGENT_FRAMES
    single_city_ms = 1e3 * single_city_s[1] / AGENT_FRAMES
    log(f"sharded_city_ms_per_frame_4ranks_1card {city_ms:.3f} ({label}; 64 cars and 128 "
        f"pedestrians, 16 and 32 a rank, 32 chained frames, second chunk; first "
        f"{1e3 * statistics.median(res.value['city_s'][0] for res in ranks) / AGENT_FRAMES:.3f}); "
        f"bytes received a frame over all ranks {city_bytes:.0f}; one process here, the same "
        f"chunk: {single_city_ms:.3f} ms per frame; both chunks bit for bit the single-rank "
        f"chain")

    # the combat chunk against one process's combat_frames_chained
    cs, ct, draws = _to(inp["combat"], dev)
    single_combat_s = []
    for _ in range(2):
        cref, dt = timed(lambda: UCB.combat_frames_chained(cs, draws, AGENT_FRAMES, ct))
        single_combat_s.append(dt)
    for k, got in enumerate(r0["combat"]):
        diff = _max_field_diff(got, cref)
        need(not diff, f"3o combat chunk {k}: bit for bit the single-rank chain (differs: {diff})")
    counts = {key: sum(res.value["counts"][key] for res in ranks)
              for key in ranks[0].value["counts"]}
    for key in ("spawned", "launched", "pd_shots", "impacts"):
        need(counts[key] > 0 and counts[key + "_cross_rank"] > 0,
             f"3o combat: {key} happened, also across a rank edge ({counts})")
    board = r0["board"]
    bcounts = {key: sum(res.value["board_counts"][key] for res in ranks)
               for key in ranks[0].value["board_counts"]}
    need(int(board.fleet.align[0]) == 0 and bool(board.captured[0])
         and bcounts["captures_cross_rank"] == 1,
         f"3o scripted boarding across ranks 0 and 1: captured ({bcounts})")
    # the same chunk with non-dyadic damages: the column sums over shooters
    # and ships add in row order on every rank count; the impact sums over
    # the pool reach the ships' shields and armor, held within 1e-5, every
    # other field bit for bit
    colsum = _column_sum_rounding(dev)
    need(colsum["row-order scan"] == 0,
         f"3o: a rank's column sums by the row-order scan are the whole block's ({colsum})")
    log(f"3o one-hot column sums, 1,560 columns, non-dyadic amounts, a rank's quarter against "
        f"the whole block on this card: columns that round apart {colsum}")
    nd_ref = UCB.combat_frames_chained(cs, draws, AGENT_FRAMES, _non_dyadic(ct))
    nd_diff = _max_field_diff(r0["combat_nd"], nd_ref)
    summed = (".fleet.shields", ".fleet.armor")
    need(all(key in summed and diff <= 1e-5 for key, diff in nd_diff.items()),
         f"3o combat chunk, non-dyadic damages: shields and armor within 1e-5, the rest bit "
         f"for bit (differs: {nd_diff})")
    nd_hit = bool((nd_ref.fleet.shields < cs.fleet.shields).any())
    need(nd_hit, "3o combat chunk, non-dyadic damages: ships take damage")
    log(f"3o combat chunk with non-dyadic damages (x1.1), 32 frames over 4 ranks against one: "
        f"fields that differ {nd_diff or 'none, bit for bit'}")
    combat_ms = 1e3 * statistics.median(res.value["combat_s"][1] for res in ranks) / AGENT_FRAMES
    combat_bytes = sum(res.value["combat_bytes"][1] for res in ranks) / AGENT_FRAMES
    single_combat_ms = 1e3 * single_combat_s[1] / AGENT_FRAMES
    log(f"3o combat chunk counts over the ranks (32 frames): {counts}"
        + ("" if counts["captures"] else "; no capture in the battle, the scripted boarding "
           "across ranks 0 and 1 captured its frigate"))
    log(f"sharded_combat_ms_per_frame_x8_4ranks_1card {combat_ms:.3f} ({label}; 1,248 ships "
        f"in 1,560 slots, 390 a rank; a pool of 1,024, 256 a rank; second chunk, no event "
        f"counts; first, counting: "
        f"{1e3 * statistics.median(res.value['combat_s'][0] for res in ranks) / AGENT_FRAMES:.3f}); "
        f"bytes received a frame over all ranks {combat_bytes:.0f}; one process here, the "
        f"same chunk: {single_combat_ms:.3f} ms per frame; both chunks bit for bit the "
        f"single-rank chain")
    for res in ranks:
        need(res.value["dryrun"].startswith(f"dryrun({SHARD_RANKS}) phases 1-7 ok"),
             "3o dry run on the gloo ranks")
    log(f"3o {r0['dryrun']}")

    # one rank over NCCL: the dry run, and phases 6-7 at the 4-rank sizes
    gen = torch.Generator().manual_seed(0)
    small = dict(city=DR.city_inputs(SHARD_RANKS, gen, "cpu"),
                 combat=DR.combat_inputs(SHARD_RANKS, gen, "cpu"))
    t0 = time.perf_counter()
    one_res = LA.run_ranks(rank_3o_nccl, 1, "nccl", None, small, timeout=300)[0]
    one = one_res.value
    need(one["backend"] == "nccl" and one["line"].startswith("dryrun(1) phases 1-7 ok"),
         "3o: the dry run over one NCCL rank")
    scs, graph, nav, cdraws = _to(small["city"], dev)
    ucs, uct, udraws = _to(small["combat"], dev)
    city1 = CS.city_frames_chained(scs, graph, nav, None, None, 2, cdraws)
    combat1 = UCB.combat_frames_chained(ucs, udraws, 2, uct)
    need(not _max_field_diff(one["city"], city1),
         "3o nccl: phase 6 bit for bit the unsharded city frames")
    need(not _max_field_diff(one["combat"], combat1),
         "3o nccl: phase 7 bit for bit the unsharded combat frames")
    log(f"3o one rank over NCCL ({time.perf_counter() - t0:.1f} s): {one['line']}; phases 6-7 "
        f"at the 4-rank sizes bit for bit the unsharded calls")
    launches = {n: sum(res.launches[n] for res in ranks) + one_res.launches[n]
                for n in one_res.launches}
    return {"launches": launches,
            "sharded_city_ms_per_frame_4ranks_1card": city_ms,
            "sharded_city_bytes_per_frame": city_bytes,
            "single_city_ms_per_frame_same_chunk": single_city_ms,
            "sharded_combat_ms_per_frame_x8_4ranks_1card": combat_ms,
            "sharded_combat_bytes_per_frame_x8": combat_bytes,
            "single_combat_ms_per_frame_x8_same_chunk": single_combat_ms}


def _glue_args(state, env, cobjs, table, dt: float, world, water: bool, gen) -> dict:
    """Each substep-glue phase's arguments on `state` under `env`, each
    from the plain phase before it (`physics/step`), with B, C and D between
    them as `_substep` calls them; `respond` without and with the pair
    pass; `take_rows` at a random permutation."""
    from w3d_torch.ops.cuda import pairs_kernel as PK
    from w3d_torch.ops.cuda import sample_kernel as SK
    from w3d_torch.physics import step as PS
    m = PS.advance(state, env, table, dt, world)
    mesh = SK.sample_mesh(env.mesh_height, m.px, m.py, world)
    wh = None
    if water and env.water_height is not None:
        wh = SK.sample_mesh(env.water_height, m.px, m.py, world)[0]
    c = PS.contact(m, mesh, wh, state.otype, env, table, dt, world, water)
    hits = PS.cobj_hits(c.px, c.py, c.pz, c.rad, cobjs)
    r, pin = PS.respond(c, state.otype, hits, env, table, dt, world, water, True)
    deltas = PK.banded_pairs(r.px, r.py, r.pz, r.vx, r.vy, r.vz, r.rad, *pin,
                             window=WINDOW)
    perm = torch.randperm(state.px.shape[0], generator=gen, device=state.px.device)
    resp = (c, state.otype, hits, env, table, dt, world, water)
    return {"advance": (state, env, table, dt, world),
            "contact": (m, mesh, wh, state.otype, env, table, dt, world, water),
            "respond": resp + (False,), "respond (pairs)": resp + (True,),
            "apply_pairs": (r, pin[2], deltas, env),
            "take_rows": (state, perm), "age_objects": (state, table)}


def _bits_off(a, b) -> int:
    """Elements in which `a` and `b` (tensors, None or nested tuples of
    them) differ in any bit, a NaN equal to a NaN; -1 where a dtype, a
    shape or a length differs."""
    if a is None or b is None:
        return 0 if a is b else -1
    if isinstance(a, tuple):
        offs = [_bits_off(x, y) for x, y in zip(a, b)]
        return -1 if len(a) != len(b) or -1 in offs else sum(offs)
    if a.dtype != b.dtype or a.shape != b.shape:
        return -1
    if a.is_floating_point():
        a, b = (torch.where(torch.isnan(t), float("nan"), t).view(torch.int32)
                for t in (a, b))
    return int((a != b).sum())


def _cut(value, n: int, rows: int):
    """`value` with each 1-D tensor of `rows` elements in it (nested in
    tuples) cut to its first `n`."""
    if isinstance(value, torch.Tensor):
        return value[:n].contiguous() if value.dim() == 1 and value.shape[0] == rows else value
    if isinstance(value, tuple):
        parts = [_cut(v, n, rows) for v in value]
        return value._make(parts) if hasattr(value, "_make") else tuple(parts)
    return value


def _leaves(value) -> list:
    """The numpy arrays of a NamedTuple tree, in field order (None skipped)."""
    if value is None:
        return []
    if isinstance(value, tuple):
        return [a for v in value for a in _leaves(v)]
    return [np.asarray(value)]


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; the port runs its "
                         "kernels only on the GPU")
    dev = torch.device("cuda")
    t_script = time.perf_counter()
    phase = {"name": None, "t": t_script}

    def mark(name):
        """Print the seconds of the phase that ends here."""
        now = time.perf_counter()
        if phase["name"] is not None:
            log(f"phase {phase['name']}: {now - phase['t']:.1f} s")
        phase.update(name=name, t=now)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from w3d_torch import convert
    from w3d_torch import entry as EN
    from w3d_torch.models import terrain_model as TMOD
    from w3d_torch.models import physics_model as PM
    from w3d_torch.ops import erosion as E
    from w3d_torch.ops import noise as N
    from w3d_torch.ops.cuda import build
    from w3d_torch.ops.cuda import erosion_kernel as EK
    from w3d_torch.ops.cuda import glue_kernel as GL
    from w3d_torch.ops.cuda import narrow_kernel as NK
    from w3d_torch.ops.cuda import noise_kernel as NZK
    from w3d_torch.ops.cuda import pairs_kernel as PK
    from w3d_torch.ops.cuda import physics_kernel as GK
    from w3d_torch.ops.cuda import sample_kernel as SK
    from w3d_torch.ops.cuda import stencil_kernel as FK
    from w3d_torch.physics import cobjs as PC
    from w3d_torch.physics import fused as PF
    from w3d_torch.physics import step as PS
    from w3d_torch.physics import types as PT
    from w3d_torch.gameplay import player as PL
    from w3d_torch.models import world as WM
    from w3d_torch.scene import cobj as SC
    from w3d_torch.terrain import mesh as TM
    from w3d_torch.utils import kernel_probe as KP
    from w3d_torch.utils.constants import WorldConst
    from w3d_torch.water import ripples as WR
    from w3d_torch.water import smoke as WS

    mark("1")
    # ---- 1. device --------------------------------------------------------
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")

    mark("2")
    # ---- 2. build ---------------------------------------------------------
    t0 = time.perf_counter()
    lib = build.build(verbose=True)
    build.library()
    log(f"build: {lib} in {time.perf_counter() - t0:.1f} s "
        f"(nvcc {build.build_seconds if build.build_seconds is not None else 'cached'})")

    kernels = {"erosion": EK.KERNEL, "sample": SK.KERNEL,
               "narrow": NK.KERNEL, "pairs": PK.KERNEL, "substep": GK.KERNEL,
               "tile_noise": NZK.KERNEL, "diffuse_smoke": FK.KERNEL, **GL.BY_NAME}
    world = WorldConst()
    gen = torch.Generator(device=dev).manual_seed(1234)

    def reset_counts():
        for k in kernels.values():
            k.launches = 0

    def read_counts(path: str, required) -> dict:
        c = {n: k.launches for n, k in kernels.items()}
        log(f"launches on the {path}: {c}")
        missing = [n for n in required if c[n] == 0]
        if missing:
            raise RuntimeError(f"kernels never launched on the {path}: {missing}")
        return c

    mark("3a")
    # ---- 3a. main path ----------------------------------------------------
    reset_counts()
    mcfg = TMOD.TileModelConfig(tile_size=128, erosion_iters_tt=512,
                                erosion_batch=512, erosion_steps=64,
                                use_pallas_erosion=True)
    table, x0, y0, ze, wpz, ang = TMOD.example_inputs(
        mcfg, world, gen, num_tiles=NUM_TILES, device=dev)
    t0 = time.perf_counter()
    tiles = TMOD.tile_batch_step(table, x0, y0, ze, wpz, ang, mcfg, world)
    torch.cuda.synchronize()
    ttfr_tiles = time.perf_counter() - t0
    need(tiles.shape == (NUM_TILES, 128, 128) and bool(torch.isfinite(tiles).all()),
         "terrain tiles finite, [256, 128, 128]")
    rates = []
    for g in range(5):
        ang_g = E.draw_angles(512, 512, 64, gen, device=dev)
        t0 = time.perf_counter()
        z = TMOD.tile_batch_step(table, x0 + (7.0 + g) * NUM_TILES * 128, y0,
                                 ze, wpz, ang_g, mcfg, world)
        torch.cuda.synchronize()
        rates.append(NUM_TILES / (time.perf_counter() - t0))
        need(bool(torch.isfinite(z).all()), "terrain tiles finite")
    tiles_per_s = statistics.median(rates)
    log(f"terrain: {NUM_TILES} tiles 128^2, first result {ttfr_tiles:.3f} s, "
        f"{tiles_per_s:.1f} tiles/s (median of 5, spread "
        f"{(max(rates) - min(rates)) / tiles_per_s:.3f})")
    # the padded path (the default config): 136^2 maps through the same kernel
    pcfg = mcfg._replace(use_pallas_erosion=False)
    ptiles = TMOD.tile_batch_step(table, x0, y0, ze, wpz, ang, pcfg, world)
    rates = []
    for g in range(3):
        ang_g = E.draw_angles(512, 512, 64, gen, device=dev)
        t0 = time.perf_counter()
        z = TMOD.tile_batch_step(table, x0 + (12.0 + g) * NUM_TILES * 128, y0,
                                 ze, wpz, ang_g, pcfg, world)
        torch.cuda.synchronize()
        rates.append(NUM_TILES / (time.perf_counter() - t0))
        need(bool(torch.isfinite(z).all()), "padded terrain tiles finite")
    padded_tiles_per_s = statistics.median(rates)
    dpad = float((ptiles - tiles).abs().max())
    need(ptiles.shape == tiles.shape and bool(torch.isfinite(ptiles).all())
         and dpad > 1e-3, "padded terrain tiles finite, and eroded otherwise "
         "than without the roam ring")
    log(f"terrain, padded path (roam ring {E.PAD}, 136^2 maps): "
        f"{padded_tiles_per_s:.1f} tiles/s (median of 3), max |padded - "
        f"unpadded| {dpad:.3g}")

    pos, vel = PM.spawn(NUM_OBJS, gen, device=dev)
    sw0 = PM.build_spheres_world(pos, vel, world=world, device=dev)
    fps = {}
    glue0 = {n: kernels[n].launches for n in GLUE}
    for pe in (5, 1):
        sw = sw0
        t0 = time.perf_counter()
        sw = PM.frame_step(sw, substeps=SUBSTEPS, world=world,
                           obj_collisions=True, pair_every=pe, water=False)
        torch.cuda.synchronize()
        ttfr = time.perf_counter() - t0
        rates = []
        for _ in range(5):
            t0 = time.perf_counter()
            for _ in range(4):
                sw = PM.frame_step(sw, substeps=SUBSTEPS, world=world,
                                   obj_collisions=True, pair_every=pe,
                                   water=False)
            torch.cuda.synchronize()
            rates.append(4 / (time.perf_counter() - t0))
        st = sw.state
        alive = int((st.status > 0).sum())
        for name in ("px", "py", "pz", "vx", "vy", "vz"):
            need(bool(torch.isfinite(getattr(st, name)).all()), f"{name} finite")
        need(alive > 0.9 * NUM_OBJS, f"alive objects {alive}")
        need(int(st.time.min()) == 21, "every object aged 21 frames")
        fps[pe] = statistics.median(rates)
        log(f"physics pair_every={pe}: {NUM_OBJS} objects, first frame "
            f"{ttfr:.3f} s, {fps[pe]:.1f} frames/s (median of 5), "
            f"alive {alive}, resting {int((st.status == 4).sum())}")
    pile = sw.state
    # 42 frames of 10 substeps, pairs on 2 and on 10 of them
    glue = {n: kernels[n].launches - glue0[n] for n in GLUE}
    log(f"substep glue launches in the 42 pile frames: {glue}")
    need(glue == dict(advance=420, contact=420, respond=420, apply_pairs=21 * 12,
                      take_rows=42, age_objects=42),
         "pile frames: advance, contact and respond once a substep, apply_pairs "
         "once a pair substep, take_rows and age_objects once a frame")

    fn, args = EN.entry(dev, gen)
    t0 = time.perf_counter()
    etiles, est = fn(*args)
    torch.cuda.synchronize()
    log(f"combined step (entry shapes: 8 tiles, 2048 objects): "
        f"{time.perf_counter() - t0:.3f} s")
    need(etiles.shape == (8, 128, 128) and bool(torch.isfinite(etiles).all()),
         "combined-step tiles finite, [8, 128, 128]")
    need(bool(torch.isfinite(est.px).all()) and int((est.status > 0).sum()) > 1800,
         "combined-step objects finite and alive")

    launches = read_counts("main path", ("erosion", "sample", "narrow", "pairs") + GLUE)

    mark("3b")
    # ---- 3b. fused frame path ----------------------------------------------
    def fused_frame(st):
        return PS.step_objects_fused(st, sw0.env, sw0.cobjs, sw0.table,
                                     substeps=SUBSTEPS, world=world,
                                     pair_every=5)

    reset_counts()
    t0 = time.perf_counter()
    fst = fused_frame(sw0.state)
    torch.cuda.synchronize()
    ttfr_fused = time.perf_counter() - t0
    rates = []
    for _ in range(5):
        t0 = time.perf_counter()
        for _ in range(4):
            fst = fused_frame(fst)
        torch.cuda.synchronize()
        rates.append(4 / (time.perf_counter() - t0))
    fc = read_counts("fused frame path", ("substep", "pairs"))
    nfr = 21
    need(fc["substep"] == SUBSTEPS * nfr and fc["pairs"] == 2 * nfr
         and fc["sample"] == 0 and fc["narrow"] == 0,
         "fused frames: 10 substep and 2 pair launches per frame, no sample "
         "or narrow launch")
    launches["substep"] = fc["substep"]
    alive = int((fst.status > 0).sum())
    for name in ("px", "py", "pz", "vx", "vy", "vz"):
        need(bool(torch.isfinite(getattr(fst, name)).all()), f"fused {name} finite")
    need(alive > 0.9 * NUM_OBJS, f"fused frames: alive objects {alive}")
    need(int(fst.time.min()) == nfr, "fused frames: every object aged 21 frames")
    fps["fused"] = statistics.median(rates)
    log(f"physics fused, pair_every=5: {NUM_OBJS} objects, first frame "
        f"{ttfr_fused:.3f} s, {fps['fused']:.1f} frames/s (median of 5; "
        f"unfused {fps[5]:.1f} / {fps[1]:.1f} at pair_every 5 / 1), "
        f"alive {alive}, resting {int((fst.status == 4).sum())}")

    mark("3c")
    # ---- 3c. tile noise and smoke stencil paths ----------------------------
    reset_counts()
    cfg = mcfg.cfg
    nargs = (table, x0, y0, 128, world.dx, world.dy, cfg.mesh_scale,
             1.0 / cfg.mesh_scale_z)
    noise = NZK.tile_noise(*nargs, start_sin=0)
    xt, yt = N.sine_term_tables(table, x0, y0, world.dx, world.dy, 128, 128,
                                world=world, mesh_scale=cfg.mesh_scale,
                                mesh_scale_z_inv=1.0 / cfg.mesh_scale_z)
    dn = float((noise - N.eval_sine_grid(xt, yt)).abs().max())
    log(f"tile noise: {NUM_TILES} tiles 128^2, max |fused - terrain path "
        f"noise| {dn:.3g}")
    need(noise.shape == (NUM_TILES, 128, 128) and bool(torch.isfinite(noise).all())
         and dn < 1e-3, "tile noise finite and within 1e-3 of the terrain path's")
    smoke0 = torch.rand(LIGHT_GRID, generator=gen, device=dev) * 5
    s_open, s_gated = smoke0, smoke0
    for _ in range(10):
        s_open = FK.diffuse_smoke_open(s_open)
        s_gated = WS.diffuse_smoke(s_gated)
    ds = float((s_open - s_gated).abs().max())
    log(f"smoke: 10 steps on {LIGHT_GRID}, total {float(smoke0.sum()):.1f} -> "
        f"{float(s_open.sum()):.1f}, max |stencil - gated path| {ds:.3g}")
    need(bool(torch.isfinite(s_open).all()) and float(s_open.min()) >= 0.0
         and float(s_open.max()) <= WS.SMOKE_MAX_VAL
         and float(s_open.sum()) < float(smoke0.sum()) and ds < 1e-5,
         "smoke finite, in [0, 100], draining at the edges, within 1e-5 of "
         "the gated path")
    ec = read_counts("noise and smoke paths", ("tile_noise", "diffuse_smoke"))
    need(ec["tile_noise"] == 1 and ec["diffuse_smoke"] == 10,
         "one tile-noise launch, 10 stencil launches")
    launches["tile_noise"] = ec["tile_noise"]
    launches["diffuse_smoke"] = ec["diffuse_smoke"]

    mark("3d")
    # ---- 3d. ground mode: generated terrain, chained ground frames --------
    # gen_terrain in three configurations (the simplex one erodes 512
    # droplets through A and raises its water as the config keyword
    # "water_h_off 0.09 0" does, so part of the map is under water), then
    # two runs of 2 x 32 chained frames at the ground loop's settings
    # (2,000 balls, 4 substeps): the grouped spheres world with smoke (B,
    # C, D; B and C for the player) and the eroded simplex terrain with the
    # plain CobjSet of wide_scene(8) (B, D, the ungrouped narrow phase)
    reset_counts()
    gcfgs = {"sine": TM.TerrainConfig(),
             "simplex, 512 droplets": TM.TerrainConfig(
                 mode=N.MGEN_SIMPLEX, erosion_iters=GROUND_DROPLETS,
                 water_h_off_rel=GROUND_WATER_REL),
             "domain warp": TM.TerrainConfig(mode=N.MGEN_DWARP_GPU)}
    gen_ms, terrains = {}, {}
    for label, cfg in gcfgs.items():
        ang = (E.draw_angles(cfg.erosion_iters, 1024, 256, gen, device=dev)
               if cfg.erosion_iters else None)
        ter = TM.gen_terrain(cfg, world, angles=ang, device=dev)
        torch.cuda.synchronize()
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            ter = TM.gen_terrain(cfg, world, angles=ang, device=dev)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        gen_ms[label] = 1e3 * statistics.median(times)
        terrains[label] = (cfg, ang, ter)
        zb, zt, wz = (float(v) for v in (ter.zbottom, ter.ztop, ter.water_plane_z))
        wet = float((ter.water_plane_z > ter.mesh_height).float().mean())
        log(f"gen_terrain {label}: {gen_ms[label]:.3f} ms per call (median of 3), "
            f"zbottom {zb:.4f}, ztop {zt:.4f}, water_plane_z {wz:.4f}, "
            f"under water {100 * wet:.1f}%")
        need(all(np.isfinite(v) for v in (zb, zt, wz)) and zt > zb
             and bool(torch.isfinite(ter.mesh_height).all()),
             f"gen_terrain {label}: finite heights and scalars")

    def ground_run(label, state, env, cobjs, table, smoke, rip):
        """2 chunks of GROUND_CHAIN chained frames; the second is timed and
        its launches counted."""
        ply = PL.make_player(0.0, 0.0, 1.0, device=dev)
        per = {}
        for c in range(2):
            k = torch.arange(c * GROUND_CHAIN, (c + 1) * GROUND_CHAIN, device=dev)
            mv = torch.stack([torch.cos(0.2 * k), torch.sin(0.2 * k)], -1)
            before = {n: kk.launches for n, kk in kernels.items()}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = WM.ground_frames_chained(state, env, cobjs, table, rip, ply, mv,
                                           world, GROUND_CHAIN, substeps=4,
                                           smoke=smoke)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            state, rip, ply, live = out[:4]
            if smoke is not None:
                smoke = out[4]
            per = {n: (kk.launches - before[n]) / GROUND_CHAIN
                   for n, kk in kernels.items() if kk.launches > before[n]}
        ms = 1e3 * dt / GROUND_CHAIN
        nlive, pz = int(live[-1]), float(ply.z[0])
        log(f"ground {label}: {ms:.3f} ms per frame (second chunk of "
            f"{GROUND_CHAIN}), kernel launches per frame {per}, live {nlive} of "
            f"{state.px.shape[0]}, player z {pz:.4f}, ripples max "
            f"{float(rip.rval.abs().max()):.3g}")
        for name in ("px", "py", "pz", "vx", "vy", "vz"):
            need(bool(torch.isfinite(getattr(state, name)).all()),
                 f"ground {label}: {name} finite")
        need(np.isfinite(pz) and nlive > 0.5 * state.px.shape[0]
             and int(state.time.min()) == 2 * GROUND_CHAIN,
             f"ground {label}: player finite, half the balls alive, all aged")
        if smoke is not None:
            need(bool(torch.isfinite(smoke).all()) and float(smoke.max()) > 0.0,
                 f"ground {label}: smoke finite")
        return dict(ms_per_frame=ms, launches_per_frame=per, live=nlive,
                    player_z=pz)

    gpos, gvel = PM.spawn(GROUND_OBJS, gen, device=dev)
    gsw = PM.build_spheres_world(gpos, gvel, world=world, device=dev)
    gsmoke = torch.zeros(LIGHT_GRID, device=dev)
    gsmoke[4, 64, 64] = 50.0                      # one source
    still = WR.make_ripples(world.mesh_y, world.mesh_x, device=dev)
    ground = {"spheres": ground_run("spheres (grouped, M = 112, smoke)", gsw.state,
                                    gsw.env, gsw.cobjs, gsw.table, gsmoke, still)}
    # the fbm run: the eroded simplex terrain with the env and the spawn the
    # scene loader builds (scene/loader.py:238-264), the plain wide scene
    ter = terrains["simplex, 512 droplets"][2]
    f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=dev)
    fenv = PS.PhysicsEnv(mesh_height=ter.mesh_height, water_plane_z=ter.water_plane_z,
                         wind=f32([0.4, 0.2, 0.0]), temperature=f32(20.0),
                         base_gravity=f32(1.0), zmin=ter.zmin)
    lrng = np.random.default_rng(1)
    lpos = np.stack([lrng.uniform(-0.8 * world.x_scene, 0.8 * world.x_scene, GROUND_OBJS),
                     lrng.uniform(-0.8 * world.y_scene, 0.8 * world.y_scene, GROUND_OBJS),
                     lrng.uniform(0.3 * world.z_scene, 0.9 * world.z_scene, GROUND_OBJS)], 1)
    fstate = PS.make_state(lpos, np.zeros((GROUND_OBJS, 3), np.float32),
                           np.full(GROUND_OBJS, PT.type_id("BALL")), gsw.table)
    # 514 live cobjs: 640 slots as a plain CobjSet, 536 grouped
    wide_plain = SC.pack_cobjs(KP.wide_scene(8), device=dev)
    deep = int(torch.argmin(ter.mesh_height))      # a splash in the deepest water
    splash = WR.add_splash(still, deep % world.mesh_x, deep // world.mesh_x, 4, 0.5,
                           world.mesh_x, world.mesh_y)
    ground["fbm"] = ground_run(f"fbm (simplex terrain, plain CobjSet of "
                               f"{wide_plain.size} slots)", fstate, fenv,
                               wide_plain, gsw.table, None, splash)
    gc3 = read_counts("ground path", ("erosion", "sample", "narrow", "pairs"))
    for n in ("erosion", "sample", "narrow", "pairs"):
        launches[n] += gc3[n]
    need(ground["fbm"]["launches_per_frame"].get("narrow", 0) == 0,
         "ground fbm: the plain CobjSet takes no narrow-kernel launch")

    # the ungrouped narrow phase at the fbm run's shapes, device-only
    nin_g = (fstate.px, fstate.py, fstate.pz,
             torch.full_like(fstate.px, float(gsw.table.radius[PT.type_id("BALL")])))
    plain_narrow = dict(graph_ms=statistics.median(
        KP.GraphTimer(lambda: PC.deepest_hits(*nin_g, wide_plain)).time()
        for _ in range(5)), eager_ms=KP.events_ms(
        lambda: PC.deepest_hits(*nin_g, wide_plain), launches=5))
    log(f"ungrouped deepest_hits, N = {GROUND_OBJS}, M = {wide_plain.size} slots "
        f"({int((wide_plain.shape != 0).sum())} live): "
        f"device-only {plain_narrow['graph_ms']:.4f} ms (CUDA graph of 20), "
        f"eager {plain_narrow['eager_ms']:.4f} ms (CUDA events)")

    # A in gen_terrain against its plain version, the same call
    cfg, ang, ter = terrains["simplex, 512 droplets"]
    walk = EK.erosion_walk
    EK.erosion_walk = E._walk_batch
    try:
        tref = TM.gen_terrain(cfg, world, angles=ang, device=dev)
    finally:
        EK.erosion_walk = walk
    flat = TM.gen_terrain(cfg._replace(erosion_iters=0), world, device=dev)
    deroded = float((ter.mesh_height - flat.mesh_height).abs().max())
    log(f"gen_terrain erosion: kernel vs plain walk bitwise "
        f"{all(torch.equal(a, b) for a, b in zip(ter, tref))}, max |eroded - "
        f"uneroded| {deroded:.3g}")
    need(all(torch.equal(a, b) for a, b in zip(ter, tref)) and deroded > 1e-3,
         "gen_terrain erosion: " + TOLS["erosion"])

    # 3d on a small world: the card against the CPU
    sw32 = WorldConst(mesh_x=32, mesh_y=32, mesh_z=8)
    rg32 = np.random.default_rng(21)
    mesh32 = rg32.standard_normal((32, 32)).astype(np.float32) * 0.3 - 0.5
    for group in (True, False):
        cpos = np.stack([rg32.uniform(-2.5, 2.5, 64), rg32.uniform(-2.5, 2.5, 64),
                         rg32.uniform(0.2, 1.5, 64)], 1).astype(np.float32)
        cvel = rg32.normal(0, 0.5, (64, 3)).astype(np.float32)
        csw = PM.build_spheres_world(torch.as_tensor(cpos), torch.as_tensor(cvel),
                                     world=sw32, device="cpu", group_shapes=group,
                                     mesh_height=torch.as_tensor(mesh32))
        csw = csw._replace(env=csw.env._replace(water_plane_z=torch.tensor(0.1)))
        cin = (csw.state, csw.env, csw.cobjs, csw.table,
               WR.add_splash(WR.make_ripples(32, 32, device="cpu"), 10, 12, 3,
                             0.5, 32, 32),
               PL.make_player(0.3, -0.2, 1.0, device="cpu"),
               torch.stack([torch.cos(0.2 * torch.arange(4.0)),
                            torch.sin(0.2 * torch.arange(4.0))], -1))
        csmoke = torch.zeros((8, 32, 32))
        csmoke[2, 16, 16] = 10.0
        cpu_out = WM.ground_frames_chained(*cin, sw32, 4, smoke=csmoke)
        gin = (*convert.spheres_world(convert.to_numpy(csw), dev),
               convert.ripple_state(convert.to_numpy(cin[4]), dev),
               convert.player_state(convert.to_numpy(cin[5]), dev), cin[6].to(dev))
        gpu_out = WM.ground_frames_chained(*gin, sw32, 4, smoke=csmoke.to(dev))

        def leaves(out):     # state, ripples, player and smoke as numpy arrays
            return [a for part in convert.to_numpy(out[:3] + out[4:])
                    for a in (part if isinstance(part, tuple) else (part,))]

        pairs = list(zip(leaves(cpu_out), leaves(gpu_out)))
        worst = max(float(np.abs(a - b).max()) for a, b in pairs if a.dtype.kind == "f")
        exact = all(np.array_equal(a, b) for a, b in pairs if a.dtype.kind != "f")
        same_live = bool(torch.equal(cpu_out[3], gpu_out[3].cpu()))
        log(f"ground 3d, 32^2 world, 64 balls, 4 frames, "
            f"{'grouped' if group else 'plain'} scene, card vs CPU: max diff "
            f"{worst:.3g}, status/flags/on_ground equal {exact}, live equal "
            f"{same_live} ({cpu_out[3].tolist()})")
        need(worst <= 1e-4 and exact and same_live,
             "ground 3d, card vs CPU: 1e-4, integer fields and live equal")

        # the player alone, 60 ticks, card vs CPU
        pc, pg = cin[5], convert.player_state(convert.to_numpy(cin[5]), dev)
        gmesh = csw.env.mesh_height.to(dev)
        gcobjs = gin[2]
        pw = 0.0
        for i in range(60):
            mvx, mvy = float(np.cos(0.05 * i)), float(np.sin(0.05 * i))
            pc = PL.step_player(pc, csw.env.mesh_height, csw.cobjs, mvx, mvy,
                                i == 40, world=sw32)
            pg = PL.step_player(pg, gmesh, gcobjs, mvx, mvy, i == 40, world=sw32)
            a, b = convert.to_numpy(pc), convert.to_numpy(pg)
            pw = max(pw, max(float(np.abs(getattr(a, f) - getattr(b, f)).max())
                             for f in ("x", "y", "z", "vz")))
            need(np.array_equal(a.on_ground, b.on_ground), "player: on_ground equal")
        log(f"player, 60 ticks, {'grouped' if group else 'plain'} scene, card vs "
            f"CPU: max diff {pw:.3g}, final z {float(pc.z[0]):.4f}")
        need(pw <= 1e-5, "player, card vs CPU: 1e-5")

    mark("3e")
    # ---- 3e. scene loading and the ground app loop ------------------------
    # at app.py's defaults (2,000 objects, 32 frames a chained call, the
    # 128^2 x 32 mesh): scene P (a DSL scene with a continuous and a
    # triggered platform: the per-frame path) and scene C (the same without
    # the platforms: the chained path) through w3d_torch.app.run_ground;
    # scene H (a 16-bit PNG heightmap with a brush journal, eroded by
    # 2,000 droplets through A); and scene P at 32^2 on the card against
    # the CPU
    with tempfile.TemporaryDirectory() as tmp:
        scene3e = run_scene_phase(tmp, dev, kernels, reset_counts, read_counts)
    for n, c in scene3e["launches"].items():
        launches[n] += c

    mark("3f")
    # ---- 3f. game mode and valley water -----------------------------------
    # FPS game mode at the app's defaults (2,000 objects, 8 smileys, 64
    # frames) on scene P eroded at load (A); a scripted rocket-against-m16
    # match if the default draws fired no projectile, no hitscan shot or no
    # explosion; valley water on scene P's mesh and 8 ground frames over
    # it; and game mode, the valley fill and the small modules at 32^2 on
    # the card against the CPU
    with tempfile.TemporaryDirectory() as tmp:
        game3f = run_game_phase(tmp, dev, kernels, reset_counts, read_counts)
    for n, c in game3f["launches"].items():
        launches[n] += c

    mark("3g")
    # ---- 3g. tiled mode --------------------------------------------------
    # app.run_tiled at the app's and bench_live_tiled's settings (B twice a
    # frame), bench_live_tiled's own loop, a profiled chunk, record and
    # replay on the card, an eroding tile manager at tile 128 (A), A bitwise
    # against its plain walk at 72^2 and 136^2, and a short session on the
    # card against the CPU
    tiled3g = run_tiled_phase(dev, kernels, reset_counts, read_counts)
    for n, c in tiled3g["launches"].items():
        launches[n] += c

    mark("3h")
    # ---- 3h. universe mode -----------------------------------------------
    # app.run_universe without defs and on the written ship defs (the full
    # weapon model) and at 8 times their fleets, a profiled chunk and one
    # with syncs raising, scripted weapon scenes, hazards and the player,
    # the asteroid field through D, the planet surfaces, and the card
    # against the CPU
    universe3h = run_universe_phase(dev, kernels, reset_counts, read_counts)
    for n, c in universe3h["launches"].items():
        launches[n] += c

    mark("3i")
    # ---- 3i. voxel landscapes ---------------------------------------------
    # load_scene and app.run_ground on the 512x512x64 landscape (B and D
    # every frame), the collider, the block marching cubes, a brush edit
    # and settle, and the small landscape on the card against the CPU
    voxel3i = run_voxel_phase(dev, kernels, reset_counts, read_counts)
    for n, c in voxel3i["launches"].items():
        launches[n] += c

    mark("3j")
    # ---- 3j. lighting ------------------------------------------------------
    # the sky bakes at scripts/lighting_bench.py's sizes (B in every
    # bounce), a profiled batch, the sweeps, scene lights, a platform delta
    # (A->B->A exactly 0), building lighting, and a small grid card vs CPU
    light3j = run_lighting_phase(dev, kernels, reset_counts, read_counts)
    for n, c in light3j["launches"].items():
        launches[n] += c

    mark("3k")
    # ---- 3k. the full-world build ------------------------------------------
    # w3d_torch.full_world at the JAX example's sizes: main end to end (A,
    # B, C, D, read per section), A against its plain walk at this shape,
    # and main on the CPU on the same draws against the card's build
    with tempfile.TemporaryDirectory() as tmp:
        world3k = run_full_world_phase(tmp, dev, kernels, reset_counts, read_counts)
    for n, c in world3k["launches"].items():
        launches[n] += c

    mark("3l")
    # ---- 3l. a building session and tiled vegetation ----------------------
    # the tiled app's city with interiors: tunnels, objects and birds,
    # building people, clocks, mall and backrooms, water, light switches,
    # zombies, building animals, model instances, grass and flowers
    with tempfile.TemporaryDirectory() as tmp:
        build3l = run_building_phase(tmp, dev, kernels, reset_counts, read_counts)
    for n, c in build3l["launches"].items():
        launches[n] += c

    mark("3m")
    # ---- 3m. scenery, weather, model formats, textures ----------------------
    # scenery on scene P and at 4,096 objects, the snow map and a bake over
    # it, 64 precipitation frames, clouds and wind, every model format and a
    # DSL scene of them, skinning, textures and DXT, checkpoints; each held
    # on the card against the CPU (B, C and D launched)
    with tempfile.TemporaryDirectory() as tmp:
        weather3m = run_weather_phase(tmp, dev, kernels, reset_counts, read_counts)
    for n, c in weather3m["launches"].items():
        launches[n] += c

    mark("3n")
    # ---- 3n. the multi-device layer: 4 gloo ranks on this card, 1 over NCCL
    shard3n = run_sharded_phase(dev, smi)
    for n, c in shard3n["launches"].items():
        launches[n] += c

    mark("3o")
    # ---- 3o. the agent-sharded city frame and ship-sharded combat frame ----
    agents3o = run_agent_sharded_phase(dev, smi)
    for n, c in agents3o["launches"].items():
        launches[n] += c

    mark("4")
    # ---- 4. kernels vs plain versions, main-path shapes ------------------
    # Each kernel device-only (a CUDA graph of 20 launches replayed between
    # CUDA events), in turns with its plain version (CUDA events around
    # back-to-back calls); each beside its bound, from this run's inputs.
    report = {}

    def in_turns(plain, kernel, rounds: int, plain_calls: int):
        timer = KP.GraphTimer(kernel)
        plain()
        tp, tk = [], []
        for i in range(rounds):
            for which in ((0, 1) if i % 2 == 0 else (1, 0)):
                if which == 0:
                    tp.append(KP.events_ms(plain, plain_calls, reps=1, warm=False))
                else:
                    tk.append(timer.time())
        return statistics.median(tp), statistics.median(tk)

    def graph_ms(fn) -> float:
        """Device-only ms of `fn`: median of 5 replays of a graph of 20."""
        timer = KP.GraphTimer(fn)
        return statistics.median(timer.time() for _ in range(5))

    def add(name, err, times, bound, note, floor, floor_at: str):
        """`floor`: the kernel's call on one CTA's worth of work
        (`floor_at`), timed as its launch-plus-set-up floor."""
        pm, km = times
        report[name] = dict(err=err, ms=km, plain_ms=pm, bound=bound, note=note,
                            floor=graph_ms(floor), floor_at=floor_at)

    # A: one erosion batch on 256 raw tiles, then the ragged case
    case = KP.erosion_case(dev, gen)
    hm, xi, zi, ang0, p6 = case
    out1 = EK.erosion_walk(*case)
    out2 = EK.erosion_walk(*case)
    stats: dict = {}
    ref = E._walk_batch(*case, stats=stats)
    d = (out1 - ref).abs()
    log(f"erosion: max |kernel-plain| {float(d.max()):.3g}, cells not equal "
        f"{int((out1 != ref).sum())} of {d.numel()}, run-to-run not equal "
        f"{int((out1 != out2).sum())}, NaN {bool(torch.isnan(out1).any())}; work "
        f"{ {k: int(v) for k, v in stats.items()} }")
    need(bool(torch.equal(out1, ref)) and bool(torch.equal(out1, out2)),
         "erosion: " + TOLS["erosion"])
    rg = np.random.default_rng(11)
    rcase = (torch.as_tensor(rg.standard_normal((3, 48, 64)).astype(np.float32)
                             * 0.5 + 1.0, device=dev),
             *(t.expand(3, 200).contiguous()
               for t in E.droplet_starts(200, 64, 48, device=dev)),
             E.draw_angles(200, 200, 64, gen, device=dev)[0].contiguous(),
             E.pack_params(E.ErosionParams(water_plane_z=0.0, half_dxy=0.06,
                                           zmin=-2.0, zmax=2.0,
                                           rock_thresh=0.75), dev))
    r1, r2 = EK.erosion_walk(*rcase), EK.erosion_walk(*rcase)
    rref = E._walk_batch(*rcase)
    log(f"erosion, 3 tiles of 48x64, 200 droplets: cells not equal "
        f"{int((r1 != rref).sum())}, run-to-run {int((r1 != r2).sum())}, "
        f"max |delta| {float(rref.abs().max()):.3g}")
    need(bool(torch.equal(r1, rref)) and bool(torch.equal(r1, r2))
         and float(rref.abs().max()) > 1e-3, "erosion (ragged): " + TOLS["erosion"])
    # the padded path's walk: the same batch on 136^2 maps, droplets PAD in
    pcase = KP.padded_erosion_case(case)
    p1, p2 = EK.erosion_walk(*pcase), EK.erosion_walk(*pcase)
    pstats: dict = {}
    pref = E._walk_batch(*pcase, stats=pstats)
    ring = float(torch.cat([pref[:, :E.PAD].flatten(), pref[:, -E.PAD:].flatten(),
                            pref[:, :, :E.PAD].flatten(),
                            pref[:, :, -E.PAD:].flatten()]).abs().max())
    pad_ms = graph_ms(lambda: EK.erosion_walk(*pcase))
    pad_bound = KP.erosion_bound(pcase[0], pcase[1], pcase[3], pstats)
    log(f"erosion, padded path ({NUM_TILES} maps of {pcase[0].shape[1]}^2): cells "
        f"not equal {int((p1 != pref).sum())}, run-to-run {int((p1 != p2).sum())}, "
        f"max |delta| in the roam ring {ring:.3g}; device-only {pad_ms:.4f} ms, "
        f"bound {pad_bound[0]:.5f} ms by {pad_bound[1]}")
    need(bool(torch.equal(p1, pref)) and bool(torch.equal(p1, p2)) and ring > 0.0,
         "erosion (padded): " + TOLS["erosion"] + ", droplets in the roam ring")
    case1 = tuple(t[:1].contiguous() for t in case[:3]) + case[3:]
    add("erosion", float(d.max()),
        in_turns(lambda: E._walk_batch(*case), lambda: EK.erosion_walk(*case),
                 rounds=4, plain_calls=1),
        KP.erosion_bound(hm, xi, ang0, stats),
        "no PyTorch call runs a lockstep droplet walk",
        floor=lambda: EK.erosion_walk(*case1), floor_at="one tile")
    report["erosion"]["padded"] = dict(ms=pad_ms, bound_ms=pad_bound[0],
                                       bound_by=pad_bound[1])

    # B: mesh sampling, 10K objects over tile 0
    mesh = tiles[0].contiguous()
    sx, sy = pile.px.contiguous(), pile.py.contiguous()
    out = SK.sample_mesh(mesh, sx, sy, world)
    ref = PS.sample_mesh(mesh, sx, sy, world)
    dh = (out[0] - ref[0]).abs()
    dn = max(float((a - b).abs().max()) for a, b in zip(out[1:], ref[1:]))
    bound = 2 * float(np.spacing(np.float32(mesh.abs().max().item())))
    log(f"sample: heights max diff {float(dh.max()):.3g} (bound {bound:.3g}), "
        f"not bitwise {int((dh > 0).sum())} of {dh.numel()}, normals max diff {dn:.3g}")
    need(float(dh.max()) <= bound and dn < 1e-6, "sample: " + TOLS["sample"])
    n = sx.shape[0]
    sx_floor, sy_floor = sx[:FLOOR_N].contiguous(), sy[:FLOOR_N].contiguous()
    add("sample", max(float(dh.max()), dn),
        in_turns(lambda: PS.sample_mesh(mesh, sx, sy, world),
                 lambda: SK.sample_mesh(mesh, sx, sy, world), rounds=10,
                 plain_calls=5),
        KP.bound_ms(mesh.numel() * 4 + 6 * n * 4, SAMPLE_OPS * n),
        "grid_sample gives the heights only, not the normals",
        floor=lambda: SK.sample_mesh(mesh, sx_floor, sy_floor, world),
        floor_at=f"{FLOOR_N} objects")

    # C and D: a dense pile so contacts happen
    dense, rad, elas, mass = KP.dense_pile(sw0.state, sw0.table)
    gc = sw0.cobjs
    nin = (dense.px, dense.py, dense.pz, rad)
    # C also on the seven-shape scene: every shape group, dead padding slots
    # in most of them; 10K objects uniform in [-2.5, 2.5]^3
    g7 = PC.group_cobjs(SC.pack_cobjs(KP.seven_shape_scene(), device=dev))
    rg7 = np.random.default_rng(3)
    nin7 = tuple(torch.as_tensor(rg7.uniform(lo, hi, NUM_OBJS).astype(np.float32),
                                 device=dev)
                 for lo, hi in ((-2.5, 2.5),) * 3 + ((0.02, 0.2),))
    wide = [KP.wide_cobjs(c, dev) for c in WIDE_COPIES]
    dwin = dpen = 0.0
    for scene, g, ins in (("spheres, dense pile", gc, nin),
                          ("seven shapes", g7, nin7),
                          *(("wide table, dense pile", gw, nin) for gw in wide)):
        out = NK.deepest_hits(*ins, g)
        ref = PC.deepest_hits_grouped(*ins, g)
        top2 = torch.topk(PC.sphere_cobj_test_grouped(*ins, g)[0], 2).values
        robust = ref[0] & ((top2[:, 0] - top2[:, 1]) > 1e-4)
        hit_eq = bool(torch.equal(out[0], ref[0]))
        dp = float((out[1] - ref[1]).abs().max())
        dw = max(float(torch.where(robust, a - b, 0.0).abs().max())
                 for a, b in zip(out[2:], ref[2:]))
        log(f"narrow, {scene}: M={g.size}, hits {int(ref[0].sum())}, hit mask "
            f"equal {hit_eq}, pen max diff {dp:.3g}, winner fields max diff "
            f"{dw:.3g} on {int(robust.sum())} lanes")
        need(hit_eq and dp < 1e-5 and dw < 1e-5 and int(ref[0].sum()) > 500,
             f"narrow ({scene}): " + TOLS["narrow"] + ", with hits")
        dpen, dwin = max(dpen, dp), max(dwin, dw)
    # one chunk against several: a variant build with 64-row chunks
    nk64 = NK.KERNEL.variant("W3D_CHUNK_ROWS=64")
    gk64 = GK.KERNEL.variant("W3D_CHUNK_ROWS=64")
    for g, ins in ((gc, nin), (g7, nin7)):
        need(all(torch.equal(a, b) for a, b in zip(
            NK.deepest_hits(*ins, g), NK.deepest_hits(*ins, g, kernel=nk64))),
            f"narrow, M = {g.size}: 384-row and 64-row chunks give the same bits")
    log(f"narrow, M = {gc.size} and {g7.size}: bitwise equal through 64-row "
        f"chunks ({-(-gc.size // 64)} and {-(-g7.size // 64)} chunks)")

    def narrow_bound(g):
        return KP.bound_ms((10 * 4 + 1) * NUM_OBJS          # 4 in, 6 out, hit mask
                           + NK.kernel_tables(g)[2].numel() * 4 + 32,
                           COBJ_TEST_OPS * NUM_OBJS * sum(hi - lo for lo, hi in g.bounds))

    nin_floor = tuple(t[:FLOOR_N].contiguous() for t in nin)
    add("narrow", max(dpen, dwin),
        in_turns(lambda: PC.deepest_hits_grouped(*nin, gc),
                 lambda: NK.deepest_hits(*nin, gc), rounds=10, plain_calls=5),
        narrow_bound(gc),
        "no PyTorch call tests spheres against cobj shapes",
        floor=lambda: NK.deepest_hits(*nin_floor, gc), floor_at=f"{FLOOR_N} objects")
    report["narrow"]["wide"] = []
    for gw in wide:
        ms = graph_ms(lambda gw=gw: NK.deepest_hits(*nin, gw))
        b = narrow_bound(gw)
        report["narrow"]["wide"].append(dict(slots=gw.size, ms=ms, bound_ms=b[0],
                                             bound_by=b[1]))
        log(f"narrow, M = {gw.size} ({-(-gw.size // NK.CHUNK_ROWS)} chunks), dense "
            f"pile: device-only {ms:.4f} ms, bound {b[0]:.5f} ms by {b[1]}")

    act = (dense.status > 0) & (rad >= 0.01)
    pin = (dense.px, dense.py, dense.pz, dense.vx, dense.vy, dense.vz,
           rad, mass, elas, act)
    out = PK.banded_pairs(*pin, window=WINDOW)
    out2 = PK.banded_pairs(*pin, window=WINDOW)
    ref = PS.banded_pair_collisions(*pin, window=WINDOW)
    dp = max(float((a - b).abs().max()) for a, b in zip(out, ref))
    nz = int((ref[0] != 0).sum())
    neq = sum(int((a != b).sum()) for a, b in zip(out, ref))
    rerun = sum(int((a != b).sum()) for a, b in zip(out, out2))
    valid, hits = KP.pair_work(dense.px, dense.py, dense.pz, rad, act, WINDOW)
    log(f"pairs: window {WINDOW}, {valid} valid pairs, {hits} contacts, ranks "
        f"with contacts {nz}, max diff {dp:.3g}, unequal outputs {neq} of "
        f"{6 * NUM_OBJS}, run-to-run unequal {rerun}")
    need(dp < 1e-6 and rerun == 0 and nz > NUM_OBJS // 10,
         "pairs: " + TOLS["pairs"] + ", with contacts")
    # ragged: N = 4,097, window 300, the i side limited to ranks below 3,001
    rp, rrad, relas, rmass = KP.dense_pile(sw0.state, sw0.table, seed=8)
    rn = 4097
    rpin = (*(t[:rn].contiguous() for t in (rp.px, rp.py, rp.pz, rp.vx, rp.vy,
                                           rp.vz, rrad, rmass, relas)),
            torch.rand(rn, generator=gen, device=dev) > 0.05)
    r1 = PK.banded_pairs(*rpin, window=300, i_limit=3001)
    r2 = PK.banded_pairs(*rpin, window=300, i_limit=3001)
    rref = PS.banded_pair_collisions(*rpin, window=300, i_limit=3001)
    rdp = max(float((a - b).abs().max()) for a, b in zip(r1, rref))
    rrerun = sum(int((a != b).sum()) for a, b in zip(r1, r2))
    rnz = int((rref[0] != 0).sum())
    log(f"pairs, N {rn}, window 300, i_limit 3001: max diff {rdp:.3g}, ranks "
        f"with contacts {rnz}, run-to-run unequal {rrerun}")
    need(rdp < 1e-6 and rrerun == 0 and rnz > 100, "pairs (ragged): " + TOLS["pairs"])
    pin_floor = tuple(t[:PAIRS_FLOOR_N].contiguous() for t in pin)
    add("pairs", dp,
        in_turns(lambda: PS.banded_pair_collisions(*pin, window=WINDOW),
                 lambda: PK.banded_pairs(*pin, window=WINDOW), rounds=4,
                 plain_calls=1),
        KP.pairs_bound(NUM_OBJS, valid, hits),
        "no PyTorch call computes banded pair impulses",
        floor=lambda: PK.banded_pairs(*pin_floor, window=WINDOW),
        floor_at=f"{PAIRS_FLOOR_N} ranks")
    # D on phase 3h's asteroid field: 8,192 asteroids, window 32
    report["pairs"]["universe"] = universe3h["pairs_universe"]

    # the substep glue: each kernel on the dense pile's card tensors against
    # its plain phase (physics/step) on the same inputs, bit for bit; dry,
    # as the pile's frames run it, and under a water map rising across the
    # pile (level max(0.15, 0 to 0.3) over the pile's 0 to 0.3), liquid and
    # frozen; timed on the dry pile, beside its byte floor
    dt = float(torch.tensor(PT.DEF_TIMESTEP / SUBSTEPS, dtype=torch.float32))
    ramp = torch.linspace(0.0, 0.3, world.mesh_x, device=dev)
    wmap = ramp.expand(world.mesh_y, -1).contiguous()
    f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=dev)
    glue_off, glue_args = {}, {}
    for label, temp in (("dry", None), ("water", 20.0), ("ice", -5.0)):
        env = sw0.env if temp is None else sw0.env._replace(
            water_plane_z=f32(0.15), water_height=wmap, temperature=f32(temp))
        ga = glue_args[label] = _glue_args(dense, env, gc, sw0.table, dt, world,
                                           temp is not None, gen)
        glue_off[label] = {k: _bits_off(getattr(GL, k.split()[0])(*a),
                                        getattr(PS, k.split()[0])(*a))
                           for k, a in ga.items()}
    wet_c, ice_c = glue_args["water"]["respond"][0], glue_args["ice"]["respond"][0]
    woke = glue_args["dry"]["apply_pairs"][2][3] != 0
    log(f"substep glue, dense pile ({NUM_OBJS} objects): elements not bit for bit "
        f"the plain phase's {glue_off}; rows touching water {int(wet_c.touches_water.sum())}, "
        f"on ice {int(ice_c.ice_touch.sum())}, with pair deltas {int(woke.sum())}")
    need(all(v == 0 for d in glue_off.values() for v in d.values())
         and int(wet_c.touches_water.sum()) > 100 and int(ice_c.ice_touch.sum()) > 100
         and int(woke.sum()) > NUM_OBJS // 10,
         "substep glue: " + TOLS["advance"] + ", with water, ice and pair contacts")
    dry = glue_args["dry"]
    for k in GLUE:
        a = dry[k]
        fl = ((_cut(a[0], FLOOR_N, NUM_OBJS), torch.arange(FLOOR_N - 1, -1, -1, device=dev))
              if k == "take_rows" else _cut(a, FLOOR_N, NUM_OBJS))
        kern, plain = getattr(GL, k), getattr(PS, k)
        add(k, float(max(glue_off[lb][k] for lb in glue_off)),
            in_turns(lambda plain=plain, a=a: plain(*a), lambda kern=kern, a=a: kern(*a),
                     rounds=4, plain_calls=2),
            KP.bound_ms(KP.GLUE_ROW_BYTES[k] * NUM_OBJS, 0),
            "one phase of elementwise glue, which PyTorch runs as one launch an op",
            floor=lambda kern=kern, fl=fl: kern(*fl), floor_at=f"{FLOOR_N} objects")
    b = KP.bound_ms(KP.GLUE_ROW_BYTES["respond (pairs)"] * NUM_OBJS, 0)
    report["respond"]["pairs"] = dict(
        ms=graph_ms(lambda: GL.respond(*dry["respond (pairs)"])), bound_ms=b[0],
        bound_by=b[1])
    log(f"respond with the pair pass's inputs: device-only "
        f"{report['respond']['pairs']['ms']:.4f} ms, bound {b[0]:.5f} ms")

    # G: one fused substep at 10K, on the dense pile in the spheres scene,
    # and on random objects (random status, flag bits and params) over a
    # bumpy mesh with water in the spheres and the seven-shape scenes, so
    # every branch and every shape group sees objects
    gin = KP.substep_args(dense, sw0, world)
    rng = np.random.default_rng(5)
    rnd = lambda lo, hi: torch.as_tensor(
        rng.uniform(lo, hi, NUM_OBJS).astype(np.float32), device=dev)
    bumpy = torch.as_tensor(rng.standard_normal((128, 128)).astype(np.float32)
                            * 0.3 - 0.5, device=dev)
    gin_rand = (rnd(-2.5, 2.5), rnd(-2.5, 2.5), rnd(-1.0, 1.0), rnd(-12, 12),
                rnd(-12, 12), rnd(-16, 8),
                torch.as_tensor(rng.integers(0, 5, NUM_OBJS).astype(np.int32), device=dev),
                torch.as_tensor(rng.integers(0, 128, NUM_OBJS).astype(np.int32), device=dev),
                rnd(0.02, 0.1), rnd(0.0, 0.3), rnd(0.0, 1.3), rnd(0.5, 1.5),
                rnd(0.2, 1.0), rnd(0.3, 2.0), rnd(5.0, 30.0),
                GK.mesh_maps(bumpy, world), NK.kernel_tables(gc), gin[-1].clone())
    gin_rand[-1][5] = 0.25                          # the water plane
    gin7 = gin_rand[:-2] + (NK.kernel_tables(g7), gin_rand[-1])
    gin_wide = [gin[:16] + (NK.kernel_tables(gw), gin[17]) for gw in wide]
    plain_g = lambda a: PF.substep_plain(*a[:-2], a[-2][0], a[-1])
    dg, unequal = 0.0, []
    for args in (gin, gin_rand, gin7, *gin_wide):
        out = GK.substep(*args)
        ref = plain_g(args)
        dg = max(dg, max(float((a - b).abs().max()) for a, b in zip(out[:6], ref[:6])))
        bad = torch.zeros(NUM_OBJS, dtype=torch.bool, device=dev)
        for a, b in zip(out, ref):
            bad |= a != b
        unequal.append((int(bad.sum()), int((out[6] != ref[6]).sum()),
                        int((out[7] != ref[7]).sum()),
                        int(((ref[7] & ~args[7] & 2) != 0).sum())))
    log(f"substep: max diff {dg:.3g}; (objects not bitwise equal, status "
        f"unequal, flags unequal, new cobj hits) dense pile {unequal[0]}, random "
        f"objects {unequal[1]}, seven shapes {unequal[2]}, wide tables M = "
        f"{wide[0].size} {unequal[3]} and M = {wide[1].size} {unequal[4]} of {NUM_OBJS}")
    need(dg < 1e-5 and all(u[1] == 0 and u[2] == 0 for u in unequal)
         and unequal[0][3] > 1000 and unequal[2][3] > 100
         and all(u[3] > 500 for u in unequal[3:]),
         "substep: " + TOLS["substep"] + ", with cobj hits")
    for args in (gin, gin7):
        need(all(torch.equal(a, b) for a, b in zip(
            GK.substep(*args), GK.substep(*args, kernel=gk64))),
            "substep: 384-row and 64-row chunks give the same bits")
    log(f"substep, M = {gc.size} and {g7.size}: bitwise equal through 64-row chunks")

    def substep_bound(a, g):
        return KP.bound_ms(23 * NUM_OBJS * 4 + a[15].numel() * 4
                           + a[16][2].numel() * 4 + 32 + 48,
                           NUM_OBJS * (COBJ_TEST_OPS * sum(hi - lo for lo, hi in g.bounds)
                                       + SUBSTEP_OBJ_OPS))

    gin_floor = tuple(t[:FLOOR_N].contiguous() for t in gin[:15]) + gin[15:]
    add("substep", dg,
        in_turns(lambda: plain_g(gin), lambda: GK.substep(*gin),
                 rounds=6, plain_calls=2),
        substep_bound(gin, gc),
        "no PyTorch call runs a physics substep",
        floor=lambda: GK.substep(*gin_floor), floor_at=f"{FLOOR_N} objects")
    report["substep"]["wide"] = []
    for gw, a in zip(wide, gin_wide):
        ms = graph_ms(lambda a=a: GK.substep(*a))
        b = substep_bound(a, gw)
        report["substep"]["wide"].append(dict(slots=gw.size, ms=ms, bound_ms=b[0],
                                              bound_by=b[1]))
        log(f"substep, M = {gw.size} ({-(-gw.size // NK.CHUNK_ROWS)} chunks), dense "
            f"pile: device-only {ms:.4f} ms, bound {b[0]:.5f} ms by {b[1]}")

    # E: 256 tiles of 128^2, all 90 terms, at the terrain path's origins
    # (the timed case) and at the rate loop's last ones
    out = NZK.tile_noise(*nargs, start_sin=0)
    ref = N.tile_noise(*nargs, start_sin=0)
    de = float((out - ref).abs().max())
    far = (table, (x0 + KP.RATE_SHIFT).contiguous()) + nargs[2:]
    de_far = float((NZK.tile_noise(*far) - N.tile_noise(*far)).abs().max())
    slow = float((KP.sine_arguments(*far).abs() > KP.SINF_FAST_MAX).float().mean())
    log(f"tile_noise: max diff {de:.3g} on heights up to {float(ref.abs().max()):.3g}; "
        f"at x0 + {KP.RATE_SHIFT} ({100 * slow:.1f}% of the sine arguments above "
        f"{KP.SINF_FAST_MAX:.0f}): max diff {de_far:.3g}, device-only "
        f"{graph_ms(lambda: NZK.tile_noise(*far)):.4f} ms")
    need(de < 1e-3 and de_far < 1e-3 and slow > 0.05,
         "tile_noise: " + TOLS["tile_noise"] + ", at both origins")
    K = N.F_TABLE_SIZE
    nargs1 = (table, x0[:1].contiguous(), y0[:1].contiguous()) + nargs[3:]
    add("tile_noise", max(de, de_far),
        in_turns(lambda: N.tile_noise(*nargs, start_sin=0),
                 lambda: NZK.tile_noise(*nargs, start_sin=0), rounds=10,
                 plain_calls=5),
        KP.bound_ms(out.numel() * 4 + 5 * K * 4 + 2 * NUM_TILES * 4,
                    out.numel() * K * 2 + NUM_TILES * 2 * 128 * K * SIN_TERM_OPS),
        "the term tables need sin, then an einsum: two calls or more",
        floor=lambda: NZK.tile_noise(*nargs1), floor_at="one tile")

    # F: the default light grid
    out = FK.diffuse_smoke_open(smoke0)
    ref = WS.diffuse_smoke_open(smoke0)
    df = float((out - ref).abs().max())
    # and a ragged grid of single-cell runs (nx % 4 != 0)
    rsm = torch.rand((5, 37, 61), generator=gen, device=dev) * 5
    rsm[0, 0, 0], rsm[-1, -1, -1] = 150.0, -20.0     # both clamps
    rneq = int((FK.diffuse_smoke_open(rsm) != WS.diffuse_smoke_open(rsm)).sum())
    log(f"diffuse_smoke: {LIGHT_GRID}, max diff {df:.3g}, not bitwise "
        f"{int((out != ref).sum())} of {out.numel()}; (5, 37, 61) not bitwise "
        f"{rneq}; z block {FK.z_block(*LIGHT_GRID, 4)} layers")
    need(bool(torch.equal(out, ref)) and rneq == 0,
         "diffuse_smoke: " + TOLS["diffuse_smoke"])
    tiny = torch.rand(SMOKE_FLOOR, generator=gen, device=dev) * 5
    add("diffuse_smoke", df,
        in_turns(lambda: WS.diffuse_smoke_open(smoke0),
                 lambda: FK.diffuse_smoke_open(smoke0), rounds=10, plain_calls=5),
        KP.bound_ms(2 * smoke0.numel() * 4, STENCIL_CELL_OPS * smoke0.numel()),
        "the z exchange depends on the sign of the difference and ends in a "
        "clamp, so it is no conv3d",
        floor=lambda: FK.diffuse_smoke_open(tiny), floor_at=f"a {SMOKE_FLOOR} grid")

    mark("5")
    # ---- 5. small combined step: card vs CPU ------------------------------
    sworld = WorldConst(mesh_x=32, mesh_y=32)
    scfg = TMOD.TileModelConfig(tile_size=32, erosion_iters_tt=128,
                                erosion_batch=128, erosion_steps=8)
    gcpu = torch.Generator().manual_seed(3)
    sargs = TMOD.example_inputs(scfg, sworld, gcpu, num_tiles=2,
                                device="cpu")
    spos, svel = PM.spawn(256, gcpu, device="cpu")
    ssw = PM.build_spheres_world(spos, svel * 8, world=sworld,
                                  device="cpu")
    cpu_tiles, cpu_st = EN.combined_step(*sargs, ssw.state, ssw, scfg, sworld)
    gsw = convert.spheres_world(convert.to_numpy(ssw), dev)
    gargs = (convert.sine_table(convert.to_numpy(sargs[0]), dev),
             *(a.to(dev) for a in sargs[1:]))
    gpu_tiles, gpu_st = EN.combined_step(*gargs, gsw.state, gsw, scfg, sworld)
    gpu_st = convert.to_numpy(gpu_st)
    dt = (gpu_tiles.cpu() - cpu_tiles).abs()
    ok_pos = np.ones(256, bool)
    for name in ("px", "py", "pz", "vx", "vy", "vz"):
        ok_pos &= np.abs(getattr(gpu_st, name) - getattr(cpu_st, name).numpy()) <= 1e-4
    same_status = gpu_st.status == cpu_st.status.numpy()
    log(f"small combined step, card vs CPU: tiles max diff {float(dt.max()):.3g}, "
        f"cells > 1e-4: {int((dt > 1e-4).sum())} of {dt.numel()}; objects within "
        f"1e-4: {int(ok_pos.sum())}/256, same status {int(same_status.sum())}/256")
    need(float((dt <= 1e-4).float().mean()) >= 0.999, "small step: 99.9% of tile cells within 1e-4")
    need(ok_pos.mean() >= 0.99 and same_status.mean() >= 0.99,
         "small step: 99% of objects within 1e-4 and same status")

    # the fused frame, 256 objects, 2 substeps
    cpu_f = PS.step_objects_fused(ssw.state, ssw.env, ssw.cobjs, ssw.table,
                                  substeps=2, world=sworld)
    gpu_f = convert.to_numpy(PS.step_objects_fused(
        gsw.state, gsw.env, gsw.cobjs, gsw.table, substeps=2, world=sworld))
    ok_f = np.ones(256, bool)
    for name in ("px", "py", "pz", "vx", "vy", "vz"):
        ok_f &= np.abs(getattr(gpu_f, name) - getattr(cpu_f, name).numpy()) <= 1e-4
    same_f = gpu_f.status == cpu_f.status.numpy()
    log(f"small fused frame, card vs CPU: objects within 1e-4: "
        f"{int(ok_f.sum())}/256, same status {int(same_f.sum())}/256")
    need(ok_f.mean() >= 0.99 and same_f.mean() >= 0.99,
         "small fused frame: 99% of objects within 1e-4 and same status")

    mark(None)
    log(f"chip_smoke total: {time.perf_counter() - t_script:.1f} s")
    # ---- results ----------------------------------------------------------
    srcs = {"erosion": ("erosion_walk", "w3d_torch/csrc/erosion.cu",
                        "3dworld_tpu/ops/pallas/erosion_kernel.py:226"),
            "sample": ("sample_mesh", "w3d_torch/csrc/sample.cu",
                       "3dworld_tpu/ops/pallas/sample_kernel.py:105"),
            "narrow": ("deepest_hits", "w3d_torch/csrc/narrow.cu",
                       "3dworld_tpu/ops/pallas/narrow_kernel.py:319"),
            "pairs": ("banded_pairs", "w3d_torch/csrc/pairs.cu",
                      "3dworld_tpu/ops/pallas/pairs_kernel.py:168"),
            "substep": ("substep", "w3d_torch/csrc/substep.cu",
                        "3dworld_tpu/ops/pallas/physics_kernel.py:543"),
            "tile_noise": ("tile_noise", "w3d_torch/csrc/noise.cu",
                           "3dworld_tpu/ops/pallas/noise_kernel.py:82"),
            "diffuse_smoke": ("diffuse_smoke_open", "w3d_torch/csrc/stencil.cu",
                              "3dworld_tpu/ops/pallas/stencil_kernel.py:62"),
            **{k: (k, "w3d_torch/csrc/substep_glue.cu", at) for k, at in zip(GLUE, (
                *("3dworld_tpu/physics/step.py:731 (_substep, fused by XLA)",) * 4,
                "3dworld_tpu/physics/step.py:258 (spatial_sort, fused by XLA)",
                "3dworld_tpu/physics/step.py:1108 (_frame_bookkeeping, fused by XLA)"))}}
    for n, r in report.items():
        floor = f", floor {r['floor']:.4f} ms ({r['floor_at']})"
        log(f"{n}: kernel {r['ms']:.4f} ms device-only{floor}, plain "
            f"{r['plain_ms']:.4f} ms, bound {r['bound'][0]:.5f} ms by "
            f"{r['bound'][1]} (roofline share {100 * r['bound'][0] / r['ms']:.1f}%), "
            f"max abs err {r['err']:.3g} ({TOLS[n]}); no library call: {r['note']}")
    log(json.dumps({
        "metrics": {"terrain_tiles_per_sec": tiles_per_s,
                    "physics_frames_per_sec_10k": fps[5],
                    "physics_fps_pair_every_1": fps[1],
                    "physics_fused_frames_per_sec_10k": fps["fused"],
                    "terrain_tiles_per_sec_padded": padded_tiles_per_s,
                    "time_to_first_tiles_s": ttfr_tiles,
                    "time_to_first_fused_frame_s": ttfr_fused,
                    "ground_ms_per_frame_spheres": ground["spheres"]["ms_per_frame"],
                    "ground_ms_per_frame_fbm": ground["fbm"]["ms_per_frame"],
                    "gen_terrain_ms": gen_ms,
                    "ungrouped_narrow_ms_2000x640": plain_narrow["graph_ms"],
                    **{k: v for k, v in scene3e.items() if k != "launches"},
                    **{k: v for k, v in game3f.items() if k != "launches"},
                    **{k: v for k, v in tiled3g.items() if k != "launches"},
                    **{k: v for k, v in universe3h.items()
                       if k not in ("launches", "pairs_universe")},
                    **{k: v for k, v in voxel3i.items() if k != "launches"},
                    **{k: v for k, v in light3j.items() if k != "launches"},
                    **{k: v for k, v in world3k.items() if k != "launches"},
                    **{k: v for k, v in build3l.items() if k != "launches"},
                    **{k: v for k, v in weather3m.items() if k != "launches"},
                    **{k: v for k, v in shard3n.items() if k != "launches"},
                    **{k: v for k, v in agents3o.items() if k != "launches"}},
        "card": smi}))
    log(json.dumps({"kernels": [
        {"name": srcs[n][0], "route": "cuda", "source": srcs[n][1],
         "replaces": srcs[n][2], "launches": launches[n],
         "max_abs_err": report[n]["err"], "ms": report[n]["ms"],
         "plain_ms": report[n]["plain_ms"], "bound_ms": report[n]["bound"][0],
         "bound_by": report[n]["bound"][1], "library_ms": None,
         "library_none_because": report[n]["note"],
         "floor_ms": report[n]["floor"], "floor_at": report[n]["floor_at"],
         **{k: report[n][k] for k in ("padded", "wide", "universe", "pairs")
            if k in report[n]}}
        for n in srcs]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

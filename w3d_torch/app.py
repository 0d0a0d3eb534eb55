"""Application entry, ground mode: config -> scene -> frame loop (port of
the ground half of `3dworld_tpu/app.py`).

The reference's `main` (3DWorld.cpp) reads the config, selects the world
mode, builds the scene and runs the display loop.  This is the ground-mode
path without the GL window: frames run headless on the card, and each
frame (or chunk of chained frames) prints one JSON line with the JAX
package's keys.

    python -m w3d_torch.app --config scene_config/config_spheres.txt \\
        --mode ground --frames 10

Not ported: the tiled and universe modes, FPS game mode (`--game`) and
the tiled mode's record, replay and spectator options (`--record`,
`--replay`, `--spectate`); asking for one raises NotImplementedError
naming its ROADMAP item.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch


def run_ground(config: str, frames: int, num_objects: int, chain: int = 32,
               device: torch.device | str = "cuda"):
    """Ground-mode loop.  Scenes without platforms chain `chain` frames
    per call (models.world.ground_frames_chained), which queues a chunk
    without a host sync; platform scenes and `chain <= 1` run the
    per-frame path (models.world.ground_frame).  The player walks a small
    circle through the scene.  Returns the stepped scene."""
    from .scene.loader import load_scene
    from .models.world import ground_frame, ground_frames_chained
    from .gameplay import player as PL
    scene = load_scene(config, num_objects=num_objects, device=device)
    ply = PL.make_player(0.0, 0.0, 1.0, device=device)
    has_platforms = scene.platforms is not None and scene.platforms.size > 0
    if has_platforms or chain <= 1:
        for i in range(frames):
            t0 = time.perf_counter()
            scene = ground_frame(scene)
            ply = PL.step_player(ply, scene.env.mesh_height, scene.cobjs,
                                 np.cos(0.2 * i), np.sin(0.2 * i), False,
                                 world=scene.world)
            live = int((scene.objects.status > 0).sum())
            print(json.dumps({"frame": i, "mode": "ground", "live": live,
                              "player_z": round(float(ply.z[0]), 3),
                              "ms": round((time.perf_counter() - t0) * 1e3, 3)}))
        return scene
    smoke = scene.light_grid.smoke if scene.smoke_active else None
    i = 0
    while i < frames:
        k = min(chain, frames - i)
        t0 = time.perf_counter()
        steps = 0.2 * (i + torch.arange(k, device=device))
        mv = torch.stack([torch.cos(steps), torch.sin(steps)], -1)
        out = ground_frames_chained(
            scene.objects, scene.env, scene.cobjs, scene.table,
            scene.ripples, ply, mv, scene.world, k, smoke=smoke)
        if smoke is None:
            st, rip, ply, live = out
        else:
            st, rip, ply, live, smoke = out
            scene.light_grid = scene.light_grid._replace(smoke=smoke)
        live_last = int(live[-1])
        scene.objects, scene.ripples = st, rip
        dt = (time.perf_counter() - t0) / k
        print(json.dumps({"frame": i + k - 1, "mode": "ground",
                          "chained": k, "live": live_last,
                          "player_z": round(float(ply.z[0]), 3),
                          "ms": round(dt * 1e3, 3)}))
        i += k
    return scene


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", default="scene_config/config_spheres.txt",
                    help="scene config (ground mode)")
    ap.add_argument("--mode", choices=("ground", "tiled", "universe"),
                    default="ground")
    ap.add_argument("--frames", type=int, default=10)
    ap.add_argument("--chunk", type=int, default=32,
                    help="frames chained per call (ground scenes without "
                         "platforms; 1 runs frame by frame)")
    ap.add_argument("--objects", type=int, default=2000)
    ap.add_argument("--game", action="store_true",
                    help="FPS game mode (not ported)")
    ap.add_argument("--record", default=None, help="(tiled mode; not ported)")
    ap.add_argument("--replay", default=None, help="(tiled mode; not ported)")
    ap.add_argument("--spectate", action="store_true",
                    help="(tiled mode; not ported)")
    args = ap.parse_args(argv)
    if args.mode == "tiled":
        raise NotImplementedError("--mode tiled is not ported (ROADMAP Queue 1, "
                                  "items 6 and 10)")
    if args.mode == "universe":
        raise NotImplementedError("--mode universe is not ported (ROADMAP Queue 1, "
                                  "items 8 and 10)")
    if args.game:
        raise NotImplementedError("--game (FPS game mode) is not ported "
                                  "(ROADMAP Queue 1, item 9)")
    if args.record or args.replay or args.spectate:
        raise NotImplementedError("--record, --replay and --spectate belong to "
                                  "tiled mode, which is not ported (ROADMAP "
                                  "Queue 1, items 6 and 10)")
    run_ground(args.config, args.frames, args.objects, chain=args.chunk)


if __name__ == "__main__":
    main()

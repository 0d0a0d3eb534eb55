"""Application entry, ground mode: config -> scene -> frame loop (port of
the ground half of `3dworld_tpu/app.py`).

The reference's `main` (3DWorld.cpp) reads the config, selects the world
mode, builds the scene and runs the display loop.  This is the ground-mode
path without the GL window: frames run headless on the card, and each
frame (or chunk of chained frames) prints one JSON line with the JAX
package's keys.

    python -m w3d_torch.app --config scene_config/config_spheres.txt \\
        --mode ground --frames 10
    python -m w3d_torch.app --config <cfg> --mode ground --game --smileys 8

`--game` runs FPS game mode: smiley AI, weapons and explosions over the
ground frame.  `W3D_PLATFORM=cpu` runs on the CPU (the JAX app's platform
override); by default everything runs on the card.  Not ported: the tiled
and universe modes and the tiled mode's record, replay and spectator
options (`--record`, `--replay`, `--spectate`); asking for one raises
NotImplementedError naming its ROADMAP item.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch


def run_ground(config: str, frames: int, num_objects: int, chain: int = 32,
               game: bool = False, num_smileys: int = 8,
               device: torch.device | str = "cuda", draws=None):
    """Ground-mode loop.  Scenes without platforms chain `chain` frames
    per call (models.world.ground_frames_chained), which queues a chunk
    without a host sync; platform scenes and `chain <= 1` run the
    per-frame path (models.world.ground_frame).  The player walks a small
    circle through the scene, on the per-frame path over the default
    world's grid, as the JAX app's does.  `game` runs FPS game mode
    (`_run_ground_game`, with `draws`).  Returns the stepped scene."""
    from .scene.loader import load_scene
    from .models.world import ground_frame, ground_frames_chained
    from .gameplay import player as PL
    scene = load_scene(config, num_objects=num_objects, device=device)
    ply = PL.make_player(0.0, 0.0, 1.0, device=device)
    if game:
        return _run_ground_game(scene, ply, frames, num_smileys, draws=draws)
    has_platforms = scene.platforms is not None and scene.platforms.size > 0
    if has_platforms or chain <= 1:
        for i in range(frames):
            t0 = time.perf_counter()
            scene = ground_frame(scene)
            ply = PL.step_player(ply, scene.env.mesh_height, scene.cobjs,
                                 np.cos(0.2 * i), np.sin(0.2 * i), False)
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


class GameDraws:
    """The draws of FPS game mode, which the JAX app takes from threefry
    keys (`fold_in(key(seed), 0)` for the spawn, `100 + i` for frame i's
    AI step, `500 + i` for its fragments).  Each stream here is a CPU
    generator seeded from (`seed`, stream), its draws copied to the
    device, so every device gets the same draws.  A caller (a test, a
    scripted match) replaces the methods to inject other draws."""

    def __init__(self, seed: int = 11):
        self.seed = seed

    def _gen(self, stream: int) -> torch.Generator:
        return torch.Generator().manual_seed(self.seed * 1_000_003 + stream)

    def smileys(self, n: int, device):
        """The initial smileys (`SmileyAI`)."""
        from .gameplay import ai as AI
        x, y, team = AI.draw_spawn(n, self._gen(0))
        return AI.make_ai_smileys(x, y, team, device=device)

    def ai(self, frame: int, n: int, device):
        """Frame `frame`'s `AIDraws`."""
        from .gameplay import ai as AI
        return AI.draw_ai(n, self._gen(100 + frame), device=device)

    def fragment_seed(self, frame: int) -> int:
        """The seed of frame `frame`'s fragment velocities."""
        return int(torch.randint(0, 2 ** 31 - 1, (1,), generator=self._gen(500 + frame)))


def _run_ground_game(scene, ply, frames: int, num_smileys: int = 8,
                     draws: GameDraws | None = None):
    """FPS game-mode frame loop: physics frame + smiley AI + weapon fire +
    explosion feedback (update_game_frame + advance_smiley per frame,
    3DWorld.cpp display loop with game_mode=1).  Each frame reads back
    the fire mask and, when a smiley fires, the free slots and the
    shooters; the explosions come back from `update_game_frame`.  One
    JSON line a frame, with the JAX app's keys."""
    from .models.world import ground_frame
    from .gameplay import ai as AI
    from .gameplay import game as GG
    from .gameplay import frame as GF
    from .physics import destroy as PD
    draws = draws or GameDraws()
    dev = scene.objects.px.device
    sm = draws.smileys(num_smileys, dev)
    ds = PD.make_destroy_state(scene.cobjs)
    shots = 0
    for i in range(frames):
        t0 = time.perf_counter()
        scene = ground_frame(scene)
        sm, fire, _ = AI.step_smileys_ai(sm, draws.ai(i, num_smileys, dev), scene.cobjs)
        fi = np.where(fire.cpu().numpy())[0]
        if len(fi):
            st = scene.objects
            free = np.where(st.status.cpu().numpy() == 0)[0]
            fptr = 0
            smx, smy, smz, ltx, lty, ltz, wsel = (
                a.cpu().numpy() for a in (sm.x, sm.y, sm.z, sm.ltx, sm.lty, sm.ltz,
                                          sm.weapon))
            for si in fi:
                wi = int(wsel[si])
                w = GG.WEAPONS[wi]
                origin = (float(smx[si]), float(smy[si]), float(smz[si]) + 0.05)
                d = (float(ltx[si] - smx[si]), float(lty[si] - smy[si]),
                     float(ltz[si] - smz[si]))
                if w[1] is None:    # hitscan (m16/shotgun/laser/melee)
                    st, _, _ = GG.fire_hitscan(st, scene.cobjs, origin, d, wi, scene.table)
                else:
                    ns = w[5]
                    st = GG.fire_weapon(st, free[fptr:fptr + ns].tolist(), wi, origin,
                                        d, scene.table)
                    fptr += ns
                shots += 1
            scene.objects = st
        res = GF.update_game_frame(scene.objects, scene.cobjs, ds, scene.table,
                                   seed=draws.fragment_seed(i))
        scene.objects, scene.cobjs = res.state, res.cobjs
        # blast damage reaches the smiley population too (Gameplay.cpp
        # blast_radius smiley damage)
        for (ex, ey, ez, er) in res.explosions:
            d2 = (sm.x - float(ex)) ** 2 + (sm.y - float(ey)) ** 2 + (sm.z - float(ez)) ** 2
            er = PD.as_f32(max(float(er), 1e-6), sm.x)
            f = torch.clamp(1.0 - torch.sqrt(d2) / er, min=0.0)
            sm = sm._replace(health=sm.health - 100.0 * f)
        alive = int((sm.health > 0).sum())
        print(json.dumps({
            "frame": i, "mode": "ground-game", "smileys": alive,
            "shots": shots, "explosions": int(len(res.explosions)),
            "live": int((scene.objects.status > 0).sum()),
            "ms": round((time.perf_counter() - t0) * 1e3, 3)}))
    return scene


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", default="scene_config/config_spheres.txt",
                    help="scene config (ground mode)")
    ap.add_argument("--mode", choices=("ground", "tiled", "universe"),
                    default="ground")
    ap.add_argument("--frames", type=int, default=10)
    ap.add_argument("--chunk", type=int, default=32,
                    help="frames chained per dispatch (tiled mode, not "
                         "ported; ground mode chains 32)")
    ap.add_argument("--objects", type=int, default=2000)
    ap.add_argument("--game", action="store_true",
                    help="FPS game mode: smiley AI + weapons (ground)")
    ap.add_argument("--smileys", type=int, default=8)
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
    if args.record or args.replay or args.spectate:
        raise NotImplementedError("--record, --replay and --spectate belong to "
                                  "tiled mode, which is not ported (ROADMAP "
                                  "Queue 1, items 6 and 10)")
    device = "cpu" if os.environ.get("W3D_PLATFORM") == "cpu" else "cuda"
    run_ground(args.config, args.frames, args.objects, game=args.game,
               num_smileys=args.smileys, device=device)


if __name__ == "__main__":
    main()

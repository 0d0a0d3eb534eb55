"""Application entry (port of `3dworld_tpu/app.py`): config -> world mode ->
frame loop.

The reference's `main` (3DWorld.cpp) reads the config, selects the world
mode, builds the scene and runs the display loop.  This is that path
without the GL window: frames run headless on the card, and each frame
(or chunk of chained frames) prints one JSON line with the JAX package's
keys.

    python -m w3d_torch.app --config scene_config/config_spheres.txt \\
        --mode ground --frames 10
    python -m w3d_torch.app --config <cfg> --mode ground --game --smileys 8
    python -m w3d_torch.app --mode tiled --frames 64 [--chunk 16] [--seed 1] \\
        [--record session.uel | --replay session.uel] [--spectate]
    python -m w3d_torch.app --mode universe --frames 192 [--chunk 32] [--seed 1]

`--game` runs FPS game mode: smiley AI, weapons and explosions over the
ground frame.  `--mode tiled` streams terrain tiles around a moving camera
and runs the live city (traffic, crowds, building people) and the tiled
fauna, `--chunk` frames a chained call; `--record` writes the session's
event journal and per-chunk state hashes, `--replay` drives a session
from a journal and reproduces its hashes, `--spectate` follows the
closest city agent.  `--mode universe` pages the universe's cells
around a camera moving 0.5 a frame and fights a fleet, `--chunk` frames a
chained call: the ship-defs file under the asset root
(`W3D_ASSET_ROOT/universe/ship_defs.txt`, or the file its
`config_universe.txt` names) gives the fleets and the full weapon model;
without one, 64 ships of the built-in classes fight without it.
`W3D_PLATFORM=cpu` runs on the CPU (the JAX app's platform override); by
default everything runs on the card.
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
    (`_run_ground_game`, with `draws`).  A config with `num_light_rays`
    bakes its lighting first (`scene.bake`).  Returns the stepped scene."""
    from .scene.loader import load_scene
    from .models.world import ground_frame, ground_frames_chained
    from .gameplay import player as PL
    scene = load_scene(config, num_objects=num_objects, device=device)
    if scene.bake is not None:
        # the load-time lighting bake, before the first frame; the bake
        # keeps its rays and seconds (`counts`, `seconds`)
        scene.light_grid = scene.bake.run()
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


class TiledDraws:
    """The draws of tiled mode, which the JAX app takes from threefry keys
    (the city state's key, split five ways a frame; `fold_in(key(seed ^
    0xFA0A), 100 + i)` for the fauna of the chunk at frame i, and folds
    0, 1, 2 of that key for the spawns).  Each stream here is a CPU
    generator seeded from (`seed`, stream), its draws copied to the
    device, so every device gets the same draws.  A caller (a test)
    replaces the methods to inject other draws."""

    CITY = 2 << 20      # + the chunk's first frame
    FAUNA = 1 << 20     # + the chunk's first frame

    def __init__(self, seed: int = 1):
        self.seed = seed

    def _gen(self, stream: int) -> torch.Generator:
        return torch.Generator().manual_seed(((self.seed % 2 ** 31) << 32) | stream)

    def city(self, frame: int, frames: int, w):
        """The `city_step.CityDraws` of the chunk of `frames` frames that
        starts at `frame`, for the TiledWorld `w`."""
        from .city import city_step as CS
        cs = w.city
        count = lambda v: 0 if v is None else v.shape[0]
        return CS.draw_city(frames, cs.peds.x.shape[0],
                            count(cs.helis and cs.helis.px), count(w.pads),
                            count(cs.birds and cs.birds.px), count(w.perches),
                            self._gen(self.CITY + frame), device=cs.peds.x.device)

    def fauna(self, frame: int, frames: int, n_birds: int, n_bfly: int,
              n_fish: int, device):
        """The `veg/animals.FaunaDraws` of the chunk at `frame`."""
        from .veg import animals as VA
        return VA.draw_fauna(frames, n_birds, n_bfly, n_fish,
                             self._gen(self.FAUNA + frame), device=device)

    def fauna_birds(self, n: int, device):
        """The terrain flock's spawn rows (`veg/animals.draw_animals`)."""
        from .veg import animals as VA
        return VA.draw_animals(n, self._gen(0)).to(device)

    def butterflies(self, n: int, world, device):
        from .veg import animals as VA
        return VA.draw_butterflies(n, world, self._gen(1)).to(device)

    def fish(self, n: int, world, device):
        from .veg import animals as VA
        return VA.draw_fish(n, world, self._gen(2)).to(device)


def _world_hash(w, tm) -> str:
    """Deterministic digest of the live tiled-world state (cars, peds,
    building people, tile keys) — the replay-equality check target.  The
    same bytes in the same order as the JAX app's: `cars.seg` int32,
    `cars.t`, `peds.x`, `peds.y` and the probe float32, then the sorted
    tile keys."""
    import hashlib
    h = hashlib.sha256()
    for a in (w.cars.seg, w.cars.t, w.peds.x, w.peds.y):
        h.update(np.ascontiguousarray(a.cpu().numpy()).tobytes())
    if w.last_probe is not None:
        h.update(np.ascontiguousarray(np.asarray(w.last_probe)).tobytes())
    h.update(",".join(map(str, sorted(tm.tiles))).encode())
    return h.hexdigest()[:16]


FAUNA_WATER_Z = -0.4


def run_tiled(frames: int, seed: int, chunk: int = 16,
              record: str | None = None, replay: str | None = None,
              spectate: bool = False, device: torch.device | str = "cuda",
              draws: TiledDraws | None = None):
    """Tiled-city loop with session record/replay (`-uel` semantics,
    u_event.cpp:23-60): `record` writes an event journal (srand seed +
    per-chunk camera inputs) plus per-chunk state hashes; `replay`
    drives the loop from a journal instead of the default camera path
    and must reproduce the hashes bit-identically.  `spectate` follows
    the closest city agent with the camera (city_interact.cpp
    city_spectate_manager_t) instead of the default camera path.

    The world: 64^2 tiles of the seed's terrain, one 128^2 city with 64
    cars, 128 pedestrians, 8 birds, 2 trains and a furnished 3-floor tower
    with 48 people, and the tiled fauna (16 birds, 16 butterflies, 32
    fish) over the camera tile.  `draws` (default `TiledDraws(seed)`, the
    seed read from a replayed journal) gives every draw.  Prints one JSON
    line a chunk with the JAX app's keys; returns the TiledWorld with the
    chunk hashes in `frame_hashes`."""
    from types import SimpleNamespace
    from .models.world import make_tiled_world
    from .terrain.tiles import TileManager
    from .terrain.mesh import TerrainConfig
    from .utils.constants import WorldConst
    from .city import assemble as CA
    from .city import floorplan as CF
    from .city import room_content as CRC
    from .city import spectate as CSP
    from .utils import events as EV
    from .veg import animals as VA

    journal = rp = None
    if replay:
        rp = EV.Replay(EV.EventJournal.load(replay))
        for (_f, kind, payload) in rp.events_for_frame(0):
            if kind == EV.EV_SRAND:
                seed = int(payload[0])
    if record:
        journal = EV.EventJournal()
        journal.record(0, EV.EV_SRAND, seed)
    draws = draws or TiledDraws(seed)
    tm = TileManager(cfg=TerrainConfig(mesh_seed=seed),
                     world=WorldConst(mesh_x=64, mesh_y=64), tile_size=64,
                     device=device)
    # full live city over a flat region (gen_cities + traffic init)
    cw = CA.build_city(np.zeros((128, 128), np.float32), num_cities=1,
                       num_cars=64, num_peds=128, seed=seed, device=device)
    # building AI in the same fused frame: one furnished tower with
    # people riding its stairs/elevators
    interior = CF.gen_interior((0.0, 0.0, 0.0, 1.2, 0.9, 0.4), 3, 0.08, seed=seed)
    objs = CRC.furnish_rooms(interior, 0.08, seed=seed)
    w = make_tiled_world(tm, cw, builders=[(interior, 48, objs)], seed=seed,
                         chunk=chunk, num_birds=8, num_trains=2, draws=draws,
                         device=device)
    # tiled-terrain fauna (animals.cpp): terrain bird flock + butterflies
    # + fish, chained per chunk over the camera tile's mesh (separate from
    # the city's perch birds above)
    wl = WorldConst(mesh_x=64, mesh_y=64)
    fauna_birds = VA.make_animals(draws.fauna_birds(16, device), VA.A_BIRD,
                                  center=(0.0, 0.0, 1.0))
    fauna_bfly = VA.make_butterflies(draws.butterflies(16, wl, device))
    fauna_fish = None    # spawned from the first camera tile's mesh
    cam, cam_y = 0.0, 0.0
    spec = None
    shim = lambda: SimpleNamespace(cars=w.cars, peds=w.peds, graph=w.road_graph)
    if spectate:
        # toggle from the starting camera; wide radius so the demo city
        # always yields a followed agent
        spec = CSP.toggle(CSP.Spectate(), cam, cam_y, shim(), camera_radius=25.0)
    hashes = []
    i = 0
    while i < frames:
        k = min(chunk, frames - i)
        if spec is not None and spec.mode != CSP.SPEC_NONE:
            eye = CSP.camera_state(spec, shim())
            if eye is not None:
                cam, cam_y = eye[0], eye[1]
        if rp is not None:
            # recorded camera input for this chunk (EV_CAMERA rows)
            for (_f, kind, payload) in rp.events_for_frame(i):
                if kind == EV.EV_CAMERA:
                    cam, cam_y, k = payload[0], payload[1], int(payload[2])
        if journal is not None:
            journal.record(i, EV.EV_CAMERA, cam, cam_y, k)
        t0 = time.perf_counter()
        created, deleted = w.step_chunk(cam, cam_y, frames=k)
        # fauna over the camera tile's mesh, chained the same k frames
        ct = tm.tiles.get(tm.camera_tile(cam, cam_y))
        if ct is not None:
            mesh_t = ct.zvals[:64, :64].contiguous()
            if fauna_fish is None:
                fauna_fish = VA.gen_fish(draws.fish(32, wl, device), mesh_t,
                                         FAUNA_WATER_Z, wl)
            fauna_birds, fauna_bfly, fauna_fish = VA.step_tiled_fauna(
                fauna_birds, fauna_bfly, fauna_fish,
                draws.fauna(i, k, 16, 16, 32, device), mesh_t, wl,
                FAUNA_WATER_Z, cam, cam_y, frames=k)
        cam += 0.8 * k
        acts = (np.bincount(w.last_probe[:, 4].astype(np.int32), minlength=5).tolist()
                if w.last_probe is not None else [])
        dt = (time.perf_counter() - t0) / k
        hashes.append(_world_hash(w, tm))
        print(json.dumps({"frame": i + k - 1, "mode": "tiled",
                          "chained": k,
                          "tiles": len(tm.tiles),
                          "cars": int(w.cars.seg.shape[0]),
                          "peds": int(w.peds.x.shape[0]),
                          "bldg_people_acts": acts,
                          "fauna": [int(fauna_birds.px.shape[0]),
                                    int(fauna_bfly.px.shape[0]),
                                    int((fauna_fish.kind >= 0).sum())
                                    if fauna_fish is not None else 0],
                          "created": len(created), "deleted": len(deleted),
                          "hash": hashes[-1],
                          "ms": round(dt * 1e3, 3)}))
        i += k
    if journal is not None:
        journal.save(record)
        with open(record + ".hashes.json", "w") as f:
            json.dump(hashes, f)
    w.frame_hashes = hashes
    w.fauna = (fauna_birds, fauna_bfly, fauna_fish)
    return w


class UniverseDraws:
    """The draws of universe mode, which the JAX app takes from threefry
    keys: `key(seed)` for the fleet (`make_fleet`'s six draws, or
    `fleet_from_defs`' positions) and, whatever the seed, the world's
    `key(1)` folded with the chunk's first frame for the combat frames
    (split per frame, then four ways).  Each stream here is a CPU
    generator seeded from (`seed`, stream), the world's from (1, stream),
    its draws copied to the device through pinned memory (without waiting
    for the card), so every device gets the same draws.  A caller (a test,
    a scripted battle) replaces the methods to inject other draws."""

    WORLD_SEED = 1
    COMBAT = 1 << 20     # + the chunk's first frame

    def __init__(self, seed: int = 1):
        self.seed = seed

    @staticmethod
    def _gen(seed: int, stream: int) -> torch.Generator:
        return torch.Generator().manual_seed(((seed % 2 ** 31) << 32) | stream)

    def fleet(self, n: int, device):
        """`universe/ships.FleetDraws` of the default fleet of `n` ships."""
        from .universe import ships as USH
        return USH.draw_fleet(n, self._gen(self.seed, 0), device=device)

    def fleet_positions(self, n: int) -> np.ndarray:
        """`fleet_from_defs`' [n, 3] uniform [-1, 1) position draw."""
        return (2.0 * torch.rand(n, 3, generator=self._gen(self.seed, 1)) - 1.0).numpy()

    def combat(self, frame: int, frames: int, n: int, slots: int, device):
        """The `universe/combat.CombatDraws` ([frames] leading) of the chunk
        of `frames` frames that starts at `frame`."""
        from .universe import combat as UCB
        from .terrain.tiles import upload
        d = UCB.draw_combat(frames, n, slots, self._gen(self.WORLD_SEED, self.COMBAT + frame))
        return UCB.CombatDraws(*(upload(t.numpy(), device) for t in d))


def run_universe(frames: int, seed: int, ship_defs: str | None = None, chunk: int = 32,
                 device: torch.device | str = "cuda", draws: UniverseDraws | None = None):
    """Universe loop (WMODE_UNIVERSE): cells paged around a camera moving
    0.5 a frame, the fleet advanced `chunk` frames a chained call.  The
    fleet comes from the ship-defs file (`ship_defs`, by default the asset
    root's `universe/ship_defs.txt`, or the file its
    `config_universe.txt` names, else `ship_defs_assault.txt` beside it),
    padded with dead slots for bay launches and fought through the full
    weapon model with a projectile pool of 1,024; without a file, 64 ships
    of the built-in classes and the fleet step.  `draws` (default
    `UniverseDraws(seed)`) gives every draw.  Prints one JSON line a chunk
    with the JAX app's keys; returns the UniverseWorld."""
    from .models.world import UniverseWorld
    from .universe.gen import UniverseState
    from .universe import ship_config as SCfg
    from .universe import ships as USH
    from .universe import combat as UCB

    draws = draws or UniverseDraws(seed)
    if ship_defs is None:   # asset tree (W3D_ASSET_ROOT) when available
        ship_defs = SCfg.shipped_defs_path()
    fleet = tbl = None
    # honor config_universe.txt's ship_def_file when present
    # (3DWorld.cpp binds "ship_def_file"; the shipped config points at
    # universe/ship_defs_fight.txt)
    ucfg = os.path.join(os.path.dirname(ship_defs), "config_universe.txt")
    if os.path.exists(ucfg):
        from .utils import config as C
        try:
            cfg = C.load_config(ucfg)
        except (OSError, ValueError):
            cfg = None
        if cfg is not None and cfg.ship_def_file:
            cand = cfg.ship_def_file
            if not os.path.exists(cand):
                cand = os.path.join(os.path.dirname(os.path.dirname(ship_defs)),
                                    cfg.ship_def_file)
            if os.path.exists(cand):
                ship_defs = cand
    defs = None
    if os.path.exists(ship_defs):
        # the reference config drive: ship classes/weapons/fleets from
        # the ship_def_file (ship_config.cpp)
        try:
            defs = SCfg.parse_ship_defs(ship_defs)
            fleet, tbl, _offs, _np = USH.fleet_from_defs(defs, draws.fleet_positions)
        except (OSError, ValueError, KeyError) as e:
            print(json.dumps({"warn": f"ship defs gave no fleet: {e}"}))
    if fleet is None:
        # fleets live in the assault/teams variants; default combat sim
        alt = os.path.join(os.path.dirname(ship_defs), "ship_defs_assault.txt")
        if os.path.exists(alt):
            defs = SCfg.parse_ship_defs(alt)
            fleet, tbl, _offs, _np = USH.fleet_from_defs(defs, draws.fleet_positions)
        else:
            fleet = USH.make_fleet(draws.fleet(64, device))
    combat = ctbl = None
    if defs is not None:
        # full weapon model: projectiles/beams/bays/PD/boarding driven
        # by the parsed tables, with reserve slots for bay launches
        ctbl = UCB.build_combat_tables(defs, device=device)
        n0 = int(fleet.px.shape[0])
        combat = UCB.make_combat_state(UCB.pad_fleet(fleet, n0 + max(16, n0 // 4)), ctbl,
                                       pool_size=1024)
        fleet = combat.fleet
    w = UniverseWorld(state=UniverseState(), fleet=USH.fleet_to(fleet, device),
                      fleet_tbl=None if tbl is None else torch.as_tensor(tbl, device=device),
                      combat=combat, combat_tables=ctbl, draws=draws)
    pos = [0.0, 0.0, 0.0]
    i = 0
    while i < frames:
        k = min(chunk, frames - i)
        t0 = time.perf_counter()
        created, freed = w.step_chunk(tuple(pos), frames=k)
        pos[0] += 0.5 * k
        alive = int(w.fleet.alive.sum())
        dt = (time.perf_counter() - t0) / k
        print(json.dumps({"frame": i + k - 1, "mode": "universe", "chained": k,
                          "cells_created": len(created), "cells_freed": len(freed),
                          "ships_alive": alive, "ms": round(dt * 1e3, 3)}))
        i += k
    return w


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", default="scene_config/config_spheres.txt",
                    help="scene config (ground mode)")
    ap.add_argument("--mode", choices=("ground", "tiled", "universe"),
                    default="ground")
    ap.add_argument("--frames", type=int, default=10)
    ap.add_argument("--chunk", type=int, default=32,
                    help="frames chained per dispatch (tiled and universe modes)")
    ap.add_argument("--objects", type=int, default=2000)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--game", action="store_true",
                    help="FPS game mode: smiley AI + weapons (ground)")
    ap.add_argument("--smileys", type=int, default=8)
    ap.add_argument("--record", default=None,
                    help="write a session event journal (tiled mode)")
    ap.add_argument("--replay", default=None,
                    help="replay a recorded session journal (tiled mode)")
    ap.add_argument("--spectate", action="store_true",
                    help="follow the closest city agent (tiled mode)")
    args = ap.parse_args(argv)
    device = "cpu" if os.environ.get("W3D_PLATFORM") == "cpu" else "cuda"
    if args.mode == "ground":
        run_ground(args.config, args.frames, args.objects, game=args.game,
                   num_smileys=args.smileys, device=device)
    elif args.mode == "tiled":
        run_tiled(args.frames, args.seed, chunk=args.chunk, record=args.record,
                  replay=args.replay, spectate=args.spectate, device=device)
    else:
        run_universe(args.frames, args.seed, chunk=args.chunk, device=device)

if __name__ == "__main__":
    main()

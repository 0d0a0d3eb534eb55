"""World-mode frame orchestration (port of the ground half of
`3dworld_tpu/models/world.py`).

The reference's `display()` branches on world mode (3DWorld.h:1360);
WMODE_GROUND runs physics + water + smoke each frame
(display_world.cpp:768).  `ground_frames_chained` runs K such frames per
call: the JAX package scans them on the device; here they are a Python
loop of eager launches that never reads a device value back, so the host
queues all K frames without waiting.

`ground_frame` steps a loaded `GroundScene` (scene/loader.py) by one
frame: the platform and trigger pass, riders, physics, ripples and gated
smoke; `with_valley_water` fills its terrain basins and feeds the water
surface to the physics env.

WMODE_INF_TERRAIN: `TiledWorld` streams tiles (`terrain/tiles`), at most
`tile_budget` new tiles a chunk where it is set, and advances one fused
city state (`city/city_step`) K frames a chunk, with the host's
building-people reroute once per chunk; `make_tiled_world` assembles it.
A chunk runs in the span `frame`; its chained city frames in `city`
(CUDA events on a card; replayed as CUDA graphs once the chunk's shape
repeats, `city_step.FRAMES`), the people probe's fetch in
`sync.people_probe` and the reroute in `city.reroute`.

WMODE_UNIVERSE: `UniverseWorld` pages the universe's cells around the
player (`universe/gen`), steers the player ship, and advances the fleet K
frames a chunk, through the full weapon model (`universe/combat`) when it
has combat tables, else the fleet step (`universe/ships`), then turns
ships away from the stars and black holes near them.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from ..ops.cuda import separation_kernel as SEP
from ..utils.constants import WorldConst
from ..utils.profiler import span
from ..physics import step as PS
from ..water import ripples as WR, smoke as WSM
from ..gameplay import player as PL
from ..physics import platforms as PP
from ..scene.loader import GroundScene


def with_valley_water(scene: GroundScene, volumes_per_basin) -> GroundScene:
    """Fill terrain basins and feed the per-cell water surface into the
    physics env (water_matrix wiring: valleys -> check_water_collision).
    Edits `scene` in place and returns it."""
    from ..water import valleys as WV

    _labels, _zv, water, _wet = WV.fill_valleys(
        scene.env.mesh_height, volumes_per_basin, scene.world)
    scene.env = scene.env._replace(water_height=water)
    return scene


def ground_frame(scene: GroundScene, substeps: int = 4,
                 obj_collisions: bool = True) -> GroundScene:
    """One WMODE_GROUND frame: platforms + process_groups + ripples
    (display() loop; platform/trigger pass = display_world.cpp:889).
    Edits `scene` in place (objects, cobjs, platforms, ripples, the smoke
    grid) and returns it; nothing reads a device value back."""
    if scene.platforms is not None and scene.platforms.size > 0:
        st0 = scene.objects
        trig = None
        if scene.triggers is not None and scene.triggers.x.shape[0] > 0:
            trig = PP.eval_triggers(scene.triggers, st0.px, st0.py, st0.pz,
                                    scene.platforms)
        plats, mx, my, mz = PP.advance_platforms(scene.platforms, trig)
        rad = scene.table.radius[st0.otype.long()]
        dx, dy, dz = PP.rider_deltas(st0.px, st0.py, st0.pz, st0.status,
                                     scene.cobjs, plats, mx, my, mz, rad)
        scene.cobjs = PP.apply_platform_motion(scene.cobjs, plats, mx, my, mz)
        scene.objects = st0._replace(px=st0.px + dx, py=st0.py + dy,
                                     pz=st0.pz + dz)
        scene.platforms = plats
    st = PS.step_objects(scene.objects, scene.env, scene.cobjs, scene.table,
                         substeps=substeps, world=scene.world,
                         obj_collisions=obj_collisions)
    wpz = scene.env.water_plane_z
    inside = wpz > scene.terrain.mesh_height
    depth = torch.clamp(wpz - scene.terrain.mesh_height, min=0.0)
    ripples, _ = WR.step_ripples(scene.ripples, inside, depth)
    # smoke diffusion over the lmcell grid every frame (distribute_smoke,
    # smoke.cpp:184), gated by the HOST flag (set by whoever injects
    # smoke), so no device value is read to decide
    if scene.smoke_active and scene.light_grid is not None:
        scene.light_grid = scene.light_grid._replace(
            smoke=WSM.diffuse_smoke(scene.light_grid.smoke))
    scene.objects = st
    scene.ripples = ripples
    return scene


def ground_frames_chained(objects: PS.ObjectState, env: PS.PhysicsEnv, cobjs,
                          table, ripples: WR.RippleState, player: PL.PlayerState,
                          move_xy, world: WorldConst, frames: int,
                          substeps: int = 4, obj_collisions: bool = True,
                          smoke: torch.Tensor | None = None):
    """K ground frames: physics + ripples + player (+ smoke) per frame.

    `cobjs` is a `GroupedCobjs` or a plain `CobjSet`; `move_xy` is
    [frames, 2] per-frame player input (a tensor on the device, or numpy).
    Smoke steps through the gated `water/smoke.diffuse_smoke`, as the JAX
    frame's XLA call does.  Returns (objects, ripples, player, live
    [frames] int32), and the smoke grid last when `smoke` is given; `live`
    stays on the device."""
    wpz = env.water_plane_z
    inside = wpz > env.mesh_height
    depth = torch.clamp(wpz - env.mesh_height, min=0.0)

    st, rip, ply, smk = objects, ripples, player, smoke
    live = []
    for k in range(frames):
        st = PS.step_objects(st, env, cobjs, table, substeps=substeps,
                             world=world, obj_collisions=obj_collisions)
        rip, _ = WR.step_ripples(rip, inside, depth)
        ply = PL.step_player(ply, env.mesh_height, cobjs, move_xy[k][0],
                             move_xy[k][1], False, world=world)
        if smk is not None:       # distribute_smoke each frame
            smk = WSM.diffuse_smoke(smk)
        live.append((st.status > 0).sum(dtype=torch.int32))
    live = torch.stack(live)
    if smoke is None:
        return st, rip, ply, live
    return st, rip, ply, live, smk


# ---------------------------------------------------------------------------
# tiled-terrain mode
# ---------------------------------------------------------------------------

@dataclass
class TiledWorld:
    """WMODE_INF_TERRAIN session: streamed tiles + one fused city sim.

    The whole per-frame city compute — stoplights, cars, pedestrians,
    helicopters, birds, trains, elevator cars, building people — lives in
    ONE device `CityState` advanced by `city_step.city_frames_chained`, K
    frames a chunk, queued without a host sync.  Host work per chunk:
    tile streaming, the chunk's draws (`draws.city`, an `app.TiledDraws`)
    and the building-people reroute from one packed fetch
    (display_world.cpp:1295-1309's 3-thread city frame)."""

    tile_mgr: object
    road_graph: object = None
    ped_nav: object = None
    city: object = None          # city_step.CityState
    bldg: object = None          # city_step.MergedBuildingPeople
    pads: object = None          # [P, 3] heli pads (device)
    perches: object = None       # [P, 3] bird perches (device)
    rail: object = None          # traffic.RailLine (trains ride it)
    chunk: int = 16
    frame: int = 0
    last_probe: object = None    # latest people_probe fetch (host numpy)
    draws: object = None         # the city's draws per chunk (app.TiledDraws)
    # new tiles a chunk (tile_draw_t::update's GPU budget,
    # tiled_mesh.cpp:2314-2316): the batch is adopted on the next chunk;
    # None creates every missing tile at once
    tile_budget: int | None = None
    # city frames run, people probes fetched and the separation kernel's
    # launches in them (host counts, beside `TileManager.counts`; the
    # people rerouted are `bldg.counts`)
    counts: dict = field(default_factory=lambda: {"city_frames": 0, "probe_fetches": 0,
                                                  "separation": 0})

    def step_chunk(self, cam_x: float, cam_y: float, frames: int | None = None):
        """Advance K frames: tiles + one chained city call + the per-chunk
        host reroute phase.  Returns the tile keys (created, deleted)."""
        from ..city import city_step as CS

        k = self.chunk if frames is None else frames
        with span("frame"):
            created, deleted = self.tile_mgr.update(
                cam_x, cam_y, max_tiles_per_frame=self.tile_budget)
            if self.city is not None:
                d = self.draws.city(self.frame, k, self)
                sep0 = SEP.KERNEL.launches
                with span("city", device=self.city.peds.x.is_cuda):
                    self.city = CS.city_frames_chained(
                        self.city, self.road_graph, self.ped_nav, self.pads,
                        self.perches, k, d, rail=self.rail)
                self.counts["city_frames"] += k
                self.counts["separation"] += SEP.KERNEL.launches - sep0
                if self.bldg is not None and self.city.people is not None:
                    # single packed fetch; reroute decisions + display stats
                    # both come from it
                    probe = CS.people_probe(self.city.people)
                    with span("sync.people_probe"):
                        self.last_probe = probe.cpu().numpy()
                    self.counts["probe_fetches"] += 1
                    with span("city.reroute"):
                        self.city = self.city._replace(
                            people=self.bldg.reroute(self.city.people, probe=self.last_probe))
        self.frame += k
        return created, deleted

    def step(self, cam_x: float, cam_y: float):
        """One un-chained frame (compat/debug path)."""
        return self.step_chunk(cam_x, cam_y, frames=1)

    # convenience views
    @property
    def cars(self):
        return self.city.cars if self.city is not None else None

    @property
    def peds(self):
        return self.city.peds if self.city is not None else None

    @property
    def stoplights(self):
        return self.city.stoplights if self.city is not None else None


def make_tiled_world(tile_mgr, city_world=None, builders=(), seed: int = 0,
                     chunk: int = 16, num_birds: int = 0, num_trains: int = 0,
                     draws=None, device: torch.device | str = "cuda") -> TiledWorld:
    """Assemble a TiledWorld from a `city.assemble.CityWorld` plus
    furnished interiors (`builders` = [(interior, n_people, room_objs)]),
    its state on `device`.  `draws` gives the city's draws per chunk
    (default `app.TiledDraws(seed)`)."""
    from ..city import city_step as CS
    from ..city import traffic as CT

    if city_world is None:
        return TiledWorld(tile_mgr=tile_mgr, chunk=chunk)
    if draws is None:
        from ..app import TiledDraws
        draws = TiledDraws(seed)
    bldg = CS.MergedBuildingPeople(builders, seed=seed, device=device) if builders else None
    birds = None
    perches = None
    if num_birds > 0:
        perches_np = CT.bird_perches(None, city_world.buildings)
        perches = torch.as_tensor(perches_np, device=device)
        birds = CT.make_birds(num_birds, perches_np, seed=seed, device=device)
    rail = None
    trains = None
    if num_trains > 0 and city_world.net.blocks:
        # rail line along the city's -y edge (railroad segments along
        # the connector route, roads.cpp railroads)
        xs = [b[0] for b in city_world.net.blocks] + \
            [b[2] for b in city_world.net.blocks]
        ys = [b[1] for b in city_world.net.blocks]
        y = min(ys) - 1.0
        rail = CT.gen_railroad([(min(xs), y), (max(xs), y)], device=device)
        trains = CT.make_trains(num_trains, 1, seed=seed, device=device)
    cs = CS.CityState(
        stoplights=city_world.stoplights, cars=city_world.cars,
        peds=city_world.peds,
        people=bldg.people if bldg is not None else None,
        elev=bldg.elev if bldg is not None else CS.make_elevator_bank(1, device=device),
        helis=city_world.helis, birds=birds, trains=trains)
    return TiledWorld(tile_mgr=tile_mgr, road_graph=city_world.graph,
                      ped_nav=city_world.ped_nav, city=cs, bldg=bldg,
                      pads=city_world.helipads, perches=perches,
                      rail=rail, chunk=chunk, draws=draws)


# ---------------------------------------------------------------------------
# universe mode
# ---------------------------------------------------------------------------

@dataclass
class UniverseWorld:
    """WMODE_UNIVERSE session: cell paging + fleet combat + the
    player-controlled ship.  The fleet, the combat state and the player
    ship are tensors on one device; the cells are host objects."""

    state: object                 # universe.gen.UniverseState
    fleet: object = None          # universe.ships.FleetState
    fleet_tbl: object = None      # [C, 9] class table from parsed ship defs
    combat: object = None         # universe.combat.CombatState (full weapon model)
    combat_tables: object = None  # universe.combat.CombatTables
    player_ship: object = None    # universe.ships.PlayerShip
    black_holes: list = field(default_factory=list)  # [(pos, radius)]
    # ($BLACK_HOLE rows, ship_config.cpp; plus generated collapsed stars)
    frame: int = 0
    draws: object = None          # the combat frames' draws (app.UniverseDraws)
    HAZARD_PAD = 64               # the star arrays' fixed size

    def __post_init__(self):
        if self.draws is None:
            from ..app import UniverseDraws
            self.draws = UniverseDraws()

    def _hazards(self, device):
        """Star/black-hole bodies near the fleet: generated systems'
        stars + configured $BLACK_HOLE entries, padded to a fixed shape
        and uploaded once (pinned, without waiting for the card).  Returns
        None when there is none."""
        from ..terrain.tiles import upload
        pos, rad, bh = [], [], []
        for (p, r) in self.black_holes:
            pos.append(tuple(p))
            rad.append(float(r))
            bh.append(True)
        for cell in self.state.cells.values():
            for g in cell.galaxies:
                if not g.generated:
                    continue
                for sy in g.systems:
                    pos.append(tuple(cell.pos[d] + sy.pos[d] for d in range(3)))
                    rad.append(float(sy.star.radius))
                    bh.append(bool(sy.star.is_black_hole))
        if not pos:
            return None
        n = self.HAZARD_PAD
        pad = n - len(pos[:n])
        pos = pos[:n] + [(1e9, 1e9, 1e9)] * pad
        rad = rad[:n] + [0.0] * pad
        bh = bh[:n] + [False] * pad
        return (upload(np.asarray(pos, np.float32), device),
                upload(np.asarray(rad, np.float32), device),
                upload(np.asarray(bh, bool), device))

    def step_chunk(self, player_pos, frames: int = 1, controls=()):
        """draw_universe: player thrust commands + process_ships + lazy
        cell gen.  `controls` = [(tdir, speed, hyperspeed), ...] applied
        before the chunk (u_ship::thrust inputs).  The fleet advances
        `frames` steps in one chained call that never reads the card; cell
        paging runs at chunk granularity (cells span 10 units, so a
        sub-chunk camera move never crosses more cells than the endpoint
        check sees).  With a player ship, its position is read back once.
        Returns the cells (created, freed)."""
        from ..universe import ships as USH
        from ..universe import combat as UCB

        if self.player_ship is not None:
            for (tdir, speed, hyper) in controls:
                self.player_ship = USH.player_thrust(self.player_ship, tdir, speed, hyper)
            for _ in range(frames):
                self.player_ship = USH.player_ship_frame(self.player_ship)
            s = self.player_ship
            player_pos = tuple(torch.stack([s.px, s.py, s.pz]).tolist())
        created, freed = self.state.update(player_pos)
        if self.combat is not None:
            # full weapon model (universe.combat): projectiles, beams,
            # bays, point defense, boarding — one chained call
            ct = self.combat_tables
            dev = ct.cls_tbl.device
            n, slots = self.combat.cool.shape
            self.combat = UCB.combat_frames_chained(
                self.combat, self.draws.combat(self.frame, frames, n, slots, dev),
                frames, ct)
            hz = self._hazards(dev)
            if hz is not None:
                self.combat = self.combat._replace(fleet=USH.avoid_hazards(
                    self.combat.fleet, *hz, tbl=ct.cls_tbl))
            self.fleet = self.combat.fleet
        elif self.fleet is not None:
            if self.fleet_tbl is not None:
                self.fleet = USH.fleet_frames_chained(
                    self.fleet, frames, tbl=self.fleet_tbl,
                    abomin_id=USH.USC_ABOMIN_ID, reaper_id=USH.USC_REAPER_ID)
            else:
                self.fleet = USH.fleet_frames_chained(self.fleet, frames)
            # star-heat / black-hole avoidance once per chunk
            # (u_ship::ai_action hazard branch, u_ship.cpp:995-1012);
            # hazards only exist where systems have generated
            hz = self._hazards(self.fleet.px.device)
            if hz is not None:
                self.fleet = USH.avoid_hazards(self.fleet, *hz, tbl=self.fleet_tbl)
        self.frame += frames
        return created, freed

    def step(self, player_pos, controls=()):
        return self.step_chunk(player_pos, frames=1, controls=controls)

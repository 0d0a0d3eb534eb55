"""Procedural universe: cell -> galaxy -> system -> star/planet -> moon.

Re-expresses the reference hierarchy (universe.h:90-100,265-441;
Universe.cpp): a 7^3 block of cells pages with the player
(`shift_cells` Universe.cpp:1098); each cell generates lazily and
deterministically from position-derived seeds
(gen_rand_seed1/2, Universe.cpp:1141-1154: prime-multiplied quantized
center coordinates feeding the two-seed LCG), so revisiting a cell always
recreates the identical contents.

Generation is host-side (irregular tree structure) with all numeric
content drawn from the reference-compatible LCG; planet *surfaces* are
device-side (see surface.py).  Port of `3dworld_tpu/universe/gen.py`, host
code, copied whole.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..utils.rng import RandGen

# universe.h:90-100
U_BLOCKS = 7
CELL_SIZE = 10.0
RS_SCALE = 7.0 / CELL_SIZE
RAND_CONST = 1

MIN_GALAXIES_PER_CELL, MAX_GALAXIES_PER_CELL = 1, 4
MIN_SYSTEMS_PER_GALAXY, MAX_SYSTEMS_PER_GALAXY = 10, 100
MAX_PLANETS_PER_SYSTEM = 8
MAX_MOONS_PER_PLANET = 4


def gen_rand_seed1(pos) -> int:
    return (196613 * int(RS_SCALE * pos[0] + 0.5)
            + 393241 * int(RS_SCALE * pos[1] + 0.5)
            + 786433 * int(RS_SCALE * pos[2] + 0.5) + RAND_CONST * 123) & 0x7FFFFFFF


def gen_rand_seed2(pos) -> int:
    return (6291469 * int(RS_SCALE * pos[0] + 0.5)
            + 3145739 * int(RS_SCALE * pos[1] + 0.5)
            + 1572869 * int(RS_SCALE * pos[2] + 0.5) + RAND_CONST * 456) & 0x7FFFFFFF


@dataclass
class Moon:
    orbit_r: float
    radius: float
    seed: int


@dataclass
class Planet:
    orbit_r: float
    radius: float
    temp: float        # from star luminosity / orbit distance
    has_water: bool
    has_atmos: bool
    is_gas_giant: bool
    has_rings: bool
    seed: int
    moons: list = field(default_factory=list)


@dataclass
class Star:
    radius: float
    temp: float        # color temperature class
    color: tuple = (1.0, 1.0, 0.9)
    is_black_hole: bool = False   # ustar BLACK_HOLE type


@dataclass
class System:
    pos: tuple
    star: Star
    planets: list = field(default_factory=list)
    has_asteroid_belt: bool = False


@dataclass
class Galaxy:
    """Galaxy header generated with the cell; its SYSTEMS generate
    lazily on first access (the reference creates galaxies in gen_cell
    but clusters/systems only on approach, ugalaxy::process
    Universe.cpp:1285) — so paging a 7^3 window is cheap and content
    cost is paid only where the player actually goes.  Deterministic:
    the system stream is seeded by two draws taken from the cell stream
    at galaxy creation."""

    pos: tuple         # relative to cell center
    radius: float
    color: tuple
    nsys: int = 0
    sys_seed1: int = 1
    sys_seed2: int = 1
    _systems: list | None = field(default=None, repr=False)

    @property
    def systems(self) -> list:
        if self._systems is None:
            rg = RandGen(self.sys_seed1 or 1, self.sys_seed2 or 1)
            out = []
            for _ in range(self.nsys):
                sp = tuple(self.pos[d] + self.radius * (rg.randd() - 0.5)
                           * (rg.randd() - 0.5) * 4.0 for d in range(3))
                out.append(gen_system(rg, sp))
            self._systems = out
        return self._systems

    @property
    def generated(self) -> bool:
        return self._systems is not None


@dataclass
class Cell:
    coords: tuple      # integer cell coords
    pos: tuple         # world center
    galaxies: list = field(default_factory=list)


def gen_star(rg: RandGen) -> Star:
    t = rg.rand_uniform(0.2, 1.0)          # temperature class in [0.2, 1]
    radius = 0.02 * rg.rand_uniform(0.5, 2.0) * (0.5 + t)
    # blackbody-ish color ramp: red -> yellow -> white -> blue
    color = (min(1.0, 1.6 - 0.8 * t), min(1.0, 0.7 + 0.5 * t), min(1.0, 0.3 + 1.2 * t))
    # rare black holes (ustar BLACK_HOLE type): derived from the existing
    # temperature draw so the deterministic generation stream is
    # unchanged (~1% of stars, the hottest tail collapses)
    bh = t > 0.993
    return Star(radius=0.25 * radius if bh else radius, temp=t,
                color=(0.0, 0.0, 0.0) if bh else color, is_black_hole=bh)


def gen_planet(rg: RandGen, star: Star, orbit_r: float) -> Planet:
    radius = 0.004 * rg.rand_uniform(0.5, 3.0)
    # temperature falls off with orbit distance (uplanet temp model)
    temp = 80.0 * star.temp * star.radius / max(orbit_r, 1e-6) * rg.rand_uniform(0.7, 1.3)
    gas = radius > 0.008 and rg.rand_bool()
    p = Planet(
        orbit_r=orbit_r, radius=radius * (3.0 if gas else 1.0), temp=temp,
        has_water=(not gas and 4.0 < temp < 40.0 and rg.randd() < 0.7),
        has_atmos=(not gas and temp < 80.0 and rg.randd() < 0.8),
        is_gas_giant=gas,
        has_rings=(gas and rg.randd() < 0.5),   # uplanet::gen_prings
        seed=rg.rand(),
    )
    if not gas:
        for m in range(rg.rand_int(0, MAX_MOONS_PER_PLANET)):
            p.moons.append(Moon(orbit_r=p.radius * rg.rand_uniform(3.0, 10.0),
                                radius=p.radius * rg.rand_uniform(0.1, 0.4),
                                seed=rg.rand()))
    return p


def gen_system(rg: RandGen, pos) -> System:
    star = gen_star(rg)
    sy = System(pos=tuple(pos), star=star,
                has_asteroid_belt=(rg.randd() < 0.3))
    nplanets = rg.rand_int(0, MAX_PLANETS_PER_SYSTEM)
    orbit = star.radius * 4.0
    for _ in range(nplanets):
        orbit *= rg.rand_uniform(1.4, 2.0)
        sy.planets.append(gen_planet(rg, star, orbit))
    return sy


def gen_galaxy(rg: RandGen, cell_radius: float) -> Galaxy:
    pos = tuple(rg.rand_uniform(-0.7, 0.7) * cell_radius for _ in range(3))
    radius = cell_radius * rg.rand_uniform(0.1, 0.3)
    color = (rg.rand_uniform(0.5, 1.0), rg.rand_uniform(0.5, 1.0),
             rg.rand_uniform(0.5, 1.0))
    nsys = rg.rand_int(MIN_SYSTEMS_PER_GALAXY, MAX_SYSTEMS_PER_GALAXY)
    return Galaxy(pos=pos, radius=radius, color=color, nsys=nsys,
                  sys_seed1=rg.rand(), sys_seed2=rg.rand())


def gen_cell(coords: tuple, origin=(0.0, 0.0, 0.0)) -> Cell:
    """ucell::gen_cell (Universe.cpp:1157-1175): deterministic from the
    cell's world position."""
    pos = tuple(CELL_SIZE * coords[d] + origin[d] for d in range(3))
    rg = RandGen(gen_rand_seed1(pos) or 1, gen_rand_seed2(pos) or 1)
    cell = Cell(coords=tuple(coords), pos=pos)
    ngal = rg.rand_int(MIN_GALAXIES_PER_CELL, MAX_GALAXIES_PER_CELL)
    for _ in range(ngal):
        cell.galaxies.append(gen_galaxy(rg, 0.5 * CELL_SIZE))
    return cell


class UniverseState:
    """Paged 7^3 cell window around the player (shift_cells)."""

    def __init__(self):
        self.cells: dict[tuple, Cell] = {}

    def update(self, player_pos) -> tuple[list, list]:
        """Generate cells within the 7^3 window; free the rest."""
        c = tuple(int(np.floor(p / CELL_SIZE + 0.5)) for p in player_pos)
        r = U_BLOCKS // 2
        want = set()
        for dx in range(-r, r + 1):
            for dy in range(-r, r + 1):
                for dz in range(-r, r + 1):
                    want.add((c[0] + dx, c[1] + dy, c[2] + dz))
        freed = [k for k in self.cells if k not in want]
        for k in freed:
            del self.cells[k]
        created = []
        for k in want:
            if k not in self.cells:
                self.cells[k] = gen_cell(k)
                created.append(k)
        self.ensure_near(player_pos)
        return created, freed

    def ensure_near(self, player_pos, radius: float = 0.5 * CELL_SIZE) -> int:
        """Force lazy system generation for galaxies the player
        approaches (ugalaxy::process on approach, Universe.cpp:1285);
        distant galaxies stay headers."""
        n = 0
        for cell in self.cells.values():
            for g in cell.galaxies:
                if g.generated:
                    continue
                d2 = sum((cell.pos[d] + g.pos[d] - player_pos[d]) ** 2
                         for d in range(3))
                if d2 < (radius + g.radius) ** 2:
                    g.systems  # noqa: B018 — forces generation
                    n += 1
        return n

    def num_systems(self) -> int:
        """Total systems in the window (header counts — does not force
        lazy generation)."""
        return sum(g.nsys for cell in self.cells.values()
                   for g in cell.galaxies)

    def num_generated(self) -> int:
        return sum(1 for cell in self.cells.values()
                   for g in cell.galaxies if g.generated)


def get_gravity(cell: Cell, pos, g_const: float = 1e-4):
    """Net gravitational acceleration at `pos` from the cell's stars and
    planets (get_gravity, Universe_control.cpp:59): sum of M/r^2 toward
    each body; star mass ~ radius^3."""
    ax = ay = az = 0.0
    for g in cell.galaxies:
        for s in g.systems:
            bodies = [(s.pos, s.star.radius ** 3 * 1e3)]
            for p in s.planets:
                bodies.append(((s.pos[0] + p.orbit_r, s.pos[1], s.pos[2]),
                               p.radius ** 3))
            for (bp, m) in bodies:
                dx = bp[0] - pos[0]
                dy = bp[1] - pos[1]
                dz = bp[2] - pos[2]
                r2 = dx * dx + dy * dy + dz * dz + 1e-12
                f = g_const * m / (r2 * np.sqrt(r2))
                ax += f * dx
                ay += f * dy
                az += f * dz
    return ax, ay, az


def gen_prings(planet: Planet):
    """Planet ring bands (uplanet::gen_prings, Universe.cpp:1743-1775):
    1-10 contiguous annular bands with jittered gaps, colors drifting a
    tinted copy of the planet color, ramped alpha.  Deterministic from
    planet.seed.  Returns (ring_ri, ring_ro, bands) where bands =
    [(r1, r2, (r, g, b, a)), ...]."""
    if not planet.has_rings:
        return 0.0, 0.0, []
    rg = RandGen(planet.seed + 77, 3 * planet.seed + 5)
    nr = rg.rand() % 10 + 1
    sr = 4.0 / nr
    radius = planet.radius
    lastr = rg.rand_uniform(1.1 * radius, 1.2 * radius)
    spans = []
    for _ in range(nr):
        r1 = lastr + sr * radius * rg.rand_uniform(-0.05, 0.05)
        r2 = r1 + sr * radius * rg.rand_uniform(0.05, 0.3)
        spans.append((r1, r2))
        lastr = r2
    base = [min(1.0, 0.6 + rg.rand_uniform(0.1, 0.6)) for _ in range(3)]
    alpha = rg.rand_uniform(0.75, 1.0)
    bands = []
    for (r1, r2) in spans:
        c = [min(1.0, max(0.0, base[i] * (1.0 + rg.rand_uniform(-0.15, 0.15))))
             for i in range(3)]
        bands.append((r1, r2, (c[0], c[1], c[2], alpha)))
    return spans[0][0], spans[-1][1], bands


# ---------------------------------------------------------------------------
# orbital motion (urev_body::do_update, Universe.cpp:1891-1912)
# ---------------------------------------------------------------------------

REV_RATE_CONST = 1.0      # REV_RATE_CONST/(0.14*TPS*aoR^1.5), Universe.cpp:1880
TICKS_PER_SECOND = 40.0


def rev_rate(orbit_r: float, parent_r: float) -> float:
    """Kepler-style revolution rate (degrees/tick) ~ (a/R)^-1.5."""
    aoR = max(orbit_r / max(parent_r, 1e-9), 1e-6)
    return REV_RATE_CONST / (0.14 * TICKS_PER_SECOND * aoR * np.sqrt(aoR))


def _phase0(seed: int) -> float:
    return (seed % 360000) / 1000.0          # rev_ang0 = 360*rand2d()


def planet_position(sy: System, p: Planet, time_ticks: float):
    """World position of a planet at time t: circular orbit about the
    star (do_update's absolute-angle evaluation — stable over long
    runs)."""
    ang = np.radians(_phase0(p.seed) + rev_rate(p.orbit_r, sy.star.radius)
                     * time_ticks)
    return (sy.pos[0] + p.orbit_r * np.cos(ang),
            sy.pos[1] + p.orbit_r * np.sin(ang), sy.pos[2])


def moon_position(sy: System, p: Planet, m: Moon, time_ticks: float):
    px, py, pz = planet_position(sy, p, time_ticks)
    ang = np.radians(_phase0(m.seed) + rev_rate(m.orbit_r, p.radius)
                     * time_ticks)
    return (px + m.orbit_r * np.cos(ang), py + m.orbit_r * np.sin(ang), pz)


def system_body_positions(sy: System, time_ticks: float):
    """[(kind, position, radius)] for every revolving body in a system
    at time t — planets and their moons (uplanet::do_update chain,
    Universe.cpp:1711-1720)."""
    out = []
    for p in sy.planets:
        pp = planet_position(sy, p, time_ticks)
        out.append(("planet", pp, p.radius))
        for m in p.moons:
            out.append(("moon", moon_position(sy, p, m, time_ticks),
                        m.radius))
    return out


# ---------------------------------------------------------------------------
# body names (Universe_name.cpp named_obj::gen_name; names derive from
# each body's own seed so lazy cell paging names bodies deterministically
# without touching the generation RNG stream)
# ---------------------------------------------------------------------------

def planet_name(p: Planet) -> str:
    from ..utils.names import gen_random_name
    return gen_random_name(RandGen(p.seed + 77, p.seed + 911), 0, True)


def moon_name(m: Moon) -> str:
    from ..utils.names import gen_random_name
    return gen_random_name(RandGen(m.seed + 77, m.seed + 911), 0, True)


def system_name(sy: System) -> str:
    """The system and its star share a name, like the reference's
    ustar/usystem naming."""
    from ..utils.names import gen_random_name
    s1 = gen_rand_seed1(sy.pos)
    s2 = gen_rand_seed2(sy.pos)
    return gen_random_name(RandGen(s1 + 77, s2 + 911), 0, True)


def galaxy_name(g: Galaxy) -> str:
    from ..utils.names import gen_random_name
    return gen_random_name(RandGen(g.sys_seed1 + 77, g.sys_seed2 + 911),
                           0, True)

"""Plain reference of the live tiled-terrain frame (`inf_terrain_128`): the
streaming manager's bookkeeping, each new tile's context, erosion,
ambient obscurance, sun shadows, surface normal and biome weights, and
the height read under the camera.

Plain float32 PyTorch, written from the engine's description
(`tile_draw_t::update`, tiled_mesh.cpp:2311-2417, and its budget of new
tiles a frame, :2314-2316; `tile_t::calc_mesh_ao_lighting`, :586-661; the
sun's mesh shadows, :664-692 and visibility.cpp:400-505; the texture bands
of mesh_gen.cpp:42-44 and :407-431 and the slope bands `sthresh`),
independent of the port: it imports nothing of it.  The sine table,
glaciation, droplet starts and the fixed-point droplet walk are
`reference/terrain.py`'s.

Departures from the engine's description, each the deployment's own:

- Context: each tile's heights are evaluated over the tile and a halo of
  `ao_halo` cells on each side, then glaciated, so that the rays of AO and
  the centred differences at the tile's border read true neighbours.
- Erosion: `erosion_iters_tt` droplets walk in lockstep batches of
  `erosion_batch` for at most `erosion_steps` steps each (the engine walks
  one droplet at a time to its end) over the tile with a roam ring of
  `erosion_pad` edge cells, and the result is clamped below at the
  tile's own lowest height before erosion.  The halo is not eroded.
- AO: first-hit obscurance only, over 8 compass directions and 8 steps of
  triangular stride (1, 3, 6, ... 36 cells); a ray rises half a cell's
  mean width per step; no falloff within a step.
- Shadows: each tile is scanned on its own, with no edge heights coming in
  from the tile upstream of the light (the engine chains `sh_in` and
  `sh_out` between tiles).  The scan runs along the light's dominant
  axis, keeping the running maximum of the shadow potential
  z + m * (cells travelled); between columns that maximum shears
  sideways by the light's lateral drift, interpolated linearly between
  the two nearest cells, and what leaves one side of the tile comes back
  in on the other (a wrap-around roll), where the engine's Bresenham
  lines leave the tile.
- Biome weights: five piecewise-linear bands of relative height (sand,
  dirt, grass, rock, snow; a blend of 0.04 about each threshold), grass
  and snow faded by slope into rock; no biome noise.
- Bookkeeping: distances in tile units from the camera's tile; missing
  tiles within `create_radius_tiles` are made nearest first, ties in
  row-major order (rows from the lowest y, then x), at most `tile_budget`
  a frame; a frame's batch becomes resident at the start of the next
  frame's update, before that update deletes the tiles beyond
  `delete_radius_tiles`.
- Height read: bilinear within the cell, contracting y first, clamped
  into the tile (its last row and column read flat), as the ground
  mode's mesh sample reads its mesh.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.reference import terrain as R

AO_DIRS = [(x, y) for y in (-1, 0, 1) for x in (-1, 0, 1) if (x, y) != (0, 0)]
MESH_MIN_Z = -1.0e30        # the empty running maximum
SHADOW_EPS = 1e-6
STHRESH_GRASS = (0.68, 0.86)   # mesh_gen.cpp:44, surface-normal z
STHRESH_SNOW = (0.48, 0.72)
BLEND = 0.04
GRASS, ROCK, SNOW = 2, 3, 4


# ---------------------------------------------------------------------------
# the manager's bookkeeping
# ---------------------------------------------------------------------------

def camera_tile(cfg: dict, x: float, y: float) -> tuple:
    tw = cfg["tile_size"] * (2.0 * cfg["x_scene"] / cfg["mesh_x"])
    th = cfg["tile_size"] * (2.0 * cfg["y_scene"] / cfg["mesh_y"])
    return math.floor(x / tw), math.floor(y / th)


def bookkeeping(cfg: dict, cams) -> list:
    """For each camera position (x, y), one per frame from the first: the
    resident keys after the frame's update and the keys of the batch it
    makes."""
    rc, rd = cfg["create_radius_tiles"], cfg["delete_radius_tiles"]
    reach = math.ceil(rc)
    near = [(dx, dy) for dy in range(-reach, reach + 1) for dx in range(-reach, reach + 1)
            if dx * dx + dy * dy <= rc * rc]
    resident: set = set()
    batch: list = []
    out = []
    for x, y in cams:
        resident.update(batch)
        cx, cy = camera_tile(cfg, x, y)
        resident = {k for k in resident if (k[0] - cx) ** 2 + (k[1] - cy) ** 2 <= rd * rd}
        missing = [(cx + dx, cy + dy) for dx, dy in near if (cx + dx, cy + dy) not in resident]
        missing.sort(key=lambda k: (k[0] - cx) ** 2 + (k[1] - cy) ** 2)
        batch = missing[:cfg["tile_budget"]]
        out.append((frozenset(resident), batch))
    return out


# ---------------------------------------------------------------------------
# a tile's phases
# ---------------------------------------------------------------------------

def obscurance(ctx: torch.Tensor, n: int, halo: int, rise: float,
               steps: int) -> torch.Tensor:
    """AO [T, n, n] of the tiles inside contexts [T, n + 2 halo, ...]: in
    each direction the nearest step whose cell stands above the ray
    obscures by (steps - step); 1 less the total over its most."""
    z0 = ctx[:, halo:halo + n, halo:halo + n]
    atten = torch.zeros_like(z0)
    for dx, dy in AO_DIRS:
        first = torch.full(z0.shape, steps, dtype=torch.int64, device=ctx.device)
        for s in reversed(range(steps)):
            off = (s + 1) * (s + 2) // 2
            y0, x0 = halo + dy * off, halo + dx * off
            hit = ctx[:, y0:y0 + n, x0:x0 + n] > z0 + rise * (s + 1)
            first = torch.where(hit, s, first)
        atten = atten + torch.where(first < steps, steps - first, 0).to(z0.dtype)
    return 1.0 - atten / (len(AO_DIRS) * steps)


def sun_shadows(z: torch.Tensor, sun: tuple, cell_w: float) -> torch.Tensor:
    """Cells [T, n, n] that a tile's own heights shade from a sun in
    direction `sun` (toward the light)."""
    lx, ly, lz = sun
    hmag = float(np.hypot(lx, ly))
    if hmag < 1e-9:
        return torch.zeros(z.shape, dtype=torch.bool, device=z.device)
    m = lz / hmag * cell_w                      # the ray's descent per cell travelled
    x_major = abs(lx) >= abs(ly)
    major, lat = (lx, ly) if x_major else (ly, lx)
    a = z if x_major else z.transpose(-1, -2)   # the scan axis last
    if major > 0:                               # the light's side first
        a = torch.flip(a, (-1,))
    drift = -lat / abs(major)                   # sideways cells per column
    s = math.floor(drift)
    f = drift - s
    n = a.shape[-1]
    p = a + m * torch.arange(n, dtype=a.dtype, device=a.device)
    run = torch.full(a.shape[:-1], MESH_MIN_Z, dtype=a.dtype, device=a.device)
    cols = []
    for i in range(n):
        cols.append(run > p[..., i] + SHADOW_EPS)
        run = torch.maximum(run, p[..., i])
        if drift != 0.0:
            run = torch.roll(run, s, -1) * (1.0 - f) + torch.roll(run, s + 1, -1) * f
    mask = torch.stack(cols, -1)
    if major > 0:
        mask = torch.flip(mask, (-1,))
    return mask if x_major else mask.transpose(-1, -2)


def normal_z(ctx: torch.Tensor, n: int, halo: int, dx_inv: float,
             dy_inv: float) -> torch.Tensor:
    """The z of the unit surface normal from centred differences."""
    s = slice(halo, halo + n)
    gx = (ctx[:, s, halo + 1:halo + n + 1] - ctx[:, s, halo - 1:halo + n - 1]) * (0.5 * dx_inv)
    gy = (ctx[:, halo + 1:halo + n + 1, s] - ctx[:, halo - 1:halo + n - 1, s]) * (0.5 * dy_inv)
    return torch.rsqrt(gx ** 2 + gy ** 2 + 1.0)


def dirt_bands(cfg: dict) -> list:
    """The five relative-height thresholds, moved with the water level
    (mesh_gen.cpp:407-431); snow capped at its default height."""
    rel_wpz = float(np.clip(R.W_PLANE_Z + cfg["water_h_off_rel"], 0.0, 1.0))
    out = []
    for i, h in enumerate(R.MESH_RH_DIRT):
        if h < R.W_PLANE_Z:
            v = h * rel_wpz / R.W_PLANE_Z
        else:
            v = rel_wpz + (h - R.W_PLANE_Z) / (1.0 - R.W_PLANE_Z) * (1.0 - rel_wpz)
            if i == 4:
                v = min(v, h)
        out.append(v)
    return out


def _over(a: torch.Tensor, d: float) -> torch.Tensor:
    """a / d with d rounded to float32 first, as a quotient of two float32
    values rounds on every device."""
    return a / torch.full((), d, dtype=a.dtype, device=a.device)


def biome_weights(z: torch.Tensor, nz: torch.Tensor, zmax: torch.Tensor,
                  cfg: dict) -> torch.Tensor:
    """Weights [T, 5, n, n] of sand, dirt, grass, rock and snow."""
    zmin = -zmax
    relh = (z - zmin) / torch.clamp(zmax - zmin, min=1e-9)
    bands = dirt_bands(cfg)
    ws = []
    lo = -1.0
    for i, hi in enumerate(bands):
        w = torch.ones_like(relh)
        if i > 0:      # rises across the band's lower threshold
            w = w * torch.clamp(_over(relh - (lo - BLEND), 2 * BLEND), 0.0, 1.0)
        if i < 4:      # falls across its upper one
            w = w * torch.clamp(_over((hi + BLEND) - relh, 2 * BLEND), 0.0, 1.0)
        ws.append(w)
        lo = hi
    for k, (a, b) in ((GRASS, STHRESH_GRASS), (SNOW, STHRESH_SNOW)):
        ws[k] = ws[k] * torch.clamp(_over(nz - a, b - a), 0.0, 1.0)
    total = ws[0] + ws[1] + ws[2] + ws[3] + ws[4]
    ws[ROCK] = ws[ROCK] + torch.clamp(1.0 - total, min=0.0)
    total = ws[0] + ws[1] + ws[2] + ws[3] + ws[4]
    return torch.stack(ws, 1) / torch.clamp(total[:, None], min=1e-9)


def height(zv: torch.Tensor, key: tuple, x: float, y: float, cfg: dict) -> torch.Tensor:
    """The bilinear height at world (x, y) of tile `key`'s heights `zv`."""
    n = cfg["tile_size"]
    gx = x * (1.0 / (2.0 * cfg["x_scene"] / cfg["mesh_x"])) - key[0] * n
    gy = y * (1.0 / (2.0 * cfg["y_scene"] / cfg["mesh_y"])) - key[1] * n
    x0 = min(max(math.floor(gx), 0), n - 2)
    y0 = min(max(math.floor(gy), 0), n - 2)
    fx = np.float32(min(max(gx - x0, 0.0), 1.0))
    fy = np.float32(min(max(gy - y0, 0.0), 1.0))
    one = np.float32(1.0)
    left = zv[y0, x0] * float(one - fy) + zv[y0 + 1, x0] * float(fy)
    right = zv[y0, x0 + 1] * float(one - fy) + zv[y0 + 1, x0 + 1] * float(fy)
    return left * float(one - fx) + right * float(fx)


class Tiles:
    """The reference's tiles of one configuration, eroded with `angles`
    [batches, steps, batch]."""

    def __init__(self, cfg: dict, device, angles: torch.Tensor):
        self.cfg, self.device = cfg, device
        self.angles = angles.to(device)
        self.base = R.Tiles(cfg, device)

    def context(self, keys, tf32: bool = False) -> torch.Tensor:
        cfg = self.cfg
        n, halo = cfg["tile_size"], cfg["ao_halo"]
        t = lambda i: torch.tensor([float(k[i]) for k in keys], dtype=torch.float32,
                                   device=self.device)
        z = R.raw_heights(self.base.table, t(0) * n - halo, t(1) * n - halo,
                          {**cfg, "tile_size": n + 2 * halo}, tf32)
        if cfg["glaciate"]:
            z = R.glaciate(z, self._zmax(), cfg["glaciate_exp"])
        return z

    def _zmax(self) -> torch.Tensor:
        return torch.full((), self.cfg["zmax_est"], dtype=torch.float32, device=self.device)

    def erode(self, z: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        T, n, _ = z.shape
        pad = cfg["erosion_pad"]
        hm = torch.nn.functional.pad(z[:, None], (pad,) * 4, mode="replicate")[:, 0]
        hm = hm.contiguous()
        iters, batch = cfg["erosion_iters_tt"], cfg["erosion_batch"]
        xi, zi = R.droplet_starts(iters, n, n, pad, self.device)
        nb = -(-iters // batch)
        fill = nb * batch - iters
        if fill:       # the last batch's spare droplets start dead
            dead = torch.full((fill,), -10, dtype=torch.int32, device=self.device)
            xi, zi = torch.cat([xi, dead]), torch.cat([zi, dead])
        p6 = self.base.params(cfg["zmax_est"], cfg["water_plane_z"])
        for b in range(nb):
            xb = xi[b * batch:(b + 1) * batch].expand(T, batch).contiguous()
            zb = zi[b * batch:(b + 1) * batch].expand(T, batch).contiguous()
            hm = hm + R.walk(hm, xb, zb, self.angles[b].contiguous(), p6)
        lo = torch.amin(z, dim=(-1, -2), keepdim=True)
        return torch.clamp(hm[:, pad:pad + n, pad:pad + n], min=lo)

    def __call__(self, keys, tf32: bool = False) -> dict:
        """Tiles `keys`: heights before erosion ("pre") and after
        ("zvals"), "ao", "shadow" and "weights", each [T, ...]."""
        cfg = self.cfg
        n, halo = cfg["tile_size"], cfg["ao_halo"]
        ctx = self.context(keys, tf32)
        inner = (slice(None), slice(halo, halo + n), slice(halo, halo + n))
        pre = ctx[inner]
        zv = self.erode(pre) if cfg["erosion_iters_tt"] > 0 else pre
        ctx = ctx.clone()
        ctx[inner] = zv
        dx = 2.0 * cfg["x_scene"] / cfg["mesh_x"]
        dy = 2.0 * cfg["y_scene"] / cfg["mesh_y"]
        ao = obscurance(ctx, n, halo, 0.5 * (0.5 * (dx + dy)), cfg["ao_steps"])
        shadow = sun_shadows(zv, tuple(cfg["sun_dir"]), dx)
        nz = normal_z(ctx, n, halo, 1.0 / dx, 1.0 / dy)
        weights = biome_weights(zv, nz, self._zmax(), cfg)
        return {"pre": pre, "zvals": zv, "ao": ao, "shadow": shadow, "weights": weights}


def tile_readings(cand: dict, ref: dict) -> dict:
    """Tiles `cand` held against the reference's `ref` (dicts of [T, ...]
    as `Tiles` returns them): the terrain cell's height readings
    (`terrain.readings`), the share of cells whose AO or shadow differs
    at the worst tile, and the largest error of a biome weight."""
    out = R.readings(cand["zvals"], ref["zvals"], ref["pre"])
    T = ref["zvals"].shape[0]
    off = lambda a, b: float((a != b).reshape(T, -1).double().mean(1).max())
    out["ao_cells_off"] = off(cand["ao"], ref["ao"])
    out["shadow_cells_off"] = off(cand["shadow"], ref["shadow"])
    w = torch.nan_to_num(cand["weights"].double(), nan=float("inf"))
    out["weights_err_max"] = float((w - ref["weights"].double()).abs().max())
    return out

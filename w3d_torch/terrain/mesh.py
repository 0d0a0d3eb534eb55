"""Terrain generation (port of `3dworld_tpu/terrain/mesh.py`).

Configuration (`HmapParams`, `TerrainConfig`), the rock threshold
(`clip_hd1`), the plateau/crater/crack post-process (`postproc_noise_zval`),
the glaciation power curve (`apply_glaciate`), the sine-table builder
(`gen_table_for`), and ground-mode `gen_terrain` in every generator mode:
raw heights, the far-grid height-range estimate, glaciation, the overlay
sine, and droplet erosion through `ops/erosion.erode` (kernel A on the
card); and the image-driven mesh (`terrain_from_heightmap`), which erodes
the same way.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..utils.constants import WorldConst, DEFAULT_WORLD
from ..ops import noise as N
from ..ops import erosion as E

# mesh_gen.cpp:20-28
W_PLANE_Z = 0.42
EST_RAND_PARAM = 128
DEF_GLACIATE_EXP = 3.0
NTEX_DIRT = 5
MESH_RH_DIRT = (0.40, 0.44, 0.60, 0.75, 1.0)  # sand,dirt,ground,rock,snow (mesh_gen.cpp:42-44)


class HmapParams(NamedTuple):
    """Post-processing params (hmap_params_t): plateau/crater/crack + overlay
    sine/volcano.  Defaults are no-ops (mesh_gen.cpp:555-562,364-379)."""

    plat_bot: float = 1.0e9
    plat_h: float = 0.0
    plat_s: float = 0.0
    plat_max: float = 0.0
    crat_h: float = 1.0e9
    crat_s: float = 0.0
    crack_lo: float = 0.0
    crack_hi: float = 0.0
    crack_d: float = 0.0
    sine_mag: float = 0.0
    sine_freq: float = 0.0
    sine_bias: float = 0.0
    volcano_width: float = 0.0
    volcano_height: float = 0.0


class TerrainConfig(NamedTuple):
    """Static terrain-generation configuration (hashable)."""

    mode: int = N.MGEN_SINE
    shape: int = N.SHAPE_LINEAR
    mesh_seed: int = 0
    mesh_scale: float = 1.0
    mesh_scale_z: float = 1.0
    mesh_height_scale: float = 1.0
    glaciate: bool = True
    glaciate_exp: float = DEF_GLACIATE_EXP
    erosion_iters: int = 0
    erode_amount: float = 1.0
    water_h_off: float = 0.0
    water_h_off_rel: float = 0.0
    relh_adj_tex: float = 0.0
    mesh_freq_filter: int = N.FREQ_FILTER
    hmap: HmapParams = HmapParams()
    xoff2: int = 0
    yoff2: int = 0


class TerrainState(NamedTuple):
    """Generated terrain + derived scalars (the reference's globals
    zmin/zmax/zmax_est/water_plane_z/... as explicit state)."""

    mesh_height: torch.Tensor  # [my, mx]
    zmin: torch.Tensor
    zmax: torch.Tensor
    zmax_est: torch.Tensor
    zbottom: torch.Tensor
    ztop: torch.Tensor
    water_plane_z: torch.Tensor
    height_histogram: torch.Tensor  # [1024] sorted sample of raw heights


def glaciate_exp_val(cfg: TerrainConfig) -> float:
    return cfg.glaciate_exp if cfg.glaciate else 1.0


def get_rel_wpz(cfg: TerrainConfig) -> float:
    """mesh_gen.cpp:344: relative water-plane height in [0,1]."""
    return float(np.clip(W_PLANE_Z + cfg.water_h_off_rel, 0.0, 1.0))


def lttex_dirt_zvals(cfg: TerrainConfig, temperature: float = 20.0):
    """init_terrain_mesh (mesh_gen.cpp:407-431): water-level-adjusted
    relative height thresholds for sand/dirt/ground/rock/snow."""
    rel_wpz = get_rel_wpz(cfg)
    zvals = []
    for i, def_h in enumerate(MESH_RH_DIRT):
        if def_h < W_PLANE_Z:
            h = def_h * rel_wpz / W_PLANE_Z
        else:
            rel_h = (def_h - W_PLANE_Z) / (1.0 - W_PLANE_Z)
            h = rel_wpz + rel_h * (1.0 - rel_wpz)
            if i == NTEX_DIRT - 1:  # snow
                h = min(h, def_h)
                if temperature > 40.0:
                    h += 0.01 * (temperature - 40.0)
        zvals.append(h)
    return zvals


def clip_hd1(cfg: TerrainConfig) -> float:
    """Rock-vs-dirt relative-height threshold (Textures.cpp:1757-1761)."""
    zv = lttex_dirt_zvals(cfg)
    gexp = glaciate_exp_val(cfg)
    h_dirt = [z ** gexp for z in zv]
    return 0.90 * h_dirt[1] + 0.10 * h_dirt[0]


def postproc_noise_zval(z: torch.Tensor, h: HmapParams) -> torch.Tensor:
    """Plateau / crater / crack shaping (mesh_gen.cpp:555-562)."""
    if h.plat_s != 0.0 or h.plat_h != 0.0:
        above = z > h.plat_bot
        plat = (h.plat_bot + h.plat_h * (z - h.plat_bot)
                + torch.clamp(h.plat_s * (z - h.plat_bot), max=h.plat_max))
        z = torch.where(above, plat, z)
    if h.crat_s != 0.0:
        z = torch.where(z > h.crat_h, h.crat_h - h.crat_s * (z - h.crat_h), z)
    if h.crack_d != 0.0:
        in_crack = (z > h.crack_lo) & (z < h.crack_hi)
        z = torch.where(in_crack, z - h.crack_d * torch.minimum(
            z - h.crack_lo, h.crack_hi - z), z)
    return z


def apply_glaciate(z: torch.Tensor, zmax_est: torch.Tensor,
                   cfg: TerrainConfig) -> torch.Tensor:
    """mesh_gen.cpp:358,380-385: relative-height power curve."""
    if not cfg.glaciate:
        return z
    zmax_est2 = 2.0 * zmax_est
    relh = (z + zmax_est) / zmax_est2
    relh = torch.clamp(relh, min=0.0)
    if cfg.glaciate_exp == 3.0:
        g = relh * relh * relh
    else:
        g = torch.pow(relh, cfg.glaciate_exp)
    return g * zmax_est2 - zmax_est


def gen_table_for(cfg: TerrainConfig, world: WorldConst,
                  device: torch.device | str = "cuda") -> N.SineTable:
    """The sine table of a terrain configuration (host-side, 450 draws)."""
    scaled_height = world.mesh_height * cfg.mesh_height_scale
    return N.gen_sine_table(world, cfg.mesh_seed, scaled_height, device=device)


def raw_height_grid(cfg: TerrainConfig, world: WorldConst,
                    table: N.SineTable | None, x0: float, y0: float,
                    dx_mult: float, dy_mult: float, nx: int, ny: int,
                    device: torch.device | str = "cuda") -> torch.Tensor:
    """mesh_xy_grid_cache_t::build_arrays + eval over a full grid.

    x0/y0 are in grid-index units, dx_mult/dy_mult multiply the world cell
    size (1.0 = DX_VAL spacing).  Returns [ny, nx] raw (pre-glaciate)
    heights on `device` (the table's, in sine mode)."""
    mszi = 1.0 / cfg.mesh_scale_z
    if cfg.mode == N.MGEN_SINE:
        start = N.start_eval_sin(cfg.mesh_scale, cfg.mesh_freq_filter)
        xt, yt = N.sine_term_tables(
            table, x0, y0, world.dx * dx_mult, world.dy * dy_mult, nx, ny,
            world=world, mesh_scale=cfg.mesh_scale, mesh_scale_z_inv=mszi,
            start_sin=start, exact=True,
        )
        z = N.eval_sine_grid(xt, yt, exact=True)
        z = N.apply_noise_shape_final(z, cfg.shape)
        return postproc_noise_zval(z, cfg.hmap)
    # fBm modes: eval_index computes xval = (x*mdx + mx0)*DX_VAL_INV
    xi = (torch.arange(nx, dtype=torch.float32, device=device) + x0) * dx_mult
    yi = (torch.arange(ny, dtype=torch.float32, device=device) + y0) * dy_mult
    xv, yv = torch.meshgrid(xi, yi, indexing="xy")
    return N.noise_zval_grid(
        xv, yv, cfg.mode, shape=cfg.shape, mesh_scale=cfg.mesh_scale,
        mesh_seed=cfg.mesh_seed, world=world,
        postproc=lambda z: postproc_noise_zval(z, cfg.hmap),
    )


def estimate_zminmax(cfg: TerrainConfig, world: WorldConst,
                     table: N.SineTable | None, zmin: torch.Tensor,
                     zmax: torch.Tensor):
    """estimate_zminmax (mesh_gen.cpp:447-485): sample the generator on a
    sparse far-flung grid to estimate the global height range.  Returns
    (zmax_est, sorted 1/16 sample of the far grid)."""
    zmax_est = torch.maximum(zmax, -zmin)
    rm_scale = 1000.0 * world.xy_scene / cfg.mesh_scale
    grid = raw_height_grid(
        cfg, world, table, 0.0, 0.0,
        rm_scale / world.dx, rm_scale / world.dy, EST_RAND_PARAM, EST_RAND_PARAM,
        device=zmax.device,
    )
    zmax_est = torch.maximum(zmax_est, torch.max(torch.abs(grid)))
    if cfg.mode != N.MGEN_SINE:
        zmax_est = zmax_est * 1.2
    zmax_est = 1.1 * zmax_est
    hist = torch.sort(grid[::4, ::4].reshape(-1)).values  # 1/16 sample (mesh_gen.cpp:478)
    return zmax_est, hist


def apply_mesh_sine(z: torch.Tensor, xg, yg, cfg: TerrainConfig) -> torch.Tensor:
    """Optional overlay sine + volcano (mesh_gen.cpp:364-379); xg/yg are
    grid coords relative to mesh center."""
    h = cfg.hmap
    if h.sine_mag <= 0.0:
        return z
    mszi = 1.0 / cfg.mesh_scale_z
    freq = cfg.mesh_scale * h.sine_freq
    z = z + (h.sine_mag * torch.cos(xg * freq) * torch.cos(yg * freq) + h.sine_bias) * mszi
    if h.volcano_width > 0.0 and h.volcano_height > 0.0:
        vf = cfg.mesh_scale / h.volcano_width
        x, y = vf * xg, vf * yg
        dist = torch.sqrt(x * x + y * y)
        val = torch.cos(x) * torch.cos(y)
        hole = torch.clamp(400.0 * (val - 0.999), min=0.0)
        peak = 0.08 * val / torch.clamp(dist, min=0.04)
        vz = h.volcano_height * torch.clamp(peak - hole, min=0.0) * mszi
        z = z + torch.where(dist > 2.0, 0.0, vz)
    return z


def water_z_height(zmax_est: torch.Tensor, cfg: TerrainConfig) -> torch.Tensor:
    """get_water_z_height (mesh_gen.cpp:508-512)."""
    wpz = get_rel_wpz(cfg)
    if cfg.glaciate:
        wpz = wpz ** cfg.glaciate_exp
    return wpz * (2.0 * zmax_est) - zmax_est + cfg.water_h_off


def gen_terrain(cfg: TerrainConfig = TerrainConfig(),
                world: WorldConst = DEFAULT_WORLD,
                angles: torch.Tensor | None = None,
                device: torch.device | str = "cuda") -> TerrainState:
    """Full ground-mode terrain generation (gen_mesh surface_type=0).

    With `cfg.erosion_iters > 0` the glaciated map erodes through
    `ops/erosion.erode` with its roam ring and defaults (batches of 1,024
    droplets, 256 steps), clamped below at the map's bottom, so `angles`
    [ceil(erosion_iters / 1024), 256, 1024] (`ops/erosion.draw_angles`)
    must be given."""
    table = gen_table_for(cfg, world, device=device) if cfg.mode == N.MGEN_SINE else None
    mx, my = world.mesh_x, world.mesh_y
    x0 = cfg.xoff2 - mx // 2
    y0 = cfg.yoff2 - my // 2
    z = raw_height_grid(cfg, world, table, x0, y0, 1.0, 1.0, mx, my, device=device)
    zmin = torch.min(z)
    zmax = torch.max(z)
    zmax_est, hist = estimate_zminmax(cfg, world, table, zmin, zmax)
    wpz = water_z_height(zmax_est, cfg)

    zg = apply_glaciate(z, zmax_est, cfg)
    xg = torch.arange(mx, dtype=torch.float32, device=z.device)[None, :] + x0
    yg = torch.arange(my, dtype=torch.float32, device=z.device)[:, None] + y0
    zg = apply_mesh_sine(zg, xg, yg, cfg)
    zbottom = torch.min(zg)
    ztop = torch.max(zg)

    if cfg.erosion_iters > 0:
        if angles is None:
            raise ValueError("gen_terrain: erosion_iters > 0 needs the erosion "
                             "angles (ops/erosion.draw_angles)")
        eparams = E.ErosionParams(
            erode_amount=cfg.erode_amount,
            water_plane_z=wpz,
            half_dxy=world.half_dxy,
            zmin=-zmax_est, zmax=zmax_est,
            rock_thresh=clip_hd1(cfg),
            relh_adj_tex=cfg.relh_adj_tex,
        )
        zg = E.erode(zg[None], cfg.erosion_iters, eparams, angles,
                     min_zval=zbottom, pad=E.PAD)[0]
        zbottom = torch.min(zg)
        ztop = torch.max(zg)

    return TerrainState(
        mesh_height=zg, zmin=-zmax_est, zmax=zmax_est, zmax_est=zmax_est,
        zbottom=zbottom, ztop=ztop, water_plane_z=wpz, height_histogram=hist,
    )


def _bilinear_resize_np(img, ny: int, nx: int):
    """heightmap_t::resize equivalent (host-side, load-time only)."""
    img = np.asarray(img, np.float32)
    oy, ox = img.shape
    if (oy, ox) == (ny, nx):
        return img
    ys = np.linspace(0.0, oy - 1.0, ny)
    xs = np.linspace(0.0, ox - 1.0, nx)
    y0 = np.clip(np.floor(ys).astype(int), 0, oy - 2)
    x0 = np.clip(np.floor(xs).astype(int), 0, ox - 2)
    fy = (ys - y0)[:, None]
    fx = (xs - x0)[None, :]
    a = img[y0][:, x0]
    b = img[y0][:, x0 + 1]
    c = img[y0 + 1][:, x0]
    d = img[y0 + 1][:, x0 + 1]
    return (a * (1 - fy) * (1 - fx) + b * (1 - fy) * fx
            + c * fy * (1 - fx) + d * fy * fx)


def terrain_from_heightmap(path: str, cfg: TerrainConfig = TerrainConfig(),
                           world: WorldConst = DEFAULT_WORLD,
                           modmap=None, invert: bool = False,
                           angles: torch.Tensor | None = None,
                           device: torch.device | str = "cuda") -> TerrainState:
    """Image-driven mesh: `mesh_height_image` config -> pixels ->
    scale_mh_texture_val heights -> resize to the mesh dims (host) ->
    optional brush-journal replay (`utils/checkpoint.ModmapJournal`) ->
    zmax_est / water plane / erosion (read_mesh_height_image,
    mesh_gen.cpp:135-160; no glaciation, which belongs to the generated
    path only).  With `cfg.erosion_iters > 0` the map erodes through
    `ops/erosion.erode` (kernel A on the card) as `gen_terrain`'s does, so
    `angles` [ceil(erosion_iters / 1024), 256, 1024] must be given.  The
    histogram is a sorted, edge-padded strided sample of 1,024 heights."""
    from ..export import heightmap_io as HIO
    z = HIO.read_heightmap(path, mesh_height_scale=cfg.mesh_height_scale,
                           invert=invert)
    z = _bilinear_resize_np(z, world.mesh_y, world.mesh_x)
    zg = torch.as_tensor(np.asarray(z, np.float32), device=device)
    if modmap is not None:
        zg = modmap.apply(zg)
    zmin = torch.min(zg)
    zmax = torch.max(zg)
    # estimate_zminmax (mesh_gen.cpp:447-464)
    zmax_est = torch.clamp(torch.maximum(zmax, -zmin), min=1e-6)
    wpz = water_z_height(zmax_est, cfg)
    zbottom = zmin
    ztop = zmax
    if cfg.erosion_iters > 0:
        if angles is None:
            raise ValueError("terrain_from_heightmap: erosion_iters > 0 needs "
                             "the erosion angles (ops/erosion.draw_angles)")
        eparams = E.ErosionParams(
            erode_amount=cfg.erode_amount,
            water_plane_z=wpz,
            half_dxy=world.half_dxy,
            zmin=-zmax_est, zmax=zmax_est,
            rock_thresh=clip_hd1(cfg),
            relh_adj_tex=cfg.relh_adj_tex,
        )
        zg = E.erode(zg[None], cfg.erosion_iters, eparams, angles,
                     min_zval=zbottom, pad=E.PAD)[0]
        zbottom = torch.min(zg)
        ztop = torch.max(zg)
    # histogram: sorted sample of the image heights (the generated path
    # samples raw noise; here the image IS the raw height field)
    samp = zg.reshape(-1)[:: max(1, zg.numel() // 1024)][:1024]
    samp = torch.cat([samp, samp[-1:].expand(1024 - samp.shape[0])])
    hist = torch.sort(samp).values
    return TerrainState(
        mesh_height=zg, zmin=-zmax_est, zmax=zmax_est, zmax_est=zmax_est,
        zbottom=zbottom, ztop=ztop, water_plane_z=wpz, height_histogram=hist,
    )

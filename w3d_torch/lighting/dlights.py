"""Dynamic lights: per-frame packed light volumes (port of
`3dworld_tpu/lighting/dlights.py`).

The reference packs up to 1024 dynamic lights per frame into textures for
shader evaluation (light_source.cpp:651, lightmap.cpp dl_sources packing).
Here the frame's dlight set is SoA tensors, and their contribution
evaluates in one pass, into the light volume (for volumetric consumers)
or at arbitrary query points (for surfaces and objects).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops.fmath import sqrt32

MAX_DLIGHTS = 1024  # README.md:21


class DLights(NamedTuple):
    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor
    radius: torch.Tensor
    r: torch.Tensor
    g: torch.Tensor
    b: torch.Tensor
    enabled: torch.Tensor


def pack_dlights(entries, capacity: int = MAX_DLIGHTS,
                 device: torch.device | str = "cuda") -> DLights:
    """Pack a frame's light list of (x, y, z, radius, r, g, b) rows into
    the fixed-capacity SoA."""
    a = np.zeros((capacity, 7), np.float32)
    n = min(len(entries), capacity)
    if n:
        a[:n] = np.asarray(entries, np.float32)[:n]
    t = torch.as_tensor(a, device=device)
    return DLights(*(t[:, i].contiguous() for i in range(7)),
                   enabled=torch.arange(capacity, device=device) < n)


def material_sphere_dlights(objects, mat_first: int, mats,
                            capacity: int | None = None) -> DLights:
    """Emissive thrown material spheres as dynamic lights at their live
    positions (throw_sphere binds a light to the object,
    sphere_materials.cpp:388-394).  Host-side pack from the current
    ObjectState (one read of its arrays), on the objects' device."""
    ot, st, px, py, pz = (t.cpu().numpy() for t in (objects.otype, objects.status,
                                                    objects.px, objects.py, objects.pz))
    entries = []
    for i in np.nonzero((st > 0) & (ot >= mat_first))[0]:
        m = mats[(int(ot[i]) - mat_first) % len(mats)]
        if m.emissive and m.light_radius > 1e-5:
            entries.append((px[i], py[i], pz[i], m.light_radius, *m.diffuse_color))
    return pack_dlights(entries, capacity or MAX_DLIGHTS, device=objects.px.device)


def eval_dlights_at(dl: DLights, px, py, pz):
    """Summed dlight RGB at query points [N] (shader-side falloff:
    (1 - d/r)^2 inside the radius)."""
    dx = px[:, None] - dl.x[None, :]
    dy = py[:, None] - dl.y[None, :]
    dz = pz[:, None] - dl.z[None, :]
    d = sqrt32(dx * dx + dy * dy + dz * dz)
    f = torch.clamp(1.0 - d / torch.clamp(dl.radius[None, :], min=1e-6), min=0.0)
    fall = f * f * dl.enabled[None, :].to(torch.float32)
    return fall @ dl.r, fall @ dl.g, fall @ dl.b


def dlight_volume(dl: DLights, grid, world):
    """Add the frame's dlights to the local-light volume channels (the
    texture-packing consumer path), sampled at cell centers, one z layer
    at a time to bound the [ny*nx, MAX_DLIGHTS] intermediate."""
    nz, ny, nx = grid.shape
    dev = grid.lc_r.device
    ar = lambda n: torch.arange(n, dtype=torch.float32, device=dev)
    xi = (ar(nx) - nx // 2 + 0.5) * world.dx
    yi = (ar(ny) - ny // 2 + 0.5) * world.dy
    zi = grid.z0 + (ar(nz) + 0.5) * grid.dz
    px = xi[None, :].expand(ny, nx).reshape(-1)
    py = yi[:, None].expand(ny, nx).reshape(-1)
    layers = [eval_dlights_at(dl, px, py, zi[k].expand_as(px)) for k in range(nz)]
    rs, gs, bs = (torch.stack([lay[c] for lay in layers]).reshape(nz, ny, nx)
                  for c in range(3))
    return grid._replace(lc_r=grid.lc_r + rs, lc_g=grid.lc_g + gs, lc_b=grid.lc_b + bs)

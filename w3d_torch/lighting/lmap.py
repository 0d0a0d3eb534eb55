"""Indirect-lighting volume (port of `LightGrid` and `make_light_grid` from
`3dworld_tpu/lighting/lmap.py`).

The reference's `lmcell` grid stores {sky RGB + weight, global RGB +
weight, local RGB, smoke, flow} per (x, y, z) cell over
MESH_X x MESH_Y x MESH_SIZE[2] (lightmap.h:31-44).  Here one [nz, ny, nx]
float32 tensor per channel; the default world's grid is [32, 128, 128],
twelve volumes, 25 MB.  A ground scene carries it for its smoke channel;
the rest of the lighting module is not ported.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..utils.constants import WorldConst, DEFAULT_WORLD


class LightGrid(NamedTuple):
    """lmcell SoA: per-channel [nz, ny, nx] volumes."""

    sc_r: torch.Tensor
    sc_g: torch.Tensor
    sc_b: torch.Tensor
    sv: torch.Tensor       # sky weight
    gc_r: torch.Tensor
    gc_g: torch.Tensor
    gc_b: torch.Tensor
    gv: torch.Tensor       # global weight
    lc_r: torch.Tensor
    lc_g: torch.Tensor
    lc_b: torch.Tensor
    smoke: torch.Tensor
    z0: torch.Tensor       # scalar: world z of cell layer 0
    dz: torch.Tensor       # scalar: cell height

    @property
    def shape(self):
        return self.sc_r.shape


def make_light_grid(world: WorldConst = DEFAULT_WORLD, nz: int | None = None,
                    z0: float | None = None, dz: float | None = None,
                    device: torch.device | str = "cuda") -> LightGrid:
    nz = nz if nz is not None else max(world.mesh_z, 1)
    z0 = z0 if z0 is not None else -world.z_scene
    dz = dz if dz is not None else (2.0 * world.z_scene) / nz
    sh = (nz, world.mesh_y, world.mesh_x)
    z = lambda: torch.zeros(sh, dtype=torch.float32, device=device)
    f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=device)
    return LightGrid(sc_r=z(), sc_g=z(), sc_b=z(), sv=z(),
                     gc_r=z(), gc_g=z(), gc_b=z(), gv=z(),
                     lc_r=z(), lc_g=z(), lc_b=z(), smoke=z(),
                     z0=f32(z0), dz=f32(dz))

"""Fused physics substep: CUDA kernel `csrc/substep.cu` (replaces the Pallas
`_substep_kernel`, `3dworld_tpu/ops/pallas/physics_kernel.py:84`, called
through `substep_pallas` at :514).

A team of 8 threads per object runs a whole substep with its state in
registers: every lane the per-object preamble, each lane a share of the
cobj rows, group by group, against the field-major table in shared memory
(the narrow kernel's walk), lane 0 the rest after the team merges its
lanes' tie sums.  The mesh maps are read from global memory.  Takes any N
and any number of cobj slots (the table streams through shared memory in
chunks).  The plain version is `physics/fused.substep_plain`.
"""

from __future__ import annotations

import ctypes

import torch

from . import build
from ...physics.cobj_table import CF_COLUMNS, CF_PAD
from ...physics.fused import substep_plain
from ...utils.constants import WorldConst

KERNEL = build.Kernel("w3d_substep",
                      [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int] + [ctypes.c_void_p] * 23 + [ctypes.c_int])

ENV_LEN = 12


def mesh_maps(mesh: torch.Tensor, world: WorldConst) -> torch.Tensor:
    """[my, mx] heightmap -> [3*my, mx] stack of (height, dz/dx, dz/dy),
    the gradients as periodic central differences (`jnp.roll`)."""
    dzdx = (torch.roll(mesh, -1, 1) - torch.roll(mesh, 1, 1)) * (0.5 * world.dx_inv)
    dzdy = (torch.roll(mesh, -1, 0) - torch.roll(mesh, 1, 0)) * (0.5 * world.dy_inv)
    return torch.cat([mesh, dzdx, dzdy], dim=0).to(torch.float32).contiguous()


def substep(px, py, pz, vx, vy, vz, status, flags,
            rad, air, fric, grav, elas, dens, tv,
            maps3: torch.Tensor, tables: tuple, env: torch.Tensor,
            kernel: build.Kernel = KERNEL):
    """One fused substep: (px, py, pz, vx, vy, vz, status, flags), each [N].
    `tables` is `narrow_kernel.kernel_tables(g)` of the scene's grouped
    cobjs: the packed [M, 32] table, which the plain version reads, its [8]
    group starts and its field-major copy, which the kernel reads.  Other
    arguments as `physics/fused.substep_plain`.  CPU tensors take the plain
    version; CUDA tensors take the kernel (`kernel`: a variant build,
    `KERNEL.variant`)."""
    cf, starts, tab = tables
    args = (px, py, pz, vx, vy, vz, status, flags, rad, air, fric, grav,
            elas, dens, tv, maps3, cf, env)
    if px.device.type == "cpu":
        return substep_plain(*args)
    if px.device.type != "cuda":
        raise ValueError(f"substep: unsupported device {px.device}")
    n = px.shape[0]
    dev = px.device
    names = ("px", "py", "pz", "vx", "vy", "vz", "status", "flags", "rad",
             "air", "fric", "grav", "elas", "dens", "tv")
    for name, t in zip(names, args[:15]):
        dt = torch.int32 if name in ("status", "flags") else torch.float32
        build.check(name, t, dt, (n,), dev)
    my3, mx = maps3.shape
    M = cf.shape[0]
    build.check("maps3", maps3, torch.float32, (my3, mx), dev)
    build.check("cf", cf, torch.float32, (M, CF_PAD), dev)
    build.check("env", env, torch.float32, (ENV_LEN,), dev)
    if my3 % 3 or my3 < 6 or mx < 2:
        raise ValueError(f"substep: maps3 {tuple(maps3.shape)} is not a "
                         f"[3*my, mx] stack with my, mx >= 2")
    build.check("fields", tab, torch.float32, (len(CF_COLUMNS), M + -M % 4), dev)
    build.check("starts", starts, torch.int32, (8,), dev)
    outs = [torch.empty_like(px) for _ in range(6)] \
        + [torch.empty_like(status) for _ in range(2)]
    kernel.launch(env.data_ptr(), maps3.data_ptr(), my3 // 3, mx,
                  tab.data_ptr(), starts.data_ptr(), tab.shape[1],
                  *(t.data_ptr() for t in args[:15]),
                  *(o.data_ptr() for o in outs), n)
    return tuple(outs)

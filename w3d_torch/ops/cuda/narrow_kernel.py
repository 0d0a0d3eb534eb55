"""Shape-grouped static-cobj narrow phase: CUDA kernel `csrc/narrow.cu`
(replaces the Pallas `_narrow_kernel`,
`3dworld_tpu/ops/pallas/narrow_kernel.py:83`).

A team of 8 threads per object splits its cobj rows, group by group,
over a field-major copy of the packed cobj table in shared memory, which
streams through in chunks of CHUNK_ROWS rows; the team merges its lanes'
deepest hits, first index on ties.  Takes any N and any number of cobj
slots.  The plain version is `physics/cobjs.deepest_hits_grouped`.
"""

from __future__ import annotations

import ctypes
import weakref

import torch

from . import build
from ...physics.cobj_table import CF_COLUMNS, CF_PAD
from ...physics.cobjs import CobjSet, GroupedCobjs, deepest_hits_grouped

KERNEL = build.Kernel("w3d_narrow",
                      [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
                      + [ctypes.c_void_p] * 11 + [ctypes.c_int])

# rows of the table a CTA holds in shared memory at once (one chunk in 48 KB)
CHUNK_ROWS = 48 * 1024 // (CF_PAD * 4)
# GroupedCobjs -> (its cobjs, their tensors' versions, kernel_tables(g))
_TABLES: weakref.WeakKeyDictionary = weakref.WeakKeyDictionary()


def pack_cobj_fields(c: CobjSet | GroupedCobjs) -> torch.Tensor:
    """CobjSet (or GroupedCobjs) -> [M, 32] f32 field matrix, columns as
    `physics/cobj_table.CF_COLUMNS`."""
    if isinstance(c, GroupedCobjs):
        c = c.cobjs
    cols = [c.shape.to(torch.float32),
            c.p1[:, 0], c.p1[:, 1], c.p1[:, 2],
            c.p2[:, 0], c.p2[:, 1], c.p2[:, 2],
            c.r1, c.r2, c.npts.to(torch.float32)]
    for k in range(4):
        cols += [c.pts[:, k, 0], c.pts[:, k, 1], c.pts[:, k, 2]]
    cols += [c.pnorm[:, 0], c.pnorm[:, 1], c.pnorm[:, 2],
             c.elasticity, c.friction]
    m = torch.stack(cols, dim=1).to(torch.float32)
    return torch.nn.functional.pad(m, (0, CF_PAD - m.shape[1])).contiguous()


def field_major(cf: torch.Tensor) -> torch.Tensor:
    """[M, 32] field table -> [27, m4] f32: column k of the used columns as
    row k, zero-padded to m4 = M rounded up to 4 (the kernels stage it as
    float4s)."""
    t = cf[:, :len(CF_COLUMNS)].t()
    return torch.nn.functional.pad(t, (0, -cf.shape[0] % 4)).contiguous()


def kernel_tables(g: GroupedCobjs) -> tuple:
    """(packed [M, 32] field table, [8] int32 padded group starts, its
    field-major [27, m4] copy) on the scene's device: the kernels' inputs
    (the kernels C and G read the other two, G's plain version the first).
    Packed at the first call for `g` and reused until `g.cobjs` is another
    object or one of its tensors has been edited in place (torch bumps a
    tensor's `_version` on every in-place write)."""
    c = g.cobjs
    versions = tuple(t._version for t in c)
    hit = _TABLES.get(g)
    if hit is not None and hit[0] is c and hit[1] == versions:
        return hit[2]
    cf = pack_cobj_fields(c)
    tabs = (cf, torch.tensor(g.padded_starts, dtype=torch.int32,
                             device=c.shape.device), field_major(cf))
    _TABLES[g] = (c, versions, tabs)
    return tabs


def deepest_hits(px, py, pz, radius, g: GroupedCobjs,
                 kernel: build.Kernel = KERNEL):
    """(hit, pen, nx, ny, nz, elas, fric), each [N]: each object's deepest
    penetrating cobj.  CPU tensors take the plain version; CUDA tensors
    take the kernel (`kernel`: a variant build, `KERNEL.variant`)."""
    if px.device.type == "cpu":
        return deepest_hits_grouped(px, py, pz, radius, g)
    if px.device.type != "cuda":
        raise ValueError(f"deepest_hits: unsupported device {px.device}")
    n = px.shape[0]
    dev = px.device
    for name, t in (("px", px), ("py", py), ("pz", pz), ("radius", radius)):
        build.check(name, t, torch.float32, (n,), dev)
    cf, starts, tab = kernel_tables(g)
    build.check("fields", tab, torch.float32, (len(CF_COLUMNS), tab.shape[1]), dev)
    build.check("starts", starts, torch.int32, (8,), dev)
    outs = [torch.empty(n, dtype=torch.bool, device=dev)]
    outs += [torch.empty_like(px) for _ in range(6)]
    kernel.launch(tab.data_ptr(), starts.data_ptr(), tab.shape[1],
                  px.data_ptr(), py.data_ptr(), pz.data_ptr(),
                  radius.data_ptr(), *(o.data_ptr() for o in outs), n)
    return tuple(outs)

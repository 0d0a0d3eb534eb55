"""Cross-rank halo exchange (port of `3dworld_tpu/parallel/halo.py`): the
reference's cross-tile chaining between ranks.

The reference chains terrain tiles through edge vectors: AO reads a
36-cell halo of neighbour heights (tiled_mesh.cpp:475-487), and
directional shadows pass `sh_in`/`sh_out` edge vectors from tile to tile
(tiled_mesh.cpp:664-692).  With the tile axis split over ranks, those edge
vectors travel between ranks as ring shifts (`halo_shift`, the JAX
`ppermute`), one `batch_isend_irecv` each.

Every function here runs on each rank with the rank's block of a 1-D row
of tiles (what `shard_map` hands its body in the JAX package) and returns
the rank's block of the result.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..ops import shadows as SH
from .mesh import Mesh, to_comm


def permute(x: torch.Tensor, mesh: Mesh, send_to: int | None,
            recv_from: int | None) -> torch.Tensor:
    """Send `x` to rank `send_to` and receive a tensor like it from rank
    `recv_from` (either None: no send, or zeros received), in one
    `batch_isend_irecv`."""
    if send_to is None and recv_from is None:
        return torch.zeros_like(x)
    src = to_comm(x.contiguous(), mesh)
    buf = torch.empty_like(src)
    ops = []
    if send_to is not None:
        ops.append(dist.P2POp(dist.isend, src, send_to, group=mesh.group))
    if recv_from is not None:
        ops.append(dist.P2POp(dist.irecv, buf, recv_from, group=mesh.group))
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    mesh.traffic.calls += 1
    if recv_from is None:
        return torch.zeros_like(x)
    mesh.traffic.bytes += buf.numel() * buf.element_size()
    return buf.to(x.device)


def halo_shift(x: torch.Tensor, mesh: Mesh, shift: int = 1) -> torch.Tensor:
    """Ring shift: rank r sends `x` to rank (r + shift) mod n and returns
    the block of rank (r - shift) mod n (the JAX `ppermute` over the whole
    ring)."""
    n = mesh.size
    if shift % n == 0:
        return x.clone()
    return permute(x, mesh, (mesh.rank + shift) % n, (mesh.rank - shift) % n)


def make_sharded_shadow_scan(mesh: Mesh, light_dir: tuple, cell_w: float,
                             mode: str = "exact"):
    """Directional mesh shadows over a row of tiles split across ranks.

    Returns `run(zv_block, init_carry)`: zv_block [t_local, n, n] is the
    rank's block of tiles laid out left to right along the light's major
    direction, init_carry [n] the open-boundary carry of the most upstream
    rank.  Returns the rank's shadow masks [t_local, n, n].

    mode="exact": each rank runs its local scan, then edge potentials
    (`sh_out`) move one rank downstream per round and every round re-runs
    the local scan: n-1 rounds, the same masks as the sequential chain of
    tiles.

    mode="carry": one local scan gives each rank's own outgoing potential;
    the n-1 rounds then move only the edge vectors (max with
    `ops/shadows.carry_transform`, the scan's pure-carry operator), and one
    last local scan applies the settled incoming carry: two local scans
    in place of n.  The same masks as "exact" for an axis-aligned light
    (no lateral drift); with drift the edge interpolation runs on the max
    of carries instead of between them."""
    if mode not in ("exact", "carry"):
        raise ValueError(f"make_sharded_shadow_scan: mode {mode!r}")
    nd = mesh.size
    lx, ly, _lz = light_dir
    major = lx if abs(lx) >= abs(ly) else ly
    # light from +major: shadows run toward -major, so tiles (and ranks)
    # are processed in decreasing index order
    reverse = major > 0
    down = -1 if reverse else 1          # the receiving rank's offset
    upstream = mesh.rank == (nd - 1 if reverse else 0)

    def local(zv, sh_in):
        carry = sh_in
        out = [None] * zv.shape[0]
        order = range(zv.shape[0] - 1, -1, -1) if reverse else range(zv.shape[0])
        for t in order:
            out[t], carry = SH.mesh_shadows(zv[t], light_dir, sh_in=carry, cell_w=cell_w)
        return torch.stack(out), carry

    def run_exact(zv_block, init_carry):
        shadowed, sh_out = local(zv_block, init_carry)
        for _ in range(nd - 1):
            incoming = halo_shift(sh_out, mesh, down)
            # the most upstream rank keeps the open-boundary carry
            shadowed, sh_out = local(zv_block, init_carry if upstream else incoming)
        return shadowed

    def run_carry(zv_block, init_carry):
        total = zv_block.shape[0] * zv_block.shape[-1]     # scan columns a rank crosses
        open_in = torch.full_like(init_carry, SH.MESH_MIN_Z)
        # pass 1: own outgoing potential (the caller's boundary carry
        # applies to the most upstream rank only)
        _, a_out = local(zv_block, init_carry if upstream else open_in)
        # edge-only relaxation: out_k = max(A_k, T(in_k)) to the fixpoint
        out_edge = a_out
        for _ in range(nd - 1):
            shifted = halo_shift(out_edge, mesh, down)
            incoming = open_in if upstream else shifted
            carried = SH.carry_transform(incoming, total, light_dir, cell_w)
            out_edge = torch.maximum(a_out, carried)
        incoming = halo_shift(out_edge, mesh, down)
        # pass 2: apply the settled incoming edge (upstream sh_out edges are
        # already framed for their downstream neighbour)
        shadowed, _ = local(zv_block, init_carry if upstream else incoming)
        return shadowed

    return run_carry if mode == "carry" else run_exact


def make_halo_context(mesh: Mesh, halo: int):
    """AO-style halo assembly for a row of tiles split across ranks:
    `run(zv_block)` gives each tile of the rank's [t, n, n] block `halo`
    columns from its left and right neighbours, [t, n, n + 2*halo] (the
    36-cell AO context of tiled_mesh.cpp:475).  A rank's first and last
    tiles take theirs from the neighbouring ranks; the ends of the row
    repeat their own edge."""
    n = mesh.size

    def run(zv_block):
        left_edge = zv_block[-1:, :, -halo:].contiguous()    # sent right
        right_edge = zv_block[:1, :, :halo].contiguous()     # sent left
        from_left = halo_shift(left_edge, mesh, 1)
        from_right = halo_shift(right_edge, mesh, -1)
        if mesh.rank == 0:
            from_left = zv_block[:1, :, :halo]
        if mesh.rank == n - 1:
            from_right = zv_block[-1:, :, -halo:]
        left = torch.cat([from_left, zv_block[:-1, :, -halo:]], 0)
        right = torch.cat([zv_block[1:, :, :halo], from_right], 0)
        return torch.cat([left, zv_block, right], -1)

    return run

"""The device mesh on `torch.distributed` (port of
`3dworld_tpu/parallel/mesh.py`).

One process per rank, as PyTorch runs multi-GPU work.  A `Mesh` names the
process group, this process's rank, the number of ranks, a label for the
sharded axis ('tiles', 'objs', 'rays' in the JAX package) and the device
the rank computes on.  What `PartitionSpec(axis)` does to a leading array
axis there, `local_block` does here: rank r holds the r-th contiguous
block.  `gather_leading` is the way back, an `all_gather` in rank order
(every leaf of a tuple packed into one buffer, one collective).
`shard_leading` takes a rank's share of a nested state, splitting only the
leaves of the named leading sizes (the JAX dry run's `shard_leading_n`),
and `unshard_leading` gathers them back.

The backend is the caller's choice and is never switched behind its back:
`nccl` with one card a rank (`cuda:<local rank>`) by default, or `gloo`,
whose collectives work on host buffers (CUDA tensors are staged through
the host and copied back).  Several ranks on one card take `gloo` and an
explicit `device="cuda:0"`; NCCL refuses two ranks on one card.
"""

from __future__ import annotations

import dataclasses
import datetime
import os

import torch
import torch.distributed as dist

# the longest a collective waits for its peers before the group fails
GROUP_TIMEOUT_S = 120


@dataclasses.dataclass
class Traffic:
    """Bytes this rank received from other ranks, and the collectives
    that moved them (reset and read by the caller)."""

    calls: int = 0
    bytes: int = 0

    def reset(self) -> None:
        self.calls = 0
        self.bytes = 0


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-D mesh of `size` ranks over one process group."""

    group: dist.ProcessGroup | None     # None: the default (world) group
    rank: int
    size: int
    axis: str
    device: torch.device
    backend: str
    traffic: Traffic = dataclasses.field(default_factory=Traffic, compare=False)


def init_mesh(axis: str = "shard", backend: str | None = None,
              device: torch.device | str | None = None) -> Mesh:
    """The mesh over the default process group, initialised here from
    `torchrun`'s environment (RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT)
    when no group exists yet.

    `backend` defaults to the group's, else `nccl`.  `device` defaults to
    `cuda:<local rank>`: with fewer cards than local ranks this raises and
    names the explicit option (`backend="gloo", device="cuda:0"` puts every
    rank on one card); `device="cpu"` runs on the host, with gloo."""
    if dist.is_initialized():
        have = dist.get_backend()
        if backend is not None and backend != have:
            raise ValueError(f"init_mesh: the process group runs {have!r}, "
                             f"not the requested {backend!r}")
        backend = have
    else:
        if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
            raise RuntimeError(
                "init_mesh: no process group and no torchrun environment; "
                "start the ranks with torchrun or parallel.launch.run_ranks")
        backend = backend or "nccl"
    rank = dist.get_rank() if dist.is_initialized() else int(os.environ["RANK"])
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("init_mesh: no CUDA device; pass device='cpu' "
                               "(with backend='gloo') to run the ranks on the host")
        lr = int(os.environ.get("LOCAL_RANK", rank))
        if lr >= torch.cuda.device_count():
            raise RuntimeError(
                f"init_mesh: local rank {lr} but {torch.cuda.device_count()} "
                "CUDA device(s); to put several ranks on one card pass "
                "backend='gloo', device='cuda:0' (python -m w3d_torch.dryrun "
                "--backend gloo --share-card)")
        device = f"cuda:{lr}"
    device = torch.device(device)
    if backend == "nccl" and device.type != "cuda":
        raise ValueError(f"init_mesh: nccl needs CUDA devices, got {device}; "
                         "use backend='gloo' for the host")
    if not dist.is_initialized():
        dist.init_process_group(backend, init_method="env://",
                                timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
    if device.type == "cuda":
        torch.cuda.set_device(device)
    return Mesh(group=None, rank=dist.get_rank(), size=dist.get_world_size(),
                axis=axis, device=device, backend=backend)


def pad_to_multiple(n: int, k: int) -> int:
    return -(-n // k) * k


def _leaves(x) -> list:
    """The tensors of a tensor or a nested tuple / NamedTuple (None
    skipped), in order."""
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, tuple):
        return [t for v in x for t in _leaves(v)]
    return []


def _rebuild(x, leaves):
    """`x` with its tensors replaced, in order, by `leaves`."""
    it = iter(leaves)

    def walk(v):
        if isinstance(v, torch.Tensor):
            return next(it)
        if isinstance(v, tuple):
            items = [walk(u) for u in v]
            return type(v)(*items) if hasattr(v, "_fields") else tuple(items)
        return v
    return walk(x)


def local_block(x, mesh: Mesh):
    """The rank's contiguous block of the leading axis of a tensor, or of
    every tensor of a (nested) tuple or NamedTuple (`P(axis)`'s shard)."""
    def block(t):
        n = t.shape[0]
        if n % mesh.size:
            raise ValueError(f"local_block: leading axis {n} does not split "
                             f"over {mesh.size} ranks")
        k = n // mesh.size
        return t[mesh.rank * k:(mesh.rank + 1) * k]
    return _rebuild(x, [block(t) for t in _leaves(x)])


def to_comm(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """`t` as the backend sends it: gloo works on host buffers."""
    return t.cpu() if mesh.backend == "gloo" else t


def all_gather_stack(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """[size, *t.shape]: every rank's `t`, in rank order, on `t`'s device."""
    src = to_comm(t.contiguous(), mesh)
    if src.dtype == torch.bool:          # gloo sends no bools: their bytes
        src = src.view(torch.uint8)
    parts = [torch.empty_like(src) for _ in range(mesh.size)]
    dist.all_gather(parts, src, group=mesh.group)
    mesh.traffic.calls += 1
    mesh.traffic.bytes += (mesh.size - 1) * src.numel() * src.element_size()
    return torch.stack(parts).view(t.dtype).to(t.device)


def _as_bytes(t: torch.Tensor) -> torch.Tensor:
    """The flat bytes of `t` (a view where `t` is contiguous)."""
    t = t.contiguous().reshape(-1)
    return t.view(torch.uint8) if t.dtype != torch.uint8 else t


def gather_packed(leaves: list, mesh: Mesh) -> list:
    """Every rank's block of each leaf, in rank order, in ONE collective:
    the leaves (any dtypes, any leading sizes, the same on every rank) are
    packed as bytes into one buffer, gathered and unpacked.  Returns each
    leaf's [size * k, ...] concatenation; the bytes are copied, so the
    values are bit for bit the senders'."""
    if not leaves:
        return []
    flat = [_as_bytes(t) for t in leaves]
    g = all_gather_stack(torch.cat(flat), mesh)           # [size, bytes]
    out, off = [], 0
    for t, b in zip(leaves, flat):
        part = g[:, off:off + b.numel()].clone()           # a storage of its own
        off += b.numel()
        if t.dtype != torch.uint8:
            part = part.view(t.dtype)
        out.append(part.reshape((-1,) + tuple(t.shape[1:])))
    return out


def gather_leading(x, mesh: Mesh):
    """Inverse of `local_block`: the whole leading axis from every rank's
    block, in rank order.  All leaves of a tuple travel in one collective."""
    return _rebuild(x, gather_packed(_leaves(x), mesh))


def shard_leading(x, mesh: Mesh, sizes):
    """The rank's share of a nested tuple / NamedTuple (the JAX dry run's
    `shard_leading_n` and `shard_ships`): `local_block` of every tensor
    whose leading size is one of `sizes`; every other leaf (scalars, tables
    of other sizes, None) stays whole, replicated.  Nothing is padded: a
    listed size that does not split over the ranks raises."""
    sizes = set(sizes)
    for n in sizes:
        if n % mesh.size:
            raise ValueError(f"shard_leading: {n} does not split over {mesh.size} ranks")

    def one(t):
        if t.dim() >= 1 and t.shape[0] in sizes:
            k = t.shape[0] // mesh.size
            return t[mesh.rank * k:(mesh.rank + 1) * k]
        return t
    return _rebuild(x, [one(t) for t in _leaves(x)])


def unshard_leading(x, mesh: Mesh, sizes):
    """Inverse of `shard_leading` with the same `sizes`: every leaf whose
    leading size times the ranks is one of them is gathered, all in one
    collective; the replicated leaves come back as they are (none of them
    may have such a leading size)."""
    sizes = set(sizes)
    leaves = _leaves(x)
    split = [i for i, t in enumerate(leaves)
             if t.dim() >= 1 and t.shape[0] * mesh.size in sizes]
    whole = gather_packed([leaves[i] for i in split], mesh)
    for i, t in zip(split, whole):
        leaves[i] = t
    return _rebuild(x, leaves)


def broadcast(t: torch.Tensor, mesh: Mesh, src: int = 0) -> torch.Tensor:
    """Rank `src`'s `t` on every rank (same shape and dtype everywhere)."""
    buf = to_comm(t.contiguous(), mesh).clone()
    dist.broadcast(buf, src, group=mesh.group)
    mesh.traffic.calls += 1
    if mesh.rank != src:
        mesh.traffic.bytes += buf.numel() * buf.element_size()
    return buf.to(t.device)


def barrier(mesh: Mesh) -> None:
    """Wait for every rank (and, on a card, for this rank's queued work)."""
    if mesh.device.type == "cuda":
        torch.cuda.synchronize(mesh.device)
    dist.barrier(group=mesh.group)

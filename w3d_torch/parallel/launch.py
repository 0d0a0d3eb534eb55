"""Start `n` ranks on this host and collect what each returns.

`run_ranks(fn, n, backend, device, *args)` spawns `n` processes with
`torch.multiprocessing` (the `spawn` method), joins them into one process
group over a `FileStore` in a temporary directory (no TCP port to collide
with another run), builds each rank's `Mesh` and calls `fn(mesh, *args)`.
It returns every rank's `RankResult` in rank order: the value `fn`
returned (tensors moved to the host) and the rank's kernel launches during
`fn`.  Any rank's exception, a rank that dies, or a run past `timeout`
fails the call with the rank's traceback, after every rank is stopped.

`fn` is pickled by its import path, so it lives at the top level of a
module the children can import (one that does not import jax: a child
imports the module of its target).  On a card the kernels are built here,
before the spawn, so the ranks never race in the build directory; every
rank then computes on `device` (`cuda:<rank>` for nccl by default).
"""

from __future__ import annotations

import datetime
import os
import tempfile
import time
import traceback
from typing import Any, Callable, NamedTuple

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from . import mesh as M


class RankResult(NamedTuple):
    value: Any
    launches: dict          # kernel name -> launches during fn


def kernels() -> dict:
    """The port's kernel handles, by name (their `launches` counters)."""
    from ..ops.cuda import (erosion_kernel, glue_kernel, narrow_kernel, noise_kernel,
                            pairs_kernel, physics_kernel, sample_kernel, stencil_kernel)
    return {"erosion": erosion_kernel.KERNEL, "sample": sample_kernel.KERNEL,
            "narrow": narrow_kernel.KERNEL, "pairs": pairs_kernel.KERNEL,
            "substep": physics_kernel.KERNEL, "tile_noise": noise_kernel.KERNEL,
            "diffuse_smoke": stencil_kernel.KERNEL, **glue_kernel.BY_NAME}


def launch_counts() -> dict:
    return {n: k.launches for n, k in kernels().items()}


def _to_host(value):
    if isinstance(value, torch.Tensor):
        return value.detach().cpu()
    if isinstance(value, dict):
        return {k: _to_host(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        items = [_to_host(v) for v in value]
        if hasattr(value, "_fields"):
            return type(value)(*items)
        return type(value)(items)
    return value


def _child(rank: int, fn: Callable, n: int, backend: str, device, tmp: str,
           args: tuple) -> None:
    """One rank: join the group, run `fn`, write its result or traceback."""
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(n))
    try:
        store = dist.FileStore(os.path.join(tmp, "store"), n)
        dev = torch.device(device if device is not None else f"cuda:{rank}")
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group(backend, store=store, rank=rank, world_size=n,
                                timeout=datetime.timedelta(seconds=M.GROUP_TIMEOUT_S))
        try:
            mesh = M.init_mesh(backend=backend, device=dev)
            for k in kernels().values():
                k.launches = 0
            value = fn(mesh, *args)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            result = RankResult(_to_host(value), launch_counts())
            torch.save(result, os.path.join(tmp, f"result_{rank}.pt"))
        finally:
            dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(tmp, f"error_{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        raise


def run_ranks(fn: Callable, n: int, backend: str, device, *args,
              timeout: float = 900.0) -> list[RankResult]:
    """Run `fn(mesh, *args)` on `n` ranks; their results in rank order.

    `device` is every rank's device ("cuda:0" to share one card, "cpu"),
    or None for `cuda:<rank>`.  Raises RuntimeError when a rank fails and
    TimeoutError after `timeout` seconds."""
    dev = torch.device(device) if device is not None else None
    if dev is None or dev.type == "cuda":
        from ..ops.cuda import build
        build.build()          # once, here: the ranks load the built library
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="w3d_ranks_") as tmp:
        procs = [ctx.Process(target=_child, args=(r, fn, n, backend, device, tmp, args),
                             daemon=True)
                 for r in range(n)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        failed = None
        try:
            while any(p.is_alive() for p in procs):
                failed = next((r for r, p in enumerate(procs)
                               if p.exitcode not in (None, 0)), None)
                if failed is not None:
                    break
                if time.monotonic() > deadline:
                    raise TimeoutError(f"run_ranks: {fn.__name__} on {n} ranks "
                                       f"ran past {timeout:.0f} s")
                time.sleep(0.05)
            if failed is None:
                failed = next((r for r, p in enumerate(procs) if p.exitcode != 0), None)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
            for p in procs:
                p.join(10)
        if failed is not None:
            path = os.path.join(tmp, f"error_{failed}.txt")
            why = "no traceback"
            if os.path.exists(path):
                with open(path) as f:
                    why = f.read()
            raise RuntimeError(f"run_ranks: rank {failed} of {n} failed "
                               f"(exit code {procs[failed].exitcode}):\n{why}")
        return [torch.load(os.path.join(tmp, f"result_{r}.pt"), weights_only=False)
                for r in range(n)]

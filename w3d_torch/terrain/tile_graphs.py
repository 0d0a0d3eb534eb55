"""CUDA graphs of a tile batch (`tiles.gen_tile_batch`) for `TileManager`.

On the card a padded batch of new tiles is some 1,750 small launches, and
the host's dispatch of them paces the frame that makes it.  A manager's
batches go through its `ops/cuda/graphs.GraphCache` named `tiles`, one
CUDA graph a phase (`tiles.phases`).  The key (`batch_key`) is the
device, the padded batch size, the tile size, the terrain configuration,
the world, the droplet count, the sun, and the sine table and erosion
angles by identity and by their tensors' `_version`s.  The origins and
the height range are the graphs' inputs (`INPUTS`), so a new
`set_height_range` needs no new capture.
"""

from __future__ import annotations

import torch

from ..ops.cuda.graphs import tensors_key
from . import tiles as TL

INPUTS = ("txs", "tys", "zmax_est", "wpz")


def batch_key(s: TL.BatchSpec, txs: torch.Tensor) -> tuple | None:
    """Everything a capture of the batch bakes in, hashable; None for a
    batch off a card, which never captures."""
    if txs.device.type != "cuda":
        return None
    return (txs.device, txs.shape[0], s.tile_size, s.cfg, s.world, s.erosion_iters,
            tuple(s.sun_dir), tensors_key(s.table), tensors_key(s.angles))

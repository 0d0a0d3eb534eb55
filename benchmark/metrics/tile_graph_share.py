"""Percent of the traced frames that make tiles whose `tiles.generate`
span holds a `tiles.graph` span: the padded batches replayed from CUDA
graphs in place of their phases' eager launches, from the program's own
spans; None where no traced frame made tiles, or where the program has
no tile graphs (`w3d_torch/terrain/tile_graphs`)."""

import importlib.util

from benchmark.metrics import spans as S


def read(run):
    if importlib.util.find_spec("w3d_torch.terrain.tile_graphs") is None:
        return None
    made = [c for c in S.calls(run) or () if c.named("tiles.generate")]
    if not made:
        return None
    return 100.0 * sum(bool(c.named("tiles.graph")) for c in made) / len(made)

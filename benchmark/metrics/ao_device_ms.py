"""Median over the traced frames that make tiles of `tiles.ao`'s device
time, from the CUDA events the span records at its ends: the tiles'
ambient obscurance (`ops/ao.tile_ao`, 8 directions of 8 steps) for one
padded batch of new tiles; None where no traced frame made tiles or the
span has no events."""

import statistics

from benchmark.metrics import spans as S


def read(run):
    per = []
    for c in S.calls(run) or ():
        d = [s.device_ms for s, _, _ in c.spans if s.name == "tiles.ao"]
        if d and None not in d:
            per.append(sum(d))
    return statistics.median(per) if per else None

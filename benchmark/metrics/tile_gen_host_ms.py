"""Median over the traced frames that make tiles of the host time in
`tiles.generate`: the enqueue of one padded batch of new tiles (context,
erosion, AO, shadows, biome weights) inside `TileManager.update`; None
where no traced frame made tiles."""

import statistics

from benchmark.metrics import spans as S


def read(run):
    calls = S.calls(run)
    per = [sum(b - a for s, a, b in c.spans if s.name == "tiles.generate")
           for c in calls or () if any(s.name == "tiles.generate" for s, _, _ in c.spans)]
    return 1e-3 * statistics.median(per) if per else None

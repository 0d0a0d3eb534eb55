"""Percent of the traced frames whose `frame` span holds a
`physics.graph` span: the frames replayed from a CUDA graph in place of
the eager glue's launches, from the program's own spans."""

from benchmark.metrics import spans as S


def read(run):
    frames = [c for c in S.calls(run) or () if c.named("frame")]
    if not frames:
        return None
    return 100.0 * sum(bool(c.named("physics.graph")) for c in frames) / len(frames)

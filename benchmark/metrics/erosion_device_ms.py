"""Median over the traced tile calls of `tiles.erode`'s device time, from
the CUDA events the span records at its ends: walk A and the erosion's
glue around it (padding, droplet starts, the clamp)."""

from benchmark.metrics import spans as S


def read(run):
    return S.device_ms(run, "tiles.erode")

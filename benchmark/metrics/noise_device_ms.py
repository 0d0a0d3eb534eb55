"""Median over the traced tile calls of `tiles.noise`'s device time, from
the CUDA events the span records at its ends: the term tables, the
einsum, shape and post-processing."""

from benchmark.metrics import spans as S


def read(run):
    return S.device_ms(run, "tiles.noise")

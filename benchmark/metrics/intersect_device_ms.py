"""Median over the traced blocks of the bake's intersect device time: the
`light.intersect` spans' CUDA events summed over a block's batches and
bounces (the cobj and heightfield tests with kernel B, the hit
selection), idle time inside them included; None without such spans."""

from benchmark.metrics import light_spans as LS


def read(run):
    return LS.device_ms(run, "light.intersect")

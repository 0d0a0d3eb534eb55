"""Median over the traced blocks of the bake's deposit device time: the
`light.deposit` spans' CUDA events summed over a block (the segments'
samples and cell sums, `lighting/lmap.cell_sums`, and the sums' addition
to the grid once a batch), idle time inside them included; None without
such spans."""

from benchmark.metrics import light_spans as LS


def read(run):
    return LS.device_ms(run, "light.deposit")

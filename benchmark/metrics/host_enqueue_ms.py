"""Median over the traced steps of the host time from a step's start
until the program's call returns, before its host read (`frame_step` in
a frame, `tile_batch_step` in a tile call)."""

from benchmark.metrics import yardstick as Y


def read(run):
    return Y.median_ms((a, b) for a, b, _ in run.steps) if run.trace else None

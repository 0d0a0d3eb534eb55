"""Median over the traced frames of `city.peds`'s device time, from its
CUDA events: the pedestrians' step (`city/traffic.step_peds`, its dense
separation over every pair included); None where a traced frame has no
such span."""

from benchmark.metrics import spans as S


def read(run):
    return S.device_ms(run, "city.peds")

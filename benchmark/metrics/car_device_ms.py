"""Median over the traced frames of `city.cars`'s device time, from its
CUDA events: the stoplights' and the cars' step
(`city/traffic.step_stoplights`, `step_cars`, its headway over every pair
of cars included); None where a traced frame has no such span."""

from benchmark.metrics import spans as S


def read(run):
    return S.device_ms(run, "city.cars")

"""Median over the traced frames of `city`'s device time, from the CUDA
events the span records at its ends: the city frame
(`city/city_step.city_frames_chained`: stoplights, cars, pedestrians,
helicopters, birds, trains, elevators, building people), idle time
inside it included; None where a traced frame has no such span."""

from benchmark.metrics import spans as S


def read(run):
    return S.device_ms(run, "city")

"""Median over the traced frames of the host time in `city.reroute`: the
building people's reroute (`city/city_step.MergedBuildingPeople.reroute`:
who arrived, their new paths planned on the host, the masked upload)
after the people probe's fetch; None where no traced frame has the
span."""

import statistics

from benchmark.metrics import spans as S


def read(run):
    per = [sum(b - a for _, a, b in c.named("city.reroute")) for c in S.calls(run) or ()
           if c.named("city.reroute")]
    return 1e-3 * statistics.median(per) if per else None

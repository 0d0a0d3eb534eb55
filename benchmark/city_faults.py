"""Faults planted in the live tiled city (`tiled_city.walk`), to read what
its check makes of them:

    python3 -m benchmark.city_faults --fault <name> --seeds 1,2,3 [--seconds 3]

prints one JSON line a seed with the program's readings, as
`benchmark.stream_faults` does for the stream's; the CPU tests plant them
through `planted`.

- `no_separation`: pedestrians ignore their neighbours
  (`city/traffic._separation` pushes nobody);
- `run_red`: red lights stop nobody: cars ignore them (`city/traffic.red_for`
  is never red) and pedestrians cross against them (`can_cross` is always
  true).  The port's car segments run from border to border of a city,
  and its border crossings have no light, so only the pedestrians show it;
- `no_headway`: cars never brake for the car ahead (`step_cars` sees
  every other car as parked in its headway test).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys

import torch

from w3d_torch.city import traffic as CT

from . import harness

WORKLOAD = "tiled_city.walk"


def _no_separation(f):
    def broken(x, y, sep_radius, peers=None):
        return torch.zeros_like(x), torch.zeros_like(y)
    return broken


def _run_red(f):
    def broken(sl, isec, orient, turn_left):
        return torch.zeros_like(isec, dtype=torch.bool)
    return broken


def _walk_red(f):
    def broken(sl, isec, road_dim):
        return torch.ones_like(isec, dtype=torch.bool)
    return broken


def _no_headway(f):
    def broken(cars, graph, stoplights=None, peers=None):
        p = peers if peers is not None else CT.CarPeers(cars.seg, cars.end, cars.t, cars.parked)
        return f(cars, graph, stoplights=stoplights,
                 peers=p._replace(parked=torch.ones_like(p.parked)))
    return broken


FAULTS = {"no_separation": ((CT, "_separation", _no_separation),),
          "run_red": ((CT, "red_for", _run_red), (CT, "can_cross", _walk_red)),
          "no_headway": ((CT, "step_cars", _no_headway),)}


@contextlib.contextmanager
def planted(name: str):
    """The program with fault `name` in place."""
    good = [(owner, attr, getattr(owner, attr)) for owner, attr, _ in FAULTS[name]]
    for owner, attr, make in FAULTS[name]:
        setattr(owner, attr, make(getattr(owner, attr)))
    try:
        yield
    finally:
        for owner, attr, f in good:
            setattr(owner, attr, f)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--fault", required=True, choices=sorted(FAULTS))
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        harness.log("city_faults needs a CUDA device")
        return 2
    for seed in (int(s) for s in args.seeds.split(",")):
        with planted(args.fault):
            r = harness.run_cell(WORKLOAD, seed, args.seconds, False,
                                 calibrate=True, control=False)
        print(json.dumps({"workload": WORKLOAD, "seed": seed, "fault": args.fault,
                          "correct": r["correct"], "failed": r["failed"],
                          "attempted": r["attempted"], "program": r["readings"]}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Faults planted in the lighting bake (`lighting_bake.sky`), to read what
its check makes of them:

    python3 -m benchmark.light_faults --fault <name> --seeds 1,2,3 [--seconds 3]

prints one JSON line a seed with the program's readings, as
`benchmark.city_faults` does for the city's; the CPU tests plant them
through `planted`.

- `one_bounce_fewer`: every batch stops a bounce early (`trace_batch`
  traces `max_bounces - 1`; the last bounce's draws are still drawn, so
  only the tracing differs);
- `no_boost`: the compaction keeps its survivors without multiplying
  their weights by alive / kept (`trace._compact_rays`).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys

import torch

from w3d_torch.lighting import trace as LT
from w3d_torch.ops.cuda import graphs as CG

from . import harness

WORKLOAD = "lighting_bake.sky"


def _one_bounce_fewer(f):
    def broken(*a, params=LT.TraceParams(), **kw):
        out = f(*a, params=params._replace(max_bounces=params.max_bounces - 1), **kw)
        last = params.max_bounces - 1
        a[13].bounce(last, LT.bounce_slots(a[3].shape[0], params)[last], params)
        return out
    return broken


def _no_boost(f):
    def broken(st, u, keep):
        order = torch.argsort(torch.where(st["alive"], u, 2.0), stable=True)[:keep]
        return dict(st, **{k: st[k][order] for k in LT._RAY_FIELDS})
    return broken


FAULTS = {"one_bounce_fewer": ((LT, "trace_batch", _one_bounce_fewer),),
          "no_boost": ((LT, "_compact_rays", _no_boost),)}


@contextlib.contextmanager
def planted(name: str):
    """The program with fault `name` in place, and a graph cache of its own
    for the batches, so no graph captured without the fault replays."""
    good = [(owner, attr, getattr(owner, attr)) for owner, attr, _ in FAULTS[name]]
    good.append((LT, "BATCHES", LT.BATCHES))
    for owner, attr, make in FAULTS[name]:
        setattr(owner, attr, make(getattr(owner, attr)))
    LT.BATCHES = CG.GraphCache("light")
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
        harness.log("light_faults needs a CUDA device")
        return 2
    for seed in (int(s) for s in args.seeds.split(",")):
        with planted(args.fault):
            r = harness.run_cell(WORKLOAD, seed, args.seconds, False,
                                 overrides={"traffic": {"check_from": 4}},
                                 calibrate=True, control=False)
        print(json.dumps({"workload": WORKLOAD, "seed": seed, "fault": args.fault,
                          "correct": r["correct"], "failed": r["failed"],
                          "attempted": r["attempted"], "program": r["readings"]}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

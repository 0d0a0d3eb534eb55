"""Readings for the correctness limits: the program's and the control's,
on many seeds, in one process.

    python3 -m benchmark.calibrate --workload <cell> --seeds 1,2,3 --seconds 3 [--fault NAME] [--out FILE]

For each seed it runs the cell with a short window and prints one JSON
line: the readings of the program against the plain reference and those
of the control (the reference in the next lower precision, in the
program's place) on the same steps.  A limit lies between the largest
program reading over a dozen seeds or more and the smallest control
reading.  With `--fault` the program runs with that fault of
`benchmark/faults.py` planted, and the line holds its readings alone.
"""

from __future__ import annotations

import argparse
import json
import sys

from . import harness


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--fault", default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        harness.log("calibrate needs a CUDA device")
        return 2
    lines = []
    for seed in (int(s) for s in args.seeds.split(",")):
        if args.fault:
            from . import faults
            with faults.planted(args.fault):
                r = harness.run_cell(args.workload, seed, args.seconds, False,
                                     calibrate=True, control=False)
        else:
            r = harness.run_cell(args.workload, seed, args.seconds, False, calibrate=True)
        line = {"workload": args.workload, "seed": seed, "fault": args.fault,
                "correct": r["correct"], "program": r["readings"],
                "control": r.get("control"),
                "metrics": {k: v["value"] for k, v in r["metrics"].items()},
                "device": r["device"]}
        lines.append(json.dumps(line))
        print(lines[-1], flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.write("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())

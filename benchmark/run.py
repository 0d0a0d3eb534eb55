"""Run one cell of the benchmark once and print its result line.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout.  Needs as many CUDA cards as the cell
asks for; without them it exits with code 2 and prints no result.  The
last line of standard output is the result as one JSON object; the last
lines of standard error are the numbers the check compared, each beside
its limit.  Build and kernel caches stay inside the checkout.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from . import harness

# the boot-clock time of the process's start, read before anything heavy
_START = harness.process_start_boot_s()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    manifest = harness.read_json(os.path.join(harness.ROOT, "BENCHMARK.json"))
    wl, _ = harness.cell(manifest, args.workload)
    cache = os.path.join(harness.ROOT, ".bench_cache")
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", os.path.join(cache, "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(cache, "triton"))

    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < wl["chips"]:
        harness.log(f"{args.workload} needs {wl['chips']} CUDA device(s); "
                    f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    result = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                              device="cuda", start_boot_s=_START)
    d = result["device"]
    harness.log(f"device: {d['kind']} x{d['count']}, {d.get('power_limit')}")
    for name, c in result["checks"].items():
        harness.log(f"check {name}: {c['value']!r} (limit {c['limit']!r})")
    sys.stdout.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

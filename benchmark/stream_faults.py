"""Faults planted in the live tiled-terrain frame (`tiled_terrain_128.stream`),
to read what its check makes of them:

    python3 -m benchmark.stream_faults --fault <name> --seeds 1,2,3 [--seconds 3]

prints one JSON line a seed with the program's readings, as
`benchmark.calibrate --fault` does for `faults.py`'s; the CPU tests plant
them through `planted`.

- `shadows_none`: no cell is ever in shadow (`ops/shadows.mesh_shadows`
  returns an all-false mask);
- `ao_halo_edge`: AO's rays march through a halo filled with the tile's
  own edge heights instead of the neighbours' (`ops/ao.tile_ao`);
- `adopt_at_once`: a budgeted batch is adopted in the frame that makes
  it instead of the next (`TileManager._generate` never defers).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys

import torch

from w3d_torch.ops import ao as AO
from w3d_torch.ops import shadows as SH
from w3d_torch.terrain import tiles as TL

from . import harness

WORKLOAD = "tiled_terrain_128.stream"


def _shadows_none(f):
    def broken(zvals, light_dir, sh_in=None, cell_w=1.0):
        mask, out = f(zvals, light_dir, sh_in, cell_w)
        return torch.zeros_like(mask), out
    return broken


def _ao_halo_edge(f):
    def broken(ctx, stride, dz):
        h = (ctx.shape[-1] - stride) // 2
        tile = ctx[..., h:h + stride, h:h + stride]
        edge = torch.nn.functional.pad(tile[:, None], (h,) * 4, mode="replicate")[:, 0]
        return f(edge, stride, dz)
    return broken


def _adopt_at_once(f):
    def broken(self, keys, defer=False):
        return f(self, keys, defer=False)
    return broken


FAULTS = {"shadows_none": (SH, "mesh_shadows", _shadows_none),
          "ao_halo_edge": (AO, "tile_ao", _ao_halo_edge),
          "adopt_at_once": (TL.TileManager, "_generate", _adopt_at_once)}


@contextlib.contextmanager
def planted(name: str):
    """The program with fault `name` in place."""
    owner, attr, make = FAULTS[name]
    good = getattr(owner, attr)
    setattr(owner, attr, make(good))
    try:
        yield
    finally:
        setattr(owner, attr, good)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--fault", required=True, choices=sorted(FAULTS))
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        harness.log("stream_faults needs a CUDA device")
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

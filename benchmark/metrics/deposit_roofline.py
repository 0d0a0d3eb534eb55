"""The bake's deposit against its least bytes: 44 B a deposited
ray-bounce (11 float32: origin, direction, hit distance, weight, colour)
and a read and a write of the 4 sky channels of every cell once a block,
over 3.35 TB/s, as a share of `deposit_device_ms`.  Once a block is the
least for the grid: a call ends in the grid that holds the whole block,
and nothing between a block's batches has to be in the grid.  The
ray-bounces are the program's count for each traced block (the check's
`work`), so any deposit is read against the same work."""

import statistics

from benchmark.metrics import light_spans as LS
from benchmark.metrics import yardstick as Y

RAY_BYTES = 11 * 4
CELL_BYTES = 2 * 4 * 4


def read(run):
    work = run.work.get("deposit")
    ms = LS.device_ms(run, "light.deposit")
    if not work or not work["rays"] or ms is None or ms <= 0.0:
        return None
    nbytes = statistics.median(RAY_BYTES * r + CELL_BYTES * work["cells"]
                               for r in work["rays"])
    return 100.0 * Y.bound_ms(nbytes, 0)[0] / ms

"""Kernel D (`banded_pairs_kernel`): its bound from the pair tests and
contacts of the traced frames' pair passes, over its summed device time."""

from benchmark.metrics import yardstick as Y


def read(run):
    work = run.work.get("banded_pairs")
    if run.trace is None or not work:
        return None
    return Y.roofline(run.trace, "banded_pairs_kernel",
                      sum(Y.pairs_bound(*w)[0] for w in work))

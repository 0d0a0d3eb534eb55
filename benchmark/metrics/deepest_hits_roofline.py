"""Kernel C (`narrow_kernel`, the shape-grouped narrow phase): its bound
per launch from the cell's shapes, times its launches in the trace, over
its summed device time."""

from benchmark.metrics import yardstick as Y


def read(run):
    work = run.work.get("narrow")
    if run.trace is None or not work:
        return None
    launches = Y.kernel_count(run.trace, "narrow_kernel")
    return Y.roofline(run.trace, "narrow_kernel", launches * Y.narrow_bound(*work)[0])

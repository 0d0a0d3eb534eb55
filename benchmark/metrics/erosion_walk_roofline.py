"""Kernel A (`erosion_walk_kernel`): its bound from the droplet-steps,
deposits and stencils that the traced calls' droplets took, over its
summed device time."""

from benchmark.metrics import yardstick as Y


def read(run):
    work = run.work.get("erosion_walk")
    if run.trace is None or not work:
        return None
    return Y.roofline(run.trace, "erosion_walk_kernel",
                      sum(Y.erosion_bound(*w)[0] for w in work))

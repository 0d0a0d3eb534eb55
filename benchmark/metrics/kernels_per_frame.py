"""Device kernels in the trace over the frames traced."""


def read(run):
    if run.trace is None or not run.trace.kernels:
        return None
    return len(run.trace.kernels) / run.trace.steps

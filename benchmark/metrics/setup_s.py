"""Set-up time: the process's start to the first timed step (imports, the
card's start, loading or building the kernel library, the inputs, the
warm-up steps)."""


def read(run):
    return run.setup_s

"""Wall time of the whole window over the frames completed in it; each
frame ends in its host read."""


def read(run):
    return 1e3 * run.window_s / len(run.steps)

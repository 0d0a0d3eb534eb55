"""Tiles finished in the window over the window's wall time; each call
ends in a host read of a value computed from all of its tiles."""


def read(run):
    return len(run.steps) * run.items_per_step / run.window_s

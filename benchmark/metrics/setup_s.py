"""Seconds from the process's start to the window's first enqueue: imports,
the kernels' build (first run in a checkout) or load, the weights, the
frames and their pinned pool, and the warm-up pass over every shape."""


def read(run):
    return run.setup_s

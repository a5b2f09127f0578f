"""Process start to window open: weights, build or load of the kernels,
graph captures, the warm-up of every shape, and the mix's warm-in."""


def read(run):
    return run.setup_s

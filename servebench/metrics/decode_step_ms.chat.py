"""Mean measured duration of a decode step of the slot pool."""

from servebench.readings import mean_ms


def read(run):
    return mean_ms(run.main, "decode")

"""Mean measured duration of a B = 1 admission prefill."""

from servebench.readings import mean_ms


def read(run):
    return mean_ms(run.main, "prefill")

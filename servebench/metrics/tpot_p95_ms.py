"""p95 of (done - first token) / (tokens - 1) over the requests completed
in the window, on the serving timeline."""

from servebench.readings import p95_ms, tpot_s


def read(run):
    return p95_ms(tpot_s(run.main))

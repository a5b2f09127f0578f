"""K4's share of its roofline in the traced tail: the least time its calls
could take (the larger of bytes over HBM bandwidth and operations over the
bf16 peak, counted by the configuration's kind,
``servebench/counts/<kind>.py``) over its profiled device time, in %."""

from servebench.readings import roofline


def read(run):
    return roofline(run, "k4")

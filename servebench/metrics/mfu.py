"""Useful operations of the window's real prompt and output tokens (the
``step_flops`` of the configuration's kind, ``servebench/counts/<kind>.py``)
per wall-clock second over the card's dense bf16 peak, in %."""


def read(run):
    seg = run.main
    if not seg.steps:
        return None
    flops = sum(run.counts.step_flops(run.model, s) for s in seg.steps)
    return 100.0 * flops / seg.wall_s / run.peaks["bf16_flops"]

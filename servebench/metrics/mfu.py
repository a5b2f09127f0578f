"""Useful operations of the window's real prompt and output tokens
(``servebench.work.step_flops``) per wall-clock second over the card's
dense bf16 peak, in %."""

from servebench import work


def read(run):
    seg = run.main
    if not seg.steps:
        return None
    flops = sum(work.step_flops(run.model, s) for s in seg.steps)
    return 100.0 * flops / seg.wall_s / run.peaks["bf16_flops"]

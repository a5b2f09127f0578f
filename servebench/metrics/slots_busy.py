"""Mean share of the pool's slots that hold a request, over the window's
decode steps, in %."""


def read(run):
    steps = [s for s in run.main.steps if s["kind"] == "decode"]
    if not steps:
        return None
    return 100.0 * sum(len(s["live_ctx"]) for s in steps) / (len(steps) * run.slots)

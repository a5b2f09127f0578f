"""Share of the window's wall clock outside the engine's timed calls, in %."""


def read(run):
    seg = run.main
    if not seg.steps:
        return None
    return 100.0 * (1.0 - sum(s["dt"] for s in seg.steps) / seg.wall_s)

"""Share of the traced tail with nothing running on the device, in %."""


def read(run):
    t = run.device_trace
    if t is None:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])

"""Mean device time of the slot pool's decode graph replay, in ms: the CUDA
event pair the program's SI2 engine records around each replay, read from
its ``repro_torch.decode`` spans (``core.wall_log``) that start in the untraced
window.  None where the program keeps no such log or times no replay."""


def read(run):
    log = getattr(run.core, "wall_log", None)
    if log is None:
        return None
    t0 = int(run.window_open * 1e9)
    ns = [s.device_ns for s in log.spans(t0, t0 + int(run.main.wall_s * 1e9))
          if s.name == "repro_torch.decode" and s.device_ns >= 0]
    return sum(ns) / len(ns) / 1e6 if ns else None

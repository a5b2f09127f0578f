"""Share of the B = 1 admission prefills' time that the host spends
enqueueing their work, in %: over the program's ``repro_torch.prefill`` spans
(``core.wall_log``) that start in the untraced window, the sum of start to
``enqueued`` (the prefill and its argmax returned) over the sum of start to
the closing sync.  Near 100 % the host sets the prefill's pace."""


def read(run):
    log = getattr(run.core, "wall_log", None)
    if log is None:
        return None
    t0 = int(run.window_open * 1e9)
    spans = [s for s in log.spans(t0, t0 + int(run.main.wall_s * 1e9))
             if s.name == "repro_torch.prefill" and s.enqueued_ns >= 0]
    total = sum(s.end_ns - s.start_ns for s in spans)
    return 100.0 * sum(s.enqueued_ns - s.start_ns for s in spans) / total if total else None

"""Mean host time of a scheduler step outside the engine's timed calls, in
ms: over the program's ``repro_torch.step`` spans (``core.wall_log``) that start
in the untraced window, each one's duration less its ``repro_torch.prefill`` and
``repro_torch.decode`` descendants.  What is left is the drains, the slot
inserts, the token read, retirement and the policy's bookkeeping."""

ENGINE = ("repro_torch.prefill", "repro_torch.decode")


def read(run):
    log = getattr(run.core, "wall_log", None)
    if log is None:
        return None
    t0 = int(run.window_open * 1e9)
    t1 = t0 + int(run.main.wall_s * 1e9)
    spans = log.spans()
    by_seq = {s.seq: s for s in spans}
    self_ns = {s.seq: s.end_ns - s.start_ns for s in spans
               if s.name == "repro_torch.step" and t0 <= s.start_ns <= t1 and s.end_ns >= 0}
    for s in spans:
        if s.name in ENGINE:
            p = by_seq.get(s.parent)
            while p is not None and p.name != "repro_torch.step":
                p = by_seq.get(p.parent)
            if p is not None and p.seq in self_ns:
                self_ns[p.seq] -= s.end_ns - s.start_ns
    return sum(self_ns.values()) / len(self_ns) / 1e6 if self_ns else None

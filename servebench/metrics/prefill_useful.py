"""Share of the admission prefills' positions that hold prompt tokens, in %:
over the program's ``repro_torch.prefill`` spans (``core.wall_log``) that start
in the untraced window, the real prompt tokens over the power-of-two
bucket each prompt was padded to."""


def read(run):
    log = getattr(run.core, "wall_log", None)
    if log is None:
        return None
    t0 = int(run.window_open * 1e9)
    spans = [s for s in log.spans(t0, t0 + int(run.main.wall_s * 1e9))
             if s.name == "repro_torch.prefill" and s.bucket > 0]
    bucket = sum(s.bucket for s in spans)
    return 100.0 * sum(s.tokens for s in spans) / bucket if bucket else None

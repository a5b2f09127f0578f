"""Output tokens emitted in the window over its wall-clock seconds."""


def read(run):
    seg = run.main
    return seg.tokens / seg.wall_s if seg.tokens else None

"""The card's energy counter across the window over the tokens it emitted."""


def read(run):
    seg = run.main
    return seg.energy_j / seg.tokens if seg.tokens else None

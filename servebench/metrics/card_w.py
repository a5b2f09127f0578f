"""The card's mean draw over the traced run's unprofiled window: its energy
counter's joules over the wall-clock seconds."""


def read(run):
    seg = run.main
    return seg.energy_j / seg.wall_s if seg.wall_s > 0 else None

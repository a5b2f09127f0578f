"""The serving convention every kind's reference shares: a prompt is
zero-padded at its end to the next power of two, and the padded positions
are part of the context it is served with."""

from __future__ import annotations


def pad_length(n: int) -> int:
    """The next power of two at or above ``n``."""
    return 1 << (max(int(n), 1) - 1).bit_length()

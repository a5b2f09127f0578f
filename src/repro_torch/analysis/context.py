"""Per-file analysis context shared by every rule."""

from __future__ import annotations

import ast
import dataclasses
from typing import List


@dataclasses.dataclass
class FileContext:
    """One parsed source file plus the scoping facts rules key on."""

    path: str            # path as reported in findings (as given on the CLI)
    norm: str            # normalized posix path used for scope decisions
    tree: ast.AST
    lines: List[str]
    scope: str           # "sim" (simulator layers) | "driver" (bench/scripts)

    def is_file(self, suffix: str) -> bool:
        """True when this file IS the named module (posix suffix match)."""
        return self.norm.endswith(suffix)

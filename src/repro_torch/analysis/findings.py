"""Finding records and the ``# simlint: allow(<rule>)`` pragma machinery."""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, List, Set

# same-line or immediately-preceding-line suppression; several rules may be
# allowed at once: `# simlint: allow(wall-clock, id-key)`
_PRAGMA_RE = re.compile(r"#\s*simlint:\s*allow\(([\w\-*,\s]+)\)")


@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule violation at one source location."""

    path: str
    line: int
    col: int
    rule: str
    message: str

    def render(self) -> str:
        return f"{self.path}:{self.line}:{self.col}: [{self.rule}] " \
               f"{self.message}"

    @property
    def key(self) -> str:
        """Stable identity used by the baseline suppress list."""
        return f"{self.path}:{self.line}:{self.rule}"


def pragma_lines(source: str) -> Dict[int, Set[str]]:
    """Map 1-based line number -> set of rule ids allowed on that line."""
    out: Dict[int, Set[str]] = {}
    for i, text in enumerate(source.splitlines(), start=1):
        m = _PRAGMA_RE.search(text)
        if m:
            out[i] = {r.strip() for r in m.group(1).split(",") if r.strip()}
    return out


def suppress(findings: List[Finding],
             pragmas: Dict[int, Set[str]]) -> List[Finding]:
    """Drop findings allowed by a pragma on their own or the previous line."""
    kept = []
    for f in findings:
        allowed = pragmas.get(f.line, set()) | pragmas.get(f.line - 1, set())
        if f.rule in allowed or "*" in allowed:
            continue
        kept.append(f)
    return kept

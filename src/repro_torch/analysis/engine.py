"""File discovery, scoping, pragma suppression and baseline filtering."""

from __future__ import annotations

import ast
import json
import os
from typing import Iterable, List, Optional, Set, Tuple

from repro_torch.analysis.context import FileContext
from repro_torch.analysis.findings import Finding, pragma_lines, suppress
from repro_torch.analysis.rules import run_rules

# path fragments (posix) that put a file in the simulator scope
_SIM_FRAGMENTS = ("repro_torch/serving/", "repro_torch/carbon/",
                  "repro_torch/workload/", "repro_torch/energy/")
# the port's drivers: the card's smoke script and the port's scripts
_DRIVER_FRAGMENTS = ("/chip_smoke.py", "/scripts/torch_")


def _norm(path: str) -> str:
    return os.path.abspath(path).replace(os.sep, "/")


def classify(path: str) -> Optional[str]:
    """``"sim"`` / ``"driver"`` / ``None`` (out of scope: models, kernels,
    training, launch — virtual-time invariants don't apply there)."""
    norm = _norm(path)
    if any(f in norm for f in _SIM_FRAGMENTS):
        return "sim"
    if norm.endswith(_DRIVER_FRAGMENTS[0]) or _DRIVER_FRAGMENTS[1] in norm:
        return "driver"
    return None


def discover(paths: Iterable[str]) -> List[str]:
    """Expand files/directories into a sorted list of .py files."""
    out: Set[str] = set()
    for p in paths:
        if os.path.isfile(p):
            out.add(p)
        elif os.path.isdir(p):
            for root, dirs, files in os.walk(p):
                dirs[:] = sorted(d for d in dirs
                                 if d not in ("__pycache__", ".git"))
                for f in sorted(files):
                    if f.endswith(".py"):
                        out.add(os.path.join(root, f))
        else:
            raise FileNotFoundError(p)
    return sorted(out)


def lint_source(source: str, path: str,
                scope: Optional[str] = None) -> List[Finding]:
    """Lint one in-memory source blob (the unit the tests drive).

    ``scope`` defaults to what :func:`classify` infers from ``path``; pass
    ``"sim"``/``"driver"`` explicitly to lint a blob under a synthetic name.
    """
    scope = scope if scope is not None else classify(path)
    if scope is None:
        return []
    tree = ast.parse(source, filename=path)
    ctx = FileContext(path=path, norm=_norm(path), tree=tree,
                      lines=source.splitlines(), scope=scope)
    findings = run_rules(ctx)
    findings = suppress(findings, pragma_lines(source))
    return sorted(findings, key=lambda f: (f.path, f.line, f.col, f.rule))


def lint_paths(paths: Iterable[str],
               baseline: Optional[Set[str]] = None
               ) -> Tuple[List[Finding], int]:
    """Lint files/trees; returns (findings, files_scanned).

    ``baseline`` is a set of :attr:`Finding.key` strings to suppress —
    the escape hatch for adopting the linter on a dirty tree.  This repo
    ships with an EMPTY baseline: every sanctioned site is annotated
    in-line instead, so the baseline never rots.
    """
    findings: List[Finding] = []
    scanned = 0
    for path in discover(paths):
        if classify(path) is None:
            continue
        scanned += 1
        with open(path, encoding="utf-8") as fh:
            source = fh.read()
        findings.extend(lint_source(source, path))
    if baseline:
        findings = [f for f in findings if f.key not in baseline]
    return findings, scanned


def load_baseline(path: str) -> Set[str]:
    with open(path, encoding="utf-8") as fh:
        data = json.load(fh)
    if not isinstance(data, list) or not all(isinstance(k, str)
                                             for k in data):
        raise ValueError(f"baseline {path} must be a JSON list of "
                         "'path:line:rule' keys")
    return set(data)


def write_baseline(path: str, findings: List[Finding]) -> None:
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(sorted(f.key for f in findings), fh, indent=2)
        fh.write("\n")

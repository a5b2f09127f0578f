"""CLI: ``python -m repro_torch.analysis [--strict] [paths...]``.

Exit codes: 0 clean (or report-only mode), 1 findings under ``--strict``,
2 usage / IO errors.  Default paths are the port's linted surfaces
(``src/repro_torch``, ``chip_smoke.py``, ``scripts/torch_*.py``) resolved
from the current directory, so a test and a bare local run agree.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
from typing import List, Optional

from repro_torch.analysis.engine import (
    lint_paths,
    load_baseline,
    write_baseline,
)
from repro_torch.analysis.rules import RULE_IDS

_DEFAULT_PATHS = ("src/repro_torch", "chip_smoke.py", "scripts/torch_*.py")


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="simlint: static invariant analysis for the "
                    "green-serving simulator (stdlib ast only)")
    parser.add_argument("paths", nargs="*",
                        help="files/directories to lint (default: "
                             + ", ".join(_DEFAULT_PATHS) + ")")
    parser.add_argument("--strict", action="store_true",
                        help="exit non-zero when any finding survives "
                             "pragmas and the baseline (the CI mode)")
    parser.add_argument("--baseline", metavar="FILE",
                        help="JSON list of finding keys to suppress")
    parser.add_argument("--write-baseline", metavar="FILE",
                        help="write surviving findings as a baseline "
                             "and exit 0")
    parser.add_argument("--list-rules", action="store_true",
                        help="print the rule catalog and exit")
    args = parser.parse_args(argv)

    if args.list_rules:
        for rule in RULE_IDS:
            print(rule)
        return 0

    paths = args.paths or sorted(p for pattern in _DEFAULT_PATHS
                                 for p in glob.glob(pattern) if os.path.exists(p))
    if not paths:
        print("simlint: no lintable paths found (run from the repo root "
              "or pass paths)", file=sys.stderr)
        return 2

    baseline = set()
    if args.baseline:
        try:
            baseline = load_baseline(args.baseline)
        except (OSError, ValueError, json.JSONDecodeError) as e:
            print(f"simlint: bad baseline: {e}", file=sys.stderr)
            return 2

    try:
        findings, scanned = lint_paths(paths, baseline=baseline)
    except (FileNotFoundError, SyntaxError) as e:
        print(f"simlint: {e}", file=sys.stderr)
        return 2

    if args.write_baseline:
        write_baseline(args.write_baseline, findings)
        print(f"simlint: wrote {len(findings)} baseline entr"
              f"{'y' if len(findings) == 1 else 'ies'} to "
              f"{args.write_baseline}")
        return 0

    for f in findings:
        print(f.render())
    print(f"simlint: {len(findings)} finding(s) in {scanned} file(s) "
          f"scanned" + (f" ({len(baseline)} baseline suppressions)"
                        if baseline else ""))
    if findings and args.strict:
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""CLI: ``python -m repro_torch.analysis [--strict] [paths...]``.

Exit status 0 when every finding is suppressed (with a written
justification under ``--strict``), 1 otherwise.  Prints each finding as
``path:line: RULE message`` plus a per-rule summary table (``--json``
for machine-readable output, ``--rules`` for the rules reference).
"""
from __future__ import annotations

import argparse
import sys

from .core import render_json, render_report, render_rules, run_paths


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="Invariant-checking static analysis of the port "
                    "(host syncs on the card's hot paths, frozen routing, "
                    "cache keys, determinism, kernel parity, replay "
                    "purity, snapshot safety).")
    ap.add_argument("paths", nargs="*", default=["src/repro_torch"],
                    help="files or directories to scan (default: "
                    "src/repro_torch)")
    ap.add_argument("--strict", action="store_true",
                    help="suppressions must carry a written justification "
                    "and must still silence something (SUP001/SUP002)")
    ap.add_argument("--tests", default=None,
                    help="the port's tests for the kernel registry: a "
                    "directory holding test_torch_*.py, or one file "
                    "(default: auto-discover tests/)")
    ap.add_argument("--select", default=None, metavar="PREFIXES",
                    help="comma-separated rule-id prefixes to activate "
                    "(e.g. TH,CK,SUP); default: all rules")
    ap.add_argument("--exclude", action="append", default=[],
                    metavar="SUBSTR",
                    help="skip files whose path contains this substring "
                    "(repeatable; e.g. tests/fixtures)")
    ap.add_argument("--json", action="store_true",
                    help="emit machine-readable JSON findings for CI "
                    "annotation instead of the text report")
    ap.add_argument("--rules", action="store_true",
                    help="print the generated rules reference and exit")
    args = ap.parse_args(argv)
    if args.rules:
        print(render_rules())
        return 0
    select = ([p.strip() for p in args.select.split(",") if p.strip()]
              if args.select else None)
    result = run_paths(args.paths, strict=args.strict, tests_dir=args.tests,
                       select=select, exclude=args.exclude)
    print(render_json(result) if args.json else render_report(result))
    return 0 if result.ok else 1


if __name__ == "__main__":
    sys.exit(main())

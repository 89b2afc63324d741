"""``python -m kmeans_tpu_torch lint [--json] [paths...]`` — run the
invariant linter (the counterpart of ``kmeans_tpu/analysis/cli.py``).

Exit codes: 0 clean, 2 on findings or a malformed path.  ``--json``
prints the machine-readable report (findings + rule counts + the full
suppression inventory, so suppression-count regressions are reviewable
in CI diffs).  Default target: the installed ``kmeans_tpu_torch``
package directory, found from this file's location: the package is not
imported, so a lint creates no CUDA context and loads no kernel library.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path


def _default_target() -> str:
    return str(Path(__file__).resolve().parent.parent)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m kmeans_tpu_torch lint",
        description="AST invariant linter: trace/cache/dispatch/thread "
                    "discipline over the package (one rule per "
                    "historical incident class; see docs/ANALYSIS.md)")
    parser.add_argument("paths", nargs="*",
                        help="files or directories to lint (default: "
                             "the kmeans_tpu_torch package)")
    parser.add_argument("--json", action="store_true",
                        help="machine-readable report on stdout")
    parser.add_argument("--rule", action="append", default=None,
                        metavar="RULE-ID",
                        help="run only this rule (repeatable)")
    args = parser.parse_args(argv)

    from kmeans_tpu_torch.analysis import RULES, lint_paths
    if args.rule:
        unknown = [r for r in args.rule if r not in RULES]
        if unknown:
            print(f"error: unknown rule id(s) {unknown}; known: "
                  f"{sorted(RULES)}", file=sys.stderr)
            return 2
    paths = args.paths or [_default_target()]
    try:
        report = lint_paths(paths, rules=args.rule)
    except (FileNotFoundError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    except SyntaxError as e:
        print(f"error: cannot parse {e.filename}:{e.lineno}: {e.msg}",
              file=sys.stderr)
        return 2

    if args.json:
        print(json.dumps(report.to_json(), indent=2, default=str))
    else:
        for f in report.findings:
            print(f.format())
        active = sum(1 for s in report.suppressions if s.used)
        print(f"lint: {len(report.findings)} finding"
              f"{'' if len(report.findings) == 1 else 's'} over "
              f"{report.files} files ({report.suppressed} suppressed "
              f"by {active} of {len(report.suppressions)} "
              f"suppressions)",
              file=sys.stderr if report.findings else sys.stdout)
    return 2 if report.findings else 0


if __name__ == "__main__":       # pragma: no cover
    sys.exit(main())

"""CLI entry point: ``python -m repro_torch.lint [paths...]``.

Exit status is 0 when every finding is suppressed (or none exist) and 1
otherwise.  ``--format json`` emits the machine report (also written via
``--output``); the default text format prints ``path:line: RULE message
[hint]`` per finding.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

from . import RULES, load_context, render_json, render_text, run


def _find_root(start: Path) -> Path:
    """The repo root: nearest ancestor holding ``src/repro_torch``.  Falls
    back to this package's own checkout when run from elsewhere."""
    for cand in (start, *start.parents):
        if (cand / "src" / "repro_torch").is_dir():
            return cand
    return Path(__file__).resolve().parents[3]


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.lint",
        description="Minos contract checker for the PyTorch port "
                    "(rules: --list-rules; policy: repro_torch.lint."
                    "contracts)")
    parser.add_argument(
        "paths", nargs="*", type=Path,
        help="files to lint (default: the port's tree — src/repro_torch, "
             "tests/test_torch_*.py, examples/*_torch.py, chip_smoke.py, "
             "tools; tests/lint_fixtures excluded)")
    parser.add_argument("--root", type=Path, default=None,
                        help="repo root (default: auto-detected)")
    parser.add_argument("--format", choices=("text", "json"),
                        default="text")
    parser.add_argument("--output", type=Path, default=None,
                        help="also write the JSON report to this path")
    parser.add_argument("--select", default=None,
                        help="comma-separated rule ids to keep "
                             "(e.g. W101,W401)")
    parser.add_argument("--list-rules", action="store_true",
                        help="print the rule catalogue and exit")
    args = parser.parse_args(argv)

    if args.list_rules:
        for rule in sorted(RULES):
            print(f"{rule}  {RULES[rule]}")
        return 0

    root = (args.root or _find_root(Path.cwd())).resolve()
    select = ({r.strip() for r in args.select.split(",") if r.strip()}
              if args.select else None)
    ctx = load_context(root, list(args.paths) or None)
    findings = run(ctx, select=select)

    if args.output is not None:
        args.output.parent.mkdir(parents=True, exist_ok=True)
        args.output.write_text(render_json(findings, root=str(root))
                               + "\n")
    if args.format == "json":
        print(render_json(findings, root=str(root)))
    else:
        print(render_text(findings))

    return 1 if any(not f.suppressed for f in findings) else 0


if __name__ == "__main__":
    sys.exit(main())

"""minoslint core: source loading, suppressions, pass runner, report.

The lint suite is pure-stdlib ``ast`` analysis — no runtime imports of the
code under audit, so it runs before any heavy dependency loads (torch
included).  A *pass* is a callable ``(LintContext) -> list[Finding]``; the
runner concatenates pass output, applies inline suppressions, and renders
either a human ``path:line`` listing or the JSON report.

The policy a pass applies comes from the context's *contracts* module
(``LintContext.contracts``): the port's own (:mod:`.contracts`) by
default, or any module with the same names — the reference's policy for
the reference's tree, say, with ``ROOT_PACKAGE = "repro"``.

Two inline pragmas are recognized (comment anywhere on a line):

``# minoslint: disable=W101,W304``
    suppress those rules on this line.  Suppressed findings still appear
    in the report (counted separately) so suppressions stay auditable.

``# minoslint: path=src/repro_torch/fleet/controller.py``
    override the file's *effective* repo-relative path (first 5 lines
    only).  Test fixtures use this to opt into a scoped rule — e.g. a
    snippet that pretends to live in ``pipeline/`` so the determinism
    pass applies — without polluting the real tree.
"""
from __future__ import annotations

import ast
import json
import re
from dataclasses import dataclass
from pathlib import Path

from . import contracts as _port_contracts

_DISABLE_RE = re.compile(r"#\s*minoslint:\s*disable=([A-Z0-9,\s]+)")
_PATH_RE = re.compile(r"#\s*minoslint:\s*path=(\S+)")


@dataclass
class Finding:
    """One rule violation at ``path:line``."""

    rule: str
    path: str
    line: int
    message: str
    hint: str = ""
    suppressed: bool = False

    def sort_key(self):
        return (self.path, self.line, self.rule, self.message)

    def to_dict(self) -> dict:
        return {"rule": self.rule, "path": self.path, "line": self.line,
                "message": self.message, "hint": self.hint}

    def render(self) -> str:
        sup = " [suppressed]" if self.suppressed else ""
        hint = f"  [{self.hint}]" if self.hint else ""
        return f"{self.path}:{self.line}: {self.rule}{sup} {self.message}{hint}"


class SourceFile:
    """A parsed source file plus its pragma state.

    ``path`` is the *effective* repo-relative posix path (after any
    ``minoslint: path=`` override) — all scope matching and reporting key
    on it.  ``real_path`` is where the bytes actually live.
    """

    def __init__(self, path: str, text: str, real_path: str | None = None):
        self.real_path = real_path or path
        self.text = text
        self.lines = text.splitlines()
        self.suppressions: dict[int, set[str]] = {}
        for n, line in enumerate(self.lines, start=1):
            m = _DISABLE_RE.search(line)
            if m:
                rules = {r.strip() for r in m.group(1).split(",") if r.strip()}
                self.suppressions.setdefault(n, set()).update(rules)
        eff = path
        for line in self.lines[:5]:
            m = _PATH_RE.search(line)
            if m:
                eff = m.group(1)
                break
        self.path = Path(eff).as_posix()
        self.parse_error: SyntaxError | None = None
        try:
            self.tree: ast.AST | None = ast.parse(text)
        except SyntaxError as exc:  # surfaced as a finding by the runner
            self.tree = None
            self.parse_error = exc

    # -- scope helpers ---------------------------------------------------
    @property
    def module(self) -> str | None:
        """Dotted module name when the file lives under ``src/`` (the
        effective path decides), e.g. ``repro_torch.fleet.controller``."""
        parts = Path(self.path).parts
        if len(parts) >= 2 and parts[0] == "src":
            mod = list(parts[1:])
            mod[-1] = mod[-1][:-3] if mod[-1].endswith(".py") else mod[-1]
            if mod[-1] == "__init__":
                mod = mod[:-1]
            return ".".join(mod)
        return None

    def package_in(self, root: str) -> str | None:
        """Top-level package under ``root`` (``fleet``, ``store``, ...);
        top-level modules report their own name (``legacy``, ``device``),
        the root's ``__init__`` the root itself."""
        mod = self.module
        if mod is None:
            return None
        parts = mod.split(".")
        if parts[0] != root:
            return None
        return parts[1] if len(parts) > 1 else parts[0]

    @property
    def package(self) -> str | None:
        """Top-level package under ``repro_torch``."""
        return self.package_in(_port_contracts.ROOT_PACKAGE)

    def in_dir(self, *prefixes: str) -> bool:
        return any(self.path.startswith(p) for p in prefixes)


class LintContext:
    """Everything a pass may look at: the parsed files, the contracts they
    are held to, and the repo root (for messages only — passes never touch
    the filesystem)."""

    def __init__(self, files: list[SourceFile], root: str = ".",
                 contracts=None):
        self.files = files
        self.root = root
        self.contracts = contracts if contracts is not None \
            else _port_contracts
        self.by_path = {f.path: f for f in files}

    @property
    def root_package(self) -> str:
        return self.contracts.ROOT_PACKAGE

    def package(self, sf: SourceFile) -> str | None:
        return sf.package_in(self.root_package)

    def under(self, *prefixes: str) -> list[SourceFile]:
        return [f for f in self.files if f.in_dir(*prefixes)]

    def in_src(self) -> list[SourceFile]:
        """Parsed files of the root package (``src/<root>/``)."""
        prefix = f"src/{self.root_package}/"
        return [f for f in self.files
                if f.path.startswith(prefix) and f.tree is not None]


# -- file discovery ------------------------------------------------------

#: what the default (no-argument) run scans, relative to the root: the
#: port's package, its tests, its examples, ``chip_smoke.py`` and the
#: chip tools.  Directories are scanned recursively; the rest are globs.
DEFAULT_SCAN = ("src/repro_torch", "tests/test_torch_*.py",
                "examples/*_torch.py", "chip_smoke.py", "tools")

#: subtrees never scanned by default: fixtures are *intentionally* bad.
EXCLUDED_DIRS = ("tests/lint_fixtures",)


def discover_files(root: Path) -> list[Path]:
    out: list[Path] = []
    for pattern in DEFAULT_SCAN:
        base = root / pattern
        found = sorted(base.rglob("*.py")) if base.is_dir() \
            else sorted(root.glob(pattern))
        for p in found:
            rel = p.relative_to(root).as_posix()
            if "__pycache__" in rel:
                continue
            if any(rel == ex or rel.startswith(ex + "/")
                   for ex in EXCLUDED_DIRS):
                continue
            out.append(p)
    return out


def load_context(root: Path, paths: list[Path] | None = None,
                 contracts=None) -> LintContext:
    """The files at ``paths`` (default: the port's tree, ``DEFAULT_SCAN``)
    under ``contracts`` (default: the port's)."""
    targets = paths if paths else discover_files(root)
    files = []
    for p in targets:
        p = p.resolve()
        try:
            rel = p.relative_to(root.resolve()).as_posix()
        except ValueError:
            rel = p.as_posix()
        files.append(SourceFile(rel, p.read_text(), real_path=str(p)))
    return LintContext(files, root=str(root), contracts=contracts)


# -- runner --------------------------------------------------------------

def run(ctx: LintContext, select: set[str] | None = None) -> list[Finding]:
    """Run every registered pass, apply suppressions, return sorted
    findings (suppressed ones included, flagged)."""
    from . import PASSES
    findings: list[Finding] = []
    for f in ctx.files:
        if f.parse_error is not None:
            findings.append(Finding(
                "E000", f.path, f.parse_error.lineno or 1,
                f"syntax error: {f.parse_error.msg}"))
    for run_pass in PASSES:
        findings.extend(run_pass(ctx))
    for f in findings:
        sf = ctx.by_path.get(f.path)
        if sf is not None and f.rule in sf.suppressions.get(f.line, set()):
            f.suppressed = True
    if select:
        findings = [f for f in findings if f.rule in select]
    findings.sort(key=Finding.sort_key)
    return findings


def report_dict(findings: list[Finding], root: str = ".") -> dict:
    active = [f for f in findings if not f.suppressed]
    suppressed = [f for f in findings if f.suppressed]
    by_rule: dict[str, int] = {}
    for f in active:
        by_rule[f.rule] = by_rule.get(f.rule, 0) + 1
    return {
        "version": 1,
        "root": root,
        "ok": not active,
        "counts": {"findings": len(active), "suppressed": len(suppressed),
                   "by_rule": by_rule},
        "findings": [f.to_dict() for f in active],
        "suppressed": [f.to_dict() for f in suppressed],
    }


def render_text(findings: list[Finding]) -> str:
    lines = [f.render() for f in findings]
    active = sum(1 for f in findings if not f.suppressed)
    suppressed = len(findings) - active
    lines.append(f"minoslint: {active} finding(s), {suppressed} suppressed")
    return "\n".join(lines)


def render_json(findings: list[Finding], root: str = ".") -> str:
    return json.dumps(report_dict(findings, root=root), indent=2,
                      sort_keys=True)

"""W201/W202/W203 · journal-record exhaustiveness.

The write-ahead journal only buys crash-safety if every record kind that
can land in ``journal.jsonl`` is (a) registered in the canonical
``store/kinds.py`` registry and (b) consumed by the resume dispatch
(``MinosSession._apply_record``) — an emitted-but-unhandled kind is state
that silently evaporates on resume, and a handled-but-never-emitted kind
is dead replay code hiding a retired (or misspelled) emitter.

The pass is fully static: it resolves ``kinds.X`` constants against the
registry module's ``NAME = "literal"`` assignments, collects every emit
site (``self._journal(<kind>, ...)`` / ``<store>.record(<kind>, ...)``
with a resolvable first argument) under the root package's
``src/repro_torch/``, and reads the handled set out of the dispatch
function's ``match`` statement (``MatchOr`` patterns flattened).  Cross-checks:

* **W201** — kind emitted somewhere but absent from the dispatch;
* **W202** — dispatch ``case`` (or registry entry) for a kind nothing
  emits;
* **W203** — emit site whose kind is not in the registry at all.
"""
from __future__ import annotations

import ast

from .core import Finding, LintContext

RULES = {
    "W201": "record kind emitted but not handled by the resume dispatch",
    "W202": "dead record-kind handler (or registered kind) nothing emits",
    "W203": "emitted record kind missing from the kinds registry",
}


def _load_registry(sf) -> dict[str, tuple[str, int]]:
    """``CONST -> (value, lineno)`` from module-level string assignments."""
    reg: dict[str, tuple[str, int]] = {}
    if sf.tree is None:
        return reg
    for node in sf.tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name) \
                and isinstance(node.value, ast.Constant) \
                and isinstance(node.value.value, str):
            reg[node.targets[0].id] = (node.value.value, node.lineno)
    return reg


def _find_registry(ctx: LintContext):
    sf = ctx.by_path.get(ctx.contracts.KINDS_REGISTRY)
    if sf is not None:
        return sf
    for f in ctx.in_src():
        if any(isinstance(n, ast.Assign)
               and any(isinstance(t, ast.Name) and t.id == "ALL_KINDS"
                       for t in n.targets)
               for n in f.tree.body):
            return f
    return None


def _kind_of_arg(arg: ast.AST, registry: dict) -> tuple[str | None, bool]:
    """Resolve an emit site's first argument to a kind value.

    Returns ``(value, known)``: ``known`` is False for dynamic arguments
    (plain variables) the pass cannot resolve and must skip."""
    if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
        return arg.value, True
    if isinstance(arg, ast.Attribute):
        if arg.attr in registry:
            return registry[arg.attr][0], True
        # kinds.X where X is not a registered constant
        recv = arg.value
        if isinstance(recv, ast.Name) and recv.id == "kinds":
            return arg.attr, True
    return None, False


def _emit_sites(ctx: LintContext, registry: dict):
    """Yield ``(kind, path, lineno)`` for every resolvable emit site."""
    for sf in ctx.in_src():
        for node in ast.walk(sf.tree):
            if not isinstance(node, ast.Call) or not node.args:
                continue
            fn = node.func
            if not isinstance(fn, ast.Attribute):
                continue
            if fn.attr not in ("_journal", "record"):
                continue
            if fn.attr == "_journal" and not (
                    isinstance(fn.value, ast.Name)
                    and fn.value.id == "self"):
                continue
            kind, known = _kind_of_arg(node.args[0], registry)
            if known:
                yield kind, sf.path, node.args[0].lineno


def _match_values(pattern: ast.pattern, registry: dict):
    """Kind values named by one ``case`` pattern (Or-patterns flattened)."""
    if isinstance(pattern, ast.MatchOr):
        for p in pattern.patterns:
            yield from _match_values(p, registry)
    elif isinstance(pattern, ast.MatchValue):
        v = pattern.value
        if isinstance(v, ast.Constant) and isinstance(v.value, str):
            yield v.value, pattern.value.lineno
        elif isinstance(v, ast.Attribute) and v.attr in registry:
            yield registry[v.attr][0], v.lineno
        elif isinstance(v, ast.Attribute):
            yield v.attr, v.lineno


def _dispatch_handlers(ctx: LintContext, registry: dict):
    """``kind -> (path, lineno)`` handled by the resume dispatch, plus the
    dispatch location itself (None when no dispatch exists in context)."""
    for sf in ctx.in_src():
        for node in ast.walk(sf.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    and node.name == ctx.contracts.DISPATCH_FUNC:
                handled: dict[str, tuple[str, int]] = {}
                for sub in ast.walk(node):
                    if isinstance(sub, ast.Match):
                        for case in sub.cases:
                            for value, lineno in _match_values(
                                    case.pattern, registry):
                                handled.setdefault(value,
                                                   (sf.path, lineno))
                return handled, (sf.path, node.lineno)
    return None, None


def run_pass(ctx: LintContext) -> list[Finding]:
    findings: list[Finding] = []
    dispatch = ctx.contracts.DISPATCH_FUNC
    reg_file = _find_registry(ctx)
    registry = _load_registry(reg_file) if reg_file is not None else {}
    registered = {v for v, _ in registry.values()}

    emitted: dict[str, tuple[str, int]] = {}
    for kind, path, lineno in _emit_sites(ctx, registry):
        emitted.setdefault(kind, (path, lineno))
        if reg_file is not None and kind not in registered:
            findings.append(Finding(
                "W203", path, lineno,
                f"record kind {kind!r} is not in the kinds registry "
                f"({reg_file.path})",
                hint="add a constant to store/kinds.py (wire format: add, "
                     "never rename) and emit that constant"))

    handled, dispatch_loc = _dispatch_handlers(ctx, registry)
    if handled is None:
        return findings  # no dispatch in scope: registry checks only

    for kind, (path, lineno) in sorted(emitted.items()):
        if kind not in handled:
            findings.append(Finding(
                "W201", path, lineno,
                f"record kind {kind!r} is emitted here but "
                f"{dispatch} never handles it — the record "
                f"is silently dropped on resume",
                hint=f"add a `case` for it in {dispatch} "
                     f"or register it as a marker kind"))
    for kind, (path, lineno) in sorted(handled.items()):
        if kind not in emitted:
            findings.append(Finding(
                "W202", path, lineno,
                f"{dispatch} handles record kind {kind!r} "
                f"but no emit site produces it",
                hint="delete the dead handler or restore the lost "
                     "emitter"))
    if reg_file is not None:
        for const, (value, lineno) in sorted(registry.items()):
            if value not in emitted and value not in handled:
                findings.append(Finding(
                    "W202", reg_file.path, lineno,
                    f"registered record kind {value!r} ({const}) is "
                    f"neither emitted nor handled",
                    hint="remove the constant or wire up its emitter and "
                         "handler"))
    return findings

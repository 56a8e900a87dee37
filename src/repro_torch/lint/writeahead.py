"""W101 · write-ahead discipline.

In the port's journaled mutators (fleet controller, session facade,
discovery controller, store), every mutation of instance state must be
*dominated* by a journal call in the same method: on every control-flow
path reaching the mutation, a ``self._journal(...)`` / ``<store>.record(...)`` /
``<journal>.append(...)`` call (or a delegate that journals internally)
has already executed.  That is the crash-safety contract — a crash
between the record landing and the mutation replays the record; a crash
the other way round silently loses state.

Dominance is computed by a conservative walk over structured control
flow:

* statements in sequence: a journal call turns the flag on for everything
  after it;
* ``if``/``else``: the flag holds after the statement only when *both*
  branches (or the code before) set it — except the store-presence guard
  ``if self._store is not None: ... record ...``, which counts as
  dominating because a ``None`` store is the inert-by-default mode with
  nothing to journal;
* loop bodies see the flag from before the loop, and the loop contributes
  nothing afterwards (the body may run zero times);
* ``try`` bodies likewise contribute nothing afterwards (any statement
  may raise).

Scope is auto-detected: only classes containing at least one journal call
are audited, so value/codec classes in the same files are skipped.  The
allowlists of the context's contracts (:mod:`.contracts` by default)
exempt derived caches (rebuilt by replay) and the apply-halves replay
itself calls.
"""
from __future__ import annotations

import ast

from .core import Finding, LintContext

RULES = {"W101": "state mutation not dominated by a write-ahead journal call"}

_MUTATOR_METHODS = frozenset({
    "append", "appendleft", "add", "insert", "extend", "update", "pop",
    "popleft", "popitem", "remove", "discard", "clear", "setdefault",
})


def _self_attr(node: ast.AST) -> str | None:
    """``self.<attr>`` -> attr name, else None."""
    if (isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name)
            and node.value.id == "self"):
        return node.attr
    return None


def is_journal_call(node: ast.AST,
                    delegates: frozenset = frozenset()) -> bool:
    """True for the calls the write-ahead contract recognizes as 'the
    record is durable now': ``self._journal(...)``, ``<x>.record(...)``,
    ``<x>.append(...)``/``<x>.write(...)`` where ``x`` names a journal,
    and journal-delegating calls ``self._fleet.<delegate>(...)`` (the
    names in ``delegates``, the contracts' ``JOURNAL_DELEGATES``)."""
    if not isinstance(node, ast.Call):
        return False
    fn = node.func
    if not isinstance(fn, ast.Attribute):
        return False
    if fn.attr == "_journal" and isinstance(fn.value, ast.Name) \
            and fn.value.id == "self":
        return True
    if fn.attr == "record":
        # a *kind* argument distinguishes SessionStore.record(kind, ...)
        # from the zero-arg .record() codec serializers
        return bool(node.args)
    if fn.attr in ("append", "write"):
        # only when the receiver is journal-named: self.journal.append(...)
        recv = fn.value
        name = recv.attr if isinstance(recv, ast.Attribute) else (
            recv.id if isinstance(recv, ast.Name) else "")
        return "journal" in name
    if fn.attr in delegates:
        recv = _self_attr(fn.value)
        if recv in ("_fleet", "fleet", "_discovery"):
            return True
    return False


def _contains_journal_call(node: ast.AST, delegates: frozenset) -> bool:
    return any(is_journal_call(n, delegates) for n in ast.walk(node))


def _is_store_guard(test: ast.AST) -> bool:
    """``self._store is not None`` (or any store/journal-named presence
    check): the inert-by-default gate around record calls."""
    def _names_store(expr: ast.AST) -> bool:
        for n in ast.walk(expr):
            label = None
            if isinstance(n, ast.Attribute):
                label = n.attr
            elif isinstance(n, ast.Name):
                label = n.id
            if label and ("store" in label or "journal" in label):
                return True
        return False
    return _names_store(test)


#: statement types scanned for mutations; compound statements are
#: excluded — the dominance walk recurses into their bodies itself.
_SIMPLE_STMTS = (ast.Assign, ast.AugAssign, ast.AnnAssign, ast.Expr,
                 ast.Delete, ast.Return, ast.Raise, ast.Assert)


def _mutations(stmt: ast.stmt, delegates: frozenset):
    """Yield ``(attr, lineno, what)`` for instance-state mutations rooted
    at this single simple statement."""
    if not isinstance(stmt, _SIMPLE_STMTS):
        return
    if isinstance(stmt, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
        targets = stmt.targets if isinstance(stmt, ast.Assign) \
            else [stmt.target]
        for t in targets:
            attr = _self_attr(t)
            if attr is not None:
                yield attr, t.lineno, f"assignment to self.{attr}"
            elif isinstance(t, ast.Subscript):
                attr = _self_attr(t.value)
                if attr is not None:
                    yield attr, t.lineno, f"item write into self.{attr}"
            elif isinstance(t, (ast.Tuple, ast.List)):
                for el in t.elts:
                    a = _self_attr(el)
                    if a is not None:
                        yield a, el.lineno, f"assignment to self.{a}"
    elif isinstance(stmt, ast.Delete):
        for t in stmt.targets:
            if isinstance(t, ast.Subscript):
                attr = _self_attr(t.value)
                if attr is not None:
                    yield attr, t.lineno, f"item delete from self.{attr}"
    # mutator method calls anywhere in the statement's expressions —
    # catches `job = self.jobs.pop(id)` as well as bare `self.x.add(...)`
    for node in ast.walk(stmt):
        if isinstance(node, ast.Call) \
                and not is_journal_call(node, delegates):
            fn = node.func
            if isinstance(fn, ast.Attribute) \
                    and fn.attr in _MUTATOR_METHODS:
                attr = _self_attr(fn.value)
                if attr is not None:
                    yield attr, node.lineno, \
                        f"self.{attr}.{fn.attr}(...) mutation"


class _DominanceWalker:
    def __init__(self, path: str, contracts):
        self.path = path
        self.delegates = contracts.JOURNAL_DELEGATES
        self.derived = contracts.DERIVED_ATTRS
        self.findings: list[Finding] = []

    def walk(self, body: list[ast.stmt], journaled: bool) -> bool:
        """Process a statement sequence; return whether a journal call
        dominates the exit of the sequence."""
        for stmt in body:
            if not journaled:
                for attr, lineno, what in _mutations(stmt, self.delegates):
                    if attr in self.derived:
                        continue
                    self.findings.append(Finding(
                        "W101", self.path, lineno,
                        f"{what} is not preceded by a journal call on "
                        f"every path through this method",
                        hint="journal the causing record first, route "
                             "through a *_apply method, or add the attr "
                             "to DERIVED_ATTRS with a justification"))
            journaled = self._step(stmt, journaled)
        return journaled

    def _step(self, stmt: ast.stmt, journaled: bool) -> bool:
        if isinstance(stmt, ast.If):
            then_j = self.walk(stmt.body, journaled)
            else_j = self.walk(stmt.orelse, journaled) if stmt.orelse \
                else journaled
            if stmt.orelse:
                return then_j and else_j
            # store-presence guard: `if self._store is not None: record`
            # dominates what follows — no store means nothing to journal.
            if then_j and _is_store_guard(stmt.test):
                return True
            return journaled
        if isinstance(stmt, (ast.For, ast.While)):
            self.walk(stmt.body, journaled)
            self.walk(stmt.orelse, journaled)
            return journaled
        if isinstance(stmt, ast.Try):
            self.walk(stmt.body, journaled)
            for handler in stmt.handlers:
                self.walk(handler.body, journaled)
            self.walk(stmt.orelse, journaled)
            final_j = self.walk(stmt.finalbody, journaled)
            return final_j if stmt.finalbody else journaled
        if isinstance(stmt, ast.With):
            return self.walk(stmt.body, journaled)
        if isinstance(stmt, ast.Match):
            arms = [self.walk(case.body, journaled) for case in stmt.cases]
            has_wildcard = any(
                isinstance(c.pattern, ast.MatchAs) and c.pattern.pattern
                is None for c in stmt.cases)
            if arms and has_wildcard and all(arms):
                return True
            return journaled
        # plain statement: does it itself journal?
        if _contains_journal_call(stmt, self.delegates):
            return True
        return journaled


def _journaled_classes(tree: ast.AST, delegates: frozenset):
    for node in ast.walk(tree):
        if isinstance(node, ast.ClassDef):
            if any(is_journal_call(n, delegates) for n in ast.walk(node)):
                yield node


def run_pass(ctx: LintContext) -> list[Finding]:
    findings: list[Finding] = []
    contracts = ctx.contracts
    for sf in ctx.under(*contracts.JOURNALED_FILES):
        if sf.tree is None:
            continue
        for cls in _journaled_classes(sf.tree, contracts.JOURNAL_DELEGATES):
            for meth in cls.body:
                if not isinstance(meth, (ast.FunctionDef,
                                         ast.AsyncFunctionDef)):
                    continue
                if meth.name.startswith("__"):
                    continue  # constructors/dunders build, not mutate
                if meth.name in contracts.APPLY_METHODS:
                    continue
                walker = _DominanceWalker(sf.path, contracts)
                walker.walk(meth.body, journaled=False)
                findings.extend(walker.findings)
    return findings

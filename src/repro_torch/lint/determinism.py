"""W301–W304 · determinism discipline.

The byte-identity pins (classification sha256, journal checksums, the
1e-9 reference agreements) only hold if the pinned packages are
*functions of their inputs*.  Four classic leaks are banned there:

* **W301** — wall-clock reads (``time.time``, ``datetime.now``,
  ``time.monotonic`` …): two runs of the same inputs produce different
  bytes.
* **W302** — unseeded randomness: module-level ``random.*`` /
  ``np.random.*`` globals and no-argument ``Random()`` /
  ``default_rng()`` constructions.  Seeded generator *objects* are fine —
  determinism requires the seed to flow in from the caller.
* **W303** — iterating a ``set`` expression straight into ordered output
  (``list(set(...))``, ``for x in {…}``): set order is hash-salt
  dependent across processes.  Wrap in ``sorted(...)``.
* **W304** — ``id(...)`` used as a container key: CPython re-uses
  addresses, so dict/set membership keyed on ``id()`` is run-dependent
  the moment an object dies.  Key on a stable identity instead.
"""
from __future__ import annotations

import ast

from .core import Finding, LintContext

RULES = {
    "W301": "wall-clock read in a byte-identity-pinned module",
    "W302": "unseeded random source in a byte-identity-pinned module",
    "W303": "set iteration feeding ordered output",
    "W304": "id()-keyed container in a byte-identity-pinned module",
}

_CLOCK_ATTRS = {
    "time": {"time", "time_ns", "monotonic", "monotonic_ns",
             "perf_counter", "perf_counter_ns"},
    "datetime": {"now", "utcnow", "today"},
    "date": {"today"},
}

_RANDOM_MODULES = ("random", "np.random", "numpy.random")


def _dotted(node: ast.AST) -> str | None:
    """``a.b.c`` attribute chain as a dotted string, else None."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _is_clock_call(call: ast.Call) -> bool:
    dotted = _dotted(call.func)
    if dotted is None:
        return False
    parts = dotted.split(".")
    if len(parts) < 2:
        return False
    base, attr = parts[-2], parts[-1]
    return attr in _CLOCK_ATTRS.get(base, ())


def _is_unseeded_random(call: ast.Call) -> bool:
    dotted = _dotted(call.func)
    if dotted is None:
        return False
    # global-state draws: random.random(), np.random.rand(), ...
    for mod in _RANDOM_MODULES:
        if dotted.startswith(mod + ".") and dotted != mod + ".Random" \
                and not dotted.endswith(".default_rng") \
                and not dotted.endswith(".seed") \
                and not dotted.endswith(".PRNGKey") \
                and not dotted.endswith(".Generator"):
            return True
    # generator construction without a seed argument
    tail = dotted.split(".")[-1]
    if tail in ("Random", "default_rng", "PRNGKey") and not call.args \
            and not call.keywords:
        return True
    return False


def _is_set_expr(node: ast.AST) -> bool:
    if isinstance(node, (ast.Set, ast.SetComp)):
        return True
    if isinstance(node, ast.Call) and isinstance(node.func, ast.Name) \
            and node.func.id in ("set", "frozenset"):
        return True
    return False


def _is_id_call(node: ast.AST) -> bool:
    return (isinstance(node, ast.Call)
            and isinstance(node.func, ast.Name) and node.func.id == "id")


def _contains_id_call(node: ast.AST) -> bool:
    return any(_is_id_call(n) for n in ast.walk(node))


def _scan_file(sf) -> list[Finding]:
    findings: list[Finding] = []

    def flag(rule: str, lineno: int, message: str, hint: str) -> None:
        findings.append(Finding(rule, sf.path, lineno, message, hint=hint))

    for node in ast.walk(sf.tree):
        if isinstance(node, ast.Call):
            if _is_clock_call(node):
                flag("W301", node.lineno,
                     f"wall-clock call `{_dotted(node.func)}(...)` in a "
                     f"byte-identity-pinned module",
                     "take the timestamp as a parameter (or journal it) "
                     "so replay reproduces identical bytes")
            elif _is_unseeded_random(node):
                flag("W302", node.lineno,
                     f"unseeded random source "
                     f"`{_dotted(node.func)}(...)`",
                     "thread an explicitly seeded generator through the "
                     "call instead of global RNG state")
            # list(set(...)) / tuple(set(...)) / enumerate(set(...))
            if isinstance(node.func, ast.Name) \
                    and node.func.id in ("list", "tuple", "enumerate") \
                    and node.args and _is_set_expr(node.args[0]):
                flag("W303", node.lineno,
                     f"`{node.func.id}()` over a set expression leaks "
                     f"hash order into ordered output",
                     "wrap the set in sorted(...) before ordering "
                     "matters")
            # container.setdefault(id(x), ...) and dict(...)[id(x)]-like
            if isinstance(node.func, ast.Attribute) \
                    and node.func.attr == "setdefault" and node.args \
                    and _contains_id_call(node.args[0]):
                flag("W304", node.lineno,
                     "setdefault key derived from id(): address re-use "
                     "makes lookups run-dependent",
                     "key on a stable identity (job_id, name, index)")
        elif isinstance(node, (ast.For, ast.comprehension)):
            it = node.iter
            if _is_set_expr(it):
                flag("W303", it.lineno,
                     "iterating a set expression: order depends on the "
                     "process hash seed",
                     "iterate sorted(...) of the set")
        elif isinstance(node, ast.Subscript):
            if _contains_id_call(node.slice):
                flag("W304", node.lineno,
                     "container subscript keyed on id(): address re-use "
                     "makes the mapping run-dependent",
                     "key on a stable identity (job_id, name, index)")
        elif isinstance(node, ast.Dict):
            for key in node.keys:
                if key is not None and _contains_id_call(key):
                    flag("W304", key.lineno,
                         "dict literal keyed on id()",
                         "key on a stable identity (job_id, name, index)")
    return findings


def run_pass(ctx: LintContext) -> list[Finding]:
    findings: list[Finding] = []
    for sf in ctx.under(*ctx.contracts.PINNED_DIRS):
        if sf.tree is not None:
            findings.extend(_scan_file(sf))
    return findings

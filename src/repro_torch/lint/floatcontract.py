"""W501/W502 · float contract.

The reference implementations are pinned to 1e-9 (or exact byte)
agreement, which makes two float idioms latent flakes in the pinned
modules:

* **W501** — bare ``==``/``!=`` against a non-integral float literal
  (``x == 0.3``): the comparison is exact, the literal is not exactly
  representable, and a kernel-vs-reference path differing in the last ulp
  flips the branch.  Integral-valued literals (``0.0``, ``2.0``) compare
  exactly and are allowed.
* **W502** — implicit float32 downcasts (``np.float32(...)``,
  ``.astype(np.float32)``, ``dtype="float32"``) in the float64 reference
  paths.  ``kernels/`` is exempt by scope: the CUDA kernels' float32
  paths compute in float32 by design, and it is the *reference* halves
  these rules keep in float64.
"""
from __future__ import annotations

import ast

from .core import Finding, LintContext

RULES = {
    "W501": "exact float equality against a non-integral literal",
    "W502": "implicit float32 downcast in a float64 reference module",
}


def _nonintegral_float(node: ast.AST) -> bool:
    if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.USub):
        node = node.operand
    return (isinstance(node, ast.Constant)
            and isinstance(node.value, float)
            and node.value == node.value          # not NaN
            and node.value not in (float("inf"), float("-inf"))
            and node.value != int(node.value))


def _float32_mention(node: ast.AST) -> str | None:
    """A float32 reference inside an expression, or None."""
    for sub in ast.walk(node):
        if isinstance(sub, ast.Attribute) and sub.attr == "float32":
            return "float32"
        if isinstance(sub, ast.Constant) and sub.value == "float32":
            return '"float32"'
    return None


def _scan_eq(sf) -> list[Finding]:
    findings = []
    for node in ast.walk(sf.tree):
        if not isinstance(node, ast.Compare):
            continue
        operands = [node.left, *node.comparators]
        for op, left, right in zip(node.ops, operands, operands[1:]):
            if not isinstance(op, (ast.Eq, ast.NotEq)):
                continue
            if _nonintegral_float(left) or _nonintegral_float(right):
                findings.append(Finding(
                    "W501", sf.path, node.lineno,
                    "exact float comparison against a non-integral "
                    "literal in a 1e-9/byte-identity-pinned module",
                    hint="compare with math.isclose/abs(a-b)<tol, or "
                         "restructure so the sentinel is integral"))
    return findings


def _scan_downcast(sf) -> list[Finding]:
    findings = []
    for node in ast.walk(sf.tree):
        mention = None
        if isinstance(node, ast.Call):
            fn = node.func
            if isinstance(fn, ast.Attribute) and fn.attr == "float32":
                mention = f"{ast.unparse(fn)}(...)"
            elif isinstance(fn, ast.Attribute) and fn.attr == "astype" \
                    and node.args and _float32_mention(node.args[0]):
                mention = ".astype(float32)"
        elif isinstance(node, ast.keyword) and node.arg == "dtype" \
                and _float32_mention(node.value):
            mention = f"dtype={_float32_mention(node.value)}"
        if mention is not None:
            findings.append(Finding(
                "W502", sf.path, node.value.lineno
                if isinstance(node, ast.keyword) else node.lineno,
                f"implicit float32 downcast ({mention}) in a float64 "
                f"reference module",
                hint="keep reference paths in float64; downcasts belong "
                     "in kernels/ only"))
    return findings


def run_pass(ctx: LintContext) -> list[Finding]:
    findings: list[Finding] = []
    for sf in ctx.under(*ctx.contracts.FLOAT_EQ_DIRS):
        if sf.tree is not None:
            findings.extend(_scan_eq(sf))
    for sf in ctx.under(*ctx.contracts.DOWNCAST_DIRS):
        if sf.tree is not None:
            findings.extend(_scan_downcast(sf))
    return findings

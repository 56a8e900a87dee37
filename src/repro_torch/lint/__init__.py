"""minoslint for the port — the contract checker of ``repro_torch``.

``python -m repro_torch.lint`` statically enforces the architectural
invariants the port's runtime tests pin behaviorally: write-ahead
journaling (W1xx), journal-record exhaustiveness (W2xx), determinism in
the byte-identity-pinned packages (W3xx), the package import DAG and the
boundary to the JAX package (W4xx), and the float contract of the 1e-9
reference paths (W5xx).  Pure stdlib ``ast`` — nothing under audit is
imported.

The rules are the reference checker's (``repro.lint``), same ids and
semantics; the policy is the port's own (:mod:`repro_torch.lint.contracts`:
scopes, allowlists, DAG).  Any module with the same names can stand in for
it (``load_context(..., contracts=...)``).  ``python -m repro_torch.lint
--list-rules`` prints the rule catalogue.
"""
from __future__ import annotations

from . import (determinism, floatcontract, layering, record_kinds,
               writeahead)
from .core import (Finding, LintContext, SourceFile, load_context,
                   render_json, render_text, report_dict, run)

#: pass execution order (report order comes from sorting, not this).
PASSES = (
    writeahead.run_pass,
    record_kinds.run_pass,
    determinism.run_pass,
    layering.run_pass,
    floatcontract.run_pass,
)

#: rule id -> one-line description, for --list-rules and the docs.
RULES = {}
for _mod in (writeahead, record_kinds, determinism, layering,
             floatcontract):
    RULES.update(_mod.RULES)

__all__ = [
    "Finding", "LintContext", "SourceFile", "PASSES", "RULES",
    "load_context", "render_json", "render_text", "report_dict", "run",
]

"""W401/W402/W403 · layering / import boundary.

The package DAG in the contracts' ``ALLOWED_EDGES`` is the declarative
source of truth for who may import whom inside ``repro_torch``.
Function-local (lazy) imports count: an edge is an edge, lazy or not —
lazy edges that are *intended* (the ``core -> pipeline`` shim) are listed
in the DAG like any other.

* **W401** — a module in package P imports ``repro_torch.Q`` with Q
  outside ``ALLOWED_EDGES[P]``; or any scanned file outside
  ``FOREIGN_ALLOWED`` (``tests/``) imports one of ``FOREIGN_PACKAGES``
  (``jax``, ``jaxlib``, the reference package ``repro``), which the port
  never imports.  The north-star edge this guards: ``core`` (and
  everything below it) never imports ``api``; ``store`` imports nothing.
* **W402** — a facade file (the ``_torch`` examples) imports a
  ``repro_torch`` module outside the public surface (``repro_torch.api``
  / ``repro_torch.fleet``).
* **W403** — ``repro_torch.legacy`` imported outside ``tests/`` /
  ``chip_smoke.py``: the frozen seed surface exists only for
  characterization tests and the card's golden check of the kernels.
"""
from __future__ import annotations

import ast

from .core import Finding, LintContext, SourceFile

RULES = {
    "W401": "package imports outside its allowed DAG edges (or imports "
            "jax / the reference package)",
    "W402": "facade file imports past the public repro_torch.api / "
            "repro_torch.fleet surface",
    "W403": "repro_torch.legacy imported outside tests/ and chip_smoke.py",
}


def _imports(sf: SourceFile, root: str):
    """Yield ``(dotted_module, lineno)`` for every import in the file,
    with relative imports resolved against the file's own module; an
    import of a package's modules from the root itself (``from repro_torch
    import legacy``) yields each module it names."""
    for node in ast.walk(sf.tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name, node.lineno
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0:
                if node.module == root:
                    for alias in node.names:
                        yield f"{root}.{alias.name}", node.lineno
                elif node.module:
                    yield node.module, node.lineno
                continue
            base = (sf.module or "").split(".")
            # a module's level-1 relative import resolves against its
            # package: drop the module segment plus (level - 1) parents.
            # For a package __init__ the module IS the package, so one
            # fewer segment comes off.
            if base:
                drop = node.level - 1 if sf.path.endswith("__init__.py") \
                    else node.level
                anchor = base[:len(base) - drop]
                mod = ".".join(anchor + ([node.module]
                                         if node.module else []))
                if mod:
                    yield mod, node.lineno


def _target_package(module: str, root: str) -> str | None:
    """Top-level ``root`` package a dotted import lands in, else None."""
    parts = module.split(".")
    if parts[0] != root:
        return None
    return parts[1] if len(parts) > 1 else root


def run_pass(ctx: LintContext) -> list[Finding]:
    findings: list[Finding] = []
    contracts = ctx.contracts
    root = ctx.root_package
    facades = set(contracts.FACADE_FILES)
    facade_surface = " / ".join(contracts.FACADE_ALLOWED)
    for sf in ctx.files:
        if sf.tree is None:
            continue
        is_facade = sf.path in facades
        pkg = ctx.package(sf)
        foreign_ok = sf.path.startswith(contracts.FOREIGN_ALLOWED)
        for module, lineno in _imports(sf, root):
            top = module.split(".")[0]
            if top in contracts.FOREIGN_PACKAGES:
                if not foreign_ok:
                    findings.append(Finding(
                        "W401", sf.path, lineno,
                        f"import of {module}: {root} imports nothing of "
                        f"{', '.join(contracts.FOREIGN_PACKAGES)}",
                        hint=f"keep {root}'s own copy of what it needs; "
                             f"only tests/ hold the two packages against "
                             f"each other"))
                continue
            target = _target_package(module, root)
            if target is None:
                continue
            # W403 first: legacy has one rule for the whole repo
            if target == "legacy":
                if not sf.path.startswith(contracts.LEGACY_ALLOWED):
                    findings.append(Finding(
                        "W403", sf.path, lineno,
                        f"{root}.legacy is the frozen seed surface; only "
                        f"{' and '.join(contracts.LEGACY_ALLOWED)} may "
                        f"import it",
                        hint=f"use {root}.api (MinosSession) instead"))
                continue
            if is_facade:
                if not (module in contracts.FACADE_ALLOWED or any(
                        module.startswith(a + ".")
                        for a in contracts.FACADE_ALLOWED)):
                    findings.append(Finding(
                        "W402", sf.path, lineno,
                        f"facade file imports {module}; facades consume "
                        f"only {facade_surface}",
                        hint=f"re-export what you need through {root}.api "
                             f"or drop the file from FACADE_FILES with a "
                             f"rationale"))
                continue
            if pkg is None or pkg == root or target == root:
                continue  # tests/tools may import anything non-legacy
            if target == pkg:
                continue
            allowed = contracts.ALLOWED_EDGES.get(pkg)
            if allowed is None:
                findings.append(Finding(
                    "W401", sf.path, lineno,
                    f"package {pkg!r} has no entry in ALLOWED_EDGES",
                    hint="declare the package's allowed imports in "
                         "lint/contracts.py"))
            elif target not in allowed:
                findings.append(Finding(
                    "W401", sf.path, lineno,
                    f"illegal package edge {pkg} -> {target} "
                    f"(allowed: {', '.join(sorted(allowed)) or 'none'})",
                    hint="invert the dependency or add the edge to "
                         "ALLOWED_EDGES with a rationale"))
    return findings

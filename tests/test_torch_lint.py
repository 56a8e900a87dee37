"""The port's contract checker (``repro_torch.lint``) and its import boundary.

The counterpart of ``tests/test_lint.py`` and ``tests/test_import_boundary.py``
for ``src/repro_torch``:

* **fixtures** — each ``tests/lint_fixtures/torch/bad_*.py`` snippet trips
  exactly its rules, and its ``good_*.py`` twin trips none (the fixtures
  carry ``minoslint: path=src/repro_torch/...`` pragmas so the scoped rules
  apply);
* **tree** — ``python -m repro_torch.lint`` exits 0 on the tree, with every
  suppression counted (the reference's 7, restored, plus at most 3);
* **regressions** — the reference's three edits to the real sources, made
  to the port's, trip the write-ahead and exhaustiveness passes;
* **boundary** — a lazy ``import jax`` or an import of the reference
  package anywhere outside ``tests/`` is a W401; the ``_torch`` examples
  import only public names;
* **parity** — the port's passes run under the reference's contracts give
  the reference checker's findings, rule, path and line, on the reference's
  tree and on each of its fixtures.

Most checks run in-process; two run the CLI.
"""
import ast
import json
import os
import subprocess
import sys
import types
from pathlib import Path

import pytest

import repro.lint as ref_lint
import repro.lint.contracts as ref_contracts
from repro.lint.core import discover_files as ref_discover_files
from repro.lint.core import load_context as ref_load_context
from repro_torch.lint import RULES, run
from repro_torch.lint import contracts
from repro_torch.lint.core import (LintContext, SourceFile, discover_files,
                                   load_context)
from repro_torch.lint.layering import run_pass as layering_pass

REPO = Path(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
FIXTURES = REPO / "tests" / "lint_fixtures" / "torch"
REF_FIXTURES = REPO / "tests" / "lint_fixtures"

#: bad fixture -> rule ids it must (exactly) trigger
BAD_FIXTURES = {
    "bad_writeahead.py": {"W101"},
    "bad_record_kinds.py": {"W201", "W202", "W203"},
    "bad_determinism.py": {"W301", "W302", "W303", "W304"},
    "bad_layering.py": {"W401", "W403"},
    "bad_foreign.py": {"W401"},
    "bad_facade.py": {"W402"},
    "bad_floatcontract.py": {"W501", "W502"},
}

GOOD_FIXTURES = sorted(name.replace("bad_", "good_") for name in BAD_FIXTURES)

#: the reference's seven justified sites, restored in the port
RESTORED = {
    ("W304", "src/repro_torch/pipeline/online.py", 287),
    ("W304", "src/repro_torch/pipeline/online.py", 328),
    ("W304", "src/repro_torch/pipeline/online.py", 329),
    ("W304", "src/repro_torch/pipeline/online.py", 394),
    ("W304", "src/repro_torch/pipeline/online.py", 395),
    ("W301", "src/repro_torch/store/journal.py", 205),
    ("W301", "src/repro_torch/store/snapshots.py", 66),
}


def _cli(*args):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO / "src")
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.lint", *args],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120)


def _active(findings):
    return [f for f in findings if not f.suppressed]


def _lint_files(*paths):
    return run(load_context(REPO, [Path(p) for p in paths]))


@pytest.fixture(scope="module")
def tree_findings():
    return run(load_context(REPO))


# -- fixtures ------------------------------------------------------------

def test_every_rule_has_a_bad_fixture():
    covered = set().union(*BAD_FIXTURES.values())
    assert covered == set(RULES), (
        f"rules without fixture coverage: {set(RULES) - covered}")
    assert set(RULES) == set(ref_lint.RULES)     # the reference's rule ids


@pytest.mark.parametrize("name,expected", sorted(BAD_FIXTURES.items()))
def test_bad_fixture_trips_exactly_its_rules(name, expected):
    findings = _active(_lint_files(FIXTURES / name))
    got = {f.rule for f in findings}
    assert got == expected, f"{name}: expected {expected}, got {got}"


@pytest.mark.parametrize("name", GOOD_FIXTURES)
def test_good_fixture_passes(name):
    findings = _lint_files(FIXTURES / name)
    assert findings == [], "\n".join(f.render() for f in findings)


def test_fixtures_are_scoped_into_the_port():
    """Each fixture opts into the port's scopes, never the reference's."""
    for p in sorted(FIXTURES.glob("*.py")):
        sf = SourceFile(p.name, p.read_text())
        assert sf.path.startswith(("src/repro_torch/", "examples/",
                                   "chip_smoke.py")), (p.name, sf.path)


def test_cli_fails_on_a_bad_fixture():
    proc = _cli("--format", "json", str(FIXTURES / "bad_layering.py"))
    assert proc.returncode == 1, proc.stdout + proc.stderr
    report = json.loads(proc.stdout)
    assert {f["rule"] for f in report["findings"]} == {"W401", "W403"}
    assert report["ok"] is False


# -- tree ----------------------------------------------------------------

def test_cli_exits_0_on_the_tree_and_writes_the_report(tmp_path):
    """Zero non-suppressed findings on the tree, through the CLI, and
    ``--output`` writes the report it prints."""
    out = tmp_path / "lint_report.json"
    proc = _cli("--format", "json", "--output", str(out))
    report = json.loads(proc.stdout)
    assert proc.returncode == 0, "\n".join(
        f"{f['path']}:{f['line']}: {f['rule']} {f['message']}"
        for f in report["findings"])
    assert report["ok"] is True
    assert report["counts"]["findings"] == 0
    assert json.loads(out.read_text()) == report


def test_clean_tree_via_api(tree_findings):
    findings = _active(tree_findings)
    assert findings == [], "\n".join(f.render() for f in findings)


def test_suppressions_are_counted_and_justified(tree_findings):
    """The reference's seven pragmas are back on the port's copies of its
    lines, at most three more were added, and each suppressed site has its
    reason in a comment right above it."""
    suppressed = [f for f in tree_findings if f.suppressed]
    sites = {(f.rule, f.path, f.line) for f in suppressed}
    assert RESTORED <= sites
    assert 7 <= len(suppressed) <= 10
    for f in suppressed:
        lines = (REPO / f.path).read_text().splitlines()
        above = [ln.strip() for ln in lines[max(0, f.line - 4):f.line - 1]]
        assert any(ln.startswith("#") for ln in above), f.render()
        assert f"disable={f.rule}" in lines[f.line - 1], f.render()


def test_fixtures_excluded_from_default_scan():
    scanned = {p.relative_to(REPO).as_posix() for p in discover_files(REPO)}
    assert not any(p.startswith("tests/lint_fixtures/") for p in scanned)
    for want in ("src/repro_torch/fleet/controller.py",
                 "src/repro_torch/lint/core.py", "tests/test_torch_lint.py",
                 "examples/quickstart_torch.py",
                 "examples/fleet_power_planner_torch.py", "chip_smoke.py",
                 "tools/kernel_variants.py"):
        assert want in scanned, want
    # the reference's tree is the reference checker's
    assert not any(p.startswith("src/repro/") for p in scanned)
    assert "tests/test_lint.py" not in scanned
    assert "examples/quickstart.py" not in scanned


# -- regressions against the port's real sources -------------------------

def _ctx_with_replacement(path: str, old: str, new: str) -> LintContext:
    files = []
    replaced = False
    for p in discover_files(REPO):
        rel = p.relative_to(REPO).as_posix()
        text = p.read_text()
        if rel == path:
            assert old in text, f"expected snippet missing from {path}"
            text = text.replace(old, new)
            replaced = True
        files.append(SourceFile(rel, text))
    assert replaced, f"{path} not in the default scan"
    return LintContext(files, root=str(REPO))


@pytest.mark.parametrize("path,old,new,expected,needle", [
    # fleet retire's write-ahead record gone: the following jobs.pop is an
    # unjournaled mutation (W101) and the RETIRE replay handler is dead
    ("src/repro_torch/fleet/controller.py",
     "self._journal(kinds.RETIRE, job_id=job_id)", "pass",
     {"W101", "W202"}, None),
    # the RETIRE case gone from _apply_record: resume would drop the kind
    ("src/repro_torch/api/session.py",
     '            case kinds.RETIRE:\n'
     '                self.retire(data["job_id"])\n', "",
     {"W201"}, "retire"),
    # an emit of a kind the registry lacks, which nothing replays either
    ("src/repro_torch/fleet/controller.py",
     "self._journal(kinds.RETIRE, job_id=job_id)",
     'self._journal("vanish", job_id=job_id)',
     {"W201", "W203"}, "vanish"),
], ids=["journal_call_deleted", "replay_case_deleted", "unregistered_kind"])
def test_edit_to_the_real_sources_trips(path, old, new, expected, needle):
    findings = _active(run(_ctx_with_replacement(path, old, new)))
    assert expected <= {f.rule for f in findings}
    if needle is not None:
        assert any(f.rule in expected and needle in f.message
                   for f in findings)


# -- the import boundary --------------------------------------------------

@pytest.mark.parametrize("path", [
    "src/repro_torch/core/newmod.py", "src/repro_torch/kernels/newmod.py",
    "chip_smoke.py", "examples/quickstart_torch.py", "tools/newtool.py"])
@pytest.mark.parametrize("stmt", ["import jax", "import jax.numpy as jnp",
                                  "from jaxlib import xla_client",
                                  "from repro.core import spikes",
                                  "import repro"])
def test_lazy_foreign_import_trips_w401(path, stmt):
    """An import of the JAX stack or of the reference package, even inside
    a function, is an edge the port's DAG does not have."""
    src = f"def f():\n    {stmt}\n    return 1\n"
    findings = layering_pass(LintContext([SourceFile(path, src)],
                                         root=str(REPO)))
    assert [(f.rule, f.line) for f in findings] == [("W401", 2)]


def test_tests_may_import_both_packages():
    src = "import jax\nfrom repro.core import spikes\n" \
          "from repro_torch.legacy import ema_filter_loop\n"
    findings = layering_pass(LintContext(
        [SourceFile("tests/test_torch_new.py", src)], root=str(REPO)))
    assert findings == []


@pytest.mark.parametrize("path,src,rule", [
    ("src/repro_torch/core/newmod.py", "import repro_torch.api\n", "W401"),
    ("src/repro_torch/store/newmod.py",
     "from repro_torch.device import resolve_device\n", "W401"),
    ("src/repro_torch/kernels/newmod.py",
     "from repro_torch.analysis.hardware import H100\n", "W401"),
    ("examples/fleet_power_planner_torch.py",
     "from repro_torch.store.journal import EventJournal\n", "W402"),
    ("src/repro_torch/api/newmod.py",
     "from repro_torch.legacy import linkage_loop\n", "W403"),
    ("tools/newtool.py", "from repro_torch import legacy\n", "W403"),
])
def test_layering_catches_a_new_edge(path, src, rule):
    findings = layering_pass(LintContext([SourceFile(path, src)],
                                         root=str(REPO)))
    assert [f.rule for f in findings] == [rule]


def test_port_modules_import_neither_jax_nor_the_reference():
    """The same boundary as ``tests/test_torch_models.py``'s runtime check,
    statically, so a function-local import is seen too."""
    files = [p for p in discover_files(REPO)
             if not p.relative_to(REPO).as_posix().startswith("tests/")]
    findings = [f for f in run(load_context(REPO, files)) if f.rule == "W401"]
    assert findings == [], "\n".join(f.render() for f in findings)


def test_allowed_edges_are_the_references_plus_device_and_kernels():
    """The port's DAG is the reference's, a ``device`` node importing
    nothing, edges into it, and ``models -> kernels``; nothing else."""
    ref, port = ref_contracts.ALLOWED_EDGES, contracts.ALLOWED_EDGES
    assert set(port) == set(ref) | {"device"}
    assert port["device"] == set()
    for pkg, allowed in ref.items():
        extra = port[pkg] - allowed
        assert allowed <= port[pkg], pkg
        assert extra <= ({"device", "kernels"} if pkg == "models"
                         else {"device"}), (pkg, extra)
    assert "kernels" in port["models"]


def test_kernels_keep_the_h100_sm_count_of_the_analysis():
    """``kernels`` imports nothing of ``analysis``: its copy of the H100's
    SM count must stay the data sheet's."""
    from repro_torch.analysis.hardware import H100
    from repro_torch.kernels import build
    assert build.H100_SMS == H100.sms


def test_facade_files_exist():
    missing = [p for p in contracts.FACADE_FILES if not (REPO / p).is_file()]
    assert not missing, f"FACADE_FILES entries not on disk: {missing}"


def _port_imports(path: str):
    tree = ast.parse((REPO / path).read_text(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom):
            mod = node.module or ""
            if mod == "repro_torch" or mod.startswith("repro_torch."):
                yield mod, [a.name for a in node.names], node.lineno


@pytest.mark.parametrize("path", contracts.FACADE_FILES)
def test_facade_files_import_only_public_names(path):
    import repro_torch.api
    import repro_torch.fleet
    public = {"repro_torch.api": set(repro_torch.api.__all__),
              "repro_torch.fleet": set(repro_torch.fleet.__all__)}
    imported = list(_port_imports(path))
    assert imported, f"{path} imports nothing of repro_torch"
    violations = []
    for mod, names, lineno in imported:
        for name in names:
            if mod not in public or name not in public[mod]:
                violations.append(f"{path}:{lineno}: {name!r} is not a "
                                  f"public (__all__) name of {mod}")
    assert not violations, "\n".join(violations)


def test_port_api_covers_the_reference_api():
    import repro.api
    import repro_torch.api
    assert set(repro.api.__all__) <= set(repro_torch.api.__all__)
    missing = [n for n in repro_torch.api.__all__
               if not hasattr(repro_torch.api, n)]
    assert not missing, f"repro_torch.api.__all__ names missing: {missing}"


# -- parity with the reference checker ------------------------------------

#: the reference's policy, as the port's passes read it: its own entries,
#: its root package, and no foreign packages (the reference's W401 knows
#: only its DAG)
REF_POLICY = types.SimpleNamespace(
    **{k: getattr(ref_contracts, k) for k in dir(ref_contracts)
       if k.isupper()},
    ROOT_PACKAGE="repro", FOREIGN_PACKAGES=(), FOREIGN_ALLOWED=(),
    LEGACY_ALLOWED=ref_contracts.LEGACY_ALLOWED_DIRS)


def _sites(findings):
    return sorted((f.rule, f.path, f.line, f.suppressed) for f in findings)


def test_parity_on_the_reference_tree():
    paths = ref_discover_files(REPO)
    want = ref_lint.run(ref_load_context(REPO, paths))
    got = run(load_context(REPO, paths, contracts=REF_POLICY))
    assert _sites(got) == _sites(want)
    assert len([f for f in want if f.suppressed]) == 7


@pytest.mark.parametrize("name", sorted(
    p.name for p in REF_FIXTURES.glob("*.py")))
def test_parity_on_each_reference_fixture(name):
    path = REF_FIXTURES / name
    want = ref_lint.run(ref_load_context(REPO, [path]))
    got = run(load_context(REPO, [path], contracts=REF_POLICY))
    assert _sites(got) == _sites(want)
    if name.startswith("bad_"):
        assert want

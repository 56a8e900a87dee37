"""The port's two facade examples against the reference's, on the CPU.

``examples/quickstart_torch.py`` and ``examples/fleet_power_planner_torch.py``
run with ``device="cpu"`` beside ``examples/quickstart.py`` and
``examples/fleet_power_planner.py`` on the same seeds, in this process, and
print the same lines:

* the quickstart: every line equal, but the byte count of the session
  report's JSON, whose floats agree within 1e-12 but need not print with
  the same number of digits (the reports themselves are compared, parsed,
  within 1e-12);
* the planner: the port builds the 28-workload library into a temporary
  store (its first line, ``# built reference library: 28 profiles in
  <seconds>``, is the one timing either example prints), and the
  reference's planner, pointed at that store through
  ``benchmarks.common.STORE``, prints the port's remaining lines.

Nothing is written into the repo's ``results/``.
"""
import json
import os
import re
import runpy

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(ROOT, "examples")


@pytest.fixture(autouse=True)
def one_thread():
    """Thousands of small tensor ops: one thread runs them as fast as
    eight, and a pool per worker oversubscribes the suite's cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _example(name: str) -> dict:
    return runpy.run_path(os.path.join(EXAMPLES, name), run_name="example")


def _lines(capsys, fn, *args) -> list[str]:
    capsys.readouterr()
    fn(*args)
    return capsys.readouterr().out.splitlines()


def _record_reports(monkeypatch, session_cls, into: list) -> None:
    """Keep every report ``session.run()`` returns."""
    run = session_cls.run

    def recording(self, *args, **kwargs):
        report = run(self, *args, **kwargs)
        into.append(json.loads(report.to_json()))
        return report
    monkeypatch.setattr(session_cls, "run", recording)


def _assert_close(got, want, where=""):
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), where
        for k in want:
            _assert_close(got[k], want[k], f"{where}/{k}")
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_close(g, w, f"{where}[{i}]")
    elif isinstance(want, float):
        assert got == pytest.approx(want, rel=1e-12, abs=1e-12), where
    else:
        assert got == want, where


_BYTES = re.compile(r"(session report: .*, )\d+( bytes as JSON)$")


def test_quickstart_prints_the_references_lines(capsys, monkeypatch):
    import repro.api
    import repro_torch.api
    reports = {"ref": [], "port": []}
    _record_reports(monkeypatch, repro.api.MinosSession, reports["ref"])
    _record_reports(monkeypatch, repro_torch.api.MinosSession,
                    reports["port"])
    want = _lines(capsys, _example("quickstart.py")["main"])
    got = _lines(capsys, _example("quickstart_torch.py")["main"], "cpu")
    assert len(got) == len(want) and _BYTES.match(want[-1])
    mask = [_BYTES.sub(r"\1N\2", line) for line in (got[-1], want[-1])]
    assert got[:-1] == want[:-1] and mask[0] == mask[1], "\n".join(got)
    assert len(reports["port"]) == len(reports["ref"]) == 1
    _assert_close(reports["port"][0], reports["ref"][0])


def test_fleet_power_planner_prints_the_references_lines(capsys, tmp_path,
                                                         monkeypatch):
    store = str(tmp_path / "reference_store")
    got = _lines(capsys, _example("fleet_power_planner_torch.py")["main"],
                 "cpu", store)
    assert re.fullmatch(r"# built reference library: 28 profiles in "
                        r"\d+\.\ds", got[0]), got[0]
    monkeypatch.syspath_prepend(ROOT)
    import benchmarks.common as common
    monkeypatch.setattr(common, "RESULTS", str(tmp_path))
    monkeypatch.setattr(common, "STORE", store)
    want = _lines(capsys, _example("fleet_power_planner.py")["main"])
    assert got[1:] == want, "\n".join(got)
    assert any(line.startswith("final packing:") for line in want)
    # a warm start from the same store prints the same lines, no build
    again = _lines(capsys, _example("fleet_power_planner_torch.py")["main"],
                   "cpu", store)
    assert again == got[1:]

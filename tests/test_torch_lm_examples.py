"""The port's two LM examples against the reference's, on the CPU.

``examples/serve_lm_torch.py`` and ``examples/train_lm_torch.py`` run in
this process with ``sys.argv`` patched and ``--device cpu``, beside
``examples/serve_lm.py`` and ``examples/train_lm.py``:

* serving, for the dense, vlm, audio and ssm branches: the request that
  each example hands its engine's ``generate`` is the same (the arrays of
  the batch, the vlm's ``image_embeds`` and whisper's ``frames`` included,
  equal in dtype and value; the token count; sampling, not greedy); the
  request line and the engine's counts are equal (the wall time and tok/s
  masked); the sampled ids cannot be equal (the reference draws them with
  JAX's PRNG, the port with a ``torch.Generator``), so each side prints
  ``--tokens`` ids of the first request, each in ``[0, vocab_size)``.  The
  port alone serves every arch of ``ARCHS`` the same way.
* training: ``hundred_m_config()`` equals the reference's field by field;
  with the ``Trainer`` of both examples replaced by one that returns a
  fixed result (no training), both print the same lines for the real
  ~100M model, the Minos classification of its kernel stream included
  (the simulator's, on the same seeds); and the port's example trains a
  small glm4 reduction end to end for 2 steps, its checkpoint under the
  test's temporary directory.
"""
import ast
import dataclasses
import math
import os
import re
import runpy
import sys
import tempfile

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import ckpt
from repro_torch.configs import ARCHS

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(ROOT, "examples")
SERVE_BRANCHES = ("glm4-9b", "llama-3.2-vision-11b", "whisper-medium",
                  "falcon-mamba-7b")
TOKENS, BATCH, PROMPT = 24, 4, 32           # serve_lm.py's defaults
_STATS = re.compile(r"(prefill tokens: \d+  decode steps: \d+  )wall: "
                    r"\d+\.\d\ds \(\d+\.\d tok/s incl\. compile\)$")
_IDS = "sampled ids (first request): "


@pytest.fixture(autouse=True)
def one_thread():
    """Small models: one thread runs them about as fast as many, and a
    pool per worker oversubscribes the suite's cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _main(capsys, monkeypatch, name: str, *argv: str,
          **replace) -> list[str]:
    """``examples/<name>``'s ``main()`` under ``sys.argv``, with the
    example's globals in ``replace`` swapped in; its lines."""
    path = os.path.join(EXAMPLES, name)
    main = runpy.run_path(path, run_name="example")["main"]
    for key, value in replace.items():
        monkeypatch.setitem(main.__globals__, key, value)
    monkeypatch.setattr(sys, "argv", [path, *argv])
    capsys.readouterr()
    main()
    return capsys.readouterr().out.splitlines()


def _example_fn(name: str, fn: str):
    return runpy.run_path(os.path.join(EXAMPLES, name),
                          run_name="example")[fn]


def _serve_lines(lines: list[str], arch: str) -> tuple[str, str]:
    """The request line and the masked counts line; checks the ids."""
    assert len(lines) == 3 and lines[1].startswith(_IDS), lines
    ids = ast.literal_eval(lines[1][len(_IDS):])
    vocab = ARCHS[arch].reduced().vocab_size
    assert len(ids) == TOKENS and all(0 <= i < vocab for i in ids), ids
    stats = _STATS.match(lines[2])
    assert stats, lines[2]
    return lines[0], stats.group(1)


def _recording(name: str, seen: dict):
    """``examples/<name>``'s ``ServeEngine`` whose ``generate`` keeps its
    request in ``seen`` (the reference's takes the parameters first)."""
    engine = _example_fn(name, "ServeEngine")

    class Recording(engine):
        def generate(self, *args, **kwargs):
            *_, batch, num_tokens = args
            seen.update(batch=batch, num_tokens=num_tokens,
                        greedy=kwargs["greedy"])
            return super().generate(*args, **kwargs)
    return Recording


@pytest.mark.parametrize("arch", SERVE_BRANCHES)
def test_serve_lm_prints_the_references_lines(capsys, monkeypatch, arch):
    ref, port = {}, {}
    want = _main(capsys, monkeypatch, "serve_lm.py", "--arch", arch,
                 ServeEngine=_recording("serve_lm.py", ref))
    got = _main(capsys, monkeypatch, "serve_lm_torch.py", "--arch", arch,
                "--device", "cpu",
                ServeEngine=_recording("serve_lm_torch.py", port))
    assert _serve_lines(got, arch) == _serve_lines(want, arch)
    assert (port["num_tokens"], port["greedy"]) == \
        (ref["num_tokens"], ref["greedy"]) == (TOKENS, False)
    assert sorted(port["batch"]) == sorted(ref["batch"])
    for key, value in ref["batch"].items():
        assert port["batch"][key].dtype == value.dtype, key
        np.testing.assert_array_equal(port["batch"][key], value, err_msg=key)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_serve_lm_torch_serves_every_arch(capsys, monkeypatch, arch):
    got = _main(capsys, monkeypatch, "serve_lm_torch.py", "--arch", arch,
                "--device", "cpu")
    assert _serve_lines(got, arch) == (
        f"arch={arch} (reduced) batch={BATCH} prompt={PROMPT} "
        f"generated={TOKENS}",
        f"prefill tokens: {BATCH * PROMPT}  decode steps: {TOKENS}  ")


def test_serve_lm_torch_defaults_to_the_card(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    main = runpy.run_path(os.path.join(EXAMPLES, "serve_lm_torch.py"),
                          run_name="example")["main"]
    monkeypatch.setattr(sys, "argv", ["serve_lm_torch.py"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main()


# ---------------------------------------------------------------------------
# train_lm
# ---------------------------------------------------------------------------
def test_hundred_m_config_equals_the_references():
    want = _example_fn("train_lm.py", "hundred_m_config")()
    got = _example_fn("train_lm_torch.py", "hundred_m_config")()
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.param_count() == want.param_count() == 100_947_200


@dataclasses.dataclass
class _Result:
    losses: list
    step_durations: list


def _fixed_trainer(seen: list):
    """A ``Trainer`` stand-in that trains nothing: its ``run()`` returns
    12 fixed losses and step times; it records its arguments."""
    class FixedTrainer:
        def __init__(self, cfg, shape, run, *args, **kwargs):
            seen.append((cfg, shape, run, kwargs))

        def run(self):
            return _Result([10.5 - 0.25 * i for i in range(12)],
                           [0.002 * (i + 1) for i in range(12)])
    return FixedTrainer


def test_train_lm_prints_the_references_lines(capsys, monkeypatch, tmp_path):
    """The real ~100M model without training: the parameter line, the
    (fixed) loss lines and the Minos line of its kernel stream at the
    reference's defaults (16 x 128), profiled on the CPU, are the
    reference's."""
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    seen = {"ref": [], "port": []}
    want = _main(capsys, monkeypatch, "train_lm.py",
                 Trainer=_fixed_trainer(seen["ref"]))
    got = _main(capsys, monkeypatch, "train_lm_torch.py", "--device", "cpu",
                Trainer=_fixed_trainer(seen["port"]))
    assert got == want, "\n".join(got)
    assert got[0] == "model: 100.9M params (10L d=640 ff=2560)"
    assert got[-1] == ("Minos classification of this job: power-neighbor="
                       "sgemm-25k, PowerCentric cap f=0.80")
    (cfg_r, shape_r, run_r, kw_r), = seen["ref"]
    (cfg_p, shape_p, run_p, kw_p), = seen["port"]
    assert dataclasses.asdict(shape_p) == dataclasses.asdict(shape_r)
    keep = ("total_steps", "warmup_steps", "learning_rate",
            "checkpoint_every", "microbatches", "seed")
    assert {k: getattr(run_p, k) for k in keep} == \
        {k: getattr(run_r, k) for k in keep}
    assert (run_p.total_steps, cfg_p.remat, run_p.microbatches) == \
        (300, True, 1)
    for run in (run_r, run_p):
        assert os.path.basename(run.checkpoint_dir).startswith("repro_100m_")
        assert os.path.dirname(run.checkpoint_dir) == str(tmp_path)
    assert kw_p["device"] == "cpu" and callable(kw_p["telemetry_hook"])


def test_train_lm_torch_trains_end_to_end(capsys, monkeypatch, tmp_path):
    """A small glm4 reduction in the 100M model's place, 2 steps of 2 x 16
    on the CPU: finite losses, one checkpoint (step 2) under the temporary
    directory, and the Minos line."""
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    small = ARCHS["glm4-9b"].reduced(num_layers=2)
    got = _main(capsys, monkeypatch, "train_lm_torch.py", "--steps", "2",
                "--seq-len", "16", "--batch", "2", "--device", "cpu",
                hundred_m_config=lambda: small)
    assert got[0] == (f"model: {small.param_count() / 1e6:.1f}M params "
                      f"(2L d=128 ff=256)")
    steps = [re.fullmatch(r"  step +(\d+)  loss (\d+\.\d{4})  \(\d+ ms/step\)",
                          line) for line in got[1:3]]
    assert [int(m.group(1)) for m in steps] == [1, 2]
    losses = [float(m.group(2)) for m in steps]
    assert all(math.isfinite(x) and 0 < x < 20 for x in losses)
    assert got[3] == (f"  final loss {losses[1]:.4f} (start "
                      f"{losses[0]:.4f})")
    assert got[4] == "" and re.fullmatch(
        r"Minos classification of this job: power-neighbor=\S+, "
        r"PowerCentric cap f=\d\.\d\d", got[5]), got
    (run_dir,) = [d for d in os.listdir(tmp_path)
                  if d.startswith("repro_100m_")]
    assert ckpt.latest_step(str(tmp_path / run_dir)) == 2


def test_train_lm_torch_defaults_to_the_card(monkeypatch, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    main = _example_fn("train_lm_torch.py", "main")
    monkeypatch.setattr(sys, "argv", ["train_lm_torch.py", "--steps", "1"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main()

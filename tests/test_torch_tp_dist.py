"""``DistGroup`` (gloo processes started by ``parallel.spawn``) against
``LocalGroup`` (threads): the same collectives and the same tp = 2
serving of a reduced command-r-35b, jamba-1.5-large-398b, deepseek-v2-236b
(MLA) and whisper-medium (an encoder and cross-attention), and the same
bits of two tp = 2 train steps of a reduced glm4-9b.

This file imports neither JAX nor the reference, so the spawned ranks,
which import it to find their function, start in about three seconds.
``spawn`` takes its rendezvous port from the OS (the suite runs on several
workers at once), has its own time limit, and joins or kills every process
before it returns.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import ARCHS
from repro_torch.configs.base import MeshConfig, RunConfig, ShapeConfig
from repro_torch.models.common import Topo
from repro_torch.models.parallel import run_local, spawn
from repro_torch.serve import ServeEngine
from repro_torch.train import Trainer
from test_torch_tp_cuda import away_from_zero

CFG = ARCHS["command-r-35b"].reduced(num_layers=2)
TOKENS = np.random.default_rng(4).integers(
    0, CFG.vocab_size, (2, 16)).astype(np.int32)


def collectives(group) -> dict:
    """Each collective once, on tensors that differ by rank."""
    r = group.rank
    x = torch.arange(12, dtype=torch.float32).reshape(3, 4) * (r + 1)
    wide = torch.arange(24, dtype=torch.float32).reshape(3, 8) + r
    return {"sum": group.all_reduce(x.clone()),
            "max": group.all_reduce(-x, "max"),
            "gather0": group.all_gather(x, 0),
            "gather1": group.all_gather(x, 1),
            "scatter1": group.reduce_scatter(wide, 1),
            "broadcast": group.broadcast(x.clone() if r == 1
                                         else torch.zeros(3, 4), 1)}


def ranks_run(group) -> dict:
    """The collectives, then a float32 engine on this rank (the seeded
    init): prefill logits, 2 greedy steps' logits, the ids."""
    out = collectives(group)
    eng = ServeEngine(CFG, max_len=40, device="cpu", dtype=torch.float32,
                      topo=Topo(MeshConfig((1, group.size),
                                           ("data", "model"))),
                      group=group)
    eng.init_params(0)
    logits, caches = eng.model.prefill({"tokens": TOKENS})
    out["logits"] = [logits]
    caches = eng._pad_caches(caches, 2)
    for i in range(2):
        nxt = logits[:, :CFG.vocab_size].argmax(-1)
        logits, caches = eng.decode_model.decode_step(caches, nxt, 16 + i,
                                                      cache_len=40)
        out["logits"].append(logits)
    out["ids"] = eng.generate({"tokens": TOKENS}, 3)
    return out


JAMBA = ARCHS["jamba-1.5-large-398b"].reduced(num_layers=2)


def jamba_run(group) -> dict:
    """A float32 reduced jamba on this rank (the seeded init; Mamba, MoE,
    attention and MLP layers): prefill logits, the rank's Mamba caches, 2
    greedy steps' logits, the ids."""
    eng = ServeEngine(JAMBA, max_len=40, device="cpu", dtype=torch.float32,
                      topo=Topo(MeshConfig((1, group.size),
                                           ("data", "model"))),
                      group=group)
    eng.init_params(0)
    logits, caches = eng.model.prefill({"tokens": TOKENS})
    out = {"logits": [logits], "state": caches["l0_mamba"]["state"].clone(),
           "conv": caches["l0_mamba"]["conv"].clone()}
    caches = eng._pad_caches(caches, 2)
    for i in range(2):
        nxt = logits[:, :JAMBA.vocab_size].argmax(-1)
        logits, caches = eng.decode_model.decode_step(caches, nxt, 16 + i,
                                                      cache_len=40)
        out["logits"].append(logits)
    out["ids"] = eng.generate({"tokens": TOKENS}, 3)
    return out


def test_dist_group_serves_jamba_as_the_threads_do():
    """Reduced jamba at tp = 2: gloo processes and threads give the same
    logits, Mamba caches (the rank's channels) and ids."""
    procs = spawn(jamba_run, 2, "gloo", timeout=120.0)
    threads = run_local(jamba_run, 2)
    for p, t in zip(procs, threads):
        for key in ("state", "conv"):
            assert p[key].shape == t[key].shape
            np.testing.assert_allclose(p[key].numpy(), t[key].numpy(),
                                       rtol=0, atol=1e-6)
        for a, b in zip(p["logits"], t["logits"]):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                       atol=1e-6)
        np.testing.assert_array_equal(p["ids"], t["ids"])
    np.testing.assert_array_equal(procs[0]["ids"], procs[1]["ids"])
    assert threads[0]["state"].shape[2] == JAMBA.d_inner // 2


def cross_run(group, arch: str) -> dict:
    """A float32 reduced ``arch`` on this rank (the seeded init, then every
    gate and bias drawn away from 0, ``away_from_zero``): prefill logits, the
    rank's run of each cache after 2 greedy steps and their logits, the
    ids.  whisper's 12 frames are cut over the ranks, its encoder too."""
    cfg = ARCHS[arch].reduced()
    eng = ServeEngine(cfg, max_len=40, device="cpu", dtype=torch.float32,
                      topo=Topo(MeshConfig((1, group.size),
                                           ("data", "model"))),
                      group=group)
    eng.init_params(0)
    away_from_zero(eng.model)
    batch = {"tokens": TOKENS}
    mem = {}
    if cfg.family == "audio":
        batch["frames"] = np.random.default_rng(6).standard_normal(
            (2, 12, cfg.d_model)).astype(np.float32) * 0.02
        mem = {"memory_len": 12}
    logits, caches = eng.model.prefill(batch)
    out = {"logits": [logits]}
    caches = eng._pad_caches(caches, 2, **mem)
    for i in range(2):
        nxt = logits[:, :cfg.vocab_size].argmax(-1)
        logits, caches = eng.decode_model.decode_step(
            caches, nxt, 16 + i, cache_len=40, **mem)
        out["logits"].append(logits)
    out["caches"] = {f"{n}.{k}": c.float() for n, e in caches.items()
                     for k, c in e.items()}
    out["ids"] = eng.generate(batch, 3)
    return out


@pytest.mark.parametrize("arch", ["deepseek-v2-236b", "whisper-medium"])
def test_dist_group_serves_mla_and_enc_dec_as_the_threads_do(arch):
    """Reduced deepseek-v2 (MLA's sharded latent caches, ``w_kvb``'s k and
    value ranks) and whisper (non-zero biases, the encoder over the
    frames, sequence-sharded cross caches) at tp = 2: gloo processes and
    threads give the same logits, cache runs and ids."""
    procs = spawn(cross_run, 2, "gloo", timeout=120.0, args=(arch,))
    threads = run_local(lambda g: cross_run(g, arch), 2)
    for p, t in zip(procs, threads):
        assert sorted(p["caches"]) == sorted(t["caches"])
        for key, c in t["caches"].items():
            np.testing.assert_allclose(p["caches"][key].numpy(), c.numpy(),
                                       rtol=0, atol=1e-6, err_msg=key)
        for a, b in zip(p["logits"], t["logits"]):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                       atol=1e-6)
        np.testing.assert_array_equal(p["ids"], t["ids"])
    np.testing.assert_array_equal(procs[0]["ids"], procs[1]["ids"])


def test_dist_group_over_gloo_equals_the_threads():
    procs = spawn(ranks_run, 2, "gloo", timeout=120.0)
    threads = run_local(ranks_run, 2)
    x = torch.arange(12, dtype=torch.float32).reshape(3, 4)
    for r, (p, t) in enumerate(zip(procs, threads)):
        for key in ("sum", "max", "gather0", "gather1", "scatter1",
                    "broadcast"):
            assert torch.equal(p[key], t[key]), (r, key)
        assert torch.equal(t["sum"], 3 * x)
        assert torch.equal(t["max"], -x)
        assert torch.equal(t["gather0"], torch.cat([x, 2 * x], 0))
        assert torch.equal(t["gather1"], torch.cat([x, 2 * x], 1))
        wide = torch.arange(24, dtype=torch.float32).reshape(3, 8)
        assert torch.equal(t["scatter1"], (2 * wide + 1)[:, 4 * r:4 * r + 4])
        assert torch.equal(t["broadcast"], 2 * x)
        for a, b in zip(p["logits"], t["logits"]):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                       atol=1e-6)
        np.testing.assert_array_equal(p["ids"], t["ids"])
    np.testing.assert_array_equal(procs[0]["ids"], procs[1]["ids"])


def test_the_launcher_serves_over_threads_as_on_one_device(capsys,
                                                            monkeypatch):
    """``launch.serve --tp 2 --group local --device cpu`` prints the ids
    of ``--tp 1``; ``--tp`` without ``--group`` is refused; ``check_fits``
    counts a rank's blocks of both layouts."""
    from repro_torch.launch import serve

    def run(*extra):
        monkeypatch.setattr("sys.argv", [
            "serve", "--arch", "command-r-35b", "--smoke", "--device",
            "cpu", "--tokens", "4", *extra])
        serve.main()
        out = capsys.readouterr().out
        return out[:out.index("prefill_tokens")]

    assert run("--tp", "2", "--group", "local") == run()
    with pytest.raises(SystemExit, match="--group"):
        run("--tp", "2")
    full = serve.rank_weight_bytes(CFG)
    rank = serve.rank_weight_bytes(CFG, 4)
    # a quarter of the weights, and the decode layout's attention blocks
    assert full / 4 < rank < full / 4 * 1.5
    with pytest.raises(ValueError, match="do not fit"):
        serve.check_fits(CFG, torch.device("cpu"), 4,
                         ranks_per_device=10**9)


GLM = ARCHS["glm4-9b"].reduced(num_layers=2)


def train_run(group) -> dict:
    """A float32 reduced glm4-9b (qkv biases) on this rank, the seeded
    init: 2 ``Trainer`` steps at 4 x 16 tokens (the residual cut over the
    sequence), no checkpoints; the losses, rank 0's grad norms and the
    rank's parameter blocks."""
    norms = []
    trainer = Trainer(
        GLM, ShapeConfig("smoke", 16, 4, "train"),
        RunConfig(total_steps=2, warmup_steps=1, learning_rate=3e-3,
                  checkpoint_dir=None),
        Topo(MeshConfig((1, group.size), ("data", "model"))),
        telemetry_hook=lambda step, dt, m: norms.append(m["grad_norm"]),
        device="cpu", dtype=torch.float32, group=group)
    res = trainer.run()
    return {"losses": res.losses, "norms": norms,
            "params": {n: p.detach().clone()
                       for n, p in trainer.model.named_parameters()}}


def test_dist_group_trains_as_the_threads_do():
    """tp = 2 training over gloo processes and over threads: the same
    losses, grad norms and parameter blocks, bit for bit."""
    procs = spawn(train_run, 2, "gloo", timeout=120.0)
    threads = run_local(train_run, 2)
    assert procs[0]["norms"] == threads[0]["norms"] and \
        len(threads[0]["norms"]) == 2
    for p, t in zip(procs, threads):
        assert p["losses"] == t["losses"] == threads[0]["losses"]
        assert sorted(p["params"]) == sorted(t["params"])
        for name, x in t["params"].items():
            assert torch.equal(p["params"][name], x), name

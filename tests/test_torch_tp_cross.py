"""Tensor-parallel cross-attention serving (``Topo`` over a (1, tp) mesh)
against the reference's unsharded engine: the vlm and the enc-dec model.

A reduced llama-3.2-vision-11b (one period of 2 layers with its gated
cross layer, twice) and a reduced whisper-medium (2 encoder and 4 decoder
layers, qkv and output biases) get the reference's numpy parameters
(``test_torch_encdec.cross_tree``: every vlm gate drawn in [0.5, 1.5],
where the reference's zero init would leave the cross layers out of the
logits, and every bias normal * 0.1, where the zero init would hide a bias
added once a rank), cut into each rank's blocks; the ranks are
``LocalGroup`` threads.  The image embeddings and frames are float32, as
the launchers draw them, so the cross layers (and whisper's encoder) run in
float32 through the bfloat16 weights.

Held to the reference as ``test_torch_tp_mla`` holds deepseek
(``check``): prefill logits, every cache, 8 teacher-forced steps and the
decode caches at 1e-4 in float32 and ``BF16_TOL`` in bfloat16, greedy ids
equal in float32.  A memory that tp divides is cut over the ranks in
decode (the cross caches' runs) and, for whisper, in its encoder (the
residual over the frames); one it does not divide (6 image tokens, 10
frames at tp = 4) falls back to whole caches and a whole encoder, whose
decode reduces nothing over the ranks.
"""
import functools

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCHS
from repro_torch.launch.mesh import tp_mesh
from repro_torch.models.common import Topo
from repro_torch.models.model_zoo import build_model
from repro_torch.models.parallel import LocalGroup
from repro_torch.serve import ServeEngine
from test_torch_encdec import batch_for, cross_tree
from test_torch_tp_mla import PROMPT, check, one_thread  # noqa: F401

VLM, WHISPER = "llama-3.2-vision-11b", "whisper-medium"


def vlm_batch(cfg) -> dict:
    return batch_for(cfg, s=PROMPT)


def whisper_batch(cfg, memory: int = 12, s: int = PROMPT) -> dict:
    return batch_for(cfg, s=s, memory=memory)


# 10 frames and a 15-token prompt: neither cut at tp = 4
whisper_uneven = functools.partial(whisper_batch, memory=10, s=15)
BATCHES = {VLM: vlm_batch, WHISPER: whisper_batch}


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", [VLM, WHISPER])
def test_tp_cross_serving_matches_the_unsharded_reference(arch, dtype, tp):
    """8 image tokens or 12 frames, a 16-token prompt and 40 cache
    positions, all cut over the ranks.  A decode step's cross layer sums
    q (one all-reduce), reduces the softmax over the memory's runs (its
    max, sum and values) and gathers the output's d."""
    ranks = check(arch, dtype, tp, cross_tree, BATCHES[arch])
    assert ranks[0]["decode_calls"] == decode_calls(ARCHS[arch].reduced(),
                                                    cross_cut=True)


def decode_calls(cfg, cross_cut: bool) -> dict:
    """A decode step's collectives on a rank: the embedding's sum; per self
    layer four sums (q, k and v; the softmax's max and sum; its values)
    and the output's gather; per cross layer q's sum, the softmax's two
    and its values' where the memory is cut (else none of the three) and
    the output's gather; per MLP one sum; the logits' gather."""
    n_cross = cfg.num_layers // cfg.cross_attn_period \
        if cfg.family == "vlm" else cfg.num_layers
    per_cross = 4 if cross_cut else 1
    return {"all_reduce": 1 + 4 * cfg.num_layers + per_cross * n_cross
            + cfg.num_layers,
            "all_gather": 1 + cfg.num_layers + n_cross,
            "reduce_scatter": 0, "broadcast": 0}


@pytest.mark.parametrize("arch,widths,batch_fn", [
    (VLM, (("num_image_tokens", 6),), vlm_batch),
    (WHISPER, (), whisper_uneven)], ids=[VLM, WHISPER])
def test_a_memory_tp_does_not_divide_is_whole_on_every_rank(arch, widths,
                                                             batch_fn):
    """tp = 4 over 6 image tokens or 10 frames: every rank holds the whole
    cross caches and attends to all of them without a reduction (an
    all-reduce there would count every position 4 times); whisper's
    encoder keeps its residual whole, and its 15-token prompt too."""
    ranks = check(arch, "float32", 4, cross_tree, batch_fn, widths)
    assert ranks[0]["decode_calls"] == decode_calls(
        ARCHS[arch].reduced(**dict(widths)), cross_cut=False)


def _blocks(arch: str, tp: int, kind: str):
    cfg = ARCHS[arch].reduced()
    topo = Topo(tp_mesh(tp))
    models = [build_model(cfg, topo, kind, device="meta", group=g)
              for g in LocalGroup.make(tp)]
    return models, [m.blocks() for m in models]


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("kind", ["prefill", "decode"])
def test_blocks_tile_every_tensor_of_the_three_models(kind, tp):
    """Every parameter of the reduced deepseek-v2, vlm and whisper: the
    ranks' blocks cover each element once (cut) or each rank holds it
    whole (norms, gates, biases, ``kv_norm``, prefill's ``w_kva``), and a
    rank's tensor has its block's shape."""
    for arch in ("deepseek-v2-236b", VLM, WHISPER):
        models, blocks = _blocks(arch, tp, kind)
        defs = models[0].param_defs().defs
        for name, d in defs.items():
            count = np.zeros(d.shape, np.int64)
            for b in blocks:
                count[b[name]] += 1
            assert (count == 1).all() or (count == tp).all(), (arch, name)
            whole = (count == tp).all()
            leaf = name.rsplit(".", 1)[-1]
            if leaf in ("gate", "scale", "bias", "kv_norm", "bq", "bk",
                        "bv", "bo"):
                assert whole, (arch, name)
            for m, b in zip(models, blocks):
                got = dict(m.named_parameters())[name].shape
                assert tuple(got) == count[b[name]].shape, (arch, name)


def test_the_engine_shares_what_both_layouts_cut_alike():
    """whisper at tp = 2: the decode model shares the prefill model's
    MLPs (``zero3``'s fsdp axis is the mesh's data axis of 1), norms,
    biases and embedding, and holds its own attention blocks
    (``megatron`` against ``decode_rp``); a cross layer's memory caches
    are the rank's run of the frames, the self caches its run of
    ``max_len``."""
    cfg = ARCHS[WHISPER].reduced()
    topo = Topo(tp_mesh(2))
    eng = ServeEngine(cfg, max_len=8, device="cpu", topo=topo,
                      group=LocalGroup.make(2)[1])
    pre = dict(eng.model.named_parameters())
    for name, p in eng.decode_model.named_parameters():
        own = name.rsplit(".", 1)[-1] in ("wq", "wk", "wv", "wo")
        assert (p is not pre[name]) == own, name
    caches = {g: {k: torch.zeros(cfg.num_layers, 2, n, 2, 32) for k in
                  ("k", "v")} for g, n in (("self", 6), ("cross", 12))}
    caches["self"]["k"][:, :, 5] = 1.0
    caches["cross"]["k"][:, :, 6:] = 2.0
    out = eng._pad_caches(caches, 2, memory_len=12)
    assert out["self"]["k"].shape[2] == 4 and out["cross"]["k"].shape[2] == 6
    assert (out["self"]["k"][:, :, 1] == 1.0).all()    # position 5, rank 1
    assert (out["cross"]["k"] == 2.0).all()             # frames 6..11
    assert out["cross"]["k"].dtype == torch.bfloat16


@pytest.mark.parametrize("arch", [VLM, WHISPER])
def test_the_launcher_serves_cross_attention_over_threads_as_on_one_device(
        arch, capsys, monkeypatch):
    """``launch.serve --arch <vlm or whisper> --smoke --tp 2 --group local
    --device cpu`` prints the ids of ``--tp 1`` (the launcher's stub image
    embeddings or 16 frames, cut over the ranks)."""
    from repro_torch.launch import serve

    def run(*extra):
        monkeypatch.setattr("sys.argv", [
            "serve", "--arch", arch, "--smoke", "--device", "cpu",
            "--tokens", "4", *extra])
        serve.main()
        out = capsys.readouterr().out
        return out[:out.index("prefill_tokens")]

    assert run("--tp", "2", "--group", "local") == run()

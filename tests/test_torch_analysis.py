"""The port's analysis tools (``repro_torch.analysis``, ``launch.dryrun``)
against the reference's (``repro.analysis``, ``repro.launch.dryrun``).

The cost counter is held to the reference's ``test_hlo_analysis``
contracts (exact product flops of a chain, a nested chain and one dot, one
multiply, a free view) and to its parser's count of the same JAX program;
the roofline to the reference's, exactly, on every (arch x shape) cell; the
kernel wrappers to their work functions on meta and on the CPU; and the
reduced models' steps counted on meta to the same steps on the CPU,
exactly, with the kernel calls of ``PERF.md``'s launch rules.
"""
import importlib
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.analysis import analyze_hlo_text
from repro.analysis.hardware import V5E as REF_V5E
from repro.analysis.hlo import Cost as RefCost
from repro.analysis.roofline import build_report as ref_build_report
from repro.analysis.roofline import model_bytes_per_device as ref_model_bytes
from repro.analysis.roofline import model_flops as ref_model_flops
from repro.configs import ARCHS as REF_ARCHS
from repro.configs import SHAPES as REF_SHAPES
from repro.configs import shape_applicable as ref_shape_applicable
from repro_torch.analysis import (CHIP_MODELS, H100, V5E, Cost, CostCounter,
                                  build_report, model_flops)
from repro_torch.analysis.roofline import model_bytes_per_device
from repro_torch.configs import ARCHS, SHAPES, ShapeConfig
from repro_torch.kernels import build
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import CARD, MESHES

# the kernel modules (``repro_torch.kernels`` exports ``ops``' functions
# under some of their names)
ema_mod, fa_mod, norm_mod, hist_mod, scan_mod = (
    importlib.import_module(f"repro_torch.kernels.{m}") for m in (
        "ema_scan", "flash_attention", "rmsnorm", "spike_hist", "ssm_scan"))
CELLS = [(a, s) for a in ARCHS for s in SHAPES]


def _count(fn, *track):
    c = CostCounter()
    c.track(*track)
    with c:
        fn()
    return c


# ---------------------------------------------------------------------------
# the reference's test_hlo_analysis contracts
# ---------------------------------------------------------------------------
def test_matmul_chain_counts_exactly():
    D, L, B = 128, 5, 16
    ws = [torch.randn(D, D) for _ in range(L)]
    x = torch.randn(B, D)

    def chain():
        h = x
        for w in ws:
            h = h @ w
    c = _count(chain)
    assert c.cost.flops == 2 * B * D * D * L
    assert c.matmul_flops == 2 * B * D * D * L
    assert c.cost.unresolved_loops == 0


def test_nested_chain_multiplies():
    D, L1, L2 = 64, 3, 4
    ws = [torch.randn(D, D) for _ in range(L1)]
    x = torch.randn(8, D)

    def nested():
        h = x
        for w in ws:
            for _ in range(L2):
                h = h @ w
    assert _count(nested).cost.flops == 2 * 8 * D * D * L1 * L2


def test_one_dot_and_its_bytes():
    a, b = torch.randn(32, 64), torch.randn(64, 48)
    c = _count(lambda: a @ b)
    assert c.cost.flops == 2 * 32 * 64 * 48
    assert c.cost.hbm_bytes >= (32 * 64 + 64 * 48 + 32 * 48) * 4
    assert c.cost.hbm_bytes_min == c.cost.hbm_bytes      # a dot materializes
    assert c.cost.tensor_flops == 0                       # float32: off them
    a16, b16 = a.to(torch.bfloat16), b.to(torch.bfloat16)
    assert _count(lambda: a16 @ b16).cost.tensor_flops == 2 * 32 * 64 * 48


def test_one_multiply_counts_its_elements_and_a_view_nothing():
    p = torch.randn(4)
    c = _count(lambda: p * p)
    assert c.cost.flops == 4
    assert c.cost.hbm_bytes_min == 0                      # fused away
    v = _count(lambda: p.view(2, 2).t())
    assert v.cost == Cost() and v.peak_bytes == 0


def test_the_reference_parser_agrees_with_the_count():
    """The reference's parse of the JAX scan chain lies within its own 5 %
    of the port's count of the same products."""
    D, L, B = 128, 5, 16

    def f(params, x):
        def body(h, w):
            return h @ w, ()
        h, _ = jax.lax.scan(body, x, params)
        return jnp.sum(h)
    compiled = jax.jit(f).lower(
        jax.ShapeDtypeStruct((L, D, D), jnp.float32),
        jax.ShapeDtypeStruct((B, D), jnp.float32)).compile()
    ref = analyze_hlo_text(compiled.as_text()).flops
    ws = torch.randn(L, D, D)
    x = torch.randn(B, D)

    def chain():
        h = x
        for w in ws:
            h = h @ w
        h.sum()
    ours = _count(chain).cost.flops
    assert abs(ref - ours) / ours < 0.05


def test_slices_and_gathers_move_twice_their_update():
    cache = torch.zeros(4, 16, 8)
    upd = torch.randn(4, 8)
    c = _count(lambda: cache[:, 3].copy_(upd))
    assert c.cost.hbm_bytes == 2 * upd.numel() * 4 == c.cost.hbm_bytes_min
    table = torch.randn(100, 8)
    idx = torch.tensor([1, 5, 7])
    g = _count(lambda: torch.nn.functional.embedding(idx, table))
    assert g.cost.hbm_bytes == 2 * 3 * 8 * 4


def test_peak_counts_what_is_alive():
    x = torch.randn(256)                       # 1 KiB, tracked

    def step():
        a = x * 2                              # +1 KiB
        b = a + 1                              # +1 KiB
        del a
        return b * 3                           # a freed: still 3 KiB
    c = _count(step, x)
    assert c.peak_bytes == 3 * 1024
    assert c.live_bytes == 1024                # the outputs are gone


# ---------------------------------------------------------------------------
# the roofline: exactly the reference's on every cell
# ---------------------------------------------------------------------------
def test_h100_is_the_card_and_not_in_the_fleet():
    assert H100.peak_flops_bf16 == 989e12 and H100.f32_rate == 67e12
    assert H100.hbm_bw == 3.35e12 and H100.hbm_bytes == 80e9
    assert H100.peak_flops_f64 == 34e12 and H100.sms == 132
    assert H100.tdp_w == 700.0 and H100.ici_links * H100.ici_link_bw == 450e9
    assert H100.name not in CHIP_MODELS and H100 not in CHIP_MODELS.values()
    assert V5E.f32_rate == V5E.peak_flops_bf16
    assert H100.compute_time(3e12, 1e12) == 1e12 / 989e12 + 2e12 / 67e12
    assert CARD.num_devices == 1 and CARD.model_axis_size == 1
    assert set(MESHES) == {"card"}


@pytest.mark.parametrize("arch,shape", CELLS)
def test_roofline_is_the_references(arch, shape):
    ref_cfg, ref_shape = REF_ARCHS[arch], REF_SHAPES[shape]
    cfg, sh = ARCHS[arch], SHAPES[shape]
    assert model_flops(cfg, sh) == ref_model_flops(ref_cfg, ref_shape)
    assert model_bytes_per_device(cfg, sh, 256, tp=16) == \
        ref_model_bytes(ref_cfg, ref_shape, 256, tp=16)
    fields = dict(flops=3.1e15, hbm_bytes=7.7e12, hbm_bytes_min=2.3e12,
                  coll_bytes={"all-reduce": 4.4e10, "all-gather": 1.5e9},
                  transcendentals=1e11)
    ref = ref_build_report(RefCost(**fields), ref_cfg, ref_shape, "single",
                           256, spec=REF_V5E, note="n")
    ours = build_report(Cost(**fields, tensor_flops=fields["flops"]), cfg, sh,
                        "single", 256, spec=V5E, note="n", tp=16)
    assert ours.to_dict() == ref.to_dict()
    # on one card: the report's own chip, tp = 1, float32 flops off the
    # tensor cores
    card = build_report(Cost(**fields, tensor_flops=1e15), cfg, sh, "card",
                        1)
    assert card.t_compute == 1e15 / 989e12 + 2.1e15 / 67e12
    assert card.t_collective == 4.55e10 / (18 * 25e9)
    assert card.model_bytes == model_bytes_per_device(cfg, sh, 1, tp=1)
    t_useful = max(card.model_flops / 989e12, card.model_bytes / 3.35e12)
    assert card.roofline_fraction == min(t_useful / card.step_time, 1.0)


# ---------------------------------------------------------------------------
# the kernel wrappers: their work functions, on meta and on the CPU
# ---------------------------------------------------------------------------
def _randn(shape, dtype, seed):
    g = np.random.default_rng(seed)
    return torch.from_numpy(g.standard_normal(shape).astype(np.float32)) \
        .to(dtype)


def _flash(dtype, causal, bwd):
    b, sq, skv, H, KV, dh = 2, 40, 56, 4, 2, 32
    q, do = _randn((b, sq, H, dh), dtype, 1), _randn((b, sq, H, dh), dtype, 4)
    k, v = _randn((b, skv, KV, dh), dtype, 2), _randn((b, skv, KV, dh),
                                                       dtype, 3)
    elem = q.element_size()
    if not bwd:
        flops, nbytes = fa_mod.attn_work(b, sq, skv, H, KV, dh, elem, causal)
        scratch = 0
        call = ("flash_attention", lambda t: fa_mod.flash_attention_bshd(
            *t[:3], causal, with_lse=True))
    else:
        flops, nbytes = fa_mod.attn_bwd_work(b, sq, skv, H, KV, dh, elem,
                                             causal)
        scratch = fa_mod.bwd_plan(b, sq, skv, H, KV, dh, 132, causal,
                                  simt=dtype == torch.float32).scratch_bytes
        o, lse = fa_mod.flash_attention_plain(q, k, v, causal, with_lse=True)
        call = ("flash_attention_bwd", lambda t: fa_mod.flash_attention_bwd(
            *t, causal))
    tensor = flops if dtype == torch.bfloat16 else 0.0
    ins = (q, k, v) if not bwd else (q, k, v, o, lse, do)
    return ins, call, build.Work(flops, nbytes, 0, tensor, scratch)


def _norm(bwd):
    n, d = 24, 256
    x, dy = _randn((n, d), torch.bfloat16, 5), _randn((n, d), torch.bfloat16,
                                                      6)
    sc = 1 + _randn((d,), torch.float32, 7) * 0.1
    if not bwd:
        w = norm_mod.norm_work(n, d, 2, 4)
        return (x, sc), ("rmsnorm", lambda t: norm_mod.rmsnorm_rows(*t)), \
            build.Work(w["flops"], w["bytes"])
    w = norm_mod.norm_bwd_work(n, d, 2, 4)
    plan = norm_mod.bwd_plan(n, d, 2, 4, True, 132)
    return (x, sc, dy), ("rmsnorm_bwd",
                         lambda t: norm_mod.rmsnorm_bwd(*t)), \
        build.Work(w["flops"], w["bytes"], scratch=4 * plan.partial_floats)


def _scan(bwd, full):
    b, s, di, ds = 2, 12, 48, 8
    x = _randn((b, s, di), torch.bfloat16, 8)
    dt = torch.nn.functional.softplus(_randn((b, s, di), torch.float32, 9))
    A = -torch.exp(_randn((di, ds), torch.float32, 10))
    B, C = _randn((b, s, ds), torch.float32, 11), _randn((b, s, ds),
                                                         torch.float32, 12)
    D = _randn((di,), torch.float32, 13) if full else None
    h0 = _randn((b, di, ds), torch.float32, 14) if full else None
    if not bwd:
        w = scan_mod.scan_work(b, s, di, ds, 2, 4, skip=full, h0=full)
        return (x, dt, A, B, C, D, h0), (
            "ssm_scan", lambda t: scan_mod.ssm_scan_bsd(*t)), \
            build.Work(w["flops"], w["bytes"], w["exps"])
    dy = _randn((b, s, di), torch.bfloat16, 15)
    dh = _randn((b, di, ds), torch.float32, 16) if full else None
    w = scan_mod.scan_bwd_work(b, s, di, ds, 2, 4, skip=full, h0=full,
                               dh_last=full)
    ws = scan_mod.bwd_plan(b, s, di, ds, 132).workspace_floats(full)
    return (x, dt, A, B, C, D, h0, dy, dh), (
        "ssm_scan_bwd", lambda t: scan_mod.ssm_scan_bwd(*t)), \
        build.Work(w["flops"], w["bytes"], w["exps"], scratch=4 * ws)


def _hist(extras):
    r = torch.from_numpy(np.random.default_rng(17).uniform(
        0.0, 2.5, (6, 300)))
    sizes, nb = (0.05, 0.1, 0.5), (30, 15, 3)
    div = torch.tensor(1.25, dtype=torch.float64) if extras else None
    out = torch.zeros((6, 48), dtype=torch.float64) if extras else None
    rel = r if div is None else r / div
    n_spike = int((rel >= 0.5).sum())

    def work(spikes):
        w = hist_mod.hist_work(6, 300, 8, 3, 48, spikes,
                               divisor=1 if extras else 0, out=extras)
        return build.Work(w["flops"], w["bytes"])
    return (r, div, out), ("spike_hist", lambda t: hist_mod.spike_hist_batch(
        t[0], sizes, nb, divisor=t[1], out=t[2])), (work(n_spike),
                                                    work(6 * 300))


def _ema(blocks):
    if not blocks:
        x = _randn((3, 500), torch.float32, 18)
        w = ema_mod.ema_rows_work(3, 500)
        return (x,), ("ema_scan", lambda t: ema_mod.ema_scan_rows(t[0])), \
            build.Work(w["flops"], w["bytes"])
    x = _randn((4, 600), torch.float64, 19)
    st = _randn((4,), torch.float64, 20)
    has = torch.ones(4, dtype=torch.bool)
    # state and flag read, both written
    w = ema_mod.ema_blocks_work(4 * 600, 4, 8 + 1 + 9)
    return (x, st, has), ("ema_scan", lambda t: ema_mod.ema_scan_blocks(
        t[0], t[1], t[2], state_out=t[1], has_out=t[2])), \
        build.Work(w["flops"], w["bytes"])


KERNEL_CASES = {
    "flash_bf16_causal": lambda: _flash(torch.bfloat16, True, False),
    "flash_f32_full": lambda: _flash(torch.float32, False, False),
    "flash_bwd_bf16": lambda: _flash(torch.bfloat16, True, True),
    "flash_bwd_f32": lambda: _flash(torch.float32, False, True),
    "rmsnorm": lambda: _norm(False),
    "rmsnorm_bwd": lambda: _norm(True),
    "ssm_scan": lambda: _scan(False, False),
    "ssm_scan_full": lambda: _scan(False, True),
    "ssm_scan_bwd": lambda: _scan(True, False),
    "ssm_scan_bwd_full": lambda: _scan(True, True),
    "spike_hist": lambda: _hist(False),
    "spike_hist_divisor_out": lambda: _hist(True),
    "ema_scan_rows": lambda: _ema(False),
    "ema_scan_blocks": lambda: _ema(True),
}


def _on(ts, device):
    return tuple(None if t is None else t.to(device) for t in ts)


@pytest.mark.parametrize("case", sorted(KERNEL_CASES))
def test_a_kernel_call_records_its_work_on_meta_and_cpu(case):
    ins, (name, fn), want = KERNEL_CASES[case]()
    wants = (want, want) if isinstance(want, build.Work) else want
    before = dict(build.LAUNCHES)
    outs = {}
    for device, w in zip(("cpu", "meta"), wants):
        c = CostCounter()
        args = _on(ins, device)
        c.track(args)
        live = c.live_bytes
        with c:
            got = fn(args)
        outs[device] = got
        assert c.calls == {name: 1}
        assert c.cost == Cost(flops=w.flops, hbm_bytes=w.bytes,
                              hbm_bytes_min=w.bytes, transcendentals=w.exps,
                              tensor_flops=w.tensor_flops), device
        out_bytes = sum(t.untyped_storage().nbytes() for t in
                        {id(t.untyped_storage()): t for t in
                         torch.utils._pytree.tree_leaves(got)
                         if isinstance(t, torch.Tensor)
                         and not any(t.untyped_storage() is a.untyped_storage()
                                     for a in args if a is not None)}.values())
        assert c.peak_bytes == live + out_bytes + w.scratch, device
    assert build.LAUNCHES == before               # meta launches nothing
    flat = [torch.utils._pytree.tree_leaves(outs[d]) for d in ("cpu", "meta")]
    assert [(t.shape, t.dtype, t.stride()) for t in flat[0] if t is not None] \
        == [(t.shape, t.dtype, t.stride()) for t in flat[1] if t is not None]
    assert all(t.device.type == "meta" for t in flat[1] if t is not None)


def test_meta_never_reaches_a_twin(monkeypatch):
    cases = [KERNEL_CASES[case]() for case in sorted(KERNEL_CASES)]

    def refuse(*a, **k):
        raise AssertionError("a plain twin ran on meta")
    for mod, twin in ((fa_mod, "flash_attention_plain"),
                      (fa_mod, "flash_attention_bwd_plain"),
                      (norm_mod, "rmsnorm_plain"),
                      (norm_mod, "rmsnorm_bwd_plain"),
                      (scan_mod, "ssm_scan_plain"),
                      (scan_mod, "ssm_scan_bwd_plain"),
                      (hist_mod, "spike_hist_batch_plain"),
                      (ema_mod, "ema_scan_plain"),
                      (ema_mod, "ema_scan_blocks_plain")):
        monkeypatch.setattr(mod, twin, refuse)
    for ins, (_, fn), _ in cases:
        fn(_on(ins, "meta"))
    with pytest.raises(RuntimeError, match="requires grad"):
        x = torch.empty(4, 8, device="meta", requires_grad=True)
        norm_mod.rmsnorm_rows(x, torch.ones(8, device="meta"))
    with pytest.raises(ValueError, match="cuda, cpu or meta"):
        norm_mod.rmsnorm_rows(torch.ones(4, 8), torch.ones(8, device="meta"))


def test_chip_smoke_bounds_read_the_work_functions():
    """The counts behind chip_smoke's printed bounds: flash 4 dh flops a
    visible pair forward and 10 dh backward; rmsnorm x read and written
    (and dy read) in x's dtype; the bf16 prefill norm's 2 (2 n d + d)."""
    f, nb = fa_mod.attn_work(4, 1024, 1024, 32, 2, 128, 2)
    fb, nbb = fa_mod.attn_bwd_work(4, 1024, 1024, 32, 2, 128, 2)
    assert fb == 2.5 * f == 10 * 128 * 1024 * 1025 // 2 * 4 * 32
    assert nbb == 2 * nb + 4 * 32 * 1024 * 4
    assert norm_mod.norm_work(4000, 4096, 2, 2) == dict(
        bytes=2.0 * (2 * 4000 * 4096 + 4096), exps=0, flops=4 * 4000 * 4096)
    assert norm_mod.norm_bwd_work(4096, 4096, 2, 4)["bytes"] == \
        3 * 4096 * 4096 * 2 + 2 * 4096 * 4
    w = hist_mod.hist_work(1, 256, 8, 6, 150, 100, divisor=1, out=True)
    assert w["bytes"] == 256 * 8 + 8 + 2 * 150 * 8
    assert ema_mod.ema_blocks_work(2_560_000, 10_000, 25)["bytes"] == \
        2_560_000 * 16 + 10_000 * 25


# ---------------------------------------------------------------------------
# the reduced models: meta counts the CPU's step exactly
# ---------------------------------------------------------------------------
FAMILIES = ("glm4-9b", "falcon-mamba-7b", "granite-moe-3b-a800m",
            "deepseek-v2-236b", "whisper-medium", "llama-3.2-vision-11b",
            "jamba-1.5-large-398b")
KINDS = {"prefill": ShapeConfig("p", 64, 2, "prefill"),
         "decode": ShapeConfig("d", 64, 2, "decode"),
         "train": ShapeConfig("t", 64, 2, "train")}


def _train_calls(cfg) -> dict:
    """PERF.md's launch rules for one train step (remat, one microbatch):
    an attention sublayer 2 flash and 1 ``flash_attention_bwd``, a Mamba
    sublayer 2 ``ssm_scan`` and 1 ``ssm_scan_bwd``; every rmsnorm twice
    forward (remat) and once backward, the final norm once each."""
    from repro_torch.models.model_zoo import build_model
    model = build_model(cfg, kind="train", device="meta")
    if cfg.is_encoder_decoder:
        attn = cfg.num_encoder_layers + 2 * cfg.num_layers
        return {"flash_attention": 2 * attn, "flash_attention_bwd": attn}
    kinds = [k for _ in range(model.n_periods) for _, k in model.period_kinds]
    attn = sum(k in ("attn", "cross") for k in kinds)
    mamba = kinds.count("mamba")
    norms = len(kinds) + sum(k == "mla" for k in kinds)   # MLA's latent norm
    calls = {"rmsnorm": 2 * norms + 1, "rmsnorm_bwd": norms + 1}
    if attn:
        calls.update(flash_attention=2 * attn, flash_attention_bwd=attn)
    if mamba:
        calls.update(ssm_scan=2 * mamba, ssm_scan_bwd=mamba)
    return calls


@pytest.mark.parametrize("kind", sorted(KINDS))
@pytest.mark.parametrize("arch", FAMILIES)
def test_meta_counts_the_cpu_step_exactly(arch, kind):
    cfg = ARCHS[arch].reduced()
    shape = KINDS[kind]
    before = dict(build.LAUNCHES)
    meta, _ = dryrun.count_cell(dryrun.make_cell(cfg, shape, "meta"))
    host, _ = dryrun.count_cell(dryrun.make_cell(cfg, shape, "cpu"))
    assert build.LAUNCHES == before
    assert meta.cost == host.cost
    assert meta.peak_bytes == host.peak_bytes
    assert meta.calls == host.calls
    assert meta.matmul_flops == host.matmul_flops
    assert meta.cost.flops > meta.matmul_flops > 0
    if kind == "train":
        assert meta.calls == _train_calls(cfg)


def test_reduced_glm_prefill_products_are_its_weights():
    """2 tokens (every layer's product weights), plus the head on the last
    token of each sequence: attention's own products run in the flash
    kernel."""
    cfg = ARCHS["glm4-9b"].reduced()
    shape = KINDS["prefill"]
    cell = dryrun.make_cell(cfg, shape, "meta")
    counter, _ = dryrun.count_cell(cell)
    # wq, wk, wv, wo, w_gate, w_up, w_down (biases and scales are adds)
    weights = sum(p.numel() for n, p in cell.args["params"].items()
                  if n.startswith("layers.")
                  and n.rsplit(".", 1)[1].startswith("w"))
    head = cfg.d_model * cfg.padded_vocab
    assert counter.matmul_flops == 2 * shape.tokens * weights \
        + 2 * shape.global_batch * head
    assert counter.calls == {"flash_attention": cfg.num_layers,
                             "rmsnorm": 2 * cfg.num_layers + 1}


# ---------------------------------------------------------------------------
# the dry run's cells and records
# ---------------------------------------------------------------------------
def _ref_dryrun():
    """The reference's dry-run module; it sets XLA_FLAGS when imported, so
    the variable is put back."""
    saved = os.environ.get("XLA_FLAGS")
    try:
        import repro.launch.dryrun as ref
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return ref


def test_cells_are_the_references():
    ref = _ref_dryrun()
    ref_cells = ref.all_cell_ids("single")
    ours = dryrun.all_cell_ids("card")
    assert [(a, s) for a, s, _ in ours] == [(a, s) for a, s, _ in ref_cells]
    assert {m for _, _, m in ours} == {"card"}
    for a, s, _ in ours:
        assert dryrun._cell_microbatches(a, s) == ref._cell_microbatches(a, s)
        assert shape_reason(a, s) == ref_shape_applicable(
            REF_ARCHS[a].family, REF_SHAPES[s])


def shape_reason(arch, shape):
    from repro_torch.configs import shape_applicable
    return shape_applicable(ARCHS[arch].family, SHAPES[shape])


def test_one_cell_writes_the_references_keys(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", [
        "dryrun", "--one", "whisper-medium", "decode_32k", "card",
        "--out", str(tmp_path)])
    dryrun.main()
    rec = json.loads((tmp_path / "card" / "whisper-medium__decode_32k.json")
                     .read_text())
    assert rec["status"] == "OK" and rec["n_chips"] == 1
    ref_keys = {"arch", "shape", "mesh", "status", "kind", "microbatches",
                "n_chips", "memory", "roofline", "timings"}
    assert ref_keys <= set(rec)
    assert {"args_bytes", "output_bytes", "temp_bytes", "alias_bytes"} <= \
        set(rec["memory"])
    fields = dict(flops=1.0, hbm_bytes=1.0, hbm_bytes_min=1.0)
    ref_dict = ref_build_report(RefCost(**fields), REF_ARCHS["whisper-medium"],
                                REF_SHAPES["decode_32k"], "single",
                                1).to_dict()
    assert set(rec["roofline"]) == set(ref_dict)
    mem = rec["memory"]
    assert mem["args_bytes"] + mem["temp_bytes"] == mem["peak_bytes"]
    assert rec["fits"] == (mem["peak_bytes"] <= 80e9)
    assert rec["calls"] == {}          # LayerNorm; decode attends in PyTorch
    assert rec["roofline"]["t_collective"] == 0.0
    assert rec["cost"]["tensor_flops"] > 0

    monkeypatch.setattr(sys, "argv", [
        "dryrun", "--one", "glm4-9b", "long_500k", "card",
        "--out", str(tmp_path)])
    dryrun.main()
    skip = json.loads((tmp_path / "card" / "glm4-9b__long_500k.json")
                      .read_text())
    ok, reason = ref_shape_applicable("dense", REF_SHAPES["long_500k"])
    assert skip == {"arch": "glm4-9b", "shape": "long_500k", "mesh": "card",
                    "status": "SKIP", "reason": reason} and not ok

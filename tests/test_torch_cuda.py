"""The port's CUDA kernels on the card (``cuda`` marker; skipped without a
card).  Imports neither JAX nor the reference package, so it runs on a
machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest``: the suite's conftest imports JAX.)
"""
import numpy as np
import pytest
import torch

from repro_torch.core import spikes
from repro_torch.kernels import (build, ema_scan_blocks,
                                 ema_scan_blocks_plain, ema_scan_plain,
                                 ema_scan_rows,
                                 flash_attention, flash_attention_plain,
                                 rmsnorm, rmsnorm_plain, spike_hist,
                                 spike_hist_batch, spike_hist_batch_plain,
                                 ssm_scan, ssm_scan_plain)
from repro_torch.pipeline import BatchProfileEngine, ProfileBuilder
from repro_torch.telemetry import TelemetryChunk, TraceMeta

BINS = (0.05, 0.1, 0.15, 0.2, 0.25, 0.5)
NBINS = tuple(spikes.num_bins(c) for c in BINS)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only there")
    return torch.device("cuda")


def _edges() -> np.ndarray:
    e = np.array([spikes.SPIKE_LO + k * c for c, n in zip(BINS, NBINS)
                  for k in range(n + 1)])
    return np.concatenate([e, np.nextafter(e, np.inf),
                           np.nextafter(e, -np.inf), e + 1e-12, e - 1e-12])


def _hist_block(rows, cols, seed):
    """Uniform relative power with every bin edge and its neighbours one ulp
    and 1e-12 away at the start, and a tenth of the samples -inf."""
    rng = np.random.default_rng(seed)
    r = rng.uniform(0.0, 2.5, (rows, cols))
    flat = r.reshape(-1)
    edges = _edges()[:flat.size]
    flat[:len(edges)] = edges
    r[rng.random(r.shape) < 0.1] = -np.inf
    return r


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [1, 7, 300, 10_000])
@pytest.mark.parametrize("cols", [1, 3, 31, 32, 33, 256, 257, 5000])
def test_spike_hist_equals_plain(cuda, rows, cols):
    r = _hist_block(rows, cols, rows + cols)
    for dtype in (torch.float64, torch.float32):
        t = torch.from_numpy(r).to(cuda, dtype)
        before = build.LAUNCHES["spike_hist"]
        got = spike_hist_batch(t, BINS, NBINS)
        assert build.LAUNCHES["spike_hist"] == before + 1
        # the plain version on the host for small blocks, on the card else
        small = t.numel() <= 1 << 20
        want = spike_hist_batch_plain(t.cpu() if small else t, BINS, NBINS)
        assert torch.equal(got.cpu(), want.cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("rows,cols", [(1, 100_000), (3, 70_001),
                                       (1, 4000)])
def test_spike_hist_split_row_equals_plain(cuda, rows, cols):
    """One long trace over several CTAs (the partial counts meet in
    atomics), and the single-trace shape of ops.spike_hist."""
    from repro_torch.kernels.spike_hist import _hist_layout
    r = _hist_block(rows, cols, cols)
    assert (_hist_layout(rows, cols, sum(NBINS))[1] > 1) == (cols > 4096)
    for dtype in (torch.float64, torch.float32):
        t = torch.from_numpy(r).to(cuda, dtype)
        want = spike_hist_batch_plain(t.cpu(), BINS, NBINS)
        assert torch.equal(spike_hist_batch(t, BINS, NBINS).cpu(), want)
        out = torch.ones((rows, sum(NBINS)), dtype=torch.float64,
                         device=cuda)
        spike_hist_batch(t, BINS, NBINS, out=out)
        assert torch.equal(out.cpu(), want.to(torch.float64) + 1)


@pytest.mark.cuda
@pytest.mark.parametrize("rows,cols", [(1, 256), (7, 33), (300, 256),
                                       (2, 5000)])
@pytest.mark.parametrize("per_row", [False, True])
def test_spike_hist_out_rows_divisor_equals_plain(cuda, rows, cols, per_row):
    """Accumulate into out[rows[i]] (repeated indices add up) the counts of
    r / divisor, exactly as the plain version (index_add_ of the counts of
    torch.div)."""
    rng = np.random.default_rng(rows * cols)
    tdp = rng.uniform(100.0, 300.0, rows if per_row else ())
    p = _hist_block(rows, cols, cols) * (tdp[:, None] if per_row else tdp)
    idx = rng.integers(0, max(rows // 2, 1), rows)
    idx[-1] = idx[0]                                   # a repeated row
    base = rng.integers(0, 50, (max(rows // 2, 1), sum(NBINS))).astype(float)
    for dtype in (torch.float64, torch.float32):
        t = torch.from_numpy(p).to(cuda, dtype)
        div = torch.tensor(tdp, dtype=dtype, device=cuda)
        rows_t = torch.from_numpy(idx).to(cuda)
        out = torch.from_numpy(base).to(cuda)
        before = build.LAUNCHES["spike_hist"]
        got = spike_hist_batch(t, BINS, NBINS, out=out, rows=rows_t,
                               divisor=div)
        assert got is out and build.LAUNCHES["spike_hist"] == before + 1
        want = spike_hist_batch_plain(t.cpu(), BINS, NBINS,
                                      out=torch.from_numpy(base),
                                      rows=rows_t.cpu(), divisor=div.cpu())
        assert torch.equal(out.cpu(), want)
        two_step = torch.from_numpy(base).index_add_(
            0, rows_t.cpu(), spike_hist_batch_plain(
                t.cpu() / (div.cpu()[:, None] if per_row else div.cpu()),
                BINS, NBINS).to(torch.float64))
        assert torch.equal(want, two_step)


@pytest.mark.cuda
def test_ops_spike_hist_on_card_equals_host(cuda):
    p = torch.from_numpy(np.random.default_rng(1).uniform(0, 400, 3000))
    assert torch.equal(spike_hist(p.to(cuda), 197.0).cpu(),
                       spike_hist(p, 197.0))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(4000,), (3, 1000), (1,), (2, 33)])
def test_ema_scan_close_to_plain(cuda, shape):
    # f32 tolerance: the kernel and the plain version round in f32 in
    # different orders; the alpha = 0.5 filter keeps the error from growing
    x = torch.from_numpy(np.random.default_rng(2).uniform(0, 300, shape)
                         .astype(np.float32))
    got = ema_scan_rows(x.to(cuda)).cpu()
    torch.testing.assert_close(got, ema_scan_plain(x), rtol=0,
                               atol=1e-5 * 300)


@pytest.mark.cuda
def test_wrappers_reject_non_contiguous(cuda):
    r = torch.zeros((4, 8), dtype=torch.float64, device=cuda).t()
    with pytest.raises(ValueError, match="contiguous"):
        spike_hist_batch(r, BINS, NBINS)
    with pytest.raises(ValueError, match="contiguous"):
        ema_scan_rows(torch.zeros((4, 8), device=cuda).t())


def _blocks_case(seed, lengths, has_bits, cuda):
    """Ragged float64 rows with their states on the card and the host."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.uniform(0.0, 400.0, int(sum(lengths))))
    state = torch.from_numpy(rng.uniform(0.0, 400.0, len(lengths)))
    has = torch.tensor(has_bits, dtype=torch.bool)
    offs = np.concatenate([[0], np.cumsum(lengths)])
    return {d: (x.to(d), state.to(d), has.to(d)) for d in (cuda, "cpu")}, offs


@pytest.mark.cuda
@pytest.mark.parametrize("alpha", [0.5, 1.0, 0.999])
@pytest.mark.parametrize("state_mode", ["none", "all", "mixed"])
def test_ema_blocks_equal_plain_ragged(cuda, alpha, state_mode):
    # the edge lengths, rows of length 0 among them, one launch
    lengths = [1, 255, 256, 0, 257, 512, 4 * 256 + 3, 0]
    has_bits = [state_mode == "all" or (state_mode == "mixed" and j % 2)
                for j in range(len(lengths))]
    t, offs = _blocks_case(len(lengths), lengths, has_bits, cuda)
    before = build.LAUNCHES["ema_scan"]
    got = ema_scan_blocks(*t[cuda], alpha, offsets=offs)
    assert build.LAUNCHES["ema_scan"] == before + 1
    assert torch.equal(got.cpu(), ema_scan_blocks_plain(*t["cpu"], alpha,
                                                        offsets=offs))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 255, 256, 257, 512, 4 * 256 + 3])
def test_ema_blocks_one_row_equal_plain(cuda, n):
    # the builder's ingest and pending view: one row, a 0-dim state
    x = torch.from_numpy(np.random.default_rng(n).uniform(0, 400, n))
    s = torch.tensor(211.5, dtype=torch.float64)
    for state, has in ((None, False), (s, True)):
        got = ema_scan_blocks(x.to(cuda), None if state is None
                              else state.to(cuda), has)
        assert torch.equal(got.cpu(), ema_scan_blocks_plain(x, state, has))


@pytest.mark.cuda
@pytest.mark.parametrize("alpha", [0.5, 0.999])
def test_ema_blocks_stop_at_zero_decay_on_card(cuda, alpha):
    # an infinite sample: a step past the reference's last (a decay of 0.0)
    # would turn what follows it into NaN
    x = torch.from_numpy(np.random.default_rng(3).uniform(0, 400, 768))
    x[261] = torch.inf
    got = ema_scan_blocks(x.to(cuda), alpha=alpha).cpu()
    want = ema_scan_blocks_plain(x, alpha=alpha)
    assert not want.isnan().any()
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("has", [False, True])
def test_ema_blocks_group_advance_equal_plain(cuda, has):
    # the engine's (10,000, 256) group advance out of (rows, 300) buffers,
    # states gathered from and written to a column through slot indices
    rng = np.random.default_rng(11)
    buf = torch.from_numpy(rng.uniform(0, 400, (10_000, 300)))
    col = torch.from_numpy(rng.uniform(0, 400, 16_384))
    idx = torch.from_numpy(rng.permutation(16_384)[:10_000])
    outs = {}
    for d in (cuda, "cpu"):
        state = col.to(d, copy=True)
        flag = torch.zeros(16_384, dtype=torch.bool, device=d)
        got = ema_scan_blocks(buf.to(d), state, has, 0.5, n=256,
                              index=idx.to(d), state_out=state, has_out=flag)
        outs[d] = (got.cpu(), state.cpu(), flag.cpu())
    for a, b in zip(outs[cuda], outs["cpu"]):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_ema_blocks_snapshot_rows_equal_plain(cuda):
    # a snapshot: ~42 pending rows of 4-250 samples with state, at slots
    rng = np.random.default_rng(12)
    lengths = rng.integers(4, 251, 42)
    t, offs = _blocks_case(12, lengths, [True] * 42, cuda)
    got = ema_scan_blocks(*t[cuda], 0.5, offsets=offs)
    assert torch.equal(got.cpu(), ema_scan_blocks_plain(*t["cpu"], 0.5,
                                                        offsets=offs))
    with pytest.raises(ValueError, match="blocks of 256"):
        ema_scan_blocks(*t[cuda], 0.5, offsets=offs, block=128)


def _counters(seed, n):
    rng = np.random.default_rng(seed)
    power = rng.uniform(0.0, 250.0, n)
    busy = (rng.random(n) < 0.8).astype(float)
    e = np.concatenate([[0.0], np.cumsum(power * 1e-3)])
    b = np.concatenate([[0.0], np.cumsum(busy * 1e-3)])
    meta = TraceMeta(name=f"s{seed}", domain="t", sample_dt=1e-3,
                     n_samples=n, exec_time=1.0, app_sm_util=0.5,
                     app_dram_util=0.5)
    return meta, e, b


@pytest.mark.cuda
def test_engine_and_builder_on_card_bitwise_equal_host(cuda):
    engines = {d: BatchProfileEngine(capacity=2, device=d)
               for d in (cuda, "cpu")}
    builders = {}
    for k in range(5):
        meta, e, b = _counters(k, 900)
        for d, eng in engines.items():
            builders[(d, k)] = (eng.builder(meta, 197.0),
                                ProfileBuilder(meta, 197.0, device=d), e, b)
    for i, j in ((0, 300), (300, 700), (700, 900)):
        for d, eng in engines.items():
            slots, chunks = [], []
            for k in range(5):
                sb, pb, e, b = builders[(d, k)]
                ck = TelemetryChunk(energy_j=e[i + 1:j + 1],
                                    busy_s=b[i + 1:j + 1], sample_dt=1e-3,
                                    start_index=i)
                slots.append(sb.slot)
                chunks.append(ck)
                pb.ingest(ck)
            eng.ingest_batch(slots, chunks)
    a, h = engines[cuda], engines["cpu"]
    for name in ("_hist_all", "_ema_state", "_n_committed", "_seen_busy"):
        assert torch.equal(getattr(a, name).cpu(), getattr(h, name)), name
    for k in range(5):
        ca, cb = builders[(cuda, k)][1].finalize(), \
            builders[("cpu", k)][1].finalize()
        assert torch.equal(ca.power_trace.cpu(), cb.power_trace)
        for c in BINS:
            assert torch.equal(ca.spike_vec(c).cpu(), cb.spike_vec(c))


# tests/test_kernels.py's tolerances: bf16 rounding of the output, float32
# rounding of a softmax or a mean of squares in another order
TOL = {torch.bfloat16: dict(rtol=2e-2, atol=2e-2),
       torch.float32: dict(rtol=3e-5, atol=3e-5)}


def _attn_inputs(cuda, b, sq, skv, H, KV, dh, dtype):
    rng = np.random.default_rng(sq + skv + H)
    return [torch.from_numpy(rng.standard_normal(s, np.float32))
            .to(cuda, dtype) for s in
            ((b, sq, H, dh), (b, skv, KV, dh), (b, skv, KV, dh))]


@pytest.mark.cuda
@pytest.mark.parametrize("b,sq,skv,H,KV,dh,causal", [
    (2, 128, 128, 8, 2, 64, True),       # GQA 4:1, whole blocks
    (1, 1000, 1000, 32, 2, 128, True),   # ragged tail, glm4-9b heads
    (2, 37, 300, 4, 1, 32, True),        # sq < skv: bottom-right causal
    (1, 1, 77, 8, 2, 128, True),         # one query row
    (2, 64, 200, 8, 8, 128, False),      # bidirectional, ragged keys
    # around the 128-row query blocks and 128-key tiles
    (1, 1, 1, 4, 1, 32, True),
    (2, 127, 127, 8, 8, 64, True),
    (1, 128, 128, 8, 1, 128, False),
    (2, 129, 129, 4, 2, 128, True),
    (1, 128, 129, 2, 2, 32, True),
    (3, 127, 128, 8, 2, 64, True),
    (1, 127, 1000, 8, 2, 64, True),
    (1, 129, 2048, 16, 8, 128, True),
    (1, 1, 2048, 8, 1, 64, True),
    (2, 1000, 1000, 8, 2, 32, False),
    (1, 1000, 2048, 4, 1, 128, False),
    (1, 2048, 2048, 16, 2, 128, True),
    (1, 2048, 2048, 8, 8, 32, True),
    (2, 129, 1000, 8, 1, 128, False),
])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_attention_close_to_plain(cuda, b, sq, skv, H, KV, dh, causal,
                                        dtype):
    q, k, v = _attn_inputs(cuda, b, sq, skv, H, KV, dh, dtype)
    before = build.LAUNCHES["flash_attention"]
    got = flash_attention(q, k, v, causal=causal)
    assert build.LAUNCHES["flash_attention"] == before + 1
    torch.cuda.synchronize()
    want = flash_attention_plain(q, k, v, causal=causal)
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_attention_is_deterministic(cuda, dtype):
    """No atomics and no order that varies: two calls give equal bits."""
    q, k, v = _attn_inputs(cuda, 4, 1000, 1000, 32, 2, 128, dtype)
    first = flash_attention(q, k, v, causal=True)
    assert torch.equal(flash_attention(q, k, v, causal=True), first)


@pytest.mark.cuda
def test_flash_attention_reads_through_strides(cuda):
    """q, k, v as head slices of one packed (b, s, H + 2 KV, dh) tensor."""
    b, s, H, KV, dh = 2, 130, 8, 2, 64
    qkv = torch.randn((b, s, H + 2 * KV, dh), device=cuda,
                      generator=torch.Generator(cuda).manual_seed(0)
                      ).to(torch.bfloat16)
    q, k, v = qkv.split([H, KV, KV], dim=2)
    assert not q.is_contiguous()
    got = flash_attention(q, k, v, causal=True)
    want = flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                           causal=True)
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_flash_attention_rejects_what_the_kernel_does_not_take(cuda):
    q = torch.zeros((1, 8, 4, 48), device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention(q, q[:, :, :2], q[:, :, :2])
    x = torch.zeros((1, 8, 4, 66), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="aligned"):
        flash_attention(x[..., :64], x[:, :, :2, :64], x[:, :, :2, :64])


@pytest.mark.cuda
@pytest.mark.parametrize("n,d", [(4096, 4096), (4, 4096), (100, 384),
                                 (7, 100), (3, 1), (1, 4096), (4000, 4096),
                                 (2048, 4096), (5, 8192), (3, 20000)])
@pytest.mark.parametrize("dtype,sdtype", [
    (torch.bfloat16, torch.bfloat16), (torch.bfloat16, torch.float32),
    (torch.float32, torch.float32), (torch.float32, torch.bfloat16)])
def test_rmsnorm_close_to_plain(cuda, n, d, dtype, sdtype):
    rng = np.random.default_rng(n + d)
    x = torch.from_numpy(rng.standard_normal((n, d), np.float32) * 3
                         ).to(cuda, dtype)
    sc = torch.from_numpy(rng.standard_normal(d, np.float32)).to(cuda,
                                                                 sdtype)
    before = build.LAUNCHES["rmsnorm"]
    got = rmsnorm(x, sc, 1e-5)
    assert build.LAUNCHES["rmsnorm"] == before + 1
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), rmsnorm_plain(x, sc).float(),
                               **TOL[dtype])
    # a row view that is not 16-byte aligned takes the scalar loads
    if n > 1 and d % 8:
        torch.testing.assert_close(rmsnorm(x[1:], sc).float(),
                                   rmsnorm_plain(x[1:], sc).float(),
                                   **TOL[dtype])
    # rows that start one element past a 16-byte boundary
    flat = torch.empty(n * d + 1, dtype=dtype, device=cuda)
    xm = flat[1:].view(n, d)
    xm.copy_(x)
    torch.testing.assert_close(rmsnorm(xm, sc).float(),
                               rmsnorm_plain(x, sc).float(), **TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("n,d", [(1, 4096), (4, 4096), (300, 4096),
                                 (7, 1000), (3, 2048), (2, 8192)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_rmsnorm_pdl_close_to_plain(cuda, n, d, dtype):
    """Launched with programmatic dependent launch, as Norm launches it, the
    kernel gives what it gives without."""
    from repro_torch.kernels import rmsnorm_rows
    rng = np.random.default_rng(n * d)
    x = torch.from_numpy(rng.standard_normal((n, d), np.float32) * 3
                         ).to(cuda, dtype)
    sc = torch.from_numpy(rng.standard_normal(d, np.float32)).to(cuda, dtype)
    want = rmsnorm_plain(x, sc).float()
    plain_launch = rmsnorm_rows(x, sc, 1e-5)
    torch.testing.assert_close(plain_launch.float(), want, **TOL[dtype])
    assert torch.equal(rmsnorm_rows(x, sc, 1e-5, pdl=True), plain_launch)


@pytest.mark.cuda
def test_rmsnorm_scale_written_just_before(cuda):
    """A scale that the kernel just before the norm writes (a cast, a scale
    computed on the fly) is read after that kernel: the default launch has
    no programmatic dependence."""
    from repro_torch.kernels import rmsnorm_rows
    g = torch.Generator(cuda).manual_seed(1)
    x = torch.randn((4, 4096), generator=g, device=cuda).to(torch.bfloat16)
    src = torch.randn(4096, generator=g, device=cuda)
    for i in range(20):
        big = torch.randn((1 << 22,), generator=g, device=cuda)
        sc = torch.empty(4096, dtype=torch.bfloat16, device=cuda)
        big.mul_(2.0)                     # keep the card busy before it
        sc.copy_(src * (i + 1))           # written by the kernel just before
        got = rmsnorm_rows(x, sc, 1e-5)
        torch.testing.assert_close(
            got.float(), rmsnorm_plain(x, sc).float(), **TOL[torch.bfloat16])


@pytest.mark.cuda
@pytest.mark.parametrize("pdl", [False, True])
def test_rmsnorm_decode_chain_graph_equals_eager(cuda, pdl):
    """A captured CUDA graph of residual adds and norms (as one decode step
    chains them) replays equal, bit for bit, to the same chain run eagerly."""
    from repro_torch.kernels import rmsnorm_rows
    g = torch.Generator(cuda).manual_seed(0)
    h0 = torch.randn((4, 4096), generator=g, device=cuda).to(torch.bfloat16)
    scales = [(1 + 0.1 * torch.randn(4096, generator=g, device=cuda))
              .to(torch.bfloat16) for _ in range(8)]

    def chain(h):
        y = h
        for sc in scales:
            h = h + y
            y = rmsnorm_rows(h, sc, 1e-5, pdl=pdl)
        return y
    eager = chain(h0)
    static = h0.clone()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        chain(static)                     # warm-up on the capture stream
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = chain(static)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, eager)


@pytest.mark.cuda
def test_reduced_lm_on_card_matches_host(cuda):
    from repro_torch.configs import ARCHS
    from repro_torch.models.model_zoo import build_model
    cfg = ARCHS["glm4-9b"].reduced(num_layers=2)
    host = build_model(cfg, kind="prefill", device="cpu",
                       dtype=torch.float32)
    host.init_params(torch.Generator().manual_seed(0))
    card = build_model(cfg, kind="prefill", device=cuda, dtype=torch.float32)
    card.load_state_dict(host.state_dict())
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 70))
    before = dict(build.LAUNCHES)
    got, _ = card.prefill({"tokens": tokens})
    assert build.LAUNCHES["flash_attention"] == before["flash_attention"] + 2
    assert build.LAUNCHES["rmsnorm"] == before["rmsnorm"] + 5
    want, _ = host.prefill({"tokens": tokens})
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)


# tests/test_kernels.py's ssm_scan tolerances: bf16 rounding of the output,
# float32 sums over the states in another order, the kernel's decay from
# ex2.approx (a few ulp) and its state update and y sum as FMAs (one
# rounding where the plain version has two)
SSM_TOL = {torch.bfloat16: dict(rtol=2e-2, atol=2e-2),
           torch.float32: dict(rtol=2e-4, atol=2e-4)}
SCAN_DTYPES = [(torch.float32, torch.float32),
               (torch.bfloat16, torch.float32),
               (torch.bfloat16, torch.bfloat16),
               (torch.float32, torch.bfloat16)]


def _scan_inputs(cuda, b, s, di, ds, xdtype, dtdtype, seed):
    rng = np.random.default_rng(seed)

    def f(a, dtype=torch.float32):
        return torch.from_numpy(a.astype(np.float32)).to(cuda, dtype)
    return dict(
        x=f(rng.standard_normal((b, s, di)) * 0.5, xdtype),
        dt=f(np.log1p(np.exp(rng.standard_normal((b, s, di)) * 0.2 - 1)),
             dtdtype),
        A=f(-np.exp(rng.standard_normal((di, ds)) * 0.3)),
        B=f(rng.standard_normal((b, s, ds)) * 0.5),
        C=f(rng.standard_normal((b, s, ds)) * 0.5),
        D=f(1 + 0.1 * rng.standard_normal(di)),
        h0=f(rng.standard_normal((b, di, ds))))


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,di,ds", [
    (1, 64, 128, 8), (2, 128, 256, 16), (1, 96, 384, 16),   # test_kernels
    (3, 77, 1000, 16),                                      # ragged s, di
    (2, 1, 8192, 16),                                       # decode step
    (1, 40, 100, 3), (1, 33, 64, 37), (1, 20, 48, 128),     # odd ds
    (4, 15, 8192, 16), (4, 16, 8192, 16), (4, 17, 8192, 16),  # eight
    (4, 1029, 8192, 16),            # states a thread, 16-step blocks, tail
    (2, 31, 1024, 16), (2, 32, 1024, 16), (2, 33, 1024, 16),  # four
    (2, 1029, 1024, 16),            # states a thread, 32-step blocks, tail
    (1, 2048, 8192, 16),                                    # batch 1
])
@pytest.mark.parametrize("xdtype,dtdtype", SCAN_DTYPES)
def test_ssm_scan_close_to_plain(cuda, b, s, di, ds, xdtype, dtdtype):
    t = _scan_inputs(cuda, b, s, di, ds, xdtype, dtdtype, s + di + ds)
    args = [t[k] for k in ("x", "dt", "A", "B", "C", "D")]
    for h0 in (None, t["h0"]):
        before = build.LAUNCHES["ssm_scan"]
        y, h = ssm_scan(*args, h0=h0)
        assert build.LAUNCHES["ssm_scan"] == before + 1
        torch.cuda.synchronize()
        y_p, h_p = ssm_scan_plain(*args, h0=h0)
        assert y.dtype == xdtype and h.dtype == torch.float32
        torch.testing.assert_close(y.float(), y_p.float(), **SSM_TOL[xdtype])
        torch.testing.assert_close(h, h_p, **SSM_TOL[torch.float32])


@pytest.mark.cuda
@pytest.mark.parametrize("b,s", [(2, 1), (2, 17), (2, 100), (4, 100)])
@pytest.mark.parametrize("xdtype,dtdtype", SCAN_DTYPES)
def test_ssm_scan_in_place_matches_plain(cuda, b, s, xdtype, dtdtype):
    """h_out = h0 over several steps and blocks, against the plain version
    from the state as it was."""
    t = _scan_inputs(cuda, b, s, 8192, 16, xdtype, dtdtype, s)
    args = [t[k] for k in ("x", "dt", "A", "B", "C", "D")]
    y_p, h_p = ssm_scan_plain(*args, h0=t["h0"])
    state = t["h0"].clone()
    y, h = ssm_scan(*args, h0=state, h_out=state)
    torch.cuda.synchronize()
    assert h is state
    torch.testing.assert_close(y.float(), y_p.float(), **SSM_TOL[xdtype])
    torch.testing.assert_close(state, h_p, **SSM_TOL[torch.float32])


@pytest.mark.cuda
def test_ssm_scan_state_in_place_and_without_skip(cuda):
    t = _scan_inputs(cuda, 2, 50, 300, 16, torch.float32, torch.float32, 9)
    args = [t[k] for k in ("x", "dt", "A", "B", "C")]
    y_d, h_d = ssm_scan(*args, t["D"], h0=t["h0"])
    state = t["h0"].clone()
    y_i, h_i = ssm_scan(*args, t["D"], h0=state, h_out=state)
    assert h_i is state
    assert torch.equal(state, h_d) and torch.equal(y_i, y_d)
    y_0, _ = ssm_scan(*args, None, h0=t["h0"])
    torch.testing.assert_close(y_0 + t["D"] * t["x"], y_d, rtol=1e-5,
                               atol=1e-5)


@pytest.mark.cuda
def test_ssm_scan_rejects_what_the_kernel_does_not_take(cuda):
    t = _scan_inputs(cuda, 1, 8, 16, 4, torch.float32, torch.float32, 1)
    x = t["x"].repeat(1, 1, 2)[:, :, ::2]           # (1, 8, 16), strided
    assert not x.is_contiguous()
    with pytest.raises(ValueError, match="contiguous"):
        ssm_scan(x, t["dt"], t["A"], t["B"], t["C"], t["D"])
    with pytest.raises(ValueError, match="one device"):
        ssm_scan(t["x"], t["dt"], t["A"].cpu(), t["B"], t["C"], t["D"])


@pytest.mark.cuda
def test_reduced_mamba_on_card_matches_host(cuda):
    from repro_torch.configs import ARCHS
    from repro_torch.models.model_zoo import build_model
    cfg = ARCHS["falcon-mamba-7b"].reduced(num_layers=2)
    host = build_model(cfg, kind="prefill", device="cpu",
                       dtype=torch.float32)
    host.init_params(torch.Generator().manual_seed(0))
    card = build_model(cfg, kind="prefill", device=cuda, dtype=torch.float32)
    card.load_state_dict(host.state_dict())
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 70))
    before = dict(build.LAUNCHES)
    got, caches = card.prefill({"tokens": tokens})
    assert build.LAUNCHES["ssm_scan"] == before["ssm_scan"] + 2
    assert build.LAUNCHES["rmsnorm"] == before["rmsnorm"] + 3
    assert build.LAUNCHES["flash_attention"] == before["flash_attention"]
    want, caches_h = host.prefill({"tokens": tokens})
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(caches["l0_mamba"]["state"].cpu(),
                               caches_h["l0_mamba"]["state"], rtol=1e-4,
                               atol=1e-4)
    # two decode steps on the caches as prefill left them (float32 here)
    for t in (70, 71):
        nxt = torch.argmax(want, dim=-1)
        got, caches = card.decode_step(caches, nxt.to(cuda), t)
        want, caches_h = host.decode_step(caches_h, nxt, t)
        torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
    assert build.LAUNCHES["ssm_scan"] == before["ssm_scan"] + 6
    for key in ("state", "conv"):
        torch.testing.assert_close(caches["l0_mamba"][key].cpu(),
                                   caches_h["l0_mamba"][key], rtol=1e-4,
                                   atol=1e-4)


def _scripted_session(device, store=None):
    """``tests/test_store.py``'s chaos script through the port's session
    on ``device`` (submit, decide, fail, budget, submit, run, degrade,
    retire, restore); returns the session and the launches of the drain
    that follows the failure."""
    from repro_torch.api import (DeviceInventory, MinosSession,
                                 ReferenceLibrary, TPUPowerModel,
                                 VariabilityModel, micro_gemm,
                                 micro_idle_burst, micro_spmv_memory,
                                 micro_stencil, stream_profile_workload,
                                 stream_telemetry)
    model = TPUPowerModel()
    lib = ReferenceLibrary(
        (stream_profile_workload(s, model, (0.6, 0.8, 1.0), model.spec.tdp_w,
                                 seed=i, target_duration=0.5, device=device)
         for i, s in enumerate([micro_gemm(), micro_idle_burst(),
                                micro_spmv_memory(), micro_stencil()])),
        built_on="tpu-v5e", device=device)
    inv = DeviceInventory.generate({"tpu-v5e": 3, "tpu-v5p": 2},
                                   VariabilityModel(), seed=7)
    session = MinosSession(lib, inventory=inv, budget_w=20000.0,
                           min_confidence=0.2, store=store, device=device)

    def tel(stream, seed):
        return stream_telemetry(stream, 1.0, model, seed=seed,
                                target_duration=0.5)

    a = session.submit(tel(micro_gemm(), 100), chips=4)
    a.run()
    session.submit(tel(micro_spmv_memory(), 101), chips=2)
    session.fail_device(a.device.device_id)
    session.set_budget(5000.0)
    c = session.submit(tel(micro_stencil(), 102), chips=1)
    before = dict(build.LAUNCHES)
    session.run()
    drained = {k: build.LAUNCHES[k] - before[k]
               for k in ("spike_hist", "ema_scan")}
    session.degrade_device(c.device.device_id)
    session.retire(a.job_id)
    session.restore_device(sorted(session._fleet._failed_devices)[0])
    return session, drained


_ENGINE_COLUMNS = ("_hist_all", "_ema_state", "_ema_has", "_energy", "_busy",
                   "_next_index", "_n_pending", "_n_committed",
                   "_seen_busy", "_live", "_tdp")


@pytest.mark.cuda
def test_chaos_session_engine_on_card_bitwise_equal_host(cuda, tmp_path):
    """Slot recycling under failures: after the chaos script (a migration,
    its freed and re-claimed slot, a retire) and after a resume of its
    store, every engine column on the card equals the host's bit for bit,
    and the drain after the failure ran the kernels."""
    from repro_torch.api import MinosSession, count_classifier_calls, to_json
    card, drained = _scripted_session(cuda, store=str(tmp_path / "card"))
    host, _ = _scripted_session("cpu", store=str(tmp_path / "host"))
    assert drained["spike_hist"] > 0 and drained["ema_scan"] > 0
    for name in _ENGINE_COLUMNS:
        assert torch.equal(getattr(card._fleet.engine, name).cpu(),
                           getattr(host._fleet.engine, name)), name
    assert to_json(card.report()) == to_json(host.report())
    card.close()
    host.close()
    # resume both stores on the card: 0 classifier calls, the same report
    clf = card.library.classifier()
    calls = count_classifier_calls(clf)
    for path in ("card", "host"):
        resumed = MinosSession.resume(str(tmp_path / path), references=clf,
                                      device=cuda)
        assert to_json(resumed.report()) == to_json(host.report())
        resumed.close()
    assert calls["n"] == 0


@pytest.mark.cuda
def test_bench_chaos_engine_on_card_bitwise_equal_host(cuda):
    """``bench_chaos.py --smoke`` as ``chip_smoke.py`` drives it: the card
    and the host give the same counts and bitwise-equal engine columns, and
    the straggler path's drain after the re-profile launches the kernels."""
    import os
    import sys
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import chip_smoke
    card = chip_smoke.session_chaos_smoke(cuda)
    host = chip_smoke.session_chaos_smoke("cpu")
    chip_smoke.engine_columns_equal(card.pop("session")._fleet.engine,
                                    host.pop("session")._fleet.engine,
                                    "the chaos schedule")
    assert card["launches_after_restart"]["spike_hist"] > 0
    assert card["launches_after_restart"]["ema_scan"] > 0
    for key in ("failures", "migrations", "reprofiled_jobs", "repacks",
                "placed", "deferred", "planned_power_w", "device_health"):
        assert card[key] == host[key], key

"""The port's CUDA kernels on the card (``cuda`` marker; skipped without a
card).  Imports neither JAX nor the reference package, so it runs on a
machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest``: the suite's conftest imports JAX.)
"""
import sys

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
                                 ssm_scan, ssm_scan_bsd, ssm_scan_bwd,
                                 ssm_scan_bwd_plain, ssm_scan_plain)
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
    # the vlm's cross-attention (sq > skv too) and whisper's encoder,
    # decoder cross-attention at a GQA ratio of 1
    (1, 2048, 1600, 32, 8, 128, False),
    (4, 1000, 1600, 32, 8, 128, False),
    (2, 1500, 1500, 16, 16, 64, False),
    (4, 64, 1500, 16, 16, 64, False),
    # the float32 kernel's 64-key tiles and its two row blocks: 64 rows
    # at dh <= 64, and at dh 128 when b H ceil(sq / 128) is below the SM
    # count; 128 rows at dh 128 otherwise (the vlm's cross, (1, 1000,
    # 1000) above and b 3 x H 96 below, on a 132-SM H100); one less
    # than, equal to and one more than each tile, dh 32 / 64 / 128, GQA
    # 1 / 4 / 8
    (1, 63, 63, 8, 1, 128, True),
    (2, 64, 64, 8, 2, 64, False),
    (1, 65, 65, 4, 4, 32, True),
    (2, 65, 129, 8, 2, 128, True),       # causal sq < skv
    (1, 1, 65, 8, 1, 64, True),          # one query row
    (2, 129, 63, 8, 8, 32, False),       # non-causal sq > skv
    (3, 127, 65, 96, 12, 128, False),
    (3, 128, 64, 96, 24, 64, False),
    (3, 129, 129, 96, 96, 128, True),
    (3, 128, 191, 96, 24, 128, True),    # causal sq < skv
    (3, 1, 63, 96, 12, 64, True),        # one query row
    (3, 200, 127, 96, 12, 64, False),    # non-causal sq > skv
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
@pytest.mark.parametrize("dtype,shape,causal", [
    (torch.bfloat16, (4, 1000, 1000, 32, 2, 128), True),
    (torch.float32, (4, 1000, 1000, 32, 2, 128), True),
    (torch.float32, (4, 1000, 1600, 32, 8, 128), False),   # vlm cross
])
def test_flash_attention_is_deterministic(cuda, dtype, shape, causal):
    """No atomics and no order that varies: two calls give equal bits."""
    q, k, v = _attn_inputs(cuda, *shape, dtype)
    first = flash_attention(q, k, v, causal=causal)
    assert torch.equal(flash_attention(q, k, v, causal=causal), first)


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


@pytest.mark.cuda
@pytest.mark.parametrize("arch,flash", [("llama-3.2-vision-11b", 6),
                                        ("whisper-medium", 10)])
def test_reduced_vlm_and_enc_dec_on_card_match_host(cuda, arch, flash):
    """float32, the gates drawn away from 0: one flash launch per self and
    cross attention of the prefill (the vlm: 4 + 2; whisper: 2 encoder + 4
    decoder self + 4 cross) and a decode step on the cross caches."""
    from repro_torch.configs import ARCHS
    from repro_torch.models.model_zoo import build_model
    cfg = ARCHS[arch].reduced()
    host = build_model(cfg, kind="prefill", device="cpu",
                       dtype=torch.float32)
    host.init_params(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    with torch.no_grad():
        for name, p in host.named_parameters():
            if name.endswith(".gate"):
                p.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, 1)))
    card = build_model(cfg, kind="prefill", device=cuda, dtype=torch.float32)
    card.load_state_dict(host.state_dict())
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (2, 70))}
    memory = "image_embeds" if cfg.family == "vlm" else "frames"
    batch[memory] = rng.standard_normal(
        (2, cfg.num_image_tokens or 90, cfg.d_model)).astype(np.float32)
    before = dict(build.LAUNCHES)
    got, caches = card.prefill(batch)
    assert build.LAUNCHES["flash_attention"] == \
        before["flash_attention"] + flash
    want, host_caches = host.prefill(batch)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
    cross = "cross" if memory == "frames" else "l1_cross"
    for key in ("k", "v"):
        torch.testing.assert_close(caches[cross][key].cpu(),
                                   host_caches[cross][key], rtol=1e-4,
                                   atol=1e-4)
    pad = {name: {key: torch.cat([c, torch.zeros_like(c[:, :, :1])], 2)
                  if "cross" not in name else c for key, c in e.items()}
           for name, e in caches.items()}
    host_pad = {name: {key: c.cpu() for key, c in e.items()}
                for name, e in pad.items()}
    tok = torch.tensor([3, 4])
    got, _ = card.decode_step(pad, tok.to(cuda), 70)
    want, _ = host.decode_step(host_pad, tok, 70)
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


def _close_scaled(got, want, tol: dict, what: str) -> None:
    """|got - want| <= atol max(1, max |want|) + rtol |want|: a gradient is
    held to its own scale (sums over thousands of steps or channels)."""
    got, want = got.float(), want.float()
    scale = max(1.0, float(want.abs().max()))
    err = (got - want).abs()
    assert bool((err <= tol["atol"] * scale + tol["rtol"] * want.abs())
                .all()), (what, float(err.max()), scale)


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,di,ds", [
    (2, 37, 24, 8), (1, 50, 40, 16),          # the CPU tests' shapes
    (3, 77, 1000, 16),                        # ragged s and di
    (1, 33, 64, 37), (1, 20, 48, 128),        # 16 threads a channel
    (4, 15, 8192, 16), (4, 16, 8192, 16), (4, 17, 8192, 16),  # one block,
    (1, 1000, 8192, 16),                      # a tail; batch 1, odd s
])
@pytest.mark.parametrize("xdtype,dtdtype", SCAN_DTYPES)
def test_ssm_scan_bwd_close_to_plain(cuda, b, s, di, ds, xdtype, dtdtype):
    """The backward kernel against its plain twin, with and without D, h0
    and dh_last; two launches bitwise equal."""
    _check_scan_bwd(cuda, b, s, di, ds, xdtype, dtdtype)


@pytest.mark.cuda
@pytest.mark.parametrize("lanes", [2, 4])
@pytest.mark.parametrize("b,s,di", [
    (3, 77, 1000),                            # ragged s and di
    (4, 17, 8192),                            # a block and a tail
    (2, 64, 200)])                            # whole blocks, a ragged CTA
@pytest.mark.parametrize("xdtype,dtdtype", SCAN_DTYPES)
def test_ssm_scan_bwd_each_layout_close_to_plain(cuda, monkeypatch, lanes, b,
                                                 s, di, xdtype, dtdtype):
    """Each layout the plan can choose at ds = 16 (eight states a thread,
    2 lanes; four, 4 lanes), forced through the plan's threshold, against
    the plain twin; the wide layout (16 lanes) is the ds > 16 cases of
    test_ssm_scan_bwd_close_to_plain."""
    ss = sys.modules["repro_torch.kernels.ssm_scan"]
    monkeypatch.setattr(ss, "_BWD_EIGHT_MIN_CTAS", 0 if lanes == 2 else 10**9)
    assert ss.bwd_plan(b, s, di, 16, build.sm_count(0)).lanes == lanes
    _check_scan_bwd(cuda, b, s, di, 16, xdtype, dtdtype)


@pytest.mark.cuda
@pytest.mark.parametrize("lanes", [2, 4, 16])
@pytest.mark.parametrize("offset", [False, True])
@pytest.mark.parametrize("xdtype,dtdtype", SCAN_DTYPES)
def test_ssm_scan_bwd_unaligned_rows_close_to_plain(cuda, monkeypatch, lanes,
                                                    offset, xdtype, dtdtype):
    """Rows the kernel cannot stage in 16-byte copies, in each layout: di
    not a multiple of 8, or x a contiguous view at an odd element offset
    (rows of whole 16-byte chunks otherwise); against the plain twin, two
    launches bitwise equal."""
    b, s, di, ds = (1, 33, 101, 37) if lanes == 16 else (2, 37, 1001, 16)
    if offset:
        di = 96 if lanes == 16 else 1000
    ss = sys.modules["repro_torch.kernels.ssm_scan"]
    monkeypatch.setattr(ss, "_BWD_EIGHT_MIN_CTAS", 0 if lanes == 2 else 10**9)
    assert ss.bwd_plan(b, s, di, ds, build.sm_count(0)).lanes == lanes
    _check_scan_bwd(cuda, b, s, di, ds, xdtype, dtdtype, offset)


def _at_odd_offset(t: torch.Tensor) -> torch.Tensor:
    """t's values in a contiguous view one element into a larger buffer."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = buf[1:].view(t.shape)
    view.copy_(t)
    assert view.is_contiguous() and view.data_ptr() % 16 != 0
    return view


def _check_scan_bwd(cuda, b, s, di, ds, xdtype, dtdtype, offset=False):
    t = _scan_inputs(cuda, b, s, di, ds, xdtype, dtdtype, 3 * s + di + ds)
    if offset:
        t["x"] = _at_odd_offset(t["x"])
    g = torch.Generator(device=cuda).manual_seed(s)
    dy = torch.randn((b, s, di), generator=g, device=cuda).to(xdtype)
    dh = torch.randn((b, di, ds), generator=g, device=cuda)
    args = [t[k] for k in ("x", "dt", "A", "B", "C")]
    for D, h0, dh_last in ((None, None, None), (t["D"], t["h0"], dh)):
        before = build.LAUNCHES["ssm_scan_bwd"]
        got = ssm_scan_bwd(*args, D, h0, dy, dh_last)
        assert build.LAUNCHES["ssm_scan_bwd"] == before + 1
        torch.cuda.synchronize()
        want = ssm_scan_bwd_plain(*args, D, h0, dy, dh_last)
        again = ssm_scan_bwd(*args, D, h0, dy, dh_last)
        for name, a, w, a2 in zip(("dx", "ddt", "dA", "dB", "dC", "dD",
                                   "dh0"), got, want, again):
            if w is None:
                assert a is None and a2 is None, name
                continue
            assert a.dtype == w.dtype and a.shape == w.shape, name
            tol = SSM_TOL[a.dtype] if a.dtype == torch.bfloat16 \
                else SSM_TOL[torch.float32]
            _close_scaled(a, w, tol, name)
            assert torch.equal(a, a2), f"{name}: two launches differ"


@pytest.mark.cuda
def test_reduced_mamba_loss_and_gradients_on_card_match_host(cuda):
    """Float32 reduced falcon-mamba-7b: the loss and every gradient through
    the kernels on the card (the scan forward, its recomputation and its
    backward) against the plain twins on the CPU."""
    from repro_torch.configs import ARCHS
    from repro_torch.models.model_zoo import build_model
    cfg = ARCHS["falcon-mamba-7b"].reduced(num_layers=2)
    host = build_model(cfg, kind="train", device="cpu", dtype=torch.float32)
    host.init_params(torch.Generator().manual_seed(0))
    card = build_model(cfg, kind="train", device=cuda, dtype=torch.float32)
    card.load_state_dict(host.state_dict())
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab_size, (2, 301)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    out = []
    for model in (host, card):
        params = dict(model.named_parameters())
        for p in params.values():
            p.requires_grad_(True)
        before = dict(build.LAUNCHES)
        total, _ = model.loss(batch)
        grads = torch.autograd.grad(total, list(params.values()))
        launched = {k: build.LAUNCHES[k] - before[k] for k in before}
        out.append((total.detach().cpu(), [g.cpu() for g in grads],
                    launched))
    (lh, gh, _), (lc, gc, launched) = out
    L = cfg.num_layers
    assert launched["ssm_scan"] == 2 * L                 # remat recomputes
    assert launched["ssm_scan_bwd"] == L
    assert launched["rmsnorm"] == 2 * L + 1
    assert launched["rmsnorm_bwd"] == L + 1
    assert launched["flash_attention"] == launched["flash_attention_bwd"] \
        == 0
    assert abs(float(lc) - float(lh)) <= 1e-5 * abs(float(lh))
    for a, w in zip(gc, gh):
        torch.testing.assert_close(a, w, rtol=1e-4, atol=1e-4)


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


def _discovery_session(device, store=None):
    """A discovery session on ``device``: the micro library, four
    vector-search arrivals quarantined, a forced promotion, one arrival
    after it; returns (session, promotion summary, decisions, the
    launches of the promotion)."""
    from repro_torch.api import (MinosSession, ReferenceLibrary,
                                 TPUPowerModel, micro_gemm, micro_idle_burst,
                                 micro_spmv_memory, micro_stencil,
                                 micro_vector_search, stream_profile_workload,
                                 stream_profiler, stream_telemetry, to_dict)
    model, freqs = TPUPowerModel(), (0.6, 0.8, 1.0)
    lib = ReferenceLibrary(
        (stream_profile_workload(s, model, freqs, model.spec.tdp_w, seed=i,
                                 target_duration=0.5, device=device)
         for i, s in enumerate([micro_gemm(), micro_idle_burst(),
                                micro_spmv_memory(), micro_stencil()])),
        built_on="tpu-v5e", device=device)
    session = MinosSession(
        lib, store=store, device=device, min_confidence=0.2,
        min_fraction=0.1, min_spike_samples=50,
        discovery={"quarantine_below": 0.9, "min_cluster": 3,
                   "recluster_every": 100, "promote_agreement": 0.5,
                   "cluster_distance": 0.5})

    def run(seed):
        return session.submit(stream_telemetry(
            micro_vector_search(), 1.0, model, seed=seed,
            target_duration=0.5), chips=2).run()

    decisions = [to_dict(run(800 + i)) for i in range(4)]
    session.discovery.profiler = stream_profiler(
        [micro_vector_search()], model, freqs, model.spec.tdp_w,
        target_duration=0.5, device=device)
    before = dict(build.LAUNCHES)
    promo = session.discover(force=True)
    launched = {k: build.LAUNCHES[k] - before[k]
                for k in ("spike_hist", "ema_scan")}
    decisions.append(to_dict(run(900)))
    return session, promo, decisions, launched


@pytest.mark.cuda
def test_discovery_on_card_bitwise_equal_host(cuda, tmp_path):
    """Online class discovery on the card against the host: the same
    promotion, the pool's records, the promoted library's spike matrices
    and every decision bit for bit; the promotion ran the kernels; both
    stores resume on the card with 0 classifier calls."""
    import json
    from repro_torch.api import MinosSession, ReferenceLibrary
    card, pc, dc, launched = _discovery_session(cuda, str(tmp_path / "c"))
    host, ph, dh, _ = _discovery_session("cpu", str(tmp_path / "h"))
    assert launched["spike_hist"] > 0 and launched["ema_scan"] > 0, launched
    for i, (c, h) in enumerate(zip(dc, dh)):
        assert c == h, (i, c, h)
    assert pc == ph, (pc, ph)
    assert "discovered-v2" in dc[-1]["selection"]["power_neighbor"]
    assert json.dumps(card.discovery.state_record()) == \
        json.dumps(host.discovery.state_record())
    lc, lh = card.discovery.library, host.discovery.library
    assert lc.names == lh.names
    for c in lc.bin_sizes:
        assert torch.equal(lc.spike_matrix(c).cpu(), lh.spike_matrix(c))
    card.close()
    host.close()
    base = card.discovery.base_library
    calls, orig = [], ReferenceLibrary.classifier

    def spied(self, *a, **k):
        from repro_torch.api import count_classifier_calls
        clf = orig(self, *a, **k)
        calls.append(count_classifier_calls(clf))
        return clf

    ReferenceLibrary.classifier = spied
    try:
        for path in ("c", "h"):
            resumed = MinosSession.resume(str(tmp_path / path),
                                          references=base, device=cuda)
            assert resumed.discovery.version == 2
            assert resumed.discovery.library.names == lc.names
            resumed.close()
    finally:
        ReferenceLibrary.classifier = orig
    assert sum(c["n"] for c in calls) == 0


def _zoo_util_matrix(device):
    from repro_torch.api import TPUPowerModel, reference_streams
    from repro_torch.pipeline import stream_profile_once
    model = TPUPowerModel()
    profiles = [stream_profile_once(s, model, model.spec.tdp_w, seed=i,
                                    target_duration=0.2, device=device)
                for i, s in enumerate(reference_streams())]
    return np.array([p.util_point for p in profiles])


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["zoo", (0, 28, 2), (3, 51, 4),
                                  (5, 90, 2)])
def test_kmeans_on_card_bitwise_equal_host(cuda, case):
    """Every (k, restart) of the float32 Lloyd: centres, labels and inertia
    on the card equal the host's bit for bit (fixed-order sums, no
    atomics), and so do ``kmeans`` and the silhouette sweep's k."""
    from repro_torch.core import clustering
    if case == "zoo":
        X, ks = _zoo_util_matrix("cpu"), range(3, 18)
    else:
        seed, n, d = case
        rng = np.random.default_rng(seed)
        X = rng.normal(size=(n, d)) * rng.uniform(0.1, 3.0)
        ks = (2, 3, 5, 9)
    for k in ks:
        rng = np.random.default_rng(0)
        inits = np.stack([clustering.kmeanspp_init(X, k, rng)
                          for _ in range(4)])
        got = clustering._lloyd(
            torch.tensor(X, dtype=torch.float32, device=cuda),
            torch.tensor(inits, dtype=torch.float32, device=cuda), k, 50)
        want = clustering._lloyd(
            torch.tensor(X, dtype=torch.float32),
            torch.tensor(inits, dtype=torch.float32), k, 50)
        for g, w in zip(got, want):
            assert torch.equal(g.cpu(), w), k
        for g, w in zip(clustering.kmeans(X, k, device=cuda),
                        clustering.kmeans(X, k, device="cpu")):
            assert np.array_equal(g, w), k
    kc, sc = clustering.best_k_by_silhouette(X, k_range=ks, device=cuda)
    kh, sh = clustering.best_k_by_silhouette(X, k_range=ks, device="cpu")
    assert kc == kh
    for k in sh:
        assert abs(sc[k] - sh[k]) <= 1e-12


# ---------------------------------------------------------------------------
# the MoE block and MLA attention, card against host
# ---------------------------------------------------------------------------
# tests/test_torch_models.py's tolerances for a model's outputs and caches
LM_TOL = {torch.bfloat16: dict(rtol=2e-2, atol=5e-2),
          torch.float32: dict(rtol=1e-4, atol=1e-4)}


def _module_pair(make, cuda, dtype, seed, prep=None):
    """One module seeded on the host (then ``prep``-ed) and a copy of it on
    the card."""
    from repro_torch.models.common import init_param_
    host = make("cpu", dtype)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in sorted(host.named_parameters()):
            init_param_(p, host.defs[name], g)
        if prep is not None:
            prep(host)
    card = make(cuda, dtype)
    card.load_state_dict(host.state_dict())
    return host, card


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 16, 256), (4, 256)],
                         ids=["prefill", "decode"])
def test_moe_block_on_card_matches_host(cuda, dtype, shape):
    """The same input on both: routing is equal where the host's
    neighbouring router probabilities among a token's first k + 1 are
    more than 1e-4 apart (asserted), so the slots are equal and the output
    within the kernel tolerances.  Expert weights are drawn normal /
    sqrt(input width) (the seeded init's fan-in of a stacked expert weight
    is its expert count)."""
    from repro_torch.models.moe import MoE

    def prep(m):
        m.router.mul_(5.0)               # the seeded 0.02: sharper routing
        m.w_gate.mul_((8 / 256) ** 0.5)
        m.w_up.mul_((8 / 256) ** 0.5)
        m.w_down.mul_((8 / 128) ** 0.5)

    host, card = _module_pair(
        lambda dev, dt: MoE("m", 256, 8, 2, 128, num_shared=1,
                            group_size=16, device=dev, dtype=dt),
        cuda, dtype, 0, prep)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        shape).astype(np.float32)).to(dtype)
    T = x.numel() // 256
    xg = x.reshape(T // host.group(T), host.group(T), 256)
    p = torch.sort(host._probs(xg), dim=-1, descending=True).values
    assert float((p[..., :2] - p[..., 1:3]).min()) > 1e-4
    rh, rc = host._route(xg), card._route(xg.to(cuda))
    assert torch.equal(rh.topi, rc.topi.cpu())
    assert torch.equal(rh.pos, rc.pos.cpu())
    assert torch.equal(rh.dispatched, rc.dispatched.cpu())
    got, aux_c = card(x.to(cuda))
    want, aux_h = host(x)
    torch.testing.assert_close(got.cpu(), want, **TOL[dtype])
    torch.testing.assert_close(aux_c.cpu(), aux_h, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mla_on_card_matches_host(cuda, dtype):
    """Prefill and absorbed decode with bfloat16 caches, as served; the
    latent norm launches the rmsnorm kernel once per call."""
    from repro_torch.models.attention import MLAttention
    host, card = _module_pair(
        lambda dev, dt: MLAttention("a", 512, 8, 128, 64, 32, 64,
                                    layout="megatron", device=dev, dtype=dt),
        cuda, dtype, 2)
    rng = np.random.default_rng(3)
    b, s, S = 2, 50, 64
    x = torch.from_numpy(rng.standard_normal((b, s, 512)).astype(
        np.float32)).to(dtype)
    pos = torch.arange(s)
    before = build.LAUNCHES["rmsnorm"]
    got, (c_c, r_c) = card(x.to(cuda), pos.to(cuda), return_kv=True)
    assert build.LAUNCHES["rmsnorm"] == before + 1
    want, (c_h, r_h) = host(x, pos, return_kv=True)
    tol = LM_TOL[dtype]
    for a, w in ((got, want), (c_c, c_h), (r_c, r_h)):
        torch.testing.assert_close(a.cpu(), w, **tol)
    caches = []
    for c, r in ((c_h, r_h), (c_h.to(cuda), r_h.to(cuda))):
        cc = torch.zeros((b, S, 128), dtype=torch.bfloat16, device=c.device)
        rc = torch.zeros((b, S, 32), dtype=torch.bfloat16, device=c.device)
        cc[:, :s], rc[:, :s] = c, r
        caches.append((cc, rc))
    xt = torch.from_numpy(rng.standard_normal((b, 512)).astype(
        np.float32)).to(dtype)
    want, _ = host.decode(xt, s, *caches[0])
    got, _ = card.decode(xt.to(cuda), s, *caches[1])
    torch.testing.assert_close(got.cpu(), want, **LM_TOL[torch.bfloat16])
    for a, w in zip(caches[1], caches[0]):
        torch.testing.assert_close(a.cpu(), w, **LM_TOL[torch.bfloat16])


# ---------------------------------------------------------------------------
# training: the backward kernels, their Functions and the guards
# ---------------------------------------------------------------------------
BWD_TOL = {torch.bfloat16: dict(rtol=2e-2, atol=2e-2),
           torch.float32: dict(rtol=1e-4, atol=1e-4)}


@pytest.mark.cuda
@pytest.mark.parametrize("b,sq,skv,H,KV,dh,causal", [
    (2, 256, 256, 8, 2, 128, True),      # glm4-9b's heads, reduced
    (1, 200, 200, 4, 4, 64, True),       # ragged tiles
    (2, 65, 129, 8, 2, 128, True),       # causal sq < skv
    (2, 100, 300, 4, 1, 32, False),      # non-causal sq != skv
    (1, 129, 63, 8, 8, 64, False),       # non-causal sq > skv
    (3, 1, 65, 6, 2, 128, True),         # one query row
    (1, 129, 129, 8, 2, 128, True),      # one row past the tiles
    (1, 257, 257, 8, 2, 128, True),      # two key tiles and a row
    (2, 256, 256, 24, 8, 64, True),      # granite-moe's heads
    (2, 300, 300, 8, 8, 128, True),      # H == KV: no group to split
    (1, 200, 200, 10, 2, 64, True),      # a group of 5 in 8 parts
    (4, 512, 512, 32, 2, 64, True),      # 512 dQ CTAs, > 2 x 132
    (2, 1, 300, 8, 2, 128, True),        # sq = 1 against skv = 300
])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_attention_backward_close_to_plain(cuda, b, sq, skv, H, KV, dh,
                                                 causal, dtype):
    from repro_torch.kernels import (flash_attention_bshd,
                                     flash_attention_bwd,
                                     flash_attention_bwd_plain)
    q, k, v = _attn_inputs(cuda, b, sq, skv, H, KV, dh, dtype)
    do = torch.randn((b, sq, H, dh), device=cuda,
                     generator=torch.Generator(cuda).manual_seed(5)).to(dtype)
    o, lse = flash_attention_bshd(q, k, v, causal, with_lse=True)
    assert torch.equal(o, flash_attention(q, k, v, causal=causal))
    _, want_lse = flash_attention_plain(q, k, v, causal, with_lse=True)
    torch.testing.assert_close(lse, want_lse, **TOL[dtype])
    before = build.LAUNCHES["flash_attention_bwd"]
    got = flash_attention_bwd(q, k, v, o, lse, do, causal)
    assert build.LAUNCHES["flash_attention_bwd"] == before + 1
    torch.cuda.synchronize()
    want = flash_attention_bwd_plain(q, k, v, o, lse, do, causal)
    for g, w in zip(got, want):
        assert g.dtype == dtype and g.shape == w.shape
        torch.testing.assert_close(g.float(), w.float(), **BWD_TOL[dtype])
    again = flash_attention_bwd(q, k, v, o, lse, do, causal)
    for g, a in zip(got, again):                     # no atomics
        assert torch.equal(g, a)


@pytest.mark.cuda
@pytest.mark.parametrize("b,sq,skv,H,KV,dh,causal", [
    (4, 1024, 1024, 32, 2, 128, True),   # glm4-9b's heads
    (1, 4096, 4096, 32, 2, 128, True),   # train_4k's sequence
    (4, 1024, 1024, 24, 8, 64, True),    # granite-moe's heads
    (4, 1024, 1600, 32, 8, 128, False),  # the vlm's cross-attention
    (4, 1024, 1024, 16, 16, 64, False),  # whisper's encoder and cross
    (2, 300, 700, 32, 8, 128, False),    # ragged: sq, skv off the tiles
    (2, 300, 700, 16, 16, 64, False),
    (1, 333, 333, 16, 4, 64, True),      # ragged causal
])
def test_float32_flash_backward_at_the_cross_and_training_shapes(
        cuda, b, sq, skv, H, KV, dh, causal):
    """The float32 backward (SIMT kernels) at the shapes phase 19 times and
    at ragged ones, within 1e-4 of its plain twin; two launches bitwise
    equal."""
    from repro_torch.kernels import (flash_attention_bshd,
                                     flash_attention_bwd,
                                     flash_attention_bwd_plain)
    dtype = torch.float32
    q, k, v = _attn_inputs(cuda, b, sq, skv, H, KV, dh, dtype)
    do = torch.randn((b, sq, H, dh), device=cuda,
                     generator=torch.Generator(cuda).manual_seed(9))
    o, lse = flash_attention_bshd(q, k, v, causal, with_lse=True)
    got = flash_attention_bwd(q, k, v, o, lse, do, causal)
    torch.cuda.synchronize()
    want = flash_attention_bwd_plain(q, k, v, o, lse, do, causal)
    for g, w in zip(got, want):
        assert g.dtype == dtype and g.shape == w.shape
        torch.testing.assert_close(g, w, **BWD_TOL[dtype])
    del want
    again = flash_attention_bwd(q, k, v, o, lse, do, causal)
    for g, a in zip(got, again):                     # no atomics
        assert torch.equal(g, a)


@pytest.mark.cuda
@pytest.mark.parametrize("n,d", [(4096, 4096), (7, 100), (300, 384),
                                 (1, 4096), (33, 5120), (5, 8192),
                                 (4096, 512), (4096, 1536),
                                 # rows that do not divide among the CTAs
                                 # (the last CTA's run and step are short)
                                 (4001, 4096), (4001, 1536), (1003, 512)])
@pytest.mark.parametrize("dtype,sdtype", [
    (torch.bfloat16, torch.bfloat16), (torch.bfloat16, torch.float32),
    (torch.float32, torch.float32), (torch.float32, torch.bfloat16)])
def test_rmsnorm_backward_close_to_plain(cuda, n, d, dtype, sdtype):
    from repro_torch.kernels import rmsnorm_bwd, rmsnorm_bwd_plain
    rng = np.random.default_rng(n + d)
    x, dy = (torch.from_numpy(rng.standard_normal((n, d), np.float32))
             .to(cuda, dtype) for _ in range(2))
    sc = torch.from_numpy(1 + 0.1 * rng.standard_normal(d, np.float32)).to(
        cuda, sdtype)
    before = build.LAUNCHES["rmsnorm_bwd"]
    dx, ds = rmsnorm_bwd(x, sc, dy, 1e-5)
    assert build.LAUNCHES["rmsnorm_bwd"] == before + 1
    torch.cuda.synchronize()
    wx, ws = rmsnorm_bwd_plain(x, sc, dy, 1e-5)
    assert dx.dtype == dtype and ds.dtype == sdtype
    torch.testing.assert_close(dx.float(), wx.float(), **BWD_TOL[dtype])
    tol = BWD_TOL[torch.bfloat16 if torch.bfloat16 in (dtype, sdtype)
                  else torch.float32]
    torch.testing.assert_close(ds.float(), ws.float(), **tol)
    dx2, ds2 = rmsnorm_bwd(x, sc, dy, 1e-5)
    assert torch.equal(dx, dx2) and torch.equal(ds, ds2)


@pytest.mark.cuda
def test_outputs_under_grad_keep_their_graph_on_the_card(cuda):
    """The kernels' outputs carry a grad_fn when a gradient is wanted and
    their backward launches its kernel once; the bare wrappers refuse such
    inputs rather than cut the graph."""
    from repro_torch.kernels import flash_attention_bshd, rmsnorm_rows
    q, k, v = (t.requires_grad_() for t in
               _attn_inputs(cuda, 1, 64, 64, 4, 2, 64, torch.bfloat16))
    o = flash_attention(q, k, v, causal=True)
    assert o.grad_fn is not None
    before = build.LAUNCHES["flash_attention_bwd"]
    o.float().sum().backward()
    assert build.LAUNCHES["flash_attention_bwd"] == before + 1
    assert q.grad is not None and k.grad.shape == k.shape
    with pytest.raises(RuntimeError, match="cut the graph"):
        flash_attention_bshd(q, k, v, True)
    x = torch.randn((8, 256), device=cuda, requires_grad=True)
    sc = torch.ones(256, device=cuda, requires_grad=True)
    y = rmsnorm(x, sc)
    assert y.grad_fn is not None
    y.sum().backward()
    assert x.grad is not None and sc.grad is not None
    with pytest.raises(RuntimeError, match="cut the graph"):
        rmsnorm_rows(x, sc)
    with torch.no_grad():
        assert flash_attention(q, k, v).grad_fn is None
        assert rmsnorm(x, sc).grad_fn is None
    xs = torch.randn((1, 8, 32), device=cuda, requires_grad=True)
    dt = torch.rand((1, 8, 32), device=cuda)
    A = -torch.rand((32, 4), device=cuda)
    B, C = torch.randn((1, 8, 4), device=cuda), torch.randn((1, 8, 4),
                                                            device=cuda)
    y, h_last = ssm_scan(xs, dt, A, B, C, None)
    assert y.grad_fn is not None
    before = build.LAUNCHES["ssm_scan_bwd"]
    y.sum().backward()
    assert build.LAUNCHES["ssm_scan_bwd"] == before + 1
    assert xs.grad is not None and xs.grad.shape == xs.shape
    with pytest.raises(RuntimeError, match="cut the graph"):
        ssm_scan_bsd(xs, dt, A, B, C, None)
    with torch.no_grad():
        assert ssm_scan(xs, dt, A, B, C, None)[0].grad_fn is None


@pytest.mark.cuda
def test_reduced_glm_loss_and_gradients_on_card_match_host(cuda):
    """Float32 reduced glm4-9b: the loss and every gradient through the
    kernels on the card against the plain twins on the CPU."""
    from repro_torch.configs import ARCHS
    from repro_torch.models.model_zoo import build_model
    cfg = ARCHS["glm4-9b"].reduced(num_layers=2)
    host = build_model(cfg, kind="train", device="cpu", dtype=torch.float32)
    host.init_params(torch.Generator().manual_seed(0))
    card = build_model(cfg, kind="train", device=cuda, dtype=torch.float32)
    card.load_state_dict(host.state_dict())
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab_size, (2, 129)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    out = []
    for model in (host, card):
        params = dict(model.named_parameters())
        for p in params.values():
            p.requires_grad_(True)
        before = dict(build.LAUNCHES)
        total, _ = model.loss(batch)
        grads = torch.autograd.grad(total, list(params.values()))
        launched = {k: build.LAUNCHES[k] - before[k] for k in before}
        out.append((total.detach().cpu(), [g.cpu() for g in grads],
                    launched))
    (lh, gh, _), (lc, gc, launched) = out
    L = cfg.num_layers
    assert launched["flash_attention"] == 2 * L          # remat recomputes
    assert launched["flash_attention_bwd"] == L
    assert launched["rmsnorm"] == 4 * L + 1
    assert launched["rmsnorm_bwd"] == 2 * L + 1
    assert abs(float(lc) - float(lh)) <= 1e-5 * abs(float(lh))
    for a, w in zip(gc, gh):
        torch.testing.assert_close(a, w, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["glm4-9b", "falcon-mamba-7b"])
def test_reduced_train_step_counts_the_same_on_meta_and_card(cuda, arch):
    """A reduced train step counted by ``analysis.cost.CostCounter`` on meta
    tensors and on the card: equal costs, products, kernel calls (each a
    launch) and, within 5 %, peak memory."""
    from repro_torch.configs import ARCHS, ShapeConfig
    from repro_torch.launch import dryrun
    cfg = ARCHS[arch].reduced()
    shape = ShapeConfig("t", 256, 2, "train")
    meta, _ = dryrun.count_cell(dryrun.make_cell(cfg, shape, "meta"))
    cell = dryrun.make_cell(cfg, shape, cuda)
    torch.cuda.synchronize()
    before = dict(build.LAUNCHES)
    card, _ = dryrun.count_cell(cell)
    torch.cuda.synchronize()
    launched = {k: build.LAUNCHES[k] - before[k] for k in before
                if build.LAUNCHES[k] != before[k]}
    assert card.cost == meta.cost
    assert card.matmul_flops == meta.matmul_flops
    assert card.calls == meta.calls == launched
    assert abs(card.peak_bytes - meta.peak_bytes) <= 0.05 * meta.peak_bytes

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
from repro_torch.kernels import (build, ema_scan_plain, ema_scan_rows,
                                 spike_hist, spike_hist_batch,
                                 spike_hist_batch_plain)
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


@pytest.mark.cuda
@pytest.mark.parametrize("rows,cols", [(300, 256), (1, 5000), (7, 3)])
def test_spike_hist_equals_plain(cuda, rows, cols):
    rng = np.random.default_rng(rows)
    r = rng.uniform(0.0, 2.5, (rows, cols))
    flat = r.reshape(-1)
    edges = _edges()[:flat.size]
    flat[:len(edges)] = edges
    r[rng.random(r.shape) < 0.1] = -np.inf
    for dtype in (torch.float64, torch.float32):
        t = torch.from_numpy(r).to(cuda, dtype)
        before = build.LAUNCHES["spike_hist"]
        got = spike_hist_batch(t, BINS, NBINS)
        assert build.LAUNCHES["spike_hist"] == before + 1
        assert torch.equal(got.cpu(),
                           spike_hist_batch_plain(t.cpu(), BINS, NBINS))


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

"""The port's blocked float64 EMA (``repro_torch.kernels.ema_scan_blocks``)
against the reference's NumPy blocks.

The reference filters a trace in fixed-position blocks of 256 samples with
``repro.pipeline.builder._ema_filter_block``, carrying each block's last
value into the next; the port filters many such rows, ragged or uniform,
each with its own carried state, in one call.  On the CPU the wrapper runs
its plain twin, which must equal the reference **bitwise** (the reference
pins the batch engine to the per-job builder bit for bit).  The CUDA kernel
is held against the plain twin by ``tests/test_torch_cuda.py`` and
``chip_smoke.py`` on the card.
"""
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.pipeline.builder import _ema_filter_block as ref_block
from repro_torch.kernels import ema_scan_blocks, ema_scan_blocks_plain

BLOCK = 256
EDGE_LENGTHS = (1, 255, 256, 257, 512, 4 * 256 + 3)
ALPHAS = (0.5, 1.0, 0.999)


def _ref_row(p: np.ndarray, state, alpha: float) -> np.ndarray:
    """One row through the reference's blocks, the carry between them."""
    w = 1.0 - alpha
    out = []
    for b in range(0, len(p), BLOCK):
        o = ref_block(p[b:b + BLOCK], state, alpha, w)
        state = float(o[-1])
        out.append(o)
    return np.concatenate(out) if out else np.empty(0)


def _ragged(seed: int, lengths, with_state: bool):
    rng = np.random.default_rng(seed)
    rows = [rng.uniform(0.0, 400.0, n) for n in lengths]
    states = rng.uniform(0.0, 400.0, len(lengths))
    has = np.ones(len(lengths), bool) if with_state \
        else np.zeros(len(lengths), bool)
    return rows, states, has


def _run_ragged(fn, rows, states, has, alpha, **kw):
    offs = np.concatenate([[0], np.cumsum([len(r) for r in rows])])
    x = torch.from_numpy(np.concatenate(rows) if rows else np.empty(0))
    return fn(x, torch.from_numpy(states.copy()), torch.from_numpy(has),
              alpha, offsets=offs, **kw), offs


@pytest.mark.parametrize("alpha", ALPHAS)
@pytest.mark.parametrize("state_mode", ["none", "all", "mixed"])
def test_plain_blocks_bitwise_equal_reference_ragged(alpha, state_mode):
    # every edge length, a row of length 0 between them, in one call
    lengths = list(EDGE_LENGTHS[:3]) + [0] + list(EDGE_LENGTHS[3:]) + [0]
    rows, states, has = _ragged(7, lengths, state_mode != "none")
    if state_mode == "mixed":
        has[::2] = False
    got, offs = _run_ragged(ema_scan_blocks_plain, rows, states, has, alpha)
    assert got.dtype == torch.float64 and got.shape == (offs[-1],)
    for j, p in enumerate(rows):
        want = _ref_row(p, float(states[j]) if has[j] else None, alpha)
        np.testing.assert_array_equal(got[offs[j]:offs[j + 1]].numpy(), want)


@pytest.mark.parametrize("alpha", ALPHAS)
@pytest.mark.parametrize("n", EDGE_LENGTHS)
def test_plain_blocks_bitwise_equal_reference_one_row(alpha, n):
    p = np.random.default_rng(n).uniform(0.0, 400.0, n)
    for state in (None, 123.456):
        got = ema_scan_blocks_plain(
            torch.from_numpy(p),
            None if state is None else torch.tensor(state, dtype=torch.float64),
            state is not None, alpha)
        np.testing.assert_array_equal(got.numpy(), _ref_row(p, state, alpha))


@pytest.mark.parametrize("alpha", [0.5, 0.999])
def test_plain_blocks_stop_at_zero_decay(alpha):
    # an infinite sample stays infinite downstream; a step with a decay
    # that underflowed to 0.0 (alpha 0.999: w^128) would make it NaN, so
    # the steps must stop where the reference's loop stops
    p = np.random.default_rng(2).uniform(0.0, 400.0, 3 * BLOCK)
    p[BLOCK + 5] = np.inf
    want = _ref_row(p, 5.0, alpha)
    assert not np.isnan(want).any()
    got = ema_scan_blocks_plain(torch.from_numpy(p),
                                torch.tensor(5.0, dtype=torch.float64), True,
                                alpha)
    np.testing.assert_array_equal(got.numpy(), want)


def test_uniform_rows_index_and_state_out():
    # the engine's group advance: the first n of each (rows, m) row, states
    # read and written at slots of a column
    rng = np.random.default_rng(3)
    buf = torch.from_numpy(rng.uniform(0.0, 400.0, (5, 2 * BLOCK + 40)))
    col = torch.from_numpy(rng.uniform(0.0, 400.0, 9))
    has_col = torch.zeros(9, dtype=torch.bool)
    idx = torch.tensor([8, 2, 0, 5, 6])
    for has in (False, True):
        state, hcol = col.clone(), has_col.clone()
        got = ema_scan_blocks(buf, state, has, 0.5, n=2 * BLOCK, index=idx,
                              state_out=state, has_out=hcol)
        assert got.shape == (5, 2 * BLOCK) and got.is_contiguous()
        for j, s in enumerate(idx.tolist()):
            want = _ref_row(buf[j, :2 * BLOCK].numpy(),
                            float(col[s]) if has else None, 0.5)
            np.testing.assert_array_equal(got[j].numpy(), want)
            assert state[s] == want[-1] and hcol[s]
        untouched = [s for s in range(9) if s not in idx.tolist()]
        assert torch.equal(state[untouched], col[untouched])
        assert not hcol[untouched].any()


def test_ragged_state_out_skips_empty_rows():
    rows, states, has = _ragged(4, (300, 0, 17), True)
    state, hcol = torch.from_numpy(states.copy()), torch.from_numpy(has)
    hcol[1] = False
    offs = [0, 300, 300, 317]
    got = ema_scan_blocks(torch.from_numpy(np.concatenate(rows)), state,
                          hcol, 0.5, offsets=offs, state_out=state,
                          has_out=hcol)
    assert state[0] == got[299] and state[2] == got[316]
    assert state[1] == states[1] and not hcol[1]


@settings(max_examples=60, deadline=None)
@given(lengths=st.lists(st.integers(0, 700), min_size=1, max_size=6),
       has_bits=st.lists(st.booleans(), min_size=6, max_size=6),
       seed=st.integers(0, 2**16), alpha=st.sampled_from(ALPHAS + (0.25,)))
def test_property_blocks_equal_reference(lengths, has_bits, seed, alpha):
    rows, states, _ = _ragged(seed, lengths, True)
    has = np.array(has_bits[:len(lengths)])
    got, offs = _run_ragged(ema_scan_blocks, rows, states, has, alpha)
    plain, _ = _run_ragged(ema_scan_blocks_plain, rows, states, has, alpha)
    assert torch.equal(got, plain)
    for j, p in enumerate(rows):
        want = _ref_row(p, float(states[j]) if has[j] else None, alpha)
        np.testing.assert_array_equal(got[offs[j]:offs[j + 1]].numpy(), want)


@pytest.mark.parametrize("fn", [ema_scan_blocks, ema_scan_blocks_plain])
def test_blocks_reject_bad_inputs(fn):
    x = torch.zeros(300, dtype=torch.float64)
    with pytest.raises(TypeError, match="float64"):
        fn(x.float())
    with pytest.raises(ValueError, match="contiguous"):
        fn(torch.zeros((300, 4), dtype=torch.float64).t())
    with pytest.raises(ValueError, match="contiguous"):
        fn(torch.zeros(600, dtype=torch.float64)[::2], offsets=[0, 300])
    with pytest.raises(ValueError, match="past the end"):
        fn(x, offsets=[0, 200, 301])
    with pytest.raises(ValueError, match="never decrease"):
        fn(x, offsets=[0, 200, 100])
    with pytest.raises(ValueError, match="needs a state"):
        fn(x, None, True)
    with pytest.raises(ValueError, match="alpha"):
        fn(x, alpha=0.0)
    with pytest.raises(ValueError, match="entries for"):
        fn(torch.zeros((3, 300), dtype=torch.float64),
           torch.zeros(2, dtype=torch.float64), True)
    with pytest.raises(ValueError, match="go together"):
        fn(x, torch.zeros(1, dtype=torch.float64), True,
           state_out=torch.zeros(1, dtype=torch.float64))

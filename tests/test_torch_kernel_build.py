"""The port's kernel build and the backward kernels' launch plans, on the
CPU (no nvcc, no card):

* ``build._lib_path`` names a library by the hash of its source, of every
  header the source includes from ``csrc/`` (recursively) and of the flags,
  so an edited header rebuilds the library and an unrelated file does not;
* ``bwd_plan`` (``kernels/flash_attention.py``): CTA counts, the split, the
  scratch, and the dK/dV and dQ grids' heaviest-first orders covering every
  visible (key tile, head, query tile) and every (query tile, head, batch)
  exactly once; its tile sizes are the CUDA source's;
* ``bwd_plan`` of ``kernels/rmsnorm.py``: every row in exactly one CTA's run
  and one step's group, a thread's chunks within the kernel's limit (a
  wider row raises), the ring in the shared memory the kernel asks for,
  several rows a step for narrow rows, dscale's columns and partials each
  summed once in runs of at most 16; its constants are the CUDA source's;
* the ``ssm_scan_bwd`` source: built and hashed like the others, its four
  entry points the ones ``build`` binds, its shape and layout constants the
  ones the wrapper plans and sizes its workspace with; ``bwd_plan`` of
  ``kernels/ssm_scan.py``: a value, four states a thread where eight would
  leave SMs short (batch 1), every layout it picks covering ds.
"""
import importlib
import os
import re

import pytest

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import BwdPlan, bwd_plan

# the modules (the package exports functions of the same names)
fa = importlib.import_module("repro_torch.kernels.flash_attention")
rn = importlib.import_module("repro_torch.kernels.rmsnorm")
ss = importlib.import_module("repro_torch.kernels.ssm_scan")


def _write(d, name, text):
    with open(os.path.join(d, name), "w") as f:
        f.write(text)


def test_a_header_edit_changes_the_library_path(tmp_path, monkeypatch):
    d = str(tmp_path)
    monkeypatch.setattr(build, "CSRC", d)
    _write(d, "k.cu", '#include <cuda.h>\n#include "a.cuh"\nint k;\n')
    _write(d, "a.cuh", '#pragma once\n  #  include "b.cuh"\nint a;\n')
    _write(d, "b.cuh", "int b;\n")
    _write(d, "other.cuh", "int other;\n")
    _write(d, "other.cu", "int o;\n")
    assert build.sources_of("k") == ["k.cu", "a.cuh", "b.cuh"]
    first = build._lib_path("k")
    assert build._lib_path("k") == first                     # stable
    _write(d, "other.cuh", "int other2;\n")
    _write(d, "other.cu", "int o2;\n")
    assert build._lib_path("k") == first                     # unrelated
    _write(d, "b.cuh", "int b2;\n")                          # nested header
    second = build._lib_path("k")
    assert second != first
    _write(d, "a.cuh", '#pragma once\n#include "b.cuh"\nint a2;\n')
    assert build._lib_path("k") not in (first, second)
    _write(d, "k.cu", '#include <cuda.h>\n#include "a.cuh"\nint k2;\n')
    assert os.path.basename(build._lib_path("k")).startswith("k-")


def test_the_flash_sources_include_the_shared_header(monkeypatch):
    for name in ("flash_attention", "flash_attention_bwd"):
        assert build.sources_of(name) == [f"{name}.cu", "hopper.cuh"]
    monkeypatch.setattr(build, "_nvcc", lambda: "nvcc")
    cmd = build.nvcc_command("/elsewhere/variant.cu", "/elsewhere/v.so")
    # a variant's copy of a source, built elsewhere, finds the header
    assert cmd[cmd.index("-I") + 1] == build.CSRC
    assert cmd[-1] == "/elsewhere/variant.cu" and "-O3" in cmd


def test_bwd_tiles_are_the_cuda_sources():
    with open(os.path.join(build.CSRC, "flash_attention_bwd.cu")) as f:
        src = f.read()
    consts = {m.group(1): m.group(2) for m in re.finditer(
        r"constexpr int (k\w+) = ([^;]+);", src)}
    consumers = int(consts["kBwdConsumers"])
    env = {"kBwdConsumers": consumers}
    value = {k: eval(v, {}, env) for k, v in consts.items()
             if k in ("kDkdvKeys", "kDkdvRows", "kDqRows", "kDqKeys",
                      "kRowPad")}
    assert value == {"kDkdvKeys": fa.BWD_KEYS, "kDkdvRows": fa.BWD_ROWS,
                     "kDqRows": fa.BWD_DQ_ROWS, "kDqKeys": fa.BWD_DQ_KEYS,
                     "kRowPad": fa.BWD_ROW_PAD}


def test_f32_bwd_tiles_are_the_plan():
    """The float32 backward takes bwd_plan's launch too: its CTAs' keys, a
    pair's query rows and the row padding are the plan's."""
    with open(os.path.join(build.CSRC, "flash_attention_bwd.cu")) as f:
        src = f.read()
    consts = {m.group(1): int(m.group(2)) for m in re.finditer(
        r"constexpr int (kF32\w+) = (\d+);", src)}
    assert {k: consts[k] for k in ("kF32Keys", "kF32Rows",
                                   "kF32RowPad")} == {
        "kF32Keys": fa.BWD_KEYS, "kF32Rows": fa.BWD_ROWS,
        "kF32RowPad": fa.BWD_ROW_PAD}
    # a step divides a pair's rows and the padding
    for step in (consts["kF32SmallStep"], consts["kF32BigStep"]):
        assert fa.BWD_ROWS % step == 0 and fa.BWD_ROW_PAD % step == 0


SHAPES = [  # (b, sq, skv, H, KV, dh, causal)
    (4, 1024, 1024, 32, 2, 128, True),      # glm4-9b's training shapes
    (1, 4096, 4096, 32, 2, 128, True),
    (4, 1024, 1024, 24, 8, 64, True),       # granite-moe's
    (1, 129, 129, 8, 2, 128, True),
    (1, 257, 257, 8, 2, 128, True),
    (2, 300, 300, 8, 8, 128, True),         # H == KV
    (1, 200, 200, 10, 2, 64, True),         # a group of 5 in 8 parts
    (4, 512, 512, 32, 2, 64, True),
    (2, 1, 300, 8, 2, 128, True),           # one row against 300 keys
    (3, 1, 65, 6, 2, 128, True),
    (2, 100, 300, 4, 1, 32, False),
    (1, 129, 63, 8, 8, 64, False),          # sq > skv
]


def _visible(sq, skv, causal, qrow, key):
    return not causal or key <= qrow + (skv - sq)


@pytest.mark.parametrize("b,sq,skv,H,KV,dh,causal", SHAPES)
def test_bwd_plan_counts_and_scratch(b, sq, skv, H, KV, dh, causal):
    p = bwd_plan(b, sq, skv, H, KV, dh, 132, causal)
    kt = -(-skv // 128)
    assert p.key_tiles == kt
    assert p.dkdv_ctas == kt * KV * b * p.split
    assert p.dq_ctas == -(-sq // 128) * H * b
    assert p.sq_pad % 128 == 0 and sq <= p.sq_pad < sq + 128
    rows = b * H * p.sq_pad
    parts = 2 * p.split * b * skv * KV * dh if p.split > 1 else 0
    assert p.scratch_bytes == 4 * (2 * rows + parts)
    if kt * KV * b >= 132:
        assert p.split == 1                 # the grid already fills the card
    else:
        assert 1 <= p.split <= fa._MAX_SPLIT
        # enough CTAs for two an SM unless the cap or the pairs stop it
        lightest = H // KV * len(p.visible_query_tiles(kt - 1, causal))
        assert p.dkdv_ctas >= 2 * 132 or p.split in (fa._MAX_SPLIT,
                                                     lightest)


def test_bwd_plan_at_the_training_shapes():
    glm = bwd_plan(4, 1024, 1024, 32, 2, 128, 132)
    assert (glm.split, glm.dkdv_ctas, glm.dq_ctas) == (5, 320, 1024)
    assert glm.scratch_bytes == 4 * (2 * 4 * 32 * 1024
                                     + 2 * 5 * 4 * 1024 * 2 * 128)
    assert bwd_plan(1, 4096, 4096, 32, 2, 128, 132).dkdv_ctas == 320
    granite = bwd_plan(4, 1024, 1024, 24, 8, 64, 132)
    assert (granite.split, granite.dkdv_ctas) == (1, 256)
    assert granite.scratch_bytes == 4 * 2 * 4 * 24 * 1024     # no parts
    assert bwd_plan(4, 1024, 1024, 32, 2, 128, 100).split == 4  # fewer SMs
    assert bwd_plan(4, 1024, 1024, 32, 2, 128, 64).split == 1   # filled


@pytest.mark.parametrize("b,sq,skv,H,KV,dh,causal", SHAPES)
def test_bwd_dkdv_order_covers_every_pair_once_heaviest_first(
        b, sq, skv, H, KV, dh, causal):
    p = bwd_plan(b, sq, skv, H, KV, dh, 132, causal)
    seen = {}
    work = []                # pairs of each CTA's key tile, in launch order
    for kt, kvh, bi, part, pairs in p.dkdv_order(causal):
        tiles = p.visible_query_tiles(kt, causal)
        work.append(H // KV * len(tiles))
        for h, qt in pairs:
            assert h // (H // KV) == kvh and qt in tiles
            key = (kt, bi, h, qt)
            assert key not in seen, key
            seen[key] = part
        # the parts of a key tile differ by at most one pair
        n = H // KV * len(tiles)
        assert len(pairs) in (n // p.split, -(-n // p.split))
    assert work == sorted(work, reverse=True)
    want = set()
    for kt in range(p.key_tiles):
        for bi in range(b):
            for h in range(H):
                for qt in range(-(-sq // 64)):
                    rows = range(qt * 64, min(sq, qt * 64 + 64))
                    keys = range(kt * 128, min(skv, kt * 128 + 128))
                    if any(_visible(sq, skv, causal, r, k)
                           for r in (rows[-1],) for k in (keys[0],)):
                        want.add((kt, bi, h, qt))
    assert set(seen) == want


@pytest.mark.parametrize("b,sq,skv,H,KV,dh,causal", SHAPES)
def test_bwd_dq_order_covers_every_tile_once_heaviest_first(
        b, sq, skv, H, KV, dh, causal):
    p = bwd_plan(b, sq, skv, H, KV, dh, 132, causal)
    order = list(p.dq_order(causal))
    assert len(order) == p.dq_ctas
    assert {(qt, h, bi) for qt, h, bi, _ in order} == {
        (qt, h, bi) for qt in range(-(-sq // 128)) for h in range(H)
        for bi in range(b)}
    tiles = [n for *_, n in order]
    assert tiles == sorted(tiles, reverse=True)
    for qt, _, _, n in order:       # the key tiles the tile's last row sees
        last = min(sq, qt * 128 + 128) - 1
        keys = min(skv, last + (skv - sq) + 1) if causal else skv
        assert n == -(-keys // 64)


@pytest.mark.parametrize("b,sq,skv,H,KV,dh,causal", SHAPES + [
    (4, 1024, 1600, 32, 8, 128, False), (4, 1024, 1024, 16, 16, 64, False)])
def test_f32_bwd_plan_fills_its_waves_and_covers_every_pair_once(
        b, sq, skv, H, KV, dh, causal):
    p = bwd_plan(b, sq, skv, H, KV, dh, 132, causal, simt=True)
    base = bwd_plan(b, sq, skv, H, KV, dh, 132, causal, simt=False)
    lightest = H // KV * len(p.visible_query_tiles(p.key_tiles - 1, causal))
    cap = max(min(fa._MAX_SPLIT, lightest), 1)
    assert base.split <= p.split <= cap or p.split == base.split == 1
    ctas = p.dkdv_ctas
    fill = ctas / 132 / -(-ctas // 132)
    # the last wave leaves at most the slack idle, unless the cap stops it
    assert fill >= 1 - fa._F32_WAVE_SLACK or p.split == cap
    seen = set()
    for kt, kvh, bi, part, pairs in p.dkdv_order(causal):
        for h, qt in pairs:
            assert (kt, bi, h, qt) not in seen
            seen.add((kt, bi, h, qt))
    assert len(seen) == sum(H * len(p.visible_query_tiles(kt, causal)) * b
                            for kt in range(p.key_tiles))


def test_f32_bwd_plan_at_the_timed_shapes():
    """One CTA an SM: the causal training shapes split for four CTAs an SM
    (capped at 8 parts), the vlm's cross shape raised from 416 CTAs (3.15
    waves of 132) to 4 parts (12.6 of 13), the full grids left alone."""
    want = {(4, 1024, 1024, 32, 2, 128, True): (8, 5),   # (float32, bf16)
            (1, 4096, 4096, 32, 2, 128, True): (8, 5),
            (4, 1024, 1024, 24, 8, 64, True): (1, 1),
            (4, 1024, 1600, 32, 8, 128, False): (4, 1),
            (4, 1024, 1024, 16, 16, 64, False): (1, 1)}
    for (b, sq, skv, H, KV, dh, causal), splits in want.items():
        p = bwd_plan(b, sq, skv, H, KV, dh, 132, causal, simt=True)
        got = (p.split, bwd_plan(b, sq, skv, H, KV, dh, 132, causal).split)
        assert got == splits, (b, sq, skv, H, KV, dh)
        # scratch: lse2, D, the dK/dV parts, each key tile's dQ partial
        rows = b * H * p.sq_pad
        parts = 2 * p.split * b * skv * KV * dh if p.split > 1 else 0
        assert p.scratch_bytes == 4 * (2 * rows + parts
                                       + p.key_tiles * rows * dh)


def test_bwd_plan_is_a_value():
    p = bwd_plan(4, 1024, 1024, 32, 2, 128, 132)
    assert p == BwdPlan(4, 1024, 1024, 32, 2, 128, 5)
    with pytest.raises(Exception):
        p.split = 2


# --- the norm backward's launch plan (kernels/rmsnorm.py, bwd_plan) ---------
# (d, x bytes, scale bytes, vectorized): glm4-9b's rows in both dtypes,
# granite-moe's, deepseek's latent norm and width, the widest rows each path
# takes, and rows read from device memory (d = 100, and any unaligned row)
NORM_CASES = [(4096, 2, 2, True), (4096, 4, 4, True), (1536, 2, 2, True),
              (512, 2, 2, True), (512, 4, 2, True), (5120, 2, 2, True),
              (16384, 2, 2, True), (8192, 4, 4, True), (100, 2, 2, False),
              (2048, 2, 4, False)]
NORM_ROWS = [1, 2, 7, 131, 264, 265, 1003, 4001, 4096, 70_000]


def test_norm_bwd_constants_are_the_cuda_source():
    with open(os.path.join(build.CSRC, "rmsnorm.cu")) as f:
        src = f.read()
    consts = {m.group(1): int(m.group(2)) for m in re.finditer(
        r"constexpr int (kBwd\w+) = (\d+);", src)}
    assert consts == {"kBwdThreads": rn.BWD_THREADS,
                      "kBwdMaxChunks": rn.BWD_MAX_CHUNKS,
                      "kBwdMinCtas": rn.BWD_MIN_CTAS,
                      "kBwdMaxStages": rn.BWD_MAX_STAGES,
                      "kBwdHeader": rn.BWD_HEADER,
                      "kBwdColSmem": rn.BWD_COL_SMEM}
    # the header holds the ring's mbarriers and two float2s a warp
    # (rmsnorm_bwd_kernel: at 0 and 64); the body the column sums' chunk
    # sums, a float a thread
    assert 8 * rn.BWD_MAX_STAGES <= 64
    assert 64 + 2 * 8 * (rn.BWD_THREADS // 32) <= rn.BWD_HEADER
    assert rn.BWD_COL_SMEM >= 4 * rn.BWD_THREADS


@pytest.mark.parametrize("n", NORM_ROWS)
@pytest.mark.parametrize("d,xs,ss,vec", NORM_CASES)
def test_norm_bwd_plan_covers_every_row_once(n, d, xs, ss, vec):
    for sms in (132, 7):
        p = rn.bwd_plan(n, d, xs, ss, vec, sms)
        runs = [(i * p.per, min(n, (i + 1) * p.per)) for i in range(p.ctas)]
        assert len(runs) == p.ctas <= sms * p.ctas_per_sm
        assert p.per == -(-n // (sms * p.ctas_per_sm))
        assert runs[0][0] == 0 and runs[-1][1] == n
        assert all(a < b for a, b in runs)               # none is empty
        assert all(b == a2 for (_, b), (a2, _) in zip(runs, runs[1:]))
        # the kernel's steps: group g of step t takes row r0 + t R + g
        seen = [r0 + t * p.rows_per_step + g for r0, r1 in runs
                for t in range(-(-(r1 - r0) // p.rows_per_step))
                for g in range(p.rows_per_step)
                if r0 + t * p.rows_per_step + g < r1]
        assert seen == list(range(n))
        # dscale: CTA i sums columns [i cols, + cols), col_width at a
        # time, each over col_chunks runs of per_chunk CTAs' partials (a
        # thread a run), then the runs in order; every column once, every
        # partial once a column, no thread adding more than 16 one after
        # another, nor the runs' sums more than 17
        cols = [c for i in range(p.ctas)
                for c0 in range(i * p.cols, min(d, (i + 1) * p.cols),
                                p.col_width)
                for c in range(c0, min(c0 + p.col_width, d,
                                       (i + 1) * p.cols))]
        assert cols == list(range(d))
        assert p.col_width * p.col_chunks <= rn.BWD_THREADS
        assert p.per_chunk <= 16 and p.col_chunks <= 17
        runs = [list(range(q * p.per_chunk,
                           min(p.ctas, (q + 1) * p.per_chunk)))
                for q in range(p.col_chunks)]
        assert sum(runs, []) == list(range(p.ctas))
        assert p.partial_floats == p.ctas * d


@pytest.mark.parametrize("d,xs,ss,vec", NORM_CASES)
def test_norm_bwd_plan_chunks_and_shared_memory(d, xs, ss, vec):
    p = rn.bwd_plan(4096, d, xs, ss, vec, 132)
    chunks = d // p.vec
    assert p.vec == (16 // xs if vec else 1)
    assert p.rows_per_step * p.warps == rn.BWD_THREADS // 32
    assert p.chunks == -(-chunks // (32 * p.warps)) <= rn.BWD_MAX_CHUNKS
    # no group of warps leaves fewer threads idle; a tie goes to the wider
    idle = p.chunks * 32 * p.warps - chunks
    for w in (1, 2, 4, 8):
        nc = -(-chunks // (32 * w))
        if nc <= rn.BWD_MAX_CHUNKS:
            assert nc * 32 * w - chunks > idle or (
                nc * 32 * w - chunks == idle and w <= p.warps)
    # the shared memory the kernel asks for holds the header, scale and
    # the ring (or, at the end, the step's groups' float32 partials), and
    # ctas_per_sm of them fit an SM
    assert p.smem_bytes == rn.bwd_smem(d, p.rows_per_step, p.stages, xs, ss)
    body = p.smem_bytes - rn.BWD_HEADER - -(-d * ss // 128) * 128
    assert body >= 4 * p.rows_per_step * d
    assert p.smem_bytes <= min(rn._SMEM_CTA, rn._SMEM_SM // p.ctas_per_sm
                               - rn._SMEM_RESERVED)
    assert p.stage_bytes == 2 * p.rows_per_step * d * xs
    if vec:
        assert 2 <= p.stages <= rn.BWD_MAX_STAGES
        assert body >= p.stages * p.stage_bytes
    else:
        assert p.stages == 0
    # the tx count of a stage's mbarrier phase stays under 2^20 bytes
    assert p.stage_bytes < 1 << 20


@pytest.mark.parametrize("d,rows", [(512, 4), (1536, 4)])
def test_norm_bwd_plan_gives_narrow_rows_several_a_step(d, rows):
    """deepseek's MLA latent norm and granite-moe's width: several rows a
    CTA step and no idle thread."""
    p = rn.bwd_plan(4096, d, 2, 2, True, 132)
    assert p.rows_per_step == rows > 1
    assert (d // 8) % (32 * p.warps) == 0


def test_norm_bwd_plan_at_the_training_shapes():
    glm = rn.bwd_plan(4096, 4096, 2, 2, True, 132)
    assert (glm.warps, glm.rows_per_step, glm.chunks, glm.stages,
            glm.ctas_per_sm, glm.ctas, glm.per, glm.cols, glm.col_width,
            glm.col_chunks, glm.per_chunk) == (
        8, 1, 2, 3, 2, 256, 16, 16, 16, 16, 16)
    f32 = rn.bwd_plan(4096, 4096, 4, 4, True, 132)
    assert (f32.chunks, f32.stages, f32.ctas_per_sm) == (4, 3, 2)
    wide = rn.bwd_plan(4096, 16384, 2, 2, True, 132)
    assert (wide.chunks, wide.ctas_per_sm, wide.ctas) == (8, 1, 128)


@pytest.mark.parametrize("d,xs,vec", [(16392, 2, True), (8200, 4, True),
                                      (2049, 2, False), (2049, 4, False)])
def test_norm_bwd_plan_refuses_rows_past_its_chunks(d, xs, vec):
    with pytest.raises(ValueError, match=r"at most 8 chunks .* elements a "
                                         r"row; got d="):
        rn.bwd_plan(16, d, xs, xs, vec, 132)


def test_norm_bwd_plan_is_a_value():
    p = rn.bwd_plan(4096, 4096, 2, 2, True, 132)
    assert p == rn.bwd_plan(4096, 4096, 2, 2, True, 132)
    with pytest.raises(Exception):
        p.ctas = 2


def test_the_scan_backward_is_built_and_hashed_like_the_others(monkeypatch):
    assert "ssm_scan_bwd" in build.SOURCES and "ssm_scan_bwd" in \
        build.LAUNCHES
    assert build.sources_of("ssm_scan_bwd") == ["ssm_scan_bwd.cu"]
    path = build._lib_path("ssm_scan_bwd")
    assert os.path.basename(path).startswith("ssm_scan_bwd-")
    assert path not in {build._lib_path(n) for n in build.SOURCES
                        if n != "ssm_scan_bwd"}
    with open(os.path.join(build.CSRC, "ssm_scan_bwd.cu")) as f:
        src = f.read()
    entries = set(re.findall(r"^SSM_SCAN_BWD_ENTRY\((\w+),", src, re.M))
    assert entries == set(build._SIGNATURES["ssm_scan_bwd"])
    # 16 pointers, batch, s, di, ds, the plan's lanes, the stream
    for argtypes in build._SIGNATURES["ssm_scan_bwd"].values():
        assert len(argtypes) == 22
    consts = {m.group(1): int(m.group(2)) for m in re.finditer(
        r"constexpr int (k\w+) = (\d+);", src)}
    assert (consts["kThreads"], consts["kSteps"]) == (ss.BWD_THREADS,
                                                      ss.BWD_STEPS)
    # the layouts by threads a channel, and the states the launch gives each
    lanes = (consts["kEightLanes"], consts["kFourLanes"],
             consts["kWideLanes"])
    assert dict(zip(lanes, (8, 4, 8))) == ss.BWD_LAYOUTS
    # the plan takes eight states where the grid fills the CTAs an SM that
    # the eight-state kernel's registers are kept for
    assert consts["kEightCtas"] == ss._BWD_EIGHT_MIN_CTAS
    assert "const int states = lanes == kFourLanes ? 4 : 8;" in src
    assert consts["kRing"] >= 2
    # a copy elsewhere builds with the same flags
    monkeypatch.setattr(build, "_nvcc", lambda: "nvcc")
    cmd = build.nvcc_command(os.path.join(build.CSRC, "ssm_scan_bwd.cu"),
                             "/tmp/x.so")
    assert "-gencode=arch=compute_90a,code=sm_90a" in cmd


@pytest.mark.parametrize("b,s,di,ds,skip,lanes", [
    (4, 1024, 8192, 16, False, 2), (1, 1000, 8192, 16, True, 4),
    (3, 77, 1000, 16, True, 4), (1, 33, 64, 37, False, 16),
    (1, 20, 48, 128, True, 16), (8, 9, 4200, 5, False, 2)])
def test_scan_backward_workspace_follows_the_kernel_layout(b, s, di, ds,
                                                           skip, lanes):
    plan = ss.bwd_plan(b, s, di, ds, 132)
    assert plan.lanes == lanes
    states = ss.BWD_LAYOUTS[lanes]
    assert plan.states == states and lanes * states >= ds
    ctas = -(-di // (ss.BWD_THREADS // lanes))
    blocks = -(-s // ss.BWD_STEPS)
    assert (plan.ctas, plan.blocks) == (ctas, blocks)
    saved = b * ctas * blocks * states * ss.BWD_THREADS
    want = saved + ctas * 2 * b * s * ds + b * di * ds + (b * di if skip
                                                           else 0)
    assert plan.workspace_floats(skip) == want


def test_scan_backward_plan_is_a_value():
    p = ss.bwd_plan(4, 1024, 8192, 16, 132)
    assert p == ss.bwd_plan(4, 1024, 8192, 16, 132)
    assert hash(p) == hash(ss.bwd_plan(4, 1024, 8192, 16, 132))
    with pytest.raises(Exception):
        p.lanes = 4


@pytest.mark.parametrize("b,s,sms,lanes", [
    (1, 2048, 132, 4),       # 128 CTAs of eight states for 132 SMs
    (2, 1024, 132, 4),       # 256: SMs left with one CTA
    (3, 1024, 132, 2),       # 384: every SM two or more
    (4, 1024, 132, 2),       # the training shape: 512
    (4, 1024, 264, 4),       # a card of twice the SMs
    (1, 2048, 64, 2)])
def test_scan_backward_plan_takes_four_states_where_eight_leave_sms_short(
        b, s, sms, lanes):
    p = ss.bwd_plan(b, s, 8192, 16, sms)
    assert p.lanes == lanes
    if lanes == 2:
        assert b * p.ctas >= 2 * sms
    else:
        assert b * -(-8192 // (ss.BWD_THREADS // 2)) < 2 * sms
        assert p.ctas == 2 * -(-8192 // (ss.BWD_THREADS // 2))


@pytest.mark.parametrize("b", [1, 4, 64])
def test_every_scan_backward_layout_covers_the_states(b):
    for ds in range(1, ss.MAX_STATE + 1):
        p = ss.bwd_plan(b, 100, 8192, ds, 132)
        assert p.lanes in ss.BWD_LAYOUTS
        assert p.lanes * p.states >= ds
        assert (p.lanes == 16) == (ds > ss.BWD_SMALL_STATE)

"""The port's kernel build and the bf16 flash backward's launch plan, on the
CPU (no nvcc, no card):

* ``build._lib_path`` names a library by the hash of its source, of every
  header the source includes from ``csrc/`` (recursively) and of the flags,
  so an edited header rebuilds the library and an unrelated file does not;
* ``bwd_plan`` (``kernels/flash_attention.py``): CTA counts, the split, the
  scratch, and the dK/dV and dQ grids' heaviest-first orders covering every
  visible (key tile, head, query tile) and every (query tile, head, batch)
  exactly once; its tile sizes are the CUDA source's.
"""
import importlib
import os
import re

import pytest

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import BwdPlan, bwd_plan

# the module (the package exports a function of the same name)
fa = importlib.import_module("repro_torch.kernels.flash_attention")


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


def test_bwd_plan_is_a_value():
    p = bwd_plan(4, 1024, 1024, 32, 2, 128, 132)
    assert p == BwdPlan(4, 1024, 1024, 32, 2, 128, 5)
    with pytest.raises(Exception):
        p.split = 2

"""The reference workload zoo (paper Table 1 analogue).

Reference set: arch x shape cells from the assigned pool + HPC/graph
microbenchmarks — spanning compute-bound, memory-bound, hybrid, and
bursty-idle behavior, mirroring the paper's 18-workload diversity.

Held-out (never in the reference set; used for the §7.1 case study):
  * ``vector-search``  — FAISS analogue
  * ``granite-moe``    — Qwen1.5-MoE analogue (an unseen MoE architecture)
"""
from __future__ import annotations

import numpy as np

from repro_torch.analysis.hardware import FREQ_SWEEP
from repro_torch.configs import ARCHS, SHAPES
from repro_torch.device import DEFAULT_DEVICE
from repro_torch.telemetry import kernel_stream as kstream
from repro_torch.telemetry.power_model import TPUPowerModel

HOLDOUT_PREFIX = ("vector-search", "granite-moe-3b-a800m")

# arch x shape cells in the zoo (kept to a representative-but-diverse set;
# granite cells are excluded from references as the held-out MoE)
_REFERENCE_CELLS = [
    ("falcon-mamba-7b", "train_4k"), ("falcon-mamba-7b", "decode_32k"),
    ("falcon-mamba-7b", "long_500k"),
    ("glm4-9b", "train_4k"), ("glm4-9b", "decode_32k"),
    ("glm4-9b", "prefill_32k"),
    ("command-r-35b", "train_4k"), ("command-r-35b", "decode_32k"),
    ("command-r-35b", "prefill_32k"),
    ("phi3-medium-14b", "train_4k"), ("phi3-medium-14b", "decode_32k"),
    ("qwen2.5-14b", "train_4k"), ("qwen2.5-14b", "decode_32k"),
    ("llama-3.2-vision-11b", "train_4k"), ("llama-3.2-vision-11b", "decode_32k"),
    ("jamba-1.5-large-398b", "train_4k"), ("jamba-1.5-large-398b", "decode_32k"),
    ("jamba-1.5-large-398b", "long_500k"),
    ("deepseek-v2-236b", "train_4k"), ("deepseek-v2-236b", "decode_32k"),
    ("deepseek-v2-236b", "prefill_32k"),
    ("whisper-medium", "train_4k"), ("whisper-medium", "decode_32k"),
]

_HOLDOUT_CELLS = [
    ("granite-moe-3b-a800m", "decode_32k"),
    ("granite-moe-3b-a800m", "train_4k"),
]

# Novel families for the online class-discovery evaluation: shapes the
# shipped reference library has never seen — an encoder-decoder prefill
# (whisper), an SSM prefill (falcon-mamba), a sparse-MoE prefill (granite)
# and a hybrid SSM-MoE prefill (jamba).  Deliberately NOT part of
# ``reference_streams``: they exist to arrive unannounced from production
# traffic and be discovered (quarantine -> re-cluster -> promote).
_NOVEL_CELLS = [
    ("whisper-medium", "prefill_32k"),
    ("falcon-mamba-7b", "prefill_32k"),
    ("granite-moe-3b-a800m", "prefill_32k"),
    ("jamba-1.5-large-398b", "prefill_32k"),
]


def reference_streams(n_chips: int = 256) -> list[kstream.KernelStream]:
    out = []
    for arch, shape in _REFERENCE_CELLS:
        out.append(kstream.build_stream(ARCHS[arch], SHAPES[shape], n_chips))
    out += [
        kstream.micro_gemm(),
        kstream.micro_spmv_memory(),
        kstream.micro_spmv_compute(),
        kstream.micro_idle_burst(),
        kstream.micro_stencil(),
    ]
    return out


def holdout_streams(n_chips: int = 256) -> list[kstream.KernelStream]:
    out = [kstream.build_stream(ARCHS[a], SHAPES[s], n_chips)
           for a, s in _HOLDOUT_CELLS]
    out.append(kstream.micro_vector_search())
    return out


def novel_streams(n_chips: int = 256) -> list[kstream.KernelStream]:
    """Workload families outside the shipped reference library (see
    ``_NOVEL_CELLS``) — the discovery evaluation's unknown arrivals."""
    return [kstream.build_stream(ARCHS[a], SHAPES[s], n_chips)
            for a, s in _NOVEL_CELLS]


def _mix_weight(name: str) -> int:
    """Sampling weight of a zoo stream in the fleet job mix.  Production
    accelerator fleets are dominated by serving traffic (arXiv:2502.18680),
    so decode cells are drawn 4x as often as training, prefill/long-context
    and the HPC microbenchmarks 2x."""
    if ":decode" in name:
        return 4
    if ":prefill" in name or ":long" in name:
        return 2
    if ":" not in name:          # microbenchmarks / HPC analogues
        return 2
    return 1                     # train cells


def fleet_job_mix(n_jobs: int, seed: int = 0,
                  chips_choices=(32, 64, 128, 256),
                  include_novel: bool = False
                  ) -> list[tuple[kstream.KernelStream, int]]:
    """A deterministic mix of ``(kernel stream, chip count)`` jobs for fleet
    simulations, sampled (seeded, serving-weighted — see ``_mix_weight``)
    from the reference + holdout zoos — the arrival queue used by
    ``benchmarks/bench_fleet.py`` and the fleet example.

    ``include_novel=True`` extends the sampling pool with the
    ``novel_streams`` families (the discovery evaluation's unknown
    arrivals); the default pool — and hence every historical seed's draw
    sequence — is unchanged."""
    rng = np.random.default_rng(seed)
    pool = [s for s in reference_streams() + holdout_streams()
            for _ in range(_mix_weight(s.name))]
    if include_novel:
        pool += [s for s in novel_streams()
                 for _ in range(_mix_weight(s.name))]
    out = []
    for _ in range(n_jobs):
        stream = pool[int(rng.integers(len(pool)))]
        out.append((stream, int(chips_choices[int(
            rng.integers(len(chips_choices)))])))
    return out


def build_reference_set(model: TPUPowerModel | None = None,
                        freqs=FREQ_SWEEP, seed: int = 0,
                        target_duration: float = 4.0,
                        device=DEFAULT_DEVICE):
    """Profiles with full frequency sweeps (the shipped reference library),
    built on ``device``."""
    from repro_torch.pipeline.builder import stream_profile_workload
    model = model or TPUPowerModel()
    tdp = model.spec.tdp_w
    return [stream_profile_workload(s, model, freqs, tdp, seed=seed + i,
                                    target_duration=target_duration,
                                    device=device)
            for i, s in enumerate(reference_streams())]


def build_holdout_profiles(model: TPUPowerModel | None = None, seed: int = 77,
                           with_truth: bool = False, freqs=FREQ_SWEEP,
                           device=DEFAULT_DEVICE):
    """Held-out workloads: one uncapped profile each (what Minos sees) and,
    with ``with_truth``, apart from it the ground-truth sweep used only to
    evaluate predictions; built on ``device``."""
    from repro_torch.pipeline.builder import (stream_profile_once,
                                              stream_profile_workload)
    model = model or TPUPowerModel()
    tdp = model.spec.tdp_w
    observed, truth = [], []
    for i, s in enumerate(holdout_streams()):
        observed.append(stream_profile_once(s, model, tdp, seed=seed + i,
                                            device=device))
        if with_truth:
            truth.append(stream_profile_workload(s, model, freqs, tdp,
                                                 seed=seed + i,
                                                 device=device))
    return (observed, truth) if with_truth else observed

"""Analytic per-kernel (FLOPs, bytes) streams for every workload.

Each workload's one training/serving step is described as an ordered list of
``Kernel``s whose FLOPs/bytes are derived from the same ModelConfig math the
dry-run compiles.  The DVFS simulator executes these streams to produce power
traces and utilization counters — Minos itself only ever sees the sampled
telemetry, never this ground truth (DESIGN.md §2).

``gap_s`` models host-side time before a kernel (CPU sections, collective
stalls): the LSMS-like idle-burst pattern of the paper comes from streams
with large gaps.
"""
from __future__ import annotations

from dataclasses import dataclass, field

from repro_torch.configs.base import ModelConfig, ShapeConfig


@dataclass(frozen=True)
class Kernel:
    name: str
    flops: float
    bytes: float
    gap_s: float = 0.0          # host gap before this kernel


@dataclass(frozen=True)
class KernelStream:
    name: str
    kernels: tuple[Kernel, ...]
    domain: str = ""

    def totals(self) -> tuple[float, float]:
        return (sum(k.flops for k in self.kernels),
                sum(k.bytes for k in self.kernels))


def _mm(name: str, m: float, k: float, n: float, gap: float = 0.0,
        dtype_bytes: int = 2) -> Kernel:
    flops = 2.0 * m * k * n
    byts = (m * k + k * n + m * n) * dtype_bytes
    return Kernel(name, flops, byts, gap)


def _ew(name: str, elems: float, flops_per: float = 4.0,
        bytes_per: float = 6.0) -> Kernel:
    return Kernel(name, elems * flops_per, elems * bytes_per)


def lm_train_stream(cfg: ModelConfig, shape: ShapeConfig,
                    n_chips: int = 256) -> KernelStream:
    """One training step, per-chip share, fwd+bwd (bwd ~= 2x fwd)."""
    T = shape.tokens / n_chips          # tokens per chip
    d = cfg.d_model
    ks: list[Kernel] = []
    ks.append(_ew("embed", T * d))
    layers = _layer_kernels(cfg, shape, T)
    for i in range(cfg.num_layers):
        for k in layers(i):
            ks.append(k)
    ks.append(_mm("logits", T, d, cfg.padded_vocab / 16))
    ks.append(_ew("ce_loss", T * cfg.padded_vocab / 16, 2.0, 4.0))
    # backward ~= 2x forward compute on the same operands
    bwd = [Kernel("bwd_" + k.name, 2 * k.flops, 2 * k.bytes, k.gap_s)
           for k in ks]
    # optimizer: read p,m,v + grads, write p,m,v (AdamW)
    params = cfg.param_count() / n_chips
    opt = Kernel("adamw", 12 * params, 22 * params)
    grad_comm = Kernel("grad_reduce", 0.0, 2 * params, gap_s=0.0)
    return KernelStream(f"{cfg.name}:{shape.name}",
                        tuple(ks + bwd + [grad_comm, opt]), domain="train")


def _layer_kernels(cfg: ModelConfig, shape: ShapeConfig, T: float):
    d = cfg.d_model
    s = shape.seq_len

    def layer(i: int) -> list[Kernel]:
        ks: list[Kernel] = []
        ks.append(_ew(f"norm", T * d, 5.0, 4.0))
        if cfg.family == "ssm" or (cfg.family == "hybrid" and not cfg.is_attn_layer(i)):
            di, dst = cfg.d_inner, cfg.ssm_state
            ks.append(_mm("ssm_in_proj", T, d, 2 * di))
            ks.append(_ew("ssm_conv", T * di, 8.0, 6.0))
            ks.append(_mm("ssm_x_proj", T, di, cfg.dt_rank + 2 * dst))
            ks.append(_mm("ssm_dt_proj", T, cfg.dt_rank, di))
            # selective scan: ~9 flops per (token, di, ds) state element,
            # bandwidth-bound on state traffic
            ks.append(Kernel("ssm_scan", 9.0 * T * di * dst,
                             6.0 * T * di * dst / 16))
            ks.append(_mm("ssm_out_proj", T, di, d))
        elif cfg.use_mla:
            H, qk = cfg.num_heads, cfg.mla_qk_nope + cfg.qk_rope_dim
            ks.append(_mm("mla_q", T, d, H * qk))
            ks.append(_mm("mla_kva", T, d, cfg.kv_lora_rank + cfg.qk_rope_dim))
            ks.append(_mm("mla_kvb", T, cfg.kv_lora_rank,
                          H * (cfg.mla_qk_nope + cfg.mla_v_dim)))
            ks.append(_attn_core(T, s, H, qk, causal=shape.kind != "decode"))
            ks.append(_mm("mla_o", T, H * cfg.mla_v_dim, d))
        elif cfg.num_heads:
            H, KV, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
            ks.append(_mm("attn_qkv", T, d, (H + 2 * KV) * dh))
            ks.append(_attn_core(T, s, H, dh, causal=True))
            ks.append(_mm("attn_o", T, H * dh, d))
        if cfg.family == "vlm" and cfg.cross_attn_period and \
                (i % cfg.cross_attn_period) == (cfg.cross_attn_period - 1):
            H, KV, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
            ks.append(_mm("xattn_q", T, d, H * dh))
            ks.append(Kernel("xattn_core",
                             4.0 * T * cfg.num_image_tokens * H * dh,
                             2.0 * T * cfg.num_image_tokens * 2))
        if cfg.is_moe_layer(i):
            E, k, f = cfg.moe_num_experts, cfg.moe_top_k, cfg.moe_d_ff
            C = max(int(cfg.moe_group_size * k * cfg.capacity_factor / E), 1)
            ks.append(_mm("moe_router", T, d, E))
            ks.append(Kernel("moe_dispatch", 2.0 * T * E * C * d / 16,
                             2.0 * T * k * cfg.capacity_factor * d,
                             gap_s=2e-5))   # all-to-all-ish stall
            for mm in ("moe_gate", "moe_up", "moe_down"):
                ks.append(_mm(mm, T * k * cfg.capacity_factor, d if mm != "moe_down" else f,
                              f if mm != "moe_down" else d))
            ks.append(Kernel("moe_combine", 2.0 * T * E * C * d / 16,
                             2.0 * T * k * cfg.capacity_factor * d))
            if cfg.moe_num_shared:
                fs = cfg.moe_num_shared * f
                for mm in ("sh_gate", "sh_up"):
                    ks.append(_mm(mm, T, d, fs))
                ks.append(_mm("sh_down", T, fs, d))
        elif cfg.d_ff:
            n_mats = 3 if cfg.mlp_activation == "swiglu" else 2
            for j in range(n_mats - 1):
                ks.append(_mm(f"mlp_in{j}", T, d, cfg.d_ff))
            ks.append(_mm("mlp_out", T, cfg.d_ff, d))
        return ks

    return layer


def _attn_core(T: float, s: float, H: int, dh: int, causal: bool) -> Kernel:
    # flash-style: scores + AV, causal halves useful work
    factor = 0.5 if causal else 1.0
    flops = 4.0 * T * s * H * dh * factor
    byts = 2.0 * T * 2 * s * dh / 128 * H  # chunked KV re-reads amortized
    return Kernel("attn_core", flops, byts)


def lm_decode_stream(cfg: ModelConfig, shape: ShapeConfig,
                     n_chips: int = 256) -> KernelStream:
    """One decode step: weight-read bound + cache reads."""
    b = shape.global_batch / max(n_chips / 16, 1)   # per data-shard batch
    params = cfg.active_param_count() / 16           # per chip (TP 16)
    ks: list[Kernel] = [
        Kernel("decode_matmuls", 2.0 * params * b, 2.0 * params, gap_s=1e-4),
    ]
    # attention cache read
    S = shape.seq_len
    if cfg.family == "ssm":
        cache = cfg.num_layers * cfg.d_inner * cfg.ssm_state * 4 / 16
    elif cfg.use_mla:
        cache = cfg.num_layers * S * (cfg.kv_lora_rank + cfg.qk_rope_dim) * 2 / 16
    else:
        n_attn = cfg.num_layers // (cfg.attn_period or 1) if cfg.family == "hybrid" \
            else cfg.num_layers
        cache = n_attn * S * 2 * cfg.num_kv_heads * cfg.head_dim * 2 / 16
    ks.append(Kernel("decode_attn", 4.0 * b * cache / 2, b * cache))
    ks.append(_ew("decode_sample", b * cfg.padded_vocab / 16, 2.0, 2.0))
    return KernelStream(f"{cfg.name}:{shape.name}", tuple(ks), domain="decode")


def lm_prefill_stream(cfg: ModelConfig, shape: ShapeConfig,
                      n_chips: int = 256) -> KernelStream:
    T = shape.tokens / n_chips
    ks: list[Kernel] = [_ew("embed", T * cfg.d_model)]
    layers = _layer_kernels(cfg, shape, T)
    for i in range(cfg.num_layers):
        ks.extend(layers(i))
    ks.append(Kernel("kv_write", 0.0,
                     shape.tokens / n_chips * 2 * max(cfg.num_kv_heads, 1)
                     * max(cfg.head_dim, 1) * 2))
    ks.append(_mm("logits_last", shape.global_batch / n_chips * 16,
                  cfg.d_model, cfg.padded_vocab / 16))
    return KernelStream(f"{cfg.name}:{shape.name}", tuple(ks), domain="prefill")


def build_stream(cfg: ModelConfig, shape: ShapeConfig,
                 n_chips: int = 256) -> KernelStream:
    if shape.kind == "train":
        return lm_train_stream(cfg, shape, n_chips)
    if shape.kind == "prefill":
        return lm_prefill_stream(cfg, shape, n_chips)
    return lm_decode_stream(cfg, shape, n_chips)


# ---------------------------------------------------------------------------
# Microbenchmark workloads (paper Table 1 analogues)
# ---------------------------------------------------------------------------
def micro_gemm(n: int = 25536) -> KernelStream:
    """SGEMM 25536^3 (paper's compute-bound microbenchmark)."""
    return KernelStream("sgemm-25k", ( _mm("gemm", n / 16, n, n), ), "micro")


def micro_spmv_memory(nnz: float = 2e8, repeat: int = 24) -> KernelStream:
    """Pannotia-PageRank-like: bandwidth-bound irregular SpMV iterations."""
    ks = []
    for i in range(repeat):
        ks.append(Kernel("spmv", 2.0 * nnz / 16, 14.0 * nnz / 16, gap_s=3e-4))
        ks.append(_ew("rank_update", nnz / 64, 3.0, 8.0))
    return KernelStream("pagerank-pannotia", tuple(ks), "graph")


def micro_spmv_compute(nnz: float = 2e8, repeat: int = 24) -> KernelStream:
    """Gunrock-PageRank-like: fused frontier kernels, higher compute density."""
    ks = []
    for i in range(repeat):
        ks.append(Kernel("frontier", 24.0 * nnz / 16, 8.0 * nnz / 16))
        ks.append(_ew("rank_update", nnz / 64, 3.0, 8.0))
    return KernelStream("pagerank-gunrock", tuple(ks), "graph")


def micro_idle_burst(burst_flops: float = 5e13, bursts: int = 6,
                     gap_s: float = 0.12) -> KernelStream:
    """LSMS-like: GPU near idle with periodic dense bursts (matrix inversion
    on device, the rest on host)."""
    ks = []
    for i in range(bursts):
        ks.append(Kernel("zgetrf_burst", burst_flops, burst_flops / 250,
                         gap_s=gap_s))
    return KernelStream("lsms-like", tuple(ks), "hpc")


def micro_vector_search(nq: int = 4096, nd: float = 5e7, dim: int = 128
                        ) -> KernelStream:
    """FAISS-like fused batched-distance + top-k (held-out workload).

    Like the real FAISS GPU kernels, distances are reduced to top-k in
    registers — the (nq x nd) distance matrix is never materialized, so the
    op is compute-bound (the paper matches FAISS to SD-XL, a high-spike
    compute workload)."""
    n_loc = nd / 16
    flops = 2.0 * nq * dim * n_loc + 6.0 * nq * n_loc   # distances + topk cmp
    byts = (nq * dim + dim * n_loc + nq * 128) * 2.0    # inputs + topk out
    ks = [Kernel("dist_topk_fused", flops, byts, gap_s=5e-5)]
    return KernelStream("vector-search", tuple(ks), "micro")


def micro_stencil(cells: float = 990 ** 3, repeat: int = 10) -> KernelStream:
    """M-PSDNS-like FFT/stencil sweep: mixed compute + bandwidth."""
    ks = []
    for i in range(repeat):
        ks.append(Kernel("fft", 5.0 * cells * 30 / 16, 8.0 * cells / 16))
        ks.append(_ew("pointwise", cells / 16, 6.0, 10.0))
    return KernelStream("mpsdns-like", tuple(ks), "hpc")

"""Three-term roofline of a counted step (the reference's
``repro.analysis.roofline``), for one H100 by default.

    T_compute    = tensor_flops / bf16 peak + (flops - tensor_flops) / f32 rate
    T_memory     = hbm_bytes_min / HBM bandwidth
    T_collective = coll_bytes / (links x link bandwidth)   (0 on one card)

``cost`` is per device (``analysis.cost.CostCounter``'s count of the step).
MODEL_FLOPS = 6*N*D (train, active params) / 2*N*D (prefill) / decode:
2*N_active*batch + attention over the cache; the ratio MODEL_FLOPS / flops
exposes remat and redundancy.

Three points where the reference disagrees with itself are settled here:
``roofline_fraction`` divides by the report's own chip (the reference's by
``V5E`` whatever chip it was built for); ``build_report`` passes its ``tp``
to ``model_bytes_per_device`` (the reference always takes the default 16);
and the compute term charges only ``tensor_flops`` at the bf16 peak (the
reference charges every flop there).  With ``tensor_flops == flops``,
``spec=V5E`` and ``tp=16`` the report is the reference's, bit for bit.
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.analysis.cost import Cost
from repro_torch.analysis.hardware import H100, ChipSpec
from repro_torch.configs.base import ModelConfig, ShapeConfig


@dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    n_chips: int
    flops: float                 # per device
    hbm_bytes: float             # upper (every op's operands + results)
    hbm_bytes_min: float         # lower (materializing ops) — used for terms
    coll_bytes: dict
    t_compute: float
    t_memory: float
    t_collective: float
    dominant: str
    model_flops: float           # global useful flops
    useful_ratio: float          # model_flops / (flops * chips)
    unresolved_loops: int = 0
    note: str = ""

    @property
    def step_time(self) -> float:
        """No-overlap upper bound on step time."""
        return self.t_compute + self.t_memory + self.t_collective

    @property
    def bound_time(self) -> float:
        """Perfect-overlap lower bound (max of terms)."""
        return max(self.t_compute, self.t_memory, self.t_collective)

    model_bytes: float = 0.0     # minimal useful HBM traffic per device
    spec: ChipSpec = H100        # the chip the terms are for

    @property
    def roofline_fraction(self) -> float:
        """Fraction of the dominant roofline achieved: the time the report's
        chip needs for the *useful* work (max of useful-compute and
        useful-memory time) over the no-overlap step time of the counted
        step. 1.0 = every byte/flop moved was necessary and at peak."""
        if self.step_time <= 0:
            return 0.0
        t_useful = max(self.model_flops / self.n_chips
                       / self.spec.peak_flops_bf16,
                       self.model_bytes / self.spec.hbm_bw)
        return min(t_useful / self.step_time, 1.0)

    def to_dict(self) -> dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "n_chips": self.n_chips, "flops": self.flops,
            "hbm_bytes": self.hbm_bytes,
            "hbm_bytes_min": self.hbm_bytes_min,
            "coll_bytes": self.coll_bytes,
            "t_compute": self.t_compute, "t_memory": self.t_memory,
            "t_collective": self.t_collective, "dominant": self.dominant,
            "model_flops": self.model_flops, "useful_ratio": self.useful_ratio,
            "model_bytes": self.model_bytes,
            "roofline_fraction": self.roofline_fraction,
            "step_time_noverlap": self.step_time,
            "bound_time": self.bound_time,
            "unresolved_loops": self.unresolved_loops,
            "note": self.note,
        }


def model_bytes_per_device(cfg: ModelConfig, shape: ShapeConfig,
                           n_chips: int, tp: int = 16) -> float:
    """Minimal useful HBM traffic per device per step (2-byte weights).

    train:   3 weight passes (fwd, bwd, update) + optimizer moments r/w +
             ~12 bytes/token/layer/d of activation traffic
    prefill: 1 weight pass + kv-cache write + ~6 B/tok/layer/d activations
    decode:  weights resident/TP read once + cache read + one slot written
    """
    n_total = cfg.param_count()
    n_active = cfg.active_param_count()
    d, L = cfg.d_model, cfg.num_layers
    if shape.kind == "train":
        w = n_total / n_chips * (3 * 2 + 2 * 8)       # bf16 x3 + m,v fp32 r/w
        act = shape.tokens / n_chips * d * L * 12
        return w + act
    if shape.kind == "prefill":
        w = n_total / n_chips * 2
        act = shape.tokens / n_chips * d * L * 6
        kv = shape.tokens / n_chips * 2 * max(cfg.num_kv_heads, 1) * \
            max(cfg.head_dim, 1) * 2
        return w + act + kv
    # decode
    w = n_active * 2 / tp
    s = shape.seq_len
    if cfg.family == "ssm":
        cache = L * cfg.d_inner * cfg.ssm_state * 4 * shape.global_batch
    elif cfg.use_mla:
        cache = L * s * (cfg.kv_lora_rank + cfg.qk_rope_dim) * 2 \
            * shape.global_batch
    else:
        n_attn = L // cfg.attn_period \
            if (cfg.family == "hybrid" and cfg.attn_period) else L
        cache = n_attn * s * 2 * cfg.num_kv_heads * cfg.head_dim * 2 \
            * shape.global_batch
    return w + cache / n_chips  # cache sharded over all chips (batch x seq)


def model_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    n_active = cfg.active_param_count()
    if shape.kind == "train":
        return 6.0 * n_active * shape.tokens
    if shape.kind == "prefill":
        return 2.0 * n_active * shape.tokens
    # decode: one token per sequence + attention over the cache
    base = 2.0 * n_active * shape.global_batch
    s = shape.seq_len
    attn = 0.0
    if cfg.num_heads:
        n_attn = cfg.num_layers
        if cfg.family == "hybrid" and cfg.attn_period:
            n_attn = cfg.num_layers // cfg.attn_period
        attn = 4.0 * shape.global_batch * s * cfg.num_heads * \
            max(cfg.head_dim, 1) * n_attn
    return base + attn


def build_report(cost: Cost, cfg: ModelConfig, shape: ShapeConfig,
                 mesh_name: str, n_chips: int, spec: ChipSpec = H100,
                 note: str = "", tp: int = 1) -> RooflineReport:
    """The report of ``cost`` on ``n_chips`` of ``spec`` with the weights
    split ``tp`` ways (one card: 1)."""
    t_c = spec.compute_time(cost.flops, cost.tensor_flops)
    # memory term from the lower estimate (every op's operands and results
    # would charge elementwise traffic a fused step does not move)
    t_m = (cost.hbm_bytes_min or cost.hbm_bytes) / spec.hbm_bw
    t_x = cost.collective_total / (spec.ici_links * spec.ici_link_bw)
    terms = {"compute": t_c, "memory": t_m, "collective": t_x}
    dominant = max(terms, key=terms.get)
    mf = model_flops(cfg, shape)
    mb = model_bytes_per_device(cfg, shape, n_chips, tp)
    useful = mf / max(cost.flops * n_chips, 1e-9)
    return RooflineReport(
        arch=cfg.name, shape=shape.name, mesh=mesh_name, n_chips=n_chips,
        flops=cost.flops, hbm_bytes=cost.hbm_bytes,
        hbm_bytes_min=cost.hbm_bytes_min or cost.hbm_bytes,
        coll_bytes=dict(cost.coll_bytes),
        t_compute=t_c, t_memory=t_m, t_collective=t_x, dominant=dominant,
        model_flops=mf, useful_ratio=useful, model_bytes=mb,
        unresolved_loops=cost.unresolved_loops, note=note, spec=spec,
    )

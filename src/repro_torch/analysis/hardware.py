"""Target hardware constants used by the roofline analysis and the
power/performance simulator.  The container is CPU-only; these describe the
TARGET chips.  The primary target stays the TPU v5e of the original repro
(197 TFLOP/s bf16, 819 GB/s HBM, ~50 GB/s/link ICI); ``CHIP_MODELS`` adds
two more generations so the fleet layer can model heterogeneous pods.

Per-instance silicon variability ("Not All GPUs Are Created Equal",
arXiv:2208.11035) is expressed through two multiplicative fields on
``ChipSpec``:

  * ``perf_scale``  — scales the achievable compute/bandwidth at a given
    normalized frequency (process-corner frequency variation);
  * ``power_scale`` — scales the power drawn at a given activity level
    (leakage/efficiency variation).

Both default to exactly 1.0, which is bit-exact with the pre-fleet model
(multiplying by 1.0 is an IEEE identity); ``repro_torch.fleet.DeviceInventory``
draws seeded per-device values around 1.0.

``H100`` is the card the port runs on, for its roofline (``analysis.roofline``)
and the kernels' bounds; it is not in ``CHIP_MODELS``, so the simulated fleet
stays the reference's.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class ChipSpec:
    name: str = "tpu-v5e"
    peak_flops_bf16: float = 197e12          # per chip
    hbm_bw: float = 819e9                    # bytes/s
    hbm_bytes: float = 16 * 2**30
    ici_link_bw: float = 50e9                # bytes/s per link (one direction)
    ici_links: int = 4                       # 2D torus: 4 links per chip
    # power model (OCP OAI-style sustained/excursion structure, DESIGN.md §2)
    tdp_w: float = 200.0
    idle_w: float = 60.0
    max_excursion: float = 2.0               # x TDP, OCP spec ceiling
    # normalized DVFS range (maps the paper's 1300..2100 MHz sweep)
    f_min: float = 0.6
    f_max: float = 1.0
    v_min: float = 0.72                      # V(f_min)/V(f_max)
    # per-instance silicon variability (1.0 = the nominal chip)
    perf_scale: float = 1.0
    power_scale: float = 1.0

    @property
    def f32_rate(self) -> float:
        """FLOP/s of work off the bf16 product units: a TPU's chip model
        gives none, so its bf16 peak."""
        return self.peak_flops_bf16

    def compute_time(self, flops: float, tensor_flops: float) -> float:
        """Seconds for ``flops``, of which ``tensor_flops`` run at the bf16
        peak and the rest at ``f32_rate`` (with ``tensor_flops == flops``
        exactly ``flops / peak_flops_bf16``)."""
        return tensor_flops / self.peak_flops_bf16 \
            + (flops - tensor_flops) / self.f32_rate

    @property
    def machine_balance(self) -> float:
        """FLOP per HBM byte at the ridge point."""
        return self.peak_flops_bf16 / self.hbm_bw

    @property
    def effective_tdp_w(self) -> float:
        """The nameplate TDP rescaled by this instance's power variability:
        the normalization base that makes profiles device-portable (a trace
        divided by it recovers the workload's intrinsic relative curve)."""
        return self.tdp_w * self.power_scale

    def voltage(self, f: float) -> float:
        """Normalized V(f), linear between (f_min, v_min) and (f_max, 1)."""
        f = min(max(f, self.f_min), self.f_max)
        t = (f - self.f_min) / (self.f_max - self.f_min)
        return self.v_min + (1.0 - self.v_min) * t


V5E = ChipSpec()

# A bigger HBM-rich training chip and a newer-generation serving chip.
# Numbers follow the public v5p/v6e (Trillium) datasheet ballpark; power
# curves reuse the same OCP structure with per-model TDP/idle.
V5P = ChipSpec(name="tpu-v5p", peak_flops_bf16=459e12, hbm_bw=2765e9,
               hbm_bytes=95 * 2**30, ici_link_bw=100e9, ici_links=6,
               tdp_w=350.0, idle_w=95.0)
V6E = ChipSpec(name="tpu-v6e", peak_flops_bf16=918e12, hbm_bw=1640e9,
               hbm_bytes=32 * 2**30, ici_link_bw=100e9, ici_links=4,
               tdp_w=300.0, idle_w=80.0)


@dataclass(frozen=True)
class GpuSpec(ChipSpec):
    """A GPU's ``ChipSpec`` with the rates off its tensor cores (FLOP/s of
    float32 and float64, exp/s on the special-function units) and its
    streaming multiprocessors.  A subclass, so that ``ChipSpec``'s fields,
    which the fleet's records carry, stay the reference's."""
    peak_flops_f32: float = 0.0
    peak_flops_f64: float = 0.0
    peak_exp: float = 0.0
    sms: int = 0

    @property
    def f32_rate(self) -> float:
        return self.peak_flops_f32


# One NVIDIA H100 SXM (data sheet, dense rates at the 700 W limit): bf16 on
# the tensor cores, float32 and float64 outside them, 3.35 TB/s of HBM3, 80
# GB, 18 NVLink 4 links of 25 GB/s each way; exp on the special-function
# units: 16 a clock an SM (CUDA guide, compute capability 9.0) x 132 SMs x
# the 1,980 MHz boost clock.  The power-model fields (idle_w, the DVFS
# range, max_excursion) keep the class defaults and are not read for it.
H100 = GpuSpec(name="h100-sxm", peak_flops_bf16=989e12, hbm_bw=3.35e12,
               hbm_bytes=80e9, ici_link_bw=25e9, ici_links=18, tdp_w=700.0,
               peak_flops_f32=67e12, peak_flops_f64=34e12,
               peak_exp=16 * 132 * 1.98e9, sms=132)

# the chip-model registry the fleet inventory draws from
CHIP_MODELS: dict[str, ChipSpec] = {s.name: s for s in (V5E, V5P, V6E)}

# the frequency sweep used for reference profiling (9 points, like the
# paper's 1300->2100 MHz in 100 MHz steps)
FREQ_SWEEP = tuple(round(0.6 + 0.05 * i, 2) for i in range(9))

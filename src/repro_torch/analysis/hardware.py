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

# the chip-model registry the fleet inventory draws from
CHIP_MODELS: dict[str, ChipSpec] = {s.name: s for s in (V5E, V5P, V6E)}

# the frequency sweep used for reference profiling (9 points, like the
# paper's 1300->2100 MHz in 100 MHz steps)
FREQ_SWEEP = tuple(round(0.6 + 0.05 * i, 2) for i in range(9))

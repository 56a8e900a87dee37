"""DVFS-aware analytical power/performance model of a TPU v5e chip.

Physically-grounded structure:
  * kernel duration  t = max(flops / (F_peak * f/f_max * eff), bytes / BW)
  * dynamic power    P = P_idle + A_c * util_c * (f/f_max) * V(f)^2 + A_m * util_m
    with V(f) linear (hardware.ChipSpec); A_c/A_m calibrated so a fully
    compute-bound kernel at f_max sustains ~1.3x TDP and a bandwidth-bound
    kernel ~0.75x TDP (the regimes the paper observes on MI300X).
  * low->high activity transitions overshoot (di/dt inrush): amplitude
    proportional to the power step, clipped at the OCP 2x TDP excursion
    ceiling, decaying over ~1 ms — these are the paper's "power spikes".

The model is fully parameterized by its ``ChipSpec``: per-model constants
(TDP, idle, DVFS range) *and* per-instance variability (``perf_scale``
scales achievable compute/bandwidth, ``power_scale`` scales drawn power).
At the default scales of exactly 1.0 every multiplication is an IEEE
identity, so a nominal chip is bit-exact with the pre-fleet model.
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.analysis.hardware import ChipSpec, V5E
from repro_torch.telemetry.kernel_stream import Kernel

T_LAUNCH = 2e-6          # fixed per-kernel launch overhead (s)
OVERSHOOT_KAPPA = 1.1    # overshoot amplitude vs power step
OVERSHOOT_TAU = 1.0e-3   # overshoot duration (s)
OVERSHOOT_MIN_STEP = 30.0  # W of step needed to trigger an excursion


@dataclass(frozen=True)
class KernelExec:
    duration: float
    util_c: float            # fraction of peak compute at current f
    util_m: float            # fraction of peak HBM bandwidth
    power: float             # steady-state W


class TPUPowerModel:
    def __init__(self, spec: ChipSpec = V5E, mxu_eff: float = 0.85,
                 hbm_eff: float = 0.9):
        self.spec = spec
        self.mxu_eff = mxu_eff
        self.hbm_eff = hbm_eff
        # calibrate A_c, A_m (see module docstring)
        tdp, idle = spec.tdp_w, spec.idle_w
        # compute-bound @ (uc=1.0, um=0.2, f=1): 1.3*TDP
        # memory-bound  @ (uc=0.15, um=0.9):     0.75*TDP
        #   idle + A_c + 0.2 A_m = 1.3 tdp ; idle + 0.15 A_c + 0.9 A_m = 0.75 tdp
        b1 = 1.3 * tdp - idle
        b2 = 0.75 * tdp - idle
        self.A_m = (b2 - 0.15 * b1) / (0.9 - 0.15 * 0.2)
        self.A_c = b1 - 0.2 * self.A_m

    # ------------------------------------------------------------------
    def exec_kernel(self, k: Kernel, f: float) -> KernelExec:
        s = self.spec
        f = min(max(f, s.f_min), s.f_max)
        fc = s.peak_flops_bf16 * (f / s.f_max) * self.mxu_eff * s.perf_scale
        bm = s.hbm_bw * self.hbm_eff * s.perf_scale   # memory clock not SM-capped
        t_c = k.flops / fc if k.flops else 0.0
        t_m = k.bytes / bm if k.bytes else 0.0
        t = max(t_c, t_m, T_LAUNCH)
        util_c = t_c / t
        util_m = t_m / t
        p = self.steady_power(util_c, util_m, f)
        return KernelExec(t, util_c, util_m, p)

    def steady_power(self, util_c: float, util_m: float, f: float) -> float:
        s = self.spec
        v = s.voltage(f)
        return (s.idle_w
                + self.A_c * util_c * (f / s.f_max) * v * v
                + self.A_m * util_m) * s.power_scale

    def overshoot(self, p_prev: float, p_new: float) -> float | None:
        """Excursion amplitude for a low->high transition (None if none).

        The ceiling is deliberately the *nameplate* OCP limit
        (``max_excursion * tdp_w``), not scaled by ``power_scale``: it
        models the platform's power-delivery spec, which doesn't move with
        the silicon lottery.  Consequence: on a far-off-nominal chip,
        effective-TDP normalization recovers the intrinsic relative curve
        exactly for steady power but only approximately for
        ceiling-clipped spikes — the fleet's device-portability tests
        bound the effect."""
        step = p_new - p_prev
        if step < OVERSHOOT_MIN_STEP:
            return None
        amp = p_new + OVERSHOOT_KAPPA * step
        return min(amp, self.spec.max_excursion * self.spec.tdp_w)

    @property
    def idle_w(self) -> float:
        return self.spec.idle_w * self.spec.power_scale

"""JSON codec for full workload profiles.

Quarantine and promotion records must carry complete
:class:`~repro_torch.core.classify.WorkloadProfile` objects through the
session journal — traces and the per-frequency scaling table included — so
a crashed session resumes its discovery state with zero classifier calls.
The record shape is the reference's (``repr(float)`` keys round-trip
float64 frequencies exactly, as do JSON float lists for traces), so either
package reads the other's records byte for byte.
"""
from __future__ import annotations

import torch

from repro_torch.core.classify import FreqPoint, WorkloadProfile
from repro_torch.device import DEFAULT_DEVICE, as_f64, resolve_device


def profile_record(profile: WorkloadProfile) -> dict:
    """Encode a full profile as a JSON-safe dict.  The trace (a device
    tensor) comes to the host in one float64 copy."""
    return {
        "name": profile.name,
        "tdp": float(profile.tdp),
        "power_trace": profile.power_trace.detach().to(torch.float64)
        .cpu().tolist(),
        "sm_util": float(profile.sm_util),
        "dram_util": float(profile.dram_util),
        "exec_time": float(profile.exec_time),
        "domain": profile.domain,
        "scaling": {
            repr(float(f)): {
                "freq": float(pt.freq),
                "p90": float(pt.p90),
                "p95": float(pt.p95),
                "p99": float(pt.p99),
                "mean_power": float(pt.mean_power),
                "exec_time": float(pt.exec_time),
            }
            for f, pt in profile.scaling.items()
        },
    }


def profile_from_record(rec: dict, device=DEFAULT_DEVICE) -> WorkloadProfile:
    """Rebuild a :class:`WorkloadProfile` from :func:`profile_record`, its
    trace a float64 tensor on ``device``."""
    scaling = {
        float(key): FreqPoint(
            freq=float(pt["freq"]),
            p90=float(pt["p90"]),
            p95=float(pt["p95"]),
            p99=float(pt["p99"]),
            mean_power=float(pt["mean_power"]),
            exec_time=float(pt["exec_time"]),
        )
        for key, pt in rec.get("scaling", {}).items()
    }
    return WorkloadProfile(
        name=rec["name"],
        tdp=float(rec["tdp"]),
        power_trace=as_f64(rec["power_trace"], resolve_device(device)),
        sm_util=float(rec["sm_util"]),
        dram_util=float(rec["dram_util"]),
        exec_time=float(rec["exec_time"]),
        scaling=scaling,
        domain=rec.get("domain", ""),
    )

"""Training launcher with Minos frequency-cap selection as a first step.

    PYTHONPATH=src python -m repro_torch.launch.train --arch glm4-9b --smoke \\
        --steps 20 --minos-cap powercentric
    PYTHONPATH=src python -m repro_torch.launch.train --arch glm4-9b --smoke \\
        --device cpu

With ``--minos-cap``, the launcher (1) loads (or builds once, profiling on
``--device``: ``spike_hist`` and ``ema_scan`` run there) the versioned
Minos ``ReferenceLibrary``, (2) opens a ``repro_torch.api.MinosSession``
and submits this job's one low-cost profiling run, capping through the DVFS
actuator as soon as the partial-profile classification is confident, and
only then trains, on ``--device`` (the card by default).  ``--smoke`` trains
the reduced configuration at (``--batch``, ``--seq-len``); without it, a
configuration whose train state (bfloat16 parameters and gradients, AdamW
moments in ``moment_dtype``) exceeds the device's memory is refused before
anything is allocated.  The checkpoint and library directories default to
the system's temporary directory (``TMPDIR``).
"""
from __future__ import annotations

import argparse
import os
import tempfile

from repro_torch.api import (MinosSession, ReferenceLibrary,
                             build_reference_library)
from repro_torch.configs import ARCHS, SHAPES, RunConfig
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.device import resolve_device
from repro_torch.launch.serve import device_memory_bytes
from repro_torch.models.common import DTYPES
from repro_torch.sched import SimActuator
from repro_torch.telemetry import TPUPowerModel
from repro_torch.telemetry.kernel_stream import build_stream
from repro_torch.train import Trainer


def minos_select_cap(arch: str, shape, objective: str, store_dir: str,
                     actuator: SimActuator | None = None,
                     device="cuda") -> float:
    model = TPUPowerModel()

    def build():
        print("[minos] building reference library (one-time)...")
        return build_reference_library(model, target_duration=2.0,
                                       device=device).profiles

    lib = ReferenceLibrary.load_or_build(store_dir, build, device=device)
    # hold this arch out of its own reference set
    lib = lib.subset(lambda r: not r.name.startswith(arch))
    session = MinosSession(lib, objective=objective,
                           actuator=actuator if actuator is not None
                           else "none", device=device)
    job = session.submit(build_stream(ARCHS[arch], shape))
    decision = job.run()               # stops profiling at the early cap
    sel = decision.selection
    how = "early, from partial profile" if decision.early else "full profile"
    print(f"[minos] target={decision.target} bin={sel.bin_size} "
          f"pwr_nn={sel.power_neighbor} (d={sel.power_distance:.3f}) "
          f"perf_nn={sel.util_neighbor} (d={sel.util_distance:.2f}) "
          f"-> cap={decision.cap:.2f} ({objective}; {how} at "
          f"{decision.fraction:.0%} of the trace, "
          f"confidence {decision.confidence:.2f})")
    return decision.cap


def train_state_bytes(cfg: ModelConfig, run_cfg: RunConfig) -> int:
    """Parameters and gradients in the config's dtype plus two AdamW
    moments: 12 bytes a parameter with bfloat16 parameters and float32
    moments."""
    per = 2 * DTYPES[cfg.dtype].itemsize \
        + 2 * DTYPES[run_cfg.moment_dtype].itemsize
    return per * cfg.param_count()


def check_fits(cfg: ModelConfig, run_cfg: RunConfig, device) -> None:
    """Raise ``ValueError`` when the train state alone exceeds the
    device."""
    need, have = train_state_bytes(cfg, run_cfg), device_memory_bytes(device)
    if need > have:
        raise ValueError(
            f"{cfg.name}: {need / 1e9:.1f} GB of train state (parameters, "
            f"gradients, AdamW moments) do not fit in the {have / 1e9:.1f} "
            f"GB of {device}; pass --smoke for the reduced configuration")


def main() -> None:
    tmp = tempfile.gettempdir()
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=sorted(ARCHS))
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config + tiny shape (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tmp, "repro_torch_train_ckpt"))
    ap.add_argument("--minos-cap", choices=["powercentric", "perfcentric"],
                    default=None)
    ap.add_argument("--minos-store",
                    default=os.path.join(tmp, "repro_torch_minos_store"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    device = resolve_device(args.device)
    cfg = ARCHS[args.arch]
    shape = SHAPES[args.shape]
    run_cfg = RunConfig(total_steps=args.steps,
                        warmup_steps=max(args.steps // 10, 1),
                        checkpoint_every=max(args.steps // 2, 1),
                        checkpoint_dir=args.ckpt_dir)
    if args.smoke:
        cfg = cfg.reduced()
        train_shape = ShapeConfig("smoke", args.seq_len, args.batch, "train")
    else:
        check_fits(cfg, run_cfg, device)
        train_shape = shape
    actuator = SimActuator()
    if args.minos_cap:
        minos_select_cap(args.arch, shape, args.minos_cap, args.minos_store,
                         actuator=actuator, device=device)

    trainer = Trainer(cfg, train_shape, run_cfg, device=device)
    res = trainer.run(num_steps=args.steps)
    if res.steps_run:
        print(f"ran {res.steps_run} steps; loss {res.losses[0]:.4f} -> "
              f"{res.losses[-1]:.4f}; cap={actuator.get_cap():.2f}")
    else:
        # a resumed checkpoint at/past --steps leaves nothing to run
        print(f"ran 0 steps (checkpoint already at step {res.final_step}); "
              f"cap={actuator.get_cap():.2f}")


if __name__ == "__main__":
    main()

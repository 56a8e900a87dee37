"""Training launcher with Minos frequency-cap selection as a first step.

    PYTHONPATH=src python -m repro_torch.launch.train --arch glm4-9b --smoke \\
        --steps 20 --minos-cap powercentric
    PYTHONPATH=src python -m repro_torch.launch.train --arch glm4-9b --smoke \\
        --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --arch glm4-9b \\
        --tp 4 --group nccl
    PYTHONPATH=src python -m repro_torch.launch.train --arch glm4-9b --smoke \\
        --tp 2 --group local --device cpu

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

``--tp N`` trains over a (1, N) mesh with the reference's layouts (the
dense and ssm families; ``models.transformer.LM.loss``), every rank on
the same batches; ``--group`` chooses how the ranks run, and is required
with it: ``nccl`` spawns N processes, rank r on card r (the kernels built
once, before the spawn); ``local`` runs N threads of this process on the
CPU (``--device cpu``; threads cannot train on a card: autograd runs a
card's backward on one thread of its own).  ``check_fits`` then counts a
rank's train state, its blocks counted on meta.  With ``--minos-cap`` the
cap is decided once, on rank 0's device, before the ranks train; rank 0
prints the losses and writes the checkpoints.
"""
from __future__ import annotations

import argparse
import os
import tempfile

import torch

from repro_torch.api import (MinosSession, ReferenceLibrary,
                             build_reference_library)
from repro_torch.configs import ARCHS, SHAPES, RunConfig
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import tp_mesh
from repro_torch.launch.serve import device_memory_bytes
from repro_torch.models.common import DTYPES, Topo
from repro_torch.models.model_zoo import build_model
from repro_torch.models.parallel import LocalGroup, run_local, spawn
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


def train_state_bytes(cfg: ModelConfig, run_cfg: RunConfig,
                      tp: int = 1) -> int:
    """Parameters and gradients in the config's dtype plus two AdamW
    moments: 12 bytes a parameter with bfloat16 parameters and float32
    moments; over tp ranks, rank 0's parameter blocks, counted on meta."""
    per = 2 * DTYPES[cfg.dtype].itemsize \
        + 2 * DTYPES[run_cfg.moment_dtype].itemsize
    if tp == 1:
        return per * cfg.param_count()
    model = build_model(cfg, Topo(tp_mesh(tp)), "train", device="meta",
                        group=LocalGroup.make(tp)[0])
    return per * sum(p.numel() for p in model.parameters())


def check_fits(cfg: ModelConfig, run_cfg: RunConfig, device, tp: int = 1,
               ranks_per_device: int = 1) -> None:
    """Raise ``ValueError`` when the train state alone exceeds the
    device: ``ranks_per_device`` ranks of a (1, tp) mesh on it."""
    rank = train_state_bytes(cfg, run_cfg, tp)
    need, have = ranks_per_device * rank, device_memory_bytes(device)
    if need > have:
        per = f" ({rank / 1e9:.1f} GB a rank of {tp})" if tp > 1 else ""
        raise ValueError(
            f"{cfg.name}: {need / 1e9:.1f} GB of train state (parameters, "
            f"gradients, AdamW moments){per} do not fit in the "
            f"{have / 1e9:.1f} GB of {device}; pass --smoke for the reduced "
            f"configuration")


def train_rank(group, cfg: ModelConfig, shape: ShapeConfig,
               run_cfg: RunConfig, steps: int) -> dict:
    """One rank of ``--tp``, on the group's device: its ``Trainer`` over
    the (1, tp) mesh, ``steps`` steps; the result's losses, steps and step
    seconds."""
    trainer = Trainer(cfg, shape, run_cfg, Topo(tp_mesh(group.size)),
                      device=group.device, group=group)
    res = trainer.run(num_steps=steps)
    return {"losses": res.losses, "steps_run": res.steps_run,
            "final_step": res.final_step,
            "restored_from": res.restored_from,
            "step_durations": res.step_durations,
            "device": str(group.device)}


def train_ranks(cfg: ModelConfig, shape: ShapeConfig, run_cfg: RunConfig,
                tp: int, group: str, device: torch.device,
                steps: int) -> list[dict]:
    """``train_rank`` on tp ranks: NCCL processes, one a card, or
    (``local``) threads of this process on the CPU; the results in rank
    order."""
    if group == "nccl":
        if torch.cuda.device_count() < tp:
            raise SystemExit(f"--group nccl needs {tp} cards, this host has "
                             f"{torch.cuda.device_count()}")
        return spawn(train_rank, tp, "nccl", timeout=3600.0,
                     args=(cfg, shape, run_cfg, steps))
    if device.type != "cpu":
        raise SystemExit("--group local trains on the CPU only (--device "
                         "cpu): threads cannot train on a card, whose "
                         "backward runs on one thread of its own")
    return run_local(lambda g: train_rank(g, cfg, shape, run_cfg, steps),
                     tp, [device])


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
    ap.add_argument("--tp", type=int, default=1)
    ap.add_argument("--group", choices=("nccl", "local"))
    args = ap.parse_args()
    if args.tp > 1 and args.group is None:
        raise SystemExit("--tp needs --group nccl (a process a card) or "
                         "--group local (threads of this process, on the "
                         "CPU)")

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
        check_fits(cfg, run_cfg, device, args.tp)
        train_shape = shape
    actuator = SimActuator()
    if args.minos_cap:                 # once, on rank 0's device
        minos_select_cap(args.arch, shape, args.minos_cap, args.minos_store,
                         actuator=actuator, device=device)

    if args.tp > 1:
        res = train_ranks(cfg, train_shape, run_cfg, args.tp, args.group,
                          device, args.steps)[0]
        steps_run, losses, final = (res["steps_run"], res["losses"],
                                    res["final_step"])
    else:
        out = Trainer(cfg, train_shape, run_cfg,
                      device=device).run(num_steps=args.steps)
        steps_run, losses, final = out.steps_run, out.losses, out.final_step
    where = f" tp={args.tp} group={args.group}" if args.tp > 1 else ""
    if steps_run:
        print(f"ran {steps_run} steps; loss {losses[0]:.4f} -> "
              f"{losses[-1]:.4f}; cap={actuator.get_cap():.2f}{where}")
    else:
        # a resumed checkpoint at/past --steps leaves nothing to run
        print(f"ran 0 steps (checkpoint already at step {final}); "
              f"cap={actuator.get_cap():.2f}{where}")


if __name__ == "__main__":
    main()

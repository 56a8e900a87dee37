"""Training loop: checkpoint/restart, preemption, stragglers, telemetry.

The loop is host-driven and step-indexed, as the reference's: the data
pipeline is addressed by step number (no hidden iterator state), so a
crashed or preempted run resumes bit for bit from its last committed
checkpoint.  Checkpoints are in the reference's layout, so a run may resume
from one the reference wrote and the reverse.  Two deliberate differences:
the final checkpoint is not written again when the run just wrote (or
restored) that step, which the reference does (the same files; a train
state of billions of parameters is tens of GB), and a ``checkpoint_dir``
of ``None`` trains without checkpoints (no restore, no save), for a run
whose state is too large to write.

With a ``group`` (a rank of a (1, tp) mesh, ``models.parallel``) each
rank builds its blocks of the model and trains them on the same batches
(data = 1: every rank draws the whole batch of the step); rank 0 calls the
telemetry hook and writes the checkpoints, which every rank gathers
(``train.step.save_state``), and every rank restores its blocks from
one.  A preemption must reach every rank (a signal to the process group
does), or the others wait for the rank that stopped.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable

import torch

from repro_torch.checkpoint import ckpt
from repro_torch.configs.base import ModelConfig, RunConfig, ShapeConfig
from repro_torch.data.synthetic import SyntheticTokens
from repro_torch.device import resolve_device
from repro_torch.ft.heartbeat import PreemptionHandler, StragglerMonitor
from repro_torch.models.common import ONE_DEVICE, Topo
from repro_torch.models.model_zoo import build_model
from repro_torch.train.step import (init_state, load_state, make_train_step,
                                    save_state)


@dataclass
class TrainResult:
    steps_run: int
    final_step: int
    losses: list = field(default_factory=list)
    preempted: bool = False
    restored_from: int | None = None
    step_durations: list = field(default_factory=list)


class Trainer:
    """``dtype`` overrides the parameters' dtype (the configs' bfloat16 by
    default); the model is built on ``device`` (the card by default); with
    a ``group``, that rank's blocks of it under ``topo``."""

    def __init__(self, cfg: ModelConfig, shape: ShapeConfig,
                 run_cfg: RunConfig, topo: Topo = ONE_DEVICE, data=None,
                 telemetry_hook: Callable[[int, float, dict], None]
                 | None = None,
                 preemption: PreemptionHandler | None = None, *,
                 device="cuda", dtype: torch.dtype | None = None,
                 group=None):
        self.cfg, self.shape, self.run_cfg, self.topo = cfg, shape, run_cfg, topo
        self.device = resolve_device(device)
        self.model = build_model(cfg, topo, kind="train", device=self.device,
                                 dtype=dtype, group=group)
        self.group = self.model.group
        self.rank = 0 if self.group is None else self.group.rank
        self.step_fn = make_train_step(self.model, run_cfg, topo)
        self.data = data or SyntheticTokens(cfg, shape, seed=run_cfg.seed)
        self.telemetry_hook = telemetry_hook
        self.preemption = preemption or PreemptionHandler(install=False)
        self.straggler_monitor = StragglerMonitor()

    # ------------------------------------------------------------------
    def init_or_restore(self, generator: torch.Generator
                        ) -> tuple[dict, int, int | None]:
        directory = self.run_cfg.checkpoint_dir
        last = None if directory is None else ckpt.latest_step(directory)
        if last is not None:
            tree, step = ckpt.restore(directory, last, lazy=True)
            return load_state(self.model, tree, self.run_cfg), step, last
        return init_state(self.model, self.run_cfg, generator), 0, None

    def _save(self, state: dict, step: int, collect: bool = False) -> None:
        directory = self.run_cfg.checkpoint_dir
        if directory is not None:
            save_state(state, self.model, directory, step)
            if collect and self.rank == 0:
                ckpt.garbage_collect(directory)

    def run(self, num_steps: int | None = None,
            generator: torch.Generator | None = None) -> TrainResult:
        """Train to ``num_steps`` (default ``run_cfg.total_steps``) from the
        latest checkpoint, or from the seeded init (``generator``, default
        one on the model's device seeded with ``run_cfg.seed``)."""
        if generator is None:
            generator = torch.Generator(device=self.device)
            generator.manual_seed(self.run_cfg.seed)
        state, start_step, restored = self.init_or_restore(generator)
        total = num_steps if num_steps is not None \
            else self.run_cfg.total_steps
        result = TrainResult(steps_run=0, final_step=start_step,
                             restored_from=restored)
        step, saved = start_step, restored
        while step < total:
            batch = {k: torch.as_tensor(v, device=self.device)
                     for k, v in self.data.batch_at(step).items()}
            t0 = time.perf_counter()
            state, metrics = self.step_fn(state, batch)
            loss = float(metrics["loss"])
            dt = time.perf_counter() - t0
            step += 1
            result.steps_run += 1
            result.losses.append(loss)
            result.step_durations.append(dt)
            self.straggler_monitor.record(self.rank, step, dt)
            if self.telemetry_hook and self.rank == 0:
                self.telemetry_hook(step, dt, {k: float(v)
                                               for k, v in metrics.items()})
            if self.preemption.preempted:
                self._save(state, step)
                result.preempted = True
                break
            if step % self.run_cfg.checkpoint_every == 0:
                self._save(state, step, collect=True)
                saved = step
        else:
            if saved != step:
                self._save(state, step)
        result.final_step = step
        self._state = state
        return result

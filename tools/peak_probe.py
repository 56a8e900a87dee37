"""Where the dry run's peak and the card's part, op by op.

    python3 tools/peak_probe.py [--arch glm4-9b] [--layers 8] [--kind train]
                                [--batch 4] [--tokens 1024] [--top 12]

Runs one cell of ``repro_torch.launch.dryrun`` (the arch cut to
``--layers``) on the card three times, each on fresh tensors: its first
run in the process, once more, and once more under ``FlopCounterMode`` (as
``chip_smoke.py``'s phase 21 does), each under a ``CostCounter`` that
also records, after every op it counts and every kernel call, its own
live bytes and the caching allocator's (``torch.cuda.memory_allocated``
above what was allocated before the cell).  Prints the card's and the
counter's peaks, the op at which the card's was reached, and the ops after
which the allocator held the most beyond the counter.  Needs one CUDA
card.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

import torch  # noqa: E402
from torch.utils.flop_counter import FlopCounterMode  # noqa: E402

from repro_torch.analysis.cost import CostCounter  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402


class Probe(CostCounter):
    """A ``CostCounter`` that logs (what, counter live + temporaries, the
    allocator's live, the allocator's peak so far) after each op."""

    def __init__(self, before: int) -> None:
        super().__init__()
        self.before = before
        self.log: list[tuple[str, int, int, int]] = []

    def _note(self, what: str) -> None:
        self.log.append((what, self.live_bytes,
                         torch.cuda.memory_allocated() - self.before,
                         torch.cuda.max_memory_allocated() - self.before))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = super().__torch_dispatch__(func, types, args, kwargs)
        if not self._quiet:
            self._note(str(func))
        return out

    @contextlib.contextmanager
    def kernel_call(self, name, work):
        with super().kernel_call(name, work):
            yield
        self._note(f"kernel {name}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="glm4-9b")
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--kind", default="train",
                    choices=["train", "prefill", "decode"])
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--tokens", type=int, default=1024)
    ap.add_argument("--top", type=int, default=12)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("peak_probe: no CUDA device available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(ARCHS[args.arch], num_layers=args.layers)
    shape = ShapeConfig(f"{args.kind}_{args.batch}x{args.tokens}",
                        args.tokens, args.batch, args.kind)
    meta = dryrun.run_cell(args.arch, shape.name, cfg=cfg, shape=shape)
    dev = torch.device("cuda", 0)
    gib = 2**30
    print(f"{args.arch} {args.layers} layers {args.kind} {args.batch} x "
          f"{args.tokens} [{torch.cuda.get_device_name(0)}]: meta peak "
          f"{meta['memory']['peak_bytes'] / gib:.3f} GiB")
    # the cell's first run in the process, a second, and a third under
    # FlopCounterMode (as chip_smoke's phase 21 runs it)
    for run in ("first", "again", "under FlopCounterMode"):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        cell = dryrun.make_cell(cfg, shape, dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        probe = Probe(before)
        probe.track(cell.args)
        outer = FlopCounterMode(display=False) if run.startswith("under") \
            else contextlib.nullcontext()
        with outer:
            with probe:
                cell.run()
            torch.cuda.synchronize()
        card = torch.cuda.max_memory_allocated() - before
        del cell
        print(f"{run}: card peak {card / gib:.3f} GiB above what was "
              f"allocated before the cell, counter {probe.peak_bytes / gib:.3f}"
              f" GiB, {len(probe.log)} ops and kernel calls")
        at_card = next(i for i, e in enumerate(probe.log) if e[3] >= card)
        what, live, alloc, peak = probe.log[at_card]
        print(f"  the card's peak first reached after op {at_card} {what}: "
              f"counter {live / gib:.3f}, allocator {alloc / gib:.3f} GiB")
        gaps = sorted(range(len(probe.log)),
                      key=lambda i: probe.log[i][2] - probe.log[i][1],
                      reverse=True)[:args.top]
        print(f"  the {args.top} ops after which the allocator held the most"
              f" beyond the counter:")
        for i in sorted(gaps):
            what, live, alloc, _ = probe.log[i]
            prev = probe.log[i - 1][0] if i else ""
            print(f"    op {i} {what} (after {prev}): "
                  f"{(alloc - live) / 2**20:.1f} MiB")
    return 0


if __name__ == "__main__":
    sys.exit(main())

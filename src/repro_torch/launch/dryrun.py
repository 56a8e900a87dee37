"""Dry run of every (arch x shape) cell on one card, on meta tensors.

The counterpart of the reference's ``repro.launch.dryrun``, which lowers
and compiles each cell for a TPU pod and parses its HLO.  Here each cell's
model is built on ``device="meta"`` (shapes and dtypes, no data, no
launch) and one step runs under ``analysis.cost.CostCounter``: a train
cell ``train.step.make_train_step``'s step, a prefill cell
``model.prefill``, a decode cell ``model.decode_step`` over caches of
``cache_shape_structs``.  For each cell it records:

  * ``memory`` — what the step needs on the card: args (parameters,
    optimizer state, inputs, caches) and temp (the peak of live bytes
    beyond them, the kernels' workspace included), and whether args + temp
    fit in one H100's 80 GB (``fits``);
  * ``cost`` — the counted flops (``tensor_flops`` of them on the tensor
    cores), HBM bytes and transcendentals, and ``calls`` by kernel;
  * ``roofline`` — the three-term report (``analysis.roofline``) at
    ``H100``, tp = 1.

Usage:
  python -m repro_torch.launch.dryrun --list
  python -m repro_torch.launch.dryrun --one ARCH SHAPE card   # one cell
  python -m repro_torch.launch.dryrun [--arch A] [--shape S] [--force]
Cells run in this process (meta allocates nothing); each record is written
to ``<out>/card/<arch>__<shape>.json`` as it completes (default ``--out``:
``results/dryrun_torch``), and cells with a record are skipped unless
``--force``.  ``count_cell`` runs the same step on any device, so the meta
count can be held against the card's.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback

import torch

from repro_torch.analysis.cost import CostCounter
from repro_torch.analysis.hardware import H100
from repro_torch.analysis.roofline import build_report
from repro_torch.configs import ARCHS, ALL_SHAPES, SHAPES, shape_applicable
from repro_torch.configs.base import ModelConfig, RunConfig, ShapeConfig
from repro_torch.launch.mesh import MESHES
from repro_torch.models.model_zoo import build_model, input_specs, make_batch
from repro_torch.train.step import make_state, make_train_step

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))
RESULTS = os.path.join(REPO, "results", "dryrun_torch")


def _cell_microbatches(arch: str, shape_name: str) -> int:
    """Gradient-accumulation depth for the big train cells (memory)."""
    if shape_name != "train_4k":
        return 1
    big = {"jamba-1.5-large-398b": 8, "deepseek-v2-236b": 4,
           "command-r-35b": 2}
    return big.get(arch, 1)


def _storages(tree) -> dict[int, int]:
    """The distinct storages of the tensors in ``tree``: id -> bytes."""
    return {id(t.untyped_storage()): t.untyped_storage().nbytes()
            for t in torch.utils._pytree.tree_leaves(tree)
            if isinstance(t, torch.Tensor)}


@dataclasses.dataclass
class Cell:
    """One cell's step, ready to run on its device: ``run()`` does one
    step (a train step updates ``args``' parameters and moments in place,
    a decode step its caches); ``args`` are the tensors the step keeps
    (parameters, optimizer state, inputs, caches)."""
    cfg: ModelConfig
    shape: ShapeConfig
    microbatches: int
    run: object
    args: dict
    params_bytes: int


def make_cell(cfg: ModelConfig, shape: ShapeConfig, device="meta",
              microbatches: int = 1, seed: int = 0) -> Cell:
    """The model of ``cfg`` for ``shape``'s kind on ``device`` with its
    step's inputs.  Off meta the parameters take the port's seeded init and
    the inputs ``make_batch``'s draws (a decode cell: zero caches)."""
    dev = torch.device(device)
    kind = shape.kind
    model = build_model(cfg, kind=kind, device=dev)
    gen = None if dev.type == "meta" else \
        torch.Generator(device=dev).manual_seed(seed)
    if gen is not None:
        model.init_params(gen)
    params = dict(model.named_parameters())
    params_bytes = sum(_storages(params).values())
    b, s = shape.global_batch, shape.seq_len
    if gen is None:
        batch = {n: torch.empty(dims, dtype=dt, device=dev)
                 for n, (dims, dt) in input_specs(cfg, shape).items()}
    else:
        batch = make_batch(cfg, shape, gen)
    if kind == "train":
        run_cfg = RunConfig(microbatches=microbatches, moment_dtype=(
            "bfloat16" if cfg.param_count() > 50e9 else "float32"))
        state = make_state(params, run_cfg)
        step = make_train_step(model, run_cfg)
        args = {"state": state, "batch": batch}
        return Cell(cfg, shape, microbatches,
                    lambda: step(state, batch), args, params_bytes)
    if kind == "prefill":
        return Cell(cfg, shape, microbatches,
                    lambda: model.prefill(batch),
                    {"params": params, "batch": batch}, params_bytes)
    caches = {name: {key: torch.zeros(dims, dtype=dt, device=dev)
                     for key, (dims, dt) in entry.items()}
              for name, entry in model.cache_shape_structs(b, s).items()}
    return Cell(cfg, shape, microbatches,
                lambda: model.decode_step(caches, batch["tokens"], s - 1),
                {"params": params, "caches": caches, "batch": batch},
                params_bytes)


def count_cell(cell: Cell) -> tuple[CostCounter, object]:
    """One step of ``cell`` under a ``CostCounter`` that tracks its args
    from the start: (the counter, the step's outputs)."""
    counter = CostCounter()
    counter.track(cell.args)
    with counter:
        out = cell.run()
    return counter, out


def run_cell(arch: str, shape_name: str, mesh_name: str = "card",
             microbatches: int | None = None,
             ssm_impl: str | None = None,
             period: int | None = None, *, cfg: ModelConfig | None = None,
             shape: ShapeConfig | None = None) -> dict:
    """The record of one cell, counted on meta.  ``cfg`` and ``shape``, when
    given, replace the registry's (a cut depth, a smaller batch)."""
    cfg = cfg if cfg is not None else ARCHS[arch]
    shape = shape if shape is not None else SHAPES[shape_name]
    if ssm_impl:
        cfg = dataclasses.replace(cfg, ssm_scan_impl=ssm_impl)
    if period:
        cfg = dataclasses.replace(cfg, layers_per_period=period)
    ok, reason = shape_applicable(cfg.family, shape)
    if not ok:
        return {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                "status": "SKIP", "reason": reason}
    mesh = MESHES[mesh_name]
    n_chips, tp = mesh.num_devices, mesh.model_axis_size
    mb = microbatches if microbatches is not None else \
        _cell_microbatches(arch, shape_name)

    t0 = time.time()
    cell = make_cell(cfg, shape, "meta", mb)
    t_build = time.time() - t0
    t0 = time.time()
    counter, out = count_cell(cell)
    t_count = time.time() - t0

    kept, outputs = _storages(cell.args), _storages(out)
    args = sum(kept.values())
    alias = sum(n for k, n in outputs.items() if k in kept)
    temp = counter.peak_bytes - args
    report = build_report(counter.cost, cfg, shape, mesh_name, n_chips,
                          H100, tp=tp)
    rec = {
        "arch": arch, "shape": shape_name, "mesh": mesh_name,
        "status": "OK", "kind": shape.kind, "microbatches": mb,
        "n_chips": n_chips, "num_layers": cfg.num_layers,
        "batch": shape.global_batch, "seq_len": shape.seq_len,
        "memory": {
            "args_bytes": args,
            "output_bytes": sum(outputs.values()) - alias,
            "temp_bytes": temp,
            "alias_bytes": alias,
            "params_bytes": cell.params_bytes,
            "peak_bytes": counter.peak_bytes,
        },
        "fits": args + temp <= H100.hbm_bytes,
        "cost": dataclasses.asdict(counter.cost),
        "matmul_flops": counter.matmul_flops,
        "calls": dict(sorted(counter.calls.items())),
        "roofline": report.to_dict(),
        "timings": {"build_s": t_build, "count_s": t_count},
    }
    print(f"memory: args={args / 2**30:.2f}GiB temp={temp / 2**30:.2f}GiB "
          f"fits={rec['fits']}")
    print(f"roofline: t_comp={report.t_compute * 1e3:.1f}ms "
          f"t_mem={report.t_memory * 1e3:.1f}ms "
          f"dominant={report.dominant} "
          f"useful_ratio={report.useful_ratio:.3f} "
          f"roofline_frac={report.roofline_fraction:.3f}")
    return rec


def all_cell_ids(mesh_sel: str = "card") -> list[tuple[str, str, str]]:
    meshes = {"card": ["card"]}[mesh_sel]
    return [(a, s.name, m) for m in meshes for a in ARCHS for s in ALL_SHAPES]


def _write(out_dir: str, rec: dict) -> str:
    path = os.path.join(out_dir, rec["mesh"],
                        f"{rec['arch']}__{rec['shape']}.json")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    return path


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--one", nargs=3, metavar=("ARCH", "SHAPE", "MESH"))
    ap.add_argument("--mesh", default="card", choices=sorted(MESHES))
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--microbatches", type=int, default=None)
    ap.add_argument("--ssm-impl", default=None,
                    choices=["sequential", "associative"])
    ap.add_argument("--period", type=int, default=None)
    ap.add_argument("--list", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--out", default=RESULTS)
    args = ap.parse_args()

    if args.one:
        arch, shape, mesh = args.one
        rec = run_cell(arch, shape, mesh, args.microbatches, args.ssm_impl,
                       args.period)
        print("WROTE", _write(args.out, rec), rec["status"])
        return

    cells = all_cell_ids(args.mesh)
    if args.arch:
        cells = [c for c in cells if c[0] == args.arch]
    if args.shape:
        cells = [c for c in cells if c[1] == args.shape]
    if args.list:
        for c in cells:
            print(*c)
        return

    t0 = time.time()
    for arch, shape, mesh in cells:
        path = os.path.join(args.out, mesh, f"{arch}__{shape}.json")
        if os.path.exists(path) and not args.force:
            print(f"skip (done): {arch} {shape} {mesh}")
            continue
        print(f"=== {arch} {shape} {mesh} ===", flush=True)
        try:
            rec = run_cell(arch, shape, mesh, args.microbatches,
                           args.ssm_impl, args.period)
        except Exception:                # a failed cell is recorded, not fatal
            rec = {"arch": arch, "shape": shape, "mesh": mesh,
                   "status": "FAIL", "error": traceback.format_exc()[-4000:]}
            print("FAILED\n" + rec["error"][-1500:])
        _write(args.out, rec)
        print(rec["status"], flush=True)
    print(f"grid: {len(cells)} cells in {time.time() - t0:.1f} s")


if __name__ == "__main__":
    main()

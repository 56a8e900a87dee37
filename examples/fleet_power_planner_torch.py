"""Fleet what-if on the PyTorch port: admit a job mix onto a heterogeneous,
variability-aware pod under a shared power budget (the paper's POLCA-style
oversubscription use case, §4.3 — now cluster-wide), all through
``repro_torch``'s declarative ``MinosSession`` facade, on the card or on
the CPU.

    PYTHONPATH=src python examples/fleet_power_planner_torch.py   # card
    PYTHONPATH=src python examples/fleet_power_planner_torch.py \
        --device cpu --store /tmp/reference_store

It prints what ``examples/fleet_power_planner.py`` prints for the reference
package.  The 28-workload reference library is loaded from ``--store``, or
built there first (``build_reference_library`` on ``--device``) when the
directory holds none; a store the reference package wrote loads as well.

``MinosSession.from_config`` builds the whole session from one dict — the
persisted reference store (warm classifier), a seeded ``DeviceInventory``
(two chip generations, per-device silicon variability), and the policy
names.  Every job's single uncapped profiling run is then one ``submit``;
``session.run()`` multiplexes the telemetry, caps each job early on its own
device, and re-packs the pod (heterogeneity-aware first-fit-decreasing) the
moment any cap lands.  The single shipped reference library — built on the
nominal v5e — serves every device through effective-TDP normalization.
"""
import argparse
import os
import tempfile
import time

from repro_torch.api import (MinosSession, ReferenceLibrary, TPUPowerModel,
                             build_reference_library, holdout_streams,
                             reference_streams)

DEFAULT_STORE = os.path.join(tempfile.gettempdir(),
                             "minos_reference_store_torch")


def reference_library(store: str, device: str) -> ReferenceLibrary:
    """The 28-workload library at ``store``, built and saved there first
    when the directory holds none (as the reference's benchmarks cache it
    under ``results/reference_store``)."""
    if os.path.exists(os.path.join(store, "profiles.json")):
        lib = ReferenceLibrary.load(store, device=device)
        # a store without provenance was built on the nominal v5e model
        if not lib.built_on:
            lib.built_on = TPUPowerModel().spec.name
        return lib
    t0 = time.time()
    lib = build_reference_library(TPUPowerModel(), target_duration=3.0,
                                  device=device)
    lib.save(store)
    print(f"# built reference library: {len(lib)} profiles "
          f"in {time.time() - t0:.1f}s")
    return lib


def main(device: str = "cuda", store: str = DEFAULT_STORE) -> None:
    lib = reference_library(store, device)   # ensures the store exists
    session = MinosSession.from_config({
        "library": store,
        "devices": {"tpu-v5e": 4, "tpu-v5p": 2},
        "variability": {},         # published default sigmas
        "seed": 3,
        "objective": "powercentric",
        "actuator": "sim",
        "quantile": "p99",
        "gates": {"min_confidence": 0.2},
    }, device=device)
    inventory = session.inventory
    print(f"fleet: {len(inventory)} devices "
          f"({', '.join(inventory.models)}; built_on={lib.built_on!r})")
    for d in inventory:
        print(f"  {d.device_id:14s} perf x{d.spec.perf_scale:.3f} "
              f"power x{d.spec.power_scale:.3f} "
              f"eff-TDP {d.effective_tdp_w:5.1f} W")

    # a queue of jobs, round-robined onto devices
    queue = [
        ("command-r-35b:train_4k", 256),
        ("deepseek-v2-236b:decode_32k", 256),
        ("vector-search", 64),
        ("granite-moe-3b-a800m:decode_32k", 64),
        ("lsms-like", 32),
    ]
    nameplate = sum(chips * inventory[i % len(inventory)].nameplate_w
                    for i, (_, chips) in enumerate(queue))
    budget = 0.75 * nameplate      # an oversubscribed pod
    session.set_budget(budget)
    print(f"\npod: {sum(c for _, c in queue)} chips, nameplate "
          f"{nameplate / 1e3:.0f} kW, budget {budget / 1e3:.0f} kW "
          f"(75% oversubscription)")

    streams = {s.name: s for s in reference_streams() + holdout_streams()}
    for i, (name, chips) in enumerate(queue):
        session.submit(streams[name], device=inventory[i % len(inventory)],
                       chips=chips, seed=i)

    report = session.run()
    print(f"\nmultiplexed run: {report.early_decisions}/{len(queue)} jobs "
          f"capped early, {report.repacks} re-packs, "
          f"{report.chunks_dropped} telemetry chunks saved")
    for job_id, d in report.decisions.items():
        when = f"{d.fraction:4.0%} of trace" if d.early else "full trace"
        print(f"  {job_id:48s} cap=f{d.cap:.2f} ({when})")

    res = report.schedule
    print(f"\nfinal packing: {len(res.placed)} jobs placed, "
          f"{len(res.deferred)} deferred:")
    for j in res.placed:
        print(f"  {j.name:36s} chips={j.chips:4d} cap=f{j.cap:.2f} "
              f"{report.quantile}={j.predicted_p90_w:5.0f} W/chip "
              f"on {j.device_id} (neighbor: {j.selection.power_neighbor})")
    for name in res.deferred:
        print(f"  deferred: {name}")
    print(f"\nplanned power: {res.planned_power_w / 1e3:.0f} kW "
          f"({res.planned_power_w / budget:.0%} of budget); headroom "
          f"reclaimed vs TDP provisioning: "
          f"{res.headroom_reclaimed_w / 1e3:+.1f} kW")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="where the session runs: cuda (default) or cpu")
    ap.add_argument("--store", default=DEFAULT_STORE,
                    help="reference-library directory, built there when "
                         f"empty (default: {DEFAULT_STORE})")
    args = ap.parse_args()
    main(args.device, args.store)

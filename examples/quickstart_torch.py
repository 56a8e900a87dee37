"""Quickstart on the PyTorch port: classify a never-before-seen workload and
pick its frequency cap through ``repro_torch``'s ``MinosSession`` facade —
end to end in seconds, on the card or on the CPU.

    PYTHONPATH=src python examples/quickstart_torch.py                # card
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu

It prints what ``examples/quickstart.py`` prints for the reference package.

The facade, in order:
  1. ``stream_profile_workload``  -> a small versioned ``ReferenceLibrary``
  2. ``MinosSession.submit``  -> the new workload's one low-cost profiling
     run, streamed chunk by chunk on the session's device
  3. ``JobHandle.run``  -> Algorithm 1 on the *partial* profile, the cap
     issued (and actuated) as soon as the distance-margin confidence clears
"""
import argparse

from repro_torch.api import (DeviceInventory, MinosSession, ReferenceLibrary,
                             TPUPowerModel, VariabilityModel, micro_gemm,
                             micro_idle_burst, micro_spmv_compute,
                             micro_spmv_memory, micro_stencil,
                             micro_vector_search, profiling_savings,
                             select_optimal_freq, stream_profile_workload)


def main(device: str = "cuda") -> None:
    model = TPUPowerModel()
    tdp = model.spec.tdp_w
    freqs = (0.6, 0.7, 0.8, 0.9, 1.0)

    # 1. reference library: a few workloads profiled across the freq sweep,
    #    streamed through the incremental ProfileBuilder
    print("building a small reference library (5 workloads x 5 freqs)...")
    lib = ReferenceLibrary(
        (stream_profile_workload(s, model, freqs, tdp, seed=i,
                                 target_duration=1.0, device=device)
         for i, s in enumerate([micro_gemm(), micro_spmv_memory(),
                                micro_spmv_compute(), micro_idle_burst(),
                                micro_stencil()])), device=device)
    print(f"  library v{lib.version}: {', '.join(lib.names)}")

    # 2. a NEW workload arrives: one session owns the library, the device,
    #    and the policies; submit attaches the job's single low-cost
    #    profiling run and run() pumps it to the first confident decision
    session = MinosSession(lib, objective="powercentric", actuator="sim",
                           min_confidence=0.2, device=device)
    job = session.submit(micro_vector_search(), seed=99)
    decision = job.run()           # profiling stops at the early cap
    target = job.snapshot() if decision.early else job.profile()
    print(f"\nnew workload: {job.meta.name} (on {job.device.device_id})")
    print(f"  p90 power     : {target.p_quantile(90):.2f} x TDP")
    print(f"  mxu/hbm util  : {target.sm_util:.2f} / {target.dram_util:.2f}")

    # 3. the online Algorithm 1 decision
    sel = decision.selection
    when = (f"after {decision.fraction:.0%} of the trace"
            if decision.early else "at stream end")
    print(f"\nonline cap decision ({when}, "
          f"confidence {decision.confidence:.2f}):")
    print(f"  bin size        : {sel.bin_size}")
    print(f"  power neighbor  : {sel.power_neighbor} "
          f"(cosine d={sel.power_distance:.3f})")
    print(f"  perf neighbor   : {sel.util_neighbor} "
          f"(euclid d={sel.util_distance:.3f})")
    print(f"  PowerCentric cap: f={sel.f_pwr:.2f}  (p90 spikes < 1.3 x TDP)")
    print(f"  PerfCentric cap : f={sel.f_perf:.2f} (perf loss < 5%)")
    print(f"  actuator now at : f={job.actuator.get_cap():.2f}")

    # 4. validate against ground truth the classifier never saw
    truth = stream_profile_workload(micro_vector_search(), model, freqs, tdp,
                                    seed=99, device=device)
    obs = truth.scaling[sel.f_pwr].p90
    print(f"\nvalidation (simulator ground truth):")
    print(f"  observed p90 at cap {sel.f_pwr:.2f}: {obs:.2f} x TDP "
          f"({'within' if obs <= 1.3 else 'EXCEEDS'} the 1.3 bound)")
    print(f"  profiling time saved vs full sweep: "
          f"{profiling_savings(truth, list(freqs)):.0%}")

    # 5. device portability: the SAME session library serves a chip that
    #    lost the silicon lottery — submit on that device and the builder
    #    normalizes by its *effective* TDP automatically
    device = DeviceInventory.generate(
        1, VariabilityModel(sigma_power=0.10), seed=13)[0]
    job_d = session.submit(micro_vector_search(), device=device, seed=99,
                           job_id="vector-search@lottery-loser",
                           profile_to_completion=True)
    job_d.run(stop_early=False)        # full trace, for apples-to-apples
    sel_dev = select_optimal_freq(job_d.profile(), session.classifier)
    # the nominal baseline is the FULL-trace selection (truth, from step 4)
    sel_full = select_optimal_freq(truth, session.classifier)
    print(f"\ndevice portability ({device.device_id}, power "
          f"x{device.spec.power_scale:.3f}, eff-TDP "
          f"{device.spec.effective_tdp_w:.1f} W):")
    print(f"  power neighbor  : {sel_dev.power_neighbor} (same as nominal "
          f"full-trace: {sel_dev.power_neighbor == sel_full.power_neighbor})")
    print(f"  PowerCentric cap: f={sel_dev.f_pwr:.2f} "
          f"(nominal chose f={sel_full.f_pwr:.2f})")

    # 6. the whole session, as one JSON-able report
    report = session.run()
    print(f"\nsession report: {len(report.decisions)} decisions "
          f"({report.early_decisions} early), {report.repacks} re-packs, "
          f"{len(report.to_json())} bytes as JSON")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="where the session runs: cuda (default) or cpu")
    main(ap.parse_args().device)

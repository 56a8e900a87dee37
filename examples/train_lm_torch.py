"""End to end on the PyTorch port: train a ~100M-parameter
GLM-family model for a few hundred steps with the full stack — synthetic
byte corpus, AdamW, checkpointing, straggler monitor, and Minos telemetry
classification of the run itself — on the card (its flash-attention and
RMSNorm kernels, forward and backward) or on the CPU.

    PYTHONPATH=src python examples/train_lm_torch.py --steps 300
    PYTHONPATH=src python examples/train_lm_torch.py --steps 2 --device cpu

It prints the lines ``examples/train_lm.py`` prints for the reference
package.  The losses start from the port's seeded init, not the
reference's; the Minos line comes from the simulator and equals the
reference's.
"""
import argparse
import tempfile

from repro_torch.configs import ARCHS
from repro_torch.configs.base import RunConfig, ShapeConfig
from repro_torch.core import MinosClassifier, select_optimal_freq
from repro_torch.data import ByteCorpus
from repro_torch.pipeline import stream_profile_once, stream_profile_workload
from repro_torch.telemetry import TPUPowerModel
from repro_torch.telemetry.kernel_stream import build_stream, micro_gemm, \
    micro_spmv_memory, micro_idle_burst
from repro_torch.train import Trainer


def hundred_m_config():
    """~100M params in the glm4 family (exact: printed at startup)."""
    return ARCHS["glm4-9b"].reduced(
        num_layers=10, d_model=640, num_heads=10, num_kv_heads=2,
        head_dim=64, d_ff=2560, vocab_size=32768)


def classify_job(cfg, shape, device="cuda"):
    """Minos on the training job of ``cfg`` at ``shape`` (its kernel-stream
    signature): three micro-stream references profiled at 0.6 / 0.8 / 1.0,
    one profiling run of the job, Algorithm 1; prints the result and
    returns the selection.  The profiles are built on ``device``."""
    model = TPUPowerModel()
    refs = [stream_profile_workload(s, model, (0.6, 0.8, 1.0),
                                    model.spec.tdp_w, seed=i,
                                    target_duration=1.0, device=device)
            for i, s in enumerate([micro_gemm(), micro_spmv_memory(),
                                   micro_idle_burst()])]
    clf = MinosClassifier(refs)
    job_profile = stream_profile_once(build_stream(cfg, shape, n_chips=1),
                                      model, model.spec.tdp_w, device=device)
    sel = select_optimal_freq(job_profile, clf)
    print(f"\nMinos classification of this job: power-neighbor="
          f"{sel.power_neighbor}, PowerCentric cap f={sel.f_pwr:.2f}")
    return sel


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--device", default="cuda",
                    help="where the model trains and the profiles are "
                         "built: cuda (default) or cpu")
    args = ap.parse_args()

    cfg = hundred_m_config()
    print(f"model: {cfg.param_count()/1e6:.1f}M params "
          f"({cfg.num_layers}L d={cfg.d_model} ff={cfg.d_ff})")
    shape = ShapeConfig("train_demo", args.seq_len, args.batch, "train")
    run = RunConfig(total_steps=args.steps, warmup_steps=20,
                    learning_rate=3e-3, checkpoint_every=100,
                    checkpoint_dir=tempfile.mkdtemp(prefix="repro_100m_"))

    telemetry_log = []
    trainer = Trainer(cfg, shape, run, data=ByteCorpus(cfg, shape),
                      telemetry_hook=lambda s, dt, m:
                      telemetry_log.append((s, dt, m)),
                      device=args.device)
    res = trainer.run()
    n = len(res.losses)
    for i in range(0, n, max(n // 10, 1)):
        print(f"  step {i+1:4d}  loss {res.losses[i]:.4f}  "
              f"({res.step_durations[i]*1e3:.0f} ms/step)")
    print(f"  final loss {res.losses[-1]:.4f} (start {res.losses[0]:.4f})")

    # classify THIS training job with Minos (via its kernel-stream signature)
    classify_job(cfg, shape, args.device)


if __name__ == "__main__":
    main()

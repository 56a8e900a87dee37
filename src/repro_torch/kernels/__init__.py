"""Hand-written CUDA kernels of the port (``csrc/``), each with its plain
PyTorch twin and a launch counter (``build.LAUNCHES``)."""
from repro_torch.kernels.ema_scan import (ema_filter_block, ema_scan_blocks,
                                          ema_scan_blocks_plain,
                                          ema_scan_plain, ema_scan_rows)
from repro_torch.kernels.flash_attention import (attn_work,
                                                 flash_attention_bshd,
                                                 flash_attention_plain)
from repro_torch.kernels.ops import (ema_scan, flash_attention, rmsnorm,
                                     spike_hist, ssm_scan)
from repro_torch.kernels.rmsnorm import rmsnorm_plain, rmsnorm_rows
from repro_torch.kernels.spike_hist import (spike_hist_batch,
                                            spike_hist_batch_plain)
from repro_torch.kernels.ssm_scan import (scan_work, ssm_scan_bsd,
                                          ssm_scan_plain)

__all__ = ["attn_work", "ema_filter_block", "ema_scan", "ema_scan_blocks",
           "ema_scan_blocks_plain", "ema_scan_plain", "ema_scan_rows",
           "flash_attention", "flash_attention_bshd", "flash_attention_plain",
           "rmsnorm", "rmsnorm_plain", "rmsnorm_rows", "scan_work",
           "spike_hist", "spike_hist_batch", "spike_hist_batch_plain",
           "ssm_scan", "ssm_scan_bsd", "ssm_scan_plain"]

"""Hand-written CUDA kernels of the port (``csrc/``), each with its plain
PyTorch twin, a launch counter (``build.LAUNCHES``) and a work function
(the bytes and operations of one call, which its bound and the cost
counter read)."""
from repro_torch.kernels.ema_scan import (ema_blocks_work, ema_filter_block,
                                          ema_rows_work, ema_scan_blocks,
                                          ema_scan_blocks_plain,
                                          ema_scan_plain, ema_scan_rows)
from repro_torch.kernels.flash_attention import (FlashAttentionFn,
                                                 attn_bwd_work, attn_work,
                                                 flash_attention_bshd,
                                                 flash_attention_bwd,
                                                 flash_attention_bwd_plain,
                                                 flash_attention_plain)
from repro_torch.kernels.ops import (ema_scan, flash_attention, rmsnorm,
                                     spike_hist, ssm_scan)
from repro_torch.kernels.rmsnorm import (RMSNormFn, norm_bwd_work,
                                         norm_work, rmsnorm_bwd,
                                         rmsnorm_bwd_plain, rmsnorm_plain,
                                         rmsnorm_rows)
from repro_torch.kernels.spike_hist import (hist_work, spike_hist_batch,
                                            spike_hist_batch_plain)
from repro_torch.kernels.ssm_scan import (SSMScanFn, scan_bwd_work,
                                          scan_work, ssm_scan_bsd,
                                          ssm_scan_bwd, ssm_scan_bwd_plain,
                                          ssm_scan_plain)

__all__ = ["FlashAttentionFn", "RMSNormFn", "SSMScanFn", "attn_bwd_work",
           "attn_work", "ema_blocks_work", "ema_filter_block",
           "ema_rows_work", "hist_work", "norm_bwd_work", "norm_work",
           "ema_scan", "ema_scan_blocks", "ema_scan_blocks_plain",
           "ema_scan_plain", "ema_scan_rows", "flash_attention",
           "flash_attention_bshd", "flash_attention_bwd",
           "flash_attention_bwd_plain", "flash_attention_plain", "rmsnorm",
           "rmsnorm_bwd", "rmsnorm_bwd_plain", "rmsnorm_plain",
           "rmsnorm_rows", "scan_bwd_work", "scan_work", "spike_hist",
           "spike_hist_batch", "spike_hist_batch_plain", "ssm_scan",
           "ssm_scan_bsd", "ssm_scan_bwd", "ssm_scan_bwd_plain",
           "ssm_scan_plain"]

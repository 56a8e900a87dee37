from repro_torch.optim.adamw import (adamw_update, clip_by_global_norm,
                                     global_norm, init_opt_state)
from repro_torch.optim.schedule import warmup_cosine

__all__ = ["adamw_update", "clip_by_global_norm", "global_norm",
           "init_opt_state", "warmup_cosine"]

from repro_torch.checkpoint import ckpt

__all__ = ["ckpt"]

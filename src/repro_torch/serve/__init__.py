"""Serving engine of the port."""
from repro_torch.serve.engine import ServeEngine, ServeStats

__all__ = ["ServeEngine", "ServeStats"]

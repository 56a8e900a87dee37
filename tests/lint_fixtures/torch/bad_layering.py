# minoslint: path=src/repro_torch/core/fixture_layering.py
"""Known-bad W401/W403 fixture for the port: ``core`` reaching up into
``api`` (the north-star edge the DAG forbids), into the frozen legacy
surface, and — lazily — into the JAX stack and the reference package."""
from repro_torch.api import MinosSession          # W401: core -> api
from repro_torch.legacy import simulate_dense     # W403


def helper():
    import jax                                    # W401: lazy, still an edge
    from repro.core import spikes                 # W401: the reference
    return MinosSession, simulate_dense, jax, spikes

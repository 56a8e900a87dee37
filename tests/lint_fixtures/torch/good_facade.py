# minoslint: path=examples/quickstart_torch.py
"""Known-good twin of ``bad_facade.py``: the facade consumes only the
public surface."""
from repro_torch.api import MinosSession
from repro_torch.fleet import FleetCapController


def main():
    return MinosSession, FleetCapController

# minoslint: path=examples/quickstart_torch.py
"""Known-bad W402 fixture for the port: a facade file importing past the
public ``repro_torch.api`` / ``repro_torch.fleet`` surface."""
from repro_torch.api import MinosSession              # fine
from repro_torch.store.journal import EventJournal    # W402: deep import


def main():
    return MinosSession, EventJournal

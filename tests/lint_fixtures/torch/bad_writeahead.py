# minoslint: path=src/repro_torch/store/fixture_writeahead.py
"""Known-bad W101 fixture for the port: the mutation lands BEFORE the
journal call, so a crash in between loses state the journal never saw."""


class BrokenController:
    def __init__(self, journal):
        self.journal = journal
        self.jobs = {}

    def admit(self, job_id, spec):
        self.jobs[job_id] = spec            # W101: mutate-then-journal
        self.journal.append("admit", {"job_id": job_id})

    def retire(self, job_id):
        del self.jobs[job_id]               # W101: never journaled at all

# minoslint: path=src/repro_torch/store/fixture_writeahead.py
"""Known-good twin of ``bad_writeahead.py``: every mutation is dominated
by the journal call — write-ahead, crash-safe."""


class Controller:
    def __init__(self, journal):
        self.journal = journal
        self.jobs = {}

    def admit(self, job_id, spec):
        self.journal.append("admit", {"job_id": job_id})
        self.jobs[job_id] = spec

    def retire(self, job_id):
        self.journal.append("retire", {"job_id": job_id})
        del self.jobs[job_id]

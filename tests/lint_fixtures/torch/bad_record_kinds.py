# minoslint: path=src/repro_torch/store/fixture_kinds.py
"""Known-bad W201/W202/W203 fixture for the port: one emitter produces a
kind the dispatch never handles (and the registry never registered), and
the dispatch keeps a handler for a kind nothing emits."""

ADMIT = "admit"
RETIRE = "retire"
ALL_KINDS = frozenset({ADMIT, RETIRE})


class Session:
    def submit(self, job_id):
        self._journal("admit", job_id=job_id)
        self._journal("orphan", job_id=job_id)   # W201 + W203

    def _apply_record(self, rec):
        match rec.kind:
            case "admit":
                pass
            case "retire":                       # W202: nothing emits it
                pass

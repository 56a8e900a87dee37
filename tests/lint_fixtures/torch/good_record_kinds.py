# minoslint: path=src/repro_torch/store/fixture_kinds.py
"""Known-good twin of ``bad_record_kinds.py``: emitted == handled ==
registered."""

ADMIT = "admit"
RETIRE = "retire"
ALL_KINDS = frozenset({ADMIT, RETIRE})


class Session:
    def submit(self, job_id):
        self._journal("admit", job_id=job_id)

    def retire(self, job_id):
        self._journal("retire", job_id=job_id)

    def _apply_record(self, rec):
        match rec.kind:
            case "admit":
                pass
            case "retire":
                pass

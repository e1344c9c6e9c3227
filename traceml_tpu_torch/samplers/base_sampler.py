"""Sampler base.

Counterpart of ``traceml_tpu/samplers/base_sampler.py``.  Every sampler
owns a bounded in-memory :class:`Database` and the incremental sender
over it; the runtime tick calls ``sample()`` (errors logged, never
raised) and the publisher ships what ``sender`` collects.
"""

from __future__ import annotations

from traceml_tpu_torch.database import Database
from traceml_tpu_torch.database.database_sender import DBIncrementalSender
from traceml_tpu_torch.utils.error_log import get_error_log


class BaseSampler:
    name: str = "base"

    def __init__(self) -> None:
        self.db = Database()
        self.sender = DBIncrementalSender(self.name, self.db)
        self.sample_errors = 0

    def sample(self) -> None:
        """Called on every runtime tick; must be cheap and non-raising."""
        try:
            self._sample()
        except Exception as exc:
            self.sample_errors += 1
            get_error_log().warning(f"sampler {self.name} sample failed", exc)

    def _sample(self) -> None:  # pragma: no cover - abstract
        raise NotImplementedError

    def drain(self) -> None:
        """Final sample pass during shutdown."""
        self.sample()

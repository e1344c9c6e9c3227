"""Sampler base.

Counterpart of ``traceml_tpu/samplers/base_sampler.py``.  Every sampler
owns a bounded in-memory :class:`Database`, the incremental sender over
it and a :class:`DatabaseWriter`, which keeps the optional disk backup
(``disk_backup_dir``, the runtime's ``rank_N/data`` under
``--disk-backup``; None writes nothing).  The runtime tick calls
``sample()`` (errors logged, never raised) and the publisher ships what
``sender`` collects and hands the same encoded bytes to ``writer``.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional

from traceml_tpu_torch.database import Database, DatabaseWriter
from traceml_tpu_torch.database.database_sender import DBIncrementalSender
from traceml_tpu_torch.utils.error_log import get_error_log


class BaseSampler:
    name: str = "base"

    def __init__(self, disk_backup_dir: Optional[Path] = None) -> None:
        self.db = Database()
        self.sender = DBIncrementalSender(self.name, self.db)
        self.writer = DatabaseWriter(self.name, disk_backup_dir)
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
        """A last sample pass: at shutdown, and for the drain-on-stop
        samplers when recording stops."""
        self.sample()

    def stop(self) -> None:
        """Last-chance backup flush, as in JAX: the writer holds only
        what the publisher fed it, so rows that landed after the final
        publish are collected into one last envelope here before the
        buffer is forced out."""
        try:
            if self.writer.enabled and self.sender.dirty():
                payload = self.sender.collect_payload()
                if payload is not None:
                    from traceml_tpu_torch.utils import msgpack_codec

                    self.writer.append_envelope(msgpack_codec.preencode(payload))
        except Exception as exc:
            get_error_log().warning(f"sampler {self.name} final collect failed", exc)
        try:
            self.writer.flush(force=True)
        except Exception:
            pass

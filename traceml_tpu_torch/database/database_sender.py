"""Incremental envelope builder over a Database.

Counterpart of ``traceml_tpu/database/database_sender.py``: a per-table
cursor on the append counter, so ``collect_payload`` ships only the rows
appended since the previous call, as a schema-2 (columnar) envelope.
``None`` when there is nothing new, so an idle tick sends nothing.
"""

from __future__ import annotations

import time
from typing import Any, Dict, Optional

from traceml_tpu_torch.database.database import Database
from traceml_tpu_torch.telemetry.envelope import SCHEMA_V2, SenderIdentity, rows_to_columns


class DBIncrementalSender:
    def __init__(self, sampler_name: str, db: Database) -> None:
        self._sampler = sampler_name
        self._db = db
        self._cursors: Dict[str, int] = {}
        self._identity = SenderIdentity()
        self._last_total = 0  # db.appended_total() at the last collection

    def set_identity(self, identity: SenderIdentity) -> None:
        self._identity = identity

    def dirty(self) -> bool:
        """O(1), lock-free: rows appended since the last collection?"""
        return self._db.appended_total() != self._last_total

    def collect_payload(self) -> Optional[Dict[str, Any]]:
        if not self.dirty():
            return None
        # Read the total BEFORE collecting: a row appended mid-collect
        # keeps dirty() true, so the next tick picks it up (at worst one
        # extra sweep, never a skipped row).
        total = self._db.appended_total()
        tables = self._db.collect_rows(self._cursors)
        self._last_total = total
        if not tables:
            return None
        meta = self._identity.to_meta()
        meta["schema"] = SCHEMA_V2
        meta["sampler"] = self._sampler
        meta["timestamp"] = time.time()
        return {
            "meta": meta,
            "body": {"tables": {k: rows_to_columns(v) for k, v in tables.items()}},
        }

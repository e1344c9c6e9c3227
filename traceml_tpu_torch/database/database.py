"""Bounded in-memory table store.

Counterpart of ``traceml_tpu/database/database.py`` without the append
counters and the envelope/columnar parts, which serve the transport.  Each
sampler owns one ``Database``: a dict of named tables, each a
``deque(maxlen=N)`` of row dicts.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Any, Deque, Dict, List, Optional

DEFAULT_MAX_ROWS = 3000


class Database:
    def __init__(self, max_rows_per_table: int = DEFAULT_MAX_ROWS) -> None:
        self._max_rows = int(max_rows_per_table)
        self._tables: Dict[str, Deque[Dict[str, Any]]] = {}
        self._lock = threading.Lock()

    def _table(self, table: str) -> Deque[Dict[str, Any]]:
        rows = self._tables.get(table)
        if rows is None:
            rows = self._tables[table] = deque(maxlen=self._max_rows)
        return rows

    def add_record(self, table: str, row: Dict[str, Any]) -> None:
        with self._lock:
            self._table(table).append(row)

    def add_records(self, table: str, rows: List[Dict[str, Any]]) -> None:
        with self._lock:
            self._table(table).extend(rows)

    def tail(self, table: str, n: Optional[int] = None) -> List[Dict[str, Any]]:
        with self._lock:
            rows = list(self._tables.get(table, ()))
        return rows if n is None else rows[-n:]

"""Bounded in-memory table store.

Counterpart of ``traceml_tpu/database/database.py`` without its columnar
append accumulator.  Each sampler owns one ``Database``: a dict of named
tables, each a ``deque(maxlen=N)`` of row dicts plus a **monotonic
append counter**, so the incremental sender finds the new rows by count
even after old ones were evicted from the left.
"""

from __future__ import annotations

import threading
from collections import deque
from itertools import islice
from typing import Any, Deque, Dict, List, Optional

DEFAULT_MAX_ROWS = 3000


class _Table:
    __slots__ = ("rows", "appended")

    def __init__(self, maxlen: int) -> None:
        self.rows: Deque[Dict[str, Any]] = deque(maxlen=maxlen)
        self.appended = 0  # rows ever appended; never decreases


class Database:
    def __init__(self, max_rows_per_table: int = DEFAULT_MAX_ROWS) -> None:
        self._max_rows = int(max_rows_per_table)
        self._tables: Dict[str, _Table] = {}
        self._lock = threading.Lock()
        self._appended_total = 0  # across all tables; never decreases

    def _table(self, table: str) -> _Table:
        t = self._tables.get(table)
        if t is None:
            t = self._tables[table] = _Table(self._max_rows)
        return t

    def add_record(self, table: str, row: Dict[str, Any]) -> None:
        with self._lock:
            t = self._table(table)
            t.rows.append(row)
            t.appended += 1
            self._appended_total += 1

    def add_records(self, table: str, rows: List[Dict[str, Any]]) -> None:
        if not rows:
            return
        with self._lock:
            t = self._table(table)
            t.rows.extend(rows)
            t.appended += len(rows)
            self._appended_total += len(rows)

    def appended_total(self) -> int:
        """Rows ever appended, across all tables.  Read without the lock:
        one int only ever incremented under it, so a reader sees a recent
        value — enough for the sender's "anything new?" gate."""
        return self._appended_total

    def tail(self, table: str, n: Optional[int] = None) -> List[Dict[str, Any]]:
        with self._lock:
            t = self._tables.get(table)
            rows = list(t.rows) if t is not None else []
        return rows if n is None else rows[-n:]

    def collect_rows(self, cursors: Dict[str, int]) -> Dict[str, List[Dict[str, Any]]]:
        """One-lock sweep: every table's rows appended after its cursor.

        ``cursors`` maps table → append count already collected and is
        updated IN PLACE, atomically per table with the rows handed
        over.  Rows evicted before they were collected are lost (the
        bounded-memory contract); the rest come oldest first.
        """
        out: Dict[str, List[Dict[str, Any]]] = {}
        with self._lock:
            for name, t in self._tables.items():
                new = t.appended - cursors.get(name, 0)
                cursors[name] = t.appended
                if new > 0:
                    # slice from the tail: O(new rows), not O(retained)
                    out[name] = list(islice(reversed(t.rows), min(new, len(t.rows))))
        for rows in out.values():
            rows.reverse()
        return out

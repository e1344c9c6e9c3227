"""Telemetry envelope.

Counterpart of ``traceml_tpu/telemetry/envelope.py``.  Canonical shape
on the wire::

    {
      "meta": {
        "schema": 1 | 2, "session_id": str, "sampler": str,
        "timestamp": float,            # sender host unix time
        "rank": int,                   # == global_rank
        "global_rank": int, "local_rank": int, "world_size": int,
        "local_world_size": int, "node_rank": int,
        "hostname": str, "pid": int,
        "seq": int,                    # per-rank monotonic
      },
      "body": {"tables": {table_name: <table>}}
    }

A table is either a row list (schema 1) or columnar (schema 2,
``{"cols": [k, ...], "vals": [[...], ...], "n": N}``; a column whose
cells are dicts with one key set is itself transposed, see
:data:`SOA_KEY`).  The rank's sender ships schema 2; the aggregator
accepts both, and its SQLite writers read tables through
:class:`ColumnView` without building row dicts.

The identity carries no device inventory yet (that comes with
``runtime/identity.py``): it is the rank's place in the job, from the
``RANK`` / ``WORLD_SIZE`` / ``LOCAL_RANK`` / ``LOCAL_WORLD_SIZE`` /
``NODE_RANK`` environment, plus the hostname and the pid.
"""

from __future__ import annotations

import dataclasses
import os
import socket
from typing import Any, Dict, List, Mapping, Optional

SCHEMA_VERSION = 1
SCHEMA_V2 = 2


@dataclasses.dataclass(frozen=True)
class SenderIdentity:
    """Identity attached to every envelope a rank emits."""

    session_id: str = "unknown"
    global_rank: int = 0
    local_rank: int = 0
    world_size: int = 1
    local_world_size: int = 1
    node_rank: int = 0
    hostname: str = dataclasses.field(default_factory=socket.gethostname)
    pid: int = dataclasses.field(default_factory=os.getpid)

    def to_meta(self) -> Dict[str, Any]:
        return {
            "schema": SCHEMA_VERSION,
            "session_id": self.session_id,
            "rank": self.global_rank,
            "global_rank": self.global_rank,
            "local_rank": self.local_rank,
            "world_size": self.world_size,
            "local_world_size": self.local_world_size,
            "node_rank": self.node_rank,
            "hostname": self.hostname,
            "pid": self.pid,
        }


# -- columnar (struct-of-arrays) table helpers ---------------------------

# Reserved marker key for a nested struct-of-arrays column: a column whose
# rows are dicts with an IDENTICAL key set (e.g. step_time "events") is
# encoded as {"\x00soa": [keys, [subcol, ...]]}, recursively — the inner
# keys hit the wire once per batch instead of once per row.  A single-key
# dict with this NUL-prefixed key cannot occur in sampler rows.
SOA_KEY = "\x00soa"


def _same_key_dicts(cells: List[Any]) -> Optional[List[str]]:
    """Key list when every cell is a dict with the same key set, else None."""
    if not cells or not isinstance(cells[0], dict):
        return None
    first = cells[0]
    for c in cells[1:]:
        if not isinstance(c, dict) or c.keys() != first.keys():
            return None
    return [str(k) for k in first]


def _encode_cells(cells: List[Any]) -> Any:
    keys = _same_key_dicts(cells)
    if keys is None:
        return cells
    return {SOA_KEY: [keys, [_encode_cells([c[k] for c in cells]) for k in keys]]}


def _decode_cells(col: Any, n: int) -> List[Any]:
    if isinstance(col, dict):
        marker = col.get(SOA_KEY)
        if (
            isinstance(marker, (list, tuple))
            and len(marker) == 2
            and isinstance(marker[0], list)
            and isinstance(marker[1], list)
        ):
            keys, subcols = marker
            if len(keys) == len(subcols):
                decoded = [_decode_cells(s, n) for s in subcols]
                return [{keys[j]: decoded[j][i] for j in range(len(keys))} for i in range(n)]
        return [None] * n  # malformed nested column → null it out
    return col


def rows_to_columns(rows: List[Mapping[str, Any]]) -> Dict[str, Any]:
    """``[{k: v}, ...]`` → ``{"cols": [...], "vals": [...], "n": N}``.

    Column order is first-appearance order across the batch; rows missing
    a key get ``None`` in that column.  Dict-valued columns with a
    uniform key set are recursively transposed (see :data:`SOA_KEY`).
    """
    cols: List[str] = []
    index: Dict[str, int] = {}
    for row in rows:
        for k in row:
            if k not in index:
                index[k] = len(cols)
                cols.append(k)
    n = len(rows)
    vals: List[Any] = [[None] * n for _ in cols]
    for i, row in enumerate(rows):
        for k, v in row.items():
            vals[index[k]][i] = v
    return {"cols": cols, "vals": [_encode_cells(col) for col in vals], "n": n}


def columns_to_rows(table: Mapping[str, Any]) -> List[Dict[str, Any]]:
    """Row dicts from a columnar table (inverse of :func:`rows_to_columns`
    for batches with uniform keys)."""
    cols = table.get("cols") or []
    n = _columnar_n(table)
    decoded = [_decode_cells(col, n) for col in table.get("vals") or []]
    return [{cols[j]: decoded[j][i] for j in range(len(cols))} for i in range(n)]


def _columnar_n(table: Mapping[str, Any]) -> int:
    n = table.get("n")
    if isinstance(n, int) and n >= 0:
        return n
    for col in table.get("vals") or ():
        if isinstance(col, list):
            return len(col)
    return 0


def is_columnar_table(obj: Any) -> bool:
    return (
        isinstance(obj, Mapping)
        and isinstance(obj.get("cols"), list)
        and isinstance(obj.get("vals"), list)
    )


def _validate_columnar(obj: Mapping[str, Any]) -> Optional[Dict[str, Any]]:
    """Sanitize a wire columnar table; None when structurally invalid."""
    cols, vals = obj.get("cols"), obj.get("vals")
    if not isinstance(cols, list) or not isinstance(vals, list) or len(cols) != len(vals):
        return None
    n = obj.get("n") if isinstance(obj.get("n"), int) else None
    for col in vals:
        if isinstance(col, list):
            if n is None:
                n = len(col)
            elif len(col) != n:
                return None
        elif not isinstance(col, Mapping):
            return None  # nested SoA columns are dicts; anything else is junk
    if n is None:
        n = 0 if not vals else None
    if n is None or n < 0:
        return None
    return {"cols": [str(c) for c in cols], "vals": vals, "n": n}


def _to_float(v: Any) -> Optional[float]:
    if v is None:
        return None
    try:
        return float(v)
    except (TypeError, ValueError):
        return None


def _to_int(v: Any) -> Optional[int]:
    if v is None:
        return None
    try:
        return int(v)
    except (TypeError, ValueError):
        return None


class ColumnView:
    """Read-only columnar view over one table, however it arrived (v2
    columns directly; v1 row dicts through one transpose).  Truthiness is
    "has at least one row"."""

    __slots__ = ("_idx", "_vals", "_n")

    def __init__(self, cols: List[str], vals: List[Any], n: int) -> None:
        self._idx = {k: j for j, k in enumerate(cols)}
        self._vals = vals
        self._n = n

    @classmethod
    def from_rows(cls, rows: List[Mapping[str, Any]]) -> "ColumnView":
        ct = rows_to_columns(rows)
        return cls(ct["cols"], ct["vals"], ct["n"])

    def __len__(self) -> int:
        return self._n

    def col(self, key: str) -> List[Any]:
        """Raw value column (nested columns materialized back to per-row
        dicts); ``None``-filled when the column is absent."""
        j = self._idx.get(key)
        if j is None:
            return [None] * self._n
        return _decode_cells(self._vals[j], self._n)

    def floats(self, key: str) -> List[Optional[float]]:
        return [_to_float(v) for v in self.col(key)]

    def ints(self, key: str) -> List[Optional[int]]:
        return [_to_int(v) for v in self.col(key)]

    def strs(self, key: str, default: str = "") -> List[str]:
        return [default if v is None else str(v) for v in self.col(key)]


class TelemetryEnvelope:
    """Canonical in-memory envelope: row-list tables, columnar tables, or
    both (a mixed wire payload)."""

    __slots__ = ("meta", "_rows", "_columns")

    def __init__(
        self,
        meta: Dict[str, Any],
        tables: Optional[Dict[str, List[Dict[str, Any]]]] = None,
        columns: Optional[Dict[str, Dict[str, Any]]] = None,
    ) -> None:
        self.meta = meta
        self._rows = tables or {}
        self._columns = columns or {}

    @property
    def sampler(self) -> str:
        return str(self.meta.get("sampler", "unknown"))

    @property
    def global_rank(self) -> int:
        return int(self.meta.get("global_rank", self.meta.get("rank", 0)))

    @property
    def seq(self) -> Optional[int]:
        return _to_int(self.meta.get("seq"))

    @property
    def tables(self) -> Dict[str, List[Dict[str, Any]]]:
        """Every table as row dicts (columnar ones materialized)."""
        merged = {k: columns_to_rows(v) for k, v in self._columns.items()}
        merged.update(self._rows)
        return merged

    def column_view(self, name: str) -> Optional[ColumnView]:
        """Columnar view of one table, or None when absent."""
        ct = self._columns.get(name)
        if ct is not None:
            return ColumnView(ct["cols"], ct["vals"], _columnar_n(ct))
        rows = self._rows.get(name)
        if rows is None:
            return None
        return ColumnView.from_rows(rows)


def normalize_telemetry_envelope(payload: Any) -> Optional[TelemetryEnvelope]:
    """A decoded wire payload as a canonical envelope, or None for
    payloads that are not telemetry (control messages, garbage)."""
    if not isinstance(payload, Mapping) or "meta" not in payload or "body" not in payload:
        return None
    meta, body = payload.get("meta"), payload.get("body")
    if not isinstance(meta, Mapping) or not isinstance(body, Mapping):
        return None
    tables = body.get("tables")
    if not isinstance(tables, Mapping):
        return None
    meta = dict(meta)
    meta.setdefault("schema", SCHEMA_VERSION)
    meta.setdefault("global_rank", meta.get("rank", 0))
    meta.setdefault("rank", meta.get("global_rank", 0))
    rows_t: Dict[str, List[Dict[str, Any]]] = {}
    cols_t: Dict[str, Dict[str, Any]] = {}
    for k, v in tables.items():
        if isinstance(v, list):
            rows_t[str(k)] = list(v)
        elif is_columnar_table(v):
            ct = _validate_columnar(v)
            if ct is not None:
                cols_t[str(k)] = ct
    return TelemetryEnvelope(meta=meta, tables=rows_t, columns=cols_t)

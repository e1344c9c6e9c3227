"""Incremental live read path: cursor-based snapshot store.

Counterpart of ``traceml_tpu/reporting/snapshot_store.py``
(``LiveSnapshotStore``), trimmed to the tables the port writes.  It sits
between SQLite and the live views and makes the tick cost proportional
to what changed:

* one persistent read-only connection with the JAX store's read
  pragmas (``busy_timeout`` among them: a locked read fails this tick's
  table, and the next tick retries it from the same cursor);
* a per-table ``max(id)`` cursor: each refresh fetches only the
  ``id > cursor`` rows, in one query per table;
* each ``events_json`` blob is decoded once, into bounded per-rank
  deques mirroring the loader windows;
* ``PRAGMA data_version`` gates the whole refresh: an idle tick (no
  commit since the last one) reads no table;
* per-domain versions (the refresh count at the domain's last new
  rows or trim) let ``LiveComputer`` recompute only the domains that
  changed.

Retention, as in JAX: the writer's watermark prune deletes one
``(session_id, global_rank)`` partition's rows at or below a watermark
id, below every cursor, and journals it in ``retention_watermarks`` in
the same transaction.  Each non-idle refresh reads the journal from its
own cursor; each table's reader then evicts exactly the rows SQLite
deleted (a per-rank buffer drops its prefix up to the watermark, a
mixed-rank buffer filters by (rank, id)), so the held windows equal a
cold load of the pruned database.  A journal row naming a rollup source
table is the ``rollup`` domain's change signal (its fold committed with
the prune); ``has_rollups``, ``stitched_series`` (cached per rollup and
raw-domain version) and ``stitched_overview`` read the tiers through
``reporting/tiers.py``.  Accumulated identity sets (topology) never
shrink on a trim.

Window engines, as in JAX: each step-time and step-memory rank buffer
keeps a columnar ring (``utils/columnar.py``) in lockstep with its row
deque: the ring self-evicts on overflow as the deque's ``maxlen`` does,
follows a journal trim's prefix eviction, and is rebuilt from the kept
rows when a watermark filter drops rows out of the middle.  The step-time
window is built from the rings by the incremental cache
(``StepTimeWindowCache``, one per store), or by the full columnar build
under ``TRACEML_INCR_WINDOW=0``, and by the scalar arm
(``utils/step_time_window.py``, the reference) under
``TRACEML_COLUMNAR_WINDOW=0`` or when a rank's ring is flagged.  The
store owns the tick profiler that the live computer, the serving tier and
the final report write into; ``window_build_stats`` reads it with the
caches' counters.

Left out against the JAX store, with the port's queues that bring them:
the ``MIN(id)`` trim detection for databases recorded before the journal
existed (every database the port writes has it) and the collectives,
serving and mesh-topology tables with their window engines (queue 1
items 5 and 6).
"""

from __future__ import annotations

import json
import sqlite3
import statistics
import threading
from collections import deque
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Set, Tuple

from traceml_tpu_torch.aggregator.rollup import ROLLUP_SOURCES
from traceml_tpu_torch.utils.columnar import (
    ColumnarFallback,
    MemoryColumns,
    StepTimeColumns,
    StepTimeWindowCache,
    TickProfile,
    columnar_window_enabled,
    engine_step_time_window,
    window_build_snapshot,
)
from traceml_tpu_torch.utils.error_log import get_error_log
from traceml_tpu_torch.utils.step_time_window import StepTimeWindow, build_step_time_window

_READ_PRAGMAS = (
    "PRAGMA busy_timeout=200",
    "PRAGMA cache_size=-8192",      # 8 MiB page cache
    "PRAGMA temp_store=MEMORY",
    "PRAGMA mmap_size=134217728",   # 128 MiB, no-op where unsupported
)

# domains exposed through per-domain versions (what dirty-gating keys on)
DOMAINS = ("step_time", "step_memory", "system", "process", "stdout", "model_stats", "topology", "rollup")
_ROLLUP_SOURCE_SET = frozenset(ROLLUP_SOURCES)

# the JAX store's bounds: system and process rows over all nodes and
# ranks, the stdout tail, model_stats declarations
_SYSTEM_ROWS = 300
_PROCESS_ROWS = 300
_STDOUT_ROWS = 64
_MODEL_STATS_ROWS = 64

_MODEL_STATS_COLS = (
    "id", "global_rank", "flops_per_step", "flops_source", "device_kind", "peak_flops",
    "device_count", "tokens_per_step",
)


class _RankBuffer:
    """Bounded row window whose ids, ranks and rows evict in lockstep
    (one ``maxlen``), so a retention trim can drop exactly the rows
    SQLite dropped."""

    __slots__ = ("ids", "ranks", "rows")

    def __init__(self, maxlen: int) -> None:
        self.ids: deque = deque(maxlen=maxlen)
        self.ranks: deque = deque(maxlen=maxlen)
        self.rows: deque = deque(maxlen=maxlen)

    def append(self, row_id: int, rank: Optional[int], row: Any) -> None:
        self.ids.append(row_id)
        self.ranks.append(rank)
        self.rows.append(row)

    def clear(self) -> None:
        self.ids.clear()
        self.ranks.clear()
        self.rows.clear()

    def evict_below(self, min_id: int) -> bool:
        """Prefix eviction for a single-rank buffer."""
        changed = False
        while self.ids and self.ids[0] < min_id:
            self.ids.popleft()
            self.ranks.popleft()
            self.rows.popleft()
            changed = True
        return changed

    def filter_watermarks(self, watermarks: Dict[int, int]) -> bool:
        """Drop every held row at or below its rank's watermark; ranks
        the journal does not name keep all their rows."""
        keep = [
            (i, rk, rw)
            for i, rk, rw in zip(self.ids, self.ranks, self.rows)
            if rk not in watermarks or i > watermarks[rk]
        ]
        if len(keep) == len(self.ids):
            return False
        self.clear()
        for i, rk, rw in keep:
            self.append(i, rk, rw)
        return True


class _ColumnarBuffer(_RankBuffer):
    """A row window and its columnar ring in lockstep: every append lands
    in both, the ring self-evicts on overflow as the deque's ``maxlen``
    does, a prefix eviction drops the same count from the ring's head,
    and a filter that drops rows out of the middle rebuilds the ring from
    the kept rows (through ``clear`` and ``append``).  So the columnar
    build always sees the rows the scalar arm would."""

    __slots__ = ("cols",)
    ring_cls: Any = None

    def __init__(self, maxlen: int) -> None:
        super().__init__(maxlen)
        self.cols = self.ring_cls(maxlen)

    def append(self, row_id: int, rank: Optional[int], row: Any) -> None:
        super().append(row_id, rank, row)
        self.cols.append(row)

    def clear(self) -> None:
        super().clear()
        self.cols.clear()

    def evict_below(self, min_id: int) -> bool:
        changed = super().evict_below(min_id)
        self.cols.evict_head(len(self.cols) - len(self.ids))
        return changed


class _StepTimeBuffer(_ColumnarBuffer):
    __slots__ = ()
    ring_cls = StepTimeColumns


class _MemoryBuffer(_ColumnarBuffer):
    __slots__ = ()
    ring_cls = MemoryColumns


class _TopologySource:
    """Accumulated identity sets for one projection table."""

    __slots__ = ("ranks", "nodes", "hostnames", "world")

    def __init__(self) -> None:
        self.ranks: Set[int] = set()
        self.nodes: Set[int] = set()
        self.hostnames: Set[str] = set()
        self.world: int = 0

    def update(self, rank, node, hostname, world) -> bool:
        before = (len(self.ranks), len(self.nodes), len(self.hostnames), self.world)
        if rank is not None:
            self.ranks.add(int(rank))
        if node is not None:
            self.nodes.add(int(node))
        if hostname is not None:
            self.hostnames.add(str(hostname))
        if world:
            self.world = max(self.world, int(world))
        return before != (len(self.ranks), len(self.nodes), len(self.hostnames), self.world)


class LiveSnapshotStore:
    """Incremental, bounded, decode-once snapshot of a session DB.

    ``refresh()`` advances the snapshot; accessors return loader-shaped
    structures (the keys and grouping of ``reporting/loaders.py``), so
    the window builder, views and diagnoses consume them unchanged.  One
    lock serializes refresh and the accessors.
    """

    def __init__(self, db_path: Path, window_steps: int = 120) -> None:
        self.db_path = Path(db_path)
        self.window_steps = int(window_steps)
        self.memory_rows_per_rank = self.window_steps * 4
        self._lock = threading.RLock()
        self._conn: Optional[sqlite3.Connection] = None
        self._primed = False
        self._last_db_dv: Optional[int] = None
        self._data_version = 0
        self._versions: Dict[str, int] = {d: 0 for d in DOMAINS}
        self._cursors: Dict[str, int] = {}
        self._tables_seen: Set[str] = set()
        # table → {rank: trim watermark} from the journal, consumed by the
        # table's reader (kept across a failed read: applied on the retry)
        self._pending_trims: Dict[str, Dict[int, int]] = {}
        self._rollup_dirty = False
        self._stitched_cache: Dict[Tuple, Tuple[Tuple[int, ...], Any]] = {}
        # step_time / step_memory: per-rank bounded windows (row deque
        # and columnar ring in lockstep)
        self._step_time: Dict[int, _StepTimeBuffer] = {}
        self._step_memory: Dict[int, _MemoryBuffer] = {}
        # the incremental step-time window cache, made on the first
        # incremental build; it follows rank churn, evictions and clock
        # flips through the rings' counters, so nothing resets it
        self._window_caches: Dict[str, StepTimeWindowCache] = {}
        # per-stage tick profiler: the live computer, the serving tier and
        # the final report write into it; window_build_stats reads it
        self.tick_profile = TickProfile()
        # system / process / stdout / model_stats: globally bounded
        # (loader semantics); system and process rows are (key, row)
        self._system_host = _RankBuffer(_SYSTEM_ROWS)
        self._system_dev = _RankBuffer(_SYSTEM_ROWS)
        self._process = _RankBuffer(_PROCESS_ROWS)
        self._process_dev = _RankBuffer(_PROCESS_ROWS)
        self._stdout = _RankBuffer(_STDOUT_ROWS)
        self._model_stats = _RankBuffer(_MODEL_STATS_ROWS)
        self._topology: Dict[str, _TopologySource] = {
            "step_time_samples": _TopologySource(),
            "process_samples": _TopologySource(),
            "system_samples": _TopologySource(),
        }
        self._topology_cache: Optional[Dict[str, Any]] = None
        self._topology_cache_version = -1

    # -- connection ------------------------------------------------------

    @property
    def connection(self) -> Optional[sqlite3.Connection]:
        """The shared read-only connection (None until the DB exists)."""
        with self._lock:
            return self._conn

    @property
    def connected(self) -> bool:
        with self._lock:
            return self._conn is not None

    def _connect(self) -> Optional[sqlite3.Connection]:
        if self._conn is not None:
            return self._conn
        if not self.db_path.exists():
            return None
        try:
            conn = sqlite3.connect(f"file:{self.db_path}?mode=ro", uri=True, check_same_thread=False)
        except sqlite3.Error:
            return None
        conn.row_factory = sqlite3.Row
        for pragma in _READ_PRAGMAS:
            try:
                conn.execute(pragma)
            except sqlite3.Error:
                pass
        self._conn = conn
        return conn

    def close(self) -> None:
        with self._lock:
            if self._conn is not None:
                try:
                    self._conn.close()
                except sqlite3.Error:
                    pass
                self._conn = None

    # -- versions --------------------------------------------------------

    @property
    def versions(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._versions)

    # -- refresh ---------------------------------------------------------

    def refresh(self) -> bool:
        """Advance the snapshot.  Returns True when anything changed.

        Idle fast path: ``PRAGMA data_version`` is a header-counter read;
        when it matches the last refresh no table is queried at all.
        """
        with self._lock:
            conn = self._connect()
            if conn is None:
                return False
            try:
                db_dv = conn.execute("PRAGMA data_version").fetchone()[0]
            except sqlite3.Error:
                return False
            if self._primed and db_dv == self._last_db_dv:
                return False
            try:
                self._read_watermark_journal(conn)
            except sqlite3.Error as exc:
                get_error_log().warning("snapshot refresh failed for retention_watermarks", exc)
            dirty: Set[str] = set()
            clean_scan = True
            readers: Tuple[Tuple[str, Callable, str], ...] = (
                ("step_time_samples", self._read_step_time, "step_time"),
                ("step_memory_samples", self._read_step_memory, "step_memory"),
                ("system_samples", self._read_system_host, "system"),
                ("system_device_samples", self._read_system_dev, "system"),
                ("process_samples", self._read_process, "process"),
                ("process_device_samples", self._read_process_dev, "process"),
                ("stdout_samples", self._read_stdout, "stdout"),
                ("model_stats_samples", self._read_model_stats, "model_stats"),
            )
            for table, reader, domain in readers:
                try:
                    if not self._table_exists(conn, table):
                        continue
                    if reader(conn, table, dirty):
                        dirty.add(domain)
                except sqlite3.Error as exc:
                    get_error_log().warning(f"snapshot refresh failed for {table}", exc)
                    clean_scan = False
            if self._rollup_dirty:
                # a fold commits with its prune's journal row, so the
                # journal naming a rollup source is the tiers' change
                dirty.add("rollup")
                self._rollup_dirty = False
            if clean_scan:
                # only mark the DB state consumed when every table read
                # cleanly: a busy or locked table retries next tick
                # (from its cursor, so the retry is incremental)
                self._last_db_dv = db_dv
                self._primed = True
            if dirty:
                self._data_version += 1
                for domain in dirty:
                    self._versions[domain] = self._data_version
            return bool(dirty)

    def _table_exists(self, conn: sqlite3.Connection, table: str) -> bool:
        if table in self._tables_seen:
            return True
        row = conn.execute(
            "SELECT name FROM sqlite_master WHERE type='table' AND name=?", (table,)
        ).fetchone()
        if row is not None:
            self._tables_seen.add(table)
            return True
        return False

    def _fetch(self, conn: sqlite3.Connection, table: str, columns: str, order: str) -> List[sqlite3.Row]:
        """The rows past the table's cursor, which moves to their max id
        (``columns`` must name ``id``)."""
        rows = conn.execute(
            f"SELECT {columns} FROM {table} WHERE id > ? ORDER BY {order}",
            (self._cursors.get(table, 0),),
        ).fetchall()
        if rows:
            self._cursors[table] = max(max(r["id"] for r in rows), self._cursors.get(table, 0))
        return rows

    def _read_watermark_journal(self, conn: sqlite3.Connection) -> None:
        """The writer's prunes since the last refresh: per table, the
        highest watermark of each rank, held until the table's reader
        applies it."""
        if not self._table_exists(conn, "retention_watermarks"):
            return
        rows = self._fetch(conn, "retention_watermarks", "id, table_name, global_rank, watermark_id", "id")
        for r in rows:
            table = str(r["table_name"])
            trims = self._pending_trims.setdefault(table, {})
            rank, wm = int(r["global_rank"]), int(r["watermark_id"])
            if wm > trims.get(rank, -1):
                trims[rank] = wm
            if table in _ROLLUP_SOURCE_SET:
                self._rollup_dirty = True

    def _apply_trims(self, table: str, rank_bufs: Optional[Dict[int, _RankBuffer]] = None,
                     flat_buf: Optional[_RankBuffer] = None) -> bool:
        """Evict exactly the rows the writer's prunes of ``table`` deleted."""
        watermarks = self._pending_trims.pop(table, None)
        if not watermarks:
            return False
        changed = False
        if rank_bufs is not None:
            for rank, wm in watermarks.items():
                buf = rank_bufs.get(rank)
                if buf is not None:
                    changed |= buf.evict_below(wm + 1)
        if flat_buf is not None:
            changed |= flat_buf.filter_watermarks(watermarks)
        return changed

    # -- per-table readers ----------------------------------------------

    def _read_step_time(self, conn, table, dirty) -> bool:
        rows = self._fetch(
            conn, table,
            "id, global_rank, node_rank, hostname, world_size, step, timestamp, clock, late_markers,"
            " events_json",
            "global_rank, step, id",
        )
        topo = self._topology[table]
        for r in rows:
            if topo.update(r["global_rank"], r["node_rank"], r["hostname"], r["world_size"]):
                dirty.add("topology")
            try:
                events = json.loads(r["events_json"] or "{}")
            except ValueError:
                events = {}
            rank = int(r["global_rank"])
            buf = self._step_time.get(rank)
            if buf is None:
                buf = self._step_time[rank] = _StepTimeBuffer(self.window_steps)
            buf.append(r["id"], rank, {
                "step": r["step"],
                "timestamp": r["timestamp"],
                "clock": r["clock"],
                "late_markers": r["late_markers"],
                "events": events,
            })
        return self._apply_trims(table, rank_bufs=self._step_time) or bool(rows)

    def _read_step_memory(self, conn, table, dirty) -> bool:
        rows = self._fetch(
            conn, table,
            "id, global_rank, step, timestamp, device_id, device_kind, current_bytes, peak_bytes,"
            " step_peak_bytes, limit_bytes",
            "global_rank, step, id",
        )
        for r in rows:
            rank = int(r["global_rank"])
            buf = self._step_memory.get(rank)
            if buf is None:
                buf = self._step_memory[rank] = _MemoryBuffer(self.memory_rows_per_rank)
            row = dict(r)
            del row["id"], row["global_rank"]
            buf.append(r["id"], rank, row)
        return self._apply_trims(table, rank_bufs=self._step_memory) or bool(rows)

    def _read_keyed(self, conn, table, buf: _RankBuffer, key_fn, dirty: Set[str]) -> bool:
        rows = self._fetch(conn, table, "*", "id")
        topo = self._topology.get(table)
        for r in rows:
            if topo is not None and topo.update(r["global_rank"], r["node_rank"], r["hostname"], r["world_size"]):
                dirty.add("topology")
            buf.append(r["id"], int(r["global_rank"]), (key_fn(r), dict(r)))
        return self._apply_trims(table, flat_buf=buf) or bool(rows)

    def _read_system_host(self, conn, table, dirty) -> bool:
        return self._read_keyed(conn, table, self._system_host, lambda r: int(r["node_rank"]), dirty)

    def _read_system_dev(self, conn, table, dirty) -> bool:
        return self._read_keyed(
            conn, table, self._system_dev, lambda r: (int(r["node_rank"]), int(r["device_id"] or 0)), dirty
        )

    def _read_process(self, conn, table, dirty) -> bool:
        return self._read_keyed(conn, table, self._process, lambda r: int(r["global_rank"]), dirty)

    def _read_process_dev(self, conn, table, dirty) -> bool:
        return self._read_keyed(
            conn, table, self._process_dev, lambda r: (int(r["global_rank"]), int(r["device_id"] or 0)), dirty
        )

    def _read_stdout(self, conn, table, dirty) -> bool:
        rows = self._fetch(conn, table, "id, global_rank, stream, line", "id")
        for r in rows:
            self._stdout.append(r["id"], int(r["global_rank"]), (r["stream"], r["line"]))
        return self._apply_trims(table, flat_buf=self._stdout) or bool(rows)

    def _read_model_stats(self, conn, table, dirty) -> bool:
        rows = self._fetch(conn, table, ", ".join(_MODEL_STATS_COLS), "id")
        for r in rows:
            self._model_stats.append(r["id"], int(r["global_rank"]), dict(r))
        return self._apply_trims(table, flat_buf=self._model_stats) or bool(rows)

    # -- accessors (loader-shaped) --------------------------------------

    def step_time_rows(self) -> Dict[int, List[Dict[str, Any]]]:
        """global_rank → decoded step rows (``loaders.load_step_time_rows``)."""
        with self._lock:
            return {rank: list(buf.rows) for rank, buf in sorted(self._step_time.items()) if buf.rows}

    def step_memory_rows(self) -> Dict[int, List[Dict[str, Any]]]:
        with self._lock:
            return {rank: list(buf.rows) for rank, buf in sorted(self._step_memory.items()) if buf.rows}

    def has_step_time_rows(self) -> bool:
        with self._lock:
            return any(buf.rows for buf in self._step_time.values())

    def latest_step_time_ts(self) -> Optional[float]:
        """The newest row's timestamp over the ranks (the freshness stamp
        the live step-time view displays)."""
        with self._lock:
            vals = [buf.rows[-1].get("timestamp") or 0.0 for buf in self._step_time.values() if buf.rows]
        return max(vals) if vals else None

    def window_build_stats(self) -> Dict[str, Dict[str, Any]]:
        """The incremental cache's build counters (empty until a columnar
        build ran with the incremental engine on) and, once the tick
        profiler saw a tick, a ``tick_profile`` entry."""
        with self._lock:
            return window_build_snapshot(self._window_caches, self.tick_profile)

    def build_step_time_window(self, max_steps: Optional[int] = None) -> Optional[StepTimeWindow]:
        """The aligned cross-rank window over the held rows: the
        incremental cache over the rings, the full columnar build under
        ``TRACEML_INCR_WINDOW=0``, and the scalar arm over the row deques
        under ``TRACEML_COLUMNAR_WINDOW=0`` or when a rank's ring is
        flagged.  All three give the same window."""
        limit = self.window_steps if max_steps is None else int(max_steps)
        with self._lock:
            if columnar_window_enabled():
                cols = {rank: buf.cols for rank, buf in self._step_time.items() if buf.rows}
                try:
                    return engine_step_time_window(cols, self._window_caches, limit)
                except ColumnarFallback:
                    pass
            rank_rows = {rank: list(buf.rows) for rank, buf in sorted(self._step_time.items()) if buf.rows}
        return build_step_time_window(rank_rows, max_steps=limit)

    def step_memory_columns(self) -> Optional[Dict[int, MemoryColumns]]:
        """rank → memory ring, or None when a rank's ring is flagged (use
        ``step_memory_rows``) or the columnar engine is off."""
        if not columnar_window_enabled():
            return None
        with self._lock:
            out: Dict[int, MemoryColumns] = {}
            for rank, buf in sorted(self._step_memory.items()):
                if not buf.rows:
                    continue
                if not buf.cols.columnar_ok:
                    return None
                out[rank] = buf.cols
            return out or None

    @staticmethod
    def _group(buf: _RankBuffer) -> Dict[Any, List[Dict[str, Any]]]:
        out: Dict[Any, List[Dict[str, Any]]] = {}
        for key, row in buf.rows:
            out.setdefault(key, []).append(row)
        return out

    def system_rows(self) -> Tuple[Dict, Dict]:
        with self._lock:
            return self._group(self._system_host), self._group(self._system_dev)

    def process_rows(self) -> Tuple[Dict, Dict]:
        with self._lock:
            return self._group(self._process), self._group(self._process_dev)

    def stdout_tail(self, n: int = 12) -> List[Tuple[str, str]]:
        with self._lock:
            rows = list(self._stdout.rows)
        return rows[-int(n):]

    def model_stats(self) -> Dict[int, Dict[str, Any]]:
        """The aggregation of ``loaders.load_model_stats``: median FLOPs
        and tokens over the recent declarations, the newest row's
        source, device kind and peak."""
        with self._lock:
            rows = list(self._model_stats.rows)
        out: Dict[int, Dict[str, Any]] = {}
        per_rank_flops: Dict[int, List[float]] = {}
        per_rank_tokens: Dict[int, List[float]] = {}
        for r in rows:
            rank = int(r["global_rank"])
            if r["flops_per_step"]:
                per_rank_flops.setdefault(rank, []).append(float(r["flops_per_step"]))
            if r["tokens_per_step"]:
                per_rank_tokens.setdefault(rank, []).append(float(r["tokens_per_step"]))
            out[rank] = {  # ascending id order → the newest row wins
                "flops_source": r["flops_source"],
                "device_kind": r["device_kind"],
                "peak_flops": r["peak_flops"],
                "device_count": r["device_count"],
            }
        for rank, vals in per_rank_flops.items():
            out[rank]["flops_per_step"] = statistics.median(vals)
        for rank, vals in per_rank_tokens.items():
            out[rank]["tokens_per_step"] = statistics.median(vals)
        return {r: v for r, v in out.items() if v.get("flops_per_step") or v.get("tokens_per_step")}

    def topology(self) -> Dict[str, Any]:
        """The source preference of ``loaders.load_topology``: the step
        time identity columns when that table exists, else process, else
        system."""
        with self._lock:
            if self._topology_cache is not None and self._topology_cache_version == self._versions["topology"]:
                return self._topology_cache
            src = next(
                (self._topology[t] for t in ("step_time_samples", "process_samples", "system_samples")
                 if t in self._tables_seen),
                None,
            )
            if src is None:
                out: Dict[str, Any] = {"mode": "unknown", "world_size": 0, "nodes": 0}
            else:
                ranks = sorted(src.ranks)
                out = {
                    "mode": "multi_node" if len(src.nodes) > 1 else "single_node",
                    "world_size": max(src.world, len(ranks)),
                    "ranks_seen": ranks,
                    "nodes": len(src.nodes),
                    "hostnames": sorted(src.hostnames),
                }
            self._topology_cache = out
            self._topology_cache_version = self._versions["topology"]
            return out

    # -- stitched rollup reads (reporting/tiers.py) ----------------------

    def has_rollups(self) -> bool:
        """Whether the database holds folded history: the gate of the
        history fragment and the final report's ``history`` block."""
        from traceml_tpu_torch.reporting import tiers

        with self._lock:
            conn = self._conn
            if conn is None:
                return False
            try:
                return tiers.has_rollups(conn)
            except sqlite3.Error:
                return False

    def stitched_series(self, source_table: str, metric: str, grain: str = "rank") -> Dict[str, List[Dict[str, Any]]]:
        """Full-run series (raw tail, 10 s and 1 m tiers) per grain key,
        cached per (rollup version, raw-domain version)."""
        from traceml_tpu_torch.reporting import tiers

        domain = source_table.replace("_samples", "")
        with self._lock:
            conn = self._conn
            if conn is None:
                return {}
            vkey = (self._versions.get("rollup", 0), self._versions.get(domain, 0))
            ckey = (source_table, metric, grain)
            hit = self._stitched_cache.get(ckey)
            if hit is not None and hit[0] == vkey:
                return hit[1]
            try:
                result = tiers.load_stitched_series(conn, source_table, metric, grain=grain)
            except sqlite3.Error as exc:
                get_error_log().warning(f"stitched read failed for {source_table}/{metric}", exc)
                return {}
            self._stitched_cache[ckey] = (vkey, result)
            return result

    def stitched_overview(self) -> Dict[str, Any]:
        """Per source, the stitched series of every served metric (the
        shape of the final report's ``history`` block); {} without
        rollups."""
        from traceml_tpu_torch.reporting import tiers

        if not self.has_rollups():
            return {}
        out: Dict[str, Any] = {}
        for source in ROLLUP_SOURCES:
            per_metric = {}
            for metric in tiers.SOURCE_METRICS.get(source, ()):
                series = self.stitched_series(source, metric)
                if series:
                    per_metric[metric] = series
            if per_metric:
                out[source.replace("_samples", "")] = per_metric
        return out

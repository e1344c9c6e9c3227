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
  rows) let ``LiveComputer`` recompute only the domains that changed.

Left out against the JAX store, with the port's queues that bring them:
the retention-trim handling (the port's writer prunes nothing yet,
ROADMAP queue 1 item 2(f)), the columnar, incremental and vector window
engines (queue 1 item 3: the windows here are built by the scalar arm,
``utils/step_time_window.py``, which the JAX package treats as the
reference), the collectives, serving and mesh-topology tables (queue 1
items 4 and 5) and the stitched rollup reads (item 2(f)).
"""

from __future__ import annotations

import json
import sqlite3
import statistics
import threading
from collections import deque
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Set, Tuple

from traceml_tpu_torch.utils.error_log import get_error_log
from traceml_tpu_torch.utils.step_time_window import StepTimeWindow, build_step_time_window

_READ_PRAGMAS = (
    "PRAGMA busy_timeout=200",
    "PRAGMA cache_size=-8192",      # 8 MiB page cache
    "PRAGMA temp_store=MEMORY",
    "PRAGMA mmap_size=134217728",   # 128 MiB, no-op where unsupported
)

# domains exposed through per-domain versions (what dirty-gating keys on)
DOMAINS = ("step_time", "step_memory", "system", "process", "stdout", "model_stats", "topology")

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
        # step_time / step_memory: per-rank bounded windows
        self._step_time: Dict[int, deque] = {}
        self._step_memory: Dict[int, deque] = {}
        # system / process / stdout / model_stats: globally bounded
        # (loader semantics); system and process rows are (key, row)
        self._system_host: deque = deque(maxlen=_SYSTEM_ROWS)
        self._system_dev: deque = deque(maxlen=_SYSTEM_ROWS)
        self._process: deque = deque(maxlen=_PROCESS_ROWS)
        self._process_dev: deque = deque(maxlen=_PROCESS_ROWS)
        self._stdout: deque = deque(maxlen=_STDOUT_ROWS)
        self._model_stats: deque = deque(maxlen=_MODEL_STATS_ROWS)
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
                buf = self._step_time[rank] = deque(maxlen=self.window_steps)
            buf.append({
                "step": r["step"],
                "timestamp": r["timestamp"],
                "clock": r["clock"],
                "late_markers": r["late_markers"],
                "events": events,
            })
        return bool(rows)

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
                buf = self._step_memory[rank] = deque(maxlen=self.memory_rows_per_rank)
            row = dict(r)
            del row["id"], row["global_rank"]
            buf.append(row)
        return bool(rows)

    def _read_keyed(self, conn, table, buf: deque, key_fn, dirty: Set[str]) -> bool:
        rows = self._fetch(conn, table, "*", "id")
        topo = self._topology.get(table)
        for r in rows:
            if topo is not None and topo.update(r["global_rank"], r["node_rank"], r["hostname"], r["world_size"]):
                dirty.add("topology")
            buf.append((key_fn(r), dict(r)))
        return bool(rows)

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
        self._stdout.extend((r["stream"], r["line"]) for r in rows)
        return bool(rows)

    def _read_model_stats(self, conn, table, dirty) -> bool:
        rows = self._fetch(conn, table, ", ".join(_MODEL_STATS_COLS), "id")
        self._model_stats.extend(dict(r) for r in rows)
        return bool(rows)

    # -- accessors (loader-shaped) --------------------------------------

    def step_time_rows(self) -> Dict[int, List[Dict[str, Any]]]:
        """global_rank → decoded step rows (``loaders.load_step_time_rows``)."""
        with self._lock:
            return {rank: list(buf) for rank, buf in sorted(self._step_time.items()) if buf}

    def step_memory_rows(self) -> Dict[int, List[Dict[str, Any]]]:
        with self._lock:
            return {rank: list(buf) for rank, buf in sorted(self._step_memory.items()) if buf}

    def has_step_time_rows(self) -> bool:
        with self._lock:
            return any(self._step_time.values())

    def latest_step_time_ts(self) -> Optional[float]:
        """The newest row's timestamp over the ranks (the freshness stamp
        the live step-time view displays)."""
        with self._lock:
            vals = [buf[-1].get("timestamp") or 0.0 for buf in self._step_time.values() if buf]
        return max(vals) if vals else None

    def build_step_time_window(self, max_steps: Optional[int] = None) -> Optional[StepTimeWindow]:
        """The aligned cross-rank window over the held rows (the scalar
        arm of the JAX store's builder)."""
        limit = self.window_steps if max_steps is None else int(max_steps)
        return build_step_time_window(self.step_time_rows(), max_steps=limit)

    @staticmethod
    def _group(buf: deque) -> Dict[Any, List[Dict[str, Any]]]:
        out: Dict[Any, List[Dict[str, Any]]] = {}
        for key, row in buf:
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
            rows = list(self._stdout)
        return rows[-int(n):]

    def model_stats(self) -> Dict[int, Dict[str, Any]]:
        """The aggregation of ``loaders.load_model_stats``: median FLOPs
        and tokens over the recent declarations, the newest row's
        source, device kind and peak."""
        with self._lock:
            rows = list(self._model_stats)
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

"""Asynchronous SQLite writer.

Counterpart of ``traceml_tpu/aggregator/sqlite_writer.py``, trimmed to
one bounded queue and a writer thread with group commit (no priority
lanes, retention prune, rollup tiers or replay dedup yet).

One dedicated thread owns the connection.  Drained envelopes coalesce
into one transaction once ``_GROUP_COMMIT_ENVS`` are pending or the
oldest has waited ``_GROUP_COMMIT_INTERVAL_S``; each (table, batch) is one
``executemany``.  A full queue drops the envelope and counts it per
domain; an envelope whose sampler has no projection writer is counted
too, never silently skipped.  ``force_flush`` is a barrier: it returns
once everything enqueued before it is committed.  ``finalize`` flushes,
checkpoints the WAL and closes.
"""

from __future__ import annotations

import queue
import sqlite3
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional

from traceml_tpu_torch.aggregator.sqlite_writers import ALL_WRITERS, writer_for
from traceml_tpu_torch.telemetry.envelope import TelemetryEnvelope
from traceml_tpu_torch.utils.error_log import get_error_log

_QUEUE_MAX = 50_000
_GROUP_COMMIT_ENVS = 512
_GROUP_COMMIT_INTERVAL_S = 0.2


class _FlushBarrier:
    __slots__ = ("event",)

    def __init__(self) -> None:
        self.event = threading.Event()


class SQLiteWriter:
    def __init__(self, db_path: Path) -> None:
        self.db_path = Path(db_path)
        self._queue: "queue.Queue[object]" = queue.Queue(maxsize=_QUEUE_MAX)
        self._thread: Optional[threading.Thread] = None
        self._stop_evt = threading.Event()
        self._finalized = threading.Event()
        self._stats_lock = threading.Lock()
        self.enqueued = 0
        self.dropped = 0
        self.written = 0
        self.commits = 0
        self._enq_by_domain: Dict[str, int] = {}
        self._drop_by_domain: Dict[str, int] = {}
        self._unknown_by_domain: Dict[str, int] = {}
        self._queue_hwm = 0

    # -- producer side (aggregator loop) --------------------------------
    def start(self) -> None:
        if self._thread is not None:
            return
        self.db_path.parent.mkdir(parents=True, exist_ok=True)
        self._thread = threading.Thread(target=self._run, name="traceml-sqlite-writer", daemon=True)
        self._thread.start()

    def ingest(self, env: TelemetryEnvelope) -> bool:
        try:
            self._queue.put_nowait(env)
        except queue.Full:
            with self._stats_lock:
                self.dropped += 1
                self._drop_by_domain[env.sampler] = self._drop_by_domain.get(env.sampler, 0) + 1
            get_error_log().warning(f"ingest queue full: dropped a {env.sampler} envelope")
            return False
        with self._stats_lock:
            self.enqueued += 1
            self._enq_by_domain[env.sampler] = self._enq_by_domain.get(env.sampler, 0) + 1
            self._queue_hwm = max(self._queue_hwm, self._queue.qsize())
        return True

    def force_flush(self, timeout: float = 10.0) -> bool:
        """Barrier: True once everything enqueued so far is committed."""
        if self._thread is None or self._finalized.is_set():
            return False
        b = _FlushBarrier()
        try:
            self._queue.put(b, timeout=timeout)
        except queue.Full:
            return False
        return b.event.wait(timeout)

    def finalize(self, timeout: float = 30.0) -> bool:
        """Flush, checkpoint, close; True when all of it finished in time."""
        if self._thread is None:
            return True
        ok = self.force_flush(timeout)
        self._stop_evt.set()
        self._thread.join(timeout=timeout)
        alive = self._thread.is_alive()
        self._thread = None
        return ok and not alive

    def stats(self) -> Dict[str, object]:
        with self._stats_lock:
            return {
                "enqueued": self.enqueued,
                "dropped": self.dropped,
                "written": self.written,
                "enqueued_by_domain": dict(self._enq_by_domain),
                "dropped_by_domain": dict(self._drop_by_domain),
                "unknown_domain_drops": dict(self._unknown_by_domain),
                "queue": {
                    "depth": self._queue.qsize(),
                    "hwm": self._queue_hwm,
                    "capacity": self._queue.maxsize,
                },
                "group_commit": {"commits": self.commits},
            }

    # -- writer thread ---------------------------------------------------
    def _connect(self) -> sqlite3.Connection:
        conn = sqlite3.connect(str(self.db_path))
        conn.execute("PRAGMA journal_mode=WAL")
        conn.execute("PRAGMA synchronous=NORMAL")
        for w in ALL_WRITERS:
            w.init_schema(conn)
        conn.commit()
        return conn

    def _run(self) -> None:
        try:
            conn = self._connect()
        except sqlite3.Error as exc:
            get_error_log().error("sqlite writer failed to open db", exc)
            self._finalized.set()
            return
        pending: List[TelemetryEnvelope] = []
        barriers: List[_FlushBarrier] = []
        pending_since: Optional[float] = None
        try:
            while True:
                if pending_since is None:
                    timeout = 0.25
                else:
                    timeout = max(0.005, _GROUP_COMMIT_INTERVAL_S - (time.monotonic() - pending_since))
                try:
                    item = self._queue.get(timeout=timeout)
                except queue.Empty:
                    item = None
                while item is not None:
                    if isinstance(item, _FlushBarrier):
                        barriers.append(item)
                    else:
                        pending.append(item)
                    try:
                        item = self._queue.get_nowait()
                    except queue.Empty:
                        item = None
                now = time.monotonic()
                if pending and pending_since is None:
                    pending_since = now
                flush_now = (
                    bool(barriers)
                    or self._stop_evt.is_set()
                    or len(pending) >= _GROUP_COMMIT_ENVS
                    or (pending_since is not None and now - pending_since >= _GROUP_COMMIT_INTERVAL_S)
                )
                if pending and flush_now:
                    self._write_batch(conn, pending)
                    pending = []
                    pending_since = None
                for b in barriers:
                    b.event.set()
                barriers = []
                if self._stop_evt.is_set() and not pending and self._queue.empty():
                    break
            conn.execute("PRAGMA wal_checkpoint(TRUNCATE)")
        except Exception as exc:
            get_error_log().error("sqlite writer thread crashed", exc)
        finally:
            conn.close()
            self._finalized.set()

    def _write_batch(self, conn: sqlite3.Connection, batch: List[TelemetryEnvelope]) -> None:
        # parameter tuples for the whole batch first, grouped by insert
        # statement: one executemany per (table, batch) in one transaction
        grouped: Dict[str, List[tuple]] = {}
        for env in batch:
            writer = writer_for(env.sampler)
            if writer is None:
                with self._stats_lock:
                    self._unknown_by_domain[env.sampler] = self._unknown_by_domain.get(env.sampler, 0) + 1
                continue
            try:
                table_rows = writer.build_rows(env)
            except Exception as exc:
                get_error_log().warning(f"projection build failed for {env.sampler}", exc)
                continue
            for table, rows in table_rows.items():
                if rows:
                    grouped.setdefault(writer.insert_sql(table), []).extend(rows)
        try:
            with conn:  # one transaction: commit, or roll back on error
                for sql, rows in grouped.items():
                    conn.executemany(sql, rows)
        except sqlite3.Error as exc:
            get_error_log().warning("sqlite batch write failed", exc)
            return
        with self._stats_lock:
            self.written += sum(len(rows) for rows in grouped.values())
            self.commits += 1

"""Asynchronous SQLite writer.

Counterpart of ``traceml_tpu/aggregator/sqlite_writer.py``, trimmed to
one bounded queue (no priority lanes) and a writer thread with group
commit and watermark retention.

One dedicated thread owns the connection.  Drained envelopes coalesce
into one transaction once ``_GROUP_COMMIT_ENVS`` are pending or the
oldest has waited ``_GROUP_COMMIT_INTERVAL_S``; each (table, batch) is one
``executemany``.  A full queue drops the envelope and counts it per
domain; an envelope whose sampler has no projection writer is counted
too, never silently skipped.  ``force_flush`` is a barrier: it returns
once everything enqueued before it is committed.  ``settled_envelopes()``
counts the envelopes resolved for good, as in JAX: each batch written
(committed, dropped as a duplicate or unknown, or lost to a failed
transaction; none is retried) and each envelope the full queue shed.  The
aggregator advances the shm rings' tails only up to what it reports.  ``finalize`` flushes,
checkpoints the WAL and closes.

Replay dedup, as in JAX: the ``rank_seq`` table holds the highest
committed ``seq`` per (session, rank, lane), where the lane is the JAX
writer's priority lane of the envelope's sampler (``PRIORITY_NAMES[
ingest_priority(sampler)]``), so the table equals the JAX one on the
same stream although this writer drains one queue.  An envelope whose
``seq`` is at or below its lane's maximum is a replay of rows already
stored (a rank's spool re-sends what a dead aggregator may not have
committed) and is dropped and counted in ``replay_duplicates``, a
duplicate inside the same batch too; an envelope without a ``seq``
bypasses dedup.  The new maxima commit in the same transaction as the
rows they cover, and the in-memory maxima advance only after that
commit.  On open (a restarted aggregator reopening the session's
database, its WAL possibly never checkpointed: SQLite recovers it) the
maxima are seeded from the table.

Watermark retention, as in JAX: ``retention = int(summary_window_rows x
1.5)`` rows per ``(table, session_id, global_rank)`` partition of every
table a projection writer lists in ``RETENTION_TABLES``.  The writer
counts each partition's rows from its own inserts (seeded by a
``GROUP BY`` on open); once one holds ``retention + slack`` rows (slack
``max(256, retention)``) it is queued, and each batch transaction
prunes at most ``_PRUNE_PARTITIONS_PER_SLICE`` queued partitions: the
watermark is the id of the (retention + 1)-th newest row, and every row
at or below it is first folded into the rollup tiers
(``aggregator/rollup.py``; ``rollup_samples_10s``/``_1m``), then
deleted, and the prune is journaled in ``retention_watermarks``, all in
the batch's transaction with its rows and the ``rank_seq`` maxima: a
crash leaves every row raw or rolled up, never neither.  The live
snapshot store reads the journal to evict exactly the deleted rows.
``finalize()`` drains, prunes every partition to exactly ``retention``
rows, checkpoints the WAL and closes; ``stats()["prune"]`` and
``stats()["rollup"]`` report the prunes and folds.
"""

from __future__ import annotations

import queue
import sqlite3
import threading
import time
from collections import deque
from pathlib import Path
from typing import Deque, Dict, List, Optional, Tuple

from traceml_tpu_torch.aggregator import rollup
from traceml_tpu_torch.aggregator.sqlite_writers import ALL_WRITERS, writer_for
from traceml_tpu_torch.telemetry.envelope import TelemetryEnvelope
from traceml_tpu_torch.utils.error_log import get_error_log

_QUEUE_MAX = 50_000
_GROUP_COMMIT_ENVS = 512
_GROUP_COMMIT_INTERVAL_S = 0.2

# the JAX writer's lanes: the samplers whose rows drive diagnosis are
# "high", everything else "low"; here they only key the dedup table
HIGH_PRIORITY_SAMPLERS = frozenset({"step_time", "step_memory", "collectives", "serving"})
PRIORITY_NAMES = ("high", "low")

# per (session, rank, lane) max committed seq (replay dedup)
RANK_SEQ_TABLE = "rank_seq"

# retention: the journal of prunes, the partitions pruned per batch
# transaction, and the journal's own bound
WATERMARK_TABLE = "retention_watermarks"
_PRUNE_PARTITIONS_PER_SLICE = 8
_JOURNAL_MAX_ROWS = 4096


def _p99(values: Deque[float]) -> Optional[float]:
    if not values:
        return None
    s = sorted(values)
    return s[min(len(s) - 1, int(len(s) * 0.99))]


def ingest_priority(sampler: str) -> int:
    return 0 if sampler in HIGH_PRIORITY_SAMPLERS else 1


class _FlushBarrier:
    __slots__ = ("event",)

    def __init__(self) -> None:
        self.event = threading.Event()


class SQLiteWriter:
    def __init__(
        self,
        db_path: Path,
        summary_window_rows: int = 10_000,
        retention_factor: float = 1.5,
    ) -> None:
        self.db_path = Path(db_path)
        self._retention_rows = int(summary_window_rows * retention_factor)
        # hysteresis: a partition is pruned online once it overflows
        # retention by this slack, so a steady trickle does not prune a
        # row per batch; finalize() trims every partition to retention
        self._prune_slack = max(256, self._retention_rows)
        self._queue: "queue.Queue[object]" = queue.Queue(maxsize=_QUEUE_MAX)
        self._thread: Optional[threading.Thread] = None
        self._stop_evt = threading.Event()
        self._finalized = threading.Event()
        self._stats_lock = threading.Lock()
        self.enqueued = 0
        self.dropped = 0
        self.written = 0
        self.commits = 0
        self._settled = 0
        self._enq_by_domain: Dict[str, int] = {}
        self._drop_by_domain: Dict[str, int] = {}
        self._unknown_by_domain: Dict[str, int] = {}
        self._queue_hwm = 0
        # (session_id, global_rank, lane) -> committed max seq; the
        # writer thread's alone, seeded from rank_seq on open
        self._seq_max: Dict[Tuple[str, int, str], int] = {}
        self.replay_duplicates = 0
        # retention bookkeeping (the writer thread's alone)
        self._part_counts: Dict[Tuple[str, str, int], int] = {}
        self._prune_due: Deque[Tuple[str, str, int]] = deque()
        self._prune_due_set: set = set()
        self._retention_tables = frozenset(t for w in ALL_WRITERS for t in w.RETENTION_TABLES)
        self._journal_rows = 0
        self._prune_lat_ms: Deque[float] = deque(maxlen=512)
        self._prune_max_ms = 0.0
        self.prunes = 0
        self.rows_pruned = 0
        # the rollup tiers (None under TRACEML_ROLLUP=0: prunes discard)
        self._rollup = rollup.build_engine()

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
                self._settled += 1  # shed: it will never be written
                self._drop_by_domain[env.sampler] = self._drop_by_domain.get(env.sampler, 0) + 1
            get_error_log().warning(f"ingest queue full: dropped a {env.sampler} envelope")
            return False
        with self._stats_lock:
            self.enqueued += 1
            self._enq_by_domain[env.sampler] = self._enq_by_domain.get(env.sampler, 0) + 1
            self._queue_hwm = max(self._queue_hwm, self._queue.qsize())
        return True

    def settled_envelopes(self) -> int:
        """Envelopes resolved for good: every batch written and every queue
        shed.  Monotonic; safe to read from any thread."""
        with self._stats_lock:
            return self._settled

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
                "replay_duplicates": self.replay_duplicates,
                "queue": {
                    "depth": self._queue.qsize(),
                    "hwm": self._queue_hwm,
                    "capacity": self._queue.maxsize,
                },
                "group_commit": {"commits": self.commits},
                "prune": {
                    "prunes": self.prunes,
                    "rows_pruned": self.rows_pruned,
                    "partitions_tracked": len(self._part_counts),
                    "partitions_due": len(self._prune_due),
                    "prune_p99_ms": _p99(self._prune_lat_ms),
                    "prune_max_ms": round(self._prune_max_ms, 3),
                    "retention_rows": self._retention_rows,
                },
                "rollup": self._rollup.stats() if self._rollup is not None else {"enabled": False},
            }

    # -- writer thread ---------------------------------------------------
    def _connect(self) -> sqlite3.Connection:
        conn = sqlite3.connect(str(self.db_path))
        conn.execute("PRAGMA journal_mode=WAL")
        conn.execute("PRAGMA synchronous=NORMAL")
        for w in ALL_WRITERS:
            w.init_schema(conn)
        conn.execute(
            f"""CREATE TABLE IF NOT EXISTS {WATERMARK_TABLE} (
                id INTEGER PRIMARY KEY AUTOINCREMENT,
                table_name TEXT,
                session_id TEXT,
                global_rank INTEGER,
                watermark_id INTEGER,
                deleted_rows INTEGER,
                ts REAL
            )"""
        )
        conn.execute(
            f"""CREATE TABLE IF NOT EXISTS {RANK_SEQ_TABLE} (
                session_id TEXT,
                global_rank INTEGER,
                lane TEXT,
                max_seq INTEGER,
                PRIMARY KEY (session_id, global_rank, lane)
            )"""
        )
        for table in sorted(self._retention_tables):
            # the watermark SELECT and the range DELETE need a
            # (session_id, global_rank) index prefix; only tables without
            # one (stdout, model_stats) get a new index, as in JAX
            if not self._has_partition_index(conn, table):
                conn.execute(
                    f"CREATE INDEX IF NOT EXISTS idx_{table}_retention ON {table} (session_id, global_rank)"
                )
        if self._rollup is not None:
            self._rollup.init_schema(conn)
        conn.commit()
        self._seed_partition_counts(conn)
        self._seed_seq_max(conn)
        return conn

    @staticmethod
    def _has_partition_index(conn: sqlite3.Connection, table: str) -> bool:
        for idx in conn.execute(f"PRAGMA index_list({table})").fetchall():
            cols = [r[2] for r in conn.execute(f"PRAGMA index_info({idx[1]})")]
            if cols[:2] == ["session_id", "global_rank"]:
                return True
        return False

    def _seed_partition_counts(self, conn: sqlite3.Connection) -> None:
        """A reopened database: learn each partition's row count once, so
        retention stays O(new rows) from the first batch."""
        for table in self._retention_tables:
            try:
                rows = conn.execute(
                    f"SELECT session_id, global_rank, COUNT(*) FROM {table} GROUP BY session_id, global_rank"
                ).fetchall()
            except sqlite3.Error:
                continue
            for session_id, rank, n in rows:
                key = (table, str(session_id), int(rank))
                self._part_counts[key] = int(n)
                self._note_overflow(key, int(n))

    def _note_overflow(self, key: Tuple[str, str, int], count: int) -> None:
        if count >= self._retention_rows + self._prune_slack and key not in self._prune_due_set:
            self._prune_due_set.add(key)
            self._prune_due.append(key)

    def _seed_seq_max(self, conn: sqlite3.Connection) -> None:
        """Crash-resume: reload the committed per-lane maxima, so a
        restarted aggregator drops the ranks' replay of everything its
        previous incarnation committed."""
        try:
            rows = conn.execute(
                f"SELECT session_id, global_rank, lane, max_seq FROM {RANK_SEQ_TABLE}"
            ).fetchall()
        except sqlite3.Error:
            return
        for session_id, rank, lane, mx in rows:
            self._seq_max[(str(session_id), int(rank), str(lane))] = int(mx)

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
                    try:
                        self._write_batch(conn, pending)
                    finally:
                        # resolved either way: nothing in a batch is retried
                        with self._stats_lock:
                            self._settled += len(pending)
                    pending = []
                    pending_since = None
                for b in barriers:
                    b.event.set()
                barriers = []
                if self._stop_evt.is_set() and not pending and self._queue.empty():
                    break
            self._prune_all(conn)
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
        touched: Dict[Tuple[str, str, int], int] = {}
        seq_touched: Dict[Tuple[str, int, str], int] = {}
        duplicates = 0
        for env in batch:
            seq = env.seq
            if seq is not None:
                # seq_touched covers a duplicate inside this batch (the
                # original and its replay drained together)
                skey = (
                    str(env.meta.get("session_id", "unknown")),
                    env.global_rank,
                    PRIORITY_NAMES[ingest_priority(env.sampler)],
                )
                if seq <= seq_touched.get(skey, self._seq_max.get(skey, -1)):
                    duplicates += 1
                    continue
                seq_touched[skey] = seq
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
                if not rows:
                    continue
                grouped.setdefault(writer.insert_sql(table), []).extend(rows)
                if table in self._retention_tables:
                    # the rows of one envelope share (session_id,
                    # global_rank), the first two columns of every row
                    key = (table, rows[0][0], rows[0][1])
                    touched[key] = touched.get(key, 0) + len(rows)
        if duplicates:
            with self._stats_lock:
                self.replay_duplicates += duplicates
        try:
            with conn:  # one transaction: commit, or roll back on error
                for sql, rows in grouped.items():
                    conn.executemany(sql, rows)
                if seq_touched:
                    # the maxima commit with the rows they cover: a crash
                    # between the two cannot drop a replay never stored
                    conn.executemany(
                        f"INSERT OR REPLACE INTO {RANK_SEQ_TABLE}"
                        " (session_id, global_rank, lane, max_seq) VALUES (?,?,?,?)",
                        [(k[0], k[1], k[2], mx) for k, mx in seq_touched.items()],
                    )
                for key, n in touched.items():
                    count = self._part_counts.get(key, 0) + n
                    self._part_counts[key] = count
                    self._note_overflow(key, count)
                # the retention prune rides this transaction: its fold,
                # delete and journal row commit with the rows above
                self._prune_slice(conn)
        except sqlite3.Error as exc:
            get_error_log().warning("sqlite batch write failed", exc)
            return
        # only after the commit: on a rollback the rows are gone, so
        # their replay must pass
        self._seq_max.update(seq_touched)
        with self._stats_lock:
            self.written += sum(len(rows) for rows in grouped.values())
            self.commits += 1

    # -- retention (O(new) watermark deletes) ----------------------------
    def _prune_slice(self, conn: sqlite3.Connection) -> int:
        """Prune at most ``_PRUNE_PARTITIONS_PER_SLICE`` due partitions inside the
        caller's open transaction (the rest wait for the next batch)."""
        pruned = 0
        for _ in range(min(_PRUNE_PARTITIONS_PER_SLICE, len(self._prune_due))):
            key = self._prune_due.popleft()
            self._prune_due_set.discard(key)
            pruned += self._prune_partition(conn, key)
        return pruned

    def _prune_all(self, conn: sqlite3.Connection) -> None:
        """Finalize: trim EVERY partition holding more than ``retention``
        rows, not just those past the slack."""
        self._prune_due.clear()
        self._prune_due_set.clear()
        for key, count in list(self._part_counts.items()):
            if count > self._retention_rows:
                self._prune_partition(conn, key)
        try:
            conn.commit()
        except sqlite3.Error as exc:
            get_error_log().warning("final prune commit failed", exc)

    def _prune_partition(self, conn: sqlite3.Connection, key: Tuple[str, str, int]) -> int:
        """Fold, delete and journal one partition's overflow: the rows at
        or below the id of its (retention + 1)-th newest row."""
        table, session_id, rank = key
        t0 = time.perf_counter()
        try:
            row = conn.execute(
                f"SELECT id FROM {table} WHERE session_id=? AND global_rank=? ORDER BY id DESC LIMIT 1 OFFSET ?",
                (session_id, rank, self._retention_rows),
            ).fetchone()
            if row is None:
                # fewer rows than retention: the count was stale; clamp it
                self._part_counts[key] = self._retention_rows
                return 0
            watermark = int(row[0])
            # fold BEFORE the delete, in this transaction.  A failed fold
            # degrades to a plain prune: its partial upserts cover only
            # doomed rows, while a retried fold would count them twice
            if self._rollup is not None and table in self._rollup.sources:
                try:
                    self._rollup.fold_doomed(conn, table, session_id, rank, watermark)
                except Exception as exc:
                    get_error_log().warning(f"rollup fold failed for {table}", exc)
            cur = conn.execute(
                f"DELETE FROM {table} WHERE session_id=? AND global_rank=? AND id <= ?",
                (session_id, rank, watermark),
            )
            deleted = cur.rowcount if cur.rowcount is not None else 0
            conn.execute(
                f"INSERT INTO {WATERMARK_TABLE} (table_name, session_id, global_rank, watermark_id,"
                " deleted_rows, ts) VALUES (?,?,?,?,?,?)",
                (table, session_id, rank, watermark, deleted, time.time()),
            )
        except sqlite3.Error as exc:
            get_error_log().warning(f"prune failed for {table}", exc)
            return 0
        self._part_counts[key] = self._retention_rows
        self.prunes += 1
        self.rows_pruned += deleted
        lat = (time.perf_counter() - t0) * 1000.0
        self._prune_lat_ms.append(lat)
        self._prune_max_ms = max(self._prune_max_ms, lat)
        self._journal_rows += 1
        if self._journal_rows >= _JOURNAL_MAX_ROWS:
            self._trim_journal(conn)
        return deleted

    def _trim_journal(self, conn: sqlite3.Connection) -> None:
        """Keep the journal bounded: readers' cursors only move forward,
        so deleting old journal rows is invisible to them."""
        try:
            row = conn.execute(f"SELECT MAX(id) FROM {WATERMARK_TABLE}").fetchone()
            if row and row[0]:
                conn.execute(f"DELETE FROM {WATERMARK_TABLE} WHERE id <= ?",
                             (int(row[0]) - _JOURNAL_MAX_ROWS // 2,))
            self._journal_rows = 0
        except sqlite3.Error as exc:
            get_error_log().warning("journal trim failed", exc)

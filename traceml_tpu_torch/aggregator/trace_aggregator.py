"""The aggregator.

Counterpart of ``traceml_tpu/aggregator/trace_aggregator.py`` for the
summary mode over TCP (no display drivers, session registry, liveness
tracker, shm rings or summary service yet).

Owns the TCP ingest server and the SQLite writer.  Its loop blocks on
``wait_for_data``, decodes frames on its own thread, hands telemetry
envelopes to the writer and handles the control messages inline:
``rank_finished`` (the end-of-run barrier), ``rank_heartbeat`` and
``producer_stats`` (kept latest-per-rank).  Every few seconds, and once
at the end, it writes ``ingest_stats.json``.

``stop()`` settles the end of the run (drains until every expected rank
sent ``rank_finished`` or the deadline passes, else writes
``finalization_warning.json`` naming the missing ranks), finalizes the
SQLite writer and generates ``final_summary.json``/``.txt``.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Any, Dict, Optional, Set

from traceml_tpu_torch.aggregator.sqlite_writer import SQLiteWriter
from traceml_tpu_torch.runtime.settings import TraceMLSettings
from traceml_tpu_torch.telemetry.control import (
    PRODUCER_STATS,
    RANK_FINISHED,
    RANK_HEARTBEAT,
    control_kind,
    is_control_message,
)
from traceml_tpu_torch.telemetry.envelope import normalize_telemetry_envelope
from traceml_tpu_torch.transport.tcp_transport import TCPServer
from traceml_tpu_torch.utils.atomic_io import atomic_write_json
from traceml_tpu_torch.utils.error_log import get_error_log

_WAIT_S = 0.5
_SETTLE_POLL = 0.1
_STATS_INTERVAL_S = 5.0
# frames decoded per drain slice: a backlog burst is worked off in
# bounded slices
_DRAIN_BATCH_FRAMES = 512


def _meta_rank(payload: Dict[str, Any]) -> Optional[int]:
    meta = payload.get("meta") or {}
    try:
        return int(meta.get("global_rank", meta.get("rank")))
    except (TypeError, ValueError):
        return None


class TraceMLAggregator:
    def __init__(self, settings: TraceMLSettings) -> None:
        self.settings = settings
        self.server = TCPServer(host=settings.aggregator.bind_host, port=settings.aggregator.port)
        self.db_path = settings.session_dir / "telemetry.sqlite"
        self.writer = SQLiteWriter(self.db_path)
        self._thread: Optional[threading.Thread] = None
        self._stop_evt = threading.Event()
        # the loop and stop()'s settle both drain: one at a time, so
        # frames reach the writer in arrival order
        self._drain_lock = threading.Lock()
        self._finished_ranks: Set[int] = set()
        self._seen_ranks: Set[int] = set()
        self._producer_stats: Dict[int, Dict[str, Any]] = {}
        self._last_drain_frames = 0
        self._last_stats_write = 0.0
        self.envelopes_ingested = 0
        self.started = False
        self.port: Optional[int] = None

    # -- lifecycle -------------------------------------------------------
    def start(self) -> None:
        if self.started:
            return
        self.started = True
        self.settings.session_dir.mkdir(parents=True, exist_ok=True)
        self.server.start()
        self.port = self.server.port
        self.writer.start()
        self._stop_evt.clear()
        self._thread = threading.Thread(target=self._loop, name="traceml-aggregator", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        if not self.started:
            return
        self.started = False
        deadline = time.monotonic() + max(1.0, self.settings.finalize_timeout_sec)
        self._stop_evt.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
        try:
            self._settle_end_of_run(deadline)
        except Exception as exc:
            get_error_log().warning("end-of-run settle failed", exc)
        self.server.stop()
        if not self.writer.finalize(timeout=max(5.0, deadline - time.monotonic())):
            get_error_log().warning("sqlite finalize incomplete within budget")
        try:
            self._write_ingest_stats(final=True)
        except OSError as exc:
            get_error_log().warning("ingest stats write failed", exc)
        try:
            ok = self.generate_final_summary()
            error = None if ok else "final summary generation failed"
        except Exception as exc:
            get_error_log().error("final summary at shutdown failed", exc)
            error = str(exc)
        if error is not None:
            atomic_write_json(
                self.settings.session_dir / "finalization_error.json",
                {"error": error, "ts": time.time()},
            )

    # -- ingest ----------------------------------------------------------
    def _drain_once(self) -> int:
        with self._drain_lock:
            frames = self.server.drain_tagged(_DRAIN_BATCH_FRAMES)
            self._last_drain_frames = len(frames)
            n = 0
            for p in self.server.decode_tagged(frames) if frames else ():
                if is_control_message(p):
                    self._handle_control(p)
                    continue
                env = normalize_telemetry_envelope(p)
                if env is None:
                    continue
                self._seen_ranks.add(env.global_rank)
                self.writer.ingest(env)
                n += 1
            self.envelopes_ingested += n
        return n

    def _drain_all(self) -> int:
        total = self._drain_once()
        while self._last_drain_frames >= _DRAIN_BATCH_FRAMES:
            total += self._drain_once()
        return total

    def _handle_control(self, payload: Dict[str, Any]) -> None:
        kind = control_kind(payload)
        rank = _meta_rank(payload)
        if rank is None:
            # a garbled marker must not default to rank 0: that would
            # settle rank 0 with its telemetry still in flight
            get_error_log().warning(f"{kind} without a valid global_rank; dropped")
            return
        self._seen_ranks.add(rank)
        if kind == RANK_FINISHED:
            self._finished_ranks.add(rank)
        elif kind == PRODUCER_STATS and isinstance(payload.get("stats"), dict):
            # snapshots are cumulative: keep the latest
            self._producer_stats[rank] = payload["stats"]
        elif kind != RANK_HEARTBEAT:
            get_error_log().warning(f"unknown control message {kind!r}; dropped")

    def _write_ingest_stats(self, final: bool = False) -> None:
        w = self.writer.stats()
        atomic_write_json(
            self.settings.session_dir / "ingest_stats.json",
            {
                "envelopes_ingested": self.envelopes_ingested,
                "frames_received": self.server.frames_received,
                "decode_errors": self.server.decode_errors,
                "corrupt_frame_drops": dict(self.server.corrupt_frame_drops),
                "pending_frames_hwm": self.server.pending_hwm,
                "rows_written": w["written"],
                "rows_enqueued": w["enqueued"],
                "rows_dropped": w["dropped"],
                "enqueued_by_domain": w["enqueued_by_domain"],
                "dropped_by_domain": w["dropped_by_domain"],
                "unknown_domain_drops": w["unknown_domain_drops"],
                "queues": w["queue"],
                "group_commit": w["group_commit"],
                "finished_ranks": sorted(self._finished_ranks),
                "producers": {str(r): s for r, s in sorted(self._producer_stats.items())},
                "final": final,
                "ts": time.time(),
            },
        )

    def _loop(self) -> None:
        while not self._stop_evt.is_set():
            try:
                self.server.wait_for_data(_WAIT_S)
                self._drain_all()
                now = time.monotonic()
                if now - self._last_stats_write >= _STATS_INTERVAL_S:
                    self._last_stats_write = now
                    self._write_ingest_stats()
            except Exception as exc:  # keep the loop alive
                get_error_log().warning("aggregator loop error", exc)
                time.sleep(0.1)

    # -- settle / finalize ------------------------------------------------
    def expected_world_size(self) -> int:
        if self.settings.expected_world_size:
            return self.settings.expected_world_size
        return max(len(self._seen_ranks), 1)

    def _settle_end_of_run(self, deadline: float) -> None:
        """Drain until every expected rank sent ``rank_finished`` or the
        deadline passes; then commit everything drained."""
        expected = self.expected_world_size()
        while time.monotonic() < deadline:
            self._drain_all()
            if len(self._finished_ranks) >= expected:
                break
            time.sleep(_SETTLE_POLL)
        self._drain_all()
        self.writer.force_flush(timeout=max(1.0, deadline - time.monotonic()))
        missing = sorted(set(range(expected)) - self._finished_ranks)
        if missing:
            atomic_write_json(
                self.settings.session_dir / "finalization_warning.json",
                {
                    "missing_ranks": missing,
                    "finished_ranks": sorted(self._finished_ranks),
                    "expected_world_size": expected,
                    "ts": time.time(),
                },
            )

    def generate_final_summary(self) -> bool:
        from traceml_tpu_torch.reporting.final import generate_summary

        return generate_summary(
            db_path=self.db_path, session_dir=self.settings.session_dir, settings=self.settings
        )


def write_ready_file(settings: TraceMLSettings, port: int) -> None:
    """The launcher polls this file for the bound (ephemeral) port."""
    atomic_write_json(
        settings.session_dir / "aggregator_ready.json",
        {"port": port, "pid": os.getpid(), "ts": time.time()},
    )

"""The aggregator.

Counterpart of ``traceml_tpu/aggregator/trace_aggregator.py`` for the
``summary``, ``cli`` and ``dashboard`` modes on one node (no session
registry).

Ingest rides the transport tier (``transport/select.py``
``server_transport_config``): unless ``TRACEML_TRANSPORT=tcp``, the
server also listens on the session's Unix socket and polls the ranks'
shared-memory rings (a ``ShmRingRegistry``) on its 50 ms tick.  A ring's
tail advances only once the SQLite writer has settled the envelopes its
frames carried: each drain pairs the ring cursors the server had read
with the shm frames it actually took, and after ingest queues them
against ``envelopes_ingested``; ``_commit_rings`` (each loop tick and
after each flush) commits the cursors whose count the writer's
``settled_envelopes()`` has reached.  So a killed aggregator's unsettled
window stays in the ring for its restarted incarnation, and the writer
drops the repeats by ``seq``.  Each rank's ``transport_hello`` (kind,
codec, fallback) and the server's frames by path, decompression counters
and ring health go to ``ingest_stats.json`` under ``transports``.

Crash-resume, as in JAX: an aggregator the launcher restarts after a
crash binds the same port (``TRACEML_AGGREGATOR_PORT``, pinned by the
launcher) and reopens the session's database, where the SQLite writer
re-seeds its seq-dedup maxima; ``start()`` restores what lived only in
the dead incarnation's memory (the finished and seen ranks and their
liveness history) from the last ``rank_status.json`` of the same
session.  Each drained payload is the ``aggregator.ingest`` chaos point
(``dev/chaos.py``).

Owns the ingest server, the SQLite writer, the rank liveness tracker,
the final-summary service and the display driver of the mode (the live
Rich display in ``cli``, the browser dashboard's HTTP server in
``dashboard``, none in ``summary``).  Its loop blocks on
``wait_for_data``, decodes frames on its own thread, hands telemetry
envelopes to the writer and handles the control messages inline: ``rank_finished`` (the
end-of-run barrier), ``rank_heartbeat``, ``producer_stats`` and
``transport_hello`` (both kept latest-per-rank).  Every envelope and control message feeds the
liveness tracker (a ``step_time`` envelope is step progress).  Every
few seconds, and once at the end, it writes ``ingest_stats.json`` and
``rank_status.json``.  Every 0.5 s (the JAX render interval) the loop
polls the summary service, which answers a rank's ``final_summary()``
request, and ticks the display driver; a tick that raises is logged and
never stops ingest.

``stop()`` settles the end of the run (drains until every expected rank
sent ``rank_finished`` or the deadline passes, else writes
``finalization_warning.json`` naming the missing ranks and their
liveness states), draws the display's last frame from everything
committed and stops it, finalizes the SQLite writer and generates
``final_summary.json``/``.txt``.  The liveness states are written as
they stand at settle-end: a rank killed mid-run reads LOST only if the
settle window outlasts ``TRACEML_LIVENESS_LOST_SEC``.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Any, Deque, Dict, Optional, Set, Tuple

from traceml_tpu_torch.aggregator.display_drivers import resolve_display_driver
from traceml_tpu_torch.aggregator.liveness import RankLivenessTracker
from traceml_tpu_torch.aggregator.sqlite_writer import SQLiteWriter
from traceml_tpu_torch.aggregator.summary_service import FinalSummaryService
from traceml_tpu_torch.dev import chaos
from traceml_tpu_torch.runtime.settings import TraceMLSettings
from traceml_tpu_torch.telemetry.control import (
    PRODUCER_STATS,
    RANK_FINISHED,
    RANK_HEARTBEAT,
    TRANSPORT_HELLO,
    control_kind,
    is_control_message,
)
from traceml_tpu_torch.telemetry.envelope import normalize_telemetry_envelope
from traceml_tpu_torch.transport.select import server_transport_config
from traceml_tpu_torch.transport.shm_ring import ShmRingRegistry
from traceml_tpu_torch.transport.tcp_transport import TCPServer
from traceml_tpu_torch.utils.atomic_io import atomic_write_json
from traceml_tpu_torch.utils.error_log import get_error_log

_RENDER_INTERVAL = 0.5
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
        transport_cfg = server_transport_config(settings)
        self.server = TCPServer(host=settings.aggregator.bind_host, port=settings.aggregator.port,
                                uds_path=transport_cfg["uds_path"])
        self.ring_registry: Optional[ShmRingRegistry] = None
        if transport_cfg["enable_rings"]:
            self.ring_registry = ShmRingRegistry(settings.session_dir)
            self.server.attach_ring_registry(self.ring_registry)
        self.db_path = settings.session_dir / "telemetry.sqlite"
        self.writer = SQLiteWriter(self.db_path, summary_window_rows=settings.summary_window_rows)
        self._thread: Optional[threading.Thread] = None
        self._stop_evt = threading.Event()
        # the loop and stop()'s settle both drain: one at a time, so
        # frames reach the writer in arrival order
        self._drain_lock = threading.Lock()
        self._finished_ranks: Set[int] = set()
        self._seen_ranks: Set[int] = set()
        self._producer_stats: Dict[int, Dict[str, Any]] = {}
        self._transport_hellos: Dict[int, Dict[str, Any]] = {}
        # shm frames taken from the server so far, and the (envelopes
        # ingested, ring cursors) watermarks waiting for the writer to
        # settle that many envelopes; both under _drain_lock
        self._shm_frames_drained = 0
        self._ring_watermarks: Deque[Tuple[int, Dict[str, int]]] = deque()
        self.display = resolve_display_driver(settings.mode)
        self.liveness = RankLivenessTracker()
        self.summary_service = FinalSummaryService(
            settings, generate=self.generate_final_summary, settle=self.settle_telemetry
        )
        self._last_drain_frames = 0
        self._last_ui_tick = 0.0
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
        self._reseed_from_prior_run()
        self.server.start()
        self.port = self.server.port
        self.writer.start()
        try:
            self.display.start(self)
        except Exception as exc:
            get_error_log().warning("display start failed", exc)
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
        try:
            # the last frame holds every committed row and the ranks'
            # settled liveness states
            self._write_rank_status()
            self.display.tick(self)
        except Exception as exc:
            get_error_log().warning("display tick failed", exc)
        try:
            self.display.stop()
        except Exception as exc:
            get_error_log().warning("display stop failed", exc)
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

    def _reseed_from_prior_run(self) -> None:
        """Crash-resume: a restarted aggregator (same session dir) picks
        up where its predecessor left off.  The SQLite writer re-seeds its
        seq-dedup maxima from the reopened database; here the finished
        and seen ranks and their liveness history come back from the
        last ``rank_status.json``, unless it belongs to another session."""
        path = self.settings.session_dir / "rank_status.json"
        if not path.exists():
            return
        try:
            snap = json.loads(path.read_text())
        except (OSError, ValueError) as exc:
            get_error_log().warning("rank_status reseed failed", exc)
            return
        if snap.get("session_id") not in (None, self.settings.session_id):
            return  # a stale file from another session sharing the dir
        self.liveness.seed(snap)
        ranks = snap.get("ranks")
        if isinstance(ranks, dict):
            for rank_s, info in ranks.items():
                try:
                    rank = int(rank_s)
                except (TypeError, ValueError):
                    continue
                self._seen_ranks.add(rank)
                if isinstance(info, dict) and info.get("finished"):
                    self._finished_ranks.add(rank)

    # -- ingest ----------------------------------------------------------
    def _drain_once(self) -> int:
        with self._drain_lock:
            frames = self.server.drain_tagged(_DRAIN_BATCH_FRAMES)
            self._last_drain_frames = len(frames)
            cursors = None
            if self.ring_registry is not None and frames:
                shm_n = sum(1 for tag, _ in frames if tag.startswith("shm:"))
                if shm_n:
                    self._shm_frames_drained += shm_n
                    # the newest ring-cursor snapshot these frames (and
                    # the earlier slices') fully cover
                    cursors = self.ring_registry.take_marks(self._shm_frames_drained)
            n = 0
            for p in self.server.decode_tagged(frames) if frames else ():
                if chaos.active():
                    chaos.fire("aggregator.ingest")  # a kill9 rule ends the process here
                if is_control_message(p):
                    self._handle_control(p)
                    continue
                env = normalize_telemetry_envelope(p)
                if env is None:
                    continue
                self._seen_ranks.add(env.global_rank)
                self.liveness.observe(env.global_rank, progress=env.sampler == "step_time")
                self.writer.ingest(env)
                n += 1
            self.envelopes_ingested += n
            if cursors:
                # every envelope those cursors cover is ingested now
                self._ring_watermarks.append((self.envelopes_ingested, cursors))
        return n

    def _commit_rings(self) -> None:
        """Advance the rings' tails to the newest cursors whose envelopes
        the writer has settled."""
        if self.ring_registry is None:
            return
        cursors = None
        with self._drain_lock:
            if not self._ring_watermarks:
                return
            settled = self.writer.settled_envelopes()
            while self._ring_watermarks and self._ring_watermarks[0][0] <= settled:
                cursors = self._ring_watermarks.popleft()[1]
        if cursors:
            self.ring_registry.commit(cursors)

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
            self.liveness.mark_finished(rank)
            return
        self.liveness.observe(rank)
        if kind == PRODUCER_STATS and isinstance(payload.get("stats"), dict):
            # snapshots are cumulative: keep the latest
            self._producer_stats[rank] = payload["stats"]
        elif kind == TRANSPORT_HELLO:
            # latest wins: a restarted rank may announce another tier
            hello = {"transport": payload.get("transport"), "compression": payload.get("compression")}
            if payload.get("fallback_from"):
                hello["fallback_from"] = payload["fallback_from"]
            self._transport_hellos[rank] = hello
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
                "replay_duplicates": w["replay_duplicates"],
                "queues": w["queue"],
                "group_commit": w["group_commit"],
                "prune": w["prune"],
                "rollup": w["rollup"],
                "finished_ranks": sorted(self._finished_ranks),
                "producers": {str(r): s for r, s in sorted(self._producer_stats.items())},
                "transports": self._transport_stats(),
                "final": final,
                "ts": time.time(),
            },
        )
        self._write_rank_status()

    def _transport_stats(self) -> Dict[str, Any]:
        """Frames by arrival path, the decompression counters, each rank's
        announced (kind, codec) and, with rings, the registry's health."""
        out: Dict[str, Any] = {
            "frames_by_kind": dict(self.server.frames_by_transport),
            "compression": {
                "envelopes": self.server.compressed_envelopes,
                "bytes_in": self.server.compressed_bytes_in,
                "bytes_decoded": self.server.decompressed_bytes,
                "errors": self.server.decompress_errors,
            },
            "ranks": {str(r): h for r, h in sorted(self._transport_hellos.items())},
        }
        if self.ring_registry is not None:
            out["shm"] = self.ring_registry.stats()
        return out

    def _write_rank_status(self) -> None:
        """Persist the liveness snapshot, on the stats cadence and at the
        end: readers use the states as written (re-deriving them after the
        run would read every rank that finished as LOST)."""
        snap = self.liveness.snapshot()
        snap["session_id"] = self.settings.session_id
        snap["expected_world_size"] = self.expected_world_size()
        atomic_write_json(self.settings.session_dir / "rank_status.json", snap)

    def _loop(self) -> None:
        while not self._stop_evt.is_set():
            try:
                self.server.wait_for_data(_RENDER_INTERVAL)
                self._drain_all()
                self._commit_rings()
                now = time.monotonic()
                if now - self._last_ui_tick >= _RENDER_INTERVAL:
                    self._last_ui_tick = now
                    self.summary_service.poll()
                    try:
                        self.display.tick(self)
                    except Exception as exc:
                        get_error_log().warning("display tick failed", exc)
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

    def settle_telemetry(self, timeout: float = 5.0) -> None:
        """Drain whatever is in flight and wait for it to be committed."""
        deadline = time.monotonic() + timeout
        self._drain_all()
        self.writer.force_flush(timeout=max(0.5, deadline - time.monotonic()))
        self._commit_rings()

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
        self._commit_rings()
        missing = sorted(set(range(expected)) - self._finished_ranks)
        if missing:
            # each missing rank's liveness state rides along: the report
            # tells a rank that died mid-run (LOST, a data gap) from one
            # that only lost its finish marker
            now = time.time()
            atomic_write_json(
                self.settings.session_dir / "finalization_warning.json",
                {
                    "missing_ranks": missing,
                    "missing_rank_states": {str(r): self.liveness.state_of(r, now) for r in missing},
                    "finished_ranks": sorted(self._finished_ranks),
                    "expected_world_size": expected,
                    "ts": now,
                },
            )

    def generate_final_summary(self) -> bool:
        from traceml_tpu_torch.reporting.final import generate_summary

        return generate_summary(
            db_path=self.db_path, session_dir=self.settings.session_dir, settings=self.settings
        )


def write_ready_file(settings: TraceMLSettings, port: int, display_port: Optional[int] = None) -> None:
    """The launcher polls this file for the bound (ephemeral) ports: the
    ingest port always, the dashboard's HTTP port when a browser driver
    is serving."""
    payload: Dict[str, Any] = {"port": port, "pid": os.getpid(), "ts": time.time()}
    if display_port is not None:
        payload["display_port"] = display_port
    atomic_write_json(settings.session_dir / "aggregator_ready.json", payload)

"""Rank liveness tracking.

Counterpart of ``traceml_tpu/aggregator/liveness.py``, with the same
states, thresholds and snapshot; the environment names and defaults
live here (the port has no registry of settings).  Every rank ships a
``rank_heartbeat`` control message every
``TRACEML_HEARTBEAT_INTERVAL_SEC`` (default 3s) across idle ticks, and
data on busy ones; the aggregator feeds every envelope AND control message into
this tracker.  A rank's state is derived from its last-seen age:

    ACTIVE  — heard from within ``stale_after`` seconds
    STALE   — silent past ``stale_after`` (missed ~3 heartbeats)
    LOST    — silent past ``lost_after`` (hard verdict: the process is
              gone, preempted, or partitioned)
    FINISHED — sent its ``rank_finished`` marker (terminal; a finished
              rank is never STALE/LOST no matter how long it is silent)

The tracker also remembers the last time each rank showed *step
progress* (a ``step_time`` envelope): the diagnostics layer uses the
gap between last-progress and last-seen to split "died mid-stride"
(LIKELY_PREEMPTED — progress right up to the silence) from a rank that
idled before vanishing.

The aggregator persists :meth:`snapshot` to ``rank_status.json`` on
the ingest-stats cadence and once more at settle-end.  Readers consume
the states **as written** — at report time every rank is silent, so
re-deriving from wall-clock would mark the whole world LOST.
:meth:`seed` re-loads such a file, so that an aggregator the launcher
restarts after a crash keeps a rank that finished before it FINISHED
(``TraceMLAggregator._reseed_from_prior_run``).
"""

from __future__ import annotations

import os
import time
from typing import Any, Dict, Mapping, Optional

ENV_STALE_SEC = "TRACEML_LIVENESS_STALE_SEC"
ENV_LOST_SEC = "TRACEML_LIVENESS_LOST_SEC"

DEFAULT_STALE_SEC = 10.0  # ~3 missed heartbeats at the 3s default
DEFAULT_LOST_SEC = 30.0

STATE_ACTIVE = "active"
STATE_STALE = "stale"
STATE_LOST = "lost"
STATE_FINISHED = "finished"


def _env_float(name: str, fallback: float) -> float:
    """A float setting; unset or malformed gives ``fallback``."""
    raw = os.environ.get(name)
    try:
        return float(raw) if raw is not None else fallback
    except ValueError:
        return fallback


class RankLivenessTracker:
    """Last-seen bookkeeping + state derivation.  Not thread-safe by
    itself: the aggregator calls it from the ticket-ordered ingest
    section only (one thread at a time by construction)."""

    def __init__(
        self,
        stale_after: Optional[float] = None,
        lost_after: Optional[float] = None,
    ) -> None:
        self.stale_after = (
            stale_after
            if stale_after is not None
            else _env_float(ENV_STALE_SEC, DEFAULT_STALE_SEC)
        )
        self.lost_after = max(
            self.stale_after,
            lost_after
            if lost_after is not None
            else _env_float(ENV_LOST_SEC, DEFAULT_LOST_SEC),
        )
        self._first_seen: Dict[int, float] = {}
        self._last_seen: Dict[int, float] = {}
        self._last_progress: Dict[int, float] = {}
        self._finished: Dict[int, float] = {}

    # -- feed ----------------------------------------------------------
    def observe(
        self,
        rank: int,
        ts: Optional[float] = None,
        progress: bool = False,
    ) -> None:
        now = time.time() if ts is None else float(ts)
        self._first_seen.setdefault(rank, now)
        if now > self._last_seen.get(rank, 0.0):
            self._last_seen[rank] = now
        if progress and now > self._last_progress.get(rank, 0.0):
            self._last_progress[rank] = now

    def mark_finished(self, rank: int, ts: Optional[float] = None) -> None:
        now = time.time() if ts is None else float(ts)
        self.observe(rank, now)
        self._finished.setdefault(rank, now)

    # -- derive --------------------------------------------------------
    def state_of(self, rank: int, now: Optional[float] = None) -> str:
        if rank in self._finished:
            return STATE_FINISHED
        now = time.time() if now is None else now
        age = now - self._last_seen.get(rank, now)
        if age >= self.lost_after:
            return STATE_LOST
        if age >= self.stale_after:
            return STATE_STALE
        return STATE_ACTIVE

    def ranks(self) -> list:
        return sorted(self._last_seen)

    def snapshot(self, now: Optional[float] = None) -> Dict[str, Any]:
        """Persistable per-rank view for ``rank_status.json``."""
        now = time.time() if now is None else now
        ranks: Dict[str, Any] = {}
        for rank in self.ranks():
            ranks[str(rank)] = {
                "state": self.state_of(rank, now),
                "first_seen": self._first_seen.get(rank),
                "last_seen": self._last_seen.get(rank),
                "last_progress": self._last_progress.get(rank),
                "finished": rank in self._finished,
            }
        return {
            "ts": now,
            "thresholds": {
                "stale_after_sec": self.stale_after,
                "lost_after_sec": self.lost_after,
            },
            "ranks": ranks,
        }

    # -- crash-resume --------------------------------------------------
    def seed(self, snapshot: Mapping[str, Any]) -> None:
        """Re-load a prior aggregator incarnation's snapshot so restart
        keeps finished ranks FINISHED and last-seen history intact."""
        ranks = snapshot.get("ranks")
        if not isinstance(ranks, Mapping):
            return
        for rank_s, info in ranks.items():
            try:
                rank = int(rank_s)
            except (TypeError, ValueError):
                continue
            if not isinstance(info, Mapping):
                continue
            last_seen = info.get("last_seen")
            if isinstance(last_seen, (int, float)):
                self.observe(rank, float(last_seen))
            last_progress = info.get("last_progress")
            if isinstance(last_progress, (int, float)):
                self.observe(rank, float(last_progress), progress=True)
            if info.get("finished"):
                ls = last_seen if isinstance(last_seen, (int, float)) else None
                self.mark_finished(rank, ls)

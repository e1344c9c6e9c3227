"""Deterministic fault-injection harness (``TRACEML_FAULT_PLAN``).

Counterpart of ``traceml_tpu/dev/chaos.py``: the same plan grammar, the
same per-rule event counters and the same actions.  The chaos tests drive
the REAL pipeline (launcher, rank executors, aggregator) and inject
faults at named points inside it instead of mocking the failure.  A plan
is a JSON list of rules shipped in the ``TRACEML_FAULT_PLAN`` environment
variable, which every child the launcher spawns inherits::

    TRACEML_FAULT_PLAN='[
      {"point": "client.send", "action": "reset", "after": 20, "rank": 0},
      {"point": "aggregator.ingest", "action": "kill9", "after": 150}
    ]'

Rule fields:

``point``   where the fault fires (see the table below)
``action``  what happens there
``after``   matching events to let pass before the first firing (default 0)
``times``   how many firings in all (default 1)
``every``   matching events between consecutive firings (default 1)
``rank``    only match in the process whose ``RANK`` env equals this
            (omit to match any process reaching the point)
``arg``     the action's parameter (stall seconds, ...)

Points and the actions their call sites implement:

======================  =====================================================
``client.send``         per stream-client send attempt (rank side, TCP
                        or Unix socket; the replay path's sends too).
                        ``reset`` — tear the socket down and fail the send;
                        ``stall`` — sleep ``arg`` seconds (default 0.2)
                        before sending; ``corrupt`` — flip a byte inside
                        the frame body (framing survives, decode fails);
                        ``truncate`` — send only a prefix of the frame,
                        then reset (the receiver's stream desyncs).
``rank.tick``           per runtime sampler tick (rank side). ``kill9``.
``aggregator.ingest``   per drained payload in the aggregator. ``kill9``.
``shm.write``           per shared-memory ring publish (rank side,
                        ``ShmRingClient``).  ``kill9`` dies mid-write,
                        before ``head`` moves, so no torn frame is ever
                        drained; ``stall`` sleeps ``arg`` seconds (default
                        0.2); ``corrupt`` flips a byte in the published
                        body (the ring's framing holds, the frame fails to
                        decode); ``reset`` and ``truncate`` fail the send.
``shm.attach``          per aggregator ring attach (``ShmRingConsumer``).
                        ``corrupt`` zeroes the segment's magic, so the
                        registry quarantines the ring.
======================  =====================================================

Determinism: the counters are per rule and count events, never time, so
the same plan against the same workload fires at the same points.  When
``TRACEML_FAULT_PLAN`` is unset or empty, a call site costs one
module-level ``None`` check.
"""

from __future__ import annotations

import json
import os
import signal
import sys
import threading
from typing import Any, Dict, List, Optional

ENV_FAULT_PLAN = "TRACEML_FAULT_PLAN"

#: Known points: a typo in a plan raises instead of never firing.
POINTS = frozenset({"client.send", "rank.tick", "aggregator.ingest", "shm.write", "shm.attach"})
ACTIONS = frozenset({"reset", "stall", "corrupt", "truncate", "kill9"})


class FaultRule:
    """One parsed plan entry with its firing counters."""

    __slots__ = ("point", "action", "after", "times", "every", "rank", "arg", "hits", "fired")

    def __init__(self, spec: Dict[str, Any]) -> None:
        self.point = str(spec["point"])
        self.action = str(spec["action"])
        if self.point not in POINTS:
            raise ValueError(f"unknown fault point {self.point!r}")
        if self.action not in ACTIONS:
            raise ValueError(f"unknown fault action {self.action!r}")
        self.after = int(spec.get("after", 0))
        self.times = int(spec.get("times", 1))
        self.every = max(1, int(spec.get("every", 1)))
        self.rank = spec.get("rank")
        if self.rank is not None:
            self.rank = int(self.rank)
        self.arg = spec.get("arg")
        self.hits = 0  # matching events seen at this rule's point
        self.fired = 0

    def observe(self) -> bool:
        """Count one matching event; True when this rule fires on it."""
        self.hits += 1
        if self.fired >= self.times:
            return False
        n = self.hits - self.after  # 1-based index past the grace window
        if n < 1 or (n - 1) % self.every != 0:
            return False
        self.fired += 1
        return True


class FaultPlan:
    __slots__ = ("rules", "_lock", "_by_point")

    def __init__(self, rules: List[FaultRule]) -> None:
        self.rules = rules
        self._lock = threading.Lock()
        self._by_point: Dict[str, List[FaultRule]] = {}
        for r in rules:
            self._by_point.setdefault(r.point, []).append(r)

    def fire(self, point: str) -> Optional[FaultRule]:
        rules = self._by_point.get(point)
        if not rules:
            return None
        with self._lock:
            for rule in rules:
                if rule.rank is not None and rule.rank != _env_rank():
                    continue
                if rule.observe():
                    return rule
        return None


def _env_rank() -> Optional[int]:
    try:
        v = os.environ.get("RANK")
        return int(v) if v is not None else None
    except ValueError:
        return None


def parse_plan(text: str) -> FaultPlan:
    spec = json.loads(text)
    if isinstance(spec, dict):
        spec = [spec]
    if not isinstance(spec, list):
        raise ValueError("fault plan must be a JSON list of rules")
    return FaultPlan([FaultRule(dict(entry)) for entry in spec])


# Loaded once at import: the plan rides the environment from the launcher
# to its children, and an environment edit mid-process must not change
# what fires.
_PLAN: Optional[FaultPlan] = None
_plan_text = os.environ.get(ENV_FAULT_PLAN)
if _plan_text:
    try:
        _PLAN = parse_plan(_plan_text)
    except Exception:
        # a malformed plan must not take real telemetry down
        print(f"[traceml] ignoring malformed {ENV_FAULT_PLAN}", file=sys.stderr)
        _PLAN = None


def active() -> bool:
    return _PLAN is not None


def fire(point: str) -> Optional[FaultRule]:
    """The rule that fires at ``point`` for this event, if any.

    ``kill9`` is carried out HERE, the same for every call site; every
    other action is returned for the call site to apply (only the
    transport knows how to corrupt its own frame).
    """
    if _PLAN is None:
        return None
    rule = _PLAN.fire(point)
    if rule is not None and rule.action == "kill9":
        os.kill(os.getpid(), signal.SIGKILL)
    return rule


def _reset_for_tests(plan_text: Optional[str]) -> None:
    """Test hook: swap the active plan in process."""
    global _PLAN
    _PLAN = parse_plan(plan_text) if plan_text else None

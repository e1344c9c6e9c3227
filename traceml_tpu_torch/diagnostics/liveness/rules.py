"""Liveness rules: RANK_LOST, LIKELY_PREEMPTED, WORLD_STALE.

Counterpart of ``traceml_tpu/diagnostics/liveness/rules.py``: the same
thresholds, kinds, severities, metrics, scores and evidence; the actions
name GPU hosts and their schedulers.  All consume one
:class:`LivenessContext` built from a persisted ``rank_status.json``
snapshot (states as written by the aggregator — never re-derived from
wall clock, see aggregator/liveness.py).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

from traceml_tpu_torch.aggregator.liveness import (
    STATE_ACTIVE,
    STATE_LOST,
    STATE_STALE,
)
from traceml_tpu_torch.diagnostics.common import (
    DiagnosticIssue,
    SEVERITY_CRITICAL,
    SEVERITY_WARNING,
    confidence_from,
)
from traceml_tpu_torch.diagnostics.liveness.policy import LivenessPolicy


@dataclasses.dataclass
class RankInfo:
    rank: int
    state: str
    last_seen: Optional[float] = None
    last_progress: Optional[float] = None
    first_seen: Optional[float] = None
    finished: bool = False


@dataclasses.dataclass
class LivenessContext:
    policy: LivenessPolicy
    snapshot_ts: float
    expected_world_size: int
    lost_after_sec: float
    ranks: List[RankInfo]
    # ranks the launcher expected that never sent a single byte —
    # killed before first contact, or never scheduled at all
    never_seen: List[int]

    def by_state(self, state: str) -> List[RankInfo]:
        return [r for r in self.ranks if r.state == state]


def build_context(
    snapshot: Dict[str, Any], policy: LivenessPolicy
) -> LivenessContext:
    raw_ranks = snapshot.get("ranks") or {}
    thresholds = snapshot.get("thresholds") or {}
    ranks: List[RankInfo] = []
    seen: set = set()
    for rank_s, info in raw_ranks.items():
        try:
            rank = int(rank_s)
        except (TypeError, ValueError):
            continue
        if not isinstance(info, dict):
            continue
        seen.add(rank)
        ranks.append(
            RankInfo(
                rank=rank,
                state=str(info.get("state", STATE_ACTIVE)),
                last_seen=info.get("last_seen"),
                last_progress=info.get("last_progress"),
                first_seen=info.get("first_seen"),
                finished=bool(info.get("finished")),
            )
        )
    expected = int(snapshot.get("expected_world_size") or len(seen) or 1)
    never_seen = sorted(set(range(expected)) - seen)
    return LivenessContext(
        policy=policy,
        snapshot_ts=float(snapshot.get("ts") or 0.0),
        expected_world_size=expected,
        lost_after_sec=float(thresholds.get("lost_after_sec") or 30.0),
        ranks=sorted(ranks, key=lambda r: r.rank),
        never_seen=never_seen,
    )


def _silent_for(ctx: LivenessContext, r: RankInfo) -> Optional[float]:
    if r.last_seen is None or ctx.snapshot_ts <= 0:
        return None
    return max(0.0, ctx.snapshot_ts - r.last_seen)


class RankLostRule:
    """A non-finished rank fell silent past the LOST threshold while
    the rest of the world kept reporting — its telemetry stream (and
    almost certainly its training process) is gone.  Ranks that never
    made first contact count too."""

    def evaluate(self, ctx: LivenessContext) -> List[DiagnosticIssue]:
        lost = [r for r in ctx.by_state(STATE_LOST) if not r.finished]
        all_lost = sorted([r.rank for r in lost] + ctx.never_seen)
        if not all_lost:
            return []
        world = max(1, ctx.expected_world_size)
        share = len(all_lost) / world
        silences = {
            str(r.rank): round(s, 1)
            for r in lost
            if (s := _silent_for(ctx, r)) is not None
        }
        evidence: Dict[str, Any] = {
            "lost_ranks": all_lost[:32],
            "expected_world_size": world,
            "lost_after_sec": ctx.lost_after_sec,
            "silent_for_sec": silences,
        }
        if ctx.never_seen:
            evidence["never_seen_ranks"] = ctx.never_seen[:32]
        return [
            DiagnosticIssue(
                kind="RANK_LOST",
                severity=SEVERITY_CRITICAL,
                summary=(
                    f"{len(all_lost)} of {world} rank(s) went silent past "
                    f"the {ctx.lost_after_sec:.0f}s liveness threshold "
                    f"without finishing — their telemetry has a data gap "
                    "from last contact onward."
                ),
                action=(
                    "Check the lost ranks' GPU hosts: the kernel log for "
                    "the OOM killer or NVIDIA Xid errors, the scheduler's "
                    "preemption notices, and each rank's "
                    "crash_stderr.log; cross-rank metrics after the loss "
                    "point cover survivors only."
                ),
                metric="lost_rank_share",
                score=float(share),
                ranks=all_lost[:64],
                confidence=confidence_from(
                    # the state machine already applied the threshold;
                    # margin comes from how far past LOST the silence ran
                    max(
                        [s for s in silences.values()] or [ctx.lost_after_sec]
                    ),
                    ctx.lost_after_sec,
                    coverage=min(1.0, len(ctx.ranks) / world),
                ),
                evidence=evidence,
            )
        ]


class LikelyPreemptedRule:
    """Refines RANK_LOST: the rank was making step progress right up to
    its final contact, then vanished mid-stride — the abrupt-kill
    profile (preemption, OOM kill, hardware loss), as opposed to a rank
    that idled or hung before going silent."""

    def evaluate(self, ctx: LivenessContext) -> List[DiagnosticIssue]:
        p = ctx.policy
        abrupt: List[RankInfo] = []
        for r in ctx.by_state(STATE_LOST):
            if r.finished or r.last_progress is None or r.last_seen is None:
                continue
            if r.last_seen - r.last_progress <= p.preempt_stride_sec:
                abrupt.append(r)
        if not abrupt:
            return []
        ranks = [r.rank for r in abrupt]
        gaps = {
            str(r.rank): round(r.last_seen - r.last_progress, 1)
            for r in abrupt
        }
        return [
            DiagnosticIssue(
                kind="LIKELY_PREEMPTED",
                severity=SEVERITY_WARNING,
                summary=(
                    f"{len(ranks)} lost rank(s) were stepping normally "
                    "until their final contact (progress within "
                    f"{p.preempt_stride_sec:.0f}s of last heartbeat) — "
                    "abrupt termination (preemption/OOM kill) is the "
                    "likely cause, not a hang."
                ),
                action=(
                    "Check the scheduler (Slurm, Kubernetes) or the cloud "
                    "console for preemption or eviction of these GPU "
                    "hosts; on preemptible capacity, checkpoint more often "
                    "and let torchrun's elastic restarts resume the job."
                ),
                metric="preempt_profile_ranks",
                score=float(len(ranks) / max(1, ctx.expected_world_size)),
                ranks=ranks[:64],
                confidence=confidence_from(
                    1.0, 1.0, coverage=min(1.0, len(ctx.ranks) / max(1, ctx.expected_world_size))
                ),
                evidence={
                    "progress_to_silence_gap_sec": gaps,
                    "preempt_stride_sec": p.preempt_stride_sec,
                },
            )
        ]


class WorldStaleRule:
    """A large share of the world simultaneously STALE (silent but not
    yet LOST) — the network-partition / aggregator-overload profile
    rather than individual rank death."""

    def evaluate(self, ctx: LivenessContext) -> List[DiagnosticIssue]:
        p = ctx.policy
        stale = [r for r in ctx.by_state(STATE_STALE) if not r.finished]
        world = max(1, ctx.expected_world_size)
        share = len(stale) / world
        if share < p.stale_share_warn:
            return []
        ranks = [r.rank for r in stale]
        return [
            DiagnosticIssue(
                kind="WORLD_STALE",
                severity=SEVERITY_WARNING,
                summary=(
                    f"{len(stale)} of {world} rank(s) are simultaneously "
                    "stale (heartbeats missing but below the LOST "
                    "threshold) — a shared cause (network partition, "
                    "aggregator overload) is more likely than "
                    "independent rank failures."
                ),
                action=(
                    "Check the aggregator host's load and the network path "
                    "from the GPU hosts to it; individual rank verdicts "
                    "are unreliable while most of the world is silent."
                ),
                metric="stale_rank_share",
                score=float(share),
                ranks=ranks[:64],
                confidence=confidence_from(share, p.stale_share_warn),
                evidence={"stale_ranks": ranks[:32], "stale_share": round(share, 3)},
            )
        ]


DEFAULT_RULES = (
    RankLostRule(),
    LikelyPreemptedRule(),
    WorldStaleRule(),
)

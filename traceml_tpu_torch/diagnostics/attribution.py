"""Shared topology attribution for the diagnosis packs.

Counterpart of ``traceml_tpu/diagnostics/attribution.py`` (copied).
Every pack ends its findings in a flat rank list.  When the session
captured a mesh topology, :func:`attach_attribution` re-reads each fired
issue against the per-rank anomaly values the pack already computed,
asks :func:`traceml_tpu_torch.utils.topology.attribute_ranks` whether a
physical grouping (host / mesh-axis coordinate / node-boundary side)
explains enough of the cross-rank variance, and when one does:

* sets ``issue.attribution`` to the grouping dict, and
* appends the human phrase to ``issue.summary``
  ("… — all 8 ranks of host 3").

With ``topology=None`` (no mesh captured) the function returns the
result unchanged, object-identical, so the serialized output stays
byte-identical to the output without a topology.  Everything here fails
open: attribution is garnish, never a reason to lose a diagnosis.
"""

from __future__ import annotations

import time
from typing import Mapping, Optional

from traceml_tpu_torch.diagnostics.common import DiagnosticResult, STATUS_ISSUE
from traceml_tpu_torch.utils.topology import MeshTopology, attribute_ranks

# lifetime nanoseconds spent attributing: the tick profiler reads the
# delta around each diagnose call to split "attribute" out of the
# "diagnose" stage without threading a profiler through the pack APIs
_ATTR_NS = 0


def attribution_ns_total() -> int:
    return _ATTR_NS


def attach_attribution(
    result: DiagnosticResult,
    topology: Optional[MeshTopology],
    per_rank_values: Optional[Mapping[int, float]],
) -> DiagnosticResult:
    """Annotate fired issues in ``result`` with the best-explaining
    physical grouping; no-op without a topology or per-rank values."""
    global _ATTR_NS
    if topology is None or not per_rank_values:
        return result
    t0 = time.perf_counter_ns()
    try:
        attr = attribute_ranks(per_rank_values, topology)
    except Exception:
        _ATTR_NS += time.perf_counter_ns() - t0
        return result
    _ATTR_NS += time.perf_counter_ns() - t0
    if attr is None:
        return result
    attr_dict = attr.to_dict()
    for issue in result.issues:
        if issue.status != STATUS_ISSUE or not issue.ranks:
            continue
        # only attribute issues whose flagged ranks live inside the
        # outlier group — a grouping that explains the window's variance
        # says nothing about an issue pointing elsewhere
        if not set(issue.ranks) <= set(attr.ranks):
            continue
        issue.attribution = dict(attr_dict)
        if attr.label and attr.label not in issue.summary:
            issue.summary = f"{issue.summary.rstrip()} — {attr.label}."
    return result

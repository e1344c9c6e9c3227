"""The browser dashboard's JSON payload.

Counterpart of ``traceml_tpu/renderers/web_payload.py``.  The payload is
derived from the same ``LiveComputer`` the CLI display renders from, the
typed views serialized by ``as_dict()``, and built as per-domain
fragments: each fragment owns a disjoint set of top-level keys
(``_FRAGMENT_KEYS``) and is rebuilt only when the snapshot-store
versions it depends on (``FRAGMENT_DEPS``) advance.
``build_web_payload`` composes them into the flat dict the page reads;
the delta and SSE endpoints ship them one by one
(``renderers/serving.py``).

All eleven JAX fragments keep their names and order, so the version
token and the page's client are the JAX ones.  ``history`` is the
full-run step-time band of the stitched rollup tiers, left out, as in
JAX, until the writer's first prune folds a row.  The domains the port
does not have yet read as the JAX payload does on a training session
that recorded none: ``collectives`` is ``null`` (its sampler, ROADMAP
queue 1 item 5), ``serving`` is left out (the serving probe, item 6),
and ``meta`` has no ``mesh`` (``utils/topology.py``, item 5).
``meta.regressions`` is the finished run's cross-run verdict
(``regressions.json``), left out until the report writes it, as in JAX;
``meta.window_build`` is the window engine's build counters and tick
profile, which ``LiveComputer.payload_with_versions`` attaches while the
incremental engine is on.  The
findings carry no mesh ``attribution`` either: the port's diagnoses run
with no topology, as the JAX ones do when no mesh was captured.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, Tuple

from traceml_tpu_torch.diagnostics.common import confidence_label
from traceml_tpu_torch.diagnostics.model_diagnostics import compose
from traceml_tpu_torch.reporting.loaders import load_ingest_stats, load_rank_status, load_regressions

PAYLOAD_VERSION = 3

#: fragment name → top-level payload keys it owns, in payload key order
#: (``header`` first; the assembler puts ``ts`` between the header and
#: the domain fragments)
_FRAGMENT_KEYS: Dict[str, Tuple[str, ...]] = {
    "header": ("version", "session"),
    "step_time": ("step_time",),
    "memory": ("memory",),
    "collectives": ("collectives",),
    "serving": ("serving",),
    "system": ("system",),
    "process": ("process",),
    "stdout": ("stdout",),
    "history": ("history",),
    "diagnosis": ("diagnosis", "findings"),
    "meta": ("ingest", "rank_status", "mesh", "regressions", "window_build"),
}

#: serving order, and the position of each counter in the version token
FRAGMENT_ORDER: Tuple[str, ...] = tuple(_FRAGMENT_KEYS)

#: fragment → the snapshot-store domains whose versions gate its
#: rebuild.  The two fragments the port has no domain for depend on
#: none, so they are built once.  ``header`` is constant and ``meta`` is
#: read from files (ingest_stats.json, rank_status.json,
#: regressions.json), so both are
#: rebuilt on every poll and compared by content.
FRAGMENT_DEPS: Dict[str, Tuple[str, ...]] = {
    "step_time": ("step_time", "model_stats", "topology"),
    "memory": ("step_memory", "topology"),
    "collectives": (),
    "serving": (),
    "system": ("system", "topology"),
    "process": ("process",),
    "stdout": ("stdout",),
    "history": ("rollup", "step_time"),
    "diagnosis": ("step_time", "model_stats", "topology", "step_memory", "system", "process"),
}


def _issue_dict(issue: Any) -> Dict[str, Any]:
    return {
        "kind": issue.kind,
        "severity": issue.severity,
        "summary": issue.summary,
        "action": issue.action,
        "confidence": getattr(issue, "confidence", None),
        "confidence_label": confidence_label(getattr(issue, "confidence", None)),
    }


def _view_fragment(payload: Dict[str, Any], key: str) -> Dict[str, Any]:
    view = (payload.get("views") or {}).get(key)
    return {key: view.as_dict() if view is not None else None}


def _history_fragment(payload: Dict[str, Any]) -> Dict[str, Any]:
    """The full-run history strip, its key left out until the first fold
    lands, so a short run's payload keeps the shape it had without
    tiers."""
    history = payload.get("history")
    if not history or not isinstance(history, dict) or not history.get("step_time"):
        return {}
    return {"history": history}


def _diagnosis_fragment(payload: Dict[str, Any]) -> Dict[str, Any]:
    out: Dict[str, Any] = {"diagnosis": None, "findings": []}
    if not payload.get("db_exists"):
        return out
    st_result = (payload.get("step_time") or {}).get("diagnosis")
    if st_result is not None:
        out["diagnosis"] = _issue_dict(st_result.diagnosis)
    domain_results = {
        "step_time": st_result,
        "step_memory": payload.get("step_memory_diagnosis"),
        "collectives": None,
        "serving": None,
        "system": payload.get("system_diagnosis"),
        "process": payload.get("process_diagnosis"),
    }
    try:
        composed = compose(domain_results)
        out["findings"] = [
            dict(_issue_dict(i), domain=i.evidence.get("domain", "?"))
            for i in composed.issues[:8]
        ]
    except Exception:
        pass
    return out


def _meta_fragment(payload: Dict[str, Any], session_dir: Path) -> Dict[str, Any]:
    """The aggregator's self-metrics for the page's meta strip
    (backpressure, per-domain drops, writer latency), the per-rank
    liveness strip, live rather than only in the final summary, the
    finished run's cross-run verdict and the window engine's counters."""
    out: Dict[str, Any] = {}
    if not payload.get("db_exists"):
        return out
    try:
        stats = load_ingest_stats(session_dir)
        if stats:
            out["ingest"] = {
                k: stats[k]
                for k in (
                    "envelopes_ingested", "rows_dropped", "drop_warnings",
                    "dropped_by_domain", "unknown_domain_drops", "queues",
                    "group_commit", "prune", "corrupt_frame_drops",
                    "replay_duplicates",
                    "pending_frames_hwm", "producers", "transports", "ts",
                )
                if k in stats
            }
        status = load_rank_status(session_dir)
        if status and isinstance(status.get("ranks"), dict):
            out["rank_status"] = {
                "ts": status.get("ts"),
                "thresholds": status.get("thresholds"),
                "states": {
                    r: (info or {}).get("state")
                    for r, info in status["ranks"].items()
                    if isinstance(info, dict)
                },
            }
        # the cross-run regression verdict, written at finalize: a
        # dashboard left open shows it the moment the run completes
        regressions = load_regressions(session_dir)
        if regressions:
            out["regressions"] = regressions
    except Exception:
        pass
    # the window engine's health: the incremental cache's builds by path
    # and invalidation reason, and the tick profile; absent when the
    # incremental engine is off or was never consulted
    window_build = payload.get("window_build_stats")
    if window_build:
        out["window_build"] = window_build
    return out


def build_fragment(name: str, payload: Dict[str, Any], *, session: str, db_path: Path) -> Dict[str, Any]:
    """One fragment's top-level payload keys, built from a
    ``LiveComputer.payload()`` result: a plain JSON-able dict, which the
    serving tier serializes once per version."""
    if name == "header":
        return {"version": PAYLOAD_VERSION, "session": session}
    if name in ("step_time", "memory", "system", "process"):
        return _view_fragment(payload, name)
    if name == "collectives":
        return {"collectives": None}
    if name == "serving":
        return {}
    if name == "history":
        return _history_fragment(payload)
    if name == "stdout":
        return {"stdout": [{"stream": s, "line": l} for s, l in (payload.get("stdout") or [])]}
    if name == "diagnosis":
        return _diagnosis_fragment(payload)
    if name == "meta":
        return _meta_fragment(payload, Path(db_path).parent)
    raise KeyError(name)


def build_web_payload(db_path: Path, session: str, window_steps: int = 150) -> Dict[str, Any]:
    """The flat full payload: every fragment merged in key order, plus a
    fresh ``ts``.  Reads through the serving tier's publisher cache, so
    full polls share the per-(fragment, version) work with the delta and
    SSE endpoints."""
    from traceml_tpu_torch.renderers.serving import publisher_for

    return publisher_for(Path(db_path), session, window_steps=window_steps).full_payload_dict()

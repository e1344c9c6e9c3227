"""``python -m traceml_tpu_torch compare a.json b.json [--output P]``.

Counterpart of ``traceml_tpu/reporting/compare/command.py`` (copied).
Pipeline: per-section comparers (sections.py) → diagnosis transitions →
priority verdict ladder (verdict.py) → payload + text render.  The
payload keeps the JAX schema string, ``traceml-tpu-compare/2``:
per-section blocks with named metric rows, per-rank deltas, and ranked
findings, plus ``candidate_baseline`` when the candidate carries a
cross-run ``regressions`` section (``analytics/baselines.py``).
``--output P`` writes the payload to ``P`` and the text beside it with
the suffix ``.txt``.  Exit code 0, or 1 when a summary cannot be read.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Dict, Optional

from traceml_tpu_torch.reporting.compare.policy import DEFAULT_POLICY, ComparePolicy
from traceml_tpu_torch.reporting.compare.sections import ALL_COMPARERS, compare_diagnoses
from traceml_tpu_torch.reporting.compare.verdict import decide_verdict
from traceml_tpu_torch.utils.atomic_io import atomic_write_json, atomic_write_text, read_json
from traceml_tpu_torch.utils.formatting import fmt_ms


def build_compare_payload(
    baseline: Dict[str, Any],
    candidate: Dict[str, Any],
    policy: ComparePolicy = DEFAULT_POLICY,
) -> Dict[str, Any]:
    sections = {
        name: comparer(baseline, candidate, policy)
        for name, comparer in ALL_COMPARERS.items()
    }
    diag_findings = compare_diagnoses(baseline, candidate)
    verdict, findings = decide_verdict(sections, diag_findings)

    step = sections.get("step_time")
    step_metric = (step.metrics.get("step_median_ms") or {}) if step else {}
    payload = {
        "schema": "traceml-tpu-compare/2",
        "verdict": verdict,
        "baseline": {
            "session_id": (baseline.get("meta") or {}).get("session_id"),
            "step_median_ms": step_metric.get("baseline"),
        },
        "candidate": {
            "session_id": (candidate.get("meta") or {}).get("session_id"),
            "step_median_ms": step_metric.get("candidate"),
        },
        "step_delta_rel": step_metric.get("delta_rel"),
        "findings": findings,
        "sections": {name: comp.as_dict() for name, comp in sections.items()},
    }
    # the candidate's own cross-run verdict (analytics/baselines.py):
    # a pairwise compare answers "vs THIS baseline run"; the baseline
    # store answers "vs the fleet of matching runs" — both belong in
    # the report.  Key absent when the candidate predates baselines.
    reg = candidate.get("regressions")
    if isinstance(reg, dict) and reg.get("checks"):
        payload["candidate_baseline"] = {
            "status": reg.get("status"),
            "baseline_runs": reg.get("baseline_runs"),
            "regressed_metrics": [
                c.get("metric")
                for c in reg.get("checks") or []
                if c.get("status") == "regression"
            ],
            "issues": [
                i.get("summary") for i in reg.get("issues") or []
            ],
        }
    return payload


def render_compare_text(payload: Dict[str, Any]) -> str:
    lines = [
        f"VERDICT: {payload['verdict']}",
        f"baseline:  {payload['baseline']['session_id']}  "
        f"step {fmt_ms(payload['baseline']['step_median_ms'])}",
        f"candidate: {payload['candidate']['session_id']}  "
        f"step {fmt_ms(payload['candidate']['step_median_ms'])}",
        "",
    ]
    for f in payload["findings"]:
        lines.append(f"[{f['significance']}] {f['section']}: {f['summary']}")
    if not payload["findings"]:
        lines.append("No significant differences.")
    cb = payload.get("candidate_baseline")
    if cb:
        if cb.get("status") == "regression":
            lines.append(
                "candidate vs its baseline store "
                f"({cb.get('baseline_runs')} matching runs): REGRESSION "
                f"in {', '.join(cb.get('regressed_metrics') or [])}"
            )
            for s in cb.get("issues") or []:
                lines.append(f"  {s}")
        else:
            lines.append(
                "candidate vs its baseline store "
                f"({cb.get('baseline_runs')} matching runs): ok"
            )
    # section status footer — says which domains actually compared
    lines.append("")
    for name, sec in (payload.get("sections") or {}).items():
        status = sec.get("status")
        note = f" — {sec['note']}" if sec.get("note") else ""
        lines.append(f"  {name}: {status}{note}")
    return "\n".join(lines) + "\n"


def _resolve_summary(path: Path) -> Optional[Dict[str, Any]]:
    """Accept a final_summary.json OR a session directory."""
    path = Path(path)
    if path.is_dir():
        path = path / "final_summary.json"
    return read_json(path)


def compare_summaries(
    baseline_path: Path,
    candidate_path: Path,
    policy: ComparePolicy = DEFAULT_POLICY,
) -> Optional[Dict[str, Any]]:
    baseline = _resolve_summary(baseline_path)
    candidate = _resolve_summary(candidate_path)
    if baseline is None or candidate is None:
        return None
    return build_compare_payload(baseline, candidate, policy)


def run_compare(
    baseline_path: Path, candidate_path: Path, output: Optional[Path] = None
) -> int:
    payload = compare_summaries(baseline_path, candidate_path)
    if payload is None:
        print("could not read one of the summaries")
        return 1
    text = render_compare_text(payload)
    print(text)
    if output:
        atomic_write_json(output, payload)
        atomic_write_text(Path(str(output)).with_suffix(".txt"), text)
    return 0

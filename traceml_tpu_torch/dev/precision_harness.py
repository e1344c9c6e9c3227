"""Diagnosis precision/recall harness.

Counterpart of ``traceml_tpu/dev/precision_harness.py``: it runs every
fault-injection scenario of ``dev/demo/scenarios.py`` K times under
``python -m traceml_tpu_torch run``, optionally once more under
ARTIFICIAL HOST LOAD (a busy-loop hog on every core), and writes a
per-scenario confusion matrix to ``--out`` (``PRECISION_TORCH.json`` at
the repo root by default)::

    python -m traceml_tpu_torch.dev.precision_harness --repeats 1 --load              # on the card
    python -m traceml_tpu_torch.dev.precision_harness --repeats 1 --device cpu --out /tmp/p.json

A run is a HIT when the scenario's injected pathology is detected
(``SCENARIOS``: a primary-diagnosis match, an issue-list match, or an
artifact signal, as the scenario e2e tests assert); ``healthy`` scores
PRECISION instead: a hit is the absence of every injected-fault verdict.
Every run is also scored for precision and calibration: each fault-kind
finding in the summary's section issue lists is checked against the
scenario's ``EXPECTED_KINDS``; a finding outside it is a false positive,
and each finding's confidence label is tallied by correctness into
``confidence_calibration``.  The exit code is 0 when the idle recall is
at least 0.9 and no high-confidence finding was wrong.

The scenario table, detectors, expected kinds, host-load hogs and scoring
are the JAX harness's.  The port's differences: the device
(``--device``: ``cuda`` by default, each rank on ``cuda:{LOCAL_RANK %
device_count}``; ``cpu`` asks the scenarios for the CPU), the report's
``device`` and ``card`` (``nvidia-smi``'s name and power limit) in place
of the JAX report's rank-pinning flag (the port's launcher pins no rank
to a core), and each run executes ``dev/demo/scenarios.py`` itself with
the scenario's arguments, where JAX writes a shim script.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

REPO = Path(__file__).resolve().parents[2]
SCENARIO_SCRIPT = REPO / "traceml_tpu_torch" / "dev" / "demo" / "scenarios.py"


# -- detectors (payload → hit?, observed kind) -----------------------------

def _primary_is(*kinds: str, ranks: Optional[List[int]] = None) -> Callable:
    def check(payload: dict):
        primary = payload.get("primary_diagnosis") or {}
        kind = primary.get("kind")
        ok = kind in kinds and (ranks is None or primary.get("ranks") == ranks)
        return ok, kind
    return check


def _issue_present(*kinds: str, ranks: Optional[List[int]] = None) -> Callable:
    def check(payload: dict):
        issues = (payload.get("sections", {}).get("step_time", {})
                  .get("issues", []))
        for issue in issues:
            if issue.get("kind") in kinds and (
                ranks is None or issue.get("ranks") == ranks
            ):
                return True, issue["kind"]
        primary = (payload.get("primary_diagnosis") or {}).get("kind")
        return False, primary
    return check


def _memory_growth(min_bytes: int) -> Callable:
    def check(payload: dict):
        sm = payload.get("sections", {}).get("step_memory", {})
        per_rank = (sm.get("global") or {}).get("per_rank") or {}
        growth = (per_rank.get("0") or {}).get("growth_bytes") or 0
        return growth > min_bytes, f"growth={growth >> 20}MiB"
    return check


def _checkpoint_phase() -> Callable:
    def check(payload: dict):
        phases = (payload.get("sections", {}).get("step_time", {})
                  .get("global", {}) or {}).get("phases") or {}
        ckpt = phases.get("checkpoint")
        ok = bool(ckpt) and (ckpt.get("mean_ms") or 0) > 0
        return ok, "checkpoint_phase" if ok else "checkpoint_phase_missing"
    return check


#: every verdict kind the scenario suite can inject — the universe the
#: precision (false-positive) scoring is computed over
_FAULT_KINDS = {
    "INPUT_BOUND", "INPUT_STRAGGLER", "COMPUTE_STRAGGLER",
    "COLLECTIVE_STRAGGLER", "COMPILE_BOUND",
    "MEMORY_CREEP_EARLY", "MEMORY_CREEP_CONFIRMED",
}

#: scenario → fault kinds that are CORRECT given its injection (a fault
#: finding outside this set counts against precision: a `healthy` run
#: firing INPUT_BOUND must hurt the score).
#: input_straggler admits INPUT_BOUND too: the slow rank IS input-bound,
#: and flagging it alongside the straggler attribution is correct.
EXPECTED_KINDS: Dict[str, set] = {
    "healthy": set(),
    "input_bound": {"INPUT_BOUND"},
    "input_straggler": {"INPUT_STRAGGLER", "INPUT_BOUND"},
    "collective_straggler": {"COLLECTIVE_STRAGGLER"},
    "compute_straggler": {"COMPUTE_STRAGGLER"},
    "recompile": {"COMPILE_BOUND"},
    "memory_creep": {"MEMORY_CREEP_EARLY", "MEMORY_CREEP_CONFIRMED"},
    "checkpoint_stall": set(),
}


def _collect_fault_findings(payload: dict) -> List[dict]:
    """Every fault-kind finding in the summary's section issue lists,
    with its evidence-derived confidence label.  The primary diagnosis
    is NOT collected separately: it is always promoted from a section's
    top issue (diagnostics/common.py), so counting it would tally the
    same finding twice in precision and calibration."""
    found: List[dict] = []
    for section, body in (payload.get("sections") or {}).items():
        for issue in (body or {}).get("issues") or []:
            if issue.get("kind") in _FAULT_KINDS:
                found.append({
                    "kind": issue["kind"],
                    "confidence_label": issue.get("confidence_label"),
                    "source": section,
                })
    return found


def _healthy(payload: dict):
    primary = (payload.get("primary_diagnosis") or {}).get("kind")
    return primary not in _FAULT_KINDS, primary


# name → (steps, nprocs, detector, counted_in_aggregate)
# compute_straggler counts unconditionally: the injection is a sleep
# inside the slow rank's wrapped step call, after its work is enqueued —
# it delays that rank's compute marker without burning a core, so the
# cross-rank skew holds even when all ranks timeshare one CPU.
SCENARIOS: Dict[str, tuple] = {
    "healthy": (60, 1, _healthy, True),
    "input_bound": (60, 1, _primary_is("INPUT_BOUND"), True),
    "input_straggler": (
        60, 4, _primary_is("INPUT_STRAGGLER", ranks=[3]), True,
    ),
    "collective_straggler": (
        60, 4, _issue_present("COLLECTIVE_STRAGGLER", ranks=[3]), True,
    ),
    "compute_straggler": (
        60, 4, _issue_present("COMPUTE_STRAGGLER"), True,
    ),
    "recompile": (60, 1, _issue_present("COMPILE_BOUND"), True),
    "memory_creep": (80, 1, _memory_growth(20 << 20), True),
    "checkpoint_stall": (40, 1, _checkpoint_phase(), True),
}


# -- execution -------------------------------------------------------------

def _card() -> Optional[str]:
    """``nvidia-smi``'s name and power limit of the first card, or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True,
        ).stdout.strip().splitlines()
        return out[0] if out else None
    except (OSError, subprocess.SubprocessError):
        return None


def _env(device: str) -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO)
    if device == "cpu":
        env["OMP_NUM_THREADS"] = "1"  # tiny models; ranks share the cores
    return env


def _run_once(name: str, steps: int, nprocs: int, device: str = "cuda", timeout: float = 360):
    """One launcher run; returns (payload | None, error | None)."""
    with tempfile.TemporaryDirectory(prefix=f"prec_{name}_") as tmp:
        tmp_path = Path(tmp)
        logs = tmp_path / "logs"
        scenario_args = [name, str(steps)] + (["--device", device] if device != "cuda" else [])
        try:
            proc = subprocess.run(
                [
                    sys.executable, "-m", "traceml_tpu_torch", "run",
                    "--mode", "summary", "--logs-dir", str(logs),
                    "--run-name", name, "--sampler-interval", "0.25",
                    "--finalize-timeout", "45", "--nprocs", str(nprocs),
                    str(SCENARIO_SCRIPT), "--", *scenario_args,
                ],
                env=_env(device), capture_output=True, text=True,
                timeout=timeout, cwd=str(tmp_path),
            )
        except subprocess.TimeoutExpired:
            return None, "timeout"
        if proc.returncode != 0:
            return None, f"rc={proc.returncode}: {proc.stderr[-500:]}"
        try:
            session = next(p for p in logs.iterdir() if p.is_dir())
            return (
                json.loads((session / "final_summary.json").read_text()),
                None,
            )
        except (StopIteration, OSError, ValueError) as exc:
            return None, f"no summary: {exc!r}"


class _HostLoad:
    """Busy-loop hogs on every core — the adversarial condition."""

    def __init__(self, n: Optional[int] = None) -> None:
        self._n = n or os.cpu_count() or 2
        self._procs: List[subprocess.Popen] = []

    def __enter__(self):
        for _ in range(self._n):
            self._procs.append(
                subprocess.Popen(
                    [sys.executable, "-c",
                     "while True:\n    sum(i*i for i in range(10_000))"],
                    stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
                )
            )
        return self

    def __exit__(self, *exc):
        for p in self._procs:
            p.kill()
        for p in self._procs:
            try:
                p.wait(timeout=5)
            except subprocess.TimeoutExpired:
                pass
        return False


def run_harness(
    repeats: int = 3,
    with_load: bool = False,
    scenarios: Optional[List[str]] = None,
    out_path: Optional[Path] = None,
    device: str = "cuda",
) -> dict:
    names = scenarios or list(SCENARIOS)
    report: Dict[str, Any] = {
        "ts": time.time(),
        "repeats": repeats,
        "with_load": with_load,
        "host_cores": (
            len(os.sched_getaffinity(0))
            if hasattr(os, "sched_getaffinity") else os.cpu_count()
        ),
        "device": device,
        # the card's name and power limit, as nvidia-smi gives them
        "card": _card() if device.startswith("cuda") else None,
        "scenarios": {},
    }
    for name in names:
        steps, nprocs, detector, counted = SCENARIOS[name]
        entry: Dict[str, Any] = {
            "counted_in_aggregate": counted, "conditions": {},
        }
        expected = EXPECTED_KINDS.get(name, set())
        conditions = [("idle", False)] + ([("loaded", True)] if with_load else [])
        for label, load in conditions:
            hits = 0
            observed: Dict[str, int] = {}
            errors: List[str] = []
            tp = fp = 0
            fp_kinds: Dict[str, int] = {}
            calibration: Dict[str, Dict[str, int]] = {}
            for _ in range(repeats):
                ctx = _HostLoad() if load else None
                if ctx:
                    ctx.__enter__()
                try:
                    payload, err = _run_once(name, steps, nprocs, device)
                finally:
                    if ctx:
                        ctx.__exit__()
                if payload is None:
                    errors.append(err or "unknown")
                    observed["RUN_FAILED"] = observed.get("RUN_FAILED", 0) + 1
                    continue
                hit, kind = detector(payload)
                hits += int(hit)
                key = str(kind)
                observed[key] = observed.get(key, 0) + 1
                # precision + calibration: every
                # fault finding in the summary is scored against the
                # scenario's full expectation, and its confidence label
                # is tallied by correctness — high-confidence findings
                # must never be wrong (calibration gate in main()).
                for finding in _collect_fault_findings(payload):
                    correct = finding["kind"] in expected
                    tp += int(correct)
                    if not correct:
                        fp += 1
                        fp_kinds[finding["kind"]] = (
                            fp_kinds.get(finding["kind"], 0) + 1
                        )
                    lab = finding.get("confidence_label") or "unlabeled"
                    cell = calibration.setdefault(lab, {"n": 0, "wrong": 0})
                    cell["n"] += 1
                    cell["wrong"] += int(not correct)
            entry["conditions"][label] = {
                "runs": repeats,
                "hits": hits,
                "recall": round(hits / repeats, 3) if repeats else None,
                "findings_correct": tp,
                "findings_false_positive": fp,
                "precision": (
                    round(tp / (tp + fp), 3) if (tp + fp) else None
                ),
                "false_positive_kinds": fp_kinds,
                "confidence_calibration": calibration,
                "observed": observed,
                "errors": errors[:3],
            }
            print(
                f"[precision] {name:22s} {label:6s} "
                f"{hits}/{repeats} fp={fp} observed={observed}",
                file=sys.stderr,
            )
        report["scenarios"][name] = entry

    counted = {
        n: e for n, e in report["scenarios"].items()
        if e["counted_in_aggregate"]
    }
    for label in ("idle", "loaded"):
        rows = [
            e["conditions"][label] for e in counted.values()
            if label in e["conditions"]
        ]
        if rows:
            report[f"aggregate_recall_{label}"] = round(
                sum(r["hits"] for r in rows) / sum(r["runs"] for r in rows), 3
            )
        # aggregate precision over EVERY scenario (the advisory ones
        # fire findings too, and a wrong finding is a wrong finding)
        all_rows = [
            e["conditions"][label] for e in report["scenarios"].values()
            if label in e["conditions"]
        ]
        tp = sum(r.get("findings_correct", 0) for r in all_rows)
        fp = sum(r.get("findings_false_positive", 0) for r in all_rows)
        if tp + fp:
            report[f"aggregate_precision_{label}"] = round(tp / (tp + fp), 3)
    # merged calibration table: the trust contract is that a
    # high-confidence finding is never wrong anywhere in the suite
    merged: Dict[str, Dict[str, int]] = {}
    for e in report["scenarios"].values():
        for cond in e["conditions"].values():
            for lab, cell in (cond.get("confidence_calibration") or {}).items():
                dst = merged.setdefault(lab, {"n": 0, "wrong": 0})
                dst["n"] += cell["n"]
                dst["wrong"] += cell["wrong"]
    report["confidence_calibration"] = merged
    if out_path:
        from traceml_tpu_torch.utils.atomic_io import atomic_write_json

        atomic_write_json(out_path, report, indent=1)
    return report


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--repeats", type=int, default=3)
    parser.add_argument("--load", action="store_true",
                        help="repeat every scenario under full-core busy load")
    parser.add_argument("--scenarios", type=str, default=None,
                        help="comma-separated subset")
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (each rank on cuda:{LOCAL_RANK %% device_count}) or cpu")
    parser.add_argument("--out", type=str, default=str(REPO / "PRECISION_TORCH.json"))
    args = parser.parse_args(argv)
    report = run_harness(
        repeats=args.repeats,
        with_load=args.load,
        scenarios=args.scenarios.split(",") if args.scenarios else None,
        out_path=Path(args.out),
        device=args.device,
    )
    agg = report.get("aggregate_recall_idle")
    high = (report.get("confidence_calibration") or {}).get("high") or {}
    print(json.dumps({
        "metric": "diagnosis_recall",
        "device": report["device"],
        "card": report["card"],
        "idle": agg,
        "loaded": report.get("aggregate_recall_loaded"),
        "precision_idle": report.get("aggregate_precision_idle"),
        "precision_loaded": report.get("aggregate_precision_loaded"),
        "high_confidence_wrong": high.get("wrong", 0),
    }))
    # gates: recall >= 0.9 and the calibration contract (a high-confidence
    # finding that is wrong breaks the product's trust model)
    return 0 if (agg or 0) >= 0.9 and not high.get("wrong") else 1


if __name__ == "__main__":
    sys.exit(main())

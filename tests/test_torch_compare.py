"""The port's ``compare`` against the JAX package's.

``build_compare_payload`` and ``render_compare_text`` of both packages on
the same pair of final summaries must give the same payload (the
``traceml-tpu-compare/2`` schema; strings, ints and kinds exactly, floats
to a relative 1e-9, as ``test_torch_final_report.py`` compares) and the
same text.  The pairs reach every rung of the verdict ladder
(INSUFFICIENT_DATA, PARTIAL_DATA, REGRESSION, LIKELY_REGRESSION,
IMPROVEMENT, LIKELY_IMPROVEMENT, MIXED, EQUIVALENT), the confidence
weighting of diagnosis transitions, rank divergence, memory skew, host
and process shifts and a candidate with its cross-run ``regressions``
section; more pairs are summaries the port's ``generate_summary`` wrote
from the SQLite fixtures of ``test_torch_sqlite.py`` (healthy, a slower
step, input-bound; each judged by the baseline store too).

Then ``python -m traceml_tpu_torch compare``: its exit codes (0; 1 when
a summary cannot be read; a session dir for a summary path), its stdout
and its ``--output`` files against the JAX ``run_compare``'s.
"""

import copy
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from tests.test_torch_advice import port_advice
from tests.test_torch_final_report import assert_same
from tests.test_torch_sqlite import memory_rows, process_rows, step_rows, system_rows, wire_payloads, write
from traceml_tpu.reporting.compare import command as jax_command
from traceml_tpu_torch.reporting.compare import command

REPO = Path(__file__).resolve().parent.parent
GiB = 1 << 30


def _summary(step_ms=100.0, input_share=0.1, per_rank=None, peaks=None, n_steps=40,
             diagnosis=("HEALTHY", "info", None), cpu_mean=30.0, rss=GiB, proc_cpu=50.0, session="s",
             clock="device", drop=(), regressions=None):
    """A final summary as both reports write it, reduced to what the
    comparers read."""
    per_rank = per_rank or {"0": step_ms, "1": step_ms}
    peaks = peaks or {"0": 4 * GiB, "1": 4 * GiB}
    kind, severity, confidence = diagnosis
    primary = {"kind": kind, "severity": severity}
    if confidence is not None:
        primary["confidence"] = confidence
        primary["confidence_label"] = "high" if confidence >= 0.85 else "medium" if confidence >= 0.6 else "low"
    out = {
        "meta": {"session_id": session},
        "primary_diagnosis": primary,
        "sections": {
            "step_time": {"status": "OK", "global": {
                "clock": clock, "n_steps": n_steps,
                "phases": {
                    "step_time": {"median_ms": step_ms, "per_rank_avg_ms": per_rank},
                    "input": {"median_ms": step_ms * input_share, "share_of_step": input_share},
                    "compute": {"median_ms": step_ms * (1 - input_share), "share_of_step": 1 - input_share},
                }}},
            "step_memory": {"status": "OK", "global": {"per_rank": {
                r: {"step_peak_bytes": p} for r, p in peaks.items()}}},
            "system": {"status": "OK", "global": {"nodes": {"0": {
                "hostname": "gpu-host-0", "cpu_pct_mean": cpu_mean, "memory_used_bytes": 8 * GiB}}}},
            "process": {"status": "OK", "global": {"per_rank": {
                "0": {"cpu_pct": proc_cpu, "rss_bytes": rss}, "1": {"cpu_pct": proc_cpu, "rss_bytes": rss}}}},
            "collectives": {"status": "NO_DATA"},
        },
    }
    for name in drop:
        if name == "step_time_no_data":
            out["sections"]["step_time"] = {"status": "NO_DATA"}
        else:
            out["sections"].pop(name)
    if regressions is not None:
        out["regressions"] = regressions
    return out


_REG_SECTION = {
    "status": "regression", "baseline_runs": 2,
    "checks": [{"metric": "steady_step_ms", "current": 410.0, "baseline_median": 117.0, "band": [81.9, 152.1],
                "baseline_runs": 2, "delta_pct": 250.43, "status": "regression"}],
    "issues": [{"kind": "PERF_REGRESSION", "severity": "warn", "metric": "steady_step_ms",
                "summary": "steady_step_ms 410 ms is 250.4% above the median of the last 2 matching run(s) (117)",
                "action": "diff this run against the baseline sessions (python -m traceml_tpu_torch compare) "
                          "and check the attributed ranks' hosts before trusting new code"}],
    "fingerprint": {"run_name": "r", "mesh_axes": "", "world_size": 1},
}
_OK_SECTION = {"status": "ok", "baseline_runs": 1, "checks": [dict(_REG_SECTION["checks"][0], status="ok")],
               "issues": [], "fingerprint": _REG_SECTION["fingerprint"]}

#: name → (baseline kwargs, candidate kwargs, expected verdict)
PAIRS = {
    "equivalent": ({}, {"step_ms": 101.0}, "EQUIVALENT"),
    "major_step_regression": ({}, {"step_ms": 115.0}, "REGRESSION"),
    "major_step_improvement": ({}, {"step_ms": 85.0}, "IMPROVEMENT"),
    "minor_step_regression": ({}, {"step_ms": 104.0}, "LIKELY_REGRESSION"),
    "minor_step_improvement": ({}, {"step_ms": 96.0}, "LIKELY_IMPROVEMENT"),
    "improvement_against_memory_regression": ({}, {"step_ms": 85.0, "peaks": {"0": 6 * GiB, "1": 6 * GiB}},
                                              "MIXED"),
    "minor_improvement_against_minor_rss": ({}, {"step_ms": 96.0, "rss": GiB + 300 * (1 << 20)}, "MIXED"),
    "too_few_steps": ({"n_steps": 4}, {"n_steps": 40}, "INSUFFICIENT_DATA"),
    "no_step_time_anywhere": ({"drop": ("step_time_no_data",)}, {"drop": ("step_time",)}, "INSUFFICIENT_DATA"),
    "candidate_lost_step_time": ({}, {"drop": ("step_time_no_data",)}, "PARTIAL_DATA"),
    "candidate_lost_system": ({}, {"drop": ("system",)}, "PARTIAL_DATA"),
    "rank_divergence": ({}, {"step_ms": 101.0, "per_rank": {"0": 100.0, "1": 125.0}}, "REGRESSION"),
    "memory_skew_grew": ({}, {"peaks": {"0": 4 * GiB, "1": 4 * GiB + 40 * (1 << 20)}}, "LIKELY_REGRESSION"),
    "memory_skew_grew_major": ({}, {"peaks": {"0": 4 * GiB, "1": 4 * GiB + 200 * (1 << 20)}}, "REGRESSION"),
    "host_cpu_and_phase_shift": ({}, {"cpu_mean": 70.0, "input_share": 0.13}, "MIXED"),
    "process_rss_grew_major": ({}, {"rss": 3 * GiB}, "REGRESSION"),
    "process_rss_shrank": ({"rss": 3 * GiB}, {"proc_cpu": 95.0}, "IMPROVEMENT"),
    "clock_changed": ({}, {"clock": "host", "step_ms": 100.5}, "EQUIVALENT"),
    "diagnosis_regression_pathological": ({}, {"diagnosis": ("INPUT_BOUND", "critical", None)}, "REGRESSION"),
    "diagnosis_to_healthy": ({"diagnosis": ("INPUT_BOUND", "critical", None)}, {}, "EQUIVALENT"),
    "low_confidence_regression_loses_to_improvement": (
        {"diagnosis": ("HEALTHY", "info", 0.9)},
        {"step_ms": 85.0, "diagnosis": ("INPUT_STRAGGLER", "warning", 0.4)}, "IMPROVEMENT"),
    "confident_regression_forces_mixed": (
        {"diagnosis": ("HEALTHY", "info", 0.9)},
        {"step_ms": 85.0, "diagnosis": ("INPUT_STRAGGLER", "warning", 0.9)}, "MIXED"),
    "low_confidence_pathological_alone": (
        {"diagnosis": ("HEALTHY", "info", 0.9)}, {"diagnosis": ("INPUT_STRAGGLER", "warning", 0.5)},
        "LIKELY_REGRESSION"),
    "candidate_baseline_regression": ({}, {"step_ms": 350.0, "regressions": _REG_SECTION}, "REGRESSION"),
    "candidate_baseline_ok": ({}, {"step_ms": 100.5, "regressions": _OK_SECTION}, "EQUIVALENT"),
    "candidate_baseline_without_checks": ({}, {"regressions": {"status": "no_baseline", "baseline_runs": 0,
                                                               "checks": [], "issues": []}}, "EQUIVALENT"),
}


def _both(baseline, candidate):
    ours = command.build_compare_payload(copy.deepcopy(baseline), copy.deepcopy(candidate))
    theirs = jax_command.build_compare_payload(copy.deepcopy(baseline), copy.deepcopy(candidate))
    assert_same(ours, port_advice(theirs), "compare")
    assert json.dumps(ours) == json.dumps(theirs)  # key order too: the payload is written as JSON
    assert command.render_compare_text(ours) == jax_command.render_compare_text(theirs)
    return ours


@pytest.mark.parametrize("pair", sorted(PAIRS))
def test_compare_payload_and_text_match_jax(pair):
    b_kw, c_kw, verdict = PAIRS[pair]
    ours = _both(_summary(session="base", **b_kw), _summary(session="cand", **c_kw))
    assert ours["schema"] == "traceml-tpu-compare/2"
    assert ours["verdict"] == verdict, (ours["verdict"], ours["findings"])
    assert ("candidate_baseline" in ours) == (pair in ("candidate_baseline_regression", "candidate_baseline_ok"))
    if pair == "candidate_baseline_regression":
        assert ours["candidate_baseline"]["status"] == "regression"
        assert ours["findings"][0]["kind"] == "STEP_TIME_REGRESSION"
        assert "REGRESSION in steady_step_ms" in command.render_compare_text(ours)


def test_every_rung_of_the_ladder_is_reached():
    assert {v for _, _, v in PAIRS.values()} == {
        "INSUFFICIENT_DATA", "PARTIAL_DATA", "REGRESSION", "LIKELY_REGRESSION", "IMPROVEMENT",
        "LIKELY_IMPROVEMENT", "MIXED", "EQUIVALENT"}


def test_policy_and_section_names_are_the_jax_ones():
    from traceml_tpu.reporting.compare import policy as jax_policy
    from traceml_tpu.reporting.compare import sections as jax_sections
    from traceml_tpu_torch.reporting.compare import policy, sections

    assert policy.DEFAULT_POLICY.__dict__ == jax_policy.DEFAULT_POLICY.__dict__
    assert policy.DIAGNOSIS_RANK == jax_policy.DIAGNOSIS_RANK
    assert list(sections.ALL_COMPARERS) == list(jax_sections.ALL_COMPARERS)
    for value in (None, 0.0, 0.02, -0.05, 0.09, 3.0):
        assert policy.classify(value, 0.03, 0.08) == jax_policy.classify(value, 0.03, 0.08)


# -- summaries the port wrote ----------------------------------------------

@pytest.fixture(scope="module")
def port_summaries(tmp_path_factory):
    """``generate_summary`` of the port on three DBs of the SQLite fixtures,
    in this order under one logs dir and run name: healthy, healthy again,
    a 2.5x slower compute step, input-bound (host clock)."""
    from traceml_tpu_torch.aggregator.sqlite_writer import SQLiteWriter
    from traceml_tpu_torch.reporting.final import generate_summary
    from traceml_tpu_torch.runtime.settings import TraceMLSettings
    from traceml_tpu_torch.telemetry.envelope import normalize_telemetry_envelope

    root = tmp_path_factory.mktemp("port_logs")
    out = {}
    for name, input_ms, compute_ms, clock, seed in (("healthy", 0.5, 18.0, "device", 10),
                                                     ("healthy2", 0.5, 18.0, "device", 30),
                                                     ("slow", 0.5, 45.0, "device", 50),
                                                     ("input_bound", 60.0, 18.0, "host", 70)):
        db = root / f"{name}.sqlite"
        payloads = wire_payloads(
            {r: step_rows(seed + r, 80, input_ms, compute_ms * (1 + 0.02 * r), clock=clock) for r in range(2)},
            {r: memory_rows(seed + 2 + r, 80, 0.5) for r in range(2)},
            rank_system={0: system_rows(20, 45)},  # one host for every run
            rank_process={r: process_rows(seed + 5 + r, 45) for r in range(2)},
        )
        write(SQLiteWriter(db), normalize_telemetry_envelope, payloads)
        session = root / "logs" / name
        session.mkdir(parents=True)
        assert generate_summary(db, session, TraceMLSettings(session_id=name, run_name="r", mode="summary"))
        out[name] = session
    return out


PORT_PAIRS = {
    ("healthy", "healthy2"): ("EQUIVALENT", "LIKELY_IMPROVEMENT", "MIXED"),
    ("healthy", "slow"): ("REGRESSION",),
    ("slow", "healthy"): ("IMPROVEMENT", "MIXED"),
    ("healthy", "input_bound"): ("REGRESSION",),
    ("input_bound", "healthy2"): ("IMPROVEMENT", "MIXED"),
    ("slow", "input_bound"): ("REGRESSION", "MIXED", "IMPROVEMENT"),
}


@pytest.mark.parametrize("pair", sorted(PORT_PAIRS), ids=lambda p: f"{p[0]}-{p[1]}")
def test_port_written_summaries_compare_as_in_jax(port_summaries, pair):
    a, b = (json.loads((port_summaries[n] / "final_summary.json").read_text()) for n in pair)
    ours = _both(a, b)
    assert ours["verdict"] in PORT_PAIRS[pair], (ours["verdict"], ours["findings"])
    assert {s["status"] for s in ours["sections"].values()} == {"OK"}
    if pair == ("healthy", "slow"):
        assert ours["findings"][0]["kind"] == "STEP_TIME_REGRESSION"
        assert ours["candidate_baseline"]["status"] == "regression"
        assert ours["candidate_baseline"]["regressed_metrics"] == ["steady_step_ms"]


def _run_both(tmp_path, capsys, *args, output=False):
    """The port's CLI and the JAX ``run_compare`` on the same paths; their
    exit codes, stdout and ``--output`` files."""
    from traceml_tpu_torch.launcher.cli import main

    out = {}
    for name in ("port", "jax"):
        dest = tmp_path / name / "cmp.json" if output else None
        if dest is not None:
            dest.parent.mkdir(exist_ok=True)
        if name == "port":
            code = main(["compare", *map(str, args)] + (["--output", str(dest)] if dest else []))
        else:
            code = jax_command.run_compare(*args, output=dest)
        files = None
        if dest is not None and dest.exists():
            files = (json.loads(dest.read_text()), dest.with_suffix(".txt").read_text())
        out[name] = (code, capsys.readouterr().out, files)
    return out["port"], out["jax"]


def test_the_compare_command_writes_what_jax_writes(tmp_path, capsys, port_summaries):
    ours, theirs = _run_both(tmp_path, capsys, port_summaries["healthy"] / "final_summary.json",
                             port_summaries["slow"], output=True)
    assert ours[0] == theirs[0] == 0
    assert ours[1] == theirs[1] and ours[1].startswith("VERDICT: REGRESSION")
    assert_same(ours[2][0], theirs[2][0], "output")
    assert ours[2][1] == theirs[2][1] == ours[1][:-1]  # print() adds the last newline


def test_an_unreadable_summary_exits_1_with_no_output(tmp_path, capsys, port_summaries):
    ours, theirs = _run_both(tmp_path, capsys, tmp_path / "missing.json", port_summaries["healthy"], output=True)
    assert ours[0] == theirs[0] == 1
    assert ours[1] == theirs[1] == "could not read one of the summaries\n"
    assert ours[2] is None and not (tmp_path / "port" / "cmp.json").exists()


def test_compare_as_a_subprocess(tmp_path, port_summaries):
    """``python -m traceml_tpu_torch compare`` in a fresh interpreter."""
    out = tmp_path / "out" / "cmp.json"
    out.parent.mkdir()
    proc = subprocess.run(
        [sys.executable, "-m", "traceml_tpu_torch", "compare", str(port_summaries["healthy"]),
         str(port_summaries["healthy2"]), "--output", str(out)],
        cwd=tmp_path, env=dict(os.environ, PYTHONPATH=str(REPO)), capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    payload = json.loads(out.read_text())
    assert payload["verdict"] not in ("REGRESSION", "LIKELY_REGRESSION")
    assert proc.stdout.startswith(f"VERDICT: {payload['verdict']}")
    assert out.with_suffix(".txt").read_text() == proc.stdout[:-1]

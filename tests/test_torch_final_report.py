"""The port's final report against the JAX package's, on the same DB.

Rows made from a numpy seed (two ranks, 80 steps on the device clock,
step-memory every 5 steps) go through the port's SQLite writer; then the
JAX ``generate_summary`` and the port's read that same database.  Once
healthy (compute-dominated: COMPUTE_BOUND) and once INPUT_BOUND, with one
rank at 95% of device memory so the memory rules fire too (pressure and
imbalance).
``primary_diagnosis`` and every section must be equal: strings, ints and
kinds exactly, floats to a relative 1e-9 (the JAX report builds its
window with the columnar engine, the port with the scalar reference,
which may differ in the last digits).

The keys the port leaves out this slice are named here: ``history`` and
``regressions`` (cross-run baselines and rollup tiers come later),
``meta.window_build`` (the columnar engine's counters), and
``meta.generated_at`` is a wall-clock stamp, present in both but not
compared.
"""

import json
import math

import pytest

from tests.test_torch_sqlite import memory_rows, step_rows, wire_payloads, write
from traceml_tpu.reporting.final import generate_summary as jax_generate_summary
from traceml_tpu.runtime.settings import TraceMLSettings as JaxSettings
from traceml_tpu_torch.aggregator.sqlite_writer import SQLiteWriter
from traceml_tpu_torch.reporting.final import generate_summary
from traceml_tpu_torch.runtime.settings import TraceMLSettings
from traceml_tpu_torch.telemetry.envelope import normalize_telemetry_envelope

LEFT_OUT = {"history", "regressions"}
LEFT_OUT_META = {"window_build"}
NOT_COMPARED_META = {"generated_at"}
REL = 1e-9


def assert_same(ours, theirs, path="payload"):
    if isinstance(theirs, float) or isinstance(ours, float):
        assert isinstance(ours, (int, float)) and isinstance(theirs, (int, float)), path
        assert math.isclose(ours, theirs, rel_tol=REL, abs_tol=1e-12), (path, ours, theirs)
    elif isinstance(theirs, dict):
        assert isinstance(ours, dict) and ours.keys() == theirs.keys(), (path, ours, theirs)
        for k in theirs:
            assert_same(ours[k], theirs[k], f"{path}.{k}")
    elif isinstance(theirs, list):
        assert isinstance(ours, list) and len(ours) == len(theirs), path
        for i, (a, b) in enumerate(zip(ours, theirs)):
            assert_same(a, b, f"{path}[{i}]")
    else:
        assert ours == theirs, (path, ours, theirs)


def _reports(tmp_path, input_ms, compute_ms, used_frac):
    db = tmp_path / "telemetry.sqlite"
    payloads = wire_payloads(
        {0: step_rows(10, 80, input_ms, compute_ms), 1: step_rows(11, 80, input_ms, compute_ms * 1.02)},
        {0: memory_rows(12, 80, 0.5), 1: memory_rows(13, 80, used_frac)},
    )
    write(SQLiteWriter(db), normalize_telemetry_envelope, payloads)
    out = {}
    for name, gen, settings in (
        ("jax", jax_generate_summary, JaxSettings(session_id="s", run_name="r", mode="summary")),
        ("port", generate_summary, TraceMLSettings(session_id="s", run_name="r", mode="summary")),
    ):
        session = tmp_path / name / "s"
        session.mkdir(parents=True)
        assert gen(db_path=db, session_dir=session, settings=settings)
        out[name] = json.loads((session / "final_summary.json").read_text())
        assert (session / "final_summary.txt").read_text().count("VERDICT") == 1
    return out["port"], out["jax"]


@pytest.mark.parametrize(
    "input_ms, compute_ms, used_frac, kind, memory_kinds",
    [
        (0.5, 18.0, 0.5, "COMPUTE_BOUND", {"HEALTHY"}),
        (60.0, 18.0, 0.95, "INPUT_BOUND", {"MEMORY_IMBALANCE", "HIGH_MEMORY_PRESSURE"}),
    ],
    ids=["healthy", "input_bound"],
)
def test_final_summary_matches_the_jax_report(tmp_path, input_ms, compute_ms, used_frac, kind, memory_kinds):
    ours, theirs = _reports(tmp_path, input_ms, compute_ms, used_frac)
    assert ours["primary_diagnosis"]["kind"] == kind
    assert {i["kind"] for i in ours["sections"]["step_memory"]["issues"]} == memory_kinds
    assert_same(ours["primary_diagnosis"], theirs["primary_diagnosis"], "primary_diagnosis")
    assert_same(ours["sections"], theirs["sections"], "sections")
    assert ours["sections"]["step_time"]["global"]["clock"] == "device"
    assert ours["sections"]["step_time"]["global"]["n_steps"] == 80
    assert ours["schema"] == theirs["schema"]
    assert set(theirs) - set(ours) <= LEFT_OUT and set(ours) <= set(theirs)
    assert set(theirs["meta"]) - set(ours["meta"]) <= LEFT_OUT_META
    for key in set(ours["meta"]) - NOT_COMPARED_META:
        assert_same(ours["meta"][key], theirs["meta"][key], f"meta.{key}")


def test_missing_db_gives_a_no_data_summary(tmp_path):
    session = tmp_path / "s"
    assert generate_summary(tmp_path / "none.sqlite", session, TraceMLSettings(session_id="s"))
    payload = json.loads((session / "final_summary.json").read_text())
    assert payload["primary_diagnosis"]["kind"] == "INSUFFICIENT_STEP_TIME_DATA"
    assert {s["status"] for s in payload["sections"].values()} == {"NO_DATA"}

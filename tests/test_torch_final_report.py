"""The port's final report against the JAX package's, on the same DB.

Rows made from a numpy seed (two ranks, 80 steps on the device clock,
step-memory every 5 steps, system rows from rank 0 with the NVML columns
filled, process rows from every rank) go through the port's SQLite
writer; then the JAX ``generate_summary`` and the port's read that same
database.  Once healthy (compute-dominated: COMPUTE_BOUND) and once
INPUT_BOUND, with one rank at 95% of device memory so the memory rules
fire too (pressure and imbalance); and once healthy with NVML utilization
at 20%, where the system section's LOW_DEVICE_UTILIZATION warning (1.0)
outranks COMPUTE_BOUND (info, 0.6).
``primary_diagnosis`` and every section, the system and process sections
and their cards included, must be equal: strings, ints and kinds exactly,
floats to a relative 1e-9 (the JAX report builds its window with the
columnar engine, the port with the scalar reference, which may differ in
the last digits).  The JAX actions and summaries are first put through
the advice table of ``test_torch_advice.py``: the port names PyTorch/CUDA
remedies.

Then the same with the aggregator's ``rank_status.json`` and
``finalization_warning.json`` in the session dir: the ``liveness``
section (states, data gaps, unfinished ranks) and its place in the
primary diagnosis, where a lost rank outranks every performance finding.

Then the same with ``model_stats_samples`` rows (the MFU inputs) beside
compute rows and beside train-shaped rows (forward, backward, optimizer):
the ``efficiency`` block and every section equal; and the one verdict
the port gives differently on purpose, LOW_MFU on a patched train step.

The keys the port leaves out this slice are named here: ``history``
(the rollup tiers' block, which these fixtures do not fold).
``meta.generated_at`` is a wall-clock stamp, present in both but not
compared.  ``meta.window_build`` (the window engine's build counters and
the report's tick profile) is in both with the JAX keys, invalidation
reasons, stage names and counters, but its numbers are timings and
build counts (the JAX report builds the step window a second time for
its collectives section), so only its shape is compared
(``assert_window_build_shape``): what the JAX block has and the port's
lacks is the serving domain, which comes with its module (ROADMAP queue 1
item 6).
"""

import json
import math

import pytest

from tests.test_torch_advice import port_advice
from tests.test_torch_sqlite import (
    memory_rows,
    model_stats_rows,
    process_rows,
    step_rows,
    system_rows,
    wire_payloads,
    write,
)
from traceml_tpu.reporting.final import generate_summary as jax_generate_summary
from traceml_tpu.runtime.settings import TraceMLSettings as JaxSettings
from traceml_tpu_torch.aggregator.sqlite_writer import SQLiteWriter
from traceml_tpu_torch.reporting.final import generate_summary
from traceml_tpu_torch.runtime.settings import TraceMLSettings
from traceml_tpu_torch.telemetry.envelope import normalize_telemetry_envelope
from traceml_tpu_torch.utils import columnar

GiB = 1 << 30
LEFT_OUT = {"history"}
LEFT_OUT_META = set()
NOT_COMPARED_META = {"generated_at", "window_build"}
REL = 1e-9
# in the JAX window_build block only: the serving domain (ROADMAP queue 1
# item 6); the collectives domain and the mesh grouping cache's counters
# are in both
JAX_ONLY_DOMAINS = {"serving"}
JAX_ONLY_COUNTERS = set()
INVALIDATE_REASONS = {getattr(columnar, n) for n in dir(columnar) if n.startswith("INVALIDATE_")}


def assert_window_build_shape(ours, theirs):
    """The same cache domains with the same stats keys and reasons, and a
    tick profile with the same keys, stage names per domain and counters
    (less the JAX-only ones); every count an int, every time a number."""
    assert set(ours) == set(theirs) - JAX_ONLY_DOMAINS
    for domain in set(ours) - {"tick_profile"}:
        assert ours[domain].keys() == theirs[domain].keys(), domain
        assert set(ours[domain]["invalidations"]) <= INVALIDATE_REASONS
        assert isinstance(ours[domain]["full_rebuilds"], int) and ours[domain]["full_rebuilds"] >= 1
        assert isinstance(ours[domain]["last_build_ms"], float)
    prof, jprof = ours["tick_profile"], theirs["tick_profile"]
    assert prof.keys() == jprof.keys() and prof["ticks"] == jprof["ticks"]
    assert set(prof["stage_ns"]) == set(jprof["stage_ns"]) - JAX_ONLY_DOMAINS
    for domain, stages in prof["stage_ns"].items():
        assert stages.keys() == jprof["stage_ns"][domain].keys(), domain
        assert all(isinstance(ns, int) and ns >= 0 for ns in stages.values()), domain
    assert set(prof["counters"]) == set(jprof["counters"]) - JAX_ONLY_COUNTERS


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


def _reports(tmp_path, input_ms, compute_ms, used_frac, train=False, model_stats=None, ranks=2,
             util_pct=92.0, session_files=None):
    """Both reports on one DB; rank r computes (1 + 0.02 r)× longer, rank
    1 uses ``used_frac`` of device memory, the others half; rank 0's
    system rows read ``util_pct`` NVML utilization.  ``session_files``
    (name → JSON) are written into both session dirs first."""
    db = tmp_path / "telemetry.sqlite"
    payloads = wire_payloads(
        {r: step_rows(10 + r, 80, input_ms, compute_ms * (1 + 0.02 * r), train=train) for r in range(ranks)},
        {r: memory_rows(12 + r, 80, used_frac if r == 1 else 0.5) for r in range(ranks)},
        rank_model_stats=model_stats,
        rank_system={0: system_rows(20, 45, util_pct=util_pct)},
        rank_process={r: process_rows(22 + r, 45, rss=(6 + 2 * r) * GiB) for r in range(ranks)},
    )
    write(SQLiteWriter(db), normalize_telemetry_envelope, payloads)
    out = {}
    for name, gen, settings in (
        ("jax", jax_generate_summary, JaxSettings(session_id="s", run_name="r", mode="summary")),
        ("port", generate_summary, TraceMLSettings(session_id="s", run_name="r", mode="summary")),
    ):
        session = tmp_path / name / "s"
        session.mkdir(parents=True)
        for fname, data in (session_files or {}).items():
            (session / fname).write_text(json.dumps(data))
        assert gen(db_path=db, session_dir=session, settings=settings)
        out[name] = json.loads((session / "final_summary.json").read_text())
        assert (session / "final_summary.txt").read_text().count("VERDICT") == 1
    return out["port"], out["jax"]


@pytest.mark.parametrize(
    "input_ms, compute_ms, used_frac, util_pct, kind, memory_kinds, system_kinds",
    [
        (0.5, 18.0, 0.5, 92.0, "COMPUTE_BOUND", {"HEALTHY"}, {"HEALTHY"}),
        (60.0, 18.0, 0.95, 92.0, "INPUT_BOUND", {"MEMORY_IMBALANCE", "HIGH_MEMORY_PRESSURE"},
         {"HEALTHY"}),
        (0.5, 18.0, 0.5, 20.0, "LOW_DEVICE_UTILIZATION", {"HEALTHY"}, {"LOW_DEVICE_UTILIZATION"}),
    ],
    ids=["healthy", "input_bound", "system_warning_outranks_compute_bound"],
)
def test_final_summary_matches_the_jax_report(tmp_path, input_ms, compute_ms, used_frac, util_pct, kind,
                                              memory_kinds, system_kinds):
    ours, theirs = _reports(tmp_path, input_ms, compute_ms, used_frac, util_pct=util_pct)
    assert ours["primary_diagnosis"]["kind"] == kind
    assert {i["kind"] for i in ours["sections"]["step_memory"]["issues"]} == memory_kinds
    assert {i["kind"] for i in ours["sections"]["system"]["issues"]} == system_kinds
    for key in ("system", "process"):
        assert ours["sections"][key]["status"] == "OK" and ours["sections"][key]["card"]
    assert_same(ours["primary_diagnosis"], port_advice(theirs["primary_diagnosis"]), "primary_diagnosis")
    assert_same(ours["sections"], port_advice(theirs["sections"]), "sections")
    assert ours["sections"]["step_time"]["global"]["clock"] == "device"
    assert ours["sections"]["step_time"]["global"]["n_steps"] == 80
    assert ours["schema"] == theirs["schema"]
    assert set(theirs) - set(ours) <= LEFT_OUT and set(ours) <= set(theirs)
    assert set(theirs["meta"]) - set(ours["meta"]) <= LEFT_OUT_META
    for key in set(ours["meta"]) - NOT_COMPARED_META:
        assert_same(ours["meta"][key], theirs["meta"][key], f"meta.{key}")
    assert_window_build_shape(ours["meta"]["window_build"], theirs["meta"]["window_build"])


def test_missing_db_gives_a_no_data_summary(tmp_path):
    session = tmp_path / "s"
    assert generate_summary(tmp_path / "none.sqlite", session, TraceMLSettings(session_id="s"))
    payload = json.loads((session / "final_summary.json").read_text())
    assert payload["primary_diagnosis"]["kind"] == "INSUFFICIENT_STEP_TIME_DATA"
    assert {s["status"] for s in payload["sections"].values()} == {"NO_DATA"}


# model FLOPs per step for an MFU of about 40% and 7% at a ~18.5 ms step
# on a 989 TFLOP/s peak; the second declaration of rank 0 differs, so the
# loaders' per-rank median is exercised
HIGH_MFU = {0: model_stats_rows(7.3e12, n=2) + model_stats_rows(7.4e12), 1: model_stats_rows(7.3e12),
            2: model_stats_rows(7.3e12)}
LOW_MFU = {r: model_stats_rows(1.28e12, tokens=8192.0) for r in range(3)}
NO_PEAK = {0: model_stats_rows(1.28e12, device_kind="cpu", peak=None)}


@pytest.mark.parametrize(
    "train, model_stats, kind",
    [(True, HIGH_MFU, "COMPUTE_BOUND"), (False, LOW_MFU, "LOW_MFU"), (True, NO_PEAK, "COMPUTE_BOUND")],
    ids=["train_high_mfu", "compute_low_mfu", "train_no_peak"],
)
def test_efficiency_section_matches_the_jax_report(tmp_path, train, model_stats, kind):
    """Train-shaped rows (forward, backward, optimizer) or compute rows
    with model_stats rows, on three ranks (with two, the rollup's median
    rank is a tie that the last bit of each engine's mean decides): the
    same efficiency block, the same verdict and every section equal."""
    ours, theirs = _reports(tmp_path, 0.5, 18.0, 0.5, train=train, model_stats=model_stats, ranks=3)
    assert ours["primary_diagnosis"]["kind"] == kind
    assert_same(ours["primary_diagnosis"], port_advice(theirs["primary_diagnosis"]), "primary_diagnosis")
    assert_same(ours["sections"], port_advice(theirs["sections"]), "sections")
    eff = ours["sections"]["step_time"]["global"]["efficiency"]
    assert eff["flops_per_step"] > 0 and eff["achieved_tflops_median"] > 0
    if model_stats is NO_PEAK:
        assert eff["mfu_median"] is None and eff["peak_tflops"] is None
    else:
        assert 0 < eff["mfu_median"] < 1 and eff["peak_tflops"] == 989.0
    phases = ours["sections"]["step_time"]["global"]["phases"]
    assert ({"forward", "backward", "optimizer"} <= set(phases)) == train
    text = (tmp_path / "port" / "s" / "final_summary.txt").read_text()
    assert "TFLOP/s" in text and ("MFU" in text) == (eff["mfu_median"] is not None)


def test_low_mfu_on_a_patched_train_step_is_judged(tmp_path):
    """The one place the port's diagnosis leaves the JAX package's: the
    JAX LowMfuRule reads the ``compute`` phase alone, so on a step timed
    as forward/backward/optimizer it never fires; the port sums those
    phases as the COMPUTE_BOUND rule does.  Everything else is equal."""
    ours, theirs = _reports(tmp_path, 0.5, 18.0, 0.5, train=True, model_stats=LOW_MFU, ranks=3)
    assert ours["primary_diagnosis"]["kind"] == "LOW_MFU"
    assert ours["primary_diagnosis"]["severity"] == "warning"
    assert theirs["primary_diagnosis"]["kind"] == "COMPUTE_BOUND"
    st_ours, st_theirs = ours["sections"]["step_time"], theirs["sections"]["step_time"]
    assert [i["kind"] for i in st_ours["issues"]] == ["LOW_MFU"] + [i["kind"] for i in st_theirs["issues"]]
    assert_same(st_ours["issues"][1:], port_advice(st_theirs["issues"]), "issues")
    for key in set(st_theirs) - {"diagnosis", "issues"}:
        assert_same(st_ours[key], st_theirs[key], f"step_time.{key}")
    for key in set(theirs["sections"]) - {"step_time"}:
        assert_same(ours["sections"][key], port_advice(theirs["sections"][key]), key)


def _rank_status(states, now=1792000000.0, stale=1.0, lost=3.0):
    """A ``rank_status.json`` as the aggregator writes it: rank → (state,
    seconds of silence at ``now``, seconds from last progress to last
    contact)."""
    ranks = {}
    for rank, (state, silent, gap) in states.items():
        last_seen = now - silent
        ranks[str(rank)] = {"state": state, "first_seen": now - 120.0, "last_seen": last_seen,
                            "last_progress": last_seen - gap, "finished": state == "finished"}
    return {"ts": now, "thresholds": {"stale_after_sec": stale, "lost_after_sec": lost}, "ranks": ranks,
            "session_id": "s", "expected_world_size": len(states)}


LIVENESS_CASES = {
    "all_finished": ({0: ("finished", 2.0, 0.1), 1: ("finished", 2.1, 0.1)}, None, "COMPUTE_BOUND",
                     {"HEALTHY"}),
    "rank_killed": ({0: ("finished", 2.0, 0.1), 1: ("lost", 8.2, 0.3)},
                    {"missing_ranks": [1], "missing_rank_states": {"1": "lost"}, "finished_ranks": [0],
                     "expected_world_size": 2, "ts": 1792000000.0},
                    "RANK_LOST", {"RANK_LOST", "LIKELY_PREEMPTED"}),
    "stale_world": ({0: ("stale", 1.5, 0.2), 1: ("stale", 1.6, 30.0)},
                    {"missing_ranks": [0, 1], "missing_rank_states": {"0": "stale", "1": "stale"},
                     "finished_ranks": [], "expected_world_size": 2, "ts": 1792000000.0},
                    "WORLD_STALE", {"WORLD_STALE"}),
}


@pytest.mark.parametrize("case", sorted(LIVENESS_CASES))
@pytest.mark.parametrize("input_ms", [0.5, 60.0], ids=["compute", "input_bound"])
def test_liveness_section_matches_the_jax_report(tmp_path, case, input_ms):
    """The liveness section and the primary diagnosis against the JAX
    report on one session dir: a lost rank (critical + 0.7) outranks
    INPUT_BOUND (critical + 0.6); a stale world (warning + 0.7) outranks
    COMPUTE_BOUND but not INPUT_BOUND."""
    states, warning, kind, kinds = LIVENESS_CASES[case]
    files = {"rank_status.json": _rank_status(states)}
    if warning is not None:
        files["finalization_warning.json"] = warning
    ours, theirs = _reports(tmp_path, input_ms, 18.0, 0.5, session_files=files)
    sec = ours["sections"]["liveness"]
    assert sec["status"] == "OK" and {i["kind"] for i in sec["issues"]} == kinds
    if input_ms > 1.0 and kind != "RANK_LOST":
        kind = "INPUT_BOUND"
    assert ours["primary_diagnosis"]["kind"] == kind
    assert (ours["primary_diagnosis"]["domain"] == "liveness") == (kind in ("RANK_LOST", "WORLD_STALE"))
    assert_same(ours["primary_diagnosis"], port_advice(theirs["primary_diagnosis"]), "primary_diagnosis")
    assert_same(sec, port_advice(theirs["sections"]["liveness"]), "sections.liveness")
    assert_same(ours["sections"], port_advice(theirs["sections"]), "sections")
    if case == "rank_killed":
        assert set(sec["data_gaps"]) == {"1"} and sec["unfinished_ranks"] == [1]
        assert sec["unfinished_rank_states"] == {"1": "lost"}
        text = (tmp_path / "port" / "s" / "final_summary.txt").read_text()
        assert "[liveness] RANK_LOST" in text

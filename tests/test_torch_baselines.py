"""The port's cross-run baselines against the JAX package's.

The same payloads, made from a numpy seed (``default_rng(seed)``), go
through the JAX ``evaluate_and_record`` and the port's into separate
stores, one run after another: every returned ``regressions`` section
must be equal (strings, ints and kinds exactly, floats to a relative
1e-9, as in ``test_torch_final_report.py``), after the JAX actions went
through the advice table of ``test_torch_advice.py`` (the port's
PERF_REGRESSION names ``python -m traceml_tpu_torch compare``).  The
sequences reach the ``no_baseline``, ``ok``, ``regression`` and
``improved`` statuses, the bands for n = 1, 2 and >= 3 prior runs, the
``TRACEML_BASELINE_MAX_RUNS`` trim, a store that cannot be used, a
payload with nothing comparable and the order evaluate-then-record (a
re-finalized session does not match itself).

Then the whole report: both ``generate_summary`` on the same DBs under
one logs dir each, three runs in a row (healthy, healthy, a step 2.5x
slower):
the ``regressions`` sections, ``regressions.json`` beside them and the
text summary's cross-run lines are equal; the dashboard's meta fragment
and ``load_regressions`` read the same file as the JAX ones.
"""

import json
import math
import os
import sqlite3

import numpy as np
import pytest

from tests.test_torch_advice import names_jax_remedy, port_advice
from tests.test_torch_final_report import assert_same
from tests.test_torch_sqlite import memory_rows, process_rows, step_rows, system_rows, wire_payloads, write
from traceml_tpu.analytics import baselines as jax_baselines
from traceml_tpu_torch.analytics import baselines

REL = 1e-9  # floats compared to a relative 1e-9, as test_torch_final_report.py does


def _payload(rng, session, step_ms, run_name="train", world=2, axes=None, overlap=True, slope=True,
             tokens=False):
    """A final-summary payload carrying every input of ``summary_stats``;
    the optional metrics present or not as asked."""
    per_rank = {str(r): float(step_ms * rng.uniform(0.97, 1.03)) for r in range(world)}
    sections = {
        "step_time": {"global": {"steady_state": {"median_ms": float(step_ms),
                                                  "per_rank_median_ms": per_rank}}},
        "step_memory": {"global": {"per_rank": {
            str(r): {"trend": {"slope_pct_per_100": float(rng.uniform(-0.2, 0.4)) if slope else None}}
            for r in range(world)}}},
    }
    if overlap:
        sections["collectives"] = {"global": {"overlap_efficiency": float(rng.uniform(0.8, 0.95))}}
    if tokens:
        sections["serving"] = {"global": {"tokens_per_s": float(rng.uniform(900.0, 1100.0))}}
    topo = {"world_size": world}
    if axes:
        topo["mesh"] = {"axes": [{"name": n, "size": s, "kind": k} for n, s, k in axes]}
    return {"meta": {"session_id": session, "run_name": run_name, "topology": topo}, "sections": sections}


def _both(tmp_path, payload, session=None, **kw):
    """``evaluate_and_record`` of both packages on ``payload``, each in its
    own logs dir; the port's section, checked equal to the JAX one."""
    out = []
    for name, mod in (("jax", jax_baselines), ("port", baselines)):
        sdir = tmp_path / name / (session or payload["meta"]["session_id"])
        sdir.mkdir(parents=True, exist_ok=True)
        out.append(mod.evaluate_and_record(sdir, payload, **kw))
    theirs, ours = out
    assert (ours is None) == (theirs is None)
    if ours is not None:
        assert_same(ours, port_advice(theirs), "regressions")
    return ours


# step-time sequences: (label, step ms per run); the statuses each must reach
SEQUENCES = {
    "steady_then_regression": ([100.0, 101.0, 99.5, 100.4, 180.0, 100.2], {"no_baseline", "ok", "regression"}),
    "improvement": ([100.0, 100.5, 99.0, 60.0, 99.8], {"no_baseline", "ok", "improved"}),
    "small_n_bands": ([100.0, 155.0, 62.0, 101.0], {"no_baseline", "ok", "regression", "improved"}),
    "noisy_history": ([100.0, 90.0, 115.0, 97.0, 125.0, 104.0, 160.0], {"no_baseline", "ok", "regression"}),
}


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("sequence", sorted(SEQUENCES))
def test_a_seeded_sequence_of_runs_gives_the_jax_sections(tmp_path, sequence, seed):
    """Run after run into one store per package: equal sections, the band
    width of n = 1 (±50%), n = 2 (±30%) and n >= 3 (MAD or floor), and the
    statuses the sequence is made to reach."""
    steps, want = SEQUENCES[sequence]
    rng = np.random.default_rng(seed)
    statuses, runs_seen = set(), []
    for i, step_ms in enumerate(steps):
        section = _both(tmp_path, _payload(rng, f"s{i}", step_ms * float(rng.uniform(0.995, 1.005)),
                                           overlap=bool(seed % 2 == 0), tokens=seed == 2))
        assert section["baseline_runs"] == i
        assert section["fingerprint"] == {"run_name": "train", "mesh_axes": "", "world_size": 2}
        statuses.add(section["status"])
        statuses.update(c["status"] for c in section["checks"])
        step = next((c for c in section["checks"] if c["metric"] == "steady_step_ms"), None)
        assert (step is None) == (i == 0)
        if step is not None:
            runs_seen.append(step["baseline_runs"])
            half = (step["band"][1] - step["band"][0]) / 2.0
            center = step["baseline_median"]
            if i == 1:
                assert math.isclose(half, 0.5 * center, rel_tol=REL)
            elif i == 2:
                assert math.isclose(half, 0.3 * center, rel_tol=REL)
            else:
                assert half >= 0.15 * center * (1 - REL)
        for issue in section["issues"]:
            assert issue["kind"] == "PERF_REGRESSION" and "attribution" not in issue
            assert "python -m traceml_tpu_torch compare" in issue["action"]
            assert not names_jax_remedy(issue["action"])
    assert runs_seen == list(range(1, len(steps)))
    assert want <= statuses, statuses


@pytest.mark.parametrize("n", [1, 2, 3, 4, 7, 20])
@pytest.mark.parametrize("metric", sorted(baselines.METRICS))
def test_robust_band_matches_jax(n, metric):
    spec = baselines.METRICS[metric]
    rng = np.random.default_rng(n)
    values = [float(v) for v in rng.normal(50.0, 5.0, n)] + [None]
    ours = baselines.robust_band(values, spec["rel_floor"], spec.get("abs_floor", 0.0))
    theirs = jax_baselines.robust_band(values, spec["rel_floor"], spec.get("abs_floor", 0.0))
    assert_same(ours, theirs, "band")
    assert ours["n"] == n
    assert baselines.METRICS == jax_baselines.METRICS and baselines.STORE_FILENAME == jax_baselines.STORE_FILENAME


@pytest.mark.parametrize(
    "kw",
    [{}, {"axes": (("data", 2, "ici"),)}, {"axes": (("data", 2, "ici"), ("model", 4, "dcn"))},
     {"run_name": ""}, {"world": 8, "tokens": True}, {"overlap": False, "slope": False}],
    ids=["plain", "mesh", "mesh2", "no_name", "world8_tokens", "step_only"],
)
def test_fingerprint_and_stats_match_jax(kw):
    payload = _payload(np.random.default_rng(3), "s", 100.0, **kw)
    assert baselines.fingerprint_from_summary(payload) == jax_baselines.fingerprint_from_summary(payload)
    assert baselines.fingerprint_key(baselines.fingerprint_from_summary(payload)) == \
        jax_baselines.fingerprint_key(jax_baselines.fingerprint_from_summary(payload))
    assert_same(baselines.summary_stats(payload), jax_baselines.summary_stats(payload), "stats")


def test_fingerprints_keep_their_own_baselines(tmp_path):
    """Another run name or another mesh starts its own history."""
    rng = np.random.default_rng(4)
    _both(tmp_path, _payload(rng, "a0", 100.0))
    _both(tmp_path, _payload(rng, "a1", 101.0))
    assert _both(tmp_path, _payload(rng, "b0", 300.0, run_name="other"))["status"] == "no_baseline"
    assert _both(tmp_path, _payload(rng, "c0", 300.0, axes=(("data", 2, "ici"),)))["status"] == "no_baseline"
    assert _both(tmp_path, _payload(rng, "a2", 300.0))["baseline_runs"] == 2


@pytest.mark.parametrize("raw, kept", [(None, 20), ("3", 3), ("1", 1), ("0", 1), ("-4", 1), ("", 20),
                                       ("many", 20), (" 2 ", 2)])
def test_max_runs_setting_trims_the_store_as_jax(tmp_path, monkeypatch, raw, kept):
    """``TRACEML_BASELINE_MAX_RUNS``: read as the JAX flag reads it (unset
    or malformed: 20; at least 1), the newest ``kept`` runs stay."""
    if raw is None:
        monkeypatch.delenv(baselines.ENV_BASELINE_MAX_RUNS, raising=False)
    else:
        monkeypatch.setenv(baselines.ENV_BASELINE_MAX_RUNS, raw)
    rng = np.random.default_rng(5)
    for i in range(6):
        section = _both(tmp_path, _payload(rng, f"s{i}", 100.0 + i))
        assert section["baseline_runs"] == min(i, kept)
    stores = {}
    for name, mod in (("jax", jax_baselines), ("port", baselines)):
        store = mod.BaselineStore(tmp_path / name / mod.STORE_FILENAME)
        assert store.max_runs == kept
        runs = store.matching_runs(mod.fingerprint_from_summary(_payload(rng, "x", 1.0)))
        store.close()
        stores[name] = [(r["session_id"], r["stats"]) for r in runs]
    assert stores["port"] == stores["jax"]
    assert [s for s, _ in stores["port"]] == [f"s{i}" for i in range(6 - min(6, kept), 6)]


def test_evaluation_precedes_recording_and_a_refinalize_does_not_self_match(tmp_path):
    """A slow run is judged against the runs before it, not against itself;
    finalizing it again gives the same section and does not add a run."""
    rng = np.random.default_rng(6)
    for i in range(3):
        _both(tmp_path, _payload(rng, f"s{i}", 100.0))
    slow = _payload(rng, "slow", 250.0)
    first = _both(tmp_path, slow)
    again = _both(tmp_path, slow)
    assert first["status"] == again["status"] == "regression"
    assert first["baseline_runs"] == again["baseline_runs"] == 3
    assert_same(again, first)
    # the slow run is in the store once, and the next healthy run is judged with it
    assert _both(tmp_path, _payload(rng, "s3", 100.0))["baseline_runs"] == 4


def test_an_unusable_store_or_nothing_comparable_leaves_the_section_out(tmp_path):
    rng = np.random.default_rng(8)
    # the store path is a directory: sqlite cannot open it
    for name in ("jax", "port"):
        (tmp_path / name / baselines.STORE_FILENAME).mkdir(parents=True)
    assert _both(tmp_path, _payload(rng, "s0", 100.0)) is None
    # no comparable metric at all
    empty = {"meta": {"session_id": "e"}, "sections": {}}
    assert _both(tmp_path / "other", empty) is None
    assert not (tmp_path / "other" / "port" / baselines.STORE_FILENAME).exists()


def test_a_store_that_fails_mid_evaluation_returns_none(tmp_path, monkeypatch):
    """A sqlite error after the store opened: logged, None, as in JAX."""
    rng = np.random.default_rng(9)
    payload = _payload(rng, "s0", 100.0)

    def broken(self, *a, **k):
        raise sqlite3.OperationalError("disk I/O error")

    for name, mod in (("jax", jax_baselines), ("port", baselines)):
        monkeypatch.setattr(mod.BaselineStore, "matching_runs", broken)
        assert mod.evaluate_and_record(tmp_path / name / "s0", payload) is None


# -- the whole report -------------------------------------------------------

def _db(tmp_path, name, compute_ms, seed):
    from traceml_tpu_torch.aggregator.sqlite_writer import SQLiteWriter
    from traceml_tpu_torch.telemetry.envelope import normalize_telemetry_envelope

    db = tmp_path / f"{name}.sqlite"
    payloads = wire_payloads(
        {r: step_rows(seed + r, 80, 0.5, compute_ms * (1 + 0.02 * r)) for r in range(2)},
        {r: memory_rows(seed + 2 + r, 80, 0.5) for r in range(2)},
        rank_system={0: system_rows(seed + 4, 45)},
        rank_process={r: process_rows(seed + 5 + r, 45) for r in range(2)},
    )
    write(SQLiteWriter(db), normalize_telemetry_envelope, payloads)
    return db


def _cross_run_lines(text):
    lines = text.splitlines()
    out = []
    for i, line in enumerate(lines):
        if line.startswith("Cross-run") or line.startswith("[baseline]"):
            out.append(line)
            j = i + 1
            while line.startswith("Cross-run regression") and j < len(lines) and lines[j].startswith("  "):
                out.append(lines[j])
                j += 1
    return out


def test_three_reports_in_a_row_match_the_jax_reports(tmp_path):
    """healthy, healthy, 2.5x slower under one logs dir and run name: the
    sections no_baseline, ok (one prior run), regression (two), equal to
    the JAX report's; regressions.json equal to the payload's section; the
    same cross-run lines in both text summaries; the dashboard's meta
    fragment and ``load_regressions`` give the file."""
    from traceml_tpu.renderers.web_payload import _meta_fragment as jax_meta_fragment
    from traceml_tpu.reporting.final import generate_summary as jax_generate_summary
    from traceml_tpu.reporting.loaders import load_regressions as jax_load_regressions
    from traceml_tpu.runtime.settings import TraceMLSettings as JaxSettings
    from traceml_tpu_torch.renderers.web_payload import _meta_fragment
    from traceml_tpu_torch.reporting.final import generate_summary
    from traceml_tpu_torch.reporting.loaders import load_regressions
    from traceml_tpu_torch.runtime.settings import TraceMLSettings

    runs = (("h1", 18.0, 10), ("h2", 18.0, 30), ("slow", 45.0, 50))
    want = (("no_baseline", 0), ("ok", 1), ("regression", 2))
    for (session, compute_ms, seed), (status, n) in zip(runs, want):
        db = _db(tmp_path, session, compute_ms, seed)
        out = {}
        for name, gen, settings in (
            ("jax", jax_generate_summary, JaxSettings(session_id=session, run_name="r", mode="summary")),
            ("port", generate_summary, TraceMLSettings(session_id=session, run_name="r", mode="summary")),
        ):
            sdir = tmp_path / name / session
            sdir.mkdir(parents=True)
            assert gen(db_path=db, session_dir=sdir, settings=settings)
            payload = json.loads((sdir / "final_summary.json").read_text())
            on_disk = json.loads((sdir / "regressions.json").read_text())
            assert on_disk == payload["regressions"]
            out[name] = (payload, (sdir / "final_summary.txt").read_text(), sdir)
        (ours, our_text, our_dir), (theirs, their_text, their_dir) = out["port"], out["jax"]
        assert_same(ours["regressions"], port_advice(theirs["regressions"]), "regressions")
        reg = ours["regressions"]
        assert (reg["status"], reg["baseline_runs"]) == (status, n)
        assert reg["fingerprint"] == {"run_name": "r", "mesh_axes": "", "world_size": 2}
        assert _cross_run_lines(our_text) == _cross_run_lines(their_text)
        if status == "regression":
            assert any(line.startswith("[baseline] PERF_REGRESSION: steady_step_ms") for line in
                       our_text.splitlines())
            step = next(c for c in reg["checks"] if c["metric"] == "steady_step_ms")
            assert step["status"] == "regression" and step["delta_pct"] > 100.0
        elif status == "ok":
            assert "Cross-run baseline: within bands of last 1 matching run(s)." in our_text
        else:
            assert "Cross-run" not in our_text and "[baseline]" not in our_text
        assert load_regressions(our_dir) == ours["regressions"]
        assert load_regressions(our_dir) is load_regressions(our_dir)  # the (mtime, size) cache
        assert jax_load_regressions(their_dir) == theirs["regressions"]
        meta = _meta_fragment({"db_exists": True}, our_dir)
        assert meta["regressions"] == ours["regressions"]
        assert_same(meta["regressions"], port_advice(jax_meta_fragment({"db_exists": True}, their_dir)["regressions"]))
    assert os.path.exists(tmp_path / "port" / baselines.STORE_FILENAME)


def test_no_regressions_file_leaves_the_meta_key_out(tmp_path):
    from traceml_tpu_torch.renderers.web_payload import _meta_fragment
    from traceml_tpu_torch.reporting.loaders import load_regressions

    assert load_regressions(tmp_path) == {}
    assert "regressions" not in _meta_fragment({"db_exists": True}, tmp_path)
    (tmp_path / "regressions.json").write_text("not json")
    assert load_regressions(tmp_path) == {}

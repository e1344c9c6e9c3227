"""The port's HTML report (``final_summary.html``) against the JAX one.

``render_html_summary`` of both packages on the same payload dicts: the
minimal, odd, multi-section and KPI payloads of
``tests/reporting/test_html_and_edge_windows.py``, and the
``final_summary.json`` of a tiny CPU ``run --mode summary`` of the port.
Tolerance: exact text, after the label table ``LABELS`` is applied to
the JAX text (the product name and the occupancy tile name the port's
platform).  Hostile strings in a hostname, a diagnosis summary and a
rank key come out escaped.  The tiny run writes ``final_summary.html``
beside the ``.json`` and ``.txt``; a payload that makes the HTML writer
raise still leaves the ``.json`` and ``.txt`` and logs the error.
"""

import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

from traceml_tpu.reporting.html.writer import render_html_summary as jax_render
from traceml_tpu_torch.reporting import final
from traceml_tpu_torch.reporting.html.writer import render_html_summary
from traceml_tpu_torch.utils.error_log import get_error_log

REPO = Path(__file__).resolve().parent.parent
TRAIN_SCRIPT = REPO / "traceml_tpu_torch" / "dev" / "train_script.py"

#: JAX text → the port's, applied in order to the JAX renderer's output
LABELS = (
    ("TraceML-TPU", "TraceML (PyTorch)"),
    ("chip busy", "GPU busy"),
)

#: a word of the JAX package's platform, which no port page may hold
JAX_WORDS = re.compile(r"\b(?:jax|tpus?|libtpu|xla|ici)\b", re.IGNORECASE)


def port_labels(text: str) -> str:
    for old, new in LABELS:
        text = text.replace(old, new)
    return text


# -- the JAX HTML test's payloads -----------------------------------------

MINIMAL = {"meta": {}, "primary_diagnosis": {}, "sections": {}}

ODD = {
    "meta": {"session_id": "<script>x</script>", "topology": {}},
    "primary_diagnosis": {"kind": "INPUT_BOUND", "severity": "critical", "summary": "a & b < c"},
    "sections": {
        "step_time": {
            "status": "OK",
            "issues": [{"kind": "K", "severity": "warning", "summary": "s"}],
            "global": {
                "n_steps": 3, "clock": "host",
                "phases": {"step_time": {"median_ms": 1.0, "share_of_step": None, "worst_rank": 0,
                                         "skew_pct": 0.0}},
                "step_series_ms": {"0": [1.0, 2.0, 1.5]},
            },
        }
    },
}

SECTIONS = {
    "meta": {"session_id": "s", "topology": {"world_size": 2}, "telemetry_stats": {"envelopes_ingested": 10}},
    "primary_diagnosis": {"kind": "HEALTHY", "severity": "info", "summary": "ok"},
    "sections": {
        "step_time": {
            "status": "OK", "issues": [],
            "global": {
                "n_steps": 40, "clock": "device",
                "median_occupancy": 0.83,
                "steady_state": {"median_ms": 90.0, "warmup_inflation_pct": 0.1, "warmup_steps_excluded": 10},
                "phases": {
                    "step_time": {"median_ms": 100.0, "share_of_step": None, "worst_rank": 1, "skew_pct": 0.0},
                    "compute": {"median_ms": 80.0, "share_of_step": 0.8, "worst_rank": 1, "skew_pct": 0.0},
                },
                "per_rank": {
                    "0": {"avg_ms": {"step_time": 100.0, "compute": 80.0}, "occupancy": 0.85, "steps_seen": 40},
                    "1": {"avg_ms": {"step_time": 101.0, "compute": 81.0}, "occupancy": 0.81, "steps_seen": 40},
                },
            },
        },
        "step_memory": {
            "status": "OK", "issues": [],
            "global": {
                "per_rank": {"0": {"current_bytes": 4 << 30, "step_peak_bytes": 5 << 30, "limit_bytes": 16 << 30,
                                   "pressure": 0.31, "growth_bytes": 1 << 20}},
                "rollup": {"total_current_bytes": 4 << 30, "max_peak_bytes": 5 << 30},
            },
        },
        "system": {
            "status": "OK", "issues": [],
            "global": {
                "nodes": {"0": {"hostname": "a", "cpu_pct_mean": 20.0, "cpu_pct_max": 40.0,
                                "memory_used_bytes": 1, "memory_total_bytes": 2, "load_1m": 0.5},
                          "1": {"hostname": "b", "cpu_pct_mean": 80.0, "cpu_pct_max": 95.0,
                                "memory_used_bytes": 1, "memory_total_bytes": 2, "load_1m": 2.0}},
                "cluster": {"n_nodes": 2, "cpu_pct_min": 20.0, "cpu_pct_median": 50.0, "cpu_pct_max": 80.0,
                            "busiest_node": "b"},
            },
        },
        "process": {
            "status": "OK", "issues": [],
            "global": {"per_rank": {"0": {"pid": 7, "cpu_pct_mean": 50.0, "cpu_pct_max": 90.0,
                                          "rss_bytes": 1 << 30, "rss_peak_bytes": 2 << 30, "num_threads": 8}}},
        },
    },
}

KPIS = {
    "meta": {"session_id": "k", "topology": {"world_size": 2}},
    "primary_diagnosis": {
        "kind": "INPUT_STRAGGLER", "severity": "critical", "summary": "rank 1 lags", "action": "look at rank 1",
        "ranks": [1], "evidence": {"score": 0.42, "statistic": "median"},
    },
    "sections": {
        "step_time": {
            "status": "OK", "issues": [],
            "diagnosis": {"kind": "INPUT_STRAGGLER"},
            "global": {
                "clock": "device", "n_steps": 50,
                "phases": {
                    "step_time": {"median_ms": 100.0, "worst_ms": 160.0, "worst_rank": 1, "skew_pct": 0.6,
                                  "share_of_step": None},
                    "input": {"median_ms": 20.0, "worst_ms": 80.0, "worst_rank": 1, "skew_pct": 3.0,
                              "share_of_step": 0.2},
                },
                "efficiency": {
                    "flops_per_step": 2.5e12, "flops_source": "manual", "achieved_tflops_median": 25.0,
                    "mfu_median": 0.41, "peak_tflops": 989.0, "peak_flops": 9.89e14,
                    "device_kind": "NVIDIA H100 80GB HBM3", "device_count": 4,
                },
                "rollup": {
                    "index_by": "global_rank",
                    "window": {"steps_analyzed": 50},
                    "average": {"step_time": 110.0, "input": 35.0},
                    "median": {"step_time": {"value": 100.0, "idx": "0"}, "input": {"value": 20.0, "idx": "0"}},
                    "worst": {"step_time": {"value": 160.0, "idx": "1"}, "input": {"value": 80.0, "idx": "1"}},
                },
            },
        },
    },
}


@pytest.fixture(scope="module")
def summary_run(tmp_path_factory):
    """One tiny CPU ``run --mode summary`` of the train script (2 layers,
    128 wide, 30 steps); returns its session directory."""
    tmp = tmp_path_factory.mktemp("html_run")
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "traceml_tpu_torch", "run", "--mode", "summary", "--logs-dir", str(tmp / "logs"),
         "--sampler-interval", "0.25", "--finalize-timeout", "30", str(TRAIN_SCRIPT), "--",
         "--device", "cpu", "--tiny", "--steps", "30"],
        env=env, capture_output=True, text=True, timeout=240, cwd=str(tmp),
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    (session,) = [p for p in (tmp / "logs").iterdir() if p.is_dir()]
    return session


@pytest.mark.parametrize("payload", [MINIMAL, ODD, SECTIONS, KPIS], ids=["minimal", "odd", "sections", "kpis"])
def test_render_equals_the_jax_render_after_the_label_table(payload):
    port = render_html_summary(payload)
    assert port == port_labels(jax_render(payload))
    assert not JAX_WORDS.search(port)


def test_render_of_a_port_run_equals_the_jax_render(summary_run):
    payload = json.loads((summary_run / "final_summary.json").read_text())
    assert payload["sections"]["step_time"]["status"] == "OK"
    port = render_html_summary(payload)
    assert port == port_labels(jax_render(payload))
    assert (summary_run / "final_summary.html").read_text() == port
    assert "TraceML (PyTorch) — final training summary" in port
    assert payload["primary_diagnosis"]["kind"] in port
    assert not JAX_WORDS.search(port)


def test_the_run_writes_html_beside_json_and_txt(summary_run):
    for name in ("final_summary.json", "final_summary.txt", "final_summary.html"):
        assert (summary_run / name).stat().st_size > 0, name


def test_hostile_strings_come_out_escaped():
    host, summary, rank = "<img src=x onerror=alert(1)>", "<script>alert('s')</script>", '1"><b>r</b>'
    payload = json.loads(json.dumps(KPIS))
    payload["primary_diagnosis"].update(summary=summary, ranks=[rank])
    g = payload["sections"]["step_time"]["global"]
    g["rollup"]["worst"]["input"]["idx"] = rank
    g["per_rank"] = {"0": {"identity": {"hostname": host, "node_rank": 0}, "avg_ms": {"step_time": 1.0}},
                     "1": {"identity": {"hostname": host, "node_rank": 1}, "avg_ms": {"step_time": 2.0}}}
    payload["sections"]["step_time"]["issues"] = [{"kind": "K", "severity": "warning", "summary": summary}]
    payload["sections"]["system"] = {"status": "OK", "issues": [], "global": {"nodes": {"0": {"hostname": host}}}}
    html = render_html_summary(payload)
    for raw in (host, summary, rank):
        assert raw not in html
    assert html.count("&lt;img src=x onerror=alert(1)&gt;") == 3  # two rank rows, one node row
    assert html.count("&lt;script&gt;alert(&#x27;s&#x27;)&lt;/script&gt;") == 2  # banner, findings
    assert "1&quot;&gt;&lt;b&gt;r&lt;/b&gt;" in html
    assert html == port_labels(jax_render(payload))


def test_a_failed_html_write_leaves_json_and_txt_and_logs(tmp_path, monkeypatch):
    """The HTML artifact is best-effort: a payload the writer cannot
    render (a step series under a rank key that is no integer) fails the
    HTML write only, and the error log says why."""
    from tests.test_torch_live_display import _seed

    db, writer = _seed(tmp_path, "input_bound")
    writer.finalize()
    attach = final.attach_section_cards

    def attach_and_spoil(payload):
        attach(payload)
        payload["sections"]["step_time"]["global"]["step_series_ms"] = {"rank-x": [1.0, 2.0]}

    monkeypatch.setattr(final, "attach_section_cards", attach_and_spoil)
    log = tmp_path / "error.log"
    monkeypatch.setattr(get_error_log(), "_path", log)
    assert final.generate_summary(db, db.parent, mode="summary")
    session = db.parent
    assert json.loads((session / "final_summary.json").read_text())["primary_diagnosis"]["kind"] == "INPUT_BOUND"
    assert "INPUT_BOUND" in (session / "final_summary.txt").read_text()
    assert not (session / "final_summary.html").exists()
    text = log.read_text()
    assert "final_summary.html write failed" in text and "ValueError" in text

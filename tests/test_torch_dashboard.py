"""The port's browser dashboard (``run --mode dashboard``) against the JAX one.

Ported from ``tests/display/test_browser_driver.py``,
``tests/display/test_serving_delta.py``,
``tests/display/test_section_contracts.py`` (without the fleet and
federation pages, which the port leaves out) and
``tests/aggregator/test_browser_dashboard.py``.

* **Payload parity.**  ``build_web_payload`` of both packages on one
  seeded session DB (``tests/test_torch_live_display.py``'s scenarios,
  written by the port's writer, plus an ``ingest_stats.json``), the JAX
  side on its scalar arm (``TRACEML_COLUMNAR_WINDOW=0
  TRACEML_INCR_WINDOW=0 TRACEML_VECTOR_DIAGNOSIS=0``), the port's with
  its engines on, as by default: the same keys in the same order, equal
  values with ``ts`` aside, floats within 1e-9 relative, the findings'
  actions and summaries through ``tests/test_torch_advice.py``'s table.
  The port's meta fragment also carries ``window_build`` (the engine's
  counters and tick profile), which the JAX scalar arm leaves out; its
  shape against the JAX engine's is held in
  ``tests/test_torch_tick_profile.py``.
* **Serving.**  Deltas replayed in any interleaving equal the full
  payload; an idle delta is a 204 with a stable token; the full payload's
  shape and version; SSE with ``Last-Event-ID`` resume; ETag and gzip on
  ``/api/live`` and ``/api/summary``; four concurrent pollers get
  consistent bodies; ``stop()`` returns promptly with a stream open.
* **Page contracts.**  Every JS element id exists in the markup, every
  phase key has a color, every payload path a section reads resolves in
  the view schema and is present in a real port payload: the history
  strip's paths in the payload of a database whose writer pruned and
  folded rows (a payload before the first fold has no ``history``, as a
  JAX one), the others in the two-rank one; every interpolation is
  escaped or vetted, and the page names no JAX or TPU word.
* **History.**  On a database with folds (the retention stream of
  ``tests/test_torch_retention.py``) the whole payload, its ``history``
  fragment among it, equals the JAX payload's.
* **Routes the port leaves out.**  ``/fleet``, ``/api/sessions`` and a
  ``?session=`` naming another session answer 404.
* **End to end.**  A tiny CPU ``run --mode dashboard``: a probe reads
  ``display_port`` from ``aggregator_ready.json``, gets ``/healthz``,
  ``/`` and ``/api/live`` with the script's stdout lines while the rank
  trains, and keeps an SSE stream open across the run's end; the run
  exits 0 within its finalize budget with ``final_summary.json`` and
  ``final_summary.html`` written.
"""

import dataclasses
import gzip
import http.client
import json
import math
import os
import random
import re
import socket
import subprocess
import sys
import threading
import time
import types
import urllib.request
from pathlib import Path

import pytest

from tests.test_torch_advice import port_advice
from tests.test_torch_html_report import JAX_WORDS
from tests.test_torch_live_display import (
    SCENARIOS,
    _GatingDB,
    _gating_step_rows,
    _jax_scalar_arm,
    _port_engines_on,
    _seed,
)
from traceml_tpu_torch.aggregator.display_drivers.browser import _PAGE, BrowserDisplayDriver, wait_until_ready
from traceml_tpu_torch.aggregator.display_drivers.browser_sections.pages import ALL_SECTIONS
from traceml_tpu_torch.aggregator.trace_aggregator import write_ready_file
from traceml_tpu_torch.renderers import serving
from traceml_tpu_torch.renderers import views as V
from traceml_tpu_torch.renderers import web_payload
from traceml_tpu_torch.reporting.snapshot_store import DOMAINS
from traceml_tpu_torch.utils.atomic_io import atomic_write_json

REPO = Path(__file__).resolve().parent.parent
TRAIN_SCRIPT = REPO / "traceml_tpu_torch" / "dev" / "train_script.py"
FLOAT_REL = 1e-9


@pytest.fixture(autouse=True)
def _fresh_publishers():
    from traceml_tpu.renderers import serving as jax_serving

    serving.close_all_publishers()
    jax_serving.close_all_publishers()
    yield
    serving.close_all_publishers()
    jax_serving.close_all_publishers()


def _ingest_stats(session_dir):
    atomic_write_json(session_dir / "ingest_stats.json", {
        "envelopes_ingested": 42, "frames_received": 40, "rows_dropped": 0, "dropped_by_domain": {},
        "unknown_domain_drops": {}, "queues": {"writer": {"depth": 0, "hwm": 3}},
        "group_commit": {"commits": 7}, "corrupt_frame_drops": {}, "pending_frames_hwm": 2,
        "producers": {"0": {"codec": "msgpack"}}, "final": False, "ts": 1.7e9,
    })


def _engine_keys_aside(port):
    """The port payload less ``ts`` and the ``window_build`` key its
    engines add (present, with a step_time cache and a tick profile)."""
    wb = port["window_build"]
    assert wb["step_time"]["full_rebuilds"] >= 1 and wb["tick_profile"]["ticks"] >= 1
    return {k: v for k, v in port.items() if k not in ("ts", "window_build")}


def _close(a, b, path="$"):
    """Equal, floats within FLOAT_REL relative; the first difference's path."""
    if isinstance(a, float) and isinstance(b, float):
        ok = a == b or (math.isfinite(a) and math.isfinite(b)
                        and abs(a - b) <= FLOAT_REL * max(abs(a), abs(b)))
        return None if ok else path
    if type(a) is not type(b):
        return path
    if isinstance(a, dict):
        if list(a) != list(b):
            return path + " keys"
        for k in a:
            bad = _close(a[k], b[k], f"{path}.{k}")
            if bad:
                return bad
        return None
    if isinstance(a, list):
        if len(a) != len(b):
            return path + " length"
        for i, (x, y) in enumerate(zip(a, b)):
            bad = _close(x, y, f"{path}[{i}]")
            if bad:
                return bad
        return None
    return None if a == b else path


# -- payload parity ------------------------------------------------------


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_payload_equals_the_jax_payload(tmp_path, monkeypatch, name):
    from traceml_tpu.renderers.web_payload import build_web_payload as jax_build

    _jax_scalar_arm(monkeypatch)
    db, writer = _seed(tmp_path, name)
    _ingest_stats(db.parent)
    try:
        jax = jax_build(db, "dash")
        _port_engines_on(monkeypatch)
        port = web_payload.build_web_payload(db, "dash")
    finally:
        writer.finalize()
    assert [k for k in port if k != "window_build"] == list(jax)
    assert list(port)[:3] == ["version", "session", "ts"] and port["version"] == 3
    assert port["collectives"] is None and "serving" not in port and "history" not in port
    assert port["ingest"]["envelopes_ingested"] == 42 and port["rank_status"]["states"]
    assert port["findings"] and port["stdout"]
    jax = port_advice({k: v for k, v in jax.items() if k != "ts"})
    assert _close(_engine_keys_aside(port), jax) is None


def test_fragments_and_token_are_the_jax_ones():
    from traceml_tpu.renderers import web_payload as jax_payload

    assert web_payload.PAYLOAD_VERSION == jax_payload.PAYLOAD_VERSION
    assert web_payload.FRAGMENT_ORDER == jax_payload.FRAGMENT_ORDER
    assert web_payload._FRAGMENT_KEYS == jax_payload._FRAGMENT_KEYS
    # the port's fragments depend only on the domains its store keeps
    for name, deps in web_payload.FRAGMENT_DEPS.items():
        assert set(deps) <= set(DOMAINS), name
        assert set(deps) <= set(jax_payload.FRAGMENT_DEPS[name]), name
    assert serving.parse_token("3:" + ".".join("1" * len(web_payload.FRAGMENT_ORDER)))
    assert serving.parse_token("2:1.1") is None and serving.parse_token("garbled") is None


# -- serving ---------------------------------------------------------------


class _Session:
    """A live session: a seeded DB that the test keeps writing to, and a
    driver serving it."""

    def __init__(self, tmp_path, wait_slice=0.02):
        self.dir = tmp_path / "dash"
        self.dir.mkdir(parents=True)
        self.db = self.dir / "telemetry.sqlite"
        self.writer = _GatingDB(self.db).seed()
        self.step = 21
        ctx = types.SimpleNamespace(db_path=self.db,
                                    settings=types.SimpleNamespace(session_id="dash", session_dir=self.dir))
        self.driver = BrowserDisplayDriver(port=0)
        self.driver.sse_wait_slice = wait_slice
        self.driver.start(ctx)
        assert self.driver.port and wait_until_ready("127.0.0.1", self.driver.port, 5.0)
        # deterministic tests: no rate limit on store refreshes
        serving.publisher_for(self.db, "dash").min_poll_interval = 0

    def write(self, n=5):
        for rank in (0, 1):
            self.writer.ingest("step_time", {"step_time": _gating_step_rows(self.step, n, 50.0 + self.step)}, rank)
        assert self.writer.writer.force_flush()
        self.step += n

    def get(self, path, headers=None):
        conn = http.client.HTTPConnection("127.0.0.1", self.driver.port, timeout=10)
        try:
            conn.request("GET", path, headers=headers or {})
            resp = conn.getresponse()
            return resp.status, dict(resp.getheaders()), resp.read()
        finally:
            conn.close()

    def close(self):
        self.driver.stop()
        self.writer.writer.finalize()


@pytest.fixture
def live(tmp_path):
    s = _Session(tmp_path)
    yield s
    s.close()


def _canon(payload):
    return json.dumps({k: v for k, v in payload.items() if k != "ts"}, sort_keys=True)


def _merge(state, body):
    m = json.loads(body)
    if "fragments" not in m:  # the first fetch, without a token: the flat payload
        return m, None
    for frag in m["fragments"].values():
        state.update(frag)
    return state, m["token"]


@pytest.mark.parametrize("seed", [1307, 7, 2024])
def test_delta_replay_in_any_interleaving_equals_the_full_payload(live, seed):
    rng = random.Random(seed)
    token, state = None, {}
    for _ in range(6):
        live.write()
        if rng.random() < 0.4:
            continue  # the viewer misses this round
        code, headers, body = live.get(f"/api/live?since={token}" if token else "/api/live")
        token = headers.get("X-TraceML-Token", token)
        if code == 204:
            continue
        assert code == 200
        state, new = _merge(state, body)
        token = new or token
    code, _, body = live.get(f"/api/live?since={token}" if token else "/api/live")
    if code == 200:
        state, _ = _merge(state, body)
    code, _, full = live.get("/api/live")
    assert code == 200
    full = json.loads(full)
    assert full["step_time"]["n_steps"] > 0
    assert _canon(state) == _canon(full)


def test_idle_delta_is_204_with_a_stable_token(live):
    code, headers, _ = live.get("/api/live")
    assert code == 200
    token = headers["X-TraceML-Token"]
    for _ in range(2):
        code, headers, body = live.get(f"/api/live?since={token}")
        assert code == 204 and body == b"" and headers["X-TraceML-Token"] == token
    # a garbled token counts as none: every fragment comes back
    code, _, body = live.get("/api/live?since=bogus")
    assert code == 200
    assert set(json.loads(body)["fragments"]) >= {"header", "step_time", "diagnosis"}
    # new rows move only the fragments whose domains they touch
    live.write()
    code, headers, body = live.get(f"/api/live?since={token}")
    assert code == 200 and headers["X-TraceML-Token"] != token
    moved = set(json.loads(body)["fragments"])
    assert "step_time" in moved and not moved & {"header", "system", "process", "stdout", "collectives"}


def test_full_payload_shape_and_version(live):
    code, _, body = live.get("/api/live")
    d = json.loads(body)
    assert code == 200 and d["version"] == 3 and d["session"] == "dash"
    assert list(d)[:3] == ["version", "session", "ts"]
    for key in ("step_time", "memory", "collectives", "system", "process", "stdout", "diagnosis", "findings"):
        assert key in d
    assert d["step_time"]["n_steps"] == 20 and len(d["step_time"]["step_series"]) == 2
    assert d["stdout"] == [{"stream": "stdout", "line": "hello"}]


def _read_sse_event(resp, max_lines=200):
    event = {}
    for _ in range(max_lines):
        line = resp.fp.readline()
        if not line:
            break
        line = line.decode().rstrip("\n")
        if line == "":
            if event:
                return event
            continue
        field, _, value = line.partition(": ")
        event[field] = value
    return event or None


def test_sse_stream_and_last_event_id_resume(live):
    conn = http.client.HTTPConnection("127.0.0.1", live.driver.port, timeout=10)
    conn.request("GET", "/api/stream")
    resp = conn.getresponse()
    assert resp.status == 200 and resp.getheader("Content-Type") == "text/event-stream"
    first = _read_sse_event(resp)
    conn.close()  # the viewer drops mid-stream
    assert first["event"] == "fragment"
    token = first["id"]
    m1 = json.loads(first["data"])
    assert m1["token"] == token and set(m1["fragments"]) >= {"header", "step_time"}
    live.write()  # rows land while the viewer is away
    conn = http.client.HTTPConnection("127.0.0.1", live.driver.port, timeout=10)
    conn.request("GET", "/api/stream", headers={"Last-Event-ID": token})
    second = _read_sse_event(conn.getresponse())
    conn.close()
    m2 = json.loads(second["data"])
    assert second["event"] == "fragment" and "step_time" in m2["fragments"]
    assert "header" not in m2["fragments"]  # constant, never resent
    state = {}
    for m in (m1, m2):
        for frag in m["fragments"].values():
            state.update(frag)
    code, _, full = live.get("/api/live")
    assert code == 200 and _canon(state) == _canon(json.loads(full))


def test_live_etag_and_gzip(live):
    code, headers, plain = live.get("/api/live")
    assert code == 200
    etag = headers["ETag"]
    assert etag == '"' + headers["X-TraceML-Token"] + '"'
    code, _, body = live.get("/api/live", {"If-None-Match": etag})
    assert code == 304 and body == b""
    code, headers, gz = live.get("/api/live", {"Accept-Encoding": "gzip"})
    assert code == 200 and headers.get("Content-Encoding") == "gzip"
    assert _canon(json.loads(gzip.decompress(gz))) == _canon(json.loads(plain))
    live.write()
    code, headers, _ = live.get("/api/live", {"If-None-Match": etag})
    assert code == 200 and headers["ETag"] != etag


def test_summary_404_then_etag_and_gzip(live):
    code, _, _ = live.get("/api/summary")
    assert code == 404
    summary = {"primary_diagnosis": {"kind": "INPUT_BOUND", "severity": "warning", "summary": "input"},
               "sections": {"pad": "x" * 600}, "meta": {}}  # over the gzip threshold
    (live.dir / "final_summary.json").write_text(json.dumps(summary))
    code, headers, plain = live.get("/api/summary")
    assert code == 200 and json.loads(plain) == summary
    etag = headers["ETag"]
    code, _, body = live.get("/api/summary", {"If-None-Match": etag})
    assert code == 304 and body == b""
    code, headers, gz = live.get("/api/summary", {"Accept-Encoding": "gzip"})
    assert code == 200 and headers.get("Content-Encoding") == "gzip" and gzip.decompress(gz) == plain


def test_four_concurrent_pollers_get_consistent_bodies(live):
    """Four viewers poll full bodies and deltas while rows land; every
    body parses, every viewer's merged state ends equal to a fresh full
    read, and the publisher's one computer is never entered twice."""
    errors, states = [], {}
    stop = threading.Event()

    def viewer(i):
        token, state = None, {}
        try:
            while True:
                done = stop.is_set()
                code, headers, body = live.get(f"/api/live?since={token}" if token and i % 2 else "/api/live")
                assert code in (200, 204), code
                if code == 200:
                    state, new = _merge(state if token and i % 2 else {}, body)
                    token = new or headers["X-TraceML-Token"]
                if done:
                    break
            states[i] = state
        except Exception as exc:  # reported below
            errors.append(repr(exc))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=viewer, args=(i,)) for i in range(4)]
        for t in threads:
            t.start()
        for _ in range(5):
            live.write()
        stop.set()
        for t in threads:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert errors == []
    code, _, full = live.get("/api/live")
    assert code == 200
    full = _canon(json.loads(full))
    assert sorted(states) == [0, 1, 2, 3] and all(_canon(s) == full for s in states.values())
    assert json.loads(full)["step_time"]["n_steps"] == 45


def test_left_out_routes_answer_404(live):
    for path in ("/fleet", "/api/sessions", "/api/live?session=other", "/api/stream?session=other",
                 "/api/summary?session=other", "/?session=other"):
        code, _, _ = live.get(path)
        assert code == 404, path
    code, _, _ = live.get("/api/live?session=dash")
    assert code == 200


def test_stop_returns_promptly_with_a_stream_open(tmp_path):
    s = _Session(tmp_path, wait_slice=0.25)
    conn = http.client.HTTPConnection("127.0.0.1", s.driver.port, timeout=10)
    conn.request("GET", "/api/stream")
    resp = conn.getresponse()
    assert _read_sse_event(resp)["event"] == "fragment"
    t0 = time.monotonic()
    s.close()
    assert time.monotonic() - t0 < 3.0
    # the stream ends once the driver stopped
    deadline = time.monotonic() + 5.0
    while resp.fp.readline() and time.monotonic() < deadline:
        pass
    assert time.monotonic() < deadline
    conn.close()


def test_server_serves_page_healthz_and_a_bare_driver(tmp_path):
    driver = BrowserDisplayDriver()
    driver.start(None)  # no context: an empty payload, not a 404
    try:
        assert wait_until_ready("127.0.0.1", driver.port, 5.0)
        with urllib.request.urlopen(f"http://127.0.0.1:{driver.port}/", timeout=5) as resp:
            assert resp.status == 200 and resp.headers["Content-Type"].startswith("text/html")
            page = resp.read().decode()
        assert page == _PAGE and "TraceML (PyTorch)" in page
        with urllib.request.urlopen(f"http://127.0.0.1:{driver.port}/healthz", timeout=5) as resp:
            health = json.loads(resp.read())
        assert health["ok"] is True and health["session"] == ""
        with urllib.request.urlopen(f"http://127.0.0.1:{driver.port}/api/live", timeout=5) as resp:
            assert json.loads(resp.read()) == {}
    finally:
        driver.stop()


def test_a_failed_bind_leaves_no_display_port(tmp_path, capsys):
    with socket.socket() as taken:
        taken.bind(("127.0.0.1", 0))
        taken.listen(1)
        driver = BrowserDisplayDriver(port=taken.getsockname()[1])
        driver.start(None)
        driver.stop()
    assert driver.port is None and "[TraceML] dashboard:" not in capsys.readouterr().out
    settings = types.SimpleNamespace(session_dir=tmp_path)
    write_ready_file(settings, 1234, display_port=driver.port)
    assert "display_port" not in json.loads((tmp_path / "aggregator_ready.json").read_text())
    write_ready_file(settings, 1234, display_port=4321)
    assert json.loads((tmp_path / "aggregator_ready.json").read_text())["display_port"] == 4321


# -- page contracts --------------------------------------------------------

_EFFICIENCY_KEYS = {
    "achieved_tflops_by_rank", "achieved_tflops_median", "device_count", "device_kind", "flops_per_step",
    "flops_source", "mfu_median", "peak_flops", "peak_tflops", "tokens_per_step", "tokens_per_sec_median",
}
_ISSUE_KEYS = {"kind", "severity", "summary", "action", "domain", "confidence", "confidence_label"}
# the history strip's schema (the stitched rollup tiers'); a payload has
# it once the writer's first prune folded rows
_HISTORY_SCHEMA = {"step_time": {"points": {"t", "mean_ms", "min_ms", "max_ms", "res"}, "ranks": True}}
_ROOTS = {
    "ts": None, "step_time": V.StepTimeView, "memory": V.MemoryView, "system": V.SystemView,
    "process": V.ProcessView, "diagnosis": _ISSUE_KEYS, "findings": _ISSUE_KEYS,
    "stdout": {"stream", "line"}, "history": _HISTORY_SCHEMA,
}
_CHILD_TYPES = {
    ("StepTimeView", "phases"): V.PhaseStat, ("StepTimeView", "coverage"): V.Coverage,
    ("MemoryView", "ranks"): V.MemoryRankStat, ("SystemView", "nodes"): V.NodeSystemStat,
    ("SystemView", "rollups"): V.ClusterRollup, ("NodeSystemStat", "devices"): V.DeviceStat,
    ("ProcessView", "ranks"): V.ProcessRankStat,
}
_DICT_LEAVES = {"phase_stack", "step_series", "per_rank_avg_ms", "occupancy_by_rank"}
_EXTRA_FIELDS = {"SystemView": {"is_cluster"}}


def _fields(cls):
    return {f.name for f in dataclasses.fields(cls)} | _EXTRA_FIELDS.get(cls.__name__, set())


def _resolve(path):
    """The JAX contract test's resolution of a payload path in the view
    schema."""
    parts = path.split(".")
    root = _ROOTS.get(parts[0], KeyError)
    if root is KeyError:
        return False
    if root is None or len(parts) == 1:
        return True
    node = root
    for i, seg in enumerate(parts[1:], start=1):
        if isinstance(node, dict):
            node = node.get(seg, False)
            if node is False:
                return False
            if node is True:
                return i == len(parts) - 1
            continue
        if isinstance(node, set):
            return seg in node and i == len(parts) - 1
        if not dataclasses.is_dataclass(node):
            return False
        if seg == "efficiency" and node is V.StepTimeView:
            rest = parts[i + 1:]
            return not rest or (len(rest) == 1 and rest[0] in _EFFICIENCY_KEYS)
        if seg in _DICT_LEAVES and seg in _fields(node):
            return i == len(parts) - 1
        if seg not in _fields(node):
            return False
        node = _CHILD_TYPES.get((node.__name__, seg), True)
    return node is not False


def _present(payload, path):
    """Whether a real payload holds the path (through the first element of
    each list; ``None`` when a list or value on the way is empty)."""
    node = payload
    for seg in path.split("."):
        while isinstance(node, list):
            if not node:
                return None
            node = node[0]
        if node is None:
            return None
        if not isinstance(node, dict) or seg not in node:
            return False
        node = node[seg]
    return True


@pytest.fixture(scope="module")
def real_payload(tmp_path_factory):
    """A real port payload: the two-rank session of the live display's
    tests, with its ingest stats."""
    tmp = tmp_path_factory.mktemp("contract")
    db, writer = _seed(tmp, "two_ranks")
    _ingest_stats(db.parent)
    try:
        return web_payload.build_web_payload(db, "contract")
    finally:
        writer.finalize()
        serving.close_all_publishers()


@pytest.fixture(scope="module")
def folded_payload(tmp_path_factory):
    """A port payload of a database whose writer pruned and folded rows
    (two ranks, retention 12; the retention tests' stream)."""
    from tests.test_torch_retention import WINDOW, _stream
    from traceml_tpu_torch.aggregator.sqlite_writer import SQLiteWriter
    from traceml_tpu_torch.telemetry.envelope import normalize_telemetry_envelope

    db = tmp_path_factory.mktemp("folded") / "telemetry.sqlite"
    writer = SQLiteWriter(db, summary_window_rows=WINDOW)
    writer.start()
    for tick in _stream():
        for p in tick:
            writer.ingest(normalize_telemetry_envelope(json.loads(json.dumps(p))))
        writer.force_flush(timeout=30)
    assert writer.finalize(timeout=30)
    _ingest_stats(db.parent)
    try:
        return db, web_payload.build_web_payload(db, "folded")
    finally:
        serving.close_all_publishers()


def test_payload_with_history_equals_the_jax_payload(folded_payload, monkeypatch):
    from traceml_tpu.renderers.web_payload import build_web_payload as jax_build

    _jax_scalar_arm(monkeypatch)
    db, port = folded_payload
    jax = jax_build(db, "folded")
    assert [k for k in port if k != "window_build"] == list(jax) and "history" in port
    assert port["history"]["step_time"]["ranks"] == 2 and port["history"]["step_time"]["points"]
    jax = port_advice({k: v for k, v in jax.items() if k != "ts"})
    assert _close(_engine_keys_aside(port), jax) is None


def test_every_js_element_id_exists_in_the_markup():
    used = set(re.findall(r'getElementById\("([\w-]+)"\)', _PAGE))
    declared = set(re.findall(r'id="([\w-]+)"', _PAGE))
    assert used - declared == set()


def test_every_phase_key_has_a_chart_color():
    from traceml_tpu_torch.utils.step_time_window import ACCOUNTED_PHASES, RESIDUAL_KEY

    m = re.search(r"const COLORS=\{(.*?)\};", _PAGE, re.S)
    colors = set(re.findall(r"(\w+):\"", m.group(1)))
    assert set(ACCOUNTED_PHASES) | {RESIDUAL_KEY} <= colors


def test_the_page_names_the_port_and_no_jax_word():
    from traceml_tpu.aggregator.display_drivers.browser import _PAGE as jax_page

    assert not JAX_WORDS.search(_PAGE)
    assert "<title>TraceML (PyTorch) live</title>" in _PAGE and "TraceML <b>(PyTorch)</b>" in _PAGE
    assert "GPU busy" in _PAGE and "NVML utilization" in _PAGE
    # the same element ids, the same payload reads and the same client
    assert set(re.findall(r'id="([\w-]+)"', _PAGE)) == set(re.findall(r'id="([\w-]+)"', jax_page))
    assert set(re.findall(r"\bd\.(\w+)", _PAGE)) == set(re.findall(r"\bd\.(\w+)", jax_page))
    assert _PAGE.count("esc(") == jax_page.count("esc(")


def test_js_top_level_reads_exist_in_a_real_payload(real_payload, folded_payload):
    top = set(re.findall(r"\bd\.(\w+)", _PAGE))
    assert top - set(real_payload) == {"history"}  # no fold yet
    assert top - set(folded_payload[1]) == set()
    st = real_payload["step_time"]
    for key in ("phase_stack", "step_series", "phases", "coverage", "n_steps", "clock", "latest_ts", "steps"):
        assert key in st
    assert real_payload["memory"]["ranks"] and "pressure" in real_payload["memory"]["ranks"][0]
    assert real_payload["process"]["ranks"] and "rss_bytes" in real_payload["process"]["ranks"][0]
    assert real_payload["system"]["nodes"][0]["devices"][0]["utilization_pct"] is not None


def test_sections_declare_contracts():
    for s in ALL_SECTIONS:
        assert s.contract or s.id == "summary", s.id


@pytest.mark.parametrize("section", ALL_SECTIONS, ids=lambda s: s.id)
def test_contract_paths_resolve_and_are_present(section, real_payload, folded_payload):
    assert [p for p in section.contract if not _resolve(p)] == []

    def present(path):
        if path.startswith("history."):  # the strip's paths, from the payload with folds
            return _present(folded_payload[1], path) is True
        return _present(real_payload, path) is not False

    assert [p for p in section.contract if not present(p)] == []


def test_every_section_render_fn_is_defined_and_called_once():
    tick_body = _PAGE[_PAGE.index("async function tick()"):]
    for s in ALL_SECTIONS:
        assert f"function render_{s.id}(" in _PAGE
        if s.js:
            assert _PAGE.count(f"render_{s.id}(d);") == 1
        else:  # driven by another section's render fn (the gauge by render_system)
            assert f"render_{s.id}(d);" not in tick_body


@pytest.mark.parametrize("section", [s for s in ALL_SECTIONS if s.js], ids=lambda s: s.id)
def test_section_js_ids_exist_on_the_page(section):
    used = set(re.findall(r'getElementById\("([\w-]+)"\)', section.js))
    declared = set(re.findall(r'id="([\w-]+)"', _PAGE))
    assert {u for u in used - declared if not u.startswith("kpi-")} == set()


def test_dynamic_kpi_ids_are_built_by_their_section():
    set_keys = set(re.findall(r'setKpi\("([\w-]+)"', _PAGE))
    tile_keys = set(re.findall(r'kpiTile\("([\w-]+)"', _PAGE))
    tile_keys |= set(re.findall(r'\["([\w-]+)","[A-Z0-9 %]+",', _PAGE))
    assert set_keys - tile_keys == set()


_SAFE_MARKERS = (
    "esc(", "fmtB(", "fmtMs(", "pct(", "meter(", "kpiTile(", "sparkPath(",
    "rankColor(", "heatColor(", ".toFixed(", "COLORS[", "SEV[", "Math.",
)
_STALE_TERNARY = "s.stale?'<span class=\"badge stale\">stale</span>':\"\""
# the JAX test's audited locals: accumulated HTML whose every input was
# escaped or formatted, numeric locals, and text assigned to textContent
_VETTED = {
    "hero": {"w>=7?esc(p.key):\"\"", "chips", "st.n_steps", "st.clock", "cov.ranks_present", "cov.world_size"},
    "step_time": {"h", "bars", "paths", "stepId", "i", "rankPair", 'rankHidden.has(r)?" off":""',
                  "band", "mean", "pts.length"},
    "memory": {"spark", "worst", "hot", "g?(g>0?\"+\":\"-\")+fmtB(Math.abs(g)):\"—\"", _STALE_TERNARY},
    "system": {"paths", "v", "src", "LEN", _STALE_TERNARY.replace("s.stale", "n.stale")},
    "process": {"hot", _STALE_TERNARY},
    "diagnostics": set(),
    "cluster": {"label", "s.nodes.length", "s.expected_nodes", "s.missing_nodes"},
    "summary": {"chips"},
    "output": set(),
    "gauge": set(),
}


@pytest.mark.parametrize("section", [s for s in ALL_SECTIONS if s.js], ids=lambda s: s.id)
def test_every_interpolation_is_escaped_or_vetted(section):
    vetted = _VETTED[section.id]
    bad = []
    for m in re.finditer(r"\$\{([^{}]+)\}", section.js):
        expr = m.group(1).strip()
        if any(mark in expr for mark in _SAFE_MARKERS) or expr in vetted:
            continue
        # ternaries whose every branch is a JS string literal are inert
        if re.fullmatch(r"""[\w.!&|=<>()\s?:"'\-+—%]*""", expr) and ('"' in expr or "'" in expr) \
                and not re.search(r"\w\s*\.\s*\w+\s*[^(]", expr):
            continue
        bad.append(expr)
    assert bad == []


# -- end to end --------------------------------------------------------------


def _probe(logs, out, stop):
    """While the run lasts: find ``display_port`` in the session's ready
    file, read ``/healthz``, ``/`` and ``/api/live`` until the script's
    stdout lines show, then hold an SSE stream open until the server ends
    it."""
    deadline = time.monotonic() + 120
    ready = None
    while ready is None and time.monotonic() < deadline and not stop.is_set():
        for path in logs.glob("*/aggregator_ready.json"):
            data = json.loads(path.read_text())
            if "display_port" in data:
                ready = data
        time.sleep(0.05)
    if ready is None:
        return
    base = f"http://127.0.0.1:{ready['display_port']}"
    out["port"] = ready["display_port"]
    with urllib.request.urlopen(base + "/healthz", timeout=5) as resp:
        out["health"] = json.loads(resp.read())
    with urllib.request.urlopen(base + "/", timeout=5) as resp:
        out["page"] = resp.read().decode()
    while time.monotonic() < deadline:
        with urllib.request.urlopen(base + "/api/live", timeout=5) as resp:
            live = json.loads(resp.read())
        if live.get("stdout") and (live.get("step_time") or {}).get("n_steps"):
            out["live"] = live
            break
        time.sleep(0.1)
    conn = http.client.HTTPConnection("127.0.0.1", ready["display_port"], timeout=60)
    conn.request("GET", "/api/stream")
    resp = conn.getresponse()
    out["events"] = 0
    while True:
        event = _read_sse_event(resp)
        if not event:
            break
        out["events"] += event.get("event") == "fragment"
    out["stream_closed_at"] = time.monotonic()
    conn.close()


def test_run_dashboard_mode_end_to_end(tmp_path):
    logs = tmp_path / "logs"
    env = {**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1"}
    got, stop = {}, threading.Event()
    probe = threading.Thread(target=_probe, args=(logs, got, stop), daemon=True)
    probe.start()
    t0 = time.monotonic()
    try:
        proc = subprocess.run(
            [sys.executable, "-m", "traceml_tpu_torch", "run", "--mode", "dashboard", "--logs-dir", str(logs),
             "--sampler-interval", "0.25", "--finalize-timeout", "20", str(TRAIN_SCRIPT), "--",
             "--device", "cpu", "--tiny", "--steps", "80", "--delay-ms", "40"],
            env=env, capture_output=True, text=True, timeout=240, cwd=str(tmp_path),
        )
    finally:
        stop.set()
        probe.join(timeout=30)
    wall = time.monotonic() - t0
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert not probe.is_alive()
    assert f"[TraceML] dashboard: http://127.0.0.1:{got['port']}/" in proc.stdout
    (session,) = [p for p in logs.iterdir() if p.is_dir()]
    assert got["health"]["ok"] is True and got["health"]["session"] == session.name
    assert got["page"] == _PAGE
    live = got["live"]
    assert live["version"] == 3 and live["session"] == session.name
    assert live["stdout"][0]["line"].startswith("train_script: ")
    assert got["events"] >= 1 and got["stream_closed_at"] - t0 <= wall  # ended by the run's end
    payload = json.loads((session / "final_summary.json").read_text())
    assert payload["meta"]["mode"] == "dashboard" and payload["sections"]["step_time"]["global"]["n_steps"] == 80
    assert payload["primary_diagnosis"]["kind"] in (session / "final_summary.html").read_text()
    manifest = json.loads((session / "manifest.json").read_text())
    assert (manifest["status"], manifest["telemetry_status"]) == ("completed", "ok")
    assert manifest["finalize_sec"] < 20
    stored = json.loads((session / "aggregator_ready.json").read_text())
    assert stored["display_port"] == got["port"]


def test_the_hero_reads_the_step_row_the_views_emit():
    """A repair against the JAX page, whose hero looks for a phase keyed
    ``step`` that the views never emit, so its median-step, worst-step,
    rank-gap and worst-rank tiles stay empty."""
    from traceml_tpu.aggregator.display_drivers.browser_sections.hero import SECTION as JAX_HERO
    from traceml_tpu_torch.aggregator.display_drivers.browser_sections.hero import SECTION as HERO
    from traceml_tpu_torch.utils.step_time_window import STEP_KEY

    assert STEP_KEY == "step_time"
    assert 'find(p=>p.key==="step_time")' in HERO.js and 'p.key!=="step_time"' in HERO.js
    assert 'find(p=>p.key==="step")' in JAX_HERO.js
    assert HERO.js.replace('"step_time"', '"step"') == JAX_HERO.js

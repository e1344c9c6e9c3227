"""The browser dashboard of ``--mode dashboard``: a stdlib HTTP server in
the aggregator process.

Counterpart of ``traceml_tpu/aggregator/display_drivers/browser.py`` on
the JAX driver's branch without a session registry: it serves only the
session it is bound to.  The page is assembled once by
``browser_sections/pages.py``; every payload body comes from the
session's ``SessionPublisher`` (``renderers/serving.py``), which
serializes each fragment once per (domain, version) and shares the bytes
across connections.

* ``GET /``            the dashboard page
* ``GET /api/live``    the full payload (strong ETag = the version token,
  ``If-None-Match`` → 304, gzip when accepted); with ``?since=<token>``
  a delta of the fragments whose version advanced, or 204 with
  ``X-TraceML-Token`` when none did
* ``GET /api/stream``  SSE push of the same deltas (``id:`` = the token,
  a heartbeat, ``Last-Event-ID`` resume)
* ``GET /api/summary`` ``final_summary.json`` once it exists (content-hash
  ETag, gzip)
* ``GET /healthz``     ``{"ok": true, "session": ..., "ts": ...}``, which
  ``wait_until_ready()`` polls

Left out with the session registry and the federation tier (ROADMAP
queue 1 item 5): the fleet page, ``/api/sessions`` and hop compression.
``/fleet``, ``/api/sessions`` and a ``?session=`` naming another session
answer 404; a body ships as identity bytes unless the client accepts
gzip.

The server binds ``127.0.0.1`` on an ephemeral port and prints
``[TraceML] dashboard: http://<host>:<port>/`` on the launcher's stdout;
the aggregator writes the port into ``aggregator_ready.json``.  A failed
bind is logged and the run goes on without a dashboard.  Every
telemetry-derived string is escaped by ``esc()`` in the page: the ingest
port is unauthenticated.
"""

from __future__ import annotations

import gzip as _gzip
import hashlib
import json
import threading
import time
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

from traceml_tpu_torch.aggregator.display_drivers.base import BaseDisplayDriver
from traceml_tpu_torch.aggregator.display_drivers.browser_sections.pages import build_page
from traceml_tpu_torch.renderers.serving import GZIP_MIN_BYTES, close_all_publishers, publisher_for
from traceml_tpu_torch.utils.atomic_io import read_json
from traceml_tpu_torch.utils.error_log import get_error_log

_PAGE = build_page()


def wait_until_ready(host: str, port: int, timeout: float = 10.0) -> bool:
    """Poll the dashboard's ``/healthz`` until it answers, so callers never
    race the bind."""
    import urllib.request

    deadline = time.monotonic() + timeout
    url = f"http://{host}:{port}/healthz"
    while time.monotonic() < deadline:
        try:
            with urllib.request.urlopen(url, timeout=1.0) as resp:
                if resp.status == 200:
                    return True
        except OSError:
            pass
        time.sleep(0.05)
    return False


class BrowserDisplayDriver(BaseDisplayDriver):
    """Serves the dashboard from inside the aggregator process."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0) -> None:
        self._host = host
        self._requested_port = port
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        self.port: Optional[int] = None
        self._db_path: Optional[Path] = None
        self._session = ""
        self._session_dir: Optional[Path] = None
        self._stopping = threading.Event()
        #: SSE cadence (instance attributes, so tests can tighten them)
        self.sse_heartbeat_sec = 10.0
        self.sse_wait_slice = 0.25
        # final_summary.json body cache: (mtime, size), etag, raw bytes
        self._summary_cache: Optional[Tuple[Tuple[float, int], str, bytes]] = None
        self._summary_lock = threading.Lock()

    def _publisher(self):
        """The bound session's publisher, or None for a driver started
        without a context (an empty payload, not a 404)."""
        if self._db_path is None:
            return None
        return publisher_for(self._db_path, self._session)

    def _summary_entry(self) -> Optional[Tuple[Tuple[float, int], str, bytes]]:
        """``final_summary.json``'s body and content-hash ETag, cached on
        the file's (mtime, size); None until the file exists."""
        if self._session_dir is None:
            return None
        path = Path(self._session_dir) / "final_summary.json"
        try:
            st = path.stat()
        except OSError:
            return None
        stamp = (st.st_mtime, st.st_size)
        with self._summary_lock:
            if self._summary_cache is not None and self._summary_cache[0] == stamp:
                return self._summary_cache
            data = read_json(path)
            if not data:
                return None
            raw = json.dumps(data).encode()
            self._summary_cache = (stamp, '"' + hashlib.sha1(raw).hexdigest() + '"', raw)
            return self._summary_cache

    # -- lifecycle -------------------------------------------------------

    def start(self, context: Optional[Any] = None) -> None:
        try:
            if context is not None:
                self._db_path = context.db_path
                self._session = context.settings.session_id
                self._session_dir = context.settings.session_dir
            self._stopping.clear()
            driver = self

            class Handler(BaseHTTPRequestHandler):
                def log_message(self, fmt, *args):  # silence
                    pass

                def _accepts_gzip(self) -> bool:
                    return "gzip" in (self.headers.get("Accept-Encoding") or "")

                def _send(self, code: int, body: bytes, ctype: str,
                          headers: Optional[Dict[str, str]] = None, gzip_ok: bool = False) -> None:
                    enc = None
                    if gzip_ok and len(body) >= GZIP_MIN_BYTES and self._accepts_gzip():
                        body = _gzip.compress(body, mtime=0)
                        enc = "gzip"
                    self.send_response(code)
                    self.send_header("Content-Type", ctype)
                    if enc:
                        self.send_header("Content-Encoding", enc)
                    for k, v in (headers or {}).items():
                        self.send_header(k, v)
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)

                def _api_live(self, query: Dict[str, list]) -> None:
                    pub = driver._publisher()
                    if pub is None:
                        self._send(200, b"{}", "application/json")
                        return
                    since = (query.get("since") or [None])[0]
                    if since is not None:
                        body, token = pub.delta_body(since)
                        if body is None:
                            self._send(204, b"", "application/json", headers={"X-TraceML-Token": token})
                        else:
                            self._send(200, body, "application/json",
                                       headers={"X-TraceML-Token": token}, gzip_ok=True)
                        return
                    # full payload: strong ETag == the quoted version token
                    inm = (self.headers.get("If-None-Match") or "").strip()
                    token = pub.poll()
                    if inm and inm == f'"{token}"':
                        self._send(304, b"", "application/json",
                                   headers={"ETag": f'"{token}"', "X-TraceML-Token": token})
                        return
                    body, token, enc = pub.full_body(accept_gzip=self._accepts_gzip())
                    headers = {"ETag": f'"{token}"', "X-TraceML-Token": token}
                    if enc:
                        headers["Content-Encoding"] = enc
                    self._send(200, body, "application/json", headers=headers)

                def _api_summary(self) -> None:
                    entry = driver._summary_entry()
                    if entry is None:
                        self._send(404, json.dumps({"error": "not ready"}).encode(), "application/json")
                        return
                    _, etag, raw = entry
                    inm = (self.headers.get("If-None-Match") or "").strip()
                    if inm and inm == etag:
                        self._send(304, b"", "application/json", headers={"ETag": etag})
                        return
                    self._send(200, raw, "application/json", headers={"ETag": etag}, gzip_ok=True)

                def _api_stream(self, query: Dict[str, list]) -> None:
                    pub = driver._publisher()
                    if pub is None:
                        self._send(404, b'{"error": "unknown session"}', "application/json")
                        return
                    # resume point: a browser replays the last event id on
                    # reconnect, other clients may pass ?since=; a stale or
                    # garbled token selects every fragment
                    since = self.headers.get("Last-Event-ID") or (query.get("since") or [None])[0]
                    self.send_response(200)
                    self.send_header("Content-Type", "text/event-stream")
                    self.send_header("Cache-Control", "no-cache")
                    self.end_headers()
                    last_write = time.monotonic()
                    # each wait is one slice, so stop() ends the stream
                    # within sse_wait_slice
                    while not driver._stopping.is_set() and not pub.closed:
                        body, token = pub.delta_body(since)
                        if body is not None:
                            self.wfile.write(b"id: " + token.encode("ascii") + b"\nevent: fragment\ndata: "
                                             + body + b"\n\n")
                            self.wfile.flush()
                            since = token
                            last_write = time.monotonic()
                        else:
                            pub.wait_for_change(since, timeout=driver.sse_wait_slice)
                        if time.monotonic() - last_write >= driver.sse_heartbeat_sec:
                            self.wfile.write(b"event: hb\ndata: {}\n\n")
                            self.wfile.flush()
                            last_write = time.monotonic()

                def do_GET(self):  # noqa: N802
                    try:
                        parts = urllib.parse.urlsplit(self.path)
                        route = parts.path
                        query = urllib.parse.parse_qs(parts.query)
                        session_param = (query.get("session") or [None])[0]
                        if session_param is not None and session_param != driver._session:
                            self._send(404, b'{"error": "unknown session"}', "application/json")
                        elif route == "/" or route.startswith("/index"):
                            self._send(200, _PAGE.encode(), "text/html; charset=utf-8", gzip_ok=True)
                        elif route.startswith("/healthz"):
                            self._send(200, json.dumps({"ok": True, "session": driver._session,
                                                        "ts": time.time()}).encode(), "application/json")
                        elif route.startswith("/api/stream"):
                            self._api_stream(query)
                        elif route.startswith("/api/live"):
                            self._api_live(query)
                        elif route.startswith("/api/summary"):
                            self._api_summary()
                        else:
                            self._send(404, b"not found", "text/plain")
                    except (BrokenPipeError, ConnectionResetError):
                        pass
                    except Exception as exc:
                        try:
                            self._send(500, str(exc).encode(), "text/plain")
                        except Exception:
                            pass

            class _Server(ThreadingHTTPServer):
                # socketserver's default listen backlog (5) drops SYNs when
                # several viewers connect at once; each drop costs the
                # client a 1 s retransmit
                request_queue_size = 128

            self._httpd = _Server((self._host, self._requested_port), Handler)
            self.port = self._httpd.server_address[1]
            self._thread = threading.Thread(target=self._httpd.serve_forever, name="traceml-dashboard",
                                            daemon=True)
            self._thread.start()
            print(f"[TraceML] dashboard: http://{self._host}:{self.port}/", flush=True)
        except Exception as exc:
            get_error_log().warning("browser dashboard start failed", exc)
            self._httpd = None
            self.port = None

    def tick(self, context: Optional[Any] = None) -> None:
        pass  # the page pulls: it polls or streams /api/*

    def stop(self) -> None:
        self._stopping.set()
        if self._httpd is not None:
            try:
                self._httpd.shutdown()
                self._httpd.server_close()
            except Exception:
                pass
            self._httpd = None
        # an open SSE stream sees the closed publisher (or _stopping)
        # within one wait slice and returns
        close_all_publishers()

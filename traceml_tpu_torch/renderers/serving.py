"""Serving tier: version-keyed publication of the dashboard payload to
any number of viewers.

Counterpart of ``traceml_tpu/renderers/serving.py`` (without the fleet
index's ``fragment`` peek, which serves the JAX session registry).  Each
fragment's JSON encode is timed into the store's tick profiler as its
``serialize`` stage.

One :class:`SessionPublisher` per live session owns the session's
``LiveComputer`` and a cache of serialized payload fragments keyed on the
snapshot store's per-domain versions.  However many page tabs, delta
pollers or SSE streams are attached, each fragment is rebuilt and
JSON-encoded at most once per version change:

- ``poll()`` refreshes the store (at most once per ``min_poll_interval``,
  so M viewers share one refresh), rebuilds only the fragments whose
  dependency versions advanced, and bumps a fragment's published version
  only when its serialized bytes changed (a store write that leaves the
  view as it was publishes nothing).
- the **version token** ``"{PAYLOAD_VERSION}:v.v.v..."`` carries every
  fragment's published version in ``FRAGMENT_ORDER`` position.  Clients
  echo it back (``?since=`` or SSE ``Last-Event-ID``) and receive only
  the fragments whose version differs; after any gap a stale token just
  selects more fragments, so a reconnect needs no server-side event log.
- delta and full bodies are spliced from the cached per-fragment bytes;
  the full body and its gzip form are also cached for ``full_ttl``
  seconds, so every viewer inside one UI tick shares the same bytes.

The publisher serializes every reader with one ``Condition`` over an
``RLock``: the HTTP handler threads and the SSE loops all reach the one
``LiveComputer`` and its SQLite read connection through it.
"""

from __future__ import annotations

import gzip
import json
import threading
import time
from collections import OrderedDict
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

from traceml_tpu_torch.renderers.compute import LiveComputer
from traceml_tpu_torch.renderers.web_payload import (
    FRAGMENT_DEPS,
    FRAGMENT_ORDER,
    PAYLOAD_VERSION,
    build_fragment,
)

#: responses smaller than this are not worth gzipping
GZIP_MIN_BYTES = 256


def parse_token(token: Optional[str]) -> Optional[Dict[str, int]]:
    """Version token → {fragment: version}, or None when absent/garbled/
    from another payload generation (caller then serves everything)."""
    if not token:
        return None
    try:
        gen, sep, rest = token.partition(":")
        if not sep or int(gen) != PAYLOAD_VERSION:
            return None
        parts = rest.split(".")
        if len(parts) != len(FRAGMENT_ORDER):
            return None
        return {n: int(v) for n, v in zip(FRAGMENT_ORDER, parts)}
    except (TypeError, ValueError):
        return None


class SessionPublisher:
    """Owns one session's computer + serialized-fragment cache; thread-safe
    (every HTTP handler thread of the serving tier reads through it)."""

    def __init__(
        self, db_path: Path, session: str, window_steps: int = 150
    ) -> None:
        self.db_path = Path(db_path)
        self.session = session
        self.window_steps = window_steps
        self._computer = LiveComputer(self.db_path, window_steps=window_steps)
        self._cond = threading.Condition(threading.RLock())
        #: minimum seconds between store refreshes — M viewers polling in
        #: one interval share a single refresh (tests/benches may set 0)
        self.min_poll_interval = 0.2
        #: assembled full body reuse window (~one UI tick); bounds how
        #: stale the ``ts`` stamp shared between viewers can get, well
        #: under the dashboard's 5 s staleness badge threshold
        self.full_ttl = 0.5
        self._last_poll = 0.0
        self._frag_versions: Dict[str, int] = {n: 0 for n in FRAGMENT_ORDER}
        self._frag_objs: Dict[str, Dict[str, Any]] = {}
        self._frag_bytes: Dict[str, bytes] = {}
        self._computed_deps: Dict[str, Tuple[int, ...]] = {}
        # [token, built_at_monotonic, raw, gzip-or-None]
        self._full_cache: Optional[list] = None
        self._closed = False
        self.stats: Dict[str, Any] = {
            "polls": 0,
            "builds": {n: 0 for n in FRAGMENT_ORDER},
            "publishes": {n: 0 for n in FRAGMENT_ORDER},
            "full_assemblies": 0,
        }

    @property
    def closed(self) -> bool:
        with self._cond:
            return self._closed

    @property
    def token(self) -> str:
        with self._cond:
            return f"{PAYLOAD_VERSION}:" + ".".join(
                str(self._frag_versions[n]) for n in FRAGMENT_ORDER
            )

    def close(self) -> None:
        with self._cond:
            if self._closed:
                return
            self._closed = True
            self._cond.notify_all()
        self._computer.close()

    # -- publication -----------------------------------------------------

    def poll(self, force: bool = False) -> str:
        """Refresh the store and republish any fragment whose content
        changed.  Rate-limited; returns the current version token."""
        with self._cond:
            if self._closed:
                return self.token
            now = time.monotonic()
            if (
                not force
                and self._frag_bytes
                and now - self._last_poll < self.min_poll_interval
            ):
                return self.token
            self._last_poll = now
            self.stats["polls"] += 1
            payload, versions = self._computer.payload_with_versions()
            changed = False
            for name in FRAGMENT_ORDER:
                deps = FRAGMENT_DEPS.get(name)
                if deps is not None:
                    at = tuple(versions[d] for d in deps)
                    if self._computed_deps.get(name) == at:
                        continue
                elif name == "header" and name in self._frag_bytes:
                    continue  # constant after first build
                obj = build_fragment(
                    name, payload, session=self.session, db_path=self.db_path
                )
                t0 = time.perf_counter_ns()
                raw = json.dumps(obj).encode("utf-8")
                self._computer.store.tick_profile.note_stage(name, "serialize", time.perf_counter_ns() - t0)
                self.stats["builds"][name] += 1
                if deps is not None:
                    self._computed_deps[name] = at
                if raw != self._frag_bytes.get(name):
                    self._frag_objs[name] = obj
                    self._frag_bytes[name] = raw
                    self._frag_versions[name] += 1
                    self.stats["publishes"][name] += 1
                    changed = True
            if changed:
                self._full_cache = None
                self._cond.notify_all()
            return self.token

    def _changed_names(self, since: Optional[str]) -> list:
        since_v = parse_token(since)
        if since_v is None:
            return [n for n in FRAGMENT_ORDER if n in self._frag_bytes]
        return [
            n
            for n in FRAGMENT_ORDER
            if n in self._frag_bytes
            and since_v.get(n) != self._frag_versions[n]
        ]

    def wait_for_change(self, since: Optional[str], timeout: float) -> bool:
        """Block until some fragment's version differs from ``since`` (or
        timeout).  The publisher is pull-driven, so this re-polls in
        slices rather than waiting purely on the condition."""
        deadline = time.monotonic() + timeout
        slice_s = max(self.min_poll_interval, 0.02)
        while True:
            self.poll()
            with self._cond:
                if self._closed or self._changed_names(since):
                    return not self._closed
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                self._cond.wait(min(slice_s, remaining))

    # -- response bodies -------------------------------------------------

    def delta_body(
        self, since: Optional[str]
    ) -> Tuple[Optional[bytes], str]:
        """(delta JSON bytes or None when nothing moved, current token).

        The body is spliced from the cached per-fragment bytes:
        ``{"token": ..., "ts": ..., "fragments": {name: <cached>, ...}}``.
        """
        self.poll()
        with self._cond:
            token = self.token
            changed = self._changed_names(since)
            if not changed:
                return None, token
            head = json.dumps(
                {"token": token, "ts": time.time()}
            ).encode("utf-8")
            parts = [
                b'"' + n.encode("ascii") + b'": ' + self._frag_bytes[n]
                for n in changed
            ]
            body = (
                head[:-1]
                + b', "fragments": {'
                + b", ".join(parts)
                + b"}}"
            )
            return body, token

    def _assemble_full(self) -> bytes:
        # historical flat key order: version, session, ts, <domains...>;
        # inner bytes are obj_bytes[1:-1] joined with json's default
        # ", " separator — byte-identical to a single json.dumps
        parts = [self._frag_bytes["header"][1:-1]]
        parts.append(json.dumps({"ts": time.time()}).encode("utf-8")[1:-1])
        for name in FRAGMENT_ORDER:
            if name == "header":
                continue
            inner = self._frag_bytes[name][1:-1]
            if inner:  # meta serializes to {} when absent — skip
                parts.append(inner)
        return b"{" + b", ".join(parts) + b"}"

    def full_body(
        self, accept_gzip: bool = False
    ) -> Tuple[bytes, str, Optional[str]]:
        """(body bytes, version token, content-encoding or None).  The
        assembled body (and its gzip form) is shared by every viewer for
        ``full_ttl`` seconds — only the ``ts`` stamp goes stale."""
        self.poll()
        with self._cond:
            token = self.token
            now = time.monotonic()
            if (
                self._full_cache is None
                or self._full_cache[0] != token
                or now - self._full_cache[1] > self.full_ttl
            ):
                self._full_cache = [token, now, self._assemble_full(), None]
                self.stats["full_assemblies"] += 1
            cache = self._full_cache
            if accept_gzip and len(cache[2]) >= GZIP_MIN_BYTES:
                if cache[3] is None:
                    cache[3] = gzip.compress(cache[2], mtime=0)
                return cache[3], token, "gzip"
            return cache[2], token, None

    def full_payload_dict(self) -> Dict[str, Any]:
        """The flat payload as a dict (``build_web_payload`` compat) —
        composed from the cached fragment objects, same key order as the
        assembled JSON body."""
        self.poll()
        with self._cond:
            out: Dict[str, Any] = dict(self._frag_objs["header"])
            out["ts"] = time.time()
            for name in FRAGMENT_ORDER:
                if name != "header":
                    out.update(self._frag_objs[name])
            return out


# -- keyed, LRU-bounded publisher cache ----------------------------------
# Keyed on (db_path, session, window_steps); the least-recently-used
# publisher is closed when the bound is exceeded.  An evicted publisher
# that a request thread still holds serves that one response from its
# closed computer (degraded, not crashed); the next request fetches a new
# one through the cache.

_publishers: "OrderedDict[Tuple[str, str, int], SessionPublisher]" = (
    OrderedDict()
)
_publishers_lock = threading.Lock()
_max_publishers = 8


def set_max_publishers(n: int) -> None:
    global _max_publishers
    with _publishers_lock:
        _max_publishers = max(1, int(n))


def publisher_for(
    db_path: Path,
    session: str,
    window_steps: int = 150,
    max_publishers: Optional[int] = None,
) -> SessionPublisher:
    key = (str(Path(db_path)), session, int(window_steps))
    evicted = []
    with _publishers_lock:
        pub = _publishers.get(key)
        if pub is not None and not pub.closed:
            _publishers.move_to_end(key)
            return pub
        pub = SessionPublisher(
            Path(db_path), session, window_steps=window_steps
        )
        _publishers[key] = pub
        limit = (
            max(1, int(max_publishers))
            if max_publishers is not None
            else _max_publishers
        )
        while len(_publishers) > limit:
            _, old = _publishers.popitem(last=False)
            evicted.append(old)
    for old in evicted:
        old.close()
    return pub


def close_all_publishers() -> None:
    """Close and drop every cached publisher (tests / aggregator stop)."""
    with _publishers_lock:
        pubs = list(_publishers.values())
        _publishers.clear()
    for pub in pubs:
        pub.close()

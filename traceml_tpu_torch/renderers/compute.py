"""Per-tick data computation for the live display.

Counterpart of ``traceml_tpu/renderers/compute.py`` (``LiveComputer``).
``payload()`` returns a dict holding both the typed views (``views.*``,
what the panels render) and the per-domain diagnosis results.  Data
comes from a :class:`LiveSnapshotStore`, and each domain's views and
diagnosis are recomputed only when the store's version of a table the
domain reads advanced.  An idle tick (no new rows) reads no SQLite row
and returns the identical cached payload object; only ``ts`` and the
rank liveness strip are refreshed in place.

As in JAX, with ``TRACEML_VECTOR_DIAGNOSIS`` on (the default) a dirty
domain whose diagnosis inputs did not change reuses its previous
``DiagnosticResult`` and runs no rule (the per-(domain, version)
diagnosis cache), the step-time window object and the step-time view's
per-rank tables are memoized per store version (a model_stats-only tick
rebuilds only the MFU block), and every tick is profiled into the
store's ``TickProfile`` (stages ``refresh``, ``build``, ``diagnose``,
``attribute``, ``view``; the serving tier adds ``serialize``).
``payload_with_versions`` exports the store's ``window_build_stats``,
version-gated, for the dashboard's ``meta.window_build``.

Left out against the JAX computer: the collectives and serving domains
(ROADMAP queue 1 items 5 and 6) with the collectives memo, and the mesh
attribution of the diagnoses (``diagnostics/attribution.py`` needs
``utils/topology.py``, queue 1 item 5): the port's diagnoses run with no
topology, as the JAX ones do when no mesh was captured, so their
``attribute`` stage reads 0 ns as the JAX one does then.  The
``history`` domain, as in JAX, is the stitched step-time series of the
rollup tiers collapsed to a cross-rank band (mean of the ranks' means,
min, max per bucket); it is empty until the writer's first prune.
"""

from __future__ import annotations

import threading
import time
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

from traceml_tpu_torch.diagnostics.common import rule_eval_counts
from traceml_tpu_torch.diagnostics.process.api import diagnose as diagnose_process
from traceml_tpu_torch.diagnostics.step_memory.api import diagnose_columns as diagnose_memory_columns
from traceml_tpu_torch.diagnostics.step_memory.api import diagnose_rank_rows as diagnose_memory
from traceml_tpu_torch.diagnostics.step_time.api import diagnose_window
from traceml_tpu_torch.diagnostics.system.api import diagnose as diagnose_system
from traceml_tpu_torch.renderers import views as V
from traceml_tpu_torch.reporting.loaders import load_rank_status
from traceml_tpu_torch.reporting.snapshot_store import LiveSnapshotStore
from traceml_tpu_torch.utils.columnar import incr_window_enabled, vector_diagnosis_enabled

# payload domain → (store versions it depends on, views key or None)
_DOMAIN_DEPS: Dict[str, Tuple[Tuple[str, ...], Optional[str]]] = {
    "topology": (("topology",), None),
    "step_time": (("step_time", "model_stats", "topology"), "step_time"),
    "memory": (("step_memory", "topology"), "memory"),
    "system": (("system", "topology"), "system"),
    "process": (("process",), "process"),
    "stdout": (("stdout",), None),
    # the stitch re-folds the surviving raw rows, so new raw steps move
    # the series between prunes too
    "history": (("rollup", "step_time"), None),
}


class LiveComputer:
    """Reads the session SQLite through an incremental snapshot store
    and produces the per-domain payloads the panels render; each domain
    recomputes only when its tables changed."""

    def __init__(self, db_path: Path, window_steps: int = 120) -> None:
        self.db_path = Path(db_path)
        self.window_steps = window_steps
        self._store = LiveSnapshotStore(self.db_path, window_steps=window_steps)
        self._lock = threading.RLock()
        self._cache: Optional[Dict[str, Any]] = None
        # domain → versions tuple the cached fragment was computed at
        self._computed_at: Dict[str, Tuple[int, ...]] = {}
        # domain → (payload updates, view object or None)
        self._fragments: Dict[str, Tuple[Dict[str, Any], Any]] = {}
        # per-(domain, version-key) diagnosis cache: a dirty domain tick
        # whose diagnosis inputs did not change reuses the previous
        # DiagnosticResult and runs no rule (off with
        # TRACEML_VECTOR_DIAGNOSIS=0)
        self._diag_cache: Dict[str, Tuple[Any, Any]] = {}
        # the step_time window object per store version, and the
        # step_time view's per-rank tables (also switched by
        # TRACEML_VECTOR_DIAGNOSIS)
        self._window_memo: Dict[str, Tuple[Tuple, Any]] = {}
        self._st_tables_memo: Dict[str, Any] = {}
        # the last exported window_build_stats, keyed on the store
        # versions it was taken at (payload_with_versions)
        self._stats_export: Optional[Tuple[Tuple, Dict[str, Any]]] = None

    @property
    def store(self) -> LiveSnapshotStore:
        return self._store

    def close(self) -> None:
        self._store.close()

    def payload(self) -> Dict[str, Any]:
        with self._lock:
            prof = self._store.tick_profile
            try:
                t0 = time.perf_counter_ns()
                self._store.refresh()
                prof.note_stage("store", "refresh", time.perf_counter_ns() - t0)
            except Exception:
                pass
            if not self._store.connected:
                # no DB yet (or it vanished): a cheap constant payload
                return {"ts": time.time(), "db_exists": self.db_path.exists(), "views": {}}
            prof.note_tick()
            versions = self._store.versions
            dirty = [
                domain
                for domain, (deps, _) in _DOMAIN_DEPS.items()
                if self._computed_at.get(domain) != tuple(versions[d] for d in deps)
            ]
            if not dirty and self._cache is not None:
                self._cache["ts"] = time.time()  # idle tick: the same object
                self._attach_rank_status(self._cache)
                return self._cache
            for domain in dirty:
                deps, _ = _DOMAIN_DEPS[domain]
                self._fragments[domain] = getattr(self, f"_compute_{domain}")()
                self._computed_at[domain] = tuple(versions[d] for d in deps)
            out: Dict[str, Any] = {"ts": time.time(), "db_exists": True, "views": {}}
            for domain, (_, view_key) in _DOMAIN_DEPS.items():
                updates, view = self._fragments.get(domain, ({}, None))
                out.update(updates)
                if view is not None and view_key is not None:
                    out["views"][view_key] = view
            self._attach_rank_status(out)
            self._cache = out
            return out

    def payload_with_versions(self) -> Tuple[Dict[str, Any], Dict[str, int]]:
        """The payload and the store versions it was computed at, read
        together under the lock: the serving tier keys its cache of
        serialized fragments on these, so the pair must agree.  With the
        incremental engine on, the payload carries the store's
        ``window_build_stats``, exported once per store-version change:
        the profile moves on every poll, and a fresh snapshot on each
        would change the meta fragment's bytes on every idle poll."""
        with self._lock:
            payload = self.payload()
            if incr_window_enabled():
                vkey = tuple(sorted(self._store.versions.items()))
                if self._stats_export is not None and self._stats_export[0] == vkey:
                    stats = self._stats_export[1]
                else:
                    stats = self._store.window_build_stats()
                    self._stats_export = (vkey, stats)
                if stats:
                    payload["window_build_stats"] = stats
            return payload, dict(self._store.versions)

    def _attach_rank_status(self, out: Dict[str, Any]) -> None:
        """The liveness strip, refreshed on every tick (never
        dirty-gated): a lost rank's state changes exactly when its DB
        writes stop, so gating on table versions would freeze the strip
        at ACTIVE."""
        try:
            status = load_rank_status(self.db_path.parent)
            if status and isinstance(status.get("ranks"), dict):
                out["rank_status"] = {
                    "ts": status.get("ts"),
                    "thresholds": status.get("thresholds"),
                    "states": {
                        r: (info or {}).get("state")
                        for r, info in status["ranks"].items()
                        if isinstance(info, dict)
                    },
                }
        except Exception:
            pass

    def _diagnose_cached(self, domain: str, cache_key: Tuple, build):
        """Run a pack's diagnosis under the per-(domain, version-key)
        cache and the tick profiler.  ``cache_key`` holds every input of
        the diagnosis that can change between ticks; a match returns the
        previous DiagnosticResult without evaluating a rule."""
        prof = self._store.tick_profile
        if vector_diagnosis_enabled():
            hit = self._diag_cache.get(domain)
            if hit is not None and hit[0] == cache_key:
                prof.bump("diag_cache_hits")
                return hit[1]
        r0 = sum(rule_eval_counts().values())
        t0 = time.perf_counter_ns()
        result = build()
        prof.note_stage(domain, "diagnose", time.perf_counter_ns() - t0)
        prof.note_stage(domain, "attribute", 0)  # no mesh attribution yet
        prof.bump("rule_evals", sum(rule_eval_counts().values()) - r0)
        if vector_diagnosis_enabled():
            prof.bump("diag_cache_misses")
            self._diag_cache[domain] = (cache_key, result)
        return result

    def _window_cached(self, domain: str, key: Tuple, build):
        """Build (and stage-time) a window object, memoized per store
        version.  Safe because a version match means the rings the
        window's arrays alias were not written since the build."""
        prof = self._store.tick_profile
        if vector_diagnosis_enabled():
            hit = self._window_memo.get(domain)
            if hit is not None and hit[0] == key:
                prof.bump("window_memo_hits")
                return hit[1]
        t0 = time.perf_counter_ns()
        window = build()
        prof.note_stage(domain, "build", time.perf_counter_ns() - t0)
        if vector_diagnosis_enabled():
            prof.bump("window_memo_misses")
            self._window_memo[domain] = (key, window)
        return window

    # -- per-domain builders ---------------------------------------------
    # Each returns (top-level payload updates, typed view or None); a
    # failing domain degrades to an {"error": ...} marker without
    # poisoning the others.

    def _compute_topology(self) -> Tuple[Dict[str, Any], Any]:
        try:
            return {"topology": self._store.topology()}, None
        except Exception:
            return {"topology": {}}, None

    def _compute_step_time(self) -> Tuple[Dict[str, Any], Any]:
        world = int((self._store.topology() or {}).get("world_size") or 0)
        prof = self._store.tick_profile
        try:
            versions = self._store.versions
            # the window object is memoized per step_time version: a
            # model_stats-only tick reuses it outright
            window = self._window_cached(
                "step_time", (versions["step_time"],),
                lambda: self._store.build_step_time_window(max_steps=self.window_steps),
            )
            # the newest row's timestamp drives the staleness badge
            latest = self._store.latest_step_time_ts()
            try:
                model_stats = self._store.model_stats()
            except Exception:
                model_stats = {}
            # the view's per-rank tables are pure window functions,
            # memoized per step_time version (None: rebuilt every tick)
            table_cache = None
            if vector_diagnosis_enabled():
                tkey = (versions["step_time"],)
                if self._st_tables_memo.get("key") != tkey:
                    self._st_tables_memo = {"key": tkey}
                elif "tables" in self._st_tables_memo:
                    prof.bump("view_table_hits")
                table_cache = self._st_tables_memo
            t0 = time.perf_counter_ns()
            view = V.build_step_time_view(window, world_size=world, latest_ts=latest, model_stats=model_stats,
                                          table_cache=table_cache)
            prof.note_stage("step_time", "view", time.perf_counter_ns() - t0)
            updates = {
                "latest_row_ts": latest,
                "step_time": {
                    "window": window,
                    # the diagnosis reads only the window, so a
                    # model_stats-only tick reuses the cached result
                    "diagnosis": self._diagnose_cached(
                        "step_time",
                        (versions["step_time"], versions["topology"]),
                        lambda: diagnose_window(window, mode="live"),
                    )
                    if self._store.has_step_time_rows()
                    else None,
                },
            }
            return updates, view
        except Exception as exc:
            return {"step_time": {"error": str(exc)}}, None

    def _compute_memory(self) -> Tuple[Dict[str, Any], Any]:
        prof = self._store.tick_profile
        try:
            versions = self._store.versions
            t0 = time.perf_counter_ns()
            mem_rows = self._store.step_memory_rows()
            mem_cols = self._store.step_memory_columns()
            prof.note_stage("memory", "build", time.perf_counter_ns() - t0)
            t0 = time.perf_counter_ns()
            view = V.build_memory_view(mem_rows, columns=mem_cols)
            prof.note_stage("memory", "view", time.perf_counter_ns() - t0)
            key = (versions["step_memory"], versions["topology"])
            if mem_cols is not None:
                diagnosis = self._diagnose_cached("memory", key, lambda: diagnose_memory_columns(mem_cols))
            else:
                diagnosis = (
                    self._diagnose_cached("memory", key, lambda: diagnose_memory(mem_rows))
                    if mem_rows else None
                )
            updates = {
                "step_memory": mem_rows,
                "step_memory_diagnosis": diagnosis,
            }
            return updates, view
        except Exception as exc:
            return {"step_memory": {"error": str(exc)}}, None

    def _compute_system(self) -> Tuple[Dict[str, Any], Any]:
        nodes = int((self._store.topology() or {}).get("nodes") or 0)
        try:
            host, devices = self._store.system_rows()
            view = V.build_system_view(host, devices, expected_nodes=nodes)
            updates = {
                "system": {"host": host, "devices": devices},
                "system_diagnosis": diagnose_system(host, devices) if host or devices else None,
            }
            return updates, view
        except Exception as exc:
            return {"system": {"error": str(exc)}}, None

    def _compute_process(self) -> Tuple[Dict[str, Any], Any]:
        try:
            procs, pdevs = self._store.process_rows()
            view = V.build_process_view(procs)
            updates = {
                "process": {"procs": procs, "devices": pdevs},
                "process_diagnosis": diagnose_process(procs, pdevs) if procs or pdevs else None,
            }
            return updates, view
        except Exception as exc:
            return {"process": {"error": str(exc)}}, None

    def _compute_stdout(self) -> Tuple[Dict[str, Any], Any]:
        try:
            return {"stdout": self._store.stdout_tail()}, None
        except Exception:
            return {"stdout": []}, None

    def _compute_history(self) -> Tuple[Dict[str, Any], Any]:
        """The full-run step-time band for the dashboard's history strip;
        {} until the first fold lands."""
        try:
            if not self._store.has_rollups():
                return {"history": {}}, None
            series = self._store.stitched_series("step_time_samples", "step_ms")
            if not series:
                return {"history": {}}, None
            band: Dict[float, Dict[str, Any]] = {}
            for points in series.values():
                for p in points:
                    if p.get("mean") is None:
                        continue
                    slot = band.get(p["t"])
                    if slot is None:
                        band[p["t"]] = {"t": p["t"], "mean_sum": p["mean"], "ranks": 1,
                                        "min": p["min"], "max": p["max"], "res": p["res"]}
                    else:
                        slot["mean_sum"] += p["mean"]
                        slot["ranks"] += 1
                        slot["min"] = min(slot["min"], p["min"])
                        slot["max"] = max(slot["max"], p["max"])
            points = [
                {"t": b["t"], "mean_ms": b["mean_sum"] / b["ranks"], "min_ms": b["min"],
                 "max_ms": b["max"], "res": b["res"]}
                for b in (band[t] for t in sorted(band))
            ]
            return {"history": {"step_time": {"points": points, "ranks": len(series)}}}, None
        except Exception as exc:
            return {"history": {"error": str(exc)}}, None

"""Per-tick data computation for the live display.

Counterpart of ``traceml_tpu/renderers/compute.py`` (``LiveComputer``).
``payload()`` returns a dict holding both the typed views (``views.*``,
what the panels render) and the per-domain diagnosis results.  Data
comes from a :class:`LiveSnapshotStore`, and each domain's views and
diagnosis are recomputed only when the store's version of a table the
domain reads advanced.  An idle tick (no new rows) reads no SQLite row
and returns the identical cached payload object; only ``ts`` and the
rank liveness strip are refreshed in place.

Left out against the JAX computer: the diagnosis, window and view memos
and the tick profiler, which serve its vector engine (ROADMAP queue 1
item 3; with ``TRACEML_VECTOR_DIAGNOSIS=0`` the JAX computer runs
without them too), the collectives and serving domains (queue 1 items
5 and 6), and the mesh attribution of the diagnoses
(``diagnostics/attribution.py`` needs ``utils/topology.py``, queue 1
item 5): the port's diagnoses run with no topology, as the JAX ones do
when no mesh was captured.  The ``history`` domain, as in JAX, is the
stitched step-time series of the rollup tiers collapsed to a cross-rank
band (mean of the ranks' means, min, max per bucket); it is empty until
the writer's first prune.
"""

from __future__ import annotations

import threading
import time
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

from traceml_tpu_torch.diagnostics.process.api import diagnose as diagnose_process
from traceml_tpu_torch.diagnostics.step_memory.api import diagnose_rank_rows as diagnose_memory
from traceml_tpu_torch.diagnostics.step_time.api import diagnose_window
from traceml_tpu_torch.diagnostics.system.api import diagnose as diagnose_system
from traceml_tpu_torch.renderers import views as V
from traceml_tpu_torch.reporting.loaders import load_rank_status
from traceml_tpu_torch.reporting.snapshot_store import LiveSnapshotStore

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

    @property
    def store(self) -> LiveSnapshotStore:
        return self._store

    def close(self) -> None:
        self._store.close()

    def payload(self) -> Dict[str, Any]:
        with self._lock:
            try:
                self._store.refresh()
            except Exception:
                pass
            if not self._store.connected:
                # no DB yet (or it vanished): a cheap constant payload
                return {"ts": time.time(), "db_exists": self.db_path.exists(), "views": {}}
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
        serialized fragments on these, so the pair must agree.  (The JAX
        method also exports the incremental window's build stats, which
        the port's scalar arm does not keep.)"""
        with self._lock:
            return self.payload(), dict(self._store.versions)

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
        try:
            window = self._store.build_step_time_window(max_steps=self.window_steps)
            # the newest row's timestamp drives the staleness badge
            latest = self._store.latest_step_time_ts()
            try:
                model_stats = self._store.model_stats()
            except Exception:
                model_stats = {}
            view = V.build_step_time_view(window, world_size=world, latest_ts=latest, model_stats=model_stats)
            updates = {
                "latest_row_ts": latest,
                "step_time": {
                    "window": window,
                    "diagnosis": diagnose_window(window, mode="live")
                    if self._store.has_step_time_rows()
                    else None,
                },
            }
            return updates, view
        except Exception as exc:
            return {"step_time": {"error": str(exc)}}, None

    def _compute_memory(self) -> Tuple[Dict[str, Any], Any]:
        try:
            mem_rows = self._store.step_memory_rows()
            view = V.build_memory_view(mem_rows)
            updates = {
                "step_memory": mem_rows,
                "step_memory_diagnosis": diagnose_memory(mem_rows) if mem_rows else None,
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

"""Stat all-gather telemetry hook: the collective rank source.

Counterpart of ``traceml_tpu/parallel/ici_telemetry.py`` (the module
keeps its name so that a reader finds it).  Cross-rank skew without a
round trip through the aggregator: opt-in through
:func:`traceml_tpu_torch.enable_ici_stats`.

1. The hook registers an ``on_batch_flushed`` observer on the trace
   state (every non-empty ``trace_step`` exit hands it the step's event
   batch) and an ``on_step_flushed`` one (every exit).
2. Every ``every_n_steps`` it folds the step's batch into one
   fixed-layout :class:`~traceml_tpu_torch.parallel.ici_stats.StatVector`
   and all-gathers it over the mesh (one small NCCL collective).
3. Every rank sees the full ``(n, N_FIELDS)`` matrix; the hook turns its
   rows back into the step rows the window builder reads and keeps them
   as a per-rank history.
4. :meth:`IciTelemetryHook.diagnose` runs the aggregator's straggler and
   bound rules on the gathered matrices alone.

The gather is a sync point: its device times come from the step's CUDA
events, so the hook first waits for the step's device work, then brings
the gathered matrix to the host.  ``wait_ms`` and ``gather_ms`` record
both costs per gather.  One difference from the JAX hook: the JAX hook
builds each vector as if the step were the first (no readiness edge
carried from the previous step), so its ``step_ms`` differs from the
stored row's whenever the host runs ahead of the device.  This hook
carries the edge across every batch it sees, as the step-time sampler
does, so a gathered row's ``step_ms`` is the stored row's.
"""

from __future__ import annotations

import collections
import time
from typing import Any, Deque, Dict, List, Optional

import numpy as np

from traceml_tpu_torch.parallel.ici_stats import (
    N_FIELDS,
    STAT_FIELDS,
    IciStatAggregator,
    StatVector,
)
from traceml_tpu_torch.utils import timing as T
from traceml_tpu_torch.utils.error_log import get_error_log

# StatVector field ↔ internal event name (forward/backward fold into
# compute: the fixed layout carries the fused phase)
_FIELD_TO_EVENT = {
    "input_ms": T.DATALOADER_NEXT,
    "h2d_ms": T.H2D_TIME,
    "compute_ms": T.COMPUTE_TIME,
    "optimizer_ms": T.OPTIMIZER_STEP,
    "compile_ms": T.COMPILE_TIME,
    "collective_ms": T.COLLECTIVE_TIME,
    "checkpoint_ms": T.CHECKPOINT_TIME,
}
# phases that run ON the device: only these get device_ms when the
# matrix is turned back into step rows (host-side waits marked as device
# time would inflate the occupancy numerator)
_DEVICE_FIELDS = {"h2d_ms", "compute_ms", "optimizer_ms", "collective_ms"}
_FOLD_INTO_COMPUTE = (T.FORWARD_TIME, T.BACKWARD_TIME)


def _step_row(batch: Any, prev_last_ready: Optional[float]) -> tuple:
    from traceml_tpu_torch.samplers.step_time_sampler import _aggregate_step

    return _aggregate_step(batch.events, prev_last_ready)


def batch_to_stat_vector(batch: Any, prev_last_ready: Optional[float] = None) -> StatVector:
    """One step's event batch → fixed-layout stat vector.

    Uses the sampler's aggregation (device readiness edges where
    resolved, host times otherwise) so the gathered rows and the stored
    rows report the same numbers for the same step.  ``prev_last_ready``
    is the previous step's last readiness edge (None: the JAX hook's
    vector, built as if the step were the first)."""
    row, _ = _step_row(batch, prev_last_ready)
    events = row.get("events") or {}

    def _ms(name: str) -> float:
        ev = events.get(name) or {}
        v = ev.get("device_ms")
        if v is None:
            v = ev.get("cpu_ms")
        return float(v or 0.0)

    values: Dict[str, float] = {"step": float(batch.step)}
    step_ms = _ms(T.STEP_TIME)
    values["step_ms"] = step_ms
    accounted = 0.0
    for field, event_name in _FIELD_TO_EVENT.items():
        v = _ms(event_name)
        if field == "compute_ms":
            v += sum(_ms(n) for n in _FOLD_INTO_COMPUTE)
        values[field] = v
        accounted += v
    values["residual_ms"] = max(0.0, step_ms - accounted)
    return StatVector(values)


def matrix_to_rank_rows(
    matrix: np.ndarray, timestamp: Optional[float] = None
) -> Dict[int, Dict[str, Any]]:
    """One gathered matrix → {participant → step row} in the window
    builder's shape (the participant index IS the rank in the gather's
    mesh-linear order)."""
    ts = time.time() if timestamp is None else timestamp
    out: Dict[int, Dict[str, Any]] = {}
    for rank, arr in enumerate(np.asarray(matrix)):
        vec = StatVector.from_array(arr).values
        events: Dict[str, Dict[str, Any]] = {
            T.STEP_TIME: {
                "cpu_ms": vec["step_ms"],
                "device_ms": vec["step_ms"],
                "count": 1,
            }
        }
        for field, event_name in _FIELD_TO_EVENT.items():
            v = vec.get(field) or 0.0
            if v > 0:
                events[event_name] = {
                    "cpu_ms": v,
                    "device_ms": v if field in _DEVICE_FIELDS else None,
                    "count": 1,
                }
        out[rank] = {
            "step": int(vec["step"]),
            "timestamp": ts,
            "clock": "device",
            "events": events,
        }
    return out


class IciTelemetryHook:
    """Accumulates gathered stat matrices into a per-rank window and
    diagnoses from it, with no aggregator involved."""

    def __init__(
        self,
        mesh=None,
        *,
        every_n_steps: int = 10,
        window_steps: int = 120,
        aggregator: Optional[IciStatAggregator] = None,
    ) -> None:
        self._agg = aggregator or IciStatAggregator(mesh)
        self.every_n_steps = max(1, int(every_n_steps))
        self._rows: Dict[int, Deque[Dict[str, Any]]] = {}
        self._window = int(window_steps)
        self._installed_on: Optional[Any] = None
        # batches flushed since the last gather, and the readiness edge
        # carried past them (the step-time sampler's fold)
        self._pending: List[Any] = []
        self._edge: Optional[float] = None
        self.gather_count = 0
        self.last_matrix: Optional[np.ndarray] = None
        # host ms per gather: waiting for the step's device work, then
        # the vector, the collective and the copy to the host
        self.wait_ms: List[float] = []
        self.gather_ms: List[float] = []

    # -- wiring ---------------------------------------------------------
    def install(self, state=None) -> "IciTelemetryHook":
        from traceml_tpu_torch.sdk.state import get_state

        st = state or get_state()
        # gathers are driven by on_step_flushed, which fires on EVERY
        # trace_step exit, batch or not: a rank whose flush came up empty
        # contributes zeros instead of leaving its peers blocked in the
        # collective
        st.on_batch_flushed.append(self._on_batch)
        st.on_step_flushed.append(self._on_step)
        self._installed_on = st
        return self

    def uninstall(self) -> None:
        st = self._installed_on
        if st is not None:
            for lst, cb in (
                (st.on_batch_flushed, self._on_batch),
                (st.on_step_flushed, self._on_step),
            ):
                try:
                    lst.remove(cb)
                except ValueError:
                    pass
            self._installed_on = None

    def _on_batch(self, batch: Any) -> None:
        self._pending.append(batch)

    def _vector(self, step: int) -> StatVector:
        """Wait for the pending batches' device work, fold their edges in
        order and build ``step``'s vector (zeros when this rank flushed no
        batch for it)."""
        from traceml_tpu_torch.utils.marker_resolver import get_marker_resolver

        t0 = time.perf_counter()
        pending, self._pending = self._pending, []
        for batch in pending:
            for ev in batch.events:
                if ev.marker is not None and not ev.marker.resolved:
                    ev.marker.wait()
        get_marker_resolver().sweep_inline()
        self.wait_ms.append((time.perf_counter() - t0) * 1000.0)
        vec = StatVector({"step": float(step)})
        for batch in pending:
            if batch.step == step:
                vec = batch_to_stat_vector(batch, self._edge)
            _, self._edge = _step_row(batch, self._edge)
        return vec

    def _on_step(self, step: int) -> None:
        if step % self.every_n_steps != 0:
            return
        # vector construction failures degrade to zeros so aggregate()
        # ALWAYS runs: a rank skipping the collective while its peers
        # block inside it would hang the whole job
        try:
            vec = self._vector(step)
        except Exception as exc:
            get_error_log().warning("stat vector build failed", exc)
            vec = StatVector({"step": float(step)})
        t0 = time.perf_counter()
        try:
            matrix = self._agg.aggregate(vec)
            self.gather_ms.append((time.perf_counter() - t0) * 1000.0)
            self.ingest_matrix(matrix)
        except Exception as exc:  # never raises into training
            get_error_log().warning("stat all-gather failed", exc)

    # -- matrix accounting ----------------------------------------------
    def ingest_matrix(self, matrix: np.ndarray, timestamp: Optional[float] = None) -> None:
        self.gather_count += 1
        self.last_matrix = np.asarray(matrix)
        for rank, row in matrix_to_rank_rows(matrix, timestamp).items():
            dq = self._rows.setdefault(
                rank, collections.deque(maxlen=self._window)
            )
            dq.append(row)

    def rank_rows(self) -> Dict[int, List[Dict[str, Any]]]:
        return {r: list(dq) for r, dq in self._rows.items()}

    # -- consumers -------------------------------------------------------
    def diagnose(self, mode: str = "live"):
        """Straggler/bound diagnosis from the gathered matrices alone."""
        from traceml_tpu_torch.diagnostics.step_time.api import diagnose_rank_rows

        return diagnose_rank_rows(self.rank_rows(), mode=mode)

    def rank_skew(self, field: str) -> Optional[Dict[str, float]]:
        if self.last_matrix is None:
            return None
        return self._agg.rank_skew(self.last_matrix, field)


__all__ = [
    "IciTelemetryHook",
    "batch_to_stat_vector",
    "matrix_to_rank_rows",
    "STAT_FIELDS",
    "N_FIELDS",
]

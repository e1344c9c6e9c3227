"""Columnar window engine: struct-of-arrays ring buffers and vectorized
window builds for the live analytics path.

Counterpart of ``traceml_tpu/utils/columnar.py`` for the step-time,
step-memory and collectives domains (the serving engine comes with its
domain, ROADMAP queue 1 item 6).  The scalar pipeline in
:mod:`traceml_tpu_torch.utils.step_time_window` is the golden reference;
this module is a drop-in fast path that must give **byte-identical**
payloads.  Its pieces:

* :class:`StepTimeColumns` / :class:`MemoryColumns`: per-rank numpy ring
  buffers (preallocated to twice the retention bound, compacted with a
  memmove when the write head reaches the end) that the snapshot store
  fills in lockstep with its row deques.  An append the vectorized build
  cannot represent exactly (a duplicate or out-of-order step, a ``None``
  step id, a malformed event payload, a non-finite duration, a
  non-integer byte count) sets a sticky ``columnar_ok = False`` flag on
  the rank's buffer.
* :func:`build_columnar_step_time_window`: the vectorized equivalent of
  ``build_step_time_window``: suffix alignment via unique counts and
  ``searchsorted``, clock selection as a boolean reduction, residual
  clamp and per-phase averages as numpy reductions over a ``(rank,
  phase, aligned_step)`` cube.  It raises :class:`ColumnarFallback` when
  any participating rank is flagged, so the caller reruns the scalar
  reference on the row deques instead.
* :class:`ColumnarStepTimeWindow`: a ``StepTimeWindow`` whose
  ``rank_windows`` materialize per-rank lists lazily from the cube.
* :class:`StepTimeWindowCache`: the incremental engine.  The window keeps
  a persistent aligned cube owned by the snapshot store, and a dirty tick
  extends it by only the newly aligned columns.  Any condition the delta
  path cannot represent exactly (realignment, ring eviction past the
  window, a clock flip, a flagged buffer, a new window length) falls back
  to the full build above, so the incremental output is bit-identical to
  a from-scratch build on every tick.
* :class:`CollectivesColumns`, :func:`build_columnar_collectives_window`
  and :class:`CollectivesWindowCache`: the collectives domain's ring, its
  full build and its incremental cache over the UNION of the ranks'
  steps, held bit for bit to the scalar fold
  :func:`build_collectives_window_rows` (whose float sums are all ``+=``
  left folds, so ``np.add.at`` and ``np.cumsum`` reproduce them);
  :func:`window_series_cube` and :func:`reduce_window_by_grouping` reshape
  a step-time series along a topology grouping;
* :class:`WindowBuildStats` and :class:`TickProfile`: the counters and
  per-stage nanoseconds that reach the user as ``meta.window_build`` in
  the dashboard payload and the final report.

Exactness rules the implementation leans on (and the tests pin):

* the per-rank averages are ``sum(vs) / len(vs)`` in the scalar arm.
  Since CPython 3.12, ``sum()`` over floats is compensated (Neumaier's
  sum, the compensation added at the end only when it is non-zero and
  finite); below 3.12 it is a plain left fold.  :func:`sum_fold`
  reproduces the running interpreter's ``sum()`` bit for bit, vectorized
  across lanes.  (The JAX engine folds with ``np.cumsum``, the plain left
  fold, so on 3.12 its averages can differ from its own scalar arm's by
  an ulp.)
* the occupancy sums are plain ``+=`` folds from ``0.0`` in the scalar
  arm, and :func:`plain_fold` is that fold; substituting ``0.0`` for a
  missing value is exact there (``s + 0.0 == s`` for every partial sum
  a fold from ``0.0`` can reach);
* the scalar arm reads a missing or zero phase as ``0.0`` (``v or 0.0``),
  so the gathered values are canonicalized with ``+ 0.0``, which turns
  ``-0.0`` into ``0.0``;
* ``np.median`` and ``statistics.median`` agree for float input (odd
  length picks the same element; even length computes ``(a + b) / 2``
  both ways);
* occupancy numerator/denominator pairs are precomputed at append time
  by the scalar :func:`row_occupancy_parts`, so the events-dict
  iteration order inside that fold is preserved by construction;
* every value escaping into a payload goes through ``.tolist()`` /
  ``float()`` first: ``np.float64`` is not JSON serializable and its
  ``__round__`` differs from the float one.

Switches, read on every call as in JAX: ``TRACEML_COLUMNAR_WINDOW=0``
forces the scalar path, ``TRACEML_INCR_WINDOW=0`` forces full rebuilds
(the cache is never consulted) and ``TRACEML_VECTOR_DIAGNOSIS=0`` forces
the scalar rule-evaluation arm (and turns off the computer's diagnosis
cache and memos).  Each is on unless set to ``0``, ``false`` or ``off``.
"""

from __future__ import annotations

import dataclasses
import logging
import math
import os
import sys
import time
from typing import Any, Dict, List, Mapping, Optional

import numpy as np

from traceml_tpu_torch.utils import timing as T
from traceml_tpu_torch.utils.step_time_window import (
    ACCOUNTED_PHASES,
    ALL_KEYS,
    PHASES,
    STEP_KEY,
    RankWindow,
    StepCombinedTimeMetric,
    StepTimeWindow,
    row_occupancy_parts,
)

# event layout inside the value cube: 0 = the step envelope, 1.. = the
# accounted phases in PHASES order (the order the scalar fold uses)
EVENT_NAMES = (T.STEP_TIME,) + tuple(PHASES.values())
N_EVENTS = len(EVENT_NAMES)
_EVENT_INDEX = {name: i for i, name in enumerate(EVENT_NAMES)}
KEY_INDEX = {k: i for i, k in enumerate(ALL_KEYS)}

_NAN = float("nan")

ENV_COLUMNAR_WINDOW = "TRACEML_COLUMNAR_WINDOW"
ENV_INCR_WINDOW = "TRACEML_INCR_WINDOW"
ENV_VECTOR_DIAGNOSIS = "TRACEML_VECTOR_DIAGNOSIS"
_FALSY = ("0", "false", "off")

# CPython 3.12 made sum() over floats compensated (Neumaier)
_COMPENSATED_SUM = sys.version_info >= (3, 12)


def _switch_on(name: str) -> bool:
    """A kill switch: on unless the variable reads 0, false or off."""
    v = os.environ.get(name)
    return v is None or v.strip().lower() not in _FALSY


def columnar_window_enabled() -> bool:
    return _switch_on(ENV_COLUMNAR_WINDOW)


def incr_window_enabled() -> bool:
    return _switch_on(ENV_INCR_WINDOW)


def vector_diagnosis_enabled() -> bool:
    return _switch_on(ENV_VECTOR_DIAGNOSIS)


# the vector arm never spams the log on a pathological session: the first
# fallback per domain is warned once, the rest are counted and surfaced
# through the tick profiler
_VECTOR_FALLBACKS: Dict[str, int] = {}
_VECTOR_FALLBACK_WARNED: set = set()


def note_vector_fallback(domain: str) -> None:
    _VECTOR_FALLBACKS[domain] = _VECTOR_FALLBACKS.get(domain, 0) + 1
    if domain not in _VECTOR_FALLBACK_WARNED:
        _VECTOR_FALLBACK_WARNED.add(domain)
        logging.getLogger(__name__).warning(
            "vectorized %s diagnosis fell back to the scalar arm "
            "(further fallbacks counted, not logged)", domain,
        )


def vector_fallback_counts() -> Dict[str, int]:
    return dict(_VECTOR_FALLBACKS)


class ColumnarFallback(Exception):
    """Raised when the columnar build cannot reproduce the scalar path
    exactly; the caller must rerun the scalar reference on the rows."""


# ---------------------------------------------------------------------------
# exact folds
# ---------------------------------------------------------------------------


def sum_fold(arr_t: np.ndarray, lo: int = 0, hi: Optional[int] = None) -> np.ndarray:
    """The running interpreter's ``sum(xs)`` of every lane of a STEP-MAJOR
    array ``(step, ...)`` over ``[lo, hi)``, bit for bit.

    ``sum()`` starts from the int ``0``, so its first add is ``0.0 + x0``.
    On CPython 3.12 and later the rest is Neumaier's compensated sum: per
    add, ``t = f + x`` and the lost low part ``(f - t) + x`` (or ``(x - t)
    + f`` when ``|x| > |f|``) goes into ``c``; at the end ``c`` is added
    only when it is non-zero and finite, so an infinite or overflowed sum
    stays as it is.  Below 3.12 it is the plain left fold.  Each
    ``arr_t[j]`` is a contiguous slice, so the loop runs across lanes."""
    if hi is None:
        hi = arr_t.shape[0]
    f = arr_t[lo] + 0.0
    if not _COMPENSATED_SUM:
        for j in range(lo + 1, hi):
            f += arr_t[j]
        return f
    c = np.zeros_like(f)
    with np.errstate(invalid="ignore", over="ignore"):
        for j in range(lo + 1, hi):
            x = arr_t[j]
            t = f + x
            c += np.where(np.abs(f) >= np.abs(x), (f - t) + x, (x - t) + f)
            f = t
        fix = (c != 0) & np.isfinite(c)
        np.add(f, c, out=f, where=fix)
    return f


def plain_fold(arr_t: np.ndarray, lo: int = 0, hi: Optional[int] = None) -> np.ndarray:
    """The scalar arm's ``acc = 0.0; acc += x`` of every lane of a
    STEP-MAJOR array over ``[lo, hi)`` (the occupancy sums)."""
    if hi is None:
        hi = arr_t.shape[0]
    acc = arr_t[lo] + 0.0
    with np.errstate(invalid="ignore", over="ignore"):
        for j in range(lo + 1, hi):
            acc += arr_t[j]
    return acc


# ---------------------------------------------------------------------------
# ring buffers
# ---------------------------------------------------------------------------


class _CompactRing:
    """Arrays sized ``2 * cap`` with ``[start, end)`` live; when the
    write head hits ``2 * cap`` the live span is memmoved to the front.
    Appends beyond ``cap`` drop the oldest entry, mirroring the snapshot
    store's ``deque(maxlen=cap)`` exactly, so views are always
    contiguous and eviction is an O(1) ``start`` bump."""

    __slots__ = ("cap", "_start", "_end", "appended_total", "evicted_total")

    def __init__(self, cap: int) -> None:
        self.cap = max(1, int(cap))
        self._start = 0
        self._end = 0
        # monotone lifetime counters: the incremental window cache
        # compares them with their last-build values to detect new rows
        # and evictions without touching the arrays
        self.appended_total = 0
        self.evicted_total = 0

    def __len__(self) -> int:
        return self._end - self._start

    def _arrays(self):  # pragma: no cover - subclass responsibility
        raise NotImplementedError

    def _next_slot(self) -> int:
        if self._end == 2 * self.cap:
            n = len(self)
            lo = self._end - n
            for a in self._arrays():
                a[:n] = a[lo : self._end]
            self._start, self._end = 0, n
        if len(self) == self.cap:
            self._start += 1
            self.evicted_total += 1
        i = self._end
        self._end += 1
        self.appended_total += 1
        return i

    def evict_head(self, n: int) -> None:
        """Drop the oldest ``n`` entries (retention-trim lockstep with
        the snapshot store's deque eviction)."""
        if n > 0:
            dropped = min(n, len(self))
            self._start = min(self._start + n, self._end)
            self.evicted_total += dropped

    def _reset(self) -> None:
        self.evicted_total += len(self)
        self._start = 0
        self._end = 0


def _duration(v: Any) -> float:
    """A reported duration as the scalar arm reads it; a non-finite one
    flags the buffer (``nan`` would read as "not reported" here, and
    ``inf`` turns the residual clamp into NaN where ``max()`` does not)."""
    f = float(v)
    if not math.isfinite(f):
        raise ColumnarFallback("non-finite duration")
    return f


class StepTimeColumns(_CompactRing):
    """Per-rank step-time columns mirroring the store's row deque."""

    __slots__ = ("_steps", "_vals", "_clock_ok", "_occ", "_last_step", "columnar_ok")

    def __init__(self, cap: int) -> None:
        super().__init__(cap)
        n = 2 * self.cap
        self._steps = np.empty(n, dtype=np.int64)
        # (row, event, {cpu_ms, device_ms}); NaN == not reported
        self._vals = np.empty((n, N_EVENTS, 2), dtype=np.float64)
        self._clock_ok = np.empty(n, dtype=np.bool_)
        # (row, {device_busy_ms, host_ms}) from row_occupancy_parts;
        # NaN pair == parts unavailable for the row
        self._occ = np.empty((n, 2), dtype=np.float64)
        self._last_step: Optional[int] = None
        self.columnar_ok = True

    def _arrays(self):
        return (self._steps, self._vals, self._clock_ok, self._occ)

    def clear(self) -> None:
        self._reset()
        self._last_step = None
        self.columnar_ok = True

    def append(self, row: Mapping[str, Any]) -> None:
        # always consume a slot, even for rows we cannot represent, so
        # the ring stays 1:1 with the store's deque and eviction math
        # holds; a flagged rank's columns are never read
        i = self._next_slot()
        if not self.columnar_ok:
            return
        try:
            step = int(row["step"])
            if self._last_step is not None and step <= self._last_step:
                raise ColumnarFallback("duplicate or out-of-order step")
            events = row.get("events") or {}
            vals = self._vals[i]
            vals.fill(_NAN)
            for name, ev in events.items():
                j = _EVENT_INDEX.get(name)
                if j is None:
                    continue
                # a truthy non-mapping raises here as in the scalar arm
                cpu = ev.get("cpu_ms")
                if cpu is not None:
                    vals[j, 0] = _duration(cpu)
                dev = ev.get("device_ms")
                if dev is not None:
                    vals[j, 1] = _duration(dev)
            env = events.get(T.STEP_TIME) or {}
            self._clock_ok[i] = (
                row.get("clock") == "device" and env.get("device_ms") is not None
            )
            parts = row_occupancy_parts(events)
            if parts is None:
                self._occ[i, 0] = _NAN
                self._occ[i, 1] = _NAN
            else:
                self._occ[i, 0] = _duration(parts[0])
                self._occ[i, 1] = _duration(parts[1])
            self._steps[i] = step
            self._last_step = step
        except Exception:
            self.columnar_ok = False

    # live views, valid until the next append, evict or clear
    def steps_view(self) -> np.ndarray:
        return self._steps[self._start : self._end]

    def vals_view(self) -> np.ndarray:
        return self._vals[self._start : self._end]

    def occ_view(self) -> np.ndarray:
        return self._occ[self._start : self._end]

    def clock_all_device(self) -> bool:
        return bool(self._clock_ok[self._start : self._end].all())

    def clock_tail_device(self, k: int) -> bool:
        """True when the newest ``k`` live rows are all device-clocked:
        the incremental tick's O(new) "still all-device" check (old live
        rows were already all-device and rows never mutate)."""
        return bool(self._clock_ok[self._end - k : self._end].all())


# MemoryColumns layout: one int64 matrix, -1 == NULL.  Integer columns
# (not float) so byte counts survive exactly into view payloads.
C_STEP, C_DEV, C_CUR, C_PEAK, C_SPEAK, C_LIM = range(6)
_MEM_FIELDS = (
    ("step", C_STEP),
    ("device_id", C_DEV),
    ("current_bytes", C_CUR),
    ("peak_bytes", C_PEAK),
    ("step_peak_bytes", C_SPEAK),
    ("limit_bytes", C_LIM),
)
# int64 -> float64 is exact below 2**53; byte counts near that bound
# (8 PiB) flag the rank instead of silently losing precision
_MAX_EXACT_INT = 2 ** 53


class MemoryColumns(_CompactRing):
    """Per-rank step-memory columns mirroring the store's row deque."""

    __slots__ = ("_data", "columnar_ok")

    def __init__(self, cap: int) -> None:
        super().__init__(cap)
        self._data = np.empty((2 * self.cap, 6), dtype=np.int64)
        self.columnar_ok = True

    def _arrays(self):
        return (self._data,)

    def clear(self) -> None:
        self._reset()
        self.columnar_ok = True

    def append(self, row: Mapping[str, Any]) -> None:
        i = self._next_slot()
        if not self.columnar_ok:
            return
        try:
            out = self._data[i]
            for field, c in _MEM_FIELDS:
                if c == C_DEV:
                    # the scalar context does int(row.get("device_id", 0));
                    # a None device would crash there, so fall back
                    v = row.get(field, 0)
                    if v is None or not isinstance(v, int):
                        raise ColumnarFallback(field)
                    out[c] = v
                    continue
                v = row.get(field)
                if v is None:
                    out[c] = -1
                elif isinstance(v, int) and not isinstance(v, bool):
                    # negatives would collide with the -1 NULL sentinel;
                    # huge ints would lose exactness in float64 math
                    if v < 0 or v >= _MAX_EXACT_INT:
                        raise ColumnarFallback(field)
                    out[c] = v
                else:
                    raise ColumnarFallback(field)
        except Exception:
            self.columnar_ok = False

    def data_view(self) -> np.ndarray:
        return self._data[self._start : self._end]

    def column(self, c: int) -> np.ndarray:
        return self._data[self._start : self._end, c]

    def last_used(self) -> float:
        """``step_peak_bytes or current_bytes or 0`` of the newest row,
        the scalar rules' ``rows[-1]`` read (-1 == NULL, falsy like the
        scalar ``or`` chain treats None and 0)."""
        d = self.data_view()
        if d.shape[0] == 0:
            return 0.0
        sp, cur = int(d[-1, C_SPEAK]), int(d[-1, C_CUR])
        return float(sp if sp > 0 else (cur if cur > 0 else 0))


# ---------------------------------------------------------------------------
# the step-time window
# ---------------------------------------------------------------------------


class _ColumnarData:
    """Raw arrays behind a built window (the ``window.col`` namespace the
    renderers' and diagnoses' fast paths read).  ``medians`` are computed
    lazily from the cube on first access: diagnosis rules that never
    touch a median do not pay the (R, 11, S) partition."""

    __slots__ = (
        "ranks",
        "steps",
        "series_cube",
        "averages",
        "_medians",
        "occupancy",
        "occ_num",
        "occ_host",
    )

    def __init__(
        self, ranks, steps, series_cube, averages, medians, occupancy,
        occ_num=None, occ_host=None,
    ):
        self.ranks: List[int] = ranks
        self.steps: np.ndarray = steps  # (S,) int64 aligned step ids
        self.series_cube: np.ndarray = series_cube  # (R, 11, S) ALL_KEYS order
        self.averages: np.ndarray = averages  # (R, 11)
        self._medians: Optional[np.ndarray] = medians  # (R, 11) or lazy
        self.occupancy: np.ndarray = occupancy  # (R,), NaN == None
        # zero-filled occupancy numerator/denominator planes (R, S), kept
        # so the incremental cache can be primed from a full build
        self.occ_num: Optional[np.ndarray] = occ_num
        self.occ_host: Optional[np.ndarray] = occ_host

    @property
    def medians(self) -> np.ndarray:
        m = self._medians
        if m is None:
            m = self._medians = np.median(self.series_cube, axis=2)
        return m


class _LazySeries(dict):
    """``RankWindow.series`` stand-in: materializes a phase's list from
    the cube on first access.  Consumers only use ``series[key]`` /
    ``series.get``; iteration and equality materialize everything first
    so the dict contract still holds."""

    __slots__ = ("_cube",)

    def __init__(self, cube_r: np.ndarray) -> None:
        super().__init__()
        self._cube = cube_r  # (11, S)

    def __missing__(self, key: str) -> List[float]:
        ki = KEY_INDEX.get(key)
        if ki is None:
            raise KeyError(key)
        vals = self._cube[ki].tolist()
        dict.__setitem__(self, key, vals)
        return vals

    def _materialize_all(self) -> None:
        for k in ALL_KEYS:
            self[k]

    def get(self, key, default=None):
        try:
            return self[key]
        except KeyError:
            return default

    def __contains__(self, key) -> bool:
        return key in KEY_INDEX or dict.__contains__(self, key)

    def __iter__(self):
        self._materialize_all()
        return dict.__iter__(self)

    def __len__(self) -> int:
        self._materialize_all()
        return dict.__len__(self)

    def keys(self):
        self._materialize_all()
        return dict.keys(self)

    def values(self):
        self._materialize_all()
        return dict.values(self)

    def items(self):
        self._materialize_all()
        return dict.items(self)

    def __eq__(self, other):
        self._materialize_all()
        if isinstance(other, _LazySeries):
            other._materialize_all()
        return dict.__eq__(self, other)

    def __ne__(self, other):
        return not self.__eq__(other)

    __hash__ = None


class _LazyRankWindows(Mapping):
    """``StepTimeWindow.rank_windows`` stand-in: builds each rank's
    ``RankWindow`` from the cube on first access and caches it."""

    def __init__(self, col: _ColumnarData, steps_list: List[int], clock: str) -> None:
        self._col = col
        self._steps = steps_list
        self._clock = clock
        self._index = {r: i for i, r in enumerate(col.ranks)}
        self._cache: Dict[int, RankWindow] = {}

    def __getitem__(self, rank: int) -> RankWindow:
        w = self._cache.get(rank)
        if w is None:
            i = self._index[rank]
            col = self._col
            occ = float(col.occupancy[i])
            w = RankWindow(
                rank=rank,
                steps=self._steps,
                series=_LazySeries(col.series_cube[i]),
                averages=dict(zip(ALL_KEYS, col.averages[i].tolist())),
                medians=dict(zip(ALL_KEYS, col.medians[i].tolist())),
                clock=self._clock,
                occupancy=occ if occ == occ else None,
            )
            self._cache[rank] = w
        return w

    def __iter__(self):
        return iter(self._col.ranks)

    def __len__(self) -> int:
        return len(self._col.ranks)


class ColumnarStepTimeWindow(StepTimeWindow):
    """A ``StepTimeWindow`` carrying its backing arrays in ``col``."""

    def __init__(self, *, col: _ColumnarData, **kwargs) -> None:
        super().__init__(**kwargs)
        self.col = col

    @property
    def occupancy_by_rank(self) -> Dict[int, float]:
        out: Dict[int, float] = {}
        for r, v in zip(self.col.ranks, self.col.occupancy.tolist()):
            if v == v:  # not NaN
                out[r] = v
        return out


def _select_clamp_slab(cube_raw: np.ndarray, clock: str) -> np.ndarray:
    """(R, n, N_EVENTS, 2) raw gathered values → (R, 11, n) series slab:
    clock selection, missing or zero → ``0.0`` (the scalar ``v or 0.0``),
    residual clamp, and the accounted left fold in PHASES order (exactly
    the scalar accumulation).  Every output column depends only on its
    own raw column, which is what lets the incremental tick compute
    bit-identical columns one slab at a time."""
    if clock == "device":
        dev = cube_raw[..., 1]
        cpu = cube_raw[..., 0]
        sel = np.where(np.isnan(dev), cpu, dev)
    else:
        sel = cube_raw[..., 0]
    sel = np.where(np.isnan(sel), 0.0, sel) + 0.0
    step = sel[:, :, 0]  # (R, n)
    phases = sel[:, :, 1:]  # (R, n, 9)
    clamped = np.where(
        (step > 0)[:, :, None], np.minimum(phases, step[:, :, None]), phases
    )
    accounted = clamped[:, :, 0] + 0.0
    for k in range(1, len(ACCOUNTED_PHASES)):
        accounted += clamped[:, :, k]
    residual = np.maximum(0.0, step - accounted) + 0.0
    slab = np.empty((step.shape[0], len(ALL_KEYS), step.shape[1]), dtype=np.float64)
    slab[:, 0] = step
    slab[:, 1 : 1 + len(ACCOUNTED_PHASES)] = np.moveaxis(clamped, 2, 1)
    slab[:, len(ALL_KEYS) - 1] = residual
    return slab


def _zeroed_occ_parts(occ_parts: np.ndarray) -> "tuple[np.ndarray, np.ndarray]":
    """(R, n, 2) raw occupancy parts → zero-filled (num, host) pair."""
    num = np.where(np.isnan(occ_parts[:, :, 0]), 0.0, occ_parts[:, :, 0])
    host = np.where(np.isnan(occ_parts[:, :, 1]), 0.0, occ_parts[:, :, 1])
    return num, host


def _occupancy_from_sums(num_sum: np.ndarray, host_sum: np.ndarray) -> np.ndarray:
    """sum/sum with the scalar path's 1.0 clamp, NaN where no host time."""
    with np.errstate(divide="ignore", invalid="ignore"):
        return np.where(host_sum > 0, np.minimum(num_sum / host_sum, 1.0), np.nan)


def _step_time_metrics(
    averages: np.ndarray, ranks: List[int]
) -> Dict[str, StepCombinedTimeMetric]:
    """Cross-rank metrics from the (R, 11) averages (native floats
    throughout; first-max tie-break matching the scalar ``max()``)."""
    metrics: Dict[str, StepCombinedTimeMetric] = {}
    avg_rows = averages.tolist()  # R x 11 native floats
    for ki, key in enumerate(ALL_KEYS):
        col_vals = [row[ki] for row in avg_rows]
        med = float(np.median(averages[:, ki]))
        wi = int(np.argmax(averages[:, ki]))  # first max == scalar max() tie-break
        worst = col_vals[wi]
        metrics[key] = StepCombinedTimeMetric(
            key=key,
            per_rank_avg_ms=dict(zip(ranks, col_vals)),
            median_ms=med,
            worst_ms=worst,
            worst_rank=ranks[wi],
            skew_pct=(worst - med) / med if med > 0 else 0.0,
        )
    return metrics


def _window(col: _ColumnarData, clock: str, phases_present: List[str]) -> ColumnarStepTimeWindow:
    steps_list = col.steps.tolist()
    return ColumnarStepTimeWindow(
        col=col,
        clock=clock,
        steps=steps_list,
        ranks=list(col.ranks),
        rank_windows=_LazyRankWindows(col, steps_list, clock),
        metrics=_step_time_metrics(col.averages, col.ranks),
        phases_present=phases_present,
        n_steps=int(col.steps.size),
    )


def build_columnar_step_time_window(
    rank_cols: Mapping[int, StepTimeColumns],
    max_steps: int,
) -> Optional[ColumnarStepTimeWindow]:
    """Vectorized ``build_step_time_window`` over per-rank columns.

    Raises :class:`ColumnarFallback` if any non-empty rank is flagged.
    """
    items = [(r, c) for r, c in sorted(rank_cols.items(), key=lambda kv: kv[0]) if len(c)]
    if not items:
        return None
    for _, c in items:
        if not c.columnar_ok:
            raise ColumnarFallback("flagged rank buffer")
    ranks = [int(r) for r, _ in items]
    R = len(items)

    # 1. suffix alignment: steps present in EVERY rank, the last max_steps.
    # Per-rank step columns are strictly ascending and unique (flagged
    # otherwise), so counts == R identifies the intersection.
    step_views = [c.steps_view() for _, c in items]
    if R == 1:
        common = np.array(step_views[0][-max_steps:], dtype=np.int64)
    else:
        uniq, counts = np.unique(np.concatenate(step_views), return_counts=True)
        common = uniq[counts == R][-max_steps:]
    S = int(common.size)
    if S == 0:
        return None

    # 2. clock selection: "device" only if EVERY buffered row (not just
    # the aligned suffix, matching select_clock) is device-clocked
    clock = "device" if all(c.clock_all_device() for _, c in items) else "host"

    # 3. gather the aligned (rank, step, event, clock) values
    cube_raw = np.empty((R, S, N_EVENTS, 2), dtype=np.float64)
    occ_parts = np.empty((R, S, 2), dtype=np.float64)
    for i, (_, c) in enumerate(items):
        idx = np.searchsorted(c.steps_view(), common)
        cube_raw[i] = c.vals_view()[idx]
        occ_parts[i] = c.occ_view()[idx]

    # 4. clock select + residual clamp + accounted left fold (shared
    # with the incremental tick)
    series_cube = _select_clamp_slab(cube_raw, clock)

    # 5. per-rank averages: sum() of each series (medians are lazy)
    averages = sum_fold(np.moveaxis(series_cube, 2, 0)) / S

    # 6. occupancy: plain folds of the precomputed (device_busy, host) parts
    occ_num, occ_host = _zeroed_occ_parts(occ_parts)
    occupancy = _occupancy_from_sums(plain_fold(occ_num.T), plain_fold(occ_host.T))

    phases_present = [
        k
        for j, k in enumerate(ACCOUNTED_PHASES)
        if bool((series_cube[:, 1 + j, :] > 0).any())
    ]
    col = _ColumnarData(
        ranks=ranks,
        steps=common,
        series_cube=series_cube,
        averages=averages,
        medians=None,
        occupancy=occupancy,
        occ_num=occ_num,
        occ_host=occ_host,
    )
    return _window(col, clock, phases_present)


def window_to_plain(w: Optional[StepTimeWindow]) -> Optional[Dict[str, Any]]:
    """Canonical plain-dict form of a window for golden comparisons
    (dataclass ``__eq__`` is class-sensitive, so a scalar and a columnar
    window never compare equal directly)."""
    if w is None:
        return None
    return {
        "clock": w.clock,
        "steps": list(w.steps),
        "ranks": list(w.ranks),
        "n_steps": w.n_steps,
        "phases_present": list(w.phases_present),
        "metrics": {k: dataclasses.asdict(m) for k, m in w.metrics.items()},
        "rank_windows": {
            r: {
                "rank": rw.rank,
                "steps": list(rw.steps),
                "series": {k: list(rw.series[k]) for k in ALL_KEYS},
                "averages": dict(rw.averages),
                "medians": dict(rw.medians),
                "clock": rw.clock,
                "occupancy": rw.occupancy,
            }
            for r, rw in w.rank_windows.items()
        },
    }


# ---------------------------------------------------------------------------
# step memory
# ---------------------------------------------------------------------------


def window_series_cube(
    window: StepTimeWindow, key: str = STEP_KEY
) -> "tuple[List[int], np.ndarray]":
    """``(ranks, (rank × step) cube)`` for one series key of a window,
    rows in ``window.ranks`` order.  Columnar windows hand out a view of
    the value cube; scalar windows materialize the same array from their
    per-rank series lists, so the topology reduction below works on
    either path.  The cube is dense by construction — suffix alignment
    keeps only steps present in EVERY rank."""
    if key not in KEY_INDEX:
        raise KeyError(key)
    col = getattr(window, "col", None)
    if col is not None:
        return list(col.ranks), col.series_cube[:, KEY_INDEX[key], :]
    ranks = list(window.ranks)
    cube = np.array(
        [window.rank_windows[r].series[key] for r in ranks],
        dtype=np.float64,
    ).reshape(len(ranks), window.n_steps)
    return ranks, cube


def reduce_window_by_grouping(
    window: StepTimeWindow, grouping: Any, key: str = STEP_KEY
) -> Dict[str, Any]:
    """(rank × step) → (axis-group × step): reshape one series of a
    window along a topology grouping (``utils.topology.Grouping`` —
    host / axis-coordinate / DCN-side) and return per-group aggregates
    plus a per-step dispersion series.

    Ranks outside the grouping are masked out rather than folded into a
    catch-all group.  Output::

        {"kind", "axis", "steps": [...],
         "groups": [{"key", "ranks", "mean": [...S], "min": [...S],
                     "max": [...S]}, ...],       # grouping-key order
         "dispersion": [...S]}                   # max-min of group means

    ``dispersion`` is the step-wise spread of the group means — the
    signal the attribution scorer explains: near-zero means the grouping
    does not separate the ranks on this series.
    """
    from traceml_tpu_torch.utils.topology import reduce_cube

    ranks, cube = window_series_cube(window, key)
    row_of = {int(r): i for i, r in enumerate(ranks)}
    keys = sorted(grouping.groups, key=lambda k: str(k))
    group_index = np.zeros(len(ranks), dtype=np.int64)
    member = np.zeros(len(ranks), dtype=bool)
    for g, k in enumerate(keys):
        for r in grouping.groups[k]:
            i = row_of.get(int(r))
            if i is not None:
                group_index[i] = g
                member[i] = True
    mask = np.broadcast_to(member[:, None], cube.shape)
    red = reduce_cube(cube, group_index, len(keys), mask=mask)
    means = red["mean"]
    with np.errstate(invalid="ignore"):
        spread = np.nanmax(means, axis=0) - np.nanmin(means, axis=0)
    return {
        "kind": grouping.kind,
        "axis": grouping.axis,
        "steps": list(window.steps),
        "groups": [
            {
                "key": str(k),
                "ranks": sorted(int(r) for r in grouping.groups[k]),
                "mean": means[g].tolist(),
                "min": red["min"][g].tolist(),
                "max": red["max"][g].tolist(),
            }
            for g, k in enumerate(keys)
        ],
        "dispersion": np.where(np.isfinite(spread), spread, 0.0).tolist(),
    }


class MemorySeries:
    """One (rank, device) step-memory series, sorted by step: the single
    representation every step-memory rule consumes, built from row dicts
    (scalar reference) or from :class:`MemoryColumns`.

    Values are float64 with NaN for NULL; both construction paths yield
    bit-identical arrays for the same data (int64 -> float64 is exact
    below 2**53, and MemoryColumns flags anything larger)."""

    __slots__ = ("rank", "dev", "steps", "current", "peak", "step_peak", "limit")

    def __init__(self, rank, dev, steps, current, peak, step_peak, limit):
        # stable sort by (step or 0), matching the scalar context's
        # rows.sort(key=lambda r: (r.get("step") or 0))
        order = np.argsort(np.where(np.isnan(steps), 0.0, steps), kind="stable")
        self.rank = rank
        self.dev = dev
        self.steps = steps[order]
        self.current = current[order]
        self.peak = peak[order]
        self.step_peak = step_peak[order]
        self.limit = limit[order]

    @classmethod
    def from_rows(cls, rank: int, dev: int, rows: List[Mapping[str, Any]]) -> "MemorySeries":
        def col(key: str) -> np.ndarray:
            return np.array(
                [
                    float(r[key]) if r.get(key) is not None else _NAN
                    for r in rows
                ],
                dtype=np.float64,
            )

        return cls(
            rank,
            dev,
            col("step"),
            col("current_bytes"),
            col("peak_bytes"),
            col("step_peak_bytes"),
            col("limit_bytes"),
        )

    @classmethod
    def from_int_columns(
        cls, rank: int, dev: int, data: np.ndarray
    ) -> "MemorySeries":
        """``data``: the (n, 6) int64 slice of a MemoryColumns buffer
        already filtered to one device; -1 == NULL."""

        def col(c: int) -> np.ndarray:
            a = data[:, c].astype(np.float64)
            a[data[:, c] == -1] = _NAN
            return a

        return cls(rank, dev, col(C_STEP), col(C_CUR), col(C_PEAK), col(C_SPEAK), col(C_LIM))

    def __len__(self) -> int:
        return int(self.steps.shape[0])

    @staticmethod
    def _opt(v: float) -> Optional[float]:
        return None if v != v else v

    def last_values(self):
        """(step_peak, current, limit) of the final (sorted) row as
        Optional floats: what the scalar rules read via rows[-1]."""
        return (
            self._opt(float(self.step_peak[-1])),
            self._opt(float(self.current[-1])),
            self._opt(float(self.limit[-1])),
        )

    def used_series(self) -> np.ndarray:
        """Per-row ``step_peak or current or 0`` (NaN-aware truthiness,
        so NULL and 0 both fall through, like the scalar `or` chain)."""
        sp, cur = self.step_peak, self.current
        sp_ok = ~np.isnan(sp) & (sp != 0)
        cur_ok = ~np.isnan(cur) & (cur != 0)
        return np.where(sp_ok, sp, np.where(cur_ok, cur, 0.0))

    def latest_pressure(self) -> Optional[float]:
        """used/limit of the newest row where both are truthy."""
        used = self.used_series()
        lim = self.limit
        ok = (used != 0) & ~np.isnan(lim) & (lim != 0)
        idx = np.flatnonzero(ok)
        if idx.size == 0:
            return None
        i = int(idx[-1])
        return float(used[i]) / float(lim[i])

    def last_used(self) -> float:
        sp, cur, _ = self.last_values()
        return float(sp or cur or 0)

    def current_list(self) -> List[float]:
        """``float(current_bytes or 0)`` per row: the creep series."""
        cur = self.current
        return np.where(np.isnan(cur), 0.0, cur).tolist()


# ---------------------------------------------------------------------------
# incremental window engine
# ---------------------------------------------------------------------------

_EMPTY_I64 = np.empty(0, dtype=np.int64)

# invalidation reasons (the vocabulary WindowBuildStats surfaces; the
# tests pin these strings)
INVALIDATE_COLD = "cold_start"
INVALIDATE_RANKS = "rank_set_changed"
INVALIDATE_CLOCK = "clock_flip"
INVALIDATE_EVICTED = "window_evicted"
INVALIDATE_SIZE = "window_size_changed"
INVALIDATE_REALIGNED = "realigned"
INVALIDATE_FALLBACK = "fallback"


class _CacheInvalid(Exception):
    """The delta path cannot represent this tick exactly: fall back to
    a full rebuild (carrying the reason for the stats)."""

    def __init__(self, reason: str) -> None:
        super().__init__(reason)
        self.reason = reason


class WindowBuildStats:
    """Per-domain window-build counters: how many ticks were served
    incrementally and how many were full rebuilds, why the cache
    invalidated, and the last build's wall time.  Surfaced through the
    snapshot store → ``payload_with_versions`` → dashboard and final
    report, so a session silently degrading to full rebuilds is visible."""

    __slots__ = (
        "incr_ticks", "full_rebuilds", "invalidations",
        "last_build_ms", "last_path",
    )

    def __init__(self) -> None:
        self.incr_ticks = 0
        self.full_rebuilds = 0
        self.invalidations: Dict[str, int] = {}
        self.last_build_ms = 0.0
        self.last_path = ""

    def note_incr(self, ms: float) -> None:
        self.incr_ticks += 1
        self.last_build_ms = ms
        self.last_path = "incremental"

    def note_full(self, ms: float, reason: str) -> None:
        self.full_rebuilds += 1
        self.invalidations[reason] = self.invalidations.get(reason, 0) + 1
        self.last_build_ms = ms
        self.last_path = "full"

    def snapshot(self) -> Dict[str, Any]:
        return {
            "incr_ticks": self.incr_ticks,
            "full_rebuilds": self.full_rebuilds,
            "invalidations": dict(self.invalidations),
            "last_build_ms": self.last_build_ms,
            "last_path": self.last_path,
        }


#: tick-profiler stage vocabulary; the tests pin these strings the same
#: way they pin INVALIDATE_*
TICK_STAGES = (
    "refresh", "build", "diagnose", "attribute", "view", "serialize",
)


class TickProfile:
    """Per-stage tick profiler: cumulative nanoseconds per (domain,
    stage) plus counters (diagnosis cache hits and misses, rule
    evaluations, memo hits).  It extends :class:`WindowBuildStats` from
    "where did the window build go" to "where did the whole tick go":
    refresh → build → diagnose → attribute → view → serialize.  It lives
    on the snapshot store and reaches the user through the same
    ``window_build`` block, so the observer's own cost is observable."""

    __slots__ = ("ticks", "stage_ns", "counters")

    def __init__(self) -> None:
        self.ticks = 0
        self.stage_ns: Dict[str, Dict[str, int]] = {}
        self.counters: Dict[str, int] = {}

    def note_tick(self) -> None:
        self.ticks += 1

    def note_stage(self, domain: str, stage: str, ns: int) -> None:
        per = self.stage_ns.setdefault(domain, {})
        per[stage] = per.get(stage, 0) + int(ns)

    def bump(self, counter: str, n: int = 1) -> None:
        self.counters[counter] = self.counters.get(counter, 0) + n

    def snapshot(self) -> Dict[str, Any]:
        return {
            "ticks": self.ticks,
            "stage_ns": {
                d: {s: per[s] for s in sorted(per)}
                for d, per in sorted(self.stage_ns.items())
            },
            "counters": {k: self.counters[k] for k in sorted(self.counters)},
        }


def window_build_snapshot(caches: Mapping[str, Any], profile: TickProfile) -> Dict[str, Dict[str, Any]]:
    """The ``window_build`` block: each domain cache's stats and, once
    the profiler saw a tick, a ``tick_profile`` entry with the vector
    arm's fallback counters and the topology grouping memo's hits and
    misses among its counters."""
    from traceml_tpu_torch.utils.topology import grouping_cache_counts

    out: Dict[str, Dict[str, Any]] = {
        domain: cache.stats.snapshot() for domain, cache in sorted(caches.items())
    }
    if profile.ticks or profile.stage_ns:
        prof = profile.snapshot()
        for domain, n in sorted(vector_fallback_counts().items()):
            prof["counters"][f"vector_fallbacks_{domain}"] = n
        for k, n in sorted(grouping_cache_counts().items()):
            prof["counters"][f"grouping_cache_{k}"] = n
        out["tick_profile"] = prof
    return out


def engine_step_time_window(rank_cols, caches: Dict[str, Any], max_steps: int):
    """The step-time window's columnar arm: the incremental cache kept in
    ``caches["step_time"]`` or, under ``TRACEML_INCR_WINDOW=0``, the full
    build.  Raises :class:`ColumnarFallback` for a flagged ring; the
    caller then builds the scalar arm from its rows."""
    if incr_window_enabled():
        cache = caches.get("step_time")
        if cache is None:
            cache = caches["step_time"] = StepTimeWindowCache()
        return cache.build(rank_cols, max_steps)
    return build_columnar_step_time_window(rank_cols, max_steps)


def engine_collectives_window(rank_cols, caches: Dict[str, Any], max_steps: int):
    """The collectives window's columnar arm: the incremental cache kept
    in ``caches["collectives"]`` or, under ``TRACEML_INCR_WINDOW=0``, the
    full build.  Raises :class:`ColumnarFallback` for a flagged ring."""
    if incr_window_enabled():
        cache = caches.get("collectives")
        if cache is None:
            cache = caches["collectives"] = CollectivesWindowCache()
        return cache.build(rank_cols, max_steps)
    return build_columnar_collectives_window(rank_cols, max_steps)


class _WindowCacheBase:
    """Shared build shell: try the delta tick, invalidate to the full
    (golden) build on any condition the delta path cannot represent
    exactly, re-prime the cache from the full result, and keep the
    counters honest.  ``ColumnarFallback`` propagates to the caller (the
    store runs the scalar reference) after noting the reason."""

    def __init__(self) -> None:
        self.stats = WindowBuildStats()
        self._valid = False

    def invalidate(self) -> None:
        self._valid = False

    # subclass hooks -----------------------------------------------------
    def _tick(self, rank_cols, max_steps):  # pragma: no cover - abstract
        raise NotImplementedError

    def _full_build(self, rank_cols, max_steps):  # pragma: no cover
        raise NotImplementedError

    def _prime(self, window, rank_cols, max_steps):  # pragma: no cover
        raise NotImplementedError

    # --------------------------------------------------------------------
    def build(self, rank_cols, max_steps: int):
        t0 = time.perf_counter()
        try:
            window = self._tick(rank_cols, max_steps)
        except _CacheInvalid as inv:
            self._valid = False
            try:
                window = self._full_build(rank_cols, max_steps)
            except ColumnarFallback:
                self.stats.note_full(
                    (time.perf_counter() - t0) * 1000.0, INVALIDATE_FALLBACK
                )
                raise
            self._prime(window, rank_cols, max_steps)
            self.stats.note_full((time.perf_counter() - t0) * 1000.0, inv.reason)
            return window
        except ColumnarFallback:
            self._valid = False
            self.stats.note_full(
                (time.perf_counter() - t0) * 1000.0, INVALIDATE_FALLBACK
            )
            raise
        self.stats.note_incr((time.perf_counter() - t0) * 1000.0)
        return window

    @staticmethod
    def _sorted_items(rank_cols):
        items = [
            (int(r), c)
            for r, c in sorted(rank_cols.items(), key=lambda kv: kv[0])
            if len(c)
        ]
        for _, c in items:
            if not c.columnar_ok:
                raise ColumnarFallback("flagged rank buffer")
        return items


class StepTimeWindowCache(_WindowCacheBase):
    """Persistent aligned-cube cache for the step-time window.

    The cache owns a (rank, 11, step) series cube with slack along the
    step axis (twice the window, compacted with a memmove like
    :class:`_CompactRing`) and step-major mirrors of it.  A dirty tick:

    * gathers and clamps ONLY the newly common aligned columns and
      appends them (each column depends only on its own raw values, so a
      column built at tick t is bit-identical to the same column inside
      a from-scratch cube);
    * slides the window head past ring-evicted steps (head-only eviction
      and strictly ascending per-rank steps mean a surviving cached step
      is still common, so a slide is exact);
    * folds the averages and the occupancy again over the cached window
      with the same exact folds the full build uses (a float window sum
      cannot be delta-updated bit-exactly, ``(a + b) - a != b``, but the
      fold over the step-major mirror is cheap); medians stay lazy.

    Invalidation → full rebuild: a rank-set change, a clock flip, a new
    window length, a rank re-reporting an old step, or
    ``ColumnarFallback``.

    Aliasing contract: emitted windows hand out views into the cache's
    buffers, valid until the next ``build()``: the lifetime the ring
    views already have.  The live computer serializes within the tick.
    """

    def __init__(self) -> None:
        super().__init__()
        self._max_steps = 0
        self._ranks: List[int] = []
        self._clock = "host"
        self._last_aligned = 0
        self._cap = 0
        self._lo = 0
        self._hi = 0
        self._steps: Optional[np.ndarray] = None
        self._cube: Optional[np.ndarray] = None
        self._phase_any: Optional[np.ndarray] = None
        # step-major mirrors of the cube and the occupancy planes: the
        # per-tick folds walk contiguous (R, …) slices
        self._cube_t: Optional[np.ndarray] = None
        self._num_t: Optional[np.ndarray] = None
        self._host_t: Optional[np.ndarray] = None
        # per-rank (sorted order) bookkeeping that lets the warm tick
        # skip binary searches: appended_total at the last tick, and
        # whether the rank's newest row WAS the aligned tail
        self._seen_appended: List[int] = []
        self._aligned: List[bool] = []

    def _full_build(self, rank_cols, max_steps):
        return build_columnar_step_time_window(rank_cols, max_steps)

    def _tick(self, rank_cols, max_steps):
        if not self._valid:
            raise _CacheInvalid(INVALIDATE_COLD)
        if int(max_steps) != self._max_steps:
            raise _CacheInvalid(INVALIDATE_SIZE)
        items = self._sorted_items(rank_cols)
        if [r for r, _ in items] != self._ranks:
            raise _CacheInvalid(INVALIDATE_RANKS)
        R = len(items)
        la = self._last_aligned
        dev_cached = self._clock == "device"

        head_floor = None
        svs: List[np.ndarray] = []
        tails: List[np.ndarray] = []
        lasts: List[int] = []
        new_app: List[int] = []
        any_empty_tail = False
        for i, (_, c) in enumerate(items):
            sv = c.steps_view()
            svs.append(sv)
            first = int(sv[0])
            if head_floor is None or first > head_floor:
                head_floor = first
            lasts.append(int(sv[-1]))
            n_new = c.appended_total - self._seen_appended[i]
            new_app.append(c.appended_total)
            k = n_new if n_new < sv.size else sv.size
            if k > 0:
                if int(sv[sv.size - k]) <= la:
                    # a cleared-and-restarted rank re-reported an old
                    # step; the intersection delta cannot express that
                    raise _CacheInvalid(INVALIDATE_REALIGNED)
                if dev_cached and not c.clock_tail_device(k):
                    raise _CacheInvalid(INVALIDATE_CLOCK)
            if self._aligned[i]:
                # the rank's newest row WAS the aligned tail, so its
                # candidate rows are exactly the surviving appends since
                # the last tick (strict per-rank ascent puts them above la)
                t = sv[sv.size - k :] if k > 0 else _EMPTY_I64
            else:
                # the rank ran ahead of the aligned tail last tick: older
                # rows above la are candidates too
                t = sv[int(np.searchsorted(sv, la, side="right")):]
            tails.append(t)
            if t.size == 0:
                any_empty_tail = True
        if dev_cached:
            clock = "device"
        else:
            # host → device flips only once every host-clocked row has
            # been evicted; the scan stops at the first host row
            for _, c in items:
                if not c.clock_all_device():
                    break
            else:
                raise _CacheInvalid(INVALIDATE_CLOCK)
            clock = "host"
        # every check that can invalidate has passed: commit the counters
        self._seen_appended = new_app

        # newly common steps: present in EVERY rank's post-cache tail (a
        # step at or below the cached tail cannot gain membership)
        if any_empty_tail:
            new_common = _EMPTY_I64
        elif R == 1:
            new_common = tails[0]
        else:
            uniq, counts = np.unique(np.concatenate(tails), return_counts=True)
            new_common = uniq[counts == R]

        if new_common.size:
            new_common = new_common[-self._max_steps:]
            n_new = int(new_common.size)
            self._ensure_capacity(n_new)
            hi = self._hi
            cube_raw = np.empty((R, n_new, N_EVENTS, 2), dtype=np.float64)
            occ_parts = np.empty((R, n_new, 2), dtype=np.float64)
            for i, (_, c) in enumerate(items):
                t = tails[i]
                base = svs[i].size - t.size
                if t.size == n_new:
                    # new_common ⊆ every tail, so equal size means equal
                    # content: the gather is a plain tail slice (the warm
                    # steady-state path: one new step, all ranks)
                    cube_raw[i] = c.vals_view()[base:]
                    occ_parts[i] = c.occ_view()[base:]
                else:
                    idx = base + np.searchsorted(t, new_common)
                    cube_raw[i] = c.vals_view()[idx]
                    occ_parts[i] = c.occ_view()[idx]
            slab = _select_clamp_slab(cube_raw, clock)
            self._cube[:, :, hi : hi + n_new] = slab
            num, host = _zeroed_occ_parts(occ_parts)
            self._cube_t[hi : hi + n_new] = np.moveaxis(slab, 2, 0)
            self._num_t[hi : hi + n_new] = num.T
            self._host_t[hi : hi + n_new] = host.T
            for j in range(len(ACCOUNTED_PHASES)):
                self._phase_any[j, hi : hi + n_new] = (
                    slab[:, 1 + j, :] > 0
                ).any(axis=0)
            self._steps[hi : hi + n_new] = new_common
            self._hi = hi + n_new
            self._last_aligned = int(new_common[-1])
        new_la = self._last_aligned
        self._aligned = [last == new_la for last in lasts]

        # slide the head past evicted steps, then clamp to the window
        lo = self._lo + int(
            np.searchsorted(
                self._steps[self._lo : self._hi], head_floor, side="left"
            )
        )
        self._lo = max(lo, self._hi - self._max_steps)
        if self._hi == self._lo:
            return None  # the intersection is empty, as in the full build
        return self._emit(clock)

    def _ensure_capacity(self, n_new: int) -> None:
        if self._hi + n_new <= self._cap:
            return
        live = self._hi - self._lo
        lo, hi = self._lo, self._hi
        # live + n_new <= 2 * max_steps == cap by construction (new
        # columns are clamped to the window length first)
        self._steps[:live] = self._steps[lo:hi]
        self._cube[:, :, :live] = self._cube[:, :, lo:hi]
        self._cube_t[:live] = self._cube_t[lo:hi]
        self._num_t[:live] = self._num_t[lo:hi]
        self._host_t[:live] = self._host_t[lo:hi]
        self._phase_any[:, :live] = self._phase_any[:, lo:hi]
        self._lo, self._hi = 0, live

    def _emit(self, clock: str) -> ColumnarStepTimeWindow:
        lo, hi = self._lo, self._hi
        S = hi - lo
        # the full build's folds over the step-major mirrors: same adds,
        # same order, same bits
        averages = sum_fold(self._cube_t, lo, hi) / S
        occupancy = _occupancy_from_sums(
            plain_fold(self._num_t, lo, hi), plain_fold(self._host_t, lo, hi)
        )
        phases_present = [
            k
            for j, k in enumerate(ACCOUNTED_PHASES)
            if bool(self._phase_any[j, lo:hi].any())
        ]
        col = _ColumnarData(
            ranks=list(self._ranks),
            steps=self._steps[lo:hi],
            series_cube=self._cube[:, :, lo:hi],
            averages=averages,
            medians=None,
            occupancy=occupancy,
        )
        return _window(col, clock, phases_present)

    def _prime(self, window, rank_cols, max_steps) -> None:
        if window is None:
            self._valid = False
            return
        col = window.col
        R = len(col.ranks)
        S = window.n_steps
        self._max_steps = int(max_steps)
        self._cap = 2 * self._max_steps
        self._steps = np.empty(self._cap, dtype=np.int64)
        self._cube = np.empty((R, len(ALL_KEYS), self._cap), dtype=np.float64)
        self._cube_t = np.empty((self._cap, R, len(ALL_KEYS)), dtype=np.float64)
        self._num_t = np.empty((self._cap, R), dtype=np.float64)
        self._host_t = np.empty((self._cap, R), dtype=np.float64)
        self._phase_any = np.empty((len(ACCOUNTED_PHASES), self._cap), dtype=np.bool_)
        self._steps[:S] = col.steps
        self._cube[:, :, :S] = col.series_cube
        self._cube_t[:S] = np.moveaxis(col.series_cube, 2, 0)
        self._num_t[:S] = col.occ_num.T
        self._host_t[:S] = col.occ_host.T
        for j in range(len(ACCOUNTED_PHASES)):
            self._phase_any[j, :S] = (col.series_cube[:, 1 + j, :] > 0).any(axis=0)
        self._lo, self._hi = 0, S
        self._ranks = list(col.ranks)
        self._clock = window.clock
        self._last_aligned = int(col.steps[-1])
        items = self._sorted_items(rank_cols)
        self._seen_appended = [c.appended_total for _, c in items]
        self._aligned = [
            int(c.steps_view()[-1]) == self._last_aligned for _, c in items
        ]
        self._valid = True


# ---------------------------------------------------------------------------
# the collectives domain: per-rank (step, op, dtype) rows → per-step
# overlap-efficiency window
# ---------------------------------------------------------------------------

# canonical op vocabulary: instrumentation/collectives.OP_KINDS (the
# tests pin the two equal)
COLLECTIVE_OPS = (
    "all_reduce",
    "all_gather",
    "reduce_scatter",
    "all_to_all",
    "p2p",
    "other",
)
_COLL_OP_INDEX = {op: i for i, op in enumerate(COLLECTIVE_OPS)}
_COLL_DTYPE_VOCAB_MAX = 64  # per-buffer dtype vocabulary bound

# int column layout
CC_STEP, CC_COUNT, CC_BYTES, CC_GROUP = range(4)


class CollectivesColumns(_CompactRing):
    """Per-rank collectives columns mirroring the store's row deque.

    One appended row per (step, op, dtype) aggregate from the sampler;
    steps are non-decreasing (several op/dtype rows share a step) —
    anything else flags the buffer for the scalar reference path."""

    __slots__ = (
        "_ints",
        "_floats",
        "_ops",
        "_dtypes",
        "_dtype_vocab",
        "_dtype_index",
        "_last_step",
        "columnar_ok",
    )

    def __init__(self, cap: int) -> None:
        super().__init__(cap)
        n = 2 * self.cap
        self._ints = np.empty((n, 4), dtype=np.int64)
        self._floats = np.empty((n, 2), dtype=np.float64)  # duration, exposed
        self._ops = np.empty(n, dtype=np.int8)
        self._dtypes = np.empty(n, dtype=np.int16)
        self._dtype_vocab: List[str] = []
        self._dtype_index: Dict[str, int] = {}
        self._last_step: Optional[int] = None
        self.columnar_ok = True

    def _arrays(self):
        return (self._ints, self._floats, self._ops, self._dtypes)

    def clear(self) -> None:
        self._reset()
        self._last_step = None
        self.columnar_ok = True
        # the dtype vocab survives a clear on purpose: codes in the ring
        # are gone, and re-coding the same strings is stable either way

    def append(self, row: Mapping[str, Any]) -> None:
        # always consume a slot (ring stays 1:1 with the row deque)
        i = self._next_slot()
        if not self.columnar_ok:
            return
        try:
            step = int(row["step"])
            if isinstance(row["step"], bool):
                raise ColumnarFallback("bool step")
            if self._last_step is not None and step < self._last_step:
                raise ColumnarFallback("out-of-order step")
            op = row.get("op")
            oi = _COLL_OP_INDEX.get(op)
            if oi is None:
                oi = _COLL_OP_INDEX["other"]
            dtype = str(row.get("dtype", "") or "")
            di = self._dtype_index.get(dtype)
            if di is None:
                if len(self._dtype_vocab) >= _COLL_DTYPE_VOCAB_MAX:
                    raise ColumnarFallback("dtype vocabulary overflow")
                di = len(self._dtype_vocab)
                self._dtype_vocab.append(dtype)
                self._dtype_index[dtype] = di
            ints = self._ints[i]
            for c, key in ((CC_COUNT, "count"), (CC_BYTES, "bytes"), (CC_GROUP, "group_size")):
                v = row.get(key, 0)
                if v is None:
                    v = 0
                if not isinstance(v, int) or isinstance(v, bool):
                    raise ColumnarFallback(key)
                if v < 0 or v >= _MAX_EXACT_INT:
                    raise ColumnarFallback(key)
                ints[c] = v
            ints[CC_STEP] = step
            dur = float(row.get("duration_ms", 0.0) or 0.0)
            exp = float(row.get("exposed_ms", 0.0) or 0.0)
            if dur < 0.0 or exp < 0.0 or exp > dur:
                raise ColumnarFallback("exposure outside duration")
            self._floats[i, 0] = dur
            self._floats[i, 1] = exp
            self._ops[i] = oi
            self._dtypes[i] = di
            self._last_step = step
        except Exception:
            self.columnar_ok = False

    # live views — valid until the next append/evict/clear
    def steps_view(self) -> np.ndarray:
        return self._ints[self._start : self._end, CC_STEP]

    def ints_view(self) -> np.ndarray:
        return self._ints[self._start : self._end]

    def floats_view(self) -> np.ndarray:
        return self._floats[self._start : self._end]

    def ops_view(self) -> np.ndarray:
        return self._ops[self._start : self._end]

    def dtypes_view(self) -> np.ndarray:
        return self._dtypes[self._start : self._end]

    def dtype_name(self, code: int) -> str:
        return self._dtype_vocab[code]


def _overlap_efficiency(total_ms: float, exposed_ms: float) -> float:
    """Share of comm time hidden behind compute: ``1 − exposed/total``.
    A zero-comm step is perfectly hidden by definition → 1.0, not NaN."""
    if total_ms > 0.0:
        return 1.0 - exposed_ms / total_ms
    return 1.0


@dataclasses.dataclass
class CollectivesWindow:
    """Cross-rank collectives aggregate over the last ``n_steps`` steps.

    Steps are the UNION of the ranks' steps (ragged participation — a
    rank that skips a collective still leaves the step in the window).
    ``per_step`` series are aligned to ``steps``; ``overlap_efficiency``
    is ``1 − exposed/total`` with zero-comm steps defined as 1.0."""

    steps: List[int]
    n_steps: int
    ranks: List[int]
    group_size: int
    per_step: Dict[str, List[float]]
    per_op: Dict[str, Dict[str, float]]
    per_rank: Dict[int, Dict[str, float]]
    totals: Dict[str, float]


def build_collectives_window_rows(
    rank_rows: Mapping[int, Any],
    max_steps: int,
) -> Optional[CollectivesWindow]:
    """Scalar reference fold over row dicts — the golden path the
    columnar build below must reproduce bit-identically.  Ranks are
    folded in sorted order, rows in arrival order."""
    items = [(r, list(rows)) for r, rows in sorted(rank_rows.items()) if rows]
    if not items:
        return None
    all_steps = sorted({int(row["step"]) for _, rows in items for row in rows})
    steps = all_steps[-max_steps:]
    lo = steps[0]
    idx = {s: i for i, s in enumerate(steps)}
    S = len(steps)

    count = [0] * S
    nbytes = [0] * S
    dur = [0.0] * S
    exp = [0.0] * S
    ar_fp32 = [0] * S
    per_op: Dict[str, Dict[str, float]] = {}
    per_rank: Dict[int, Dict[str, float]] = {}
    group = 1
    for rank, rows in items:
        r_dur = 0.0
        r_exp = 0.0
        r_bytes = 0
        for row in rows:
            s = int(row["step"])
            if s < lo:
                continue
            i = idx[s]
            c = int(row.get("count", 0) or 0)
            b = int(row.get("bytes", 0) or 0)
            d = float(row.get("duration_ms", 0.0) or 0.0)
            e = float(row.get("exposed_ms", 0.0) or 0.0)
            op = row.get("op") if row.get("op") in _COLL_OP_INDEX else "other"
            count[i] += c
            nbytes[i] += b
            dur[i] += d
            exp[i] += e
            if op == "all_reduce" and str(row.get("dtype", "")) == "float32":
                ar_fp32[i] += b
            slot = per_op.get(op)
            if slot is None:
                slot = per_op[op] = {
                    "count": 0, "bytes": 0, "duration_ms": 0.0, "exposed_ms": 0.0,
                }
            slot["count"] += c
            slot["bytes"] += b
            slot["duration_ms"] += d
            slot["exposed_ms"] += e
            group = max(group, int(row.get("group_size", 1) or 1))
            r_dur += d
            r_exp += e
            r_bytes += b
        per_rank[rank] = {
            "duration_ms": r_dur,
            "exposed_ms": r_exp,
            "bytes": r_bytes,
            "overlap_efficiency": _overlap_efficiency(r_dur, r_exp),
        }

    total_dur = 0.0
    total_exp = 0.0
    for v in dur:
        total_dur += v
    for v in exp:
        total_exp += v
    return CollectivesWindow(
        steps=steps,
        n_steps=S,
        ranks=[r for r, _ in items],
        group_size=group,
        per_step={
            "count": count,
            "bytes": nbytes,
            "duration_ms": dur,
            "exposed_ms": exp,
            "overlap_efficiency": [
                _overlap_efficiency(dur[i], exp[i]) for i in range(S)
            ],
            "allreduce_fp32_bytes": ar_fp32,
        },
        per_op=per_op,
        per_rank=per_rank,
        totals={
            "count": sum(count),
            "bytes": sum(nbytes),
            "duration_ms": total_dur,
            "exposed_ms": total_exp,
            "overlap_efficiency": _overlap_efficiency(total_dur, total_exp),
        },
    )


def build_columnar_collectives_window(
    rank_cols: Mapping[int, CollectivesColumns],
    max_steps: int,
) -> Optional[CollectivesWindow]:
    """Vectorized ``build_collectives_window_rows`` over per-rank columns.

    Exactness: per-slot accumulation uses ``np.add.at``, unbuffered and
    applied in element order, so repeated step slots accumulate in row
    order exactly like the scalar ``acc[i] += v`` fold; ranks are
    processed in sorted order, matching the scalar traversal; the
    per-rank and total sums are ``np.cumsum(...)[-1]``, the scalar arm's
    ``+=`` left fold (the scalar arm folds no float with ``sum()``, so
    the 3.12 compensated sum never enters).  Raises
    :class:`ColumnarFallback` if any non-empty rank is flagged."""
    items = [
        (r, c) for r, c in sorted(rank_cols.items(), key=lambda kv: kv[0]) if len(c)
    ]
    if not items:
        return None
    for _, c in items:
        if not c.columnar_ok:
            raise ColumnarFallback("flagged rank buffer")

    uniq = np.unique(np.concatenate([c.steps_view() for _, c in items]))
    common = uniq[-max_steps:]
    S = int(common.size)
    lo = int(common[0])

    count = np.zeros(S, dtype=np.int64)
    nbytes = np.zeros(S, dtype=np.int64)
    dur = np.zeros(S, dtype=np.float64)
    exp = np.zeros(S, dtype=np.float64)
    ar_fp32 = np.zeros(S, dtype=np.int64)
    n_ops = len(COLLECTIVE_OPS)
    op_count = np.zeros(n_ops, dtype=np.int64)
    op_bytes = np.zeros(n_ops, dtype=np.int64)
    op_dur = np.zeros(n_ops, dtype=np.float64)
    op_exp = np.zeros(n_ops, dtype=np.float64)
    op_seen = np.zeros(n_ops, dtype=np.bool_)
    per_rank: Dict[int, Dict[str, float]] = {}
    group = 1
    ar_code = _COLL_OP_INDEX["all_reduce"]

    for rank, c in items:
        steps = c.steps_view()
        mask = steps >= lo
        slots = np.searchsorted(common, steps[mask])
        ints = c.ints_view()[mask]
        floats = c.floats_view()[mask]
        ops = c.ops_view()[mask].astype(np.int64)
        np.add.at(count, slots, ints[:, CC_COUNT])
        np.add.at(nbytes, slots, ints[:, CC_BYTES])
        np.add.at(dur, slots, floats[:, 0])
        np.add.at(exp, slots, floats[:, 1])
        np.add.at(op_count, ops, ints[:, CC_COUNT])
        np.add.at(op_bytes, ops, ints[:, CC_BYTES])
        np.add.at(op_dur, ops, floats[:, 0])
        np.add.at(op_exp, ops, floats[:, 1])
        op_seen[ops] = True
        try:
            fp32_code = c._dtype_index["float32"]
        except KeyError:
            fp32_code = -1
        fp32_mask = (ops == ar_code) & (c.dtypes_view()[mask] == fp32_code)
        if fp32_mask.any():
            np.add.at(ar_fp32, slots[fp32_mask], ints[fp32_mask, CC_BYTES])
        if ints.shape[0]:
            group = max(group, int(ints[:, CC_GROUP].max()))
            r_dur = float(np.cumsum(floats[:, 0])[-1])
            r_exp = float(np.cumsum(floats[:, 1])[-1])
            r_bytes = int(np.cumsum(ints[:, CC_BYTES])[-1])
        else:
            r_dur = r_exp = 0.0
            r_bytes = 0
        per_rank[rank] = {
            "duration_ms": r_dur,
            "exposed_ms": r_exp,
            "bytes": r_bytes,
            "overlap_efficiency": _overlap_efficiency(r_dur, r_exp),
        }

    dur_l = dur.tolist()
    exp_l = exp.tolist()
    # totals fold over the per-step series, matching the scalar loop
    total_dur = float(np.cumsum(dur)[-1]) if S else 0.0
    total_exp = float(np.cumsum(exp)[-1]) if S else 0.0
    per_op: Dict[str, Dict[str, float]] = {}
    for oi, op in enumerate(COLLECTIVE_OPS):
        if not op_seen[oi]:
            continue
        per_op[op] = {
            "count": int(op_count[oi]),
            "bytes": int(op_bytes[oi]),
            "duration_ms": float(op_dur[oi]),
            "exposed_ms": float(op_exp[oi]),
        }
    return CollectivesWindow(
        steps=common.tolist(),
        n_steps=S,
        ranks=[r for r, _ in items],
        group_size=group,
        per_step={
            "count": count.tolist(),
            "bytes": nbytes.tolist(),
            "duration_ms": dur_l,
            "exposed_ms": exp_l,
            "overlap_efficiency": [
                _overlap_efficiency(dur_l[i], exp_l[i]) for i in range(S)
            ],
            "allreduce_fp32_bytes": ar_fp32.tolist(),
        },
        per_op=per_op,
        per_rank=per_rank,
        totals={
            "count": int(np.cumsum(count)[-1]) if S else 0,
            "bytes": int(np.cumsum(nbytes)[-1]) if S else 0,
            "duration_ms": total_dur,
            "exposed_ms": total_exp,
            "overlap_efficiency": _overlap_efficiency(total_dur, total_exp),
        },
    )


def collectives_window_to_plain(
    w: Optional[CollectivesWindow],
) -> Optional[Dict[str, Any]]:
    """Canonical plain-dict form for golden comparisons."""
    if w is None:
        return None
    return {
        "steps": list(w.steps),
        "n_steps": w.n_steps,
        "ranks": list(w.ranks),
        "group_size": w.group_size,
        "per_step": {k: list(v) for k, v in w.per_step.items()},
        "per_op": {k: dict(v) for k, v in sorted(w.per_op.items())},
        "per_rank": {r: dict(v) for r, v in sorted(w.per_rank.items())},
        "totals": dict(w.totals),
    }


class _SlotWindowCacheBase(_WindowCacheBase):
    """Shared machinery for the union-aligned (collectives/serving)
    caches: per-step slot arrays with 2x slack, a delta scan that
    classifies newly appended rows against the cached window, and a
    conservative eviction guard keyed on the rings' monotone
    ``appended_total``/``evicted_total`` counters.

    Slot exactness: a cached slot value equals the fold (in sorted-rank,
    row-order — ``np.add.at`` element order) over ALL live rows carrying
    that step.  A new row landing on a cached step makes the slot
    "touched"; touched and new slots are recomputed from scratch from
    the raw rows, so partial-sum merging (which would change IEEE fold
    grouping) never happens.

    Invalidation: a mid-window union insert (new step ≤ cached max not
    already cached) or a below-window insert while the union is still
    shorter than the window ("realigned"), and any eviction whose
    surviving head sits at/above the cached window start
    ("window_evicted" — the evicted rows might have contributed to
    cached slots).  Evictions strictly below the window are provably
    harmless: head-only eviction + non-decreasing steps mean every
    evicted step ≤ the surviving oldest step < window start."""

    def __init__(self) -> None:
        super().__init__()
        self._max_steps = 0
        self._cap = 0
        self._lo = 0
        self._hi = 0
        self._steps: Optional[np.ndarray] = None
        self._ranks: List[int] = []
        self._seen_appended: List[int] = []
        self._seen_evicted: List[int] = []

    def _slot_arrays(self):  # pragma: no cover - abstract
        raise NotImplementedError

    def _scan_delta(self, items, max_steps: int):
        """Classify each rank's newly appended rows.  Returns
        ``(touched_steps, new_union_steps)`` or raises
        :class:`_CacheInvalid`.  Seen counters advance only when every
        check passed (a raise re-primes them anyway)."""
        if [r for r, _ in items] != self._ranks:
            raise _CacheInvalid(INVALIDATE_RANKS)
        lo_step = int(self._steps[self._lo])
        cached_max = int(self._steps[self._hi - 1])
        cached_S = self._hi - self._lo
        cs = self._steps[self._lo : self._hi]
        touched: set = set()
        tail_parts: List[np.ndarray] = []
        new_app: List[int] = []
        new_ev: List[int] = []
        for i, (_, c) in enumerate(items):
            new_app.append(c.appended_total)
            new_ev.append(c.evicted_total)
            sv = c.steps_view()
            if c.evicted_total != self._seen_evicted[i] and int(sv[0]) >= lo_step:
                raise _CacheInvalid(INVALIDATE_EVICTED)
            n_new = c.appended_total - self._seen_appended[i]
            if n_new <= 0:
                continue
            ns = sv[max(0, sv.size - n_new):]
            pos = int(np.searchsorted(ns, cached_max, side="right"))
            old_part = ns[:pos]
            if old_part.size:
                below = old_part[old_part < lo_step]
                if below.size and cached_S < max_steps:
                    # the union (== cached window) would grow downward
                    raise _CacheInvalid(INVALIDATE_REALIGNED)
                within = old_part[old_part >= lo_step]
                if within.size:
                    at = np.searchsorted(cs, within)
                    if bool((cs[at] != within).any()):
                        # mid-window union insert
                        raise _CacheInvalid(INVALIDATE_REALIGNED)
                    touched.update(int(x) for x in within)
            if pos < ns.size:
                tail_parts.append(ns[pos:])
        if tail_parts:
            if len(tail_parts) > 1:
                new_steps = np.unique(np.concatenate(tail_parts))
            else:
                new_steps = np.unique(tail_parts[0])
        else:
            new_steps = _EMPTY_I64
        self._seen_appended = new_app
        self._seen_evicted = new_ev
        return touched, new_steps

    def _ensure_slot_capacity(self, n_new: int) -> None:
        if self._hi + n_new <= self._cap:
            return
        live = self._hi - self._lo
        lo, hi = self._lo, self._hi
        self._steps[:live] = self._steps[lo:hi]
        for a in self._slot_arrays():
            a[:live] = a[lo:hi]
        self._lo, self._hi = 0, live

    def _append_and_touch(self, touched, new_steps):
        """Append zeroed slots for the new union steps (pre-clamped to
        the window), slide the window, and mark them for recompute."""
        if new_steps.size:
            new_steps = new_steps[-self._max_steps:]
            n_new = int(new_steps.size)
            self._ensure_slot_capacity(n_new)
            hi = self._hi
            self._steps[hi : hi + n_new] = new_steps
            for a in self._slot_arrays():
                a[hi : hi + n_new] = 0
            self._hi = hi + n_new
            self._lo = max(self._lo, self._hi - self._max_steps)
            touched.update(int(x) for x in new_steps)
        return touched

    def _prime_common(self, window, rank_cols) -> None:
        self._lo, self._hi = 0, window.n_steps
        items = self._sorted_items(rank_cols)
        self._ranks = [r for r, _ in items]
        self._seen_appended = [c.appended_total for _, c in items]
        self._seen_evicted = [c.evicted_total for _, c in items]
        self._valid = True


class CollectivesWindowCache(_SlotWindowCacheBase):
    """Incremental collectives window: per-step count/bytes/duration/
    exposed/allreduce-fp32 slots are cached and delta-maintained; the
    per-op / per-rank / group aggregates are re-folded each tick over
    the live row suffixes with the exact full-build fold (their fold
    start moves with the window head, so a cached partial sum cannot be
    reused bit-exactly — the refold over ring views is still far
    cheaper than the full gather + per-slot scatter)."""

    def __init__(self) -> None:
        super().__init__()
        self._count: Optional[np.ndarray] = None
        self._bytes: Optional[np.ndarray] = None
        self._ar: Optional[np.ndarray] = None
        self._dur: Optional[np.ndarray] = None
        self._exp: Optional[np.ndarray] = None

    def _slot_arrays(self):
        return (self._count, self._bytes, self._ar, self._dur, self._exp)

    def _full_build(self, rank_cols, max_steps):
        return build_columnar_collectives_window(rank_cols, max_steps)

    def _tick(self, rank_cols, max_steps):
        if not self._valid:
            raise _CacheInvalid(INVALIDATE_COLD)
        if int(max_steps) != self._max_steps:
            raise _CacheInvalid(INVALIDATE_SIZE)
        items = self._sorted_items(rank_cols)
        if not items:
            raise _CacheInvalid(INVALIDATE_RANKS)
        touched, new_steps = self._scan_delta(items, self._max_steps)
        touched = self._append_and_touch(touched, new_steps)
        lo_step = int(self._steps[self._lo])
        buf = self._steps[: self._hi]
        for s in sorted(touched):
            if s < lo_step:
                continue
            self._recompute_slot(int(np.searchsorted(buf, s)), s, items)
        return self._emit(items)

    def _recompute_slot(self, j: int, s: int, items) -> None:
        # from-scratch fold over ALL live rows carrying step s, in
        # sorted-rank row order — np.add.at element order, so the slot
        # is bit-identical to the full build's scatter
        ar_code = _COLL_OP_INDEX["all_reduce"]
        cnt = 0
        byt = 0
        ar = 0
        d_acc = 0.0
        e_acc = 0.0
        for _, c in items:
            sv = c.steps_view()
            a = int(np.searchsorted(sv, s, side="left"))
            b = int(np.searchsorted(sv, s, side="right"))
            if a == b:
                continue
            ints = c.ints_view()
            flts = c.floats_view()
            ops = c.ops_view()
            dts = c.dtypes_view()
            fp32 = c._dtype_index.get("float32", -1)
            for t in range(a, b):
                cnt += int(ints[t, CC_COUNT])
                byt += int(ints[t, CC_BYTES])
                d_acc += float(flts[t, 0])
                e_acc += float(flts[t, 1])
                if int(ops[t]) == ar_code and int(dts[t]) == fp32:
                    ar += int(ints[t, CC_BYTES])
        self._count[j] = cnt
        self._bytes[j] = byt
        self._ar[j] = ar
        self._dur[j] = d_acc
        self._exp[j] = e_acc

    def _emit(self, items) -> CollectivesWindow:
        lo, hi = self._lo, self._hi
        S = hi - lo
        common = self._steps[lo:hi]
        lo_step = int(common[0])
        n_ops = len(COLLECTIVE_OPS)
        op_count = np.zeros(n_ops, dtype=np.int64)
        op_bytes = np.zeros(n_ops, dtype=np.int64)
        op_dur = np.zeros(n_ops, dtype=np.float64)
        op_exp = np.zeros(n_ops, dtype=np.float64)
        op_seen = np.zeros(n_ops, dtype=np.bool_)
        per_rank: Dict[int, Dict[str, float]] = {}
        group = 1
        for rank, c in items:
            sv = c.steps_view()
            k = int(np.searchsorted(sv, lo_step, side="left"))
            ints = c.ints_view()[k:]
            floats = c.floats_view()[k:]
            ops = c.ops_view()[k:].astype(np.int64)
            np.add.at(op_count, ops, ints[:, CC_COUNT])
            np.add.at(op_bytes, ops, ints[:, CC_BYTES])
            np.add.at(op_dur, ops, floats[:, 0])
            np.add.at(op_exp, ops, floats[:, 1])
            op_seen[ops] = True
            if ints.shape[0]:
                group = max(group, int(ints[:, CC_GROUP].max()))
                r_dur = float(np.cumsum(floats[:, 0])[-1])
                r_exp = float(np.cumsum(floats[:, 1])[-1])
                r_bytes = int(np.cumsum(ints[:, CC_BYTES])[-1])
            else:
                r_dur = r_exp = 0.0
                r_bytes = 0
            per_rank[rank] = {
                "duration_ms": r_dur,
                "exposed_ms": r_exp,
                "bytes": r_bytes,
                "overlap_efficiency": _overlap_efficiency(r_dur, r_exp),
            }

        count = self._count[lo:hi]
        nbytes = self._bytes[lo:hi]
        dur = self._dur[lo:hi]
        exp = self._exp[lo:hi]
        dur_l = dur.tolist()
        exp_l = exp.tolist()
        total_dur = float(np.cumsum(dur)[-1]) if S else 0.0
        total_exp = float(np.cumsum(exp)[-1]) if S else 0.0
        per_op: Dict[str, Dict[str, float]] = {}
        for oi, op in enumerate(COLLECTIVE_OPS):
            if not op_seen[oi]:
                continue
            per_op[op] = {
                "count": int(op_count[oi]),
                "bytes": int(op_bytes[oi]),
                "duration_ms": float(op_dur[oi]),
                "exposed_ms": float(op_exp[oi]),
            }
        return CollectivesWindow(
            steps=common.tolist(),
            n_steps=S,
            ranks=list(self._ranks),
            group_size=group,
            per_step={
                "count": count.tolist(),
                "bytes": nbytes.tolist(),
                "duration_ms": dur_l,
                "exposed_ms": exp_l,
                "overlap_efficiency": [
                    _overlap_efficiency(dur_l[i], exp_l[i]) for i in range(S)
                ],
                "allreduce_fp32_bytes": self._ar[lo:hi].tolist(),
            },
            per_op=per_op,
            per_rank=per_rank,
            totals={
                "count": int(np.cumsum(count)[-1]) if S else 0,
                "bytes": int(np.cumsum(nbytes)[-1]) if S else 0,
                "duration_ms": total_dur,
                "exposed_ms": total_exp,
                "overlap_efficiency": _overlap_efficiency(total_dur, total_exp),
            },
        )

    def _prime(self, window, rank_cols, max_steps) -> None:
        if window is None:
            self._valid = False
            return
        self._max_steps = int(max_steps)
        self._cap = 2 * self._max_steps
        S = window.n_steps
        self._steps = np.empty(self._cap, dtype=np.int64)
        self._count = np.empty(self._cap, dtype=np.int64)
        self._bytes = np.empty(self._cap, dtype=np.int64)
        self._ar = np.empty(self._cap, dtype=np.int64)
        self._dur = np.empty(self._cap, dtype=np.float64)
        self._exp = np.empty(self._cap, dtype=np.float64)
        self._steps[:S] = np.asarray(window.steps, dtype=np.int64)
        ps = window.per_step
        self._count[:S] = np.asarray(ps["count"], dtype=np.int64)
        self._bytes[:S] = np.asarray(ps["bytes"], dtype=np.int64)
        self._ar[:S] = np.asarray(ps["allreduce_fp32_bytes"], dtype=np.int64)
        self._dur[:S] = np.asarray(ps["duration_ms"], dtype=np.float64)
        self._exp[:S] = np.asarray(ps["exposed_ms"], dtype=np.float64)
        self._prime_common(window, rank_cols)

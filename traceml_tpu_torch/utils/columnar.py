"""Columnar series of the diagnosis packs.

Counterpart of ``traceml_tpu/utils/columnar.py``, holding only
:class:`MemorySeries` (built from row dicts, as the JAX package's scalar
reference arm does); the ring buffers and the vectorized window engine
come later.
"""

from __future__ import annotations

from typing import Any, List, Mapping, Optional

import numpy as np

_NAN = float("nan")


class MemorySeries:
    """One (rank, device) step-memory series, sorted by step — the
    single representation every step-memory rule consumes.  Values are
    float64 with NaN for NULL."""

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

    def __len__(self) -> int:
        return int(self.steps.shape[0])

    @staticmethod
    def _opt(v: float) -> Optional[float]:
        return None if v != v else v

    def last_values(self):
        """(step_peak, current, limit) of the final (sorted) row as
        Optional floats — what the scalar rules read via rows[-1]."""
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
        """``float(current_bytes or 0)`` per row — the creep series."""
        cur = self.current
        return np.where(np.isnan(cur), 0.0, cur).tolist()

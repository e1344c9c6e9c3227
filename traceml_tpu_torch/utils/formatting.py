"""Human-readable units.

Counterpart of ``traceml_tpu/utils/formatting.py`` (copied).
"""

from __future__ import annotations

from typing import Optional

_BYTE_UNITS = ["B", "KiB", "MiB", "GiB", "TiB", "PiB"]


def fmt_bytes(n: Optional[float]) -> str:
    if n is None:
        return "n/a"
    n = float(n)
    sign = "-" if n < 0 else ""
    n = abs(n)
    for unit in _BYTE_UNITS:
        if n < 1024.0 or unit == _BYTE_UNITS[-1]:
            if unit == "B":
                return f"{sign}{n:.0f} {unit}"
            return f"{sign}{n:.2f} {unit}"
        n /= 1024.0
    return f"{sign}{n:.2f} PiB"


def fmt_ms(ms: Optional[float]) -> str:
    if ms is None:
        return "n/a"
    if ms < 1.0:
        return f"{ms * 1000:.0f} µs"
    if ms < 1000.0:
        return f"{ms:.1f} ms"
    s = ms / 1000.0
    if s < 60:
        return f"{s:.2f} s"
    m, s = divmod(s, 60.0)
    return f"{int(m)}m{s:04.1f}s"


def fmt_pct(frac: Optional[float], *, digits: int = 1) -> str:
    if frac is None:
        return "n/a"
    return f"{frac * 100:.{digits}f}%"


def fmt_count(n: Optional[float]) -> str:
    if n is None:
        return "n/a"
    n = float(n)
    for thresh, suffix in ((1e9, "B"), (1e6, "M"), (1e3, "k")):
        if abs(n) >= thresh:
            return f"{n / thresh:.1f}{suffix}"
    return f"{n:.0f}"

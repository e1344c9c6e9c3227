"""Achieved FLOP/s and MFU: the ``efficiency`` block of the final summary.

Counterpart of ``traceml_tpu/analytics/efficiency.py``, the same formula
and the same keys.
"""

from __future__ import annotations

import statistics
from typing import Any, Dict, Mapping, Optional


def _rank_key(stats: Mapping[int, Mapping[str, Any]], rank: Any):
    """Stats key for a per-step-ms rank id (int keys in stats, str or
    int in step-ms maps), or None when that rank never declared."""
    try:
        r = int(rank)
    except (TypeError, ValueError):
        return None
    return r if r in stats else None


def build_efficiency(
    stats: Optional[Mapping[int, Mapping[str, Any]]],
    per_rank_step_ms: Mapping[Any, Optional[float]],
) -> Optional[Dict[str, Any]]:
    """The ``efficiency`` block, or None.

    ``stats`` is ``loaders.load_model_stats``'s output: per rank, the
    median ``flops_per_step`` over its recent declarations and the newest
    source, device kind, peak and device count.  ``per_rank_step_ms`` maps
    rank → its representative step time (the steady-state median when
    there is one).  Each rank's achieved FLOP/s uses its own declaration,
    else the first declaring rank's; its MFU denominator is the device's
    peak × the rank's device count.
    """
    if not stats:
        return None
    ms0 = next(iter(stats.values()))
    if not ms0.get("flops_per_step"):
        # the fallback declaration is unusable; require per-rank ones
        ms0 = next(
            (
                v for v in stats.values()
                if v.get("flops_per_step") or v.get("tokens_per_step")
            ),
            None,
        )
        if ms0 is None:
            return None

    achieved: Dict[str, float] = {}
    mfu: Dict[str, float] = {}
    tokens_ps: Dict[str, float] = {}
    for rank, step_ms in per_rank_step_ms.items():
        if not step_ms:
            continue
        key = _rank_key(stats, rank)
        decl = stats[key] if key is not None else ms0
        tokens = decl.get("tokens_per_step") or ms0.get("tokens_per_step")
        if tokens:
            tokens_ps[str(rank)] = tokens / (step_ms / 1000.0)
        flops = decl.get("flops_per_step") or ms0.get("flops_per_step")
        if not flops:
            continue
        tflops = flops / (step_ms / 1000.0) / 1e12
        achieved[str(rank)] = tflops
        peak = decl.get("peak_flops")
        if peak:
            n_dev = int(decl.get("device_count") or 1)
            mfu[str(rank)] = tflops * 1e12 / (peak * max(n_dev, 1))
    if not achieved and not tokens_ps:
        return None
    # the numerator and its metadata come from one declaration, so a
    # FLOPs value is never paired with another rank's device or peak
    flops_decl = next(
        (v for v in stats.values() if v.get("flops_per_step")), ms0
    )
    tokens0 = next(
        (v["tokens_per_step"] for v in stats.values()
         if v.get("tokens_per_step")),
        None,
    )
    peak0 = flops_decl.get("peak_flops")
    return {
        "flops_per_step": flops_decl.get("flops_per_step"),
        "flops_source": flops_decl.get("flops_source"),
        "device_kind": flops_decl.get("device_kind"),
        "device_count": flops_decl.get("device_count"),
        "peak_tflops": (peak0 / 1e12) if peak0 else None,
        "achieved_tflops_by_rank": {r: round(v, 3) for r, v in achieved.items()},
        "achieved_tflops_median": (
            round(statistics.median(achieved.values()), 3)
            if achieved else None
        ),
        "mfu_median": statistics.median(mfu.values()) if mfu else None,
        "tokens_per_step": tokens0,
        "tokens_per_sec_median": (
            round(statistics.median(tokens_ps.values()), 1)
            if tokens_ps else None
        ),
    }

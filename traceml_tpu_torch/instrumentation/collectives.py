"""Collective-communication capture.

Counterpart of ``traceml_tpu/instrumentation/collectives.py``.  Two
sources feed one bounded queue of per-collective records:

1. **Profiler trace events**, when a capture backend registered one
   (:func:`register_trace_source`; none is required):
   :func:`extract_collectives_from_trace_events` maps trace rows
   (``all-reduce``, ``ncclDevKernel_AllReduce_*``, ``nccl:all_reduce``,
   ...) to canonical records, with the *exposed* part of each collective
   (the span no concurrent compute covered) when the backend measured it.
2. **The pure-Python recorders**, always there:
   :func:`instrument_collective` wraps a host-dispatched collective
   callable (a gradient sync, a manual ring hop), and
   :func:`patch_dist_collectives` wraps the eager ``torch.distributed``
   entry points.  Both time the host window of the call, take bytes and
   dtype from the output tensors, and record the call as fully exposed
   unless the caller declares overlap: a host-blocking dispatch is
   exposed comm.  NCCL returns once the work is enqueued, so a healthy
   NCCL call reads almost no host time; the ``collective`` *phase*
   around it (``sdk/wrappers.py`` ``wrap_collective``) is device-timed.

Every record is a flat uniform dict::

    {"step", "ts", "op", "dtype", "bytes", "group_size",
     "duration_ms", "exposed_ms"}

The dtype is named as the JAX package names it (``"float32"``, not
``"torch.float32"``): the window counts fp32 all-reduce bytes by that
name.  ``TRACEML_COLLECTIVES=0`` turns every entry point into a no-op
(and leaves the sampler out, ``runtime/sampler_registry.py``).
"""

from __future__ import annotations

import functools
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from traceml_tpu_torch.runtime.settings import collectives_enabled
from traceml_tpu_torch.utils.error_log import get_error_log
from traceml_tpu_torch.utils.timing import BoundedDropQueue

# --- canonical op vocabulary ------------------------------------------------
OP_ALL_REDUCE = "all_reduce"
OP_ALL_GATHER = "all_gather"
OP_REDUCE_SCATTER = "reduce_scatter"
OP_ALL_TO_ALL = "all_to_all"
OP_P2P = "p2p"
OP_OTHER = "other"

OP_KINDS = (
    OP_ALL_REDUCE,
    OP_ALL_GATHER,
    OP_REDUCE_SCATTER,
    OP_ALL_TO_ALL,
    OP_P2P,
    OP_OTHER,
)

# XLA HLO / trace-event spellings → canonical kind (the JAX table).
# Longest-prefix style matching happens in normalize_op; these are exact
# (lowered) aliases.
_OP_ALIASES: Dict[str, str] = {
    "all_reduce": OP_ALL_REDUCE,
    "all-reduce": OP_ALL_REDUCE,
    "allreduce": OP_ALL_REDUCE,
    "psum": OP_ALL_REDUCE,
    "pmean": OP_ALL_REDUCE,
    "pmax": OP_ALL_REDUCE,
    "pmin": OP_ALL_REDUCE,
    "cross-replica-sum": OP_ALL_REDUCE,
    "all_gather": OP_ALL_GATHER,
    "all-gather": OP_ALL_GATHER,
    "allgather": OP_ALL_GATHER,
    "reduce_scatter": OP_REDUCE_SCATTER,
    "reduce-scatter": OP_REDUCE_SCATTER,
    "reducescatter": OP_REDUCE_SCATTER,
    "psum_scatter": OP_REDUCE_SCATTER,
    "all_to_all": OP_ALL_TO_ALL,
    "all-to-all": OP_ALL_TO_ALL,
    "alltoall": OP_ALL_TO_ALL,
    "collective-permute": OP_P2P,
    "collective_permute": OP_P2P,
    "ppermute": OP_P2P,
    "send": OP_P2P,
    "recv": OP_P2P,
}

# NCCL's spellings: the profiler's record-function names
# ("nccl:all_reduce", "nccl:_all_gather_base",
# "nccl:reduce_scatter_tensor_coalesced") and the device kernels'
# ("ncclDevKernel_AllReduce_Sum_f32_RING_LL", "ncclKernel_AllGather_...").
# The op is read from the name's head with its underscores dropped.
_NCCL_PREFIXES = ("nccl:", "nccldevkernel_", "ncclkernel_")
_NCCL_WORDS = (
    ("allreduce", OP_ALL_REDUCE),
    ("allgather", OP_ALL_GATHER),
    ("reducescatter", OP_REDUCE_SCATTER),
    ("alltoall", OP_ALL_TO_ALL),
    ("sendrecv", OP_P2P),
    ("send", OP_P2P),
    ("recv", OP_P2P),
)

_QUEUE_MAX = 8192

# Global queue shared by the recorders above and CollectivesSampler.
GLOBAL_COLLECTIVES_QUEUE = BoundedDropQueue("collectives", maxsize=_QUEUE_MAX)


def _nccl_op(s: str) -> Optional[str]:
    """The kind of an NCCL spelling (lowered), or None when ``s`` is not
    one."""
    for prefix in _NCCL_PREFIXES:
        if s.startswith(prefix):
            word = s[len(prefix):].replace("_", "")
            for head, kind in _NCCL_WORDS:
                if word.startswith(head):
                    return kind
            return OP_OTHER
    return None


def normalize_op(name: Any) -> str:
    """Canonicalize an op spelling (HLO name, ``torch.distributed`` name,
    NCCL name, user string)."""
    s = str(name or "").strip().lower()
    if s in _OP_ALIASES:
        return _OP_ALIASES[s]
    if s in OP_KINDS:
        return s
    nccl = _nccl_op(s)
    if nccl is not None:
        return nccl
    # trace events carry suffixed HLO names ("all-reduce.17", fusion tags)
    for alias, kind in _OP_ALIASES.items():
        if s.startswith(alias):
            return kind
    return OP_OTHER


def _dtype_name(dtype: Any) -> str:
    """``torch.float32`` → ``"float32"``, the JAX package's spelling."""
    s = str(dtype or "")
    return s[len("torch."):] if s.startswith("torch.") else s


def bytes_of(tree: Any) -> Tuple[int, str]:
    """Best-effort (payload bytes, dtype) of a collective's output: every
    tensor leaf of the output (lists, tuples, dicts walked by
    ``torch.utils._pytree``).  The dtype is the largest leaf's: for a
    fused sync that is the gradient payload, which
    ALLREDUCE_QUANTIZABLE reads."""
    leaves: Sequence[Any]
    try:
        from torch.utils import _pytree

        leaves = _pytree.tree_leaves(tree)
    except Exception:
        leaves = [tree]
    total = 0
    dtype = ""
    best = -1
    for leaf in leaves:
        try:
            n = int(leaf.nelement()) * int(leaf.element_size())
        except Exception:
            continue
        total += n
        if n > best:
            best = n
            dtype = _dtype_name(getattr(leaf, "dtype", ""))
    return total, dtype


def _current_step() -> int:
    try:
        from traceml_tpu_torch.sdk.state import get_state

        return int(get_state().current_step)
    except Exception:
        return 0


def record_collective(
    op: str,
    *,
    nbytes: int = 0,
    dtype: str = "",
    group_size: int = 1,
    duration_ms: float = 0.0,
    exposed_ms: Optional[float] = None,
    overlapped: bool = False,
    step: Optional[int] = None,
    ts: Optional[float] = None,
) -> bool:
    """Record one collective occurrence.  Never raises; returns whether
    the record was enqueued (False: disabled or queue full).

    ``exposed_ms`` is the part of ``duration_ms`` NOT hidden behind
    compute.  When omitted it follows the coarse ``overlapped`` flag:
    fully exposed (a host-blocking dispatch) or fully hidden.  Profiler
    sources pass the measured value.
    """
    if not collectives_enabled():
        return False
    try:
        dur = max(0.0, float(duration_ms))
        if exposed_ms is None:
            exp = 0.0 if overlapped else dur
        else:
            exp = min(dur, max(0.0, float(exposed_ms)))
        rec = {
            "step": int(step) if step is not None else _current_step(),
            "ts": float(ts) if ts is not None else time.time(),
            "op": normalize_op(op),
            "dtype": str(dtype or ""),
            "bytes": max(0, int(nbytes)),
            "group_size": max(1, int(group_size)),
            "duration_ms": dur,
            "exposed_ms": exp,
        }
    except Exception as exc:
        get_error_log().warning("record_collective failed", exc)
        return False
    return GLOBAL_COLLECTIVES_QUEUE.put(rec)


# --- profiler trace-event source (when a capture backend registered) -------

_trace_sources: List[Callable[[], List[Dict[str, Any]]]] = []


def register_trace_source(fn: Callable[[], List[Dict[str, Any]]]) -> None:
    """Register a callable returning raw trace-event dicts to harvest.
    The sampler drains it each tick; a raising source disables nothing
    (the recorders keep the domain alive)."""
    _trace_sources.append(fn)


def clear_trace_sources() -> None:
    _trace_sources.clear()


def drain_trace_sources() -> List[Dict[str, Any]]:
    events: List[Dict[str, Any]] = []
    for src in list(_trace_sources):
        try:
            events.extend(src() or [])
        except Exception as exc:
            get_error_log().warning("collective trace source failed", exc)
    return events


def _is_collective_name(name: Any) -> bool:
    s = str(name or "").lower()
    return _nccl_op(s) is not None or any(s.startswith(a) for a in _OP_ALIASES)


def extract_collectives_from_trace_events(
    events: Sequence[Dict[str, Any]],
    default_step: Optional[int] = None,
) -> List[Dict[str, Any]]:
    """Map raw trace events to canonical collective records.

    Expects chrome-trace rows: ``name``, ``dur`` (µs), ``ts`` (µs),
    optional ``args`` with ``bytes_accessed``/``dtype``/``group_size``/
    ``step``.  Exposure: a row may carry ``args.exposed_us`` (computed by
    the capture backend from concurrent compute spans); otherwise the
    event counts as fully exposed, the conservative reading.  Rows that
    name no collective are skipped.  A pure function.
    """
    out: List[Dict[str, Any]] = []
    for ev in events:
        try:
            op = normalize_op(ev.get("name"))
            if op == OP_OTHER and not _is_collective_name(ev.get("name")):
                continue
            args = ev.get("args") or {}
            dur_ms = float(ev.get("dur", 0.0)) / 1000.0
            exposed_us = args.get("exposed_us")
            step = args.get("step", default_step)
            rec = {
                "step": int(step) if step is not None else _current_step(),
                "ts": float(ev.get("ts", 0.0)) / 1e6 or time.time(),
                "op": op,
                "dtype": _dtype_name(args.get("dtype", "") or ""),
                "bytes": max(0, int(args.get("bytes_accessed", 0) or 0)),
                "group_size": max(1, int(args.get("group_size", 1) or 1)),
                "duration_ms": max(0.0, dur_ms),
                "exposed_ms": (
                    min(max(0.0, float(exposed_us) / 1000.0), max(0.0, dur_ms))
                    if exposed_us is not None
                    else max(0.0, dur_ms)
                ),
            }
            out.append(rec)
        except Exception:
            continue  # one malformed row never poisons the batch
    return out


# --- pure-Python recorders --------------------------------------------------


def _default_group_size() -> int:
    """The default process group's world size, or 1 without one."""
    try:
        import torch.distributed as dist

        if dist.is_available() and dist.is_initialized():
            return int(dist.get_world_size())
    except Exception:
        pass
    return 1


def instrument_collective(
    fn: Callable,
    op: str = OP_ALL_REDUCE,
    state: Any = None,
    group_size: Optional[int] = None,
    overlapped: bool = False,
) -> Callable:
    """Capture a host-dispatched collective callable.

    The call is timed as the first-class ``collective`` phase
    (``wrap_collective``: device-timed, feeds COLLECTIVE_STRAGGLER), and
    each call also lands in the collectives domain with bytes and dtype
    from its outputs: return the tensors the collective moved.  The host
    window is recorded fully exposed unless the caller declares
    ``overlapped=True`` (an async dispatch known to run under compute).
    """
    from traceml_tpu_torch.sdk.wrappers import wrap_collective

    timed = wrap_collective(fn, state)
    kind = normalize_op(op)

    @functools.wraps(fn)
    def wrapped(*args: Any, **kwargs: Any):
        if not collectives_enabled():
            return timed(*args, **kwargs)
        t0 = time.perf_counter()
        out = timed(*args, **kwargs)
        dur_ms = (time.perf_counter() - t0) * 1000.0
        try:
            nbytes, dtype = bytes_of(out)
            record_collective(
                kind,
                nbytes=nbytes,
                dtype=dtype,
                group_size=group_size if group_size is not None else _default_group_size(),
                duration_ms=dur_ms,
                overlapped=overlapped,
            )
        except Exception as exc:  # never raise into user code
            get_error_log().warning("instrument_collective record failed", exc)
        return out

    wrapped._traceml_collective_instrumented = True  # type: ignore[attr-defined]
    return wrapped


# torch.distributed entry point → canonical op kind for the eager-call
# patches (the map of the JAX package's _LAX_COLLECTIVES)
_DIST_COLLECTIVES = {
    "all_reduce": OP_ALL_REDUCE,
    "all_gather": OP_ALL_GATHER,
    "all_gather_into_tensor": OP_ALL_GATHER,
    "reduce_scatter_tensor": OP_REDUCE_SCATTER,
    "all_to_all_single": OP_ALL_TO_ALL,
    "send": OP_P2P,
    "recv": OP_P2P,
    "batch_isend_irecv": OP_P2P,
}

_dist_patched = False


def _is_compiling() -> bool:
    """True inside a ``torch.compile`` trace, where wall time measures
    tracing, not communication, and one trace serves many steps: such
    calls pass through unrecorded."""
    try:
        import torch

        return bool(torch.compiler.is_compiling())
    except Exception:
        return False


def _payload(name: str, args: Any, kwargs: Any, out: Any) -> Any:
    """The tensors a patched call moved: the in-place argument for the
    calls that write their first argument (``all_reduce``, ``send``,
    ``recv``), the output list or tensor otherwise; for
    ``batch_isend_irecv`` the ops' tensors."""
    if name == "batch_isend_irecv":
        ops = args[0] if args else kwargs.get("p2p_op_list") or []
        return [getattr(p, "tensor", None) for p in ops]
    if name in ("all_reduce", "send", "recv"):
        return args[0] if args else kwargs.get("tensor")
    if name in ("all_gather", "all_gather_into_tensor", "reduce_scatter_tensor", "all_to_all_single"):
        if args:
            return args[0]
        return kwargs.get("tensor_list") or kwargs.get("output_tensor_list") or kwargs.get("output")
    return out


def patch_dist_collectives() -> bool:
    """Wrap the eager ``torch.distributed`` collective entry points, so
    call sites need no change.  Calls made while ``torch.compile``
    traces pass through unrecorded; only eager host dispatches are timed.
    Idempotent; returns whether the patch is installed."""
    global _dist_patched
    if _dist_patched:
        return True
    if not collectives_enabled():
        return False
    try:
        import torch.distributed as dist
    except Exception:
        return False
    for name, kind in _DIST_COLLECTIVES.items():
        orig = getattr(dist, name, None)
        if orig is None or getattr(orig, "_traceml_collective_instrumented", False):
            continue

        def make(orig: Callable, name: str, kind: str) -> Callable:
            @functools.wraps(orig)
            def wrapped(*args: Any, **kwargs: Any):
                if not collectives_enabled() or _is_compiling():
                    return orig(*args, **kwargs)
                t0 = time.perf_counter()
                out = orig(*args, **kwargs)
                dur_ms = (time.perf_counter() - t0) * 1000.0
                try:
                    nbytes, dtype = bytes_of(_payload(name, args, kwargs, out))
                    record_collective(
                        kind,
                        nbytes=nbytes,
                        dtype=dtype,
                        group_size=_default_group_size(),
                        duration_ms=dur_ms,
                    )
                except Exception:
                    pass
                return out

            wrapped._traceml_collective_instrumented = True  # type: ignore[attr-defined]
            return wrapped

        setattr(dist, name, make(orig, name, kind))
    _dist_patched = True
    return True

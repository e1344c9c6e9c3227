"""Process-wide compile attribution through dynamo's compile callbacks.

Counterpart of ``traceml_tpu/instrumentation/compile_tracker.py``, whose
``jax.monitoring`` listener turns each XLA compile into a
``compile_time`` event.  Under ``torch.compile`` the compiles are
dynamo's: ``torch._dynamo.callback`` runs its start callbacks when a
compile begins (a frame traced by dynamo, a backward compiled lazily by
AOTAutograd at its first run) and its end callbacks when it ends, each
with a ``CallbackArgs`` naming the trigger and the compile id ("0/1":
frame 0, its second compile).  Nested compiles fire once, for the
outermost.  The tracker keeps each compile's host start by id and, at
its end, adds one ``compile_time`` event to the step that is open, its
span rebuilt from the end time, with ``meta`` = the compile's ms, its id
and its trigger, and bumps ``TraceState.compile_events_seen``.  A compile
under ``MIN_COMPILE_MS`` adds nothing.

Dynamo fires the callbacks on the compiling thread, synchronously, so
the event lands in that thread's open step.  Importing ``torch._dynamo``
costs seconds, so the tracker registers at once only where dynamo is
imported already, and otherwise right after its first import
(``post_import.arm``; ``torch.compile`` imports it at its first call).
``torch._dynamo.reset()`` clears every callback: ``install_compile_tracker``
checks for its own callbacks, not a flag, and re-registers them.
Fail-open: a callback's error is logged, never raised into torch.
"""

from __future__ import annotations

import sys
import threading
from typing import Any, Dict, Optional

from traceml_tpu_torch.instrumentation.post_import import PostImportHook, arm
from traceml_tpu_torch.sdk.state import get_state
from traceml_tpu_torch.utils.error_log import get_error_log
from traceml_tpu_torch.utils.timing import COMPILE_TIME, TimeEvent, _now

# compiles shorter than this (a cache-hit re-entry, a trivial frame)
# cost nothing and would flood the event stream
MIN_COMPILE_MS = 2.0

DYNAMO = "torch._dynamo"

_lock = threading.Lock()
_starts: Dict[str, float] = {}  # compile key → host start
_hook: Optional[PostImportHook] = None


def _on_compile_start(args: Any) -> None:
    try:
        _starts[str(args.compile_id)] = _now()
    except Exception as exc:  # never raise into dynamo
        get_error_log().warning("compile start callback failed", exc)


def _on_compile_end(args: Any) -> None:
    try:
        key = str(args.compile_id)
        start = _starts.pop(key, None)
        end = _now()
        if start is None or (end - start) * 1000.0 < MIN_COMPILE_MS:
            return
        st = get_state()
        ev = TimeEvent(COMPILE_TIME, st.current_step)
        ev.cpu_start, ev.cpu_end = start, end
        ev.meta = {
            "compile_ms": (end - start) * 1000.0,
            "compile_id": key,
            "trigger": args.callback_trigger.name.lower(),
        }
        st.buffer.add(ev)
        st.compile_events_seen += 1
    except Exception as exc:
        try:
            get_error_log().warning("compile end callback failed", exc)
        except Exception:
            pass


def _handler():
    from torch._dynamo.callback import callback_handler

    return callback_handler


def compile_tracker_installed() -> bool:
    if DYNAMO not in sys.modules:
        return False
    try:
        return _on_compile_end in _handler().end_callbacks
    except Exception:
        return False


def _register() -> bool:
    with _lock:
        try:
            handler = _handler()
            if _on_compile_start not in handler.start_callbacks:
                handler.register_start_callback(_on_compile_start)
            if _on_compile_end not in handler.end_callbacks:
                handler.register_end_callback(_on_compile_end)
            return True
        except Exception as exc:
            get_error_log().warning("compile tracker install failed", exc)
            return False


def install_compile_tracker() -> str:
    """Register both callbacks once, now when dynamo is imported, else
    after its first import: "patched" | "deferred" | "noop" (this torch
    has no compile callbacks).  A second call, or one after
    ``torch._dynamo.reset()`` left them in place, adds nothing."""
    global _hook
    outcome, _hook = arm(DYNAMO, _register, _hook, lambda: True)
    return outcome


def uninstall_compile_tracker() -> None:
    """Remove both callbacks, a pending hook and the open compiles
    (tests, clean embedding)."""
    global _hook
    if _hook is not None:
        _hook.remove()
        _hook = None
    with _lock:
        _starts.clear()
        if DYNAMO not in sys.modules:
            return  # nothing registered, and importing dynamo costs seconds
        try:
            handler = _handler()
            for callbacks, cb in ((handler.start_callbacks, _on_compile_start),
                                  (handler.end_callbacks, _on_compile_end)):
                while cb in callbacks:
                    callbacks.remove(cb)
        except Exception:
            pass

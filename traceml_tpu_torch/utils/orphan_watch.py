"""Parent-death watchdog for helper processes.

Counterpart of ``traceml_tpu/utils/orphan_watch.py`` (without its
opt-out: the port has no daemonized helper yet).  The aggregator is a
child of the launcher and stops on SIGTERM/SIGINT, but a parent that
dies WITHOUT signalling (a SIGKILLed launcher or test runner) would leave
it orphaned forever.  The watchdog records the parent pid when armed and
polls ``os.getppid()``; once the process is reparented the callback
fires, so the helper shuts down cleanly.
"""

from __future__ import annotations

import os
import threading
from typing import Callable, Optional

_POLL_S = 2.0


def arm_parent_death_watch(on_parent_death: Callable[[], None]) -> Optional[threading.Thread]:
    """Start a daemon thread that fires ``on_parent_death`` once the
    original parent exits.  Returns the thread, or None when the process
    is already orphaned at arm time."""
    parent = os.getppid()
    if parent <= 1:
        return None

    def _watch() -> None:
        while os.getppid() == parent:
            threading.Event().wait(_POLL_S)
        on_parent_death()

    t = threading.Thread(target=_watch, name="traceml-ppid-watch", daemon=True)
    t.start()
    return t

"""Patch a module now if it is imported, else right after its first import.

Counterpart of the hook in ``traceml_tpu/instrumentation/orbax_patch.py``
(``_PostImportHook``, ``arm_post_import_patch``).  The launcher starts
tracing BEFORE the user script imports its stack, so a patch gated on
"module already loaded" would be inert in the main deployment; a
meta-path finder applies it right after the import instead, and never
imports the module on the user's behalf.  Users: the checkpoint patch
(``torch.distributed.checkpoint``) and the compile tracker
(``torch._dynamo``, whose import costs seconds).
"""

from __future__ import annotations

import importlib.util
import sys
from typing import Any, Callable, Optional, Tuple

from traceml_tpu_torch.utils.error_log import get_error_log


class PostImportHook:
    """Meta-path finder that runs ``callback`` right after ``name`` is
    imported, then retires itself."""

    def __init__(self, name: str, callback: Callable[[], Any]) -> None:
        self._name = name
        self._callback = callback
        self._busy = False

    def find_spec(self, fullname, path=None, target=None):  # noqa: ANN001
        if fullname != self._name or self._busy:
            return None
        self._busy = True
        try:
            spec = importlib.util.find_spec(fullname)
        finally:
            self._busy = False
        if spec is None or spec.loader is None:
            return None
        hook = self
        orig_loader = spec.loader  # captured before it is replaced
        orig_exec = orig_loader.exec_module

        class _Loader:
            def create_module(self, s):  # noqa: ANN001
                return orig_loader.create_module(s)

            def exec_module(self, module):  # noqa: ANN001
                orig_exec(module)
                hook.remove()
                try:
                    hook._callback()
                except Exception as exc:
                    get_error_log().warning(f"post-import patch for {fullname} failed", exc)

            def __getattr__(self, attr):  # the rest of the loader protocol
                return getattr(orig_loader, attr)

        spec.loader = _Loader()
        return spec

    def remove(self) -> None:
        try:
            sys.meta_path.remove(self)
        except ValueError:
            pass


def arm(name: str, callback: Callable[[], Any], existing: Optional[PostImportHook],
        importable: Callable[[], bool]) -> Tuple[str, Optional[PostImportHook]]:
    """``name`` imported → ``callback()`` now ("patched", or "noop" when it
    returns falsy).  Else, when ``importable()`` (which must not import
    ``name``), a hook that runs it after the first import ("deferred");
    a process that can never import ``name`` carries no hook ("noop").
    Returns (outcome, hook)."""
    if name in sys.modules:
        return ("patched" if callback() else "noop"), existing
    try:
        if not importable():
            return "noop", existing
    except Exception:
        return "noop", existing
    if existing is None:
        existing = PostImportHook(name, callback)
        sys.meta_path.insert(0, existing)
    return "deferred", existing

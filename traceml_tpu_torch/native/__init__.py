"""Native fast paths of the transport tier, built from source at first use.

Counterpart of ``traceml_tpu/native/__init__.py``.  ``framing.c`` packs
and drains the stream transports' length-prefixed frames; ``ring.c`` does
the shared-memory ring's append, peek, drain and set-tail.  They are C on
the host, no device code.

The contract is the JAX package's: :func:`get_framing` and
:func:`get_ring` return the compiled module, or None when the build or
the load fails or ``TRACEML_NO_NATIVE`` is set, and the pure-Python twins
in ``transport/tcp_transport.py`` and ``transport/shm_ring.py`` run
instead.  They frame the same bytes, so a broken fast path never reaches
training code.

The build is the port's own: ``cc -O2 -shared -fPIC -I<Python include>``
writes ``build/traceml_tpu_torch/_<name>-<hash>.so`` (beside the CUDA
libraries of ``ops/_build.py``, nothing under the package).  The hash
covers the source, the flags and the interpreter's include directory and
ABI suffix, so an edited source, or another interpreter, builds anew.  A
build goes through a temporary file and ``os.replace``, so processes that
build at once never load a torn file.  The module is loaded under the
name its ``PyInit_`` function carries (``_framing``, ``_ring``).
:func:`build` is the strict form, which raises on a failed build.
"""

from __future__ import annotations

import hashlib
import importlib.util
import os
import subprocess
import sysconfig
import threading
from pathlib import Path
from types import ModuleType
from typing import Dict, Optional

from traceml_tpu_torch.ops._build import BUILD_DIR
from traceml_tpu_torch.utils.error_log import get_error_log

ENV_NO_NATIVE = "TRACEML_NO_NATIVE"
SOURCES = ("framing", "ring")
CFLAGS = ("-O2", "-shared", "-fPIC")
_SRC_DIR = Path(__file__).resolve().parent
_TRUTHY = ("1", "true", "yes", "on")

_lock = threading.Lock()
_cached: Dict[str, Optional[ModuleType]] = {}


class NativeBuildError(RuntimeError):
    pass


def disabled() -> bool:
    return os.environ.get(ENV_NO_NATIVE, "").strip().lower() in _TRUTHY


def _compiler() -> str:
    return os.environ.get("CC", "cc")


def library_path(name: str) -> Path:
    """Where the build of ``<name>.c`` lands for this interpreter."""
    h = hashlib.sha256((_SRC_DIR / f"{name}.c").read_bytes())
    h.update(" ".join(CFLAGS).encode())
    h.update(sysconfig.get_paths()["include"].encode())
    h.update(str(sysconfig.get_config_var("EXT_SUFFIX")).encode())
    return BUILD_DIR / f"_{name}-{h.hexdigest()[:16]}.so"


def build(name: str) -> Path:
    """Compile ``<name>.c`` unless its library exists; returns its path.
    Raises :class:`NativeBuildError` when the compiler fails."""
    out = library_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [_compiler(), *CFLAGS, f"-I{sysconfig.get_paths()['include']}",
           str(_SRC_DIR / f"{name}.c"), "-o", str(tmp)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
    except (OSError, subprocess.SubprocessError) as exc:
        raise NativeBuildError(f"{name}.c: {' '.join(cmd)}: {exc}") from exc
    if proc.returncode != 0 or not tmp.exists():
        tmp.unlink(missing_ok=True)
        raise NativeBuildError(f"{name}.c: {_compiler()} exited {proc.returncode}\n{proc.stderr[-2000:]}")
    os.replace(tmp, out)
    return out


def load(name: str) -> ModuleType:
    """Build (if needed) and import the extension of ``<name>.c``."""
    path = build(name)
    spec = importlib.util.spec_from_file_location(f"_{name}", path)
    if spec is None or spec.loader is None:
        raise NativeBuildError(f"{path}: not loadable as an extension module")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _get(name: str) -> Optional[ModuleType]:
    if name in _cached:
        return _cached[name]
    with _lock:
        if name not in _cached:
            mod = None
            if not disabled():
                try:
                    mod = load(name)
                except Exception as exc:  # no compiler, no headers, a bad load
                    get_error_log().warning(f"native {name} extension unavailable; using Python", exc)
            _cached[name] = mod
        return _cached[name]


def get_framing() -> Optional[ModuleType]:
    """The compiled framing extension, built on first use; None on failure."""
    return _get("framing")


def get_ring() -> Optional[ModuleType]:
    """The compiled SPSC ring extension, built on first use; None on failure."""
    return _get("ring")


"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` exports a plain C interface and becomes its own
shared library, ``build/traceml_tpu_torch/lib<name>-<hash>.so``, at first
use.  The hash covers the source, every ``csrc/*.cuh`` header and the
compiler flags, so an edited source is rebuilt and an unchanged one is
loaded as it is.  ``build()`` starts one ``nvcc`` per missing library,
all at once, and waits for them together.

There is no other path: a missing ``nvcc`` or a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Sequence

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "traceml_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}
#: ptxas report (registers, shared memory, spills) of each library built
#: by this process, keyed by kernel source name
build_log: Dict[str, str] = {}


class KernelBuildError(RuntimeError):
    pass


def _nvcc() -> str:
    for home in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH")):
        if home and (Path(home) / "bin" / "nvcc").is_file():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.is_file():
        return str(default)
    raise KernelBuildError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH); the CUDA "
        "kernels of traceml_tpu_torch are built from source at first use"
    )


def library_path(name: str) -> Path:
    src = CSRC_DIR / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: Sequence[str]) -> Dict[str, Path]:
    """Build every named kernel library that is not built yet, one
    ``nvcc`` per source, all started together.  Returns name → path."""
    paths = {name: library_path(name) for name in names}
    missing = [n for n, p in paths.items() if not p.exists()]
    if not missing:
        return paths
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs: List[tuple] = []
    for name in missing:
        out = paths[name]
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
        procs.append((name, tmp, out, proc))
    failures = []
    for name, tmp, out, proc in procs:
        text, _ = proc.communicate()
        build_log[name] = text
        if proc.returncode != 0:
            failures.append(f"{name}: nvcc exited {proc.returncode}\n{text}")
            continue
        os.replace(tmp, out)
    if failures:
        raise KernelBuildError("kernel build failed:\n" + "\n".join(failures))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel source ``name``, built if needed."""
    lib = _loaded.get(name)
    if lib is not None:
        return lib
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build([name])[name]))
            _loaded[name] = lib
    return lib


def kernel_sources() -> List[str]:
    return sorted(p.stem for p in CSRC_DIR.glob("*.cu"))

"""Runtime identity resolution.

Counterpart of ``traceml_tpu/runtime/identity.py``.  Precedence (the
first source that yields a rank wins):

1. the torchrun env: RANK / WORLD_SIZE / LOCAL_RANK / LOCAL_WORLD_SIZE /
   GROUP_RANK | NODE_RANK;
2. single-process defaults.

The JAX package's TPU sources (``TPU_WORKER_ID``, ``MEGASCALE_*`` and the
live JAX process index) have no CUDA counterpart and are left out: a
PyTorch job on GPUs is launched with the torchrun env.  ``platform`` and
``device_kind`` come from ``torch.cuda`` only once this process has
initialized CUDA itself (the counterpart of ``jax_is_initialized``): the
identity is resolved on the runtime's thread, which must never initialize
CUDA.
"""

from __future__ import annotations

import dataclasses
import os
import socket
from typing import Dict, Optional

from traceml_tpu_torch.telemetry.envelope import SenderIdentity


@dataclasses.dataclass(frozen=True)
class RuntimeIdentity:
    global_rank: int = 0
    local_rank: int = 0
    world_size: int = 1
    local_world_size: int = 1
    node_rank: int = 0
    hostname: str = dataclasses.field(default_factory=socket.gethostname)
    pid: int = dataclasses.field(default_factory=os.getpid)
    platform: str = "cpu"
    device_kind: str = "unknown"
    source: str = "defaults"

    def to_sender_identity(self, session_id: str) -> SenderIdentity:
        return SenderIdentity(
            session_id=session_id,
            global_rank=self.global_rank,
            local_rank=self.local_rank,
            world_size=self.world_size,
            local_world_size=self.local_world_size,
            node_rank=self.node_rank,
            hostname=self.hostname,
            pid=self.pid,
        )

    @property
    def is_global_primary(self) -> bool:
        return self.global_rank == 0

    @property
    def is_node_primary(self) -> bool:
        return self.local_rank == 0


def cuda_is_initialized() -> bool:
    """True only when this process has already initialized CUDA; never
    imports torch or initializes anything itself."""
    import sys

    torch = sys.modules.get("torch")
    cuda = getattr(torch, "cuda", None)
    try:
        return bool(cuda is not None and cuda.is_initialized())
    except Exception:
        return False


def _device_info() -> Dict[str, str]:
    """platform/device_kind from torch.cuda, only if CUDA is initialized."""
    if not cuda_is_initialized():
        return {}
    try:
        import torch

        return {"platform": "cuda", "device_kind": torch.cuda.get_device_name(torch.cuda.current_device())}
    except Exception:
        return {}


def resolve_runtime_identity(env: Optional[Dict[str, str]] = None) -> RuntimeIdentity:
    e = os.environ if env is None else env
    dev = _device_info()
    common = dict(
        hostname=socket.gethostname(),
        pid=os.getpid(),
        platform=dev.get("platform", "cpu"),
        device_kind=dev.get("device_kind", "unknown"),
    )
    if "RANK" in e and "WORLD_SIZE" in e:
        try:
            rank = int(e["RANK"])
            world = int(e["WORLD_SIZE"])
            return RuntimeIdentity(
                global_rank=rank,
                local_rank=int(e.get("LOCAL_RANK", rank)),
                world_size=world,
                local_world_size=int(e.get("LOCAL_WORLD_SIZE", max(1, world))),
                node_rank=int(e.get("GROUP_RANK", e.get("NODE_RANK", 0))),
                source="env:torchrun",
                **common,
            )
        except (ValueError, TypeError):
            pass
    return RuntimeIdentity(source="defaults", **common)

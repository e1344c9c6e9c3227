"""A world of spawned gloo ranks for the port's multi-rank CPU tests.

``World(n, tmp)`` spawns ``n`` processes (the ``spawn`` start method),
each joins one gloo process group through a file store under ``tmp``,
then runs tasks until closed.  ``world.run(fn, *args, **kwargs)`` sends
every rank the same task, a module-level function named by its import
path (``fn(*args, **kwargs)`` on each rank), and returns the ranks'
results in rank order.  A task that raises on any rank, or a world that
does not answer within ``timeout`` seconds, fails the call with every
rank's traceback, and the world is spawned anew for the next call (a
rank left inside a collective would hang it).

The workers import torch and the port only: tasks live in modules that
import no JAX (``tests/torch_spmd_tasks.py``), and tests compare their
results with the JAX package in the test process.  One world per test
file, shared by a module-scoped fixture, keeps the CPU time small;
``Worlds`` spawns one world per size a file needs, on first use.
"""

from __future__ import annotations

import importlib
import multiprocessing as mp
import os
import queue
import sys
import traceback
from pathlib import Path
from typing import Any, Callable, List


def _worker(rank: int, n: int, store: str, inbox, outbox, paths: List[str]) -> None:
    sys.path[:0] = [p for p in paths if p not in sys.path]
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank, world_size=n)
    try:
        while True:
            task = inbox.get()
            if task is None:
                break
            name, args, kwargs = task
            try:
                module, fn = name.split(":")
                result = getattr(importlib.import_module(module), fn)(*args, **kwargs)
                outbox.put((rank, True, result))
            except BaseException:
                outbox.put((rank, False, traceback.format_exc()))
    finally:
        dist.destroy_process_group()


class World:
    def __init__(self, n: int, tmp: Path) -> None:
        self.n = n
        self._tmp = Path(tmp)
        self._spawned = 0
        self._start()

    def _start(self) -> None:
        ctx = mp.get_context("spawn")
        self._spawned += 1
        store = self._tmp / f"gloo_store_{self._spawned}"
        paths = [str(Path(__file__).resolve().parent), str(Path(__file__).resolve().parent.parent)]
        self._inboxes = [ctx.Queue() for _ in range(self.n)]
        self._outbox = ctx.Queue()
        self._procs = [ctx.Process(target=_worker, args=(r, self.n, str(store), self._inboxes[r], self._outbox,
                                                          paths), daemon=True, name=f"spmd-rank-{r}")
                       for r in range(self.n)]
        for p in self._procs:
            p.start()

    def run(self, fn: Callable[..., Any], *args: Any, timeout: float = 240.0, **kwargs: Any) -> List[Any]:
        name = f"{fn.__module__}:{fn.__qualname__}"
        for inbox in self._inboxes:
            inbox.put((name, args, kwargs))
        results, errors = {}, {}
        try:
            while len(results) + len(errors) < self.n:
                rank, ok, value = self._outbox.get(timeout=timeout)
                (results if ok else errors)[rank] = value
        except queue.Empty:
            errors["timeout"] = f"{self.n - len(results) - len(errors)} rank(s) did not answer in {timeout} s"
        if errors:
            self.close()
            self._start()
            raise AssertionError(f"task {name} failed:\n" + "\n".join(f"[{r}] {e}" for r, e in errors.items()))
        return [results[r] for r in range(self.n)]

    def close(self) -> None:
        for inbox in self._inboxes:
            inbox.put(None)
        for p in self._procs:
            p.join(timeout=20)
        for p in self._procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=10)


class Worlds:
    """``worlds(n)``: the world of ``n`` ranks, spawned on first use and
    kept; ``close()`` closes every one."""

    def __init__(self, tmp: Path) -> None:
        self._tmp = Path(tmp)
        self._worlds = {}

    def __call__(self, n: int) -> World:
        if n not in self._worlds:
            path = self._tmp / f"world{n}"
            path.mkdir(exist_ok=True)
            self._worlds[n] = World(n, path)
        return self._worlds[n]

    def close(self) -> None:
        for world in self._worlds.values():
            world.close()

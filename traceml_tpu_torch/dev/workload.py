"""The main-path workload of the on-card runs, their kernel timer and
their sampler timer.

The full-width DecoderLM of the repo's own TPU lane (``bench.py:206-210``:
vocab 16384, hidden 1024, 12 layers, 16 heads over 8 kv heads, bf16
compute, f32 parameters) with random weights made from a numpy seed in
the flax params layout and loaded through ``params_from_jax``, plus host
token batches from a seed: (8, 1024) for the forward, (8, 1025) for the
train step, whose model sees ``tokens[:, :-1]`` at S=1024.
:func:`gradient_sync` is the data-parallel gradient sync of the
collectives runs: one all-reduce of the flattened f32 gradients
(175,137,792 values, 700,551,168 bytes at full width), recorded through
``instrument_collective``.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterator, List, Sequence, Tuple

import collections
import statistics
import time

import numpy as np
import torch

from traceml_tpu_torch.models.convert import params_from_jax
from traceml_tpu_torch.models.transformer import DecoderLM, ModelConfig, init_train_state

BATCH, SEQ = 8, 1024
TRAIN_TOKENS = SEQ + 1  # the train step feeds tokens[:, :-1]: S=1024 reaches attention


def full_width_config() -> ModelConfig:
    return ModelConfig(vocab_size=16384, hidden=1024, n_layers=12, n_heads=16,
                       n_kv_heads=8, max_seq_len=SEQ, dtype=torch.bfloat16)


def random_flax_params(cfg: ModelConfig, seed: int) -> Dict[str, Any]:
    """A flax-layout DecoderLM params tree of numpy arrays, from a seed:
    kernels normal with std 1/sqrt(fan_in), embedding normal, scales ones."""
    rng = np.random.default_rng(seed)

    def dense(d_in: int, d_out: int) -> Dict[str, np.ndarray]:
        w = rng.standard_normal((d_in, d_out), dtype=np.float32)
        return {"kernel": w * np.float32(1.0 / np.sqrt(d_in))}

    def ones(n: int) -> Dict[str, np.ndarray]:
        return {"scale": np.ones((n,), np.float32)}

    hd = cfg.head_dim
    params: Dict[str, Any] = {
        "embed": {"embedding": rng.standard_normal((cfg.vocab_size, cfg.hidden), dtype=np.float32)}
    }
    for i in range(cfg.n_layers):
        params[f"layer_{i}"] = {
            "attn_norm": ones(cfg.hidden),
            "attn": {
                "wq": dense(cfg.hidden, cfg.n_heads * hd),
                "wk": dense(cfg.hidden, cfg.n_kv_heads * hd),
                "wv": dense(cfg.hidden, cfg.n_kv_heads * hd),
                "wo": dense(cfg.n_heads * hd, cfg.hidden),
            },
            "mlp_norm": ones(cfg.hidden),
            "mlp": {
                "w_gate": dense(cfg.hidden, cfg.ffn_hidden),
                "w_up": dense(cfg.hidden, cfg.ffn_hidden),
                "w_down": dense(cfg.ffn_hidden, cfg.hidden),
            },
        }
    params["final_norm"] = ones(cfg.hidden)
    params["lm_head"] = dense(cfg.hidden, cfg.vocab_size)
    return params


def seeded_state_dict(cfg: ModelConfig, seed: int) -> Dict[str, torch.Tensor]:
    """``params_from_jax(random_flax_params(cfg, seed))``, kept on disk in
    the kernels' build directory (``ops/_build.py``) once made: every
    ``run`` of a ``dev/`` script starts a process that would draw the
    same 175M normals again (seconds at full width).  The file is named
    by the widths, the seed and the source of the code that makes the
    weights (``random_flax_params`` and ``models/convert.py``), so a
    change to either makes a new file; it is written atomically and read
    back memory-mapped, so ranks and runs at once share it."""
    import hashlib
    import inspect
    import os
    import pickle

    from traceml_tpu_torch.models import convert
    from traceml_tpu_torch.ops._build import BUILD_DIR

    widths = (cfg.vocab_size, cfg.hidden, cfg.n_layers, cfg.n_heads, cfg.n_kv_heads, cfg.ffn_hidden)
    makers = inspect.getsource(random_flax_params) + inspect.getsource(convert)
    tag = hashlib.sha256(repr((makers, widths, seed)).encode()).hexdigest()[:16]
    path = BUILD_DIR / f"weights-{tag}.pt"
    if path.exists():
        try:
            return torch.load(path, mmap=True, weights_only=True)
        except (RuntimeError, EOFError, pickle.UnpicklingError):
            pass  # an unreadable file (torn by a full disk): make it again
    state = params_from_jax(random_flax_params(cfg, seed))
    try:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
        torch.save(state, tmp)
        os.replace(tmp, path)
    except OSError:
        pass  # an unwritable build dir: the weights are made each time
    return state


def build_model(cfg: ModelConfig, seed: int, device: Any = "cuda") -> DecoderLM:
    model = DecoderLM(cfg, device=device)
    model.load_state_dict(seeded_state_dict(cfg, seed))
    return model.eval()


def build_train_state(cfg: ModelConfig, seed: int, device: Any = "cuda",
                      learning_rate: float = 3e-4, mesh: Any = None) -> Tuple[DecoderLM, torch.optim.AdamW]:
    """``init_train_state``'s model and AdamW, with the weights of
    :func:`build_model` for the same seed (loaded before a ``mesh``'s
    FSDP2 sharding)."""
    return init_train_state(cfg, device=device, learning_rate=learning_rate, seed=seed, mesh=mesh,
                            state_dict=seeded_state_dict(cfg, seed))


def host_batches(cfg: ModelConfig, seed: int, n: int = 4, batch: int = BATCH,
                 seq: int = SEQ, pin: bool = True) -> List[torch.Tensor]:
    """``n`` (batch, seq) int64 token batches in host memory, pinned by
    default, so that ``.to("cuda", non_blocking=True)`` copies
    asynchronously."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (batch, seq), dtype=np.int64))
        out.append(tokens.pin_memory() if pin else tokens)
    return out


def cuda_ms(fn: Callable[[], Any], iters: int) -> float:
    """Mean device time of one call of ``fn``, from CUDA events around
    ``iters`` calls after three warm-up calls.  The card first spins for
    about 10 ms, so the host has queued the calls before the start event
    runs and their launch cost on the host stays out of the time."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(20_000_000)  # cycles: ~10 ms at the H100's ~2 GHz
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def time_samplers(samplers) -> Dict[str, List[float]]:
    """Wrap each sampler's ``sample`` so that every tick's wall time (s)
    lands in the returned dict under the sampler's name."""
    costs: Dict[str, List[float]] = {s.name: [] for s in samplers}

    def timed(inner, out):
        def sample() -> None:
            t0 = time.perf_counter()
            inner()
            out.append(time.perf_counter() - t0)
        return sample

    for s in samplers:
        s.sample = timed(s.sample, costs[s.name])
    return costs


def sampler_cost_summary(costs: Dict[str, List[float]]) -> Dict[str, Any]:
    """Per sampler: ticks and the median, p90 and max µs of a tick; and the
    median µs of a whole tick of all samplers."""
    out: Dict[str, Any] = {}
    for name, vals in costs.items():
        if vals:
            v = sorted(vals)
            out[name] = {"ticks": len(v), "median_us": statistics.median(v) * 1e6,
                         "p90_us": v[min(len(v) - 1, int(0.9 * len(v)))] * 1e6, "max_us": v[-1] * 1e6}
    ticks = [sum(t) for t in zip(*(v for v in costs.values() if v))]
    out["all_samplers_median_us_per_tick"] = statistics.median(ticks) * 1e6 if ticks else None
    return out


def paced_batches(host: Sequence[Any], steps: int, delay_ms: float, delay_x: float,
                  warmup_s: Sequence[float]) -> Iterator[Any]:
    """Yield ``steps`` batches from ``host`` in turn, sleeping before each
    ``delay_ms`` plus ``delay_x`` times the median host time of the last 8
    steps (the warm-up steps' ``warmup_s`` before the first): an input
    pipeline that cannot keep up, whose delay dominates the step whatever
    the host's load.  The time between two batches is the step's."""
    recent = collections.deque(warmup_s, maxlen=8)
    for i in range(steps):
        delay_s = delay_ms / 1000.0 + delay_x * statistics.median(recent)
        if delay_s:
            time.sleep(delay_s)
        t = time.perf_counter()
        yield host[i % len(host)]
        recent.append(time.perf_counter() - t)


def kill_after(step: int, after: int, rank: int) -> None:
    """SIGKILL this process once ``step`` (1-based) reaches ``after`` when
    it is rank ``rank`` (``RANK``, 0 when unset): a rank that dies mid-run
    for the liveness runs.  ``after`` 0 never kills."""
    import os
    import signal

    if after and step == after and int(os.environ.get("RANK", 0)) == rank:
        os.kill(os.getpid(), signal.SIGKILL)


def gradient_sync(model: torch.nn.Module, kind: str = "all_reduce", sleep_ms: float = 0.0) -> Callable[[], Any]:
    """The gradient sync a train step calls between backward and the
    update, as ``instrument_collective(op="all_reduce")`` records it (the
    ``collective`` phase, device-timed, and one collectives-domain record
    a call with the flat buffer's bytes and dtype).  It flattens the
    gradients into one f32 buffer, ``dist.all_reduce``s it (``kind``
    ``"all_reduce"``; the default process group) or leaves it local
    (``"local"``: a sync whose cost is this rank's alone, as the JAX
    ``collective_straggler`` scenario's is), divides by the world size and
    copies the mean back.  DDP's bucketed all-reduce runs in its C++
    reducer, where no Python wrapper sees it; this sync is the loop's own.

    ``sleep_ms`` slows the sync on the host, inside the recorded window:
    a link too slow to hide.  On CUDA the device is synchronized first,
    outside the window, so the window holds the slow link and not the
    backward it waited for."""
    import torch.distributed as dist

    import traceml_tpu_torch as tm

    params = list(model.parameters())
    world = dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1

    def sync() -> torch.Tensor:
        grads = [p.grad for p in params if p.grad is not None]
        flat = torch.cat([g.reshape(-1) for g in grads])
        if sleep_ms:
            time.sleep(sleep_ms / 1000.0)
        if kind == "all_reduce":
            dist.all_reduce(flat)
        if world > 1:
            flat.div_(world)
        offset = 0
        for g in grads:
            n = g.numel()
            g.copy_(flat[offset:offset + n].view_as(g))
            offset += n
        return flat

    timed = tm.instrument_collective(sync, op="all_reduce")

    def step_sync() -> torch.Tensor:
        if sleep_ms and params and params[0].is_cuda:
            torch.cuda.synchronize()
        return timed()

    return step_sync

"""Project-level static code scan.

Counterpart of ``traceml_tpu/launcher/ast_scan.py`` (copied).  One AST
visitor, shared by the single-file and the project-level paths, pulls
the framework, parallelism, precision, optimizer and input signals of a
training script.  The scan is framework-neutral: it keeps the JAX
vocabulary (``framework: "jax"``, ``pjit``, ``donate_argnums``) beside
the PyTorch one, so a script scans the same under both packages.

``analyze_script``  — one file.
``analyze_project`` — entry file + bounded BFS over its LOCAL imports
(modules resolvable to files under the script's directory, at most
``_MAX_MODULES`` of at most ``_MAX_FILE_BYTES`` each), merged into one
manifest with per-module provenance.
"""

from __future__ import annotations

import ast
from pathlib import Path
from typing import Any, Dict, List, Optional, Set

_MAX_MODULES = 24
_MAX_FILE_BYTES = 512 * 1024


#: host-sync leaf attrs — each forces a device→host round trip
_SYNC_ATTRS = (
    "item", "cpu", "numpy", "tolist", "block_until_ready", "device_get",
)
#: calls that mark a loop as training-like (torch AND jax vocabularies)
_TRAIN_MARKERS = (
    "backward", "zero_grad", "apply_gradients", "apply_updates",
    "trace_step", "train_step",
)
#: markers valid only as a BARE NAME call — ``step(state, batch)`` is
#: the canonical jitted-jax-step idiom, but the attribute form
#: (scheduler.step(), env.step(), optimizer.step() without backward)
#: matches far too much non-training code
_TRAIN_NAME_MARKERS = _TRAIN_MARKERS + ("step",)


def _receiver_is_optimizer(node: ast.AST) -> bool:
    """Any name/attr along the receiver chain mentions an optimizer —
    handles `optimizer`, `self.optimizer`, `optimizers[0]`, and
    `self.optimizers()[0]` receivers alike."""
    for n in ast.walk(node):
        if isinstance(n, ast.Name) and "opt" in n.id.lower():
            return True
        if isinstance(n, ast.Attribute) and "opt" in n.attr.lower():
            return True
    return False


class _ScriptVisitor(ast.NodeVisitor):
    def __init__(self) -> None:
        self.imports: Set[str] = set()        # top-level names
        self.import_modules: Set[str] = set()  # full dotted module names
        # (level, module-or-"", names) for `from . import x` forms —
        # resolved against the IMPORTING file's package, not the entry
        self.relative_imports: List[tuple] = []
        self.calls: List[str] = []
        self.attrs: List[str] = []
        # call name → list of per-call {kwarg: literal value} (a script
        # may build several DataLoaders with different configs)
        self.call_kwargs: Dict[str, List[Dict[str, Any]]] = {}
        # per-site classification: sync calls, H2D idioms, and loop
        # flags are classified PER CALL SITE with training-loop context,
        # not just noted to exist
        self.sync_sites: Dict[str, Dict[str, Any]] = {}
        self.h2d: Dict[str, Any] = {
            "to_device": False, "non_blocking": False,
            "device_put_count": 0, "h2d_in_loop": 0,
        }
        self.loop_flags: Dict[str, bool] = {}
        self.distributed_sampler_used = False
        self.set_epoch_called = False
        self._loop_stack: List[bool] = []  # is-training per open loop

    # -- loop context ------------------------------------------------

    def _loop_is_training(self, loop: ast.AST) -> bool:
        for child in ast.walk(loop):
            if isinstance(child, ast.Call):
                f = child.func
                if isinstance(f, ast.Attribute):
                    if f.attr in _TRAIN_MARKERS:
                        return True
                    # attribute .step() counts only on an optimizer-named
                    # receiver: catches `optimizer.step(closure)` (LBFGS,
                    # where backward lives in the closure outside the
                    # loop) and `optimizers[0].step()` without
                    # re-admitting scheduler/env/tqdm .step false
                    # positives
                    if f.attr == "step" and _receiver_is_optimizer(f.value):
                        return True
                if isinstance(f, ast.Name) and f.id in _TRAIN_NAME_MARKERS:
                    return True
        return False

    def _in_train_loop(self) -> bool:
        return any(self._loop_stack)

    def visit_For(self, node: ast.For) -> None:
        self._loop_stack.append(self._loop_is_training(node))
        self.generic_visit(node)
        self._loop_stack.pop()

    visit_AsyncFor = visit_For

    def visit_While(self, node: ast.While) -> None:
        self._loop_stack.append(self._loop_is_training(node))
        self.generic_visit(node)
        self._loop_stack.pop()

    _KWARG_TARGETS = (
        "DataLoader",
        "TrainingArguments",
        "jit",
        "pjit",
        "Trainer",
        "BitsAndBytesConfig",
        "LoraConfig",
        "from_pretrained",
    )

    def visit_Import(self, node: ast.Import) -> None:
        for a in node.names:
            self.imports.add(a.name.split(".")[0])
            self.import_modules.add(a.name)

    def visit_ImportFrom(self, node: ast.ImportFrom) -> None:
        if node.level and node.level > 0:
            self.relative_imports.append(
                (node.level, node.module or "", [a.name for a in node.names])
            )
        elif node.module:
            self.imports.add(node.module.split(".")[0])
            self.import_modules.add(node.module)
        for a in node.names:
            # imported symbol names carry parallelism signals
            # (Mesh, PartitionSpec, shard_map, …)
            self.attrs.append(a.name)
            if node.module and not node.level:
                self.import_modules.add(f"{node.module}.{a.name}")

    def visit_Call(self, node: ast.Call) -> None:
        name = _dotted(node.func)
        if name is None and isinstance(node.func, ast.Attribute):
            # chained / subscripted receivers (`metrics["loss"].item()`,
            # `model(x).cpu()`) have no resolvable dotted chain but the
            # leaf attr still classifies the site; record the leaf in
            # ``calls`` too so sync_call_hints (built from calls) stays
            # consistent with sync_sites
            self.calls.append(node.func.attr)
            self._classify_site(node, node.func.attr)
        if name:
            self.calls.append(name)
            tail = name.split(".")[-1]
            if tail in self._KWARG_TARGETS:
                kws: Dict[str, Any] = {}
                for kw in node.keywords:
                    if kw.arg is None:
                        continue
                    try:
                        kws[kw.arg] = ast.literal_eval(kw.value)
                    except (ValueError, SyntaxError):
                        kws[kw.arg] = "<dynamic>"
                self.call_kwargs.setdefault(tail, []).append(kws)
            self._classify_site(node, tail)
        self.generic_visit(node)

    def _classify_site(self, node: ast.Call, leaf: str) -> None:
        in_loop = self._in_train_loop()
        line = getattr(node, "lineno", 0)
        if leaf in _SYNC_ATTRS:
            site = self.sync_sites.setdefault(
                leaf, {"count": 0, "in_loop": 0, "lines": []}
            )
            site["count"] += 1
            site["in_loop"] += int(in_loop)
            if len(site["lines"]) < 10:
                site["lines"].append(line)
        if leaf in ("to", "cuda"):
            self.h2d["to_device"] = True
            for kw in node.keywords:
                if kw.arg == "non_blocking":
                    try:
                        if ast.literal_eval(kw.value) is True:
                            self.h2d["non_blocking"] = True
                    except (ValueError, SyntaxError):
                        pass
            if in_loop:
                self.h2d["h2d_in_loop"] += 1
        elif leaf == "device_put":
            self.h2d["device_put_count"] += 1
            if in_loop:
                self.h2d["h2d_in_loop"] += 1
        if in_loop:
            if leaf in ("save", "save_checkpoint", "save_pretrained"):
                self.loop_flags["checkpoint_in_loop"] = True
            elif leaf in ("eval", "no_grad", "inference_mode"):
                self.loop_flags["validation_in_loop"] = True
            elif leaf in ("log", "add_scalar"):
                self.loop_flags["logging_in_loop"] = True
            elif leaf == "print":
                # ordinary progress prints are too common to count as
                # logger traffic — separate advisory flag
                self.loop_flags["print_in_loop"] = True
        if leaf == "DistributedSampler":
            self.distributed_sampler_used = True
        elif leaf == "set_epoch":
            self.set_epoch_called = True

    def visit_Attribute(self, node: ast.Attribute) -> None:
        name = _dotted(node)
        if name:
            self.attrs.append(name)
        self.generic_visit(node)


def _dotted(node: ast.AST) -> Optional[str]:
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _visit_file(path: Path, enforce_size: bool = True) -> Optional[_ScriptVisitor]:
    """Parse + visit one file; None on parse failure (or oversize, when
    ``enforce_size`` — the traversal bound; the ENTRY script is always
    scanned in full)."""
    try:
        if enforce_size and path.stat().st_size > _MAX_FILE_BYTES:
            return None
        tree = ast.parse(path.read_text(encoding="utf-8"))
    except Exception:
        return None
    v = _ScriptVisitor()
    v.visit(tree)
    return v


def _extract(v: _ScriptVisitor, out: Dict[str, Any]) -> None:
    """Fold one visitor's signals into the manifest dict."""
    names = set(v.calls) | set(v.attrs)
    imports = v.imports

    # jax/flax anywhere in the project wins (torch often appears as a
    # data-utility import in jax projects); order-independent
    if "jax" in imports or "flax" in imports:
        out["framework"] = "jax"
    elif out["framework"] == "unknown" and imports & {
        "torch", "lightning", "pytorch_lightning"
    }:
        out["framework"] = "torch"
    out["uses"] = sorted(
        set(out["uses"])
        | (
            imports
            & {
                "jax", "flax", "optax", "orbax", "torch", "transformers",
                "numpy", "tensorflow", "grain", "lightning",
                "pytorch_lightning", "deepspeed", "accelerate", "peft",
                "bitsandbytes", "ray",
            }
        )
    )

    def any_in(*subs: str) -> bool:
        return any(any(s in n for n in names) for s in subs)

    def add(field: str, value: str) -> None:
        if value not in out[field]:
            out[field].append(value)

    if any_in("pjit", "shard_map", "NamedSharding", "PartitionSpec", "Mesh"):
        add("parallelism_hints", "gspmd")
    if any_in("pmap"):
        add("parallelism_hints", "pmap")
    if any_in("distributed.initialize"):
        add("parallelism_hints", "multi_host")
    if any_in("DistributedDataParallel", "DDPStrategy"):
        add("parallelism_hints", "ddp")
    if any_in("FSDP", "fully_shard", "FSDPStrategy"):
        add("parallelism_hints", "fsdp")
    if "deepspeed" in imports or any_in("DeepSpeedStrategy", "deepspeed"):
        add("parallelism_hints", "deepspeed")
    # lightning Trainer(strategy="...") literal
    for call in v.call_kwargs.get("Trainer", []):
        strategy = call.get("strategy")
        if isinstance(strategy, str):
            out["trainer_strategy"] = strategy
            for tag in ("ddp", "fsdp", "deepspeed"):
                if tag in strategy:
                    add("parallelism_hints", tag)
        for k in ("devices", "num_nodes", "precision", "accumulate_grad_batches"):
            if k in call:
                out.setdefault("trainer_args", {})[k] = call[k]
    if any_in("bfloat16", "bf16"):
        add("precision_hints", "bf16")
    if any_in("float16", "fp16", "autocast"):
        add("precision_hints", "fp16/amp")
    for opt in ("adamw", "adam", "sgd", "adafactor", "lion", "lamb"):
        if any_in(opt):
            add("optimizer_hints", opt)
    if any_in("DataLoader"):
        add("input_hints", "torch_dataloader")
    if any_in("device_put"):
        add("input_hints", "explicit_device_put")
    if any_in("jax.checkpoint", "remat") and "remat" not in out["uses"]:
        out["uses"].append("remat")

    # config extraction: dataloader args, TrainingArguments precision,
    # grad accumulation, QLoRA markers
    dls = v.call_kwargs.get("DataLoader", [])
    if dls:
        keep = ("num_workers", "pin_memory", "prefetch_factor",
                "batch_size", "persistent_workers")
        out.setdefault("dataloader_args", []).extend(
            {k: dl[k] for k in keep if k in dl} for dl in dls[:8]
        )
        # torch's DataLoader default is num_workers=0 (single worker in
        # the main process) — exactly the input-bound setup this hint
        # exists to flag, so a missing kwarg counts
        if any(dl.get("num_workers", 0) in (0, None) for dl in dls):
            add("input_hints", "single_worker_dataloader")
    ta = {
        k: val
        for call in v.call_kwargs.get("TrainingArguments", [])
        for k, val in call.items()
    }
    if ta:
        out.setdefault("hf_training_args", {}).update(
            {
                k: ta[k]
                for k in ("per_device_train_batch_size",
                          "gradient_accumulation_steps", "bf16", "fp16",
                          "gradient_checkpointing", "optim",
                          "deepspeed", "fsdp")
                if k in ta
            }
        )
        if ta.get("bf16"):
            add("precision_hints", "bf16")
        if ta.get("fp16"):
            add("precision_hints", "fp16/amp")
        if ta.get("fsdp"):
            add("parallelism_hints", "fsdp")
        if ta.get("deepspeed"):
            add("parallelism_hints", "deepspeed")
    jit_kw = {
        k: val
        for call in v.call_kwargs.get("jit", []) + v.call_kwargs.get("pjit", [])
        for k, val in call.items()
    }
    if "donate_argnums" in jit_kw and "buffer_donation" not in out["uses"]:
        out["uses"].append("buffer_donation")

    # QLoRA / quantization
    quant: Dict[str, Any] = dict(out.get("quantization") or {})
    for call in v.call_kwargs.get("BitsAndBytesConfig", []):
        for k in ("load_in_4bit", "load_in_8bit", "bnb_4bit_quant_type",
                  "bnb_4bit_compute_dtype"):
            if k in call:
                quant[k] = call[k]
    for call in v.call_kwargs.get("from_pretrained", []):
        for k in ("load_in_4bit", "load_in_8bit"):
            if call.get(k):
                quant[k] = call[k]
    lora = {
        k: val
        for call in v.call_kwargs.get("LoraConfig", [])
        for k, val in call.items()
        if k in ("r", "lora_alpha", "target_modules", "lora_dropout")
    }
    if lora:
        quant["lora"] = lora
    if quant:
        out["quantization"] = quant
    if (
        imports & {"peft", "bitsandbytes"}
        or any_in("lora", "Lora", "LoRA")
    ) and "lora/qlora" not in out["uses"]:
        out["uses"].append("lora/qlora")
    # host-sync calls inside the loop are a classic TPU/GPU perf trap
    sync_markers = [
        n for n in _SYNC_ATTRS
        if any(name.endswith("." + n) or name == n for name in set(v.calls))
    ]
    for m in sync_markers:
        if m not in out.setdefault("sync_call_hints", []):
            out["sync_call_hints"].append(m)

    # per-site classification: sync call
    # counts with training-loop context and line numbers, H2D idioms,
    # and loop hygiene flags — merged across project files
    if v.sync_sites:
        merged = out.setdefault("sync_sites", {})
        for leaf, site in v.sync_sites.items():
            dst = merged.setdefault(
                leaf, {"count": 0, "in_loop": 0, "lines": []}
            )
            dst["count"] += site["count"]
            dst["in_loop"] += site["in_loop"]
            dst["lines"] = (dst["lines"] + site["lines"])[:10]
        if any(s["in_loop"] for s in merged.values()):
            add("input_hints", "host_sync_in_loop")
    if v.h2d["to_device"] or v.h2d["device_put_count"]:
        h2d = out.setdefault("h2d", {
            "to_device": False, "non_blocking": False,
            "device_put_count": 0, "h2d_in_loop": 0,
        })
        h2d["to_device"] = h2d["to_device"] or v.h2d["to_device"]
        h2d["non_blocking"] = h2d["non_blocking"] or v.h2d["non_blocking"]
        h2d["device_put_count"] += v.h2d["device_put_count"]
        h2d["h2d_in_loop"] += v.h2d["h2d_in_loop"]
        if h2d["to_device"] and not h2d["non_blocking"]:
            add("input_hints", "blocking_h2d")
        elif h2d["non_blocking"] and "blocking_h2d" in out["input_hints"]:
            # an earlier file looked blocking; a later one proved
            # non_blocking is used — drop the stale hint
            out["input_hints"].remove("blocking_h2d")
    if v.loop_flags:
        out.setdefault("loop_flags", {}).update(v.loop_flags)
    # fold set_epoch UNCONDITIONALLY: the sampler and its set_epoch
    # call may live in different project files, and extraction order
    # is BFS over imports — gating this on the same file using
    # DistributedSampler would fabricate the missing-set_epoch hint
    out["set_epoch_called"] = (
        out.get("set_epoch_called") or v.set_epoch_called
    )
    if v.distributed_sampler_used:
        add("input_hints", "distributed_sampler")
        out["_sampler_seen"] = True
    if out.get("_sampler_seen"):
        if not out["set_epoch_called"]:
            # same-order shards every epoch — the classic missing
            # sampler.set_epoch bug
            add("input_hints", "distributed_sampler_no_set_epoch")
        elif "distributed_sampler_no_set_epoch" in out["input_hints"]:
            out["input_hints"].remove("distributed_sampler_no_set_epoch")


def _empty_manifest(script: Path) -> Dict[str, Any]:
    return {
        "script": str(script),
        "framework": "unknown",
        "uses": [],
        "parallelism_hints": [],
        "precision_hints": [],
        "optimizer_hints": [],
        "input_hints": [],
    }


def analyze_script(script: Path) -> Dict[str, Any]:
    """Best-effort static scan of ONE file."""
    out = _empty_manifest(script)
    v = _visit_file(Path(script), enforce_size=False)
    if v is None:
        try:
            ast.parse(Path(script).read_text(encoding="utf-8"))
        except Exception as exc:
            out["error"] = str(exc)
        return out
    _extract(v, out)
    return {k: val for k, val in out.items() if not k.startswith("_")}


def _resolve_local(module: str, roots: List[Path]) -> Optional[Path]:
    """Dotted module name → local file under one of ``roots``, or None."""
    rel = module.replace(".", "/")
    for root in roots:
        for candidate in (root / f"{rel}.py", root / rel / "__init__.py"):
            try:
                if candidate.is_file():
                    return candidate.resolve()
            except OSError:
                continue
    return None


def analyze_project(script: Path, max_modules: int = _MAX_MODULES) -> Dict[str, Any]:
    """Entry script + bounded BFS over its LOCAL imports

    Only modules that resolve to files under the entry script's directory
    (the project) are followed; site-packages never are.  Bounded by
    ``max_modules`` and per-file size, tolerant of cycles and syntax
    errors (a broken module is recorded, not fatal).
    """
    entry = Path(script).resolve()
    out = _empty_manifest(entry)
    roots = [entry.parent]
    queue: List[Path] = [entry]
    seen: Set[Path] = set()
    scanned: List[str] = []
    failed: List[str] = []
    while queue and len(seen) < max_modules:
        path = queue.pop(0)
        if path in seen:
            continue
        seen.add(path)
        v = _visit_file(path, enforce_size=path != entry)
        if v is None:
            failed.append(str(path))
            continue
        scanned.append(str(path))
        _extract(v, out)
        for module in sorted(v.import_modules):
            local = _resolve_local(module, roots)
            if local is not None and local not in seen:
                queue.append(local)
        # relative imports resolve against THIS file's package, walking
        # one directory up per extra leading dot
        for level, module, names in v.relative_imports:
            base = path.parent
            for _ in range(level - 1):
                base = base.parent
            candidates = [module] if module else []
            candidates += (
                [f"{module}.{n}" for n in names] if module else list(names)
            )
            for mod in candidates:
                local = _resolve_local(mod, [base])
                if local is not None and local not in seen:
                    queue.append(local)
    out["modules_scanned"] = len(scanned)
    out["local_modules"] = [str(p) for p in scanned if Path(p) != entry]
    if failed:
        out["modules_failed"] = failed
    # cross-file extraction state (e.g. _sampler_seen) is not manifest
    out = {k: v for k, v in out.items() if not k.startswith("_")}
    return out

"""The port's code manifest against the JAX package's.

``analyze_script`` and ``analyze_project`` of both packages on the same
scripts must give the same manifest, key for key (the scan holds no
float).  The scripts cover every shape of the JAX launcher tests
(``tests/launcher/test_launcher_units.py``: hints, a bad script, deep
extraction, donation, several DataLoaders, sync sites, H2D idioms, the
scheduler loop, the sampler with and without ``set_epoch``, bare
``step`` calls, an LBFGS closure, subscripted optimizers; projects with
``set_epoch`` in another module and a later file that retracts
``blocking_h2d``), plus relative imports, a cycle, an oversize module, a
broken module, the module bound, a Lightning ``Trainer``, QLoRA configs
and the port's own ``dev/train_script.py`` and ``dev/forward_script.py``.

Then ``write_code_manifest`` and ``python -m traceml_tpu_torch run``:
every run writes ``code_manifest.json``, traced or not, equal to the JAX
``analyze_project`` of the same script but for ``generated_at``.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from traceml_tpu.launcher import ast_scan as jax_scan
from traceml_tpu_torch.launcher import ast_scan, manifest

REPO = Path(__file__).resolve().parent.parent
DEV = REPO / "traceml_tpu_torch" / "dev"

_LOOP_SCRIPT = """
import torch
from torch.utils.data import DataLoader, DistributedSampler

sampler = DistributedSampler(ds)
loader = DataLoader(ds, sampler=sampler)
model.to("cuda", non_blocking=True)
for batch in loader:
    optimizer.zero_grad()
    loss = model(batch.to("cuda"))
    loss.backward()
    optimizer.step()
    print(loss.item())
    if step % 100 == 0:
        torch.save(model.state_dict(), "ckpt.pt")
x = tensor.item()  # outside any loop: must not count as in_loop
"""

SCRIPTS = {
    "jax_hints": (
        "import jax\nimport optax\n"
        "from jax.sharding import Mesh, PartitionSpec\n"
        "import jax.numpy as jnp\n"
        "opt = optax.adamw(1e-3)\n"
        "x = jax.device_put(jnp.ones(3).astype(jnp.bfloat16))\n"
    ),
    "bad_script": "def broken(:\n",
    "empty": "",
    "deep_extraction": (
        "import torch\n"
        "from torch.utils.data import DataLoader\n"
        "from transformers import TrainingArguments\n"
        "import peft\n"
        "loader = DataLoader(ds, batch_size=32, num_workers=0, pin_memory=True)\n"
        "args = TrainingArguments(output_dir='x', bf16=True,\n"
        "                         gradient_accumulation_steps=4,\n"
        "                         per_device_train_batch_size=8)\n"
        "loss.item()\n"
    ),
    "jax_donation": "import jax\nstep = jax.jit(f, donate_argnums=(0,))\njax.block_until_ready(x)\n",
    "two_dataloaders": (
        "import torch\nfrom torch.utils.data import DataLoader\n"
        "train = DataLoader(a, num_workers=8)\n"
        "val = DataLoader(b)\n"
    ),
    "loop": _LOOP_SCRIPT,
    "loop_with_set_epoch": _LOOP_SCRIPT + "\nsampler.set_epoch(0)\n",
    "scheduler_loop": (
        "for epoch in range(10):\n"
        "    scheduler.step()\n"
        "    metrics.append(loss.item())\n"
        "    print(epoch)\n"
    ),
    "jax_sync_and_device_put": (
        "import jax\n"
        "import traceml_tpu\n"
        "for x in loader:\n"
        "    with traceml_tpu.trace_step():\n"
        "        x = jax.device_put(x)\n"
        "        loss = step(x)\n"
        "        jax.block_until_ready(loss)\n"
    ),
    "non_training_loop": "for f in files:\n    data.append(f.item())\n",
    "bare_step_call": (
        "import jax\n"
        "step = jax.jit(train_step)\n"
        "for batch in ds:\n"
        "    state, m = step(state, batch)\n"
        "    losses.append(m['loss'].item())\n"
    ),
    "lbfgs_closure": (
        "def closure():\n"
        "    loss = model(x)\n"
        "    loss.backward()\n"
        "    return loss\n"
        "for epoch in range(10):\n"
        "    optimizer.step(closure)\n"
        "    losses.append(loss.item())\n"
    ),
    "subscripted_optimizer": (
        "for batch in ds:\n"
        "    optimizers[0].step(closure)\n"
        "    stats.append(model(batch).cpu())\n"
    ),
    "lightning_trainer": (
        "import lightning as L\n"
        "from lightning.pytorch.strategies import DDPStrategy\n"
        "trainer = L.Trainer(strategy='fsdp', devices=8, num_nodes=2, precision='bf16-mixed',\n"
        "                    accumulate_grad_batches=4)\n"
        "trainer.fit(model)\n"
    ),
    "qlora": (
        "import torch\nfrom transformers import BitsAndBytesConfig, AutoModel\n"
        "from peft import LoraConfig\n"
        "bnb = BitsAndBytesConfig(load_in_4bit=True, bnb_4bit_quant_type='nf4',\n"
        "                         bnb_4bit_compute_dtype=torch.bfloat16)\n"
        "model = AutoModel.from_pretrained('m', load_in_4bit=True, quantization_config=bnb)\n"
        "lora = LoraConfig(r=16, lora_alpha=32, target_modules=['q', 'v'], lora_dropout=0.05)\n"
        "opt = torch.optim.AdamW(model.parameters())\n"
    ),
    "ddp_amp_loop": (
        "import torch\nimport torch.distributed as dist\n"
        "from torch.nn.parallel import DistributedDataParallel\n"
        "model = DistributedDataParallel(model)\n"
        "opt = torch.optim.SGD(model.parameters(), lr=0.1)\n"
        "while True:\n"
        "    with torch.autocast('cuda', dtype=torch.float16):\n"
        "        loss = model(next(it).cuda())\n"
        "    loss.backward()\n"
        "    opt.step()\n"
        "    writer.add_scalar('loss', loss.item())\n"
        "    with torch.no_grad():\n"
        "        model.eval()\n"
        "    model.save_pretrained('out')\n"
    ),
    "jax_pmap_remat_multihost": (
        "import jax\nimport flax\nimport orbax\n"
        "jax.distributed.initialize()\n"
        "f = jax.pmap(jax.checkpoint(g))\n"
        "step = pjit(f, donate_argnums=0)\n"
        "for b in ds:\n"
        "    state = step(state, b)\n"
        "    print(jax.device_get(state))\n"
    ),
}

#: project layouts: file name → source; the entry is ``train.py``
PROJECTS = {
    "set_epoch_in_other_module": {
        "data.py": "from torch.utils.data import DistributedSampler\ndef make(ds):\n"
                   "    return DistributedSampler(ds)\n",
        "train.py": "import data\nsampler = data.make(ds)\nfor epoch in range(3):\n    sampler.set_epoch(epoch)\n",
    },
    "blocking_h2d_retracted": {
        "train.py": "import data\nmodel.to('cuda')\n",
        "data.py": "batch.to('cuda', non_blocking=True)\n",
    },
    "relative_and_package_imports": {
        "train.py": "import torch\nfrom pkg import model\nfrom pkg.sub import loop\n",
        "pkg/__init__.py": "from . import helpers\n",
        "pkg/helpers.py": "import torch\nx = torch.zeros(3).to('cuda')\n",
        "pkg/model.py": "from .sub.loop import run\nimport torch.nn as nn\nlayer = nn.Linear(4, 4).bfloat16()\n",
        "pkg/sub/__init__.py": "",
        "pkg/sub/loop.py": "from ..helpers import x\ndef run(opt):\n    for b in ds:\n"
                           "        loss = f(b)\n        loss.backward()\n        opt.step()\n"
                           "        print(loss.item())\n",
    },
    "cycle_broken_and_oversize": {
        "train.py": "import a\nimport broken\nimport big\nimport numpy\n",
        "a.py": "import train\nimport b\nfrom torch.optim import Adam\n",
        "b.py": "import a\nfrom torch.utils.data import DataLoader\nDataLoader(x, num_workers=4)\n",
        "broken.py": "def oops(:\n",
        "big.py": "x = 1\n" + "# padding line to pass the per-file bound\n" * 13000,
    },
    "module_bound": {
        "train.py": "".join(f"import m{i}\n" for i in range(30)),
        **{f"m{i}.py": f"import torch\nv{i} = torch.ones({i}).cpu()\n" for i in range(30)},
    },
}


def _write(tmp_path, name, text):
    path = tmp_path / name
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(text)
    return path


@pytest.mark.parametrize("case", sorted(SCRIPTS))
def test_analyze_script_matches_jax(tmp_path, case):
    script = _write(tmp_path, f"{case}.py", SCRIPTS[case])
    ours = ast_scan.analyze_script(script)
    assert ours == jax_scan.analyze_script(script)
    assert ours == manifest.analyze_script(script)  # the re-export
    assert ours["script"] == str(script)
    assert ("error" in ours) == (case == "bad_script")


@pytest.mark.parametrize("case", sorted(SCRIPTS))
def test_analyze_project_of_one_file_matches_jax(tmp_path, case):
    script = _write(tmp_path, f"{case}.py", SCRIPTS[case])
    ours = ast_scan.analyze_project(script)
    assert ours == jax_scan.analyze_project(script)
    assert ours["modules_scanned"] == (0 if case == "bad_script" else 1)


@pytest.mark.parametrize("case", sorted(PROJECTS))
def test_analyze_project_matches_jax(tmp_path, case):
    for name, text in PROJECTS[case].items():
        _write(tmp_path, name, text)
    entry = tmp_path / "train.py"
    ours = ast_scan.analyze_project(entry)
    assert ours == jax_scan.analyze_project(entry)
    assert not any(k.startswith("_") for k in ours)
    if case == "set_epoch_in_other_module":
        assert "distributed_sampler" in ours["input_hints"]
        assert "distributed_sampler_no_set_epoch" not in ours["input_hints"]
    elif case == "blocking_h2d_retracted":
        assert ours["h2d"]["non_blocking"] and "blocking_h2d" not in ours["input_hints"]
    elif case == "relative_and_package_imports":
        assert ours["modules_scanned"] == 6 and "bf16" in ours["precision_hints"]
    elif case == "cycle_broken_and_oversize":
        assert {Path(p).name for p in ours["modules_failed"]} == {"broken.py", "big.py"}
        assert "torch_dataloader" in ours["input_hints"] and ours["optimizer_hints"] == []
    elif case == "module_bound":
        assert ours["modules_scanned"] == ast_scan._MAX_MODULES == jax_scan._MAX_MODULES


@pytest.mark.parametrize("script", ["train_script.py", "forward_script.py"])
def test_the_ports_own_scripts_scan_as_in_jax(script):
    path = DEV / script
    ours = ast_scan.analyze_project(path)
    assert ours == jax_scan.analyze_project(path)
    assert ast_scan.analyze_script(path) == jax_scan.analyze_script(path)
    assert ours["framework"] == "torch"
    if script == "train_script.py":
        assert "adamw" in ours["optimizer_hints"]
        assert ours["modules_scanned"] == 1  # the package imports resolve outside the script's directory


def test_write_code_manifest_stamps_the_scan(tmp_path):
    from traceml_tpu.launcher.manifest import write_code_manifest as jax_write_code_manifest

    (tmp_path / "jax").mkdir()
    data = manifest.write_code_manifest(tmp_path, DEV / "train_script.py")
    theirs = jax_write_code_manifest(tmp_path / "jax", DEV / "train_script.py")
    on_disk = json.loads((tmp_path / "code_manifest.json").read_text())
    assert on_disk == data and data["generated_at"] > 0
    assert {k: v for k, v in data.items() if k != "generated_at"} == \
        {k: v for k, v in theirs.items() if k != "generated_at"}


@pytest.mark.parametrize("traced", [False, True], ids=["disabled", "traced"])
def test_every_run_writes_the_code_manifest(tmp_path, traced):
    """``run`` of a tiny script, with ``--disable-traceml`` and traced: the
    session's ``code_manifest.json`` is the JAX scan of the script."""
    script = _write(tmp_path, "tiny.py", "import torch\nfrom torch.optim import adamw\n"
                                         "opt = adamw.AdamW([torch.zeros(1)])\nprint('tiny done')\n")
    logs = tmp_path / "logs"
    argv = [sys.executable, "-m", "traceml_tpu_torch", "run", "--mode", "summary", "--logs-dir", str(logs),
            "--finalize-timeout", "15", str(script)]
    if not traced:
        argv.insert(4, "--disable-traceml")
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    proc = subprocess.run(argv, cwd=tmp_path, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    (session,) = [p for p in logs.iterdir() if p.is_dir()]
    data = json.loads((session / "code_manifest.json").read_text())
    assert data.pop("generated_at") > 0
    assert data == jax_scan.analyze_project(script)
    assert data["framework"] == "torch" and "adamw" in data["optimizer_hints"]
    mf = json.loads((session / "manifest.json").read_text())
    assert mf["status"] == "completed"

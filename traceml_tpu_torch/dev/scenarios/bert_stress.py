"""BERT Hugging Face ``Trainer`` stress scenario.

Counterpart of ``traceml_tpu/dev/scenarios/bert_stress.py``: a 4-layer,
128-wide ``BertForSequenceClassification`` trained by the HF ``Trainer``
on synthetic token batches of 8 × 64, bracketed by the port's
``TraceMLTrainerCallback`` (which calls ``init(mode="auto")`` on the
Trainer's device, so the auto-patches time the forward, backward and
optimizer)::

    python -m traceml_tpu_torch.dev.scenarios.bert_stress [steps] [--device cpu]

It needs ``transformers``, which the H100 machine of this project does
not have: it runs where ``transformers`` is installed, on the CPU with
``--device cpu`` (``use_cpu=True``), or on CUDA by default.
"""

from __future__ import annotations

import argparse
import tempfile

import numpy as np


def _dataset(n: int = 512, seq: int = 64, vocab: int = 2000):
    import torch

    class SyntheticText(torch.utils.data.Dataset):
        def __len__(self):
            return n

        def __getitem__(self, i):
            rng = np.random.default_rng(i)
            return {
                "input_ids": torch.tensor(rng.integers(0, vocab, seq)),
                "attention_mask": torch.ones(seq, dtype=torch.long),
                "labels": torch.tensor(int(i % 2)),
            }

    return SyntheticText()


def main(max_steps: int = 60, device=None) -> None:
    from transformers import BertConfig, BertForSequenceClassification, Trainer, TrainingArguments

    from traceml_tpu_torch.integrations.huggingface import TraceMLTrainerCallback
    from traceml_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    config = BertConfig(vocab_size=2000, hidden_size=128, num_hidden_layers=4, num_attention_heads=4,
                        intermediate_size=256, max_position_embeddings=128)
    model = BertForSequenceClassification(config)
    with tempfile.TemporaryDirectory(prefix="traceml_bert_stress_") as out:
        trainer = Trainer(
            model=model,
            args=TrainingArguments(output_dir=out, max_steps=max_steps, per_device_train_batch_size=8,
                                   report_to=[], logging_steps=1000, disable_tqdm=True,
                                   save_strategy="no", use_cpu=dev.type == "cpu"),
            train_dataset=_dataset(),
            callbacks=[TraceMLTrainerCallback()],
        )
        trainer.train()
    print("bert stress done", flush=True)


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("steps", nargs="?", type=int, default=60)
    parser.add_argument("--device", default=None, help="cpu, cuda or cuda:N (default: CUDA)")
    args = parser.parse_args()
    main(max_steps=args.steps, device=args.device)

"""The ``lm_head``'s GEMMs at TF32, scoped to the ``lm_head``.

The JAX ``lm_head`` is ``nn.Dense(dtype=float32)`` with no ``precision``:
XLA's DEFAULT, TF32 on a Hopper GPU.  The port's ``TF32Dense`` runs its
forward GEMM and both gradient GEMMs under ``tf32_matmul``, which must
leave every precision flag as the caller set it.  On the CPU, where TF32
does not exist:

* a forward and a backward of the model leave the flags as they found
  them, from ``allow_tf32 = False`` and from ``True`` and from each other
  way a user sets them;
* a dispatch mode that reads the flag at every matmul sees TF32 at
  exactly the three ``lm_head`` GEMMs and the caller's setting at every
  other one;
* the gradients equal those of a plain ``F.linear`` ``lm_head``.
"""

import pytest
import torch
import torch.nn.functional as F
from torch.utils._python_dispatch import TorchDispatchMode

from traceml_tpu_torch.models import transformer as tf

B = torch.backends
CFG = tf.ModelConfig(vocab_size=96, hidden=64, n_layers=2, n_heads=4, n_kv_heads=2, max_seq_len=64)


def _flags():
    """Every precision flag a caller can read, or the error its getter raises."""
    out = {}
    for name, get in (
        ("cuda.matmul.fp32_precision", lambda: B.cuda.matmul.fp32_precision),
        ("fp32_precision", lambda: B.fp32_precision),
        ("cudnn.conv.fp32_precision", lambda: B.cudnn.conv.fp32_precision),
        ("cudnn.rnn.fp32_precision", lambda: B.cudnn.rnn.fp32_precision),
        ("mkldnn.matmul.fp32_precision", lambda: B.mkldnn.matmul.fp32_precision),
        ("mkldnn.conv.fp32_precision", lambda: B.mkldnn.conv.fp32_precision),
        ("float32_matmul_precision", torch.get_float32_matmul_precision),
        ("allow_tf32", lambda: B.cuda.matmul.allow_tf32),
    ):
        try:
            out[name] = get()
        except RuntimeError as exc:
            out[name] = f"raises: {str(exc)[:40]}"
    return out


SETTINGS = {
    "allow_tf32_false": lambda: setattr(B.cuda.matmul, "allow_tf32", False),
    "allow_tf32_true": lambda: setattr(B.cuda.matmul, "allow_tf32", True),
    "fp32_precision_ieee": lambda: setattr(B.cuda.matmul, "fp32_precision", "ieee"),
    "fp32_precision_tf32": lambda: setattr(B.cuda.matmul, "fp32_precision", "tf32"),
    "matmul_precision_high": lambda: torch.set_float32_matmul_precision("high"),
    "matmul_precision_medium": lambda: torch.set_float32_matmul_precision("medium"),
}


@pytest.fixture
def restore_flags():
    """Each case sets the process's flags (``matmul_precision_medium``
    turns the CPU's matmuls to bf16): put back what the test found."""
    found = _flags()
    backends = (B.cuda.matmul, B.cudnn.conv, B.cudnn.rnn, B.mkldnn.matmul, B.mkldnn.conv, B.mkldnn.rnn, B)
    values = [b.fp32_precision for b in backends]
    yield
    torch.set_float32_matmul_precision(found["float32_matmul_precision"])
    for backend, value in zip(backends, values):
        backend.fp32_precision = value
    assert _flags() == found


def _model_and_tokens():
    torch.manual_seed(0)
    model = tf.DecoderLM(CFG, device="cpu")
    tokens = torch.randint(0, CFG.vocab_size, (2, 33))
    return model, tokens


@pytest.mark.parametrize("setting", sorted(SETTINGS))
def test_a_train_step_leaves_the_flags_as_it_found_them(setting, restore_flags):
    SETTINGS[setting]()
    before = _flags()
    model, tokens = _model_and_tokens()
    tf.loss_fn(model, tokens).backward()
    assert _flags() == before
    with tf.tf32_matmul():
        inside = _flags()
    assert inside["cuda.matmul.fp32_precision"] == "tf32"
    assert _flags() == before


class _MatmulPrecision(TorchDispatchMode):
    """Records (output shape, cuda matmul precision) at every matmul."""

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.overloadpacket in (torch.ops.aten.mm, torch.ops.aten.addmm, torch.ops.aten.bmm):
            self.seen.append((tuple(out.shape), B.cuda.matmul.fp32_precision))
        return out


@pytest.mark.parametrize("setting", ["allow_tf32_false", "fp32_precision_ieee"])
def test_only_the_lm_head_gemms_run_at_tf32(setting, restore_flags):
    SETTINGS[setting]()
    caller = B.cuda.matmul.fp32_precision
    model, tokens = _model_and_tokens()
    mode = _MatmulPrecision()
    with mode:
        tf.loss_fn(model, tokens).backward()
    vocab = CFG.vocab_size
    tf32 = [shape for shape, prec in mode.seen if prec == "tf32"]
    # forward logits (B·S, V), grad of the activations (B·S, H), grad of the weight (V, H)
    assert sorted(tf32) == sorted([(2 * 32, vocab), (2 * 32, CFG.hidden), (vocab, CFG.hidden)])
    assert len(mode.seen) > 3 * CFG.n_layers
    assert {prec for _, prec in mode.seen} - {"tf32"} == {caller}


def test_gradients_equal_a_plain_lm_head():
    model, tokens = _model_and_tokens()
    tf.loss_fn(model, tokens).backward()
    ours = {n: p.grad.clone() for n, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    plain = lambda x: F.linear(x.float(), model.lm_head.weight)  # noqa: E731
    model.lm_head.forward = plain
    tf.loss_fn(model, tokens).backward()
    for name, p in model.named_parameters():
        torch.testing.assert_close(ours[name], p.grad, rtol=1e-6, atol=1e-7, msg=name)

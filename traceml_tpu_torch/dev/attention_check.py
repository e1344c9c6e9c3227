"""How a flash-attention output is held against its plain version.

``allclose`` at a fixed tolerance compares each element with a bound near
the size of the outputs themselves: with unit-variance q, k and v, row i
of a causal attention output has a standard deviation of about
sqrt(e / i), so at S=4096 a typical element is about 0.03, the bf16
tolerance.  Two checks that scale with the output stand beside it:

* ``rel_fro``: ‖out − ref‖_F / ‖ref‖_F over the whole tensor;
* ``row_rel_max``: the largest ‖out_i − ref_i‖ / ‖ref_i‖ over the rows
  (one row is the D-vector of one (b, s, h)), which a fault confined to
  one key tile of one head cannot hide in.

:func:`planted_faults` gives outputs with faults a TMA/``mbarrier`` ring
or a low-precision P could have, so a run can show that the checks
reject them.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

#: bf16: the kernel rounds P to bf16 before the P·V product, where the
#: plain version keeps it in f32, and both round the output to bf16; those
#: roundings give ``rel_fro`` of about 2e-3.  P rounded to fp8 gives 7e-3
#: or more, a K/V tile read from the wrong place far more.  f32: sum order
#: only.
TOLERANCES = {
    torch.bfloat16: {"atol": 3e-2, "rel_fro": 5e-3, "row_rel_max": 1.5e-2},
    torch.float32: {"atol": 1e-4, "rel_fro": 1e-5, "row_rel_max": 1e-5},
}
_KEY_TILE = 128  # the bf16 kernel's key tile


def scaled_errors(out: torch.Tensor, ref: torch.Tensor) -> Dict[str, float]:
    """``max_abs_err``, ``rel_fro`` and ``row_rel_max`` of ``out`` against
    ``ref``, both (B, S, H, D)."""
    o, r = out.float(), ref.float()
    d = o - r
    row_norm = r.norm(dim=-1).clamp_min(torch.finfo(torch.float32).tiny)
    return {
        "max_abs_err": d.abs().max().item(),
        "rel_fro": (d.norm() / r.norm()).item(),
        "row_rel_max": (d.norm(dim=-1) / row_norm).max().item(),
    }


def compare(out: torch.Tensor, ref: torch.Tensor) -> Dict[str, object]:
    """The errors of ``out`` against ``ref`` and whether it passes every
    check for its dtype: finite, ``allclose`` at ``atol = rtol``, and both
    scaled checks."""
    tol = TOLERANCES[ref.dtype]
    errors = scaled_errors(out, ref)
    finite = bool(torch.isfinite(out).all())
    close = torch.allclose(out.float(), ref.float(), atol=tol["atol"], rtol=tol["atol"])
    ok = (finite and close and errors["rel_fro"] <= tol["rel_fro"]
          and errors["row_rel_max"] <= tol["row_rel_max"])
    return {**errors, "finite": finite, "allclose": close, "ok": ok, "tol": tol}


def dense_causal(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, p_dtype: torch.dtype = None
) -> torch.Tensor:
    """softmax(Q Kᵀ/√D) V under a causal mask, in f32 over the whole
    sequence at once.  With ``p_dtype``, P is rounded to it before the P·V
    product while the row sums come from f32 P, as the bf16 kernel does.
    Returns q's dtype."""
    S, D = q.shape[1], q.shape[3]
    qf, kf, vf = (x.float().permute(0, 2, 1, 3) for x in (q, k, v))
    s = qf @ kf.transpose(-1, -2) * (1.0 / math.sqrt(D))
    mask = torch.ones((S, S), dtype=torch.bool, device=q.device).tril()
    s = s.masked_fill(~mask, -1e30)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1, keepdim=True)
    if p_dtype is not None:
        p = p.to(p_dtype).float()
    return ((p @ vf) / l).permute(0, 2, 1, 3).to(q.dtype)


def planted_faults(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Outputs of broken kernels on these inputs, by fault:

    * ``p_fp8``: P rounded to fp8 (e4m3) instead of bf16;
    * ``kv_tile_from_previous_stage``: the middle key tile's K and V read
      from the tile before it, in every (batch, head), as a ring stage
      read at the wrong phase would;
    * ``k_tile_zeroed``: the middle key tile's K read as zeros.
    """
    S = q.shape[1]
    j = S // _KEY_TILE // 2
    cur, prev = slice(j * _KEY_TILE, (j + 1) * _KEY_TILE), slice((j - 1) * _KEY_TILE, j * _KEY_TILE)
    k_stale, v_stale, k_zero = k.clone(), v.clone(), k.clone()
    k_stale[:, cur], v_stale[:, cur] = k[:, prev], v[:, prev]
    k_zero[:, cur] = 0
    return {
        "p_fp8": dense_causal(q, k, v, torch.float8_e4m3fn),
        "kv_tile_from_previous_stage": dense_causal(q, k_stale, v_stale, torch.bfloat16),
        "k_tile_zeroed": dense_causal(q, k_zero, v, torch.bfloat16),
    }

"""Embed / final-norm + LM-head math of the client (port of
bloombee_tpu/models/head.py and client/model.py `_norm_head_chunked`,
Llama path).

The head promotes as the JAX package does: f32 hidden states against bf16
parameters give an f32 product (`torch.promote_types`), never a bf16 one,
so greedy tokens near a tie match the reference. The promotion runs per
call: `norm_head_impl` upcasts the whole `lm_head` for the product (a
transient f32 copy, 2.1 GB for Llama-3-8B's 4096 x 128256 head);
`norm_head_chunked` upcasts one `step`-column slice at a time.
"""

from __future__ import annotations

import numpy as np
import torch

from bloombee_tpu_torch.ops import rms_norm
from bloombee_tpu_torch.utils.device import resolve_device

# numpy dtype names of the JAX client's arrays (ml_dtypes names bf16
# "bfloat16") -> torch dtypes
_NP_NAMES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
}


def embed_impl(params: dict, input_ids: torch.Tensor) -> torch.Tensor:
    """Token ids -> hidden states, in the embed table's dtype."""
    return params["embed"][input_ids]


def _normed(params: dict, hidden: torch.Tensor, eps: float):
    """The final RMSNorm's output and `lm_head`, in their promoted dtype."""
    h = rms_norm(hidden, params["norm"], eps)
    w = params["lm_head"]
    return h.to(torch.promote_types(h.dtype, w.dtype)), w


def norm_head_impl(
    params: dict, hidden: torch.Tensor, eps: float
) -> torch.Tensor:
    """Final RMSNorm + LM head -> fp32 logits."""
    h, w = _normed(params, hidden, eps)
    return (h @ w.to(h.dtype)).float()


def norm_head_chunked(
    params: dict, hidden: torch.Tensor, eps: float, step: int = 16384
) -> torch.Tensor:
    """Vocab-chunked head: the product runs `step` vocab columns at a time
    into a preallocated f32 output, bounding transient memory to one
    [D, step] slice and one [..., step] product. The ragged last start is
    clamped to V - step, as JAX's dynamic_slice clamps it: the overlap
    columns are written twice with equal values."""
    h, w = _normed(params, hidden, eps)
    v = w.shape[1]
    step = min(step, v)
    out = torch.empty((*h.shape[:-1], v), dtype=torch.float32,
                      device=h.device)
    for i in range(-(-v // step)):
        start = min(i * step, v - step)
        out[..., start:start + step] = (
            h @ w[:, start:start + step].to(h.dtype)
        ).float()
    return out


def client_params_from_jax(tree: dict, dtype=None, device="cuda") -> dict:
    """The JAX client's {"embed", "norm", "lm_head"}, given as numpy arrays
    (f32, f16 or ml_dtypes bf16), as the port's tensors on `device`. Same
    layout (`lm_head` [D, V]). `dtype=None` keeps each array's dtype."""
    device = resolve_device(device)
    out = {}
    for name in ("embed", "norm", "lm_head"):
        arr = np.asarray(tree[name])
        want = dtype or _NP_NAMES[str(arr.dtype)]
        out[name] = torch.from_numpy(arr.astype(np.float32)).to(
            device=device, dtype=want
        )
    return out

"""Embed / final-norm + LM-head math of the client (port of
bloombee_tpu/models/head.py and client/model.py `_norm_head_chunked`:
RMSNorm or, for Bloom, LayerNorm with its bias as the final norm; Gemma's
embedding multiplier and final logit soft-cap; Bloom's embedding
LayerNorm).

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

from bloombee_tpu_torch.ops import layer_norm, rms_norm
from bloombee_tpu_torch.utils.device import resolve_device

# numpy dtype names of the JAX client's arrays (ml_dtypes names bf16
# "bfloat16") -> torch dtypes
_NP_NAMES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
}


def embed_impl(params: dict, input_ids: torch.Tensor,
               embedding_multiplier: float = 1.0,
               has_embed_norm: bool = False,
               eps: float = 1e-5) -> torch.Tensor:
    """Token ids -> hidden states, in the embed table's dtype (Gemma's
    multiplier applied in that dtype, as JAX applies a Python float;
    Bloom's `word_embeddings_layernorm`, `has_embed_norm`, computed in f32
    and cast back to it)."""
    h = params["embed"][input_ids]
    if embedding_multiplier != 1.0:
        h = h * embedding_multiplier
    if has_embed_norm:
        h = layer_norm(h, params["embed_norm"], params["embed_norm_bias"],
                       eps)
    return h


def _capped(logits: torch.Tensor, soft_cap: float) -> torch.Tensor:
    """The final logit soft-cap `tanh(l / c) * c` on the f32 logits."""
    return torch.tanh(logits / soft_cap) * soft_cap if soft_cap else logits


def _normed(params: dict, hidden: torch.Tensor, eps: float,
            norm_type: str):
    """The final norm's output (RMSNorm, or LayerNorm with `norm_bias`
    for an "ln" spec) and `lm_head`, in their promoted dtype."""
    if norm_type == "ln":
        h = layer_norm(hidden, params["norm"], params.get("norm_bias"), eps)
    else:
        h = rms_norm(hidden, params["norm"], eps)
    w = params["lm_head"]
    return h.to(torch.promote_types(h.dtype, w.dtype)), w


def norm_head_impl(
    params: dict, hidden: torch.Tensor, eps: float, soft_cap: float = 0.0,
    norm_type: str = "rms",
) -> torch.Tensor:
    """Final norm + LM head -> fp32 logits (optionally soft-capped)."""
    h, w = _normed(params, hidden, eps, norm_type)
    return _capped((h @ w.to(h.dtype)).float(), soft_cap)


def norm_head_chunked(
    params: dict, hidden: torch.Tensor, eps: float, soft_cap: float = 0.0,
    norm_type: str = "rms", step: int = 16384,
) -> torch.Tensor:
    """Vocab-chunked head: the product runs `step` vocab columns at a time
    into a preallocated f32 output, bounding transient memory to one
    [D, step] slice and one [..., step] product. The ragged last start is
    clamped to V - step, as JAX's dynamic_slice clamps it: the overlap
    columns are written twice with equal values. The soft-cap applies per
    slice (elementwise: the same values as on the whole output)."""
    h, w = _normed(params, hidden, eps, norm_type)
    v = w.shape[1]
    step = min(step, v)
    out = torch.empty((*h.shape[:-1], v), dtype=torch.float32,
                      device=h.device)
    for i in range(-(-v // step)):
        start = min(i * step, v - step)
        out[..., start:start + step] = _capped(
            (h @ w[:, start:start + step].to(h.dtype)).float(), soft_cap
        )
    return out


def client_params_from_jax(tree: dict, dtype=None, device="cuda") -> dict:
    """The JAX client's {"embed", "norm", "lm_head"} and, where the tree
    has them, Bloom's "embed_norm", "embed_norm_bias" and "norm_bias",
    given as numpy arrays (f32, f16 or ml_dtypes bf16), as the port's
    tensors on `device`. Same layout (`lm_head` [D, V]). `dtype=None` keeps
    each array's dtype."""
    device = resolve_device(device)
    out = {}
    extras = ("embed_norm", "embed_norm_bias", "norm_bias")
    for name in ("embed", "norm", "lm_head", *(k for k in extras
                                               if k in tree)):
        arr = np.asarray(tree[name])
        want = dtype or _NP_NAMES[str(arr.dtype)]
        out[name] = torch.from_numpy(arr.astype(np.float32)).to(
            device=device, dtype=want
        )
    return out

"""Mixture-of-experts MLP (Mixtral, Qwen3-MoE), port of
bloombee_tpu/ops/moe.py.

The experts are stacked weight tensors (`[E, D, I]` gate and up, `[E, I,
D]` down) and the layer runs dense over them, masked by the top-k router
weights, as the JAX package computes it. The products are plain matrix
products outside any kernel (`torch.matmul`), as the JAX package leaves
them to XLA. Dense over experts reads every expert's weights at every
batch size; a sparse top-k dispatch is later work (ROADMAP, after the
port's benchmark).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def router_topk_weights(
    logits: torch.Tensor,  # [..., E]
    top_k: int,
    pre_softmax: bool = False,
    norm_topk: bool = False,
) -> torch.Tensor:
    """Top-k router weights, zero off the selected experts, in the logits'
    dtype.

    pre_softmax=False: HF Mixtral semantics, mask to the top-k logits, then
    an f32 softmax over them. pre_softmax=True: HF Qwen3-MoE semantics, an
    f32 softmax over all experts, then the top-k, renormalised iff
    norm_topk. The selection keeps every expert at or above the k-th top
    value, so experts tied at that threshold are all kept, as in the JAX
    package: more than k can be selected."""
    if pre_softmax:
        probs = torch.softmax(logits.float(), dim=-1)
        thresh = torch.topk(probs, top_k, dim=-1).values[..., -1:]
        kept = torch.where(probs >= thresh, probs, 0.0)
        if norm_topk:
            kept = kept / kept.sum(dim=-1, keepdim=True).clamp_min(1e-20)
        return kept.to(logits.dtype)
    thresh = torch.topk(logits, top_k, dim=-1).values[..., -1:]
    neg = torch.finfo(torch.float32).min
    masked = torch.where(logits >= thresh, logits.float(), neg)
    return torch.softmax(masked, dim=-1).to(logits.dtype)


def moe_mlp(
    x: torch.Tensor,  # [..., D]
    router_w: torch.Tensor,  # [D, E]
    gate_w: torch.Tensor,  # [E, D, I]
    up_w: torch.Tensor,  # [E, D, I]
    down_w: torch.Tensor,  # [E, I, D]
    top_k: int,
    pre_softmax: bool = False,
    norm_topk: bool = False,
) -> torch.Tensor:
    """Dense-over-experts gated SiLU MLP weighted by the top-k router
    weights. The router logits are `x @ router_w` in x's dtype, as in JAX.

    Each expert's activations are weighted before the down product, so the
    expert sum is the K = E * I reduction of one matrix product and no
    `[..., E, D]` per-expert output is made (JAX weights after it; the two
    agree within f32 rounding)."""
    router_weights = router_topk_weights(
        x @ router_w, top_k, pre_softmax=pre_softmax, norm_topk=norm_topk
    )
    lead, d = x.shape[:-1], x.shape[-1]
    e, i, _ = down_w.shape
    rows = x.reshape(1, -1, d)  # broadcast over the experts
    h = F.silu(rows @ gate_w) * (rows @ up_w)  # [E, N, I]
    h = h * router_weights.reshape(-1, e).t()[:, :, None]
    h = h.transpose(0, 1).reshape(-1, e * i)  # [N, E * I]
    return (h @ down_w.reshape(e * i, d)).reshape(*lead, d)

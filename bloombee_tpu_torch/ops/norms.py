"""Normalization ops (port of bloombee_tpu/ops/norms.py).

HF Llama semantics: statistics in fp32, cast back to the input dtype, then
multiply by the weight.
"""

from __future__ import annotations

import torch


def layer_norm(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: torch.Tensor | None = None,
    eps: float = 1e-5,
) -> torch.Tensor:
    """Standard LayerNorm (Bloom/Falcon families), fp32 accumulation."""
    in_dtype = x.dtype
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = ((x32 - mean) ** 2).mean(dim=-1, keepdim=True)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    y = y * weight.float()
    if bias is not None:
        y = y + bias.float()
    return y.to(in_dtype)


def rms_norm(
    x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6
) -> torch.Tensor:
    """RMSNorm: normalize in fp32, cast back to the input dtype, then
    multiply by the (un-cast) weight — HF LlamaRMSNorm's order."""
    in_dtype = x.dtype
    x32 = x.float()
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return weight * y.to(in_dtype)

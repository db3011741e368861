"""Embed / final-norm + LM-head math of the client (port of
bloombee_tpu/models/head.py, Llama path)."""

from __future__ import annotations

import torch

from bloombee_tpu_torch.ops import rms_norm


def embed_impl(params: dict, input_ids: torch.Tensor) -> torch.Tensor:
    """Token ids -> hidden states, in the embed table's dtype."""
    return params["embed"][input_ids]


def norm_head_impl(
    params: dict, hidden: torch.Tensor, eps: float
) -> torch.Tensor:
    """Final RMSNorm + LM head -> fp32 logits."""
    h = rms_norm(hidden, params["norm"], eps)
    return (h @ params["lm_head"]).float()

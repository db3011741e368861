"""Attention ops (GQA, arbitrary boolean masks), port of
bloombee_tpu/ops/attention.py.

One masked implementation covers prefill (causal mask), decode (length mask)
and tree verify (tree mask): the mask is data. Logits and softmax are fp32;
probabilities are cast back to the input dtype before P.V, as in the JAX
version.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30


def repeat_kv(x: torch.Tensor, n_rep: int) -> torch.Tensor:
    """[B, S, Hkv, hd] -> [B, S, Hkv*n_rep, hd] (GQA share pattern)."""
    if n_rep == 1:
        return x
    b, s, h, d = x.shape
    return x[:, :, :, None, :].expand(b, s, h, n_rep, d).reshape(
        b, s, h * n_rep, d
    )


def masked_attention(
    q: torch.Tensor,  # [B, T, H, hd]
    k: torch.Tensor,  # [B, S, Hkv, hd]
    v: torch.Tensor,  # [B, S, Hkv, hd]
    mask: torch.Tensor,  # [B, T, S] bool (True = attend) or [B, 1, T, S]
    scale: float | None = None,
) -> torch.Tensor:
    """Full masked attention; returns [B, T, H, hd] in q.dtype."""
    n_rep = q.shape[2] // k.shape[2]
    k = repeat_kv(k, n_rep)
    v = repeat_kv(v, n_rep)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bthd,bshd->bhts", q, k).float() * scale
    if mask.ndim == 3:
        mask = mask[:, None, :, :]
    logits = logits.masked_fill(~mask, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhts,bshd->bthd", probs, v)


def causal_mask(
    t: int, offset: int = 0, s: int | None = None, device=None
) -> torch.Tensor:
    """[T, S] causal mask: query i (absolute position offset+i) sees keys
    at positions <= its own."""
    if s is None:
        s = offset + t
    q_pos = offset + torch.arange(t, device=device)[:, None]
    k_pos = torch.arange(s, device=device)[None, :]
    return k_pos <= q_pos

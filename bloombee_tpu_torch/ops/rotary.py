"""Rotary position embeddings (port of bloombee_tpu/ops/rotary.py).

Positions are explicit (no module state): the paged KV design and tree
verify steps need arbitrary per-token positions.
"""

from __future__ import annotations

import torch

# On the CPU, torch's first cos in a process, when it is split over several
# intra-op threads, is now and then up to ~1.5e-4 off; later calls are exact,
# and so is a first call on one thread (`scripts/torch_cpu_cos_first_call.py`
# reproduces it with torch alone). The tables are built after one-element
# (single-threaded) cos and sin calls, so every process gets the same ones.
_cpu_trig_settled = False


def _settle_cpu_trig() -> None:
    global _cpu_trig_settled
    if not _cpu_trig_settled:
        torch.cos(torch.zeros(1))
        torch.sin(torch.zeros(1))
        _cpu_trig_settled = True


def rotary_cos_sin(
    positions: torch.Tensor,  # [..., T] integer absolute positions
    head_dim: int,
    theta: float = 10000.0,
    dtype: torch.dtype = torch.float32,
) -> tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables for the given absolute positions; fp32 math like HF."""
    if positions.device.type == "cpu":
        _settle_cpu_trig()
    exponent = (
        torch.arange(0, head_dim, 2, dtype=torch.float32, device=positions.device)
        / head_dim
    )
    inv_freq = 1.0 / (theta**exponent)
    freqs = positions.float()[..., None] * inv_freq  # [..., T, hd/2]
    emb = torch.cat([freqs, freqs], dim=-1)  # [..., T, hd]
    return emb.cos().to(dtype), emb.sin().to(dtype)


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def apply_rotary(
    q: torch.Tensor,  # [B, T, H, hd]
    k: torch.Tensor,  # [B, T, Hkv, hd]
    cos: torch.Tensor,  # [B, T, hd]
    sin: torch.Tensor,  # [B, T, hd]
) -> tuple[torch.Tensor, torch.Tensor]:
    """Apply RoPE to q and k (head axis broadcast)."""
    cos = cos[:, :, None, :].to(q.dtype)
    sin = sin[:, :, None, :].to(q.dtype)
    q_out = q * cos + _rotate_half(q) * sin
    k_out = k * cos.to(k.dtype) + _rotate_half(k) * sin.to(k.dtype)
    return q_out, k_out

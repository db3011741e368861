"""Gated MLPs, port of bloombee_tpu/ops/mlp.py (SiLU / SwiGLU) and of the
gated tanh-GELU branch of bloombee_tpu/runtime/layer_body.py `_mlp`
(Gemma).

The projections are plain matrix products (`torch.matmul`), as the JAX
package leaves them to XLA.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def silu_mlp(
    x: torch.Tensor,
    gate_w: torch.Tensor,  # [D, I]
    up_w: torch.Tensor,  # [D, I]
    down_w: torch.Tensor,  # [I, D]
) -> torch.Tensor:
    return (F.silu(x @ gate_w) * (x @ up_w)) @ down_w


def gelu_tanh_mlp(
    x: torch.Tensor,
    gate_w: torch.Tensor,  # [D, I]
    up_w: torch.Tensor,  # [D, I]
    down_w: torch.Tensor,  # [I, D]
) -> torch.Tensor:
    """Gemma's MLP: `down(gelu_tanh(gate(x)) * up(x))`."""
    return (F.gelu(x @ gate_w, approximate="tanh") * (x @ up_w)) @ down_w

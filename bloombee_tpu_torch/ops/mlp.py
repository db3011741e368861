"""Gated MLP (SiLU / SwiGLU), port of bloombee_tpu/ops/mlp.py.

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

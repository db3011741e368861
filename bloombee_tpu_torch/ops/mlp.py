"""MLPs, port of bloombee_tpu/ops/mlp.py (SiLU / SwiGLU) and of the
tanh-GELU branches of bloombee_tpu/runtime/layer_body.py `_mlp`: gated
(Gemma) and plain 4h (Bloom; the exact-erf form is Falcon's).

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


def gelu_mlp(
    x: torch.Tensor,
    up_w: torch.Tensor,  # [D, I]
    down_w: torch.Tensor,  # [I, D]
    up_b: torch.Tensor | None = None,  # [I]
    down_b: torch.Tensor | None = None,  # [D]
    approximate: bool = True,
) -> torch.Tensor:
    """The plain (non-gated) MLP: `down(gelu(up(x)))`, each projection
    with its bias where given; GELU in its tanh form (`approximate`,
    Bloom's) or exact (erf, Falcon's)."""
    h = x @ up_w
    if up_b is not None:
        h = h + up_b
    h = F.gelu(h, approximate="tanh" if approximate else "none") @ down_w
    return h if down_b is None else h + down_b

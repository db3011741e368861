"""ALiBi attention biases (Bloom family; port of bloombee_tpu/ops/alibi.py).

HF Bloom's slope construction: powers of 2^(-8/n) for the largest power of
two n <= the head count, then the odd powers of the next base for the
heads past it (BLOOM-176B's 112 heads: 64 + 48). The bias added to the
logits is slopes[h] * key_position, the distance form up to a per-row
constant, which softmax ignores.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch


def alibi_slopes(n_heads: int) -> np.ndarray:
    closest = 2 ** math.floor(math.log2(n_heads))
    base = 2.0 ** (-(2.0 ** -(math.log2(closest) - 3)))
    slopes = [base ** (i + 1) for i in range(closest)]
    if closest != n_heads:
        extra_base = 2.0 ** (-(2.0 ** -(math.log2(2 * closest) - 3)))
        num_extra = min(closest, n_heads - closest)
        slopes.extend(extra_base ** (1 + 2 * i) for i in range(num_extra))
    return np.asarray(slopes, dtype=np.float32)


@functools.lru_cache(maxsize=None)
def slopes_on(n_heads: int, device: torch.device) -> torch.Tensor:
    """`alibi_slopes` as an f32 tensor on `device`, copied there once."""
    return torch.from_numpy(alibi_slopes(n_heads)).to(device)

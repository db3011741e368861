"""Core numeric ops: norms, rotary embeddings, ALiBi slopes (`ops.alibi`),
attention, the dense and mixture-of-experts MLPs (port of
bloombee_tpu/ops). The Pallas kernels' counterparts live in `ops/cuda`."""

from bloombee_tpu_torch.ops.attention import masked_attention, repeat_kv
from bloombee_tpu_torch.ops.mlp import gelu_mlp, gelu_tanh_mlp, silu_mlp
from bloombee_tpu_torch.ops.moe import moe_mlp
from bloombee_tpu_torch.ops.norms import layer_norm, rms_norm
from bloombee_tpu_torch.ops.rotary import apply_rotary, rotary_cos_sin

__all__ = [
    "rms_norm",
    "layer_norm",
    "apply_rotary",
    "rotary_cos_sin",
    "masked_attention",
    "repeat_kv",
    "silu_mlp",
    "gelu_tanh_mlp",
    "gelu_mlp",
    "moe_mlp",
]

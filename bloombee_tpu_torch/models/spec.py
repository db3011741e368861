"""ModelSpec: the static shape/hyperparameter description of a model family.

A copy of bloombee_tpu/models/spec.py (a frozen dataclass of primitives), so
both packages describe a model with the same fields and a spec built by one
compares field for field with the other's.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    family: str
    hidden_size: int
    intermediate_size: int
    num_attention_heads: int
    num_key_value_heads: int
    head_dim: int
    num_hidden_layers: int
    vocab_size: int
    rms_norm_eps: float = 1e-6
    rope_theta: float = 10000.0
    tie_word_embeddings: bool = False
    max_position_embeddings: int = 4096
    # MoE (Mixtral-style); 0 experts = dense MLP
    num_experts: int = 0
    num_experts_per_tok: int = 0
    moe_pre_softmax: bool = False
    moe_norm_topk: bool = False
    # Qwen3-style per-head q/k RMSNorm
    qk_norm: bool = False
    # Gemma-style sliding-window layers: pattern of layer types, e.g.
    # ("sliding", "sliding", "full", ...); empty = all full attention.
    layer_types: tuple[str, ...] = ()
    sliding_window: int = 0
    # Falcon/Bloom-style extras
    alibi: bool = False
    parallel_attn: bool = False
    num_ln_in_parallel_attn: int = 0
    attention_multiplier: float | None = None
    # Gemma-style logit soft-capping / embedding scaling
    logits_soft_cap: float = 0.0
    embedding_multiplier: float = 1.0
    # Per-layer rope theta override for sliding layers (Gemma3-style)
    rope_local_theta: float = 0.0
    # block structure knobs
    norm_type: str = "rms"  # "rms" | "ln"
    mlp_type: str = "silu"  # "silu" | "gelu" | "gelu_tanh_gated"
    sandwich_norms: bool = False
    attn_logit_softcap: float = 0.0
    # Gemma-4-style heterogeneous attention geometry
    global_head_dim: int = 0
    num_global_key_value_heads: int = 0
    k_eq_v_full: bool = False
    k_eq_v: bool = False

    def window_for_layer(self, layer_idx: int) -> int:
        return (
            self.sliding_window
            if self.layer_type(layer_idx) == "sliding"
            else 0
        )

    @property
    def gqa_groups(self) -> int:
        return self.num_attention_heads // self.num_key_value_heads

    def layer_type(self, layer_idx: int) -> str:
        if not self.layer_types:
            return "full"
        return self.layer_types[layer_idx % len(self.layer_types)]

    @property
    def heterogeneous(self) -> bool:
        """Layers differ in attention geometry (head_dim / kv heads)."""
        return bool(
            (self.global_head_dim and self.global_head_dim != self.head_dim)
            or (
                self.num_global_key_value_heads
                and self.num_global_key_value_heads
                != self.num_key_value_heads
            )
        )

    def theta_for_layer(self, layer_idx: int) -> float:
        """Sliding layers may use a local rope base (Gemma3 style)."""
        if self.layer_type(layer_idx) == "sliding" and self.rope_local_theta:
            return self.rope_local_theta
        return self.rope_theta

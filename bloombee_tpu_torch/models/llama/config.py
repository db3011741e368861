"""Llama family config mapping (port of bloombee_tpu/models/llama/config.py;
registered in `models.auto`)."""

from __future__ import annotations

from typing import Any

from bloombee_tpu_torch.models.spec import ModelSpec


def llama_spec_from_hf(config: Any) -> ModelSpec:
    head_dim = getattr(config, "head_dim", None) or (
        config.hidden_size // config.num_attention_heads
    )
    return ModelSpec(
        family="llama",
        hidden_size=config.hidden_size,
        intermediate_size=config.intermediate_size,
        num_attention_heads=config.num_attention_heads,
        num_key_value_heads=getattr(
            config, "num_key_value_heads", config.num_attention_heads
        ),
        head_dim=head_dim,
        num_hidden_layers=config.num_hidden_layers,
        vocab_size=config.vocab_size,
        rms_norm_eps=config.rms_norm_eps,
        rope_theta=getattr(config, "rope_theta", 10000.0),
        tie_word_embeddings=getattr(config, "tie_word_embeddings", False),
        max_position_embeddings=getattr(config, "max_position_embeddings", 4096),
    )


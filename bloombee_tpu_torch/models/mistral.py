"""Mistral family (port of bloombee_tpu/models/mistral.py): the Llama block
layout, with every layer sliding when config.sliding_window is set (each
query attends to at most `sliding_window` keys, itself included, as in
HF)."""

from __future__ import annotations

from typing import Any

from bloombee_tpu_torch.models.auto import Family, register_family
from bloombee_tpu_torch.models.llama.block import load_hf_block
from bloombee_tpu_torch.models.spec import ModelSpec


def mistral_spec_from_hf(config: Any) -> ModelSpec:
    sliding = getattr(config, "sliding_window", None)
    return ModelSpec(
        family="mistral",
        hidden_size=config.hidden_size,
        intermediate_size=config.intermediate_size,
        num_attention_heads=config.num_attention_heads,
        num_key_value_heads=config.num_key_value_heads,
        head_dim=getattr(config, "head_dim", None)
        or config.hidden_size // config.num_attention_heads,
        num_hidden_layers=config.num_hidden_layers,
        vocab_size=config.vocab_size,
        rms_norm_eps=config.rms_norm_eps,
        rope_theta=getattr(config, "rope_theta", 10000.0),
        tie_word_embeddings=getattr(config, "tie_word_embeddings", False),
        layer_types=("sliding",) if sliding else (),
        sliding_window=sliding or 0,
    )


register_family(Family("mistral", mistral_spec_from_hf, load_hf_block))

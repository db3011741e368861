"""Qwen3 family (port of the dense part of bloombee_tpu/models/qwen3.py):
the Llama block layout plus per-head q/k RMSNorm before rotary and an
explicit head_dim (Qwen3-4B: 128 against hidden / heads = 80). Qwen3-MoE
is refused by the registry (`models.auto.UNPORTED`)."""

from __future__ import annotations

from typing import Any

from bloombee_tpu_torch.models.auto import Family, register_family
from bloombee_tpu_torch.models.checkpoint import read_tensor
from bloombee_tpu_torch.models.llama.block import load_hf_block
from bloombee_tpu_torch.models.spec import ModelSpec


def qwen3_spec_from_hf(config: Any) -> ModelSpec:
    return ModelSpec(
        family="qwen3",
        hidden_size=config.hidden_size,
        intermediate_size=config.intermediate_size,
        num_attention_heads=config.num_attention_heads,
        num_key_value_heads=config.num_key_value_heads,
        head_dim=getattr(config, "head_dim", None)
        or config.hidden_size // config.num_attention_heads,
        num_hidden_layers=config.num_hidden_layers,
        vocab_size=config.vocab_size,
        rms_norm_eps=config.rms_norm_eps,
        rope_theta=getattr(config, "rope_theta", 1000000.0),
        tie_word_embeddings=getattr(config, "tie_word_embeddings", False),
        qk_norm=True,
    )


def _load_block(reader, layer_idx: int, dtype=None, device="cuda") -> dict:
    params = load_hf_block(reader, layer_idx, dtype=dtype, device=device)
    for name in ("q_norm", "k_norm"):
        params[name] = read_tensor(
            reader, f"model.layers.{layer_idx}.self_attn.{name}.weight",
            dtype, device,
        )
    return params


register_family(Family("qwen3", qwen3_spec_from_hf, _load_block))

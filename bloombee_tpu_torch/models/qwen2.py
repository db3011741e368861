"""Qwen2/Qwen2.5 family (port of bloombee_tpu/models/qwen2.py): the Llama
block layout plus the biased q/k/v projections Qwen2 adds, loaded when the
checkpoint has them (the layer body adds `{q,k,v}_bias` where present)."""

from __future__ import annotations

from typing import Any

from bloombee_tpu_torch.models.auto import Family, register_family
from bloombee_tpu_torch.models.checkpoint import read_tensor
from bloombee_tpu_torch.models.llama.block import load_hf_block
from bloombee_tpu_torch.models.spec import ModelSpec


def qwen2_spec_from_hf(config: Any) -> ModelSpec:
    if getattr(config, "use_sliding_window", False):
        # released Qwen2/2.5 checkpoints ship use_sliding_window=false; the
        # partial-depth variant (max_window_layers) is not mapped, as in
        # the JAX package
        raise NotImplementedError(
            "qwen2 with use_sliding_window=true is not supported yet"
        )
    return ModelSpec(
        family="qwen2",
        hidden_size=config.hidden_size,
        intermediate_size=config.intermediate_size,
        num_attention_heads=config.num_attention_heads,
        num_key_value_heads=config.num_key_value_heads,
        head_dim=getattr(config, "head_dim", None)
        or config.hidden_size // config.num_attention_heads,
        num_hidden_layers=config.num_hidden_layers,
        vocab_size=config.vocab_size,
        rms_norm_eps=config.rms_norm_eps,
        rope_theta=getattr(config, "rope_theta", 1_000_000.0),
        tie_word_embeddings=getattr(config, "tie_word_embeddings", False),
    )


def _load_block(reader, layer_idx: int, dtype=None, device="cuda") -> dict:
    params = load_hf_block(reader, layer_idx, dtype=dtype, device=device)
    for proj in ("q", "k", "v"):
        name = f"model.layers.{layer_idx}.self_attn.{proj}_proj.bias"
        if reader.has(name):
            params[f"{proj}_bias"] = read_tensor(reader, name, dtype, device)
    return params


register_family(Family("qwen2", qwen2_spec_from_hf, _load_block))

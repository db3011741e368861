"""Mixtral family (port of bloombee_tpu/models/mixtral.py): Llama-style
attention and a sparse mixture-of-experts MLP (`ops.moe`): the router
masks to the top-k logits, then takes a softmax over them.

The experts are stacked tensors, run dense over the experts as the JAX
package runs them (`models.checkpoint.load_moe_block` loads them).
"""

from __future__ import annotations

from typing import Any

from bloombee_tpu_torch.models.auto import Family, register_family
from bloombee_tpu_torch.models.checkpoint import load_moe_block
from bloombee_tpu_torch.models.spec import ModelSpec


def mixtral_spec_from_hf(config: Any) -> ModelSpec:
    return ModelSpec(
        family="mixtral",
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
        num_experts=config.num_local_experts,
        num_experts_per_tok=config.num_experts_per_tok,
    )


# the MoE MLP's HF names under the layer's prefix: the router, the
# experts' prefix, and each expert's gate, up and down matrix
HF_MOE_KEYS = ("block_sparse_moe.gate", "block_sparse_moe.experts",
               ("w1", "w3", "w2"))


def _load_block(reader, layer_idx: int, dtype=None, device="cuda") -> dict:
    return load_moe_block(reader, layer_idx, HF_MOE_KEYS, dtype, device)


register_family(Family("mixtral", mixtral_spec_from_hf, _load_block,
                       moe_keys=HF_MOE_KEYS))

"""Qwen3 and Qwen3-MoE families (port of bloombee_tpu/models/qwen3.py):
the Llama block layout plus per-head q/k RMSNorm before rotary and an
explicit head_dim (Qwen3-4B: 128 against hidden / heads = 80). Qwen3-MoE
replaces the MLP with a mixture of experts (`ops.moe`) whose router takes
a softmax over all experts, then the top-k, renormalised iff
`norm_topk_prob`."""

from __future__ import annotations

import dataclasses
from typing import Any

from bloombee_tpu_torch.models.auto import Family, register_family
from bloombee_tpu_torch.models.checkpoint import load_moe_block, read_tensor
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


def _add_qk_norms(params: dict, reader, layer_idx: int, dtype,
                  device) -> dict:
    for name in ("q_norm", "k_norm"):
        params[name] = read_tensor(
            reader, f"model.layers.{layer_idx}.self_attn.{name}.weight",
            dtype, device,
        )
    return params


def _load_block(reader, layer_idx: int, dtype=None, device="cuda") -> dict:
    params = load_hf_block(reader, layer_idx, dtype=dtype, device=device)
    return _add_qk_norms(params, reader, layer_idx, dtype, device)


register_family(Family("qwen3", qwen3_spec_from_hf, _load_block))


# ---------------------------------------------------------------- qwen3-moe
def qwen3_moe_spec_from_hf(config: Any) -> ModelSpec:
    """Qwen3 attention (q/k norms) and the MoE MLP. The router's softmax
    runs over all experts before the top-k (HF Qwen3MoeSparseMoeBlock),
    unlike Mixtral's mask-then-softmax. Checkpoints whose dense layers
    interleave with the sparse ones are refused, as the JAX package
    refuses them."""
    if getattr(config, "mlp_only_layers", None) or getattr(
        config, "decoder_sparse_step", 1
    ) != 1:
        raise NotImplementedError(
            "qwen3-moe with dense interleaved layers (mlp_only_layers / "
            "decoder_sparse_step != 1) is not supported yet"
        )
    return dataclasses.replace(
        qwen3_spec_from_hf(config),
        family="qwen3_moe",
        intermediate_size=config.moe_intermediate_size,
        num_experts=config.num_experts,
        num_experts_per_tok=config.num_experts_per_tok,
        moe_pre_softmax=True,
        moe_norm_topk=bool(getattr(config, "norm_topk_prob", False)),
    )


# the MoE MLP's HF names (`mixtral.HF_MOE_KEYS`' layout)
HF_MOE_KEYS = ("mlp.gate", "mlp.experts", ("gate_proj", "up_proj",
                                           "down_proj"))


def _load_block_moe(reader, layer_idx: int, dtype=None,
                    device="cuda") -> dict:
    params = load_moe_block(reader, layer_idx, HF_MOE_KEYS, dtype, device)
    return _add_qk_norms(params, reader, layer_idx, dtype, device)


register_family(Family("qwen3_moe", qwen3_moe_spec_from_hf,
                       _load_block_moe, moe_keys=HF_MOE_KEYS))

"""Falcon family (port of bloombee_tpu/models/falcon.py): rotary attention
with multi-query or grouped K/V heads, LayerNorm with biases, the parallel
residual `hidden + attn + mlp(x_mlp)` (`models.llama.block.finish_layer`),
bias-free projections and the plain 4h exact-GELU MLP.

Two layouts of the fused `query_key_value` weight:
- Falcon-7B (`multi_query`): rows [H query heads | n_kv k | n_kv v], one
  input LayerNorm feeding attention and the MLP alike;
- the new decoder architecture (Falcon-40B/180B): rows grouped per KV
  head, [n_rep q | 1 k | 1 v] each, and usually two LayerNorms, `ln_attn`
  for attention (stored as `input_layernorm`) and `ln_mlp` for the MLP
  (`mlp_layernorm`).
The loader splits it into q/k/v projections stored [in, out], as the layer
body takes them. The head is `lm_head` where the checkpoint has one, else
the embedding's transpose, a view. falcon-rw (ALiBi, biased projections)
is refused, as in the JAX package.
"""

from __future__ import annotations

from typing import Any

from bloombee_tpu_torch.models.auto import Family, register_family
from bloombee_tpu_torch.models.checkpoint import read_tensor
from bloombee_tpu_torch.models.spec import ModelSpec


def falcon_spec_from_hf(config: Any) -> ModelSpec:
    n_head = config.num_attention_heads
    hidden = config.hidden_size
    if getattr(config, "alibi", False) or getattr(config, "bias", False):
        raise NotImplementedError(
            "falcon-rw variants (alibi/bias) are not supported yet"
        )
    new_arch = bool(getattr(config, "new_decoder_architecture", False))
    if new_arch:
        n_kv = getattr(config, "num_kv_heads", None) or n_head
        n_ln = getattr(config, "num_ln_in_parallel_attn", None)
        if n_ln is None:
            n_ln = 2
    else:
        n_kv = 1 if getattr(config, "multi_query", True) else n_head
        n_ln = 1
    return ModelSpec(
        family="falcon",
        hidden_size=hidden,
        intermediate_size=4 * hidden,
        num_attention_heads=n_head,
        num_key_value_heads=n_kv,
        head_dim=hidden // n_head,
        num_hidden_layers=config.num_hidden_layers,
        vocab_size=config.vocab_size,
        rms_norm_eps=getattr(config, "layer_norm_epsilon", 1e-5),
        rope_theta=getattr(config, "rope_theta", 10000.0),
        tie_word_embeddings=True,
        norm_type="ln",
        mlp_type="gelu",
        parallel_attn=getattr(config, "parallel_attn", True) or new_arch,
        num_ln_in_parallel_attn=n_ln,
        alibi=getattr(config, "alibi", False),
    )


def _load_block(reader, layer_idx: int, dtype=None, device="cuda") -> dict:
    p = f"transformer.h.{layer_idx}"
    config = reader.config
    n_head = config["num_attention_heads"]
    d = config["hidden_size"]
    hd = d // n_head

    def t(name):
        return read_tensor(reader, f"{p}.{name}", dtype, device)

    def proj(w):  # rows [out, D] -> [D, out]
        return w.reshape(-1, d).t().contiguous()

    params = {}
    if reader.has(f"{p}.ln_attn.weight"):
        for key, hf in (("input_layernorm", "ln_attn"),
                        ("mlp_layernorm", "ln_mlp")):
            params[key] = t(f"{hf}.weight")
            params[f"{key}_bias"] = t(f"{hf}.bias")
    else:
        params["input_layernorm"] = t("input_layernorm.weight")
        params["input_layernorm_bias"] = t("input_layernorm.bias")
    w = t("self_attention.query_key_value.weight")
    if config.get("new_decoder_architecture", False):
        # per KV group: [n_rep q rows | 1 k row | 1 v row] of hd each
        n_kv = config.get("num_kv_heads") or n_head
        grouped = w.reshape(n_kv, n_head // n_kv + 2, hd, d)
        params["q_proj"] = proj(grouped[:, :-2])
        params["k_proj"] = proj(grouped[:, -2])
        params["v_proj"] = proj(grouped[:, -1])
    else:
        n_kv = 1 if config.get("multi_query", True) else n_head
        q_rows, kv_rows = n_head * hd, n_kv * hd
        params["q_proj"] = proj(w[:q_rows])
        params["k_proj"] = proj(w[q_rows:q_rows + kv_rows])
        params["v_proj"] = proj(w[q_rows + kv_rows:])
    del w
    for key, hf in (("o", "self_attention.dense"),
                    ("up", "mlp.dense_h_to_4h"),
                    ("down", "mlp.dense_4h_to_h")):
        params[f"{key}_proj"] = t(f"{hf}.weight").t().contiguous()
    return params


def _load_client(reader, dtype=None, device="cuda") -> dict:
    def t(name):
        return read_tensor(reader, name, dtype, device)

    embed = t("transformer.word_embeddings.weight")
    return {
        "embed": embed,
        "norm": t("transformer.ln_f.weight"),
        "norm_bias": t("transformer.ln_f.bias"),
        "lm_head": (t("lm_head.weight").t().contiguous()
                    if reader.has("lm_head.weight") else embed.t()),
    }


register_family(
    Family("falcon", falcon_spec_from_hf, _load_block,
           client_loader=_load_client,
           client_extras=("norm_bias",))
)

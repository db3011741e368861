"""Bloom family (port of bloombee_tpu/models/bloom.py): ALiBi attention in
place of rotary, LayerNorm with biases (the blocks, the embedding's
`word_embeddings_layernorm` and the final `ln_f`), every projection biased,
the plain 4h tanh-GELU MLP and a tied head.

The checkpoint's fused `query_key_value` weight holds its rows per head as
[q (hd), k (hd), v (hd)]; the loader splits it into q/k/v projections (and
their biases) stored [in, out], as the layer body takes them. Checkpoints
name their tensors with or without a `transformer.` prefix (HF's
`BloomForCausalLM` writes it; the hub's BLOOM checkpoints do not). The
head is the embedding's transpose, a view: no second copy of the
embedding (7.19 GB in bf16 at BLOOM-176B's width).
"""

from __future__ import annotations

from typing import Any

from bloombee_tpu_torch.models.auto import Family, register_family
from bloombee_tpu_torch.models.checkpoint import read_tensor
from bloombee_tpu_torch.models.spec import ModelSpec


def bloom_spec_from_hf(config: Any) -> ModelSpec:
    n_head = getattr(config, "n_head", None) or config.num_attention_heads
    hidden = config.hidden_size
    return ModelSpec(
        family="bloom",
        hidden_size=hidden,
        intermediate_size=4 * hidden,
        num_attention_heads=n_head,
        num_key_value_heads=n_head,
        head_dim=hidden // n_head,
        num_hidden_layers=getattr(config, "n_layer", None)
        or config.num_hidden_layers,
        vocab_size=config.vocab_size,
        rms_norm_eps=getattr(config, "layer_norm_epsilon", 1e-5),
        tie_word_embeddings=True,
        alibi=True,
        norm_type="ln",
        mlp_type="gelu_tanh",
    )


def _load_block(reader, layer_idx: int, dtype=None, device="cuda") -> dict:
    p = f"h.{layer_idx}"
    if not reader.has(f"{p}.input_layernorm.weight"):
        p = f"transformer.{p}"

    def t(name):
        return read_tensor(reader, f"{p}.{name}", dtype, device)

    params = {}
    for ln in ("input_layernorm", "post_attention_layernorm"):
        params[ln] = t(f"{ln}.weight")
        params[f"{ln}_bias"] = t(f"{ln}.bias")
    w = t("self_attention.query_key_value.weight")  # [3 H hd, D]
    b = t("self_attention.query_key_value.bias")
    d = w.shape[1]
    n_head = reader.config.get("n_head") or reader.config.get(
        "num_attention_heads"
    )
    hd = d // n_head
    w4 = w.reshape(n_head, 3, hd, d)
    b4 = b.reshape(n_head, 3, hd)
    for i, name in enumerate("qkv"):
        params[f"{name}_proj"] = (
            w4[:, i].reshape(n_head * hd, d).t().contiguous()
        )
        params[f"{name}_bias"] = b4[:, i].reshape(-1).contiguous()
    del w, w4
    for key, hf in (("o", "self_attention.dense"),
                    ("up", "mlp.dense_h_to_4h"),
                    ("down", "mlp.dense_4h_to_h")):
        params[f"{key}_proj"] = t(f"{hf}.weight").t().contiguous()
        params[f"{key}_bias"] = t(f"{hf}.bias")
    return params


def _load_client(reader, dtype=None, device="cuda") -> dict:
    pref = "" if reader.has("word_embeddings.weight") else "transformer."

    def t(name):
        return read_tensor(reader, f"{pref}{name}", dtype, device)

    embed = t("word_embeddings.weight")
    return {
        "embed": embed,
        "embed_norm": t("word_embeddings_layernorm.weight"),
        "embed_norm_bias": t("word_embeddings_layernorm.bias"),
        "norm": t("ln_f.weight"),
        "norm_bias": t("ln_f.bias"),
        "lm_head": embed.t(),  # tied
    }


register_family(
    Family("bloom", bloom_spec_from_hf, _load_block,
           client_loader=_load_client,
           client_extras=("embed_norm", "embed_norm_bias", "norm_bias"))
)

"""Gemma2 and Gemma3 families (port of bloombee_tpu/models/gemma2.py):
sandwich norms, alternating sliding-window layers, the gated tanh-GELU
MLP, the attention and final logit soft-caps (Gemma2), per-head q/k norms
and a local rope base on the sliding layers (Gemma3), and the sqrt(D)
embedding multiplier.

Gemma's RMSNorm weights are stored as w with output x_norm * (1 + w); the
loaders store them as (1 + w), in the load dtype as the JAX loaders add
them, so the shared `rms_norm` applies. The head is tied: `lm_head` is the
embedding's transpose (a view, no copy).
"""

from __future__ import annotations

import dataclasses
import math
from types import SimpleNamespace
from typing import Any

from bloombee_tpu_torch.models.auto import Family, register_family
from bloombee_tpu_torch.models.checkpoint import read_tensor
from bloombee_tpu_torch.models.spec import ModelSpec
from bloombee_tpu_torch.utils.device import resolve_device

_NORMS = (
    "input_layernorm",
    "post_attention_layernorm",
    "pre_feedforward_layernorm",
    "post_feedforward_layernorm",
)


def gemma2_spec_from_hf(config: Any) -> ModelSpec:
    layer_types = getattr(config, "layer_types", None)
    if layer_types:
        pattern = tuple(
            "sliding" if "sliding" in t else "full" for t in layer_types
        )
    else:
        # HF Gemma2: even layers sliding, odd layers full
        pattern = ("sliding", "full")
    return ModelSpec(
        family="gemma2",
        hidden_size=config.hidden_size,
        intermediate_size=config.intermediate_size,
        num_attention_heads=config.num_attention_heads,
        num_key_value_heads=config.num_key_value_heads,
        head_dim=config.head_dim,
        num_hidden_layers=config.num_hidden_layers,
        vocab_size=config.vocab_size,
        rms_norm_eps=config.rms_norm_eps,
        rope_theta=getattr(config, "rope_theta", 10000.0),
        tie_word_embeddings=True,
        layer_types=pattern,
        sliding_window=getattr(config, "sliding_window", 4096),
        attention_multiplier=getattr(config, "query_pre_attn_scalar", None)
        and getattr(config, "query_pre_attn_scalar") ** -0.5,
        logits_soft_cap=getattr(config, "final_logit_softcapping", 0.0) or 0.0,
        attn_logit_softcap=getattr(config, "attn_logit_softcapping", 0.0)
        or 0.0,
        embedding_multiplier=math.sqrt(config.hidden_size),
        mlp_type="gelu_tanh_gated",
        sandwich_norms=True,
    )


def gemma3_spec_from_hf(config: Any) -> ModelSpec:
    """Gemma3's text tower: Gemma2's structure plus per-head q/k norms, no
    soft-caps, and the sliding layers roped with rope_local_base_freq.
    Multimodal bundles nest the tower under text_config."""
    text = getattr(config, "text_config", None)
    if text is not None:
        config = SimpleNamespace(**text) if isinstance(text, dict) else text
    return dataclasses.replace(
        gemma2_spec_from_hf(config),
        family="gemma3",
        qk_norm=True,
        logits_soft_cap=0.0,
        attn_logit_softcap=0.0,
        rope_theta=getattr(config, "rope_theta", 1_000_000.0),
        rope_local_theta=getattr(config, "rope_local_base_freq", 10_000.0),
        sliding_window=getattr(config, "sliding_window", 512),
    )


def _prefix(reader) -> str:
    """Text-only checkpoints use model.*; multimodal Gemma3 bundles nest
    the tower under language_model.model.*."""
    if reader.has("model.embed_tokens.weight"):
        return "model"
    return "language_model.model"


def _norm(reader, name, dtype, device):
    return 1.0 + read_tensor(reader, name, dtype, device)


def _load_block(reader, layer_idx: int, dtype=None, device="cuda",
                qk_norm: bool = False) -> dict:
    p = f"{_prefix(reader)}.layers.{layer_idx}"
    params = {ln: _norm(reader, f"{p}.{ln}.weight", dtype, device)
              for ln in _NORMS}
    for proj, sub in (("q", "self_attn"), ("k", "self_attn"),
                      ("v", "self_attn"), ("o", "self_attn"),
                      ("gate", "mlp"), ("up", "mlp"), ("down", "mlp")):
        w = reader.tensor(f"{p}.{sub}.{proj}_proj.weight").t()
        params[f"{proj}_proj"] = w.to(
            device=resolve_device(device), dtype=dtype
        ).contiguous()
    if qk_norm:
        for name in ("q_norm", "k_norm"):
            params[name] = _norm(reader, f"{p}.self_attn.{name}.weight",
                                 dtype, device)
    return params


def _load_block_gemma3(reader, layer_idx: int, dtype=None,
                       device="cuda") -> dict:
    return _load_block(reader, layer_idx, dtype, device, qk_norm=True)


def _load_client(reader, dtype=None, device="cuda") -> dict:
    base = _prefix(reader)
    embed = read_tensor(reader, f"{base}.embed_tokens.weight", dtype, device)
    return {
        "embed": embed,
        "norm": _norm(reader, f"{base}.norm.weight", dtype, device),
        "lm_head": embed.t(),
    }


register_family(
    Family("gemma2", gemma2_spec_from_hf, _load_block,
           client_loader=_load_client)
)
for _name in ("gemma3", "gemma3_text"):
    register_family(
        Family(_name, gemma3_spec_from_hf, _load_block_gemma3,
               client_loader=_load_client)
    )

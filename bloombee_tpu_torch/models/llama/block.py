"""The Llama-structured transformer block as a plain function (port of
bloombee_tpu/models/llama/block.py), shared by the families the port
serves: Mistral (the same block), Qwen2 (biased q/k/v projections), Qwen3
(per-head q/k RMSNorm before rotary), Gemma2/Gemma3 (sandwich norms
around attention and the gated tanh-GELU MLP, q/k norms on Gemma3),
Mixtral/Qwen3-MoE (the mixture-of-experts MLP, `ops.moe`, in place of the
dense one), Bloom (LayerNorm with biases, every projection biased, no
rotary: its ALiBi bias lives in the attention routes, and the plain 4h
tanh-GELU MLP) and Falcon (LayerNorm with biases, the parallel residual:
attention and the plain 4h exact-GELU MLP both read the layer's input,
through one norm or, with `mlp_layernorm`, two). The family extras are
optional parameter keys, `{q,k,v,o,up,down}_bias`, `{norm}_bias` and
`q_norm`/`k_norm`, applied where present, and spec switches
(`norm_type`, `alibi`, `sandwich_norms`, `parallel_attn`, `mlp_type`,
`num_experts`), as the JAX package's family-generic layer body applies
them. An MoE layer holds `router` [D, E], `experts_gate`/
`experts_up` [E, D, I] and `experts_down` [E, I, D] instead of
`gate_proj`/`up_proj`/`down_proj`; a plain-MLP layer has no `gate_proj`.

Weight convention (kept from the JAX package): projection matrices are
stored [in_features, out_features] and applied as `x @ w`, the transpose of
torch `nn.Linear`. Converting JAX parameters is therefore a dtype/device
copy with nothing transposed.
"""

from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch

from bloombee_tpu_torch.models.spec import ModelSpec
from bloombee_tpu_torch.ops import apply_rotary, masked_attention, rms_norm
from bloombee_tpu_torch.ops import gelu_mlp, gelu_tanh_mlp, moe_mlp, silu_mlp
from bloombee_tpu_torch.ops import layer_norm
from bloombee_tpu_torch.ops.attention import causal_mask
from bloombee_tpu_torch.utils.device import resolve_device

# attend(q, k_new, v_new) -> (attn_out, aux); shapes
#   q: [B, T, H, hd], k_new/v_new: [B, T, Hkv, hd], attn_out: [B, T, H, hd]
Attend = Callable[
    [torch.Tensor, torch.Tensor, torch.Tensor], tuple[torch.Tensor, Any]
]


def init_block_params(
    generator: torch.Generator,
    spec: ModelSpec,
    dtype=torch.float32,
    device="cuda",
) -> dict:
    """Random block parameters: N(0, 1/D) projections (drawn in f32 on the
    generator's device), unit norms. The generator must live on `device`.
    An MoE spec draws the router and the stacked experts after the
    attention projections, in place of the dense MLP; a plain-MLP spec
    (Bloom) draws no gate. A Qwen2 spec also gets N(0, 1) q/k/v biases, a
    `qk_norm` spec unit q/k norms, a `sandwich_norms` spec unit pre- and
    post-feedforward norms and a LayerNorm spec biases of standard
    deviation 0.1 on both norms and every projection, made after the
    Llama keys so a Llama spec's draws stay as they were. A parallel
    (Falcon) spec has no post-attention norm and bias-free projections:
    of the biases it draws the input LayerNorm's, and with two norms
    `mlp_layernorm` (unit) and its bias last."""
    device = resolve_device(device)
    d, i = spec.hidden_size, spec.intermediate_size
    h, kv, hd = spec.num_attention_heads, spec.num_key_value_heads, spec.head_dim
    scale = d**-0.5

    def w(shape, s=scale):
        x = torch.randn(
            shape, generator=generator, device=device, dtype=torch.float32
        )
        return (x * s).to(dtype)

    params = {
        "input_layernorm": torch.ones((d,), dtype=dtype, device=device),
        "post_attention_layernorm": torch.ones((d,), dtype=dtype, device=device),
        "q_proj": w((d, h * hd)),
        "k_proj": w((d, kv * hd)),
        "v_proj": w((d, kv * hd)),
        "o_proj": w((h * hd, d)),
    }
    e = spec.num_experts
    if e:
        params["router"] = w((d, e))
        params["experts_gate"] = w((e, d, i))
        params["experts_up"] = w((e, d, i))
        params["experts_down"] = w((e, i, d))
    else:
        if _gated(spec):
            params["gate_proj"] = w((d, i))
        params["up_proj"] = w((d, i))
        params["down_proj"] = w((i, d))
    if spec.family == "qwen2":
        for name, n in (("q", h * hd), ("k", kv * hd), ("v", kv * hd)):
            params[f"{name}_bias"] = w((n,), 1.0)
    if spec.qk_norm:
        for name in ("q_norm", "k_norm"):
            params[name] = torch.ones((hd,), dtype=dtype, device=device)
    if spec.sandwich_norms:
        for name in ("pre_feedforward_layernorm",
                     "post_feedforward_layernorm"):
            params[name] = torch.ones((d,), dtype=dtype, device=device)
    if spec.parallel_attn:  # Falcon: bias-free projections
        del params["post_attention_layernorm"]
        params["input_layernorm_bias"] = w((d,), 0.1)
        if spec.num_ln_in_parallel_attn == 2:
            params["mlp_layernorm"] = torch.ones((d,), dtype=dtype,
                                                 device=device)
            params["mlp_layernorm_bias"] = w((d,), 0.1)
    elif spec.norm_type == "ln":
        for name, n in (("input_layernorm_bias", d),
                        ("post_attention_layernorm_bias", d),
                        ("q_bias", h * hd), ("k_bias", kv * hd),
                        ("v_bias", kv * hd), ("o_bias", d), ("up_bias", i),
                        ("down_bias", d)):
            params[name] = w((n,), 0.1)
    return params


def _gated(spec: ModelSpec) -> bool:
    return spec.mlp_type in ("silu", "gelu_tanh_gated")


def norm(x: torch.Tensor, params: dict, key: str,
         spec: ModelSpec) -> torch.Tensor:
    """The layer's norm `key`: LayerNorm with `{key}_bias` where the layer
    has one for a LayerNorm spec (Bloom), else RMSNorm (JAX `_norm`)."""
    if spec.norm_type == "ln":
        return layer_norm(x, params[key], params.get(f"{key}_bias"),
                          spec.rms_norm_eps)
    return rms_norm(x, params[key], spec.rms_norm_eps)


def proj(x: torch.Tensor, params: dict, key: str) -> torch.Tensor:
    """`x @ params[key]`, plus the projection's bias where the layer has
    one (`q_proj` -> `q_bias`)."""
    y = x @ params[key]
    b = params.get(f"{key.removesuffix('_proj')}_bias")
    return y if b is None else y + b


def attention_inputs(
    params: dict,
    spec: ModelSpec,
    x: torch.Tensor,  # [..., T, D] normed input
    cos: torch.Tensor,
    sin: torch.Tensor,
):
    """q [..., T, H, hd] and k, v [..., T, Hkv, hd] of a layer: the
    (biased) projections, Qwen3's per-head q/k RMSNorm, then rotary on q
    and k (none for an ALiBi spec: its position bias is added to the
    attention logits)."""
    lead = x.shape[:-1]
    q = proj(x, params, "q_proj").reshape(
        *lead, spec.num_attention_heads, spec.head_dim
    )
    k = proj(x, params, "k_proj").reshape(
        *lead, spec.num_key_value_heads, spec.head_dim
    )
    v = proj(x, params, "v_proj").reshape(
        *lead, spec.num_key_value_heads, spec.head_dim
    )
    if spec.qk_norm:
        q = rms_norm(q, params["q_norm"], spec.rms_norm_eps)
        k = rms_norm(k, params["k_norm"], spec.rms_norm_eps)
    if not spec.alibi:
        q, k = apply_rotary(q, k, cos, sin)
    return q, k, v


def block_forward(
    params: dict,
    spec: ModelSpec,
    hidden: torch.Tensor,  # [B, T, D]
    cos: torch.Tensor,  # [B, T, hd]
    sin: torch.Tensor,  # [B, T, hd]
    attend: Attend,
) -> tuple[torch.Tensor, Any]:
    b, t, _ = hidden.shape
    x = norm(hidden, params, "input_layernorm", spec)
    q, k, v = attention_inputs(params, spec, x, cos, sin)

    attn_out, aux = attend(q, k, v)

    attn_out = proj(attn_out.reshape(b, t, -1), params, "o_proj")
    return finish_layer(params, spec, hidden, x, attn_out), aux


def mlp(params: dict, spec: ModelSpec, x: torch.Tensor) -> torch.Tensor:
    """The layer's MLP (JAX `_mlp`): the mixture of experts when the spec
    has experts, else the gated SiLU or Gemma's gated tanh-GELU, or the
    plain 4h GELU with biases ("gelu_tanh": Bloom's tanh form; "gelu":
    exact)."""
    if spec.num_experts:
        return moe_mlp(
            x, params["router"], params["experts_gate"],
            params["experts_up"], params["experts_down"],
            spec.num_experts_per_tok, pre_softmax=spec.moe_pre_softmax,
            norm_topk=spec.moe_norm_topk,
        )
    if not _gated(spec):
        return gelu_mlp(x, params["up_proj"], params["down_proj"],
                        params.get("up_bias"), params.get("down_bias"),
                        approximate=spec.mlp_type != "gelu")
    fn = gelu_tanh_mlp if spec.mlp_type == "gelu_tanh_gated" else silu_mlp
    return fn(x, params["gate_proj"], params["up_proj"], params["down_proj"])


def finish_layer(
    params: dict,
    spec: ModelSpec,
    hidden: torch.Tensor,  # [..., D] the layer's input
    x: torch.Tensor,  # [..., D] the attention input's norm of it
    attn_out: torch.Tensor,  # [..., D] after o_proj
) -> torch.Tensor:
    """Residual + MLP tail of every attention route (JAX `_finish_layer`).
    Llama and Bloom: hidden + attn, then the post-attention norm and the
    MLP. Gemma's sandwich: the post-attention norm on the attention output
    before the residual, the pre- and post-feedforward norms around the
    MLP. Falcon's parallel residual: hidden + attn + the MLP of `x` (one
    norm, Falcon-7B) or of the layer's `mlp_layernorm` (two, Falcon-40B
    and 180B)."""
    if spec.parallel_attn:
        if spec.num_ln_in_parallel_attn == 2:
            x = norm(hidden, params, "mlp_layernorm", spec)
        return hidden + attn_out + mlp(params, spec, x)
    if spec.sandwich_norms:
        hidden = hidden + norm(attn_out, params, "post_attention_layernorm",
                               spec)
        x = norm(hidden, params, "pre_feedforward_layernorm", spec)
        return hidden + norm(mlp(params, spec, x), params,
                             "post_feedforward_layernorm", spec)
    hidden = hidden + attn_out
    x = norm(hidden, params, "post_attention_layernorm", spec)
    return hidden + mlp(params, spec, x)


def dense_attend(
    past_k: torch.Tensor | None = None,  # [B, S_past, Hkv, hd]
    past_v: torch.Tensor | None = None,
) -> Attend:
    """Plain causal attention with an optional dense concatenated past: the
    local reference the paged serving path is held against."""

    def attend(q, k, v):
        if past_k is not None:
            k_all = torch.cat([past_k, k], dim=1)
            v_all = torch.cat([past_v, v], dim=1)
        else:
            k_all, v_all = k, v
        t, s = q.shape[1], k_all.shape[1]
        mask = causal_mask(t, offset=s - t, s=s, device=q.device)[None]
        return masked_attention(q, k_all, v_all, mask), (k_all, v_all)

    return attend


# HF checkpoint key mapping: per-layer torch name -> (our name, transpose?);
# the norms and attention projections every family here shares, then the
# dense MLP
HF_ATTENTION_KEYS = {
    "input_layernorm.weight": ("input_layernorm", False),
    "post_attention_layernorm.weight": ("post_attention_layernorm", False),
    "self_attn.q_proj.weight": ("q_proj", True),
    "self_attn.k_proj.weight": ("k_proj", True),
    "self_attn.v_proj.weight": ("v_proj", True),
    "self_attn.o_proj.weight": ("o_proj", True),
}
HF_BLOCK_KEYS = {
    **HF_ATTENTION_KEYS,
    "mlp.gate_proj.weight": ("gate_proj", True),
    "mlp.up_proj.weight": ("up_proj", True),
    "mlp.down_proj.weight": ("down_proj", True),
}


def convert_hf_block_params(
    tensors: dict, dtype=None, device="cuda", keys=HF_BLOCK_KEYS
) -> dict:
    """One decoder layer's HF tensors (suffix-keyed) to the port's dict,
    projections transposed to [in, out]."""
    device = resolve_device(device)
    out = {}
    for hf_key, (name, transpose) in keys.items():
        w = torch.as_tensor(tensors[hf_key])
        if transpose:
            w = w.t()
        out[name] = w.to(device=device, dtype=dtype).contiguous()
    return out


def load_hf_block(reader, layer_idx: int, dtype=None, device="cuda",
                  keys=HF_BLOCK_KEYS) -> dict:
    """Layer `layer_idx` of a checkpoint (`models.checkpoint.
    CheckpointReader`) in the Llama layout: the Llama family's loader, and
    the base of the other Llama-like families' loaders (the MoE families'
    `checkpoint.load_moe_block` reads `HF_ATTENTION_KEYS` and adds the
    experts)."""
    prefix = f"model.layers.{layer_idx}"
    tensors = {k: reader.tensor(f"{prefix}.{k}") for k in keys}
    return convert_hf_block_params(tensors, dtype=dtype, device=device,
                                   keys=keys)


def params_from_jax(tree, dtype=None, device="cuda") -> list[dict]:
    """The JAX package's block parameters, given as numpy arrays — a list of
    per-layer dicts, or one dict stacked with a leading L — as the port's
    list of per-layer dicts of tensors. Same [in, out] layout: a copy of
    every key, the family extras (`{q,k,v}_bias`, `q_norm`/`k_norm`, the
    Gemma norms, an MoE layer's router and stacked experts, `[L, E, ...]`
    when stacked) and Bloom's norm and projection biases included."""
    device = resolve_device(device)

    def conv(x):
        t = torch.from_numpy(np.array(x, dtype=np.float32))
        return t.to(device=device, dtype=dtype or torch.float32)

    if isinstance(tree, dict):
        n = len(next(iter(tree.values())))
        tree = [{k: v[i] for k, v in tree.items()} for i in range(n)]
    return [{k: conv(v) for k, v in layer.items()} for layer in tree]

"""Transformer layer body of the paged span step for the families the
port serves: Llama, Mistral, Qwen2, Qwen3, Gemma2, Gemma3, Mixtral,
Qwen3-MoE, Bloom and Falcon (port of bloombee_tpu/runtime/layer_body.py).

The input norm (RMSNorm, or Bloom's LayerNorm with its bias:
`models.llama.block.norm`), the projections (with Qwen2's q/k/v biases and
Bloom's biases where the layer has them), the per-head q/k RMSNorm (Qwen3,
Gemma3, Qwen3-MoE), rotary (none under ALiBi), the K/V scatter into the
paged arena, attention (Gemma2's logit soft-cap and Bloom's ALiBi bias on
the dense routes) and the tail (`models.llama.block.finish_layer`: the
Llama residual, Gemma's sandwich norms or Falcon's parallel residual; the
SiLU, tanh-GELU, plain 4h GELU or mixture-of-experts MLP, the same on every
attention route).
Sliding windows (Mistral, Gemma) arrive per layer from the executor, and
so do the rotary tables (Gemma3's sliding layers use a local base).
Attention routes three ways, as in the JAX package, on flags the executor
sets per step:

- `use_paged`: the paged kernels read K/V straight off the arena (decode for
  T=1, the int4 decode kernel over a quantized arena, chunk for T>1
  including tree-verify steps);
- `use_flash`: the flash kernel over the step's gathered pages (prefill;
  dequantized pages over an int4 arena);
- otherwise `attend_paged`, the dense masked path over gathered pages.

`layer_body_ragged` is the layer of the ragged step (rows of several
sessions packed as [1, R, D]): the ragged kernel when `use_kernel` is set,
else the dense `attend_ragged` over every member's gathered pages. Its
MoE tail routes each packed row alone, so a padding row changes no real
row's experts.

`dense_block_forward` is the same block over caller-supplied attention and
no arena (`models.llama.block.block_forward`; the speculative drafter's
path).

The kernels have no soft-cap and no position bias: a soft-capped or ALiBi
spec stays on the dense routes (the executor's gates, as in the JAX
package), and a kernel route asked for one raises. The other families'
structure (heterogeneous layers, shared K=V), LoRA
and top-k sparse attention are left out; the executor and the drafter
refuse specs that need them (`unsupported`, `dense_unsupported`), naming
ROADMAP Queue 1.
"""

from __future__ import annotations

import torch

from bloombee_tpu_torch.kv.arena import arena_write, gather_pages
from bloombee_tpu_torch.kv.quant import QuantSlab
from bloombee_tpu_torch.models.llama.block import (
    attention_inputs,
    block_forward,
    finish_layer,
    norm,
    proj,
)
from bloombee_tpu_torch.models.spec import ModelSpec
from bloombee_tpu_torch.ops.alibi import slopes_on
from bloombee_tpu_torch.ops.attention import NEG_INF, repeat_kv
from bloombee_tpu_torch.ops.cuda.flash_attention import flash_attention
from bloombee_tpu_torch.ops.cuda.paged_attention import (
    paged_chunk_attention,
    paged_decode_attention,
    paged_decode_attention_int4,
    paged_ragged_attention,
)


def attn_scale(spec: ModelSpec) -> float:
    return (
        spec.attention_multiplier
        if spec.attention_multiplier is not None
        else spec.head_dim**-0.5
    )


def soft_cap(spec: ModelSpec, logits: torch.Tensor) -> torch.Tensor:
    """Gemma2's attention logit soft-cap `tanh(s / c) * c`, on the scaled
    f32 logits before the mask (the JAX order); identity without one."""
    c = spec.attn_logit_softcap
    return torch.tanh(logits / c) * c if c else logits


def position_bias(spec: ModelSpec, logits: torch.Tensor,
                  key_pos: torch.Tensor) -> torch.Tensor:
    """Bloom's ALiBi bias `slopes[h] * key_pos` in f32, added to the f32
    logits (head axis 1) before the mask, at the absolute key positions
    (the JAX form); identity without ALiBi. `key_pos` broadcasts to the
    logits' axes after the head axis."""
    if not spec.alibi:
        return logits
    slopes = slopes_on(spec.num_attention_heads, logits.device)
    shape = (1, -1) + (1,) * (logits.dim() - 2)
    return logits + slopes.view(shape) * key_pos.float()


def _kernel_route_check(spec: ModelSpec) -> None:
    if spec.attn_logit_softcap:
        raise ValueError(
            "the attention kernels have no logit soft-cap: a soft-capped "
            "spec takes the dense routes"
        )
    if spec.alibi:
        raise ValueError(
            "the attention kernels have no ALiBi position bias: an ALiBi "
            "spec takes the dense routes"
        )


def attend_paged(
    spec: ModelSpec,
    q: torch.Tensor,  # [B, T, H, hd]
    k_ctx: torch.Tensor,  # [B, S, Hkv, hd]
    v_ctx: torch.Tensor,
    q_positions: torch.Tensor,  # [B, T]
    total_lens: torch.Tensor,  # [B]
    tree_mask: torch.Tensor | None,  # [B, T, T] bool
    window: int,  # 0 = full attention
) -> torch.Tensor:
    """Dense masked attention over the gathered context. Probabilities are
    cast to the input dtype before P.V, as in the JAX version."""
    b, t = q.shape[:2]
    s = k_ctx.shape[1]
    key_pos = torch.arange(s, device=q.device)[None, None, :]  # [1, 1, S]
    q_pos = q_positions.long()[:, :, None]  # [B, T, 1]
    lens = total_lens.long()[:, None, None]
    valid = key_pos < lens
    mask = valid & (key_pos <= q_pos)
    if window > 0:
        mask = mask & (key_pos > q_pos - window)
    if tree_mask is not None:
        # the step's tokens sit at cache positions total-T..total-1; their
        # mutual visibility comes from the tree mask
        step_start = lens - t
        in_step = (key_pos >= step_start) & (key_pos < lens)
        rel = (key_pos - step_start).clamp(0, t - 1).expand(b, t, s)
        tree_on_keys = torch.gather(tree_mask, 2, rel)
        mask = torch.where(in_step, tree_on_keys & valid, mask)

    n_rep = q.shape[2] // k_ctx.shape[2]
    k_r = repeat_kv(k_ctx, n_rep)
    v_r = repeat_kv(v_ctx, n_rep)
    logits = torch.einsum("bthd,bshd->bhts", q, k_r).float() * attn_scale(spec)
    logits = position_bias(spec, soft_cap(spec, logits), key_pos[:, :, None])
    logits = logits.masked_fill(~mask[:, None], NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhts,bshd->bthd", probs, v_r)


def unsupported(spec: ModelSpec) -> str | None:
    """Why this layer body cannot serve `spec`, naming the ROADMAP item
    that ports it; None when it can (Llama-structured blocks, with or
    without q/k/v biases, q/k norms and sliding windows; Gemma's sandwich
    norms, tanh-GELU MLP, attention soft-cap and per-layer rope theta; the
    mixture-of-experts MLP; Bloom's LayerNorm, biases, plain GELU MLP and
    ALiBi; Falcon's parallel residual with one or two LayerNorms)."""
    reason = _unported_structure(spec)
    return None if reason is None else (
        f"{reason} (ROADMAP Queue 1 item 15)"
    )


def _unported_structure(spec: ModelSpec) -> str | None:
    if spec.heterogeneous:
        return "heterogeneous head_dim layers"
    if spec.norm_type not in ("rms", "ln") or spec.mlp_type not in (
        "silu", "gelu_tanh_gated", "gelu_tanh", "gelu"
    ):
        return f"{spec.norm_type} norm / {spec.mlp_type} MLP"
    if spec.k_eq_v_full:
        return "shared K=V projections"
    return None


def dense_unsupported(spec: ModelSpec) -> str | None:
    """Why a family cannot run the cache-returning DENSE block forward (the
    drafter's path); None when it can. JAX's attend-injection limits come
    first (the caller supplies attention, so position bias, sliding
    windows and logit soft-caps would silently drop), then what this
    layer body lacks (`unsupported`)."""
    if spec.alibi:
        return "ALiBi bias lives inside attention"
    if spec.layer_types and "sliding" in spec.layer_types:
        return "sliding-window masks live inside attention"
    if spec.attn_logit_softcap:
        return "attention logit soft-cap lives inside attention"
    if spec.heterogeneous:
        return "heterogeneous head_dim layers"
    return unsupported(spec)


def dense_block_forward(
    params: dict,
    spec: ModelSpec,
    hidden: torch.Tensor,  # [B, T, D]
    cos: torch.Tensor,  # [B, T, hd]
    sin: torch.Tensor,
    attend,  # (q, k, v) -> (attn_out [B, T, H, hd], aux)
):
    """Dense block forward with caller-supplied attention: the client-side
    counterpart of `layer_body` for code that manages its own KV (the
    speculative drafter). Returns (hidden, (k, v)), k and v [B, T, Hkv, hd]
    after rotary."""
    reason = dense_unsupported(spec)
    if reason is not None:
        raise NotImplementedError(
            f"dense block forward doesn't cover family {spec.family!r}: "
            f"{reason}"
        )

    def attend_kv(q, k, v):
        return attend(q, k, v)[0], (k, v)

    return block_forward(params, spec, hidden, cos, sin, attend_kv)


def layer_body(
    spec: ModelSpec,
    page_size: int,
    hidden: torch.Tensor,  # [B, T, D]
    params: dict,  # one layer's params
    k_slab,  # [S_tot, Hkv, hd] or QuantSlab, updated in place
    v_slab,
    cos: torch.Tensor,  # [B, T, hd]
    sin: torch.Tensor,
    write: tuple[torch.Tensor, torch.Tensor],  # kv.arena.write_plan
    page_table: torch.Tensor,  # [B, NP] i32
    q_positions: torch.Tensor,  # [B, T] i32
    total_lens: torch.Tensor,  # [B] i32
    tree_mask: torch.Tensor | None,  # [B, T, T] bool
    window: int,
    use_flash: bool = False,
    use_paged: bool = False,
    t_real: int | None = None,  # real step tokens when T is a padded bucket
) -> torch.Tensor:
    b, t, _ = hidden.shape
    h_heads, kv_heads, hd = (
        spec.num_attention_heads,
        spec.num_key_value_heads,
        spec.head_dim,
    )
    if use_paged or use_flash:
        _kernel_route_check(spec)
    x = norm(hidden, params, "input_layernorm", spec)
    q, k, v = attention_inputs(params, spec, x, cos, sin)

    arena_write(
        k_slab, v_slab, None,
        k.reshape(b * t, kv_heads, hd), v.reshape(b * t, kv_heads, hd),
        plan=write,
    )
    scale = attn_scale(spec)
    if use_paged:
        if t == 1:
            decode = (
                paged_decode_attention_int4
                if isinstance(k_slab, QuantSlab) else paged_decode_attention
            )
            attn = decode(
                q[:, 0], k_slab, v_slab, page_table, total_lens,
                page_size=page_size, scale=scale, window=window,
            )[:, None]
        else:
            attn = paged_chunk_attention(
                q, k_slab, v_slab, page_table, total_lens,
                page_size=page_size, tree_mask=tree_mask, scale=scale,
                window=window, t_real=t_real,
            )
    else:
        k_ctx = gather_pages(k_slab, page_table, page_size).to(hidden.dtype)
        v_ctx = gather_pages(v_slab, page_table, page_size).to(hidden.dtype)
        if use_flash:
            attn = flash_attention(
                q, k_ctx, v_ctx, causal=True, scale=scale,
                starts=q_positions[:, 0].contiguous(), lens=total_lens,
            )
        else:
            attn = attend_paged(
                spec, q, k_ctx, v_ctx, q_positions, total_lens, tree_mask,
                window,
            )
    attn_out = proj(attn.reshape(b, t, h_heads * hd), params, "o_proj")
    return finish_layer(params, spec, hidden, x, attn_out)


def attend_ragged(
    spec: ModelSpec,
    q: torch.Tensor,  # [R, H, hd] rows of every member
    k_ctx: torch.Tensor,  # [B, S, Hkv, hd] every member's gathered context
    v_ctx: torch.Tensor,
    q_pos: torch.Tensor,  # [R] position of each row
    q_seq: torch.Tensor,  # [R] owning sequence (>= B: padding)
    total_lens: torch.Tensor,  # [B]
    window: int,  # 0 = full attention
    nt: torch.Tensor | None = None,  # [B] in-step tokens (tree mode)
    tree_rows: torch.Tensor | None = None,  # [R, t_max] (tree mode)
) -> torch.Tensor:  # [R, H, hd]
    """Dense route of the ragged step: every row attends the whole [B, S]
    cross-session context and masks what it does not own (x B masked
    logits). Tree mode: sequence b's last nt[b] positions are this step's
    tokens; committed keys stay visible and row i sees the m-th in-step key
    iff tree_rows[i, m]. Padding rows softmax over nothing they own and come
    out as garbage the executor slices away."""
    r, h, hd = q.shape
    b, s = k_ctx.shape[:2]
    dev = q.device
    key_pos = torch.arange(s, device=dev)[None, None, :]  # [1, 1, S]
    seq_ids = torch.arange(b, device=dev)[None, :, None]  # [1, B, 1]
    lens = total_lens.long()[None, :, None]  # [1, B, 1]
    own = (q_seq.long()[:, None, None] == seq_ids) & (key_pos < lens)
    if tree_rows is None:
        qp = q_pos.long()[:, None, None]
        mask = own & (key_pos <= qp)
        if window > 0:
            mask = mask & (key_pos > qp - window)
    else:
        t_max = tree_rows.shape[1]
        step_start = lens - nt.long()[None, :, None]
        m = key_pos - step_start  # [1, B, S] in-step slot (or < 0)
        vis = tree_rows[:, m[0].clamp(0, t_max - 1)] > 0  # [R, B, S]
        mask = own & ((key_pos < step_start) | ((m >= 0) & vis))

    n_rep = h // k_ctx.shape[2]
    k_r = repeat_kv(k_ctx, n_rep)  # [B, S, H, hd]
    v_r = repeat_kv(v_ctx, n_rep)
    logits = torch.einsum("rhd,bshd->rhbs", q, k_r).float() * attn_scale(spec)
    logits = position_bias(spec, soft_cap(spec, logits), key_pos)
    logits = logits.masked_fill(~mask[:, None], NEG_INF)
    probs = torch.softmax(logits.reshape(r, h, b * s), dim=-1).to(q.dtype)
    return torch.einsum("rhs,shd->rhd", probs, v_r.reshape(b * s, h, hd))


def layer_body_ragged(
    spec: ModelSpec,
    page_size: int,
    hidden: torch.Tensor,  # [1, R, D] every member's rows, packed
    params: dict,  # one layer's params
    k_slab,  # [S_tot, Hkv, hd] or QuantSlab, updated in place
    v_slab,
    cos: torch.Tensor,  # [1, R, hd]
    sin: torch.Tensor,
    write: tuple[torch.Tensor, torch.Tensor],  # kv.arena.write_plan
    page_table: torch.Tensor,  # [B, NP] i32
    q_positions: torch.Tensor,  # [1, R] i32
    total_lens: torch.Tensor,  # [B] i32
    q_seq: torch.Tensor,  # [R] i32
    window: int,
    use_kernel: bool = False,
    nt: torch.Tensor | None = None,  # [B] i32 (tree mode)
    tree_rows: torch.Tensor | None = None,  # [R, t_max] i32 (tree mode)
) -> torch.Tensor:
    """layer_body for the ragged step: projections, rotary and the arena
    write are position-wise; attention gets the member structure from
    (q_seq, q_positions) per row (and ALiBi its key positions from the
    gathered context, as in `layer_body`)."""
    _, r, _ = hidden.shape
    h_heads, kv_heads, hd = (
        spec.num_attention_heads,
        spec.num_key_value_heads,
        spec.head_dim,
    )
    if use_kernel:
        _kernel_route_check(spec)
    x = norm(hidden, params, "input_layernorm", spec)
    q, k, v = attention_inputs(params, spec, x, cos, sin)

    arena_write(
        k_slab, v_slab, None, k.reshape(r, kv_heads, hd),
        v.reshape(r, kv_heads, hd), plan=write,
    )
    if use_kernel and not isinstance(k_slab, QuantSlab):
        attn = paged_ragged_attention(
            q[0], k_slab, v_slab, page_table, total_lens, q_seq,
            q_positions[0], page_size=page_size, scale=attn_scale(spec),
            window=window, nt=nt, tree_rows=tree_rows,
        )
    else:
        k_ctx = gather_pages(k_slab, page_table, page_size).to(hidden.dtype)
        v_ctx = gather_pages(v_slab, page_table, page_size).to(hidden.dtype)
        attn = attend_ragged(
            spec, q[0], k_ctx, v_ctx, q_positions[0], q_seq, total_lens,
            window, nt=nt, tree_rows=tree_rows,
        )
    attn_out = proj(attn.reshape(1, r, h_heads * hd), params, "o_proj")
    return finish_layer(params, spec, hidden, x, attn_out)

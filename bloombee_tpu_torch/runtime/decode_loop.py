"""Server-side multi-step greedy decode: N tokens per RPC (port of
bloombee_tpu/runtime/decode_loop.py `decode_loop_impl`).

When one server holds the whole model, the client hands it the last token
id and the server runs embed -> span -> norm + head -> select N times,
returning N token ids per RPC: one client round trip for N tokens.

The JAX package runs the loop as one jitted `lax.scan`. Here it is an
eager Python loop over device work: every step's plan (write plan, page
table, positions, lengths) is built and uploaded before the loop, and the
ids, the `finished` mask and the tokens stay device tensors, so the loop
never waits on the device. The caller fetches the [B, N] tokens once, off
the compute queue.

Exactness contract (the JAX module's): on the same device this loop is
token-identical to the client's per-step greedy path. The embed runs in
the table's dtype and is cast to the compute dtype (the per-step path's
f32 embed plus the wire cast, exact for bf16 and f32 tables); the head
reads the span output cast to f32 (the per-step path's fetch in the wire
dtype plus the client's f32 cast, exact because the compute dtype is the
wire dtype); both use the client's embed and head math (`models/head.py`)
and the first-index argmax. Each step is built as the per-step path builds
it (the same batch bucket and page bucket), so the kernels see the same
shapes.
"""

from __future__ import annotations

import dataclasses

import torch

from bloombee_tpu_torch.models.head import embed_impl, norm_head_impl
from bloombee_tpu_torch.models.spec import ModelSpec
from bloombee_tpu_torch.runtime.step import span_step


@dataclasses.dataclass
class StepPlan:
    """One decode step's control tensors on the device: the write plan
    (`kv.arena.write_plan`: kept rows and their slots), the page table
    [B, NP], the query positions [B, 1] and the lengths after the write
    [B]."""

    write: tuple[torch.Tensor, torch.Tensor]
    page_table: torch.Tensor
    positions: torch.Tensor
    lens: torch.Tensor


def decode_loop_impl(
    client_params: dict,  # embed table + final norm + lm_head
    params: list[dict],  # per-layer span params
    arena_k,  # [L, S_tot, Hkv, hd], updated in place
    arena_v,
    ids0: torch.Tensor,  # [B] int: the input token of the FIRST step
    finished0: torch.Tensor,  # [B] bool: rows already at EOS
    plans: list[StepPlan],  # one per step
    layer_active,  # [L] ints
    *,
    spec: ModelSpec,
    page_size: int,
    eos_id: int = -1,  # -1: no EOS clamping
    compute_dtype=torch.bfloat16,
    windows: tuple | None = None,
    use_paged: bool = False,
    rows: int | None = None,  # real rows (the rest is bucket padding,
    # whose hidden states stay zero as the per-step path pads them)
) -> torch.Tensor:
    """Returns the tokens [B, N] (int64, on the device).

    tokens[:, i] is the token selected AFTER step i (greedy argmax over the
    f32 logits), with EOS rows clamped to eos_id exactly like the client's
    per-step `finished` masking."""
    b = ids0.shape[0]
    rows = b if rows is None else rows
    d = spec.hidden_size
    ids, finished = ids0.long(), finished0.bool()
    has_embed_norm = "embed_norm" in client_params
    tokens = []
    for plan in plans:
        h = torch.zeros((b, 1, d), dtype=compute_dtype, device=ids.device)
        h[:rows] = embed_impl(
            client_params, ids[:rows, None], spec.embedding_multiplier,
            has_embed_norm, spec.rms_norm_eps,
        ).to(compute_dtype)
        h = span_step(
            params, arena_k, arena_v, h, plan.write, plan.page_table,
            plan.positions, plan.lens, layer_active,
            spec=spec, page_size=page_size, windows=windows,
            use_paged=use_paged, t_real=1,
        )
        logits = norm_head_impl(
            client_params, h[:, -1:].float(), spec.rms_norm_eps,
            spec.logits_soft_cap, spec.norm_type,
        )[:, 0]  # [B, V] f32
        nxt = logits.argmax(dim=-1)
        if eos_id >= 0:
            nxt = torch.where(finished, torch.full_like(nxt, eos_id), nxt)
            finished = finished | (nxt == eos_id)
        tokens.append(nxt)
        ids = nxt
    return torch.stack(tokens, dim=1)

"""The span step: every local block over one step (port of
bloombee_tpu/runtime/step.py `span_step_impl` and `span_step_ragged_impl`).

A Python loop over layers takes the place of the JAX `lax.scan`; the arena
(dense or int4) is updated in place. Rotary cos/sin are computed once per
step from the positions, in fp32 like HF: the global pair and, when
`rope_local_theta` differs from `rope_theta` (Gemma3), the local pair that
every layer with a window takes. `layer_active` skips layers a session
does not use (a session entering mid-span).
"""

from __future__ import annotations

import torch

from bloombee_tpu_torch.kv.arena import slab_layer
from bloombee_tpu_torch.models.spec import ModelSpec
from bloombee_tpu_torch.ops.rotary import rotary_cos_sin
from bloombee_tpu_torch.runtime.layer_body import layer_body, layer_body_ragged


def rotary_tables(spec: ModelSpec, positions: torch.Tensor, dtype,
                  windows: tuple) -> list:
    """(cos, sin) in `dtype` for each layer of `windows`: the global pair,
    or for a layer with a window > 0 the local pair when the spec has its
    own local base (the JAX scan's `where(window > 0, local, global)`).
    Each pair is computed once per step."""
    def pair(theta):
        cos, sin = rotary_cos_sin(positions, spec.head_dim, theta)
        return cos.to(dtype), sin.to(dtype)

    glob = pair(spec.rope_theta)
    theta = spec.rope_local_theta
    if not theta or theta == spec.rope_theta:
        return [glob] * len(windows)
    local = pair(theta)
    return [local if int(w) > 0 else glob for w in windows]


def span_step(
    params: list[dict],  # per-layer params
    arena_k,  # [L, S_tot, Hkv, hd] or QuantSlab, updated in place
    arena_v,
    hidden: torch.Tensor,  # [B, T, D]
    write: tuple[torch.Tensor, torch.Tensor],  # kv.arena.write_plan
    page_table: torch.Tensor,  # [B, NP] i32
    q_positions: torch.Tensor,  # [B, T] i32
    total_lens: torch.Tensor,  # [B] i32
    layer_active,  # [L] ints: run layer l iff layer_active[l]
    tree_mask: torch.Tensor | None = None,  # [B, T, T] bool
    *,
    spec: ModelSpec,
    page_size: int,
    windows: tuple | None = None,
    use_flash: bool = False,
    use_paged: bool = False,
    t_real: int | None = None,
) -> torch.Tensor:
    """Run all active local blocks over one step; returns the hidden
    states."""
    windows = windows if windows is not None else (0,) * len(params)
    tables = rotary_tables(spec, q_positions, hidden.dtype, windows)
    for l, params_l in enumerate(params):
        if not layer_active[l]:
            continue
        hidden = layer_body(
            spec, page_size, hidden, params_l, slab_layer(arena_k, l),
            slab_layer(arena_v, l), *tables[l], write, page_table,
            q_positions, total_lens, tree_mask, int(windows[l]),
            use_flash=use_flash, use_paged=use_paged, t_real=t_real,
        )
    return hidden


def span_step_ragged(
    params: list[dict],  # per-layer params
    arena_k,  # [L, S_tot, Hkv, hd] or QuantSlab, updated in place
    arena_v,
    hidden: torch.Tensor,  # [1, R, D] every member's rows, packed
    write: tuple[torch.Tensor, torch.Tensor],  # kv.arena.write_plan
    page_table: torch.Tensor,  # [B, NP] i32
    q_positions: torch.Tensor,  # [1, R] i32
    total_lens: torch.Tensor,  # [B] i32
    q_seq: torch.Tensor,  # [R] i32 owning sequence (>= B: padding)
    layer_active,  # [L] ints
    nt: torch.Tensor | None = None,  # [B] i32 (tree mode)
    tree_rows: torch.Tensor | None = None,  # [R, t_max] i32 (tree mode)
    *,
    spec: ModelSpec,
    page_size: int,
    windows: tuple | None = None,
    use_kernel: bool = False,
) -> torch.Tensor:
    """The ragged span step: decode rows, tree-verify rows and at most one
    prefill chunk of several sessions in one dispatch; per-row (q_seq,
    q_positions) carry the member structure. (nt, tree_rows) switch
    attention to the tree variant."""
    windows = windows if windows is not None else (0,) * len(params)
    tables = rotary_tables(spec, q_positions, hidden.dtype, windows)
    for l, params_l in enumerate(params):
        if not layer_active[l]:
            continue
        hidden = layer_body_ragged(
            spec, page_size, hidden, params_l, slab_layer(arena_k, l),
            slab_layer(arena_v, l), *tables[l], write, page_table,
            q_positions, total_lens, q_seq, int(windows[l]),
            use_kernel=use_kernel, nt=nt, tree_rows=tree_rows,
        )
    return hidden

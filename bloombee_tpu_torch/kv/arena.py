"""Device KV arena: the data plane of the paged cache (port of
bloombee_tpu/kv/arena.py).

Layout (kept from the JAX package): per layer a flat slot dimension of
num_pages * page_size tokens,
    k, v: [L, num_pages * page_size, n_kv_heads, head_dim]
with slot ids from the host-side PagedKVTable (page * page_size + offset).

Unlike JAX's functional scatter, `arena_write` updates the slab in place
(PyTorch tensors are mutable; no donated copy is needed). JAX drops writes to
out-of-bounds slots (`mode="drop"`), and the executor points padding rows at
slot == capacity relying on that; `index_copy_` would not drop them, so the
write plan keeps only in-bounds rows before scattering.

`arena_reorder` compacts a speculative accept's surviving rows in place.

`quant="int4"` stores the slabs group-quantized (`kv.quant.QuantSlab`):
writes quantize the kept rows, gathers dequantize to f32.
"""

from __future__ import annotations

import torch

from bloombee_tpu_torch.kv.quant import (
    QuantSlab,
    dequantize,
    make_quant_slab,
    quantize,
    take,
)
from bloombee_tpu_torch.utils.device import resolve_device


def make_arena(
    num_layers: int,
    num_pages: int,
    page_size: int,
    n_kv_heads: int,
    head_dim: int,
    dtype=torch.bfloat16,
    device="cuda",
    quant: str | None = None,
) -> dict:
    device = resolve_device(device)
    shape = (num_layers, num_pages * page_size, n_kv_heads, head_dim)
    if quant == "int4":
        return {
            "k": make_quant_slab(shape, device),
            "v": make_quant_slab(shape, device),
        }
    if quant not in (None, "none"):
        raise ValueError(f"unknown KV quant mode {quant!r}")
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
    }


def write_plan(
    slots, capacity: int, device
) -> tuple[torch.Tensor, torch.Tensor]:
    """(rows, dst) int64 index tensors on `device`: the rows of a write whose
    slot lies inside [0, capacity), and those slots. The mask is computed on
    the host when `slots` is host data, so the device never synchronizes."""
    slots = torch.as_tensor(slots).long()
    keep = (slots >= 0) & (slots < capacity)
    rows = keep.nonzero().squeeze(1)
    return rows.to(device), slots[rows].to(device)


def slab_layer(slab, layer: int):
    """Layer `layer` of an arena slab (dense or QuantSlab) as views that
    write through to the arena."""
    return take(slab, layer) if isinstance(slab, QuantSlab) else slab[layer]


def arena_write(
    k_layer: torch.Tensor,  # [S_tot, n_kv, hd] one layer's slab (in place)
    v_layer: torch.Tensor,
    slots,  # [N] flat slot ids; None when `plan` is given
    k_new: torch.Tensor,  # [N, n_kv, hd]
    v_new: torch.Tensor,
    plan: tuple[torch.Tensor, torch.Tensor] | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Scatter new KV rows into a layer slab, dropping out-of-bounds slots.
    `plan` is a precomputed `write_plan` (one per step, shared by layers).
    Returns the (updated) slabs."""
    if plan is None:
        plan = write_plan(slots, k_layer.shape[0], k_new.device)
    rows, dst = plan
    if isinstance(k_layer, QuantSlab):
        for slab, new in ((k_layer, k_new), (v_layer, v_new)):
            for leaf, part in zip(slab, quantize(new.index_select(0, rows))):
                leaf.index_copy_(0, dst, part)
        return k_layer, v_layer
    k_layer.index_copy_(0, dst, k_new.index_select(0, rows).to(k_layer.dtype))
    v_layer.index_copy_(0, dst, v_new.index_select(0, rows).to(v_layer.dtype))
    return k_layer, v_layer


def arena_reorder(k_slab, v_slab, src, dst):
    """Compact surviving speculative KV rows onto the committed prefix, in
    place, in every layer of both [L, S, ...] slabs: slot `dst[i]` takes
    what slot `src[i]` held. Every read happens before any write (JAX's
    gather-before-scatter), so a source that is another row's destination
    still yields its old contents; a QuantSlab moves every leaf on the
    same slots. `src` and `dst` are in-bounds int64 index tensors on the
    slabs' device: JAX pads to a bucket and drops out-of-bounds scatters,
    the caller here drops padding on the host instead. Returns the
    (updated) slabs."""
    for slab in (k_slab, v_slab):
        leaves = slab if isinstance(slab, QuantSlab) else (slab,)
        moved = [leaf.index_select(1, src) for leaf in leaves]
        for leaf, rows in zip(leaves, moved):
            leaf.index_copy_(1, dst, rows)
    return k_slab, v_slab


def gather_pages(
    layer_slab: torch.Tensor,  # [S_tot, n_kv, hd]
    page_table: torch.Tensor,  # [B, max_pages] int
    page_size: int,
) -> torch.Tensor:
    """Each sequence's pages as [B, max_pages*page_size, n_kv, hd]
    (dequantized to f32 from a QuantSlab). Padding pages gather garbage
    rows; callers mask by context length."""
    b, max_pages = page_table.shape
    slots = (
        page_table.long()[:, :, None] * page_size
        + torch.arange(page_size, device=page_table.device)[None, None, :]
    ).reshape(b, max_pages * page_size)
    if isinstance(layer_slab, QuantSlab):
        return dequantize(take(layer_slab, slots), torch.float32)
    return layer_slab[slots]

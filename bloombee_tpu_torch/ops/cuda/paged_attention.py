"""Paged decode and paged chunk attention: the Hopper kernels
(`csrc/paged_attention.cu`) and their plain PyTorch versions.

Replaces, in bloombee_tpu/ops/pallas/paged_attention.py:

- `paged_decode_attention`: T=1 attention straight off the paged arena. The
  decode query sits at position lens[b]-1 and sees keys at positions
  < lens[b] (and >= lens[b]-window when window > 0).
- `paged_chunk_attention`: T>1 steps (short follow-up chunks, tree verify).
  The step's tokens sit at [lens[b]-t_real, lens[b]). Causal mode takes an
  optional per-query window and treats query rows >= t_real as padding;
  tree mode keeps the committed prefix fully visible and lets a [T, T] tree
  mask govern the in-step keys.

Both read keys only through the NP pages of the page table, keep the softmax
and the P.V sum in f32 (as the Pallas kernels do), and output zeros for a
row with no visible key. Each wrapper runs its plain version for tensors on
the CPU and its kernel for CUDA tensors; it never falls back.
"""

from __future__ import annotations

import ctypes

import torch

from bloombee_tpu_torch.ops.attention import NEG_INF, repeat_kv
from bloombee_tpu_torch.ops.cuda import build

SOURCE = "paged_attention"
DECODE = "paged_decode_attention"
CHUNK = "paged_chunk_attention"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128)
_GROUPS = (1, 2, 4, 8)
_lib = None


def _gather(slab, page_table, page_size):
    b = page_table.shape[0]
    slots = (
        page_table.long()[:, :, None] * page_size
        + torch.arange(page_size, device=slab.device)
    ).reshape(b, -1)
    return slab[slots].float()  # [B, NP * page_size, Hkv, hd]


def _softmax_pv(logits, mask, v):
    """Masked f32 softmax then P.V with zeros for fully masked rows:
    logits [B, H, T, S], mask broadcastable to it, v [B, S, H, hd]."""
    logits = logits.masked_fill(~mask, NEG_INF)
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.exp(logits - m) * mask
    denom = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    out = torch.einsum("bhts,bshd->bthd", p, v)
    return out / denom.permute(0, 2, 1, 3)


def paged_chunk_attention_reference(
    q: torch.Tensor,  # [B, T, H, hd]
    k_slab: torch.Tensor,  # [S_tot, Hkv, hd]
    v_slab: torch.Tensor,
    page_table: torch.Tensor,  # [B, NP] i32
    lens: torch.Tensor,  # [B] i32, including the step's tokens
    page_size: int,
    tree_mask: torch.Tensor | None = None,  # [B, T, T] bool (tree mode)
    scale: float | None = None,
    window: int = 0,
    t_real: int | None = None,
) -> torch.Tensor:
    """Plain PyTorch version of the chunk kernel: gather the pages, then the
    kernel's masks over a materialized [B, H, T, S] logit tensor."""
    b, t, h, hd = q.shape
    hkv = k_slab.shape[1]
    if scale is None:
        scale = hd**-0.5
    if t_real is None:
        t_real = t
    k = repeat_kv(_gather(k_slab, page_table, page_size), h // hkv)
    v = repeat_kv(_gather(v_slab, page_table, page_size), h // hkv)
    s = k.shape[1]
    dev = q.device
    lens = lens.long()
    start = lens - t_real  # [B]
    pos = torch.arange(s, device=dev)
    qt = torch.arange(t, device=dev)
    valid = pos[None, None, :] < lens[:, None, None]  # [B, 1, S]
    if tree_mask is None:
        q_pos = start[:, None] + qt[None, :]  # [B, T]
        mask = (
            valid
            & (pos[None, None, :] <= q_pos[:, :, None])
            & (qt < t_real)[None, :, None]
        )
        if window > 0:
            mask = mask & (pos[None, None, :] > q_pos[:, :, None] - window)
    else:
        rel = pos[None, :] - start[:, None]  # [B, S] in-step key index
        in_step = (rel >= 0) & (rel < t)
        tree_on_keys = torch.gather(
            tree_mask.bool(), 2, rel.clamp(0, t - 1)[:, None, :].expand(b, t, s)
        )  # [B, T, S]
        mask = valid & (
            (pos[None, None, :] < start[:, None, None])
            | (in_step[:, None, :] & tree_on_keys)
        )
    logits = torch.einsum("bthd,bshd->bhts", q.float() * scale, k)
    return _softmax_pv(logits, mask[:, None], v).to(q.dtype)


def paged_decode_attention_reference(
    q: torch.Tensor,  # [B, H, hd]
    k_slab: torch.Tensor,  # [S_tot, Hkv, hd]
    v_slab: torch.Tensor,
    page_table: torch.Tensor,  # [B, NP] i32
    lens: torch.Tensor,  # [B] i32, including this token
    page_size: int,
    scale: float | None = None,
    window: int = 0,
) -> torch.Tensor:
    """Plain PyTorch version of the decode kernel: a one-token causal chunk
    (query at lens-1, window counted back from it)."""
    return paged_chunk_attention_reference(
        q[:, None], k_slab, v_slab, page_table, lens, page_size,
        scale=scale, window=window, t_real=1,
    )[:, 0]


def _library():
    global _lib
    if _lib is None:
        lib = build.library(SOURCE)
        vp, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.bb_paged_decode_attention.argtypes = [
            vp, vp, vp, vp, vp, vp,  # q, k_slab, v_slab, page_table, lens, out
            i32, i32, i32, i32, i32, i32, i32,  # B, H, Hkv, hd, NP, ps, window
            f32, i32, vp,  # scale, dtype, stream
        ]
        lib.bb_paged_decode_attention.restype = i32
        lib.bb_paged_chunk_attention.argtypes = [
            vp, vp, vp, vp, vp, vp, vp,  # q, k, v, page_table, lens, tree, out
            i32, i32, i32, i32, i32, i32, i32, i32, i32,  # B T H Hkv hd NP
            # ps window t_real
            f32, i32, vp,  # scale, dtype, stream
        ]
        lib.bb_paged_chunk_attention.restype = i32
        _lib = lib
    return _lib


def _check(kernel, q, k_slab, v_slab, page_table, lens, page_size):
    b, h, hd = q.shape[0], q.shape[-2], q.shape[-1]
    if q.device.type != "cuda":
        raise ValueError(f"{kernel}: tensors must be on CUDA, not {q.device}")
    if q.dtype not in _DTYPES:
        raise ValueError(f"{kernel}: dtype {q.dtype} not in {list(_DTYPES)}")
    if hd not in _HEAD_DIMS:
        raise ValueError(f"{kernel}: head_dim {hd} not in {_HEAD_DIMS}")
    if k_slab.dim() != 3 or k_slab.shape[2] != hd or k_slab.shape != v_slab.shape:
        raise ValueError(f"{kernel}: slab {tuple(k_slab.shape)} vs hd {hd}")
    hkv = k_slab.shape[1]
    if h % hkv or h // hkv not in _GROUPS:
        raise ValueError(f"{kernel}: H/Hkv = {h}/{hkv} not in {_GROUPS}")
    if k_slab.shape[0] % page_size:
        raise ValueError(f"{kernel}: arena slots % page_size {page_size}")
    for name, x in (("k_slab", k_slab), ("v_slab", v_slab)):
        if x.dtype != q.dtype or x.device != q.device:
            raise ValueError(f"{kernel}: {name} must match q's dtype/device")
    if page_table.dim() != 2 or page_table.shape[0] != b:
        raise ValueError(f"{kernel}: page_table must be [B, NP]")
    for name, x in (("page_table", page_table), ("lens", lens)):
        if x.dtype != torch.int32 or x.device != q.device:
            raise ValueError(f"{kernel}: {name} must be int32 on q's device")
    if lens.shape != (b,):
        raise ValueError(f"{kernel}: lens must be [B]")
    for name, x in (("q", q), ("k_slab", k_slab), ("v_slab", v_slab),
                    ("page_table", page_table), ("lens", lens)):
        if not x.is_contiguous():
            raise ValueError(f"{kernel}: {name} must be contiguous")


def paged_decode_attention(
    q: torch.Tensor,  # [B, H, hd]
    k_slab: torch.Tensor,  # [S_tot, Hkv, hd]
    v_slab: torch.Tensor,
    page_table: torch.Tensor,  # [B, NP] i32
    lens: torch.Tensor,  # [B] i32
    page_size: int,
    scale: float | None = None,
    window: int = 0,
) -> torch.Tensor:  # [B, H, hd]
    if q.device.type == "cpu":
        return paged_decode_attention_reference(
            q, k_slab, v_slab, page_table, lens, page_size, scale, window
        )
    _check(DECODE, q, k_slab, v_slab, page_table, lens, page_size)
    lib = _library()
    b, h, hd = q.shape
    out = torch.empty_like(q)
    err = lib.bb_paged_decode_attention(
        q.data_ptr(), k_slab.data_ptr(), v_slab.data_ptr(),
        page_table.data_ptr(), lens.data_ptr(), out.data_ptr(),
        b, h, k_slab.shape[1], hd, page_table.shape[1], page_size,
        int(window), float(hd**-0.5 if scale is None else scale),
        _DTYPES[q.dtype], torch.cuda.current_stream(q.device).cuda_stream,
    )
    build.check(err, DECODE)
    build.LAUNCHES[DECODE] += 1
    return out


def paged_chunk_attention(
    q: torch.Tensor,  # [B, T, H, hd]
    k_slab: torch.Tensor,  # [S_tot, Hkv, hd]
    v_slab: torch.Tensor,
    page_table: torch.Tensor,  # [B, NP] i32
    lens: torch.Tensor,  # [B] i32
    page_size: int,
    tree_mask: torch.Tensor | None = None,  # [B, T, T] bool
    scale: float | None = None,
    window: int = 0,
    t_real: int | None = None,
) -> torch.Tensor:  # [B, T, H, hd]
    if q.device.type == "cpu":
        return paged_chunk_attention_reference(
            q, k_slab, v_slab, page_table, lens, page_size, tree_mask,
            scale, window, t_real,
        )
    _check(CHUNK, q, k_slab, v_slab, page_table, lens, page_size)
    b, t, h, hd = q.shape
    if tree_mask is not None:
        if (
            tree_mask.dtype != torch.bool
            or tree_mask.shape != (b, t, t)
            or tree_mask.device != q.device
            or not tree_mask.is_contiguous()
        ):
            raise ValueError(f"{CHUNK}: tree_mask must be contiguous bool "
                             "[B, T, T] on q's device")
        if window:
            raise ValueError(f"{CHUNK}: tree mode takes no window")
    lib = _library()
    out = torch.empty_like(q)
    err = lib.bb_paged_chunk_attention(
        q.data_ptr(), k_slab.data_ptr(), v_slab.data_ptr(),
        page_table.data_ptr(), lens.data_ptr(),
        None if tree_mask is None else tree_mask.data_ptr(), out.data_ptr(),
        b, t, h, k_slab.shape[1], hd, page_table.shape[1], page_size,
        int(window), int(t if t_real is None else t_real),
        float(hd**-0.5 if scale is None else scale),
        _DTYPES[q.dtype], torch.cuda.current_stream(q.device).cuda_stream,
    )
    build.check(err, CHUNK)
    build.LAUNCHES[CHUNK] += 1
    return out

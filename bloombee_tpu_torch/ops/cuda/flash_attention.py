"""Flash attention: the Hopper kernel (`csrc/flash_attention.cu`) and its
plain PyTorch version.

Replaces bloombee_tpu/ops/pallas/flash_attention.py::flash_attention. Row
b's query i sits at absolute position starts[b] + i; keys occupy positions
0..S-1 and row b sees those below lens[b] (and, when causal, at or below its
own position). The softmax and the P.V sum are f32 (as in the Pallas
kernel); a row with no visible key outputs zeros. bf16 inputs run on the
tensor cores (P enters the P.V product as two bf16 terms, hi + lo); f32
inputs on the CUDA cores.

`flash_attention` runs the plain version for tensors on the CPU and the
kernel for CUDA tensors; it never falls back from one to the other.
"""

from __future__ import annotations

import ctypes

import torch

from bloombee_tpu_torch.ops.attention import NEG_INF, repeat_kv
from bloombee_tpu_torch.ops.cuda import build

KERNEL = "flash_attention"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128)
_lib = None


def supports(h: int, hkv: int, hd: int, dtype) -> bool:
    """Whether the kernel takes this head geometry and dtype: the domain
    `_check` enforces at launch, and the gate the executor routes by. Any
    GQA group H/Hkv, as the Pallas kernel (the paged kernels' domain too,
    so one geometry takes all the routes or none)."""
    return (
        dtype in _DTYPES
        and hd in _HEAD_DIMS
        and hkv > 0
        and h % hkv == 0
    )


def _defaults(q, k, causal, scale, starts, lens):
    b, t, _, hd = q.shape
    s = k.shape[1]
    if scale is None:
        scale = hd**-0.5
    if starts is None:
        starts = torch.full((b,), s - t, dtype=torch.int32, device=q.device)
    if lens is None:
        lens = (
            starts + t if causal
            else torch.full((b,), s, dtype=torch.int32, device=q.device)
        )
    return float(scale), starts, lens


def flash_attention_reference(
    q: torch.Tensor,  # [B, T, H, hd]
    k: torch.Tensor,  # [B, S, Hkv, hd], S >= T
    v: torch.Tensor,
    causal: bool = True,
    scale: float | None = None,
    starts: torch.Tensor | None = None,  # [B] position of each row's query 0
    lens: torch.Tensor | None = None,  # [B] visible key count per row
) -> torch.Tensor:
    """Plain PyTorch version of the kernel: the same masked f32 softmax,
    materialized as [B, H, T, S] logits."""
    b, t, h, _ = q.shape
    s, hkv = k.shape[1], k.shape[2]
    scale, starts, lens = _defaults(q, k, causal, scale, starts, lens)
    kf = repeat_kv(k.float(), h // hkv)
    vf = repeat_kv(v.float(), h // hkv)
    logits = torch.einsum("bthd,bshd->bhts", q.float() * scale, kf)
    k_pos = torch.arange(s, device=q.device)
    mask = k_pos[None, None, :] < lens.long()[:, None, None]  # [B, 1, S]
    if causal:
        q_pos = starts.long()[:, None] + torch.arange(t, device=q.device)
        mask = mask & (k_pos[None, None, :] <= q_pos[:, :, None])
    mask = mask.expand(b, t, s)[:, None]  # [B, 1, T, S]
    logits = logits.masked_fill(~mask, NEG_INF)
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.exp(logits - m) * mask
    denom = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    out = torch.einsum("bhts,bshd->bthd", p, vf)
    return (out / denom.permute(0, 2, 1, 3)).to(q.dtype)


def _library():
    global _lib
    if _lib is None:
        lib = build.library(KERNEL)
        vp, i32 = ctypes.c_void_p, ctypes.c_int
        lib.bb_flash_attention.argtypes = [
            vp, vp, vp, vp, vp, vp,  # q, k, v, o, starts, lens
            i32, i32, i32, i32, i32, i32,  # B, T, S, H, Hkv, hd
            ctypes.c_float, i32, i32, vp,  # scale, causal, dtype, stream
        ]
        lib.bb_flash_attention.restype = i32
        _lib = lib
    return _lib


def _check(q, k, v, starts, lens):
    b, t, h, hd = q.shape
    if q.device.type != "cuda":
        raise ValueError(f"{KERNEL}: tensors must be on CUDA, not {q.device}")
    if q.dtype not in _DTYPES:
        raise ValueError(f"{KERNEL}: dtype {q.dtype} not in {list(_DTYPES)}")
    if hd not in _HEAD_DIMS:
        raise ValueError(f"{KERNEL}: head_dim {hd} not in {_HEAD_DIMS}")
    if k.dim() != 4 or k.shape[0] != b or k.shape[3] != hd or k.shape != v.shape:
        raise ValueError(f"{KERNEL}: k/v {tuple(k.shape)} vs q {tuple(q.shape)}")
    if k.shape[2] == 0 or h % k.shape[2]:
        raise ValueError(
            f"{KERNEL}: H = {h} is not a multiple of Hkv = {k.shape[2]}"
        )
    if k.shape[1] < t:
        raise ValueError(f"{KERNEL}: S={k.shape[1]} must be >= T={t}")
    for name, x in (("k", k), ("v", v)):
        if x.dtype != q.dtype or x.device != q.device:
            raise ValueError(f"{KERNEL}: {name} must match q's dtype/device")
    for name, x in (("starts", starts), ("lens", lens)):
        if x.dtype != torch.int32 or x.device != q.device or x.shape != (b,):
            raise ValueError(f"{KERNEL}: {name} must be int32 [B] on q's device")
    for name, x in (("q", q), ("k", k), ("v", v), ("starts", starts),
                    ("lens", lens)):
        if not x.is_contiguous():
            raise ValueError(f"{KERNEL}: {name} must be contiguous")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.data_ptr() % 16:
            raise ValueError(f"{KERNEL}: {name} must be 16-byte aligned")


def flash_attention(
    q: torch.Tensor,  # [B, T, H, hd]
    k: torch.Tensor,  # [B, S, Hkv, hd], S >= T
    v: torch.Tensor,
    causal: bool = True,
    scale: float | None = None,
    starts: torch.Tensor | None = None,  # [B] i32
    lens: torch.Tensor | None = None,  # [B] i32
) -> torch.Tensor:  # [B, T, H, hd] in q's dtype
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, causal, scale, starts, lens)
    scale, starts, lens = _defaults(q, k, causal, scale, starts, lens)
    _check(q, k, v, starts, lens)
    lib = _library()
    b, t, h, hd = q.shape
    out = torch.empty_like(q)
    err = lib.bb_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        starts.data_ptr(), lens.data_ptr(),
        b, t, k.shape[1], h, k.shape[2], hd, scale, int(causal),
        _DTYPES[q.dtype], torch.cuda.current_stream(q.device).cuda_stream,
    )
    build.check(err, KERNEL)
    build.count_launch(KERNEL)
    return out

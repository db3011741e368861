"""Group-wise 4-bit KV quantization (a torch copy of bloombee_tpu/kv/quant.py).

The layout is the JAX package's, bit for bit, so quantized pages can move
between the two packages:

- `codes [..., hd/2] uint8`: two 4-bit codes per byte, the EVEN head
  position in the low nibble and the ODD one in the high nibble;
- `scale`, `zero [..., hd/32] float16`: per group of 32 head positions,
  scale = (max - min) / 15 and zero = min, both rounded to f16 only when
  stored (the codes are computed with the f32 scale).

`torch.round` and `jnp.round` both round half to even. At head_dim 128 a
token costs 64 B of codes + 16 B of scale/zero = 80 B against 256 B in
bf16: 3.2x the tokens per byte of device memory.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from bloombee_tpu_torch.utils.device import resolve_device

GROUP_SIZE = 32


class QuantSlab(NamedTuple):
    """An int4-quantized KV slab. Leading dims mirror the dense slab
    ([L, S, Hkv] or [S, Hkv])."""

    codes: torch.Tensor  # [..., hd // 2] uint8, two nibbles per byte
    scale: torch.Tensor  # [..., hd // GROUP_SIZE] f16, (max - min) / 15
    zero: torch.Tensor  # [..., hd // GROUP_SIZE] f16, group min

    @property
    def shape(self) -> tuple[int, ...]:
        """The codes' shape: the leading dims match the dense slab's."""
        return tuple(self.codes.shape)


def _group(hd: int) -> int:
    gs = min(GROUP_SIZE, hd)
    if hd % 2 or hd % gs:
        raise ValueError(f"head_dim {hd} is not int4-packable")
    return gs


def make_quant_slab(shape: tuple[int, ...], device="cuda") -> QuantSlab:
    """Empty quantized slab for a dense-equivalent shape [..., hd], on the
    card unless the caller asks for another device."""
    device = resolve_device(device)
    *lead, hd = shape
    groups = hd // _group(hd)
    return QuantSlab(
        codes=torch.zeros((*lead, hd // 2), dtype=torch.uint8, device=device),
        scale=torch.zeros((*lead, groups), dtype=torch.float16, device=device),
        zero=torch.zeros((*lead, groups), dtype=torch.float16, device=device),
    )


def quantize(x: torch.Tensor) -> QuantSlab:
    """Group-wise asymmetric int4 quantization along the last dim."""
    *lead, hd = x.shape
    gs = _group(hd)
    xg = x.float().reshape(*lead, hd // gs, gs)
    mn = xg.amin(dim=-1)
    scale = (xg.amax(dim=-1) - mn) / 15.0
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    q = torch.clamp(
        torch.round((xg - mn[..., None]) / safe[..., None]), 0, 15
    ).to(torch.uint8).reshape(*lead, hd)
    return QuantSlab(
        codes=q[..., 0::2] | (q[..., 1::2] << 4),
        scale=scale.half(),
        zero=mn.half(),
    )


def dequantize(slab: QuantSlab, dtype=torch.bfloat16) -> torch.Tensor:
    """Inverse of `quantize`: [..., hd] in the requested dtype."""
    codes = slab.codes
    q = torch.stack([codes & 0xF, codes >> 4], dim=-1).reshape(
        *codes.shape[:-1], codes.shape[-1] * 2
    )
    hd = q.shape[-1]
    gs = _group(hd)
    qg = q.reshape(*q.shape[:-1], hd // gs, gs).float()
    out = qg * slab.scale[..., None].float() + slab.zero[..., None].float()
    return out.reshape(*q.shape[:-1], hd).to(dtype)


def take(slab: QuantSlab, index) -> QuantSlab:
    """slab[index] on every leaf (a layer: views that write through; a
    slot gather: copies)."""
    return QuantSlab(*(leaf[index] for leaf in slab))


def slab_nbytes(slab) -> int:
    """Total bytes of a slab (a dense tensor or a QuantSlab)."""
    leaves = slab if isinstance(slab, QuantSlab) else (slab,)
    return sum(t.numel() * t.element_size() for t in leaves)

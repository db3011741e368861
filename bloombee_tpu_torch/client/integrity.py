"""Client-side integrity layer: sanity gate, tolerance compare, digests
(a copy of bloombee_tpu/client/integrity.py over torch, with
`out_digest` of bloombee_tpu/kv/prefix.py).

In a public swarm, peers may return incorrect outputs, maliciously or via
bad hardware, and the client feeds whatever hidden states a server returns
straight into the next span. The pieces here:

- ``SanityGate``: a cheap O(B*D) inline check every received span output
  passes before entering the next span — all-finite plus a per-span
  running activation-RMS envelope.
- ``tensors_close``: the dtype-aware tolerance compare (never exact
  equality: honest replicas differ in ulps).
- ``out_digest``: blake2b over a span output's exact bytes, equal to the
  JAX package's digest of the same numpy array, so a port client verifies
  a JAX server's stamps.
- ``IntegrityError``: raised into the session's reroute + replay recovery
  when a check fails.

Opt-in (``ClientConfig.integrity`` / ``BBTPU_INTEGRITY``). The audits of
the JAX package (``BBTPU_AUDIT_P``) are not ported (ROADMAP item 19).
"""

from __future__ import annotations

import hashlib
import logging

import numpy as np
import torch

from bloombee_tpu_torch.utils import env
from bloombee_tpu_torch.wire.rpc import RpcError
from bloombee_tpu_torch.wire.tensor_codec import dtype_for_name

logger = logging.getLogger(__name__)

env.declare(
    "BBTPU_INTEGRITY", bool, False,
    "enable the client integrity layer (inline sanity gate on every span "
    "output + out_digest verification)",
)

# span-output digests: one-shot, not chained (bloombee_tpu/kv/prefix.py)
_DIGEST_VERSION = b"bbtpu-outdigest-v1"
# numpy's names for the wire's float dtypes (ml_dtypes names bf16
# "bfloat16"): the digest hashes the dtype's name
_NP_NAMES = {
    torch.float32: "float32",
    torch.bfloat16: "bfloat16",
    torch.float16: "float16",
    torch.float64: "float64",
}


class IntegrityError(RpcError):
    """A span output failed an integrity check. Subclasses RpcError so the
    session's retry loop heals it via reroute + replay."""


def _as_f32(x) -> torch.Tensor:
    return torch.as_tensor(x).detach().float()


def out_digest(t) -> str:
    """blake2b hex digest over a span output's exact bytes: its dtype's
    numpy name, its shape as a Python tuple ("(2, 1, 64)") and its C-order
    bytes — the bytes the JAX package hashes for the same numpy array."""
    t = torch.as_tensor(t).detach().cpu().contiguous()
    h = hashlib.blake2b(_DIGEST_VERSION, digest_size=16)
    h.update(_NP_NAMES[t.dtype].encode("ascii"))
    h.update(str(tuple(t.shape)).encode("ascii"))
    flat = t.reshape(-1)
    if flat.numel():
        h.update(flat.view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def rtol_for(dtype) -> float:
    """Audit comparison tolerance for a wire dtype (torch dtype or wire
    name like "bf16"). Generous on purpose: honest cross-replica ulp drift
    must never convict."""
    if isinstance(dtype, str):
        dtype = dtype_for_name(dtype)
    if dtype in (torch.bfloat16, torch.float16):
        return 0.1
    if dtype == torch.float32:
        return 0.02
    return 1e-6


def tensors_close(a, b, dtype=None) -> bool:
    """Dtype-aware tolerance compare of two span outputs. ``dtype`` is the
    wire dtype the activations travelled in (default: the coarser of the
    two inputs' dtypes); the absolute floor scales with the reference RMS."""
    aa, bb = torch.as_tensor(a), torch.as_tensor(b)
    if aa.shape != bb.shape:
        return False
    if dtype is None:
        dtype = max((aa.dtype, bb.dtype), key=rtol_for)
    rtol = rtol_for(dtype)
    a32, b32 = _as_f32(aa), _as_f32(bb.to(aa.device))
    rms = a32.square().mean().sqrt().item() if a32.numel() else 0.0
    atol = rtol * max(rms, 1e-6)
    return bool(torch.allclose(a32, b32, rtol=rtol, atol=atol))


class SanityGate:
    """Per-span running activation-norm envelope plus all-finite check.

    Keyed by span block range (start, end), not by peer, so a rerouted
    replacement server is judged against the same envelope. Warmup
    observations are accepted unconditionally; stats update only on
    accepted outputs so one lie can't stretch the envelope."""

    def __init__(self, margin: float = 4.0, warmup: int = 3):
        self.margin = float(margin)
        self.warmup = int(warmup)
        # span key -> [observations, max accepted per-position RMS]
        self._stats: dict[tuple, list] = {}

    def check(self, key, t) -> str | None:
        """Returns None when `t` passes, else a short reject reason."""
        a32 = _as_f32(t)
        if not torch.isfinite(a32).all().item():
            return "nonfinite"
        if a32.numel() == 0:
            return None
        # per-position RMS over the feature dim, worst position; f64: a
        # x64-scaled bf16 lie squares past f32 range
        rms = a32.double().square().mean(dim=-1).sqrt()
        worst = float(rms.max().item())
        st = self._stats.get(key)
        if st is None:
            st = [0, 0.0]
            self._stats[key] = st
        if st[0] >= self.warmup and worst > self.margin * max(st[1], 1e-6):
            return (
                f"rms-envelope: {worst:.3g} > {self.margin:g}x"
                f" {st[1]:.3g}"
            )
        st[0] += 1
        st[1] = max(st[1], worst)
        return None

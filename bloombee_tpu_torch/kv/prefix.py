"""Page-aligned content hash chains for cross-session prefix sharing (a
copy of bloombee_tpu/kv/prefix.py, over numpy and torch inputs).

The chain is the identity of a cached KV page: page i's hash covers its own
token ids AND the parent page's hash, so equal hashes imply equal *full
prefixes*, not just equal page contents. The bytes hashed are the JAX
package's byte for byte, so a port client's chains address a JAX server's
pool and the reverse; a version skew shows up as a clean cache miss, never
a wrong hit.

`out_digest` (the integrity layer's one-shot span-output digest) lives here
too, as in the JAX package.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch

from bloombee_tpu_torch.utils import env

env.declare(
    "BBTPU_PREFIX_CACHE", bool, False,
    "cross-session shared-prefix KV cache: servers keep finished "
    "sequences' committed prompt pages pooled under content hashes, new "
    "sessions whose prompt chain matches adopt them and prefill only the "
    "suffix; clients probe the pools before their first prefill",
)

# bumped whenever the hash layout changes: a stale client's chains must
# miss, not alias, a newer server's pool
_CHAIN_VERSION = b"bbtpu-prefix-v1"
# hidden-state sessions (no token ids) hash raw activations instead; a
# distinct root guarantees a hidden chain can never alias an id chain
_HIDDEN_VERSION = b"bbtpu-hidden-v1"
# span-output digests (integrity layer): one-shot, not chained — each step's
# output stands alone so a single corrupted reply can't invalidate the rest
_DIGEST_VERSION = b"bbtpu-outdigest-v1"
# numpy's names for the wire's float dtypes (ml_dtypes names bf16
# "bfloat16"): the digest hashes the dtype's name
_NP_NAMES = {
    torch.float32: "float32",
    torch.bfloat16: "bfloat16",
    torch.float16: "float16",
    torch.float64: "float64",
}


def _host_f32(x) -> np.ndarray:
    """A tensor or array as contiguous float32 numpy on the host."""
    if isinstance(x, torch.Tensor):
        x = x.detach().to(device="cpu", dtype=torch.float32).numpy()
    return np.ascontiguousarray(np.asarray(x), dtype=np.float32)


def out_digest(t) -> str:
    """blake2b hex digest over a span output's exact bytes: its dtype's
    numpy name, its shape as a Python tuple ("(2, 1, 64)") and its C-order
    bytes — the bytes the JAX package hashes for the same numpy array.
    The digest covers the bytes the server serialized, so a client detects
    in-flight corruption exactly; honest replicas differ in ulps, so it is
    no cross-replica equality check."""
    t = torch.as_tensor(t).detach().cpu().contiguous()
    h = hashlib.blake2b(_DIGEST_VERSION, digest_size=16)
    h.update(_NP_NAMES[t.dtype].encode("ascii"))
    h.update(str(tuple(t.shape)).encode("ascii"))
    flat = t.reshape(-1)
    if flat.numel():
        h.update(flat.view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def _extend_chain(
    pages_bytes, total_pages: int, chain: list[str] | None, root: bytes
) -> list[str]:
    """Shared chaining core: extend `chain` (treated as already covering
    its own length in pages) out to `total_pages` using `pages_bytes(p)`
    for page p's canonical byte content."""
    out = list(chain or [])
    if len(out) >= total_pages:
        return out[:total_pages]
    parent = out[-1].encode("ascii") if out else root
    for p in range(len(out), total_pages):
        digest = hashlib.blake2b(
            parent + pages_bytes(p), digest_size=16
        ).hexdigest()
        out.append(digest)
        parent = digest.encode("ascii")
    return out


def page_hash_chain(
    ids, page_size: int, chain: list[str] | None = None
) -> list[str]:
    """Chained hashes of the *full* pages of one row of token ids.

    One hex digest per complete page (a trailing partial page gets no hash:
    its content is still growing). Ids are canonicalized to int64, so the
    same prompt hashes identically whatever integer dtype it came in.
    `chain` (an earlier result over a prefix of the same row) extends
    incrementally instead of rehashing from the root."""
    if page_size <= 0:
        raise ValueError(f"page_size must be positive, got {page_size}")
    if isinstance(ids, torch.Tensor):
        ids = ids.detach().cpu().numpy()
    row = np.asarray(ids).reshape(-1).astype(np.int64)
    return _extend_chain(
        lambda p: row[p * page_size : (p + 1) * page_size].tobytes(),
        len(row) // page_size, chain, _CHAIN_VERSION,
    )


def hidden_hash_chain(
    hidden, page_size: int, chain: list[str] | None = None
) -> list[str]:
    """Chained hashes of the full pages of one row of hidden states
    ([T, D]), over contiguous float32 bytes so the chain is stable across
    the dtypes a client may hold its history in. Used by hidden-state
    sessions (no token ids): same pool, different hash root."""
    if page_size <= 0:
        raise ValueError(f"page_size must be positive, got {page_size}")
    row = _host_f32(hidden)
    if row.ndim != 2:
        raise ValueError(f"hidden row must be [T, D], got {row.shape}")
    return _extend_chain(
        lambda p: row[p * page_size : (p + 1) * page_size].tobytes(),
        row.shape[0] // page_size, chain, _HIDDEN_VERSION,
    )

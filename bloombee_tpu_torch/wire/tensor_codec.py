"""Tensor (de)serialization with optional lossless compression (port of
bloombee_tpu/wire/tensor_codec.py for torch tensors).

A tensor goes on the wire as a `TensorMeta` (wire dtype name, shape, codec,
byte split) and a payload of the same bytes the JAX package sends for the
same values, so the two packages read each other's frames:

- wire dtype names f32, f16, bf16, i32, i64, u8, bool and f64. A
  `torch.bfloat16` tensor's bytes are the payload of "bf16" as they are;
  no `ml_dtypes` is involved;
- codecs zlib always, zstd only when the `zstandard` package imports (and
  only then advertised); "raw" always;
- for 2-byte dtypes the two byte planes of the little-endian pairs are
  split before compression (a numpy transpose, the same bytes as the JAX
  package's native helper);
- payloads below BBTPU_MIN_COMPRESS_BYTES, or compressing by less than
  BBTPU_MIN_COMPRESS_GAIN bytes, ship raw.

The first frames of a connection go out before the peer's codec advert, on
LEGACY_WIRE_CODECS = {raw, zstd, zlib}; a JAX peer may therefore send zstd
before it knows better. Without `zstandard`, decoding such a payload raises
an error naming the codec.

Deserialized tensors live on the CPU and own their memory.
"""

from __future__ import annotations

import dataclasses
import threading
import time as _time
import zlib

import numpy as np
import torch

from bloombee_tpu_torch.utils import env as _env

try:
    import zstandard as _zstd
except ImportError:
    _zstd = None

# zstd (de)compressor objects must not be used by two threads at once, and
# the codec pool runs several: one pair per thread
_zstd_local = threading.local()


def _zstd_pair():
    pair = getattr(_zstd_local, "pair", None)
    if pair is None:
        pair = _zstd_local.pair = (
            _zstd.ZstdCompressor(level=3), _zstd.ZstdDecompressor()
        )
    return pair


class _TransportStats:
    """Per-process codec counters per direction: tensor count, raw vs wire
    bytes, codec seconds (snapshot via transport_stats())."""

    def __init__(self):
        self._lock = threading.Lock()
        self.reset()

    def reset(self):
        with self._lock:
            self._d = {
                d: {"n": 0, "raw_bytes": 0, "wire_bytes": 0, "s": 0.0,
                    "compressed": 0}
                for d in ("tx", "rx")
            }

    def record(self, direction, raw_len, wire_len, seconds, compressed):
        with self._lock:
            d = self._d[direction]
            d["n"] += 1
            d["raw_bytes"] += raw_len
            d["wire_bytes"] += wire_len
            d["s"] += seconds
            d["compressed"] += bool(compressed)

    def snapshot(self) -> dict:
        with self._lock:
            out = {}
            for k, d in self._d.items():
                out[k] = dict(d)
                out[k]["ratio"] = (
                    d["wire_bytes"] / d["raw_bytes"] if d["raw_bytes"] else 1.0
                )
            return out


_STATS = _TransportStats()


def transport_stats() -> dict:
    """Snapshot of this process's wire-codec counters."""
    return _STATS.snapshot()


MIN_COMPRESS_BYTES = 48 * 1024
MIN_GAIN_BYTES = 2 * 1024

_env.declare(
    "BBTPU_MIN_COMPRESS_BYTES", int, MIN_COMPRESS_BYTES,
    "payloads below this ship raw (reference lossless_transport 48 KiB gate)",
)
_env.declare(
    "BBTPU_MIN_COMPRESS_GAIN", int, MIN_GAIN_BYTES,
    "compression kept only if it saves at least this many bytes",
)
_env.declare(
    "BBTPU_WIRE_COMPRESSION", bool, True,
    "losslessly compress large wire tensors (zstd byte-split)",
)
_env.declare(
    "BBTPU_WIRE_CODECS", str, "",
    "comma-separated allowlist restricting which codecs this process "
    "advertises and uses on the wire; empty means every built-in codec, "
    "'raw' disables compression entirely",
)

# name -> (compress, decompress). "raw" is implicit and always supported.
_CODECS: dict[str, tuple] = {"zlib": (lambda b: zlib.compress(b, 6),
                                      zlib.decompress)}
if _zstd is not None:
    _CODECS["zstd"] = (
        lambda b: _zstd_pair()[0].compress(b),
        lambda b: _zstd_pair()[1].decompress(b),
    )

# preference order when several codecs are permitted for a payload
_PREFERENCE: list[str] = ["zstd", "zlib"]

# what a peer that never advertises is assumed to decode
LEGACY_WIRE_CODECS = frozenset({"raw", "zstd", "zlib"})


def supported_codecs() -> frozenset:
    """Codecs this process can encode and decode now: what a connection
    advertises. BBTPU_WIRE_CODECS restricts the set ("raw" always stays)."""
    names = {"raw", *_CODECS}
    allow = str(_env.get("BBTPU_WIRE_CODECS")).strip()
    if allow:
        keep = {c.strip() for c in allow.split(",") if c.strip()}
        names &= keep | {"raw"}
    return frozenset(names)


_DTYPES = {
    "f32": torch.float32,
    "f16": torch.float16,
    "bf16": torch.bfloat16,
    "i32": torch.int32,
    "i64": torch.int64,
    "u8": torch.uint8,
    "bool": torch.bool,
    "f64": torch.float64,
}
_DTYPE_NAMES = {v: k for k, v in _DTYPES.items()}


def dtype_for_name(name: str, default=torch.float32) -> torch.dtype:
    """Resolve a wire dtype name ("bf16", "f32", ...) to a torch dtype."""
    return _DTYPES.get(name, default)


@dataclasses.dataclass
class TensorMeta:
    dtype: str
    shape: tuple[int, ...]
    codec: str  # "raw" | "zstd" | "zlib"
    byte_split: bool

    def to_wire(self) -> dict:
        return {
            "d": self.dtype,
            "s": list(self.shape),
            "c": self.codec,
            "b": self.byte_split,
        }

    @classmethod
    def from_wire(cls, d: dict) -> "TensorMeta":
        # an older peer's lean meta (dtype + shape) means raw bytes
        return cls(d["d"], tuple(d["s"]), d.get("c", "raw"),
                   d.get("b", False))


def _compress(buf, codec: str) -> bytes:
    try:
        return _CODECS[codec][0](buf)
    except KeyError:
        raise ValueError(f"unknown codec {codec}") from None


def _decompress(buf, codec: str) -> bytes:
    try:
        fn = _CODECS[codec][1]
    except KeyError:
        if codec == "zstd":
            raise ValueError(
                "codec 'zstd' is not available in this process (the "
                "zstandard package is not installed); the peer must not "
                "send zstd once it has read this process's codec advert"
            ) from None
        raise ValueError(f"unknown codec {codec}") from None
    return fn(buf)


def _raw_bytes(t: torch.Tensor) -> bytes:
    """A CPU tensor's bytes in row-major order."""
    flat = t.reshape(-1)
    if flat.numel() == 0:
        return b""
    return flat.view(torch.uint8).numpy().tobytes()


def serialize_tensor(
    t, compression: bool = True, allowed: frozenset | None = None,
) -> tuple[TensorMeta, bytes]:
    """Serialize one tensor (any device; numpy arrays are taken as
    tensors); returns (meta, payload bytes). `allowed` is the negotiated
    codec set for the destination peer; None means LEGACY_WIRE_CODECS."""
    t0 = _time.perf_counter()
    t = torch.as_tensor(t).detach().cpu().contiguous()
    if t.dtype not in _DTYPE_NAMES:
        raise TypeError(f"unsupported wire dtype {t.dtype}")
    raw = _raw_bytes(t)
    codec = "raw"
    byte_split = False
    payload = raw
    if not _env.get("BBTPU_WIRE_COMPRESSION"):
        compression = False
    if allowed is None:
        allowed = LEGACY_WIRE_CODECS
    usable = [c for c in _PREFERENCE if c in _CODECS and c in allowed]
    if (compression and usable
            and len(raw) >= _env.get("BBTPU_MIN_COMPRESS_BYTES")):
        candidate = raw
        if t.element_size() == 2:
            # byte-plane split: [b0 b1 b0 b1 ...] -> [b0 b0 ...][b1 b1 ...]
            candidate = _split_planes(raw)
            byte_split = True
        chosen = usable[0]
        compressed = _compress(candidate, chosen)
        if len(compressed) + _env.get("BBTPU_MIN_COMPRESS_GAIN") <= len(raw):
            payload = compressed
            codec = chosen
        else:
            byte_split = False
    _STATS.record(
        "tx", len(raw), len(payload), _time.perf_counter() - t0,
        codec != "raw",
    )
    return (
        TensorMeta(_DTYPE_NAMES[t.dtype], tuple(t.shape), codec, byte_split),
        payload,
    )


def deserialize_tensor(meta: TensorMeta, payload) -> torch.Tensor:
    """Decode one payload (bytes or memoryview) into a CPU tensor."""
    t0 = _time.perf_counter()
    dtype = _DTYPES[meta.dtype]
    if meta.codec == "raw":
        raw = payload
    else:
        raw = _decompress(payload, meta.codec)
        if meta.byte_split:
            raw = _merge_planes(raw)
    if len(raw) == 0:
        out = torch.empty(meta.shape, dtype=dtype)
    else:
        # a writable copy: torch tensors have no read-only mode
        buf = bytearray(raw)
        out = torch.frombuffer(buf, dtype=torch.uint8).view(dtype)
        out = out.reshape(meta.shape)
    _STATS.record(
        "rx", len(raw), len(payload), _time.perf_counter() - t0,
        meta.codec != "raw",
    )
    return out


def _split_planes(raw: bytes) -> bytes:
    return np.frombuffer(raw, dtype=np.uint8).reshape(-1, 2).T.tobytes()


def _merge_planes(raw: bytes) -> bytes:
    return np.frombuffer(raw, dtype=np.uint8).reshape(2, -1).T.tobytes()


def serialize_tensors(
    tensors: list, compression: bool = True,
    allowed: frozenset | None = None,
) -> tuple[list[dict], list[bytes]]:
    metas, blobs = [], []
    for t in tensors:
        m, b = serialize_tensor(t, compression, allowed=allowed)
        metas.append(m.to_wire())
        blobs.append(b)
    return metas, blobs


def deserialize_tensors(metas: list[dict], blobs: list) -> list[torch.Tensor]:
    return [
        deserialize_tensor(TensorMeta.from_wire(m), b)
        for m, b in zip(metas, blobs)
    ]

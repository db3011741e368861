"""Off-loop wire codec pipeline (per-connection, bounded, ordered; a copy
of bloombee_tpu/wire/pipeline.py over the port's tensor codec).

Tensor (de)serialization used to run synchronously inside wire/rpc.py
coroutines — the event loop stalled for every codec call. This module
moves that work into a small shared thread pool while keeping the two
invariants the RPC layer depends on:

- ordering: frames for one stream must not reorder. The receive side
  submits decode jobs as frames arrive but a single drain task awaits
  them in arrival order (wire/rpc.py), so concurrency never reorders a
  stream. The send side keeps order because stream senders await each
  frame before the next.
- backpressure: both directions are bounded per connection. TX holds a
  FlowLimiter slot (wire/flow.py AIMD) around encode+write, so a slow
  peer shrinks only its own connection's concurrency instead of
  convoying the loop; RX queues at most BBTPU_WIRE_PIPELINE_DEPTH frames
  — a full queue stops the socket reads and TCP pushes back on the peer.

BBTPU_WIRE_PIPELINE=0 restores the seed's fully synchronous scheduling
(frames stay byte-identical either way; the switch changes only where
codec work runs).
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import threading

from bloombee_tpu_torch.utils import env
from bloombee_tpu_torch.wire import tensor_codec
from bloombee_tpu_torch.wire.flow import FlowLimiter

env.declare(
    "BBTPU_WIRE_PIPELINE", bool, True,
    "run wire tensor (de)serialization off the event loop in the shared "
    "codec pool, bounded and ordered per connection; 0 restores the "
    "seed's synchronous codec scheduling (frames are byte-identical "
    "either way)",
)
env.declare(
    "BBTPU_WIRE_PIPELINE_DEPTH", int, 8,
    "per-connection bound on in-flight codec jobs: max queued inbound "
    "frames awaiting decode (past it the socket read stalls — TCP "
    "backpressure) and the FlowLimiter ceiling for concurrent sends",
)
env.declare(
    "BBTPU_WIRE_CODEC_THREADS", int, 2,
    "worker threads in the process-wide wire codec pool",
)
env.declare(
    "BBTPU_WIRE_PIPELINE_INLINE", int, 4096,
    "payloads smaller than this many bytes are (de)serialized in-line "
    "even when the pipeline is on — a thread hop costs more than codec "
    "work on tiny frames; 0 forces every frame through the pool",
)

_EXEC: concurrent.futures.ThreadPoolExecutor | None = None
_EXEC_GUARD = threading.Lock()


def codec_executor() -> concurrent.futures.ThreadPoolExecutor:
    """Process-wide codec pool, created on first use (thread count is
    pinned at creation; BBTPU_WIRE_CODEC_THREADS is read once)."""
    global _EXEC
    if _EXEC is None:
        with _EXEC_GUARD:
            if _EXEC is None:
                _EXEC = concurrent.futures.ThreadPoolExecutor(
                    max_workers=max(1, env.get("BBTPU_WIRE_CODEC_THREADS")),
                    thread_name_prefix="bbtpu-codec",
                )
    return _EXEC


def encode_now(tensors, compression: bool = True, allowed=None):
    """Synchronous serialize (worker-thread body / legacy sync path)."""
    return tensor_codec.serialize_tensors(tensors, compression,
                                          allowed=allowed)


def decode_now(metas, blobs):
    """Synchronous deserialize (worker-thread body / legacy sync path)."""
    return tensor_codec.deserialize_tensors(metas, blobs)


class _NullSlot:
    """No-op stand-in for a FlowLimiter slot when the pipeline is off."""

    async def __aenter__(self):
        return self

    async def __aexit__(self, exc_type, exc, tb):
        return False


class CodecPipeline:
    """Per-connection codec scheduling state + counters.

    One instance per wire/rpc.py Connection. When disabled (env switch or
    legacy peer emulation) every entry point degrades to the synchronous
    in-line codec call the seed shipped."""

    def __init__(self, name: str = ""):
        self.enabled = bool(env.get("BBTPU_WIRE_PIPELINE"))
        self.depth = max(1, int(env.get("BBTPU_WIRE_PIPELINE_DEPTH")))
        self.inline_bytes = max(0, int(env.get("BBTPU_WIRE_PIPELINE_INLINE")))
        self.tx_flow = FlowLimiter(
            name=f"wire.tx:{name}" if name else "wire.tx",
            initial=2, lo=1, hi=self.depth,
        )
        self.tx_jobs = 0
        self.rx_jobs = 0
        self.rx_depth_max = 0
        self.rx_backpressure_waits = 0

    # ------------------------------------------------------------------ TX
    def tx_slot(self):
        """Bounded-send context: `async with pipeline.tx_slot(): ...`."""
        return self.tx_flow.slot() if self.enabled else _NullSlot()

    async def encode(self, tensors, compression: bool = True,
                     allowed=None):
        """Serialize a frame's tensors, off-loop when enabled and the
        payload is big enough for the thread hop to pay for itself."""
        self.tx_jobs += 1
        if (
            not self.enabled
            or not tensors
            or sum(int(getattr(t, "nbytes", 0)) for t in tensors)
            < self.inline_bytes
        ):
            return encode_now(tensors, compression, allowed)
        loop = asyncio.get_running_loop()
        return await loop.run_in_executor(
            codec_executor(), encode_now, tensors, compression, allowed
        )

    # ------------------------------------------------------------------ RX
    def decode_submit(self, metas, blobs):
        """Submit one inbound frame's decode; returns the awaitable the
        connection's ordered drain task resolves. Payloads under the
        inline threshold decode here (already-resolved future) — the
        ordered FIFO still serializes dispatch either way. Only valid
        while the pipeline is enabled."""
        self.rx_jobs += 1
        loop = asyncio.get_running_loop()
        if sum(len(b) for b in blobs) < self.inline_bytes:
            fut = loop.create_future()
            try:
                fut.set_result(decode_now(metas, blobs))
            except Exception as e:  # noqa: BLE001 — drain maps to the frame
                fut.set_exception(e)
            return fut
        return loop.run_in_executor(codec_executor(), decode_now, metas,
                                    blobs)

    async def decode_wait(self, metas, blobs):
        """Decode an inbound payload for an unordered handler (unary/push):
        off-loop when enabled and big enough, in-line otherwise."""
        self.rx_jobs += 1
        if (
            not self.enabled
            or not blobs
            or sum(len(b) for b in blobs) < self.inline_bytes
        ):
            return decode_now(metas, blobs)
        loop = asyncio.get_running_loop()
        return await loop.run_in_executor(codec_executor(), decode_now,
                                          metas, blobs)

    def note_rx_depth(self, depth: int) -> None:
        if depth > self.rx_depth_max:
            self.rx_depth_max = depth

    # ------------------------------------------------------------- counters
    def stats(self) -> dict:
        out = {
            "enabled": self.enabled,
            "depth": self.depth,
            "tx_jobs": self.tx_jobs,
            "rx_jobs": self.rx_jobs,
            "rx_depth_max": self.rx_depth_max,
            "rx_backpressure_waits": self.rx_backpressure_waits,
        }
        out.update({f"tx_{k}": v for k, v in self.tx_flow.stats().items()})
        return out

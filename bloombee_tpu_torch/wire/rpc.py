"""Async RPC over length-prefixed msgpack frames on TCP (a copy of
bloombee_tpu/wire/rpc.py: the same frames, over the port's own packer and
torch tensor codec).

Provides the reference's RPC surface (SURVEY.md section 2.7 / 5): unary calls
(`rpc_info`, `rpc_forward`, `rpc_backward`), one-way pushes (`rpc_push`), and
bidirectional streams (`rpc_inference`) — the semantics of hivemind's
libp2p/protobuf transport re-provided natively. One TCP connection multiplexes
any number of concurrent calls and streams by frame id.

Frame layout: [u32 frame_len][u32 header_len][msgpack header][tensor blobs].
The header carries method, metadata (msgpack dict — the reference's MSGPack
sidecar), and per-tensor codec metas (see tensor_codec).

Codec scheduling (wire/pipeline.py): tensor (de)serialization runs OFF
the event loop in a shared codec pool, bounded and ordered per
connection. Sends hold a FlowLimiter slot around encode+write so a slow
peer backpressures its own connection, not the loop; receives are
decoded concurrently but dispatched by a single drain task in arrival
order, so frames for one stream never reorder, and the bounded drain
queue turns a slow consumer into TCP backpressure. BBTPU_WIRE_PIPELINE=0
restores the seed's synchronous scheduling (byte-identical frames).

Codec negotiation: each side piggybacks its supported codec names
("cd" header key) on the first frames it sends. Older peers ignore
unknown header keys and never advertise, so until (unless) an advert
arrives the send path assumes tensor_codec.LEGACY_WIRE_CODECS — mixed
swarms degrade byte-for-byte to the legacy codec choice, and a future
codec ships without a flag day.
"""

from __future__ import annotations

import asyncio
import itertools
import logging
import struct
from typing import Awaitable, Callable

import torch

from bloombee_tpu_torch.utils import clock, env, lockwatch
from bloombee_tpu_torch.wire import faults, packer, tensor_codec
from bloombee_tpu_torch.wire.pipeline import CodecPipeline, decode_now

logger = logging.getLogger(__name__)

MAX_FRAME = 1 << 31  # 2 GiB

env.declare(
    "BBTPU_KEEPALIVE_S", float, 0.0,
    "keepalive interval: idle connections exchange ping/pong frames so a "
    "half-open TCP peer (partition without FIN/RST) is detected instead of "
    "hanging forever in recv(); a connection silent past ~2.5x the interval "
    "is declared dead. 0 disables keepalives (seed behavior)",
)


class RpcError(RuntimeError):
    pass


class ConnectionClosed(RpcError):
    pass


class OverloadedError(RpcError):
    """Structured retriable shed: the peer is healthy but past its
    admission high-watermark, so it refused NEW work instead of letting it
    rot in the queue until the deadline aborts it. Carries the server's
    suggested retry delay; clients treat this as reroute-then-backoff (a
    short overload penalty, never a fault ban)."""

    def __init__(self, msg: str = "server overloaded",
                 retry_after_ms: int | None = None):
        super().__init__(msg)
        self.retry_after_ms = (
            int(retry_after_ms) if retry_after_ms is not None else None
        )


def error_to_meta(e: Exception) -> dict:
    """Serialize a handler failure into an err-frame meta. Overload sheds
    keep their structure (code + retry hint) across the wire; everything
    else degrades to the legacy message string, which old peers parse
    unchanged."""
    meta = {"error": f"{type(e).__name__}: {e}"}
    if isinstance(e, OverloadedError):
        meta["code"] = "overloaded"
        if e.retry_after_ms is not None:
            meta["retry_after_ms"] = int(e.retry_after_ms)
    return meta


def error_from_meta(meta: dict) -> RpcError:
    """Inverse of error_to_meta; unknown codes fall back to plain RpcError
    so a newer peer's error classes never break an older client."""
    msg = meta.get("error", "remote error")
    if meta.get("code") == "overloaded":
        return OverloadedError(msg, retry_after_ms=meta.get("retry_after_ms"))
    return RpcError(msg)


# frame types whose payload is decoded by the ordered receive path; unary
# reqs and pushes decode inside their own handler task instead (unordered
# by design, and a bad unary payload answers with an err frame rather
# than killing the connection)
_ORDERED_FRAMES = frozenset({"sopen", "sitem", "res"})


def _frame_buffers(header: dict, blobs: list) -> list:
    """Vectored frame encoding: [u32 frame_len][u32 header_len][header]
    followed by the tensor payloads AS-IS (bytes or memoryview), ready for
    writer.writelines — the payloads are never copied into an
    intermediate frame buffer."""
    header = dict(header)
    header["bl"] = [len(b) for b in blobs]
    h = packer.packb(header)
    total = 4 + len(h) + sum(len(b) for b in blobs)
    bufs = [struct.pack("<II", total, len(h)) + h]
    bufs.extend(blobs)
    return bufs


def _encode_frame(header: dict, blobs: list) -> bytes:
    """Contiguous frame bytes (tests and tooling; the hot path writes the
    _frame_buffers sequence without this join)."""
    return b"".join(bytes(b) for b in _frame_buffers(header, blobs))


class Stream:
    """One side of a bidirectional stream (the rpc_inference session carrier,
    reference: handler.py:798-1257)."""

    def __init__(self, conn: "Connection", stream_id: int, meta: dict,
                 tensors: list[torch.Tensor]):
        self.conn = conn
        self.id = stream_id
        self.open_meta = meta
        self.open_tensors = tensors
        self._inbox: asyncio.Queue = asyncio.Queue()
        self._closed_local = False
        self._closed_remote = False

    async def send(self, meta: dict, tensors: list[torch.Tensor] | None = None,
                   compression: bool = True) -> None:
        if self._closed_local:
            raise RpcError("stream closed")
        await self.conn._send_payload(
            {"t": "sitem", "id": self.id, "meta": meta}, tensors, compression
        )

    async def recv(self) -> tuple[dict, list[torch.Tensor]] | None:
        """Next item, or None once the peer half-closed."""
        if self._closed_remote and self._inbox.empty():
            return None
        item = await self._inbox.get()
        if item is None:
            self._closed_remote = True
            return None
        if isinstance(item, Exception):
            raise item
        return item

    async def close(self, meta: dict | None = None) -> None:
        """Half-close: tells the peer no more items will be sent."""
        if not self._closed_local:
            self._closed_local = True
            if not self.conn.is_closing():
                await self.conn._send(
                    {"t": "send", "id": self.id, "meta": meta or {}}, []
                )

    def _push_inbound(self, item) -> None:
        self._inbox.put_nowait(item)


UnaryHandler = Callable[[dict, list[torch.Tensor]], Awaitable[tuple[dict, list[torch.Tensor]]]]
StreamHandler = Callable[[Stream], Awaitable[None]]
PushHandler = Callable[[dict, list[torch.Tensor]], Awaitable[None]]


class Connection:
    """A multiplexed RPC connection (either direction)."""

    def __init__(
        self,
        reader: asyncio.StreamReader,
        writer: asyncio.StreamWriter,
        unary_handlers: dict[str, UnaryHandler] | None = None,
        stream_handlers: dict[str, StreamHandler] | None = None,
        push_handlers: dict[str, PushHandler] | None = None,
        peer: tuple[str, int] | None = None,
        keepalive_s: float | None = None,
        legacy_wire: bool = False,
        codecs: frozenset | None = None,
    ):
        self.reader = reader
        self.writer = writer
        self.unary_handlers = unary_handlers or {}
        self.stream_handlers = stream_handlers or {}
        self.push_handlers = push_handlers or {}
        # remote (host, port) when known — fault rules target peers by port
        self.peer = peer or self._peername(writer)
        self.fault_plan = faults.get_plan()
        self._ids = itertools.count(1)
        self._pending: dict[int, asyncio.Future] = {}
        self._streams: dict[int, Stream] = {}
        self._unary_tasks: dict[int, asyncio.Task] = {}
        self._tasks: set[asyncio.Task] = set()
        self._send_lock = lockwatch.async_lock("rpc.send")
        self._reader_task: asyncio.Task | None = None
        self._closed = asyncio.Event()
        # --- codec negotiation + off-loop pipeline -----------------------
        # legacy_wire emulates a pre-negotiation peer (compat shim for
        # mixed-swarm tests and the bench's legacy leg): never advertise,
        # ignore adverts, codec work stays synchronous on the loop
        self.legacy_wire = bool(legacy_wire)
        self.codecs_local = (
            frozenset(codecs) | {"raw"} if codecs is not None
            else tensor_codec.supported_codecs()
        )
        # until the peer advertises, assume the pre-negotiation contract
        self.peer_codecs = tensor_codec.LEGACY_WIRE_CODECS
        self._advertised = self.legacy_wire
        self.pipeline = CodecPipeline(
            name="%s:%s" % self.peer if self.peer else ""
        )
        if self.legacy_wire:
            self.pipeline.enabled = False
        self._rx_queue: asyncio.Queue | None = (
            asyncio.Queue(maxsize=self.pipeline.depth)
            if self.pipeline.enabled else None
        )
        self._drain_task: asyncio.Task | None = None
        self.on_close: Callable[["Connection"], None] | None = None
        # keepalive state: last_recv only advances on frames that survive
        # fault injection, so an injected partition looks exactly as silent
        # as a real half-open peer
        self.keepalive_s = (
            env.get("BBTPU_KEEPALIVE_S") if keepalive_s is None
            else keepalive_s
        )
        self.last_recv = clock.monotonic()
        self.keepalives_sent = 0
        self._keepalive_task: asyncio.Task | None = None

    @staticmethod
    def _peername(writer: asyncio.StreamWriter) -> tuple[str, int] | None:
        try:
            name = writer.get_extra_info("peername")
            return (name[0], name[1]) if name else None
        except Exception:
            return None

    # ------------------------------------------------------------------ setup
    def start(self) -> None:
        self._reader_task = asyncio.create_task(self._read_loop())
        if self._rx_queue is not None:
            self._drain_task = asyncio.create_task(self._rx_drain_loop())
        if self.keepalive_s and self.keepalive_s > 0:
            self._keepalive_task = asyncio.create_task(self._keepalive_loop())

    def is_closing(self) -> bool:
        return self._closed.is_set() or self.writer.is_closing()

    async def close(self) -> None:
        self._closed.set()
        if self._reader_task is not None:
            self._reader_task.cancel()
        if self._drain_task is not None:
            self._drain_task.cancel()
        if self._keepalive_task is not None:
            self._keepalive_task.cancel()
        for t in list(self._tasks):
            t.cancel()
        try:
            self.writer.close()
            await self.writer.wait_closed()
        except Exception:
            pass
        self._fail_all(ConnectionClosed("connection closed"))

    def _fail_all(self, exc: Exception) -> None:
        for fut in self._pending.values():
            if not fut.done():
                fut.set_exception(exc)
        self._pending.clear()
        for s in self._streams.values():
            s._push_inbound(exc)

    def abort(self, reason: str = "connection aborted") -> None:
        """Fail every pending call/stream locally and kill the transport
        with no FIN handshake. Used to fence a peer we have decided is gone
        (keepalive timeout, superseded by a session resume, expired lease):
        everyone blocked on this connection unwedges NOW instead of
        whenever TCP notices."""
        self._fail_all(ConnectionClosed(reason))
        self._closed.set()
        if self._drain_task is not None:
            self._drain_task.cancel()
        try:
            transport = self.writer.transport
            if transport is not None:
                transport.abort()
        except Exception:
            pass
        self._streams.clear()

    # -------------------------------------------------------------- client API
    async def call(
        self,
        method: str,
        meta: dict | None = None,
        tensors: list[torch.Tensor] | None = None,
        timeout: float | None = None,
        compression: bool = True,
    ) -> tuple[dict, list[torch.Tensor]]:
        rid = next(self._ids)
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        self._pending[rid] = fut
        await self._send_payload(
            {"t": "req", "id": rid, "m": method, "meta": meta or {}},
            tensors, compression,
        )
        try:
            return await asyncio.wait_for(fut, timeout)
        except asyncio.TimeoutError:
            # the caller is abandoning this call: tell the server so it can
            # stop computing for a client that will never read the reply
            if not self.is_closing():
                try:
                    await self._send({"t": "cancel", "id": rid}, [])
                except Exception:
                    pass  # best-effort; the timeout still propagates
            raise
        finally:
            self._pending.pop(rid, None)

    async def push(
        self,
        method: str,
        meta: dict | None = None,
        tensors: list[torch.Tensor] | None = None,
        compression: bool = True,
    ) -> None:
        """Fire-and-forget (the reference's rpc_push plane)."""
        await self._send_payload(
            {"t": "push", "id": 0, "m": method, "meta": meta or {}},
            tensors, compression,
        )

    async def open_stream(
        self,
        method: str,
        meta: dict | None = None,
        tensors: list[torch.Tensor] | None = None,
        compression: bool = True,
    ) -> Stream:
        rid = next(self._ids)
        stream = Stream(self, rid, meta or {}, tensors or [])
        self._streams[rid] = stream
        await self._send_payload(
            {"t": "sopen", "id": rid, "m": method, "meta": meta or {}},
            tensors, compression,
        )
        return stream

    # --------------------------------------------------------------- internals
    def _allowed_codecs(self) -> frozenset:
        """Send-codec set for this peer: the negotiated intersection (the
        from_wire compat-filtering spirit, applied to codecs)."""
        return (self.peer_codecs & self.codecs_local) | {"raw"}

    async def _send_payload(
        self,
        header: dict,
        tensors: list[torch.Tensor] | None,
        compression: bool = True,
    ) -> None:
        """Encode + send one tensor-carrying frame. Serialization runs in
        the codec pool under a FlowLimiter slot: a peer that drains slowly
        inflates this connection's send times, the AIMD law shrinks its
        concurrency, and waiters park on the limiter instead of stacking
        encoded frames in memory or convoying the event loop."""
        async with self.pipeline.tx_slot():
            tm, blobs = await self.pipeline.encode(
                tensors or [], compression, self._allowed_codecs()
            )
            header["tm"] = tm
            await self._send(header, blobs)

    async def _send(self, header: dict, blobs: list) -> None:
        if not self._advertised:
            # negotiation advert rides the first outgoing frame(s): older
            # peers ignore unknown header keys, newer peers switch their
            # send codecs to the intersection. Repeated until one frame is
            # known written, so an injected drop can't eat the advert.
            header = dict(header)
            header["cd"] = sorted(self.codecs_local)
        if self.fault_plan is not None:
            # may sleep (delayed frame), raise after killing the transport
            # (injected reset / mid-stream close / stalled write), mutate
            # header+blobs in place (injected payload corruption — the
            # frame below is encoded from the mutated pair), or ask for a
            # silent discard (injected partition blackhole)
            if await self.fault_plan.on_send(self, header, blobs) == "drop":
                return
        bufs = _frame_buffers(header, blobs)
        async with self._send_lock:
            # a closed transport's writelines fails inside asyncio with a
            # TypeError on Python 3.12: fail with the wire's own error
            if self.writer.is_closing():
                raise ConnectionClosed("connection closed")
            self.writer.writelines(bufs)
            await self.writer.drain()
        self._advertised = True

    async def _keepalive_loop(self) -> None:
        """Ping on idle, declare the peer dead when silent too long.

        A half-open connection (peer partitioned without FIN/RST) never
        errors recv() — this loop is the only thing that unwedges it: after
        ~2.5 intervals with no inbound frame the transport is aborted and
        every pending call/stream fails with ConnectionClosed, exactly like
        a real disconnect (retry paths must not special-case it)."""
        interval = self.keepalive_s
        try:
            while not self._closed.is_set():
                await clock.async_sleep(interval / 2)
                idle = clock.monotonic() - self.last_recv
                if idle >= 2.5 * interval:
                    logger.warning(
                        "keepalive timeout after %.2fs silence from %s",
                        idle, self.peer,
                    )
                    self.abort("keepalive timeout")
                    break
                if idle >= interval / 2:
                    try:
                        await self._send({"t": "ping", "id": 0}, [])
                        self.keepalives_sent += 1
                    except Exception:
                        pass  # the read loop will surface the real error
        except asyncio.CancelledError:
            pass

    async def _read_loop(self) -> None:
        try:
            while True:
                head = await self.reader.readexactly(8)
                total, hlen = struct.unpack("<II", head)
                if total > MAX_FRAME:
                    raise RpcError(f"frame too large: {total}")
                body = await self.reader.readexactly(total - 4)
                header = packer.unpackb(body[:hlen])
                # zero-copy receive: slice the frame body into memoryviews
                # so the codec reads payloads without copying the frame
                mv = memoryview(body)
                blobs = []
                off = hlen
                for blen in header.get("bl", []):
                    blobs.append(mv[off : off + blen])
                    off += blen
                if self.fault_plan is not None:
                    act = await self.fault_plan.on_read(self, header)
                    if act == "drop":
                        continue  # injected stall/loss: frame never arrives
                self.last_recv = clock.monotonic()
                cd = header.get("cd")
                if cd and not self.legacy_wire:
                    self.peer_codecs = frozenset(str(c) for c in cd)
                await self._ingest(header, blobs)
        except (asyncio.IncompleteReadError, ConnectionResetError):
            pass
        except asyncio.CancelledError:
            return
        except Exception as e:  # pragma: no cover
            logger.exception("rpc read loop error: %s", e)
        finally:
            self._closed.set()
            if self._keepalive_task is not None:
                self._keepalive_task.cancel()
            await self._flush_drain()
            self._fail_all(ConnectionClosed("peer disconnected"))
            # close our side of the transport too: asyncio.Server.wait_closed
            # blocks until every accepted connection's transport is closed
            try:
                self.writer.close()
            except Exception:
                pass
            if self.on_close is not None:
                self.on_close(self)

    async def _ingest(self, header: dict, blobs: list) -> None:
        """Route one inbound frame toward _dispatch.

        Pipelined: ordered frames get their decode submitted to the codec
        pool NOW (overlapping the next socket read) and everything goes
        through the bounded FIFO the drain task empties — a full queue
        stalls this coroutine, which stalls the socket: TCP backpressure.
        Legacy sync mode decodes in-line and dispatches immediately (the
        seed's exact scheduling)."""
        t = header["t"]
        if self._rx_queue is None:
            if t in _ORDERED_FRAMES:
                self._dispatch(
                    header, decode_now(header.get("tm") or [], blobs)
                )
            else:
                self._dispatch(header, blobs)
            return
        aw = None
        if t in _ORDERED_FRAMES:
            aw = self.pipeline.decode_submit(header.get("tm") or [], blobs)
        if self._rx_queue.full():
            self.pipeline.rx_backpressure_waits += 1
        self.pipeline.note_rx_depth(self._rx_queue.qsize() + 1)
        await self._rx_queue.put((header, blobs, aw))

    async def _rx_drain_loop(self) -> None:
        """Single consumer of the receive queue: awaits each frame's decode
        in ARRIVAL order before dispatching, so off-loop concurrency can
        never reorder the frames of one stream."""
        try:
            while True:
                item = await self._rx_queue.get()
                if item is None:
                    return
                header, blobs, aw = item
                if aw is not None:
                    try:
                        payload = await aw
                    except Exception as e:
                        self._decode_failed(header, e)
                        continue
                else:
                    payload = blobs
                try:
                    self._dispatch(header, payload)
                except Exception:
                    logger.exception("rpc dispatch error")
                    self.abort("dispatch error")
                    return
        except asyncio.CancelledError:
            pass

    async def _flush_drain(self) -> None:
        """Read-loop teardown: frames already queued (a res some caller is
        awaiting) still dispatch before everyone gets failed."""
        if self._drain_task is None or self._drain_task.done():
            return
        try:
            self._rx_queue.put_nowait(None)
        except asyncio.QueueFull:
            self._drain_task.cancel()
        try:
            await self._drain_task
        except (asyncio.CancelledError, Exception):
            pass

    def _decode_failed(self, header: dict, exc: Exception) -> None:
        """A frame that parsed but whose payload fails the codec is a peer
        bug (or injected corruption): fail the one call/stream it belongs
        to and keep the connection — the other multiplexed users are
        unaffected."""
        t, rid = header.get("t"), header.get("id")
        err = RpcError(f"codec error on {t} frame: {exc}")
        logger.warning("%s from %s", err, self.peer)
        if t == "res":
            fut = self._pending.get(rid)
            if fut is not None and not fut.done():
                fut.set_exception(err)
        elif t == "sitem":
            stream = self._streams.get(rid)
            if stream is not None:
                stream._push_inbound(err)
        elif t == "sopen":
            # no Stream exists yet on this side; tell the opener
            self._spawn(self._send(
                {"t": "err", "id": rid, "meta": {"error": str(err)}}, []
            ))

    def _dispatch(self, header: dict, payload: list) -> None:
        """payload: decoded tensors for ordered frames (sopen/sitem/res),
        raw blob buffers for req/push — their handler tasks decode
        off-loop themselves so a bad unary payload answers with an err
        frame instead of killing the connection."""
        t = header["t"]
        rid = header["id"]
        if t == "req":
            task = asyncio.create_task(self._handle_unary(header, payload))
            self._tasks.add(task)
            task.add_done_callback(self._tasks.discard)
            # indexed by request id so a later "cancel" frame can stop it
            self._unary_tasks[rid] = task
            task.add_done_callback(
                lambda _t, rid=rid: self._unary_tasks.pop(rid, None)
            )
        elif t == "cancel":
            # peer abandoned a unary call (client-side wait_for timeout):
            # stop the in-flight handler; no reply is expected
            task = self._unary_tasks.pop(rid, None)
            if task is not None and not task.done():
                task.cancel()
        elif t == "push":
            self._spawn(self._handle_push(header, payload))
        elif t == "sopen":
            stream = Stream(self, rid, header.get("meta", {}), payload)
            self._streams[rid] = stream
            self._spawn(self._handle_stream(header["m"], stream))
        elif t == "sitem":
            stream = self._streams.get(rid)
            if stream is not None:
                stream._push_inbound((header.get("meta", {}), payload))
        elif t == "send":
            stream = self._streams.get(rid)
            if stream is not None:
                stream._push_inbound(None)
        elif t == "res":
            fut = self._pending.get(rid)
            if fut is not None and not fut.done():
                fut.set_result((header.get("meta", {}), payload))
        elif t == "err":
            fut = self._pending.get(rid)
            if fut is not None and not fut.done():
                fut.set_exception(error_from_meta(header.get("meta", {})))
            stream = self._streams.get(rid)
            if stream is not None:
                stream._push_inbound(error_from_meta(header.get("meta", {})))
        elif t == "ping":
            # keepalive probe: answer even when we have no keepalive loop of
            # our own, so a one-sided rollout still detects half-open links
            self._spawn(self._send_pong())
        elif t == "pong":
            pass  # liveness already recorded by the read loop
        else:
            logger.warning("unknown frame type %r", t)

    def _spawn(self, coro) -> None:
        task = asyncio.create_task(coro)
        self._tasks.add(task)
        task.add_done_callback(self._tasks.discard)

    async def _send_pong(self) -> None:
        try:
            if not self.is_closing():
                await self._send({"t": "pong", "id": 0}, [])
        except Exception:
            pass  # a dying transport surfaces through the read loop

    async def _handle_unary(self, header: dict, blobs: list) -> None:
        rid = header["id"]
        method = header["m"]
        try:
            handler = self.unary_handlers.get(method)
            if handler is None:
                raise RpcError(f"no such method: {method}")
            tensors = await self.pipeline.decode_wait(
                header.get("tm", []), blobs
            )
            meta, out = await handler(header.get("meta", {}), tensors)
            await self._send_payload({"t": "res", "id": rid, "meta": meta}, out)
        except asyncio.CancelledError:
            # cancelled by a peer "cancel" frame (abandoned call) or by
            # connection teardown: either way nobody is reading the reply
            logger.debug("unary handler %s cancelled", method)
        except Exception as e:
            logger.debug("unary handler %s failed: %s", method, e)
            if not self.is_closing():
                await self._send(
                    {"t": "err", "id": rid, "meta": error_to_meta(e)},
                    [],
                )

    async def _handle_push(self, header: dict, blobs: list) -> None:
        method = header["m"]
        handler = self.push_handlers.get(method)
        if handler is None:
            logger.warning("no push handler for %s", method)
            return
        tensors = await self.pipeline.decode_wait(header.get("tm", []), blobs)
        try:
            await handler(header.get("meta", {}), tensors)
        except Exception as e:
            logger.exception("push handler %s failed: %s", method, e)

    async def _handle_stream(self, method: str, stream: Stream) -> None:
        handler = self.stream_handlers.get(method)
        if handler is None:
            await self._send(
                {"t": "err", "id": stream.id,
                 "meta": {"error": f"no such stream method: {method}"}},
                [],
            )
            return
        try:
            await handler(stream)
        except OverloadedError as e:
            # expected shed under load, not a server fault: no stack trace
            logger.info("stream handler %s shed: %s", method, e)
            if not self.is_closing():
                await self._send(
                    {"t": "err", "id": stream.id, "meta": error_to_meta(e)},
                    [],
                )
        except Exception as e:
            logger.exception("stream handler %s failed: %s", method, e)
            if not self.is_closing():
                await self._send(
                    {"t": "err", "id": stream.id, "meta": error_to_meta(e)},
                    [],
                )
        finally:
            self._streams.pop(stream.id, None)


class RpcServer:
    """Listening side: accepts connections, one Connection per peer."""

    def __init__(
        self,
        unary_handlers: dict[str, UnaryHandler] | None = None,
        stream_handlers: dict[str, StreamHandler] | None = None,
        push_handlers: dict[str, PushHandler] | None = None,
        host: str = "0.0.0.0",
        port: int = 0,
        keepalive_s: float | None = None,
        legacy_wire: bool = False,
        codecs: frozenset | None = None,
    ):
        self.unary_handlers = unary_handlers or {}
        self.stream_handlers = stream_handlers or {}
        self.push_handlers = push_handlers or {}
        self.host = host
        self.port = port
        self.keepalive_s = keepalive_s
        self.legacy_wire = legacy_wire
        self.codecs = codecs
        self._server: asyncio.AbstractServer | None = None
        self._conns: set[Connection] = set()
        # cumulative pings from already-closed connections; live ones are
        # summed on demand (keepalives_sent property)
        self._keepalives_closed = 0
        # same pattern for the codec-pipeline counters
        self._pipeline_closed = {
            "tx_jobs": 0, "rx_jobs": 0,
            "rx_depth_max": 0, "rx_backpressure_waits": 0,
        }

    @property
    def keepalives_sent(self) -> int:
        return self._keepalives_closed + sum(
            c.keepalives_sent for c in self._conns
        )

    def pipeline_stats(self) -> dict:
        """Aggregated off-loop codec pipeline counters: live connections
        plus the already-closed accumulator. Surfaced through rpc_info so
        cli/health --probe can print them (BB006)."""
        out = dict(self._pipeline_closed)
        out["conns"] = len(self._conns)
        out["enabled"] = False
        out["tx_limit"] = 0
        for c in self._conns:
            s = c.pipeline.stats()
            out["enabled"] = out["enabled"] or s["enabled"]
            out["tx_jobs"] += s["tx_jobs"]
            out["rx_jobs"] += s["rx_jobs"]
            out["rx_backpressure_waits"] += s["rx_backpressure_waits"]
            out["rx_depth_max"] = max(out["rx_depth_max"], s["rx_depth_max"])
            out["tx_limit"] = max(out["tx_limit"], s["tx_limit"])
        return out

    async def start(self) -> None:
        self._server = await asyncio.start_server(
            self._on_connect, self.host, self.port
        )
        self.port = self._server.sockets[0].getsockname()[1]

    async def _on_connect(
        self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter
    ) -> None:
        conn = Connection(
            reader, writer,
            self.unary_handlers, self.stream_handlers, self.push_handlers,
            keepalive_s=self.keepalive_s,
            legacy_wire=self.legacy_wire, codecs=self.codecs,
        )
        conn.on_close = self._on_conn_close
        self._conns.add(conn)
        conn.start()

    def _on_conn_close(self, conn: Connection) -> None:
        if conn in self._conns:
            self._keepalives_closed += conn.keepalives_sent
            s = conn.pipeline.stats()
            acc = self._pipeline_closed
            acc["tx_jobs"] += s["tx_jobs"]
            acc["rx_jobs"] += s["rx_jobs"]
            acc["rx_backpressure_waits"] += s["rx_backpressure_waits"]
            acc["rx_depth_max"] = max(acc["rx_depth_max"], s["rx_depth_max"])
        self._conns.discard(conn)

    async def stop(self) -> None:
        for c in list(self._conns):
            await c.close()
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()

    def abort(self) -> None:
        """Hard-kill (crash fault injection): abort every live
        connection's transport — no close frame, no FIN handshake, every
        pending call on the peer side fails exactly like a process death
        — and close the listener without waiting for it."""
        for c in list(self._conns):
            c.abort("server crashed")
        if self._server is not None:
            self._server.close()
            self._server = None


async def connect(
    host: str,
    port: int,
    unary_handlers: dict[str, UnaryHandler] | None = None,
    stream_handlers: dict[str, StreamHandler] | None = None,
    push_handlers: dict[str, PushHandler] | None = None,
    keepalive_s: float | None = None,
    legacy_wire: bool = False,
    codecs: frozenset | None = None,
) -> Connection:
    reader, writer = await asyncio.open_connection(host, port)
    conn = Connection(
        reader, writer, unary_handlers, stream_handlers, push_handlers,
        peer=(host, port), keepalive_s=keepalive_s,
        legacy_wire=legacy_wire, codecs=codecs,
    )
    conn.start()
    return conn

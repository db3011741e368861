"""InferenceSession: client-side stateful decode across the span chain (the
port of bloombee_tpu/client/session.py's main path).

Reference client/inference_session.py:438-855: owns one rpc_inference
stream per span, steps hidden states through the chain, and on a span
failure re-routes the chain and replays the input history into the
replacement servers to rebuild their KV caches (`_update_sequence`,
:802-831). Supports server-to-server push-only decode: the client sends
only to span 0 and each hop forwards activations directly (reference
ClientConfig.push_only_downstream_decode, config.py:19-42).

Hidden states are torch tensors on the client's device. A step's output
is gathered in f32 there, as the JAX client gathers it; replies arrive
from the codec as CPU tensors and move to the device once per chunk.

Not ported yet, and refused with NotImplementedError naming the ROADMAP
item: the speculative arguments of `step` (`tree_mask`, `depths`,
`accept`, `prune`, `accept_per_span`, `rows`) and `send_accept` (item
13), `decode_n` (item 11) and `rewind_decoded_tail` (items 11, 13). The
prefix probe, standby replication and reconnect-resume (item 12) and the
cross-replica audits (item 19) are reached only through `ClientConfig`
fields, which refuse them (client/config.py).
"""

from __future__ import annotations

import asyncio
import logging
import random
import time
import uuid

import torch

from bloombee_tpu_torch.client.integrity import (
    IntegrityError,
    SanityGate,
    out_digest,
)
from bloombee_tpu_torch.client.sequence_manager import (
    MissingBlocksError,
    RemoteSequenceManager,
)
from bloombee_tpu_torch.swarm.data import RemoteSpanInfo
from bloombee_tpu_torch.utils import env, ledger
from bloombee_tpu_torch.wire.rpc import (
    Connection,
    OverloadedError,
    RpcError,
    Stream,
    connect,
)
from bloombee_tpu_torch.wire.tensor_codec import (
    dtype_for_name,
    transport_stats,
)

logger = logging.getLogger(__name__)

env.declare(
    "BBTPU_MICROBATCH", int, 1,
    "default within-stage micro-batch count for client sessions (>1 splits "
    "each step's batch so stage N+1 computes chunk k while stage N computes "
    "k+1 — the reference's BLOOMBEE_MICRO_BATCH_SIZE overlap)",
)

# default admission-control identity: one id per client process, so all of
# a process's sessions share one fair-share bucket server-side
_PROCESS_CLIENT_ID = f"cli-{uuid.uuid4().hex[:8]}"

# step arguments and methods of the JAX session this port lacks ->
# (what they ask for, ROADMAP Queue 1 item)
_UNPORTED = {
    "tree_mask": ("speculative tree steps", "13"),
    "depths": ("speculative tree steps", "13"),
    "accept": ("speculative accepts", "13"),
    "prune": ("mid-chain tree pruning", "13"),
    "accept_per_span": ("mid-chain tree pruning", "13"),
    "rows": ("live-row windows of tree steps", "13"),
    "send_accept": ("speculative accepts", "13"),
    "decode_n": ("server-side multi-step decode", "11"),
    "rewind_decoded_tail": ("server-side decode with speculative rewind",
                            "11 and 13"),
}


def _unported(name: str) -> NotImplementedError:
    what, item = _UNPORTED[name]
    return NotImplementedError(
        f"{name} asks for {what}, which the port's client does not have yet "
        f"(ROADMAP Queue 1 item {item})"
    )


def _raise_if_session_lost(resp_meta: dict) -> None:
    """Typed `session_lost` reply: the server is healthy but this session's
    KV is gone. Raise a plain wire error so the caller's retry loop
    recovers and replays WITHOUT banning the peer."""
    if resp_meta.get("session_lost"):
        raise RpcError(resp_meta.get("reason", "session KV lost"))


def _sanitize_retry_ms(retry_ms) -> int | None:
    try:
        v = int(retry_ms)
    except (TypeError, ValueError):
        return None
    return v if v > 0 else None


class _SpanSession:
    """One open rpc_inference stream to one server
    (reference _ServerInferenceSession)."""

    def __init__(self, span: RemoteSpanInfo, conn: Connection, stream: Stream,
                 session_id: str):
        self.span = span
        self.conn = conn
        self.stream = stream
        self.session_id = session_id

    async def close(self):
        try:
            await self.stream.close()
        except Exception:
            pass
        try:
            await self.conn.close()
        except Exception:
            pass


class InferenceSession:
    def __init__(
        self,
        manager: RemoteSequenceManager,
        max_length: int,
        batch_size: int = 1,
        use_push: bool = True,
        max_retries: int = 3,
        step_timeout: float = 120.0,
        microbatch: int | str | None = None,  # count or "auto"
        embed_fn=None,  # ids [B, T] -> hidden; enables token-id replay
        client_id: str | None = None,  # admission-control identity (None ->
        # one shared id per client process)
        overload_retries: int = 10,  # `overloaded` sheds a step rides out
        # (backoff + reroute) before failing: a separate budget from
        # max_retries, since a shed is the server working as designed
        keepalive_s: float | None = None,  # client-side wire keepalive
        # (None -> BBTPU_KEEPALIVE_S env; 0 disables)
        integrity: bool | None = None,  # inline sanity gate + out_digest
        # verification on every received span output; rejects strike the
        # peer and heal via reroute + replay (None -> BBTPU_INTEGRITY env)
    ):
        self.manager = manager
        self.max_length = max_length
        self.batch_size = batch_size
        self.use_push = use_push
        self.max_retries = max_retries
        self.step_timeout = step_timeout
        self.client_id = client_id or _PROCESS_CLIENT_ID
        self.overload_retries = max(0, int(overload_retries))
        self.embed_fn = embed_fn
        self.keepalive_s = keepalive_s
        self.integrity = (
            bool(env.get("BBTPU_INTEGRITY")) if integrity is None
            else bool(integrity)
        )
        self._gate = SanityGate() if self.integrity else None
        # integrity observability (tests read these)
        self.sanity_rejects = 0
        self.integrity_reroutes = 0
        # tokens re-prefilled by recoveries
        self.failover_replayed_tokens = 0
        # within-stage micro-batch pipelining (reference
        # microbatch_config.py:84-130 overlap-only mode)
        self.microbatch = (
            microbatch if microbatch is not None
            else env.get("BBTPU_MICROBATCH")
        )
        if not (
            self.microbatch == "auto"
            or (isinstance(self.microbatch, int) and self.microbatch >= 1)
        ):
            raise ValueError(
                f"microbatch must be >= 1 or 'auto', got {self.microbatch!r}"
            )
        self._spans: list[_SpanSession] = []
        # failure-replay history. Preferred: per-row committed token ids
        # (ragged; replayed by re-embedding, as the reference replays ids,
        # inference_session.py:802-831). Fallback without an embed_fn:
        # the stored hidden tensors.
        self._id_rows: list[list[int]] = [[] for _ in range(batch_size)]
        self._history: list[torch.Tensor] = []
        self._step_counter = 0
        self.position = 0
        # per-step timing rows: per-span compute ms and the wall ms
        self.timings: list[dict] = []

    # ------------------------------------------------------------- lifecycle
    async def __aenter__(self) -> "InferenceSession":
        await self.manager.update(force=True)
        route = self.manager.make_sequence(
            cache_tokens_needed=self.batch_size * self.max_length,
            relay=not self.use_push,
        )
        self._spans = [await self._open_span(s) for s in route]
        return self

    async def __aexit__(self, *exc) -> None:
        await self.close()

    async def close(self) -> None:
        for s in self._spans:
            await s.close()
        self._spans = []

    async def _open_span(self, span: RemoteSpanInfo) -> _SpanSession:
        session_id = f"sess-{uuid.uuid4().hex[:12]}"
        conn = await connect(
            span.server_info.host, span.server_info.port,
            keepalive_s=self.keepalive_s,
        )
        stream = await conn.open_stream(
            "rpc_inference",
            {
                "session_id": session_id,
                "batch_size": self.batch_size,
                "max_length": self.max_length,
                "start": span.start,
                "end": span.end,
                "client_id": self.client_id,
            },
        )
        return _SpanSession(span, conn, stream, session_id)

    def _raise_if_shed(self, resp_meta: dict, peer_id: str) -> None:
        """Typed `overloaded` reply: penalize the peer with the SHORT
        overload class — never a fault ban — and raise the retriable error
        so step()'s overload handler backs off and reroutes."""
        if not resp_meta.get("overloaded"):
            return
        retry_ms = _sanitize_retry_ms(resp_meta.get("retry_after_ms"))
        self.manager.note_peer_overloaded(
            peer_id,
            retry_after_s=retry_ms / 1000.0 if retry_ms else None,
        )
        raise OverloadedError(
            resp_meta.get("reason", "server overloaded"),
            retry_after_ms=retry_ms,
        )

    def _note_shed_exc(self, e: OverloadedError, peer_id: str) -> None:
        """Wire-level overloaded err frame (session-open shed): short
        overload penalty instead of a fault ban."""
        self.manager.note_peer_overloaded(
            peer_id,
            retry_after_s=(
                e.retry_after_ms / 1000.0 if e.retry_after_ms else None
            ),
        )

    # ------------------------------------------------------------------ steps
    async def step(
        self,
        hidden,  # [B, T, D] tensor (or numpy array)
        commit: bool = True,
        tree_mask=None,
        depths=None,
        accept=None,
        ids=None,  # [B, T] (tensor or numpy): enables token-id replay
        commit_lens: list | None = None,
        prune=None,
        accept_per_span=None,
        rows=None,
    ) -> torch.Tensor:
        """Push hidden through the whole chain; returns the last span's
        output, f32, on hidden's device."""
        for name, value in (
            ("tree_mask", tree_mask), ("depths", depths), ("accept", accept),
            ("prune", prune), ("accept_per_span", accept_per_span),
            ("rows", rows),
        ):
            if value is not None:
                raise _unported(name)
        hidden = torch.as_tensor(hidden)
        attempt = 0
        overload_waits = 0
        while True:
            try:
                out = await self._step_once(hidden, commit, commit_lens)
                if commit:
                    if ids is not None and self.embed_fn is not None:
                        for i, row in enumerate(torch.as_tensor(ids).tolist()):
                            self._id_rows[i].extend(int(t) for t in row)
                    else:
                        self._history.append(hidden)
                    self.position += hidden.shape[1]
                return out
            except OverloadedError as e:
                # retriable shed: the peer told us to go elsewhere, not that
                # it is broken; honor its retry_after hint, then reroute
                overload_waits += 1
                if overload_waits > self.overload_retries:
                    raise
                wait_s = min((e.retry_after_ms or 500) / 1000.0, 5.0)
                wait_s *= random.uniform(0.75, 1.25)
                logger.info(
                    "step shed by overloaded server (%s); rerouting in "
                    "%.2fs (shed %d/%d)",
                    e, wait_s, overload_waits, self.overload_retries,
                )
                await asyncio.sleep(wait_s)
                try:
                    await self._recover()
                except (
                    RpcError, OSError, asyncio.TimeoutError,
                    MissingBlocksError,
                ) as e2:
                    logger.warning("recovery after shed failed: %s", e2)
            except (RpcError, OSError, asyncio.TimeoutError) as e:
                attempt += 1
                if attempt > self.max_retries:
                    raise
                logger.warning(
                    "step failed (%s); re-routing (attempt %d)", e, attempt
                )
                try:
                    await self._recover()
                except (
                    RpcError, OSError, asyncio.TimeoutError,
                    MissingBlocksError,
                ) as e2:
                    logger.warning("recovery attempt failed: %s", e2)
                    await asyncio.sleep(min(0.2 * attempt, 2.0))

    def _note_spans_ok(self) -> None:
        """A full step succeeded through every span: clear any ban history
        (half-open probes resolve to healthy; backoff resets to base)."""
        for s in self._spans:
            self.manager.note_peer_ok(s.span.peer_id)

    # ------------------------------------------------------------- integrity
    def _check_span_output(self, span_sess, resp_meta, chunk) -> None:
        """Inline checks on one received span-output chunk, BEFORE it
        enters the output buffer or is relayed on: the digest first (the
        server hashed the exact bytes it serialized), then the sanity
        gate (all-finite + activation-RMS envelope)."""
        span = span_sess.span
        digest = resp_meta.get("out_digest")
        verified = False
        if digest is not None:
            if out_digest(chunk) != digest:
                # bytes changed between serialization and us: evidence
                # against the wire, not the peer — short ban, no strike
                self._integrity_reject(
                    span.peer_id,
                    "out_digest mismatch (in-flight corruption)",
                    strike=False, ban=True,
                )
            verified = True
        reason = self._gate.check((span.start, span.end), chunk)
        if reason is not None:
            # a digest-verified reject is the peer's own computation: a
            # strike without a ban (conviction needs repeat evidence);
            # without a digest the wire could be at fault: short ban too
            self._integrity_reject(
                span.peer_id, reason, strike=True, ban=not verified
            )

    def _integrity_reject(
        self, peer_id: str, reason: str, strike: bool, ban: bool
    ) -> None:
        """An integrity check failed: raise into the retry loop, which
        heals it by reroute + replay. `strike` counts a quarantine strike;
        `ban` takes the ordinary short fault ban."""
        self.sanity_rejects += 1
        self.integrity_reroutes += 1
        if strike:
            self.manager.note_integrity_strike(peer_id)
        if ban:
            self.manager.ban_peer(peer_id)
        logger.warning(
            "integrity reject: %s from peer %s; rerouting", reason, peer_id
        )
        raise IntegrityError(f"span output rejected ({reason})")

    async def _step_once(self, hidden, commit, commit_lens=None):
        if not self._spans:
            # a failed recovery left no open chain; surface as a retryable
            # wire error so the caller's retry loop attempts recovery again
            raise RpcError("session chain is closed (recovery pending)")
        step_id = self._step_counter
        self._step_counter += 1
        meta_base = {
            "step": step_id,
            "commit": commit,
            "tree": False,
            # remaining-time budget: the server aborts work this client
            # has already given up on
            "deadline_s": self.step_timeout,
        }
        if commit_lens is not None:
            meta_base["commit_lens"] = [int(x) for x in commit_lens]
        # ship hidden in the first span's advertised wire dtype (bf16 for
        # bf16-compute servers: half the bytes on the latency-critical hop)
        wire_dt = dtype_for_name(self._spans[0].span.server_info.wire_dtype)
        hidden_w = hidden.to(wire_dt)

        # within-stage micro-batching: plain committed steps only
        b = hidden.shape[0]
        mb = self.microbatch
        if mb == "auto":
            # size chunks to the pipeline depth: overlap pays when there is
            # more than one stage, and more chunks than stages adds
            # per-chunk overhead without more overlap
            mb = (
                min(b, max(2, len(self._spans)))
                if len(self._spans) > 1 and b > 1
                else 1
            )
        if commit_lens is not None or mb > b:
            mb = 1
        bounds = [
            (round(k * b / mb), round((k + 1) * b / mb)) for k in range(mb)
        ]

        route = []
        if self.use_push and len(self._spans) > 1:
            route = [
                {
                    "host": s.span.server_info.host,
                    "port": s.span.server_info.port,
                    "session_id": s.session_id,
                }
                for s in self._spans[1:]
            ]
        for k, (lo, hi) in enumerate(bounds):
            meta = {
                **meta_base,
                "reply": "tensor",
                "mb": k,
                "mb_of": mb,
                "rows": [lo, hi],
            }
            if route:
                meta["route"] = route
            await self._spans[0].stream.send(meta, [hidden_w[lo:hi]])

        t_start = time.perf_counter()
        out = torch.zeros(hidden.shape, dtype=torch.float32,
                          device=hidden.device)
        got_tensor = False
        compute_ms = []
        for i, span_sess in enumerate(self._spans):
            span_ms = 0.0
            for _ in range(mb):
                try:
                    item = await asyncio.wait_for(
                        span_sess.stream.recv(), self.step_timeout
                    )
                except OverloadedError as e:
                    self._note_shed_exc(e, span_sess.span.peer_id)
                    raise
                except (RpcError, OSError, asyncio.TimeoutError):
                    self.manager.ban_peer(span_sess.span.peer_id)
                    raise
                if item is None:
                    self.manager.ban_peer(span_sess.span.peer_id)
                    raise RpcError(f"span {i} closed mid-session")
                resp_meta, resp_tensors = item
                _raise_if_session_lost(resp_meta)
                self._raise_if_shed(resp_meta, span_sess.span.peer_id)
                if resp_meta.get("t_compute_ms") is not None:
                    span_ms += resp_meta["t_compute_ms"]
                if resp_meta.get("ack"):
                    continue
                lo, hi = resp_meta.get("rows") or (0, b)
                chunk = resp_tensors[0]
                if self._gate is not None:
                    # inline integrity BEFORE this chunk enters `out` or
                    # gets forwarded to the next span
                    self._check_span_output(span_sess, resp_meta, chunk)
                out[lo:hi] = chunk.to(device=out.device, dtype=torch.float32)
                got_tensor = True
                if not self.use_push and i + 1 < len(self._spans):
                    # relay mode: forward each chunk as it lands so the next
                    # span starts while this span computes the next chunk
                    fwd_meta = {
                        **meta_base,
                        "reply": "tensor",
                        "mb": resp_meta.get("mb", 0),
                        "mb_of": mb,
                        "rows": [lo, hi],
                    }
                    await self._spans[i + 1].stream.send(fwd_meta, [chunk])
            compute_ms.append(span_ms)
        if not got_tensor:
            raise RpcError("no span returned a tensor")
        self._note_spans_ok()
        self.timings.append(
            {
                "step": step_id,
                "tokens": hidden.shape[1],
                "span_compute_ms": compute_ms,
                "total_ms": (time.perf_counter() - t_start) * 1000.0,
            }
        )
        return out

    def timing_summary(self) -> dict:
        """Aggregate decode-step timing: mean per-span compute vs wire and
        other (the client-side view of the reference's timing tables)."""
        decode = [t for t in self.timings if t["tokens"] == 1]
        rows = decode or self.timings
        if not rows:
            return {}
        n_spans = max(len(t["span_compute_ms"]) for t in rows)
        per_span = []
        for i in range(n_spans):
            xs = [
                t["span_compute_ms"][i] for t in rows
                if len(t["span_compute_ms"]) > i
                and t["span_compute_ms"][i] is not None
            ]
            per_span.append(sum(xs) / len(xs) if xs else 0.0)
        total = sum(t["total_ms"] for t in rows) / len(rows)
        return {
            "steps": len(rows),
            "mean_total_ms": total,
            "mean_compute_ms_per_span": per_span,
            "mean_wire_and_overhead_ms": total - sum(per_span),
            # process-wide codec counters
            "transport": transport_stats(),
            # per-span off-loop codec pipeline counters (wire/pipeline.py)
            "wire_pipeline": [
                s.conn.pipeline.stats() for s in self._spans
                if s.conn is not None
            ],
        }

    def record_history_ids(self, rows: list[list[int]]) -> None:
        """Ragged per-row committed token ids. Requires embed_fn: id
        history can only be replayed by re-embedding."""
        if self.embed_fn is None:
            raise ValueError(
                "record_history_ids needs a session with embed_fn "
                "(model.inference_session provides it)"
            )
        for i, row in enumerate(rows):
            self._id_rows[i].extend(int(t) for t in row)

    async def decode_n(self, *args, **kwargs):
        raise _unported("decode_n")

    async def send_accept(self, *args, **kwargs):
        raise _unported("send_accept")

    def rewind_decoded_tail(self, *args, **kwargs):
        raise _unported("rewind_decoded_tail")

    # -------------------------------------------------------------- recovery
    async def _recover(self) -> None:
        """Rebuild the entire chain and replay history (v1 of reference
        `_update_sequence`: servers key KV caches by session, and new
        sessions start empty). A bounded retry loop wraps rebuild +
        replay: each failed attempt bans the offending peer, so the next
        attempt routes around it."""
        if any(self._id_rows) and self.embed_fn is None:
            await self.close()
            raise RuntimeError(
                "session recorded token-id history but has no embed_fn to "
                "replay it"
            )
        if any(self._id_rows) and self._history:
            # both histories populated: the replay order is unknowable
            await self.close()
            raise RuntimeError(
                "session mixed token-id and hidden-state history; replay "
                "order is ambiguous"
            )
        await self.close()
        attempts = max(1, int(self.max_retries))
        last_exc: Exception | None = None
        for attempt in range(attempts):
            if attempt:
                await asyncio.sleep(min(0.2 * attempt, 1.0))
            try:
                await self._recover_once()
                ledger.recovery("client.reroute_replay")
                return
            except (
                RpcError, OSError, asyncio.TimeoutError, MissingBlocksError,
            ) as e:
                # MissingBlocksError is retriable here: a span can go dark
                # for a beat while the swarm self-heals
                last_exc = e
                await self.close()
                logger.warning(
                    "recovery attempt %d/%d failed: %s",
                    attempt + 1, attempts, e,
                )
                if isinstance(e, OverloadedError):
                    await asyncio.sleep(
                        min((e.retry_after_ms or 500) / 1000.0, 2.0)
                    )
        raise last_exc

    async def _recover_once(self) -> None:
        """One rebuild + replay attempt (see _recover)."""
        await self.manager.update(force=True)
        route = self.manager.make_sequence(
            cache_tokens_needed=self.batch_size * self.max_length,
            relay=not self.use_push,
        )
        spans: list[_SpanSession] = []
        try:
            for s in route:
                try:
                    spans.append(await self._open_span(s))
                except OverloadedError as e:
                    # session-open shed: short overload penalty, not a ban
                    self._note_shed_exc(e, s.peer_id)
                    raise
                except (OSError, RpcError, asyncio.TimeoutError):
                    self.manager.ban_peer(s.peer_id)
                    raise
        except Exception:
            for sp in spans:
                await sp.close()
            raise
        self._spans = spans
        try:
            if self.embed_fn is not None and any(self._id_rows):
                # token-id replay (ragged rows): right-pad to a rectangle,
                # write speculatively, then commit each row to its true
                # length — padded garbage lands after a row's real tokens
                # so the causal mask hides it, and commit_lens frees it
                lens = [len(r) for r in self._id_rows]
                padded = torch.zeros((self.batch_size, max(lens)),
                                     dtype=torch.int64)
                for i, r in enumerate(self._id_rows):
                    padded[i, : len(r)] = torch.tensor(r, dtype=torch.int64)
                await self._step_once(
                    self.embed_fn(padded), commit=False, commit_lens=lens,
                )
                self.failover_replayed_tokens += sum(lens)
            elif self._history:
                replay = torch.cat(self._history, dim=1)
                await self._step_once(replay, commit=True)
                self.failover_replayed_tokens += (
                    replay.shape[0] * replay.shape[1]
                )
        except Exception:
            # a half-replayed chain must not be reused: its KV caches are
            # incomplete and a later "successful" step would be garbage
            await self.close()
            raise

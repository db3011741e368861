"""InferenceSession: client-side stateful decode across the span chain (the
port of bloombee_tpu/client/session.py's main path).

Reference client/inference_session.py:438-855: owns one rpc_inference
stream per span, steps hidden states through the chain, and on a span
failure re-routes the chain and replays the input history into the
replacement servers to rebuild their KV caches (`_update_sequence`,
:802-831). Supports server-to-server push-only decode: the client sends
only to span 0 and each hop forwards activations directly (reference
ClientConfig.push_only_downstream_decode, config.py:19-42).

Speculative steps (reference speculative_model.py, spe_dec_tree.py): a
`step` with `tree_mask` [B, T, T] and `depths` [B, T] verifies linearized
draft trees speculatively; `accept` (per-row surviving node indices of the
previous tree) rides the next step and the servers compact those rows
before computing; `rows=(lo, hi)` ships only a live-row window of the
batch; `prune` asks span 0 to prune the tree with its MidLMHead and
`accept_per_span` gives each span its own accepts (`_step_pruned`, relay
mode only); `send_accept` applies a final accept with no compute.

Hidden states are torch tensors on the client's device. A step's output
is gathered in f32 there, as the JAX client gathers it; replies arrive
from the codec as CPU tensors and move to the device once per chunk.

The shared-prefix cache (`prefix_cache`, else BBTPU_PREFIX_CACHE): on
the session's first committed prefill the client probes every span's pool
with the prompt's page-hash chains (kv/prefix.py) and ships only the
uncached suffix, declaring the chain-wide skip as `prefix_skip`; recovery
probes too, so a replay re-ships only what no pool holds.

Standby replication (`repl_every`, else BBTPU_REPL_EVERY; 0 = off): every
`repl_every` newly sealed pages the client tells each span's server
(a `kv_repl` item, no reply) to ship them to a same-span standby, and
recovery routes through those standbys, so a failover replays at most one
interval plus the unsealed tail.

Reconnect-resume (`resume`, else BBTPU_RESUME, on): after a stream failure
the client first re-attaches each span's lease-parked session on a fresh
stream and retransmits the failed step under its original id; a server
that already applied it answers from its recorded reply. Any decline falls
back to reroute + replay.

Server-side multi-step decode (`decode_n`): one RPC to span 0 returns
[B, n] greedy token ids. A one-span route runs the server's fused or
stepped loop; a longer push route runs chained decode (span 0 embeds and
coordinates, the tail applies the head). A declining server raises
`DecodeNUnsupported`; a chain that failed after committing KV marks the
session for a rebuild and replay on its next use, as does
`rewind_decoded_tail` after a call ran past an EOS stop.

The cross-replica audits (ROADMAP item 19) are reached only through
`ClientConfig.audit_p`, which refuses them (client/config.py).
"""

from __future__ import annotations

import asyncio
import logging
import random
import time
import uuid

import numpy as np
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
from bloombee_tpu_torch.kv.prefix import hidden_hash_chain, page_hash_chain
from bloombee_tpu_torch.spec.tree import pruned_step_arrays
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
env.declare(
    "BBTPU_REPL_EVERY", int, 0,
    "session-KV replication interval: every N newly-sealed pages the "
    "client asks each span's server to ship them (kv_put) to a standby "
    "covering the same span, so failover replays at most one interval "
    "plus the unsealed tail (0 = replication off)",
)
env.declare(
    "BBTPU_RESUME", bool, True,
    "reconnect-resume: after a stream failure, try to re-attach each "
    "span's lease-parked session (resume: session_id) and retransmit the "
    "failed step under its original id — at-most-once server-side, zero "
    "prompt replay — before falling back to full-replay recovery. Safe "
    "against servers with leases off: they decline and recovery proceeds "
    "as before",
)

# default admission-control identity: one id per client process, so all of
# a process's sessions share one fair-share bucket server-side
_PROCESS_CLIENT_ID = f"cli-{uuid.uuid4().hex[:8]}"

class DecodeNUnsupported(RuntimeError):
    """The server cannot run server-side multi-step decode for this session
    (no client params, a sub-span route, a declined chain). Not a failure:
    the caller falls back to per-step decoding without banning the peer."""


def _raise_if_session_lost(resp_meta: dict) -> None:
    """Typed `session_lost` reply: the server is healthy but this session's
    KV is gone. Raise a plain wire error so the caller's retry loop
    recovers and replays WITHOUT banning the peer."""
    if resp_meta.get("session_lost"):
        raise RpcError(resp_meta.get("reason", "session KV lost"))


def _mask_u8(tree_mask) -> torch.Tensor:
    """A [B, T, T] tree mask (bool, numpy or torch) as the u8 host tensor
    the wire carries."""
    if isinstance(tree_mask, torch.Tensor):
        return tree_mask.detach().to(device="cpu", dtype=torch.uint8)
    return torch.from_numpy(
        np.ascontiguousarray(np.asarray(tree_mask), dtype=np.uint8)
    )


def _accept_meta(accept) -> list:
    """Per-row accepted node indices as the wire's lists of ints."""
    return [np.asarray(a, dtype=np.int64).tolist() for a in accept]


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
        prefix_cache: bool | None = None,  # probe servers' shared-prefix
        # pools before the first prefill and send only the uncached suffix
        # (None -> BBTPU_PREFIX_CACHE)
        repl_every: int | None = None,  # standby-KV replication interval
        # in sealed pages (None -> BBTPU_REPL_EVERY; 0 disables)
        client_id: str | None = None,  # admission-control identity (None ->
        # one shared id per client process)
        overload_retries: int = 10,  # `overloaded` sheds a step rides out
        # (backoff + reroute) before failing: a separate budget from
        # max_retries, since a shed is the server working as designed
        resume: bool | None = None,  # reconnect-resume after a stream
        # failure: re-attach each span's lease-parked session and
        # retransmit the failed step under its original id (None ->
        # BBTPU_RESUME)
        resume_timeout: float = 10.0,  # per-span resume handshake budget
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
        self.resume = (
            bool(env.get("BBTPU_RESUME")) if resume is None else bool(resume)
        )
        self.resume_timeout = float(resume_timeout)
        self.keepalive_s = keepalive_s
        self.integrity = (
            bool(env.get("BBTPU_INTEGRITY")) if integrity is None
            else bool(integrity)
        )
        self._gate = SanityGate() if self.integrity else None
        # integrity observability (tests read these)
        self.sanity_rejects = 0
        self.integrity_reroutes = 0
        # reconnect-resume: streams re-attached without replay, resumes
        # the servers declined, and the (step_id, prefix_skip) of the last
        # transmitted step, so a post-resume retry retransmits it under
        # the SAME id with the same suffix
        self.resumed_streams = 0
        self.resume_declines = 0
        self._last_sent: tuple[int, int | None] | None = None
        self.prefix_cache = bool(
            env.get("BBTPU_PREFIX_CACHE") if prefix_cache is None
            else prefix_cache
        )
        # standby replication: per-span state (standby address, peer id,
        # pages announced per row) and incremental full-history hash
        # chains keyed by page size
        self.repl_every = int(
            env.get("BBTPU_REPL_EVERY") if repl_every is None
            else repl_every
        )
        self._repl: list[dict | None] = []
        self._chains_by_ps: dict[int, list[list[str]]] = {}
        # pages sealed but not yet announced to a standby, and tokens
        # re-prefilled by recoveries
        self.repl_lag_pages = 0
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
        # a dirty decode_n decline or an EOS rewind left the servers' KV
        # ahead of the history: rebuild and replay before the next use
        self._needs_rebuild = False
        self._warned_no_embed = False
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
        self._init_repl()
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

    # ----------------------------------------------------------- prefix cache
    async def _probe_prefix(
        self,
        id_rows: list[list[int]] | None = None,
        hidden_rows: list | None = None,
    ) -> int:
        """Ask every span how much of each row's history its shared-prefix
        pool holds; returns the chain-wide skippable token count (min over
        spans AND rows: every span receives the same suffix hidden).

        Probes hash token-id rows (the prompt / replay path) or [T, D]
        hidden rows (embed-less sessions, under a distinct hash root).
        A span advertising no page size forces 0. Wire failures propagate
        as step errors, so the caller's retry loop rebuilds the chain: a
        timed-out probe never leaves a stale reply on a reused stream."""
        rows = id_rows if id_rows is not None else hidden_rows
        builder = page_hash_chain if id_rows is not None else hidden_hash_chain
        lens = [len(r) for r in rows] if rows else []
        ps_list = [s.span.server_info.page_size for s in self._spans]
        if not ps_list or any(ps <= 0 for ps in ps_list) or not any(lens):
            return 0
        chains_by_ps = {
            ps: [builder(row, ps) for row in rows] for ps in set(ps_list)
        }
        step_id = self._step_counter
        self._step_counter += 1
        for s in self._spans:
            await s.stream.send(
                {
                    "step": step_id,
                    "prefix_probe": chains_by_ps[s.span.server_info.page_size],
                },
                [],
            )
        matched = None
        for i, s in enumerate(self._spans):
            try:
                item = await asyncio.wait_for(
                    s.stream.recv(), self.step_timeout
                )
            except OverloadedError as e:
                self._note_shed_exc(e, s.span.peer_id)
                raise
            except (RpcError, OSError, asyncio.TimeoutError):
                self.manager.ban_peer(s.span.peer_id)
                raise
            if item is None:
                self.manager.ban_peer(s.span.peer_id)
                raise RpcError(f"span {i} closed during prefix probe")
            resp_meta, _ = item
            _raise_if_session_lost(resp_meta)
            self._raise_if_shed(resp_meta, s.span.peer_id)
            span_min = min(
                int(x) for x in resp_meta.get("prefix_matched") or [0]
            )
            matched = span_min if matched is None else min(matched, span_min)
        # cap below the shortest row so the final prompt position always
        # computes (the caller consumes its output); the uncached tail
        # then writes into the last shared page, which the server copies
        return max(0, min(matched or 0, min(lens) - 1))

    # ------------------------------------------------------- kv replication
    def _history_rows(self):
        """(kind, per-row history) for hashing: ("ids", ragged id lists),
        ("hidden", [T, D] tensors), or (None, None) when nothing is
        committed yet (or the kinds are mixed: recovery refuses those)."""
        if any(self._id_rows):
            if self._history:
                return None, None
            return "ids", self._id_rows
        if self._history:
            full = torch.cat(self._history, dim=1)
            return "hidden", [full[i] for i in range(full.shape[0])]
        return None, None

    def _full_chains(self, ps: int) -> list[list[str]] | None:
        """Per-row hash chains over the session's FULL committed history
        (prompt + generated) at page size `ps`, extended incrementally:
        sealed pages already hashed are never rehashed."""
        kind, rows = self._history_rows()
        if kind is None:
            return None
        fn = page_hash_chain if kind == "ids" else hidden_hash_chain
        cached = self._chains_by_ps.get(ps)
        chains = [
            fn(row, ps, chain=cached[i] if cached else None)
            for i, row in enumerate(rows)
        ]
        self._chains_by_ps[ps] = chains
        return chains

    def _init_repl(self) -> None:
        """(Re)select one standby per span for KV replication. A None slot
        means that span can't replicate: knob off, no page size advertised,
        a sub-span of the server (its pages would carry layers the session
        doesn't own), or no capable same-span alternative; all degrade to
        plain full-replay recovery."""
        self._repl = [None] * len(self._spans)
        if self.repl_every <= 0 or not self.prefix_cache:
            return
        exclude = {s.span.peer_id for s in self._spans}
        for i, s in enumerate(self._spans):
            info = s.span.server_info
            if (
                info.page_size <= 0
                or s.span.start != info.start_block
                or s.span.end != info.end_block
            ):
                continue
            standby = self.manager.pick_standby(s.span, exclude=exclude)
            if standby is None:
                continue
            self._repl[i] = {
                "standby": {
                    "host": standby.server_info.host,
                    "port": standby.server_info.port,
                },
                "peer": standby.peer_id,
                "announced": [0] * self.batch_size,
            }

    def _standby_peers(self) -> set[str]:
        """Peers holding (some of) this session's replicated pages: the
        recovery route hint."""
        return {st["peer"] for st in self._repl or [] if st is not None}

    async def _maybe_replicate(self) -> None:
        """Announce newly sealed pages to each span's server, which exports
        them off the critical path and kv_puts them into the standby's
        prefix pool. Fire-and-forget: no reply rides the stream (so the
        step recv loop never desyncs), and a failed send leaves the pages
        for the next interval."""
        live = [st for st in self._repl if st is not None]
        if not live:
            self.repl_lag_pages = 0
            return
        kind, rows = self._history_rows()
        if kind is None:
            return
        lag = 0
        for s, st in zip(self._spans, self._repl):
            if st is None:
                continue
            ps = s.span.server_info.page_size
            sealed = [len(r) // ps for r in rows]
            behind = max(
                sl - a for sl, a in zip(sealed, st["announced"])
            )
            if behind < self.repl_every:
                lag = max(lag, behind)
                continue
            chains = self._full_chains(ps)
            if chains is None:
                return
            try:
                await s.stream.send(
                    {"kv_repl": {"standby": st["standby"], "chains": chains}},
                    [],
                )
            except (RpcError, OSError, asyncio.TimeoutError) as e:
                logger.debug("kv_repl announce failed: %s", e)
                lag = max(lag, behind)
                continue
            st["announced"] = sealed
        self.repl_lag_pages = lag

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
        prune: dict | None = None,  # mid-chain tree pruning (tree steps)
        accept_per_span: list | None = None,  # pruned chains: per span
        rows: tuple | None = None,  # (lo, hi): hidden covers only this
        # contiguous row window of the session's cache; accept stays
        # full-width (servers apply it before slicing the handle)
    ):
        """Push hidden through the whole chain; returns the last span's
        output, f32, on hidden's device (or (output, keep) for pruned tree
        steps, keep [B, K] numpy or None)."""
        hidden = torch.as_tensor(hidden)

        async def attempt(resume):
            if prune is not None or accept_per_span is not None:
                return await self._step_pruned(
                    hidden, tree_mask, depths, prune, accept_per_span
                )
            send_hidden, skip, step_id = hidden, None, None
            if resume is not None:
                # retransmit the exact failed step: the same id (servers
                # that applied it answer from the recorded reply) and the
                # same prefix skip (the same suffix), with no fresh probe
                step_id, skip = resume
                if skip:
                    send_hidden = hidden[:, skip:]
            elif (
                # shared-prefix fast path: on the session's FIRST committed
                # prefill, probe the chain's pools and ship only the
                # uncached suffix. The output covers only the suffix;
                # callers consume the last position, which the probe's cap
                # always keeps
                self.prefix_cache
                and commit
                and tree_mask is None
                and ids is not None
                and self.position == 0
                and hidden.shape[1] > 1
            ):
                skip = await self._probe_prefix(
                    [[int(t) for t in row]
                     for row in torch.as_tensor(ids).tolist()]
                )
                if skip:
                    send_hidden = hidden[:, skip:]
            out = await self._step_once(
                send_hidden, commit, commit_lens, tree_mask, depths,
                accept, rows, prefix_skip=skip, step_id=step_id,
            )
            if commit and tree_mask is None:
                if ids is not None and self.embed_fn is not None:
                    for i, row in enumerate(torch.as_tensor(ids).tolist()):
                        self._id_rows[i].extend(int(t) for t in row)
                else:
                    self._history.append(hidden)
                self.position += hidden.shape[1]
                await self._maybe_replicate()
            return out

        def rerouted():
            # the replay committed every accepted token on the fresh
            # chain, whose speculative window is empty: a carried accept
            # is stale
            nonlocal accept, accept_per_span
            accept = None
            accept_per_span = None

        return await self._with_recovery(
            "step", attempt,
            # a pruned chain's per-span accepts are not retransmitted
            can_resume=lambda: prune is None and accept_per_span is None,
            rerouted=rerouted,
        )

    async def _with_recovery(
        self, what: str, attempt, can_resume=None, rerouted=None
    ):
        """Run `attempt(resume)` until it returns, through the session's
        recovery: a pending rebuild first; an overload shed waits out the
        peer's retry hint (jittered) and reroutes, on its own budget; a
        wire failure tries a reconnect-resume (unless `can_resume()` says
        no), then a reroute and replay, on `max_retries`. `resume` is the
        `_last_sent` (step id, prefix skip) to retransmit after a resume,
        else None. `rerouted()` runs after each reroute the loop makes."""
        attempts = 0
        overload_waits = 0
        resume = None
        while True:
            try:
                if self._needs_rebuild:
                    await self._recover()
                last, resume = resume, None
                return await attempt(last)
            except OverloadedError as e:
                # retriable shed: the peer told us to go elsewhere, not that
                # it is broken; honor its retry_after hint, then reroute
                overload_waits += 1
                if overload_waits > self.overload_retries:
                    raise
                wait_s = min((e.retry_after_ms or 500) / 1000.0, 5.0)
                wait_s *= random.uniform(0.75, 1.25)
                logger.info(
                    "%s shed by overloaded server (%s); rerouting in "
                    "%.2fs (shed %d/%d)",
                    what, e, wait_s, overload_waits, self.overload_retries,
                )
                await asyncio.sleep(wait_s)
                try:
                    await self._recover()
                    if rerouted is not None:
                        rerouted()
                except (
                    RpcError, OSError, asyncio.TimeoutError,
                    MissingBlocksError,
                ) as e2:
                    logger.warning("recovery after shed failed: %s", e2)
            except (RpcError, OSError, asyncio.TimeoutError) as e:
                attempts += 1
                if attempts > self.max_retries:
                    raise
                if (
                    self.resume
                    and (can_resume is None or can_resume())
                    and self._last_sent is not None
                    # a call that left spans ahead of the history (a dirty
                    # decode_n decline) must rebuild and replay
                    and not self._needs_rebuild
                    # resume would retransmit to the SAME peer whose
                    # output an integrity check just rejected, and its
                    # at-most-once dedup would replay the recorded reply:
                    # integrity rejects take the reroute + replay path
                    and not isinstance(e, IntegrityError)
                ):
                    # cheap path first: re-attach the lease-parked sessions
                    # on fresh streams and retransmit the failed call under
                    # its original id: no KV is rebuilt, no token replayed
                    # (a server whose decode_n died mid-commit is kv_dirty:
                    # its park, and so this resume, is refused)
                    last = self._last_sent
                    if await self._try_resume():
                        resume = last
                        logger.info(
                            "%s failed (%s); resumed session, "
                            "retransmitting step %d", what, e, last[0],
                        )
                        continue
                logger.warning(
                    "%s failed (%s); re-routing (attempt %d)",
                    what, e, attempts,
                )
                try:
                    await self._recover()
                    if rerouted is not None:
                        rerouted()
                except (
                    RpcError, OSError, asyncio.TimeoutError,
                    MissingBlocksError,
                ) as e2:
                    logger.warning("recovery attempt failed: %s", e2)
                    await asyncio.sleep(min(0.2 * attempts, 2.0))

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

    async def _step_pruned(
        self, hidden, tree_mask, depths, prune, accept_per_span
    ):
        """Tree step through the chain with mid-chain pruning: span 0 runs
        the full tree and returns only surviving rows + keep indices; the
        client forwards the pruned tree (restricted mask/depths)
        downstream (relay mode only). Accepts may differ per span:
        downstream spans hold KV in kept-row order (reference
        backend.py:763-775 + block_functions.py restore_hidden_states,
        inverted client-side).

        Returns (out [B, K, D] f32 on hidden's device, keep [B, K] numpy
        or None if the pruning span has no pruner head)."""
        if not self._spans:
            raise RpcError("session chain is closed (recovery pending)")
        if self.use_push and len(self._spans) > 1:
            raise ValueError(
                "pruned tree steps need relay mode (use_push=False)"
            )
        if tree_mask is None or depths is None:
            raise ValueError("a pruned step is a tree step: pass tree_mask "
                             "and depths")
        step_id = self._step_counter
        self._step_counter += 1
        wire_dt = dtype_for_name(self._spans[0].span.server_info.wire_dtype)
        chunk = hidden.to(wire_dt)
        mask_u8 = _mask_u8(tree_mask)
        depths_list = np.asarray(depths).tolist()
        keep = None

        t_start = time.perf_counter()
        compute_ms = []
        for i, span_sess in enumerate(self._spans):
            meta = {
                "step": step_id,
                "commit": False,
                "tree": True,
                "depths": depths_list,
                "reply": "tensor",
                "deadline_s": self.step_timeout,
            }
            if accept_per_span is not None and accept_per_span[i] is not None:
                meta["accept"] = _accept_meta(accept_per_span[i])
            if i == 0 and prune is not None:
                meta["prune"] = prune
            try:
                await span_sess.stream.send(meta, [chunk, mask_u8])
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
            compute_ms.append(resp_meta.get("t_compute_ms"))
            chunk = resp_tensors[0]
            if self._gate is not None:
                self._check_span_output(span_sess, resp_meta, chunk)
            if i == 0 and resp_meta.get("keep") is not None:
                keep = np.asarray(resp_meta["keep"], dtype=np.int32)
                mask_k, depths_k = pruned_step_arrays(
                    mask_u8.numpy().astype(bool), np.asarray(depths), keep
                )
                mask_u8 = torch.from_numpy(mask_k.astype(np.uint8))
                depths_list = depths_k.tolist()
        self._note_spans_ok()
        self.timings.append(
            {
                "step": step_id,
                "tokens": hidden.shape[1],
                "span_compute_ms": compute_ms,
                "total_ms": (time.perf_counter() - t_start) * 1000.0,
            }
        )
        return chunk.to(device=hidden.device, dtype=torch.float32), keep

    async def _step_once(self, hidden, commit, commit_lens=None,
                         tree_mask=None, depths=None, accept=None, rows=None,
                         prefix_skip=None, step_id=None):
        if not self._spans:
            # a failed recovery left no open chain; surface as a retryable
            # wire error so the caller's retry loop attempts recovery again
            raise RpcError("session chain is closed (recovery pending)")
        if step_id is None:
            step_id = self._step_counter
            self._step_counter += 1
        # remembered for reconnect-resume: a retransmit after a resumed
        # stream reuses this exact id (the server's at-most-once dedup
        # keys on it) and the same prefix_skip (the same suffix)
        self._last_sent = (step_id, prefix_skip)
        meta_base = {
            "step": step_id,
            "commit": commit,
            "tree": tree_mask is not None,
            # remaining-time budget: the server aborts work this client
            # has already given up on
            "deadline_s": self.step_timeout,
        }
        if depths is not None:
            meta_base["depths"] = np.asarray(depths).tolist()
        if accept is not None:
            meta_base["accept"] = _accept_meta(accept)
        if commit_lens is not None:
            meta_base["commit_lens"] = [int(x) for x in commit_lens]
        if prefix_skip is not None:
            # settle the preceding probe: servers keep exactly this many
            # adopted tokens per row (0 drops the adoption). Present on
            # every mb chunk and relay forward via meta_base
            meta_base["prefix_skip"] = int(prefix_skip)
        # ship hidden in the first span's advertised wire dtype (bf16 for
        # bf16-compute servers: half the bytes on the latency-critical hop)
        wire_dt = dtype_for_name(self._spans[0].span.server_info.wire_dtype)
        hidden_w = hidden.to(wire_dt)
        extra = [_mask_u8(tree_mask)] if tree_mask is not None else []

        # within-stage micro-batching: plain committed steps only (tree and
        # accept steps keep whole-batch semantics)
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
        if (
            tree_mask is not None
            or accept is not None
            or commit_lens is not None
            or mb > b
        ):
            mb = 1
        # live-row window (tree steps): hidden carries only rows [lo, hi)
        # of the cache and the servers slice their handle to it. Row
        # labels on the wire stay ABSOLUTE; row_base maps them back onto
        # this window-sized hidden/out.
        row_base = 0
        if rows is not None:
            lo_r, hi_r = int(rows[0]), int(rows[1])
            if hi_r - lo_r != b:
                raise ValueError(
                    f"rows window {rows} does not match hidden batch {b}"
                )
            mb = 1
            row_base = lo_r
            bounds = [(lo_r, hi_r)]
        else:
            bounds = [
                (round(k * b / mb), round((k + 1) * b / mb))
                for k in range(mb)
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
            await self._spans[0].stream.send(
                meta, [hidden_w[lo - row_base:hi - row_base]] + extra
            )

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
                lo, hi = resp_meta.get("rows") or (row_base, row_base + b)
                chunk = resp_tensors[0]
                if self._gate is not None:
                    # inline integrity BEFORE this chunk enters `out` or
                    # gets forwarded to the next span
                    self._check_span_output(span_sess, resp_meta, chunk)
                out[lo - row_base:hi - row_base] = chunk.to(
                    device=out.device, dtype=torch.float32
                )
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
                    await self._spans[i + 1].stream.send(
                        fwd_meta, [chunk] + extra
                    )
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

    async def decode_n(
        self,
        ids,  # [B] int: the input token of the first step
        n: int,
        eos_token_id: int | None = None,
        finished=None,  # [B] bool rows already at EOS
        head_dtype: str | None = None,  # the client's lm_head dtype
        # ("float32", "bfloat16"); servers decline on a mismatch so the
        # logits stay those of the per-step path
    ) -> np.ndarray:
        """Server-side multi-step greedy decode: one RPC returns [B, n]
        token ids (int64 numpy). A one-span route runs the server's fused
        or stepped loop; a longer route runs CHAINED decode: span 0 embeds
        and coordinates, hidden states hop server to server, the tail span
        applies the head and pushes each next id back to span 0, which
        replies all n ids at once. Raises DecodeNUnsupported when the
        server declines, so the caller can fall back to per-step decoding.

        The servers write n tokens of KV (the input token plus the first
        n-1 selected ones), so the position advances by n and those ids
        enter the replay history.

        Exactness caveat: a call whose context CROSSES
        BBTPU_PAGED_MIN_CONTEXT runs one attention route for the whole
        call where the per-step path would switch mid-way; the routes
        agree to ~1e-5, so only an exact argmax tie at the crossing could
        differ (runtime/executor.py `decode_n`)."""
        if self.embed_fn is None and not self._warned_no_embed:
            # ids recorded without an embed_fn cannot be replayed: a later
            # transport failure becomes a RuntimeError in _recover
            self._warned_no_embed = True
            logger.warning(
                "decode_n on a session without embed_fn: the session loses "
                "failure recovery (id history cannot be re-embedded); use "
                "model.inference_session() for recoverable decode"
            )
        ids = np.asarray(ids).reshape(-1).astype(np.int32)

        async def attempt(resume):
            # every reroute may pick a route decode_n cannot use
            self._check_decode_n_route()
            return await self._decode_n_once(
                ids, n, eos_token_id, finished, head_dtype,
                step_id=None if resume is None else resume[0],
            )

        toks = await self._with_recovery("decode_n", attempt)
        # the KV now holds [input, toks[:, :-1]] per row: the replay history
        written = np.concatenate([ids[:, None], toks[:, :-1]], axis=1)
        for i, row in enumerate(written):
            self._id_rows[i].extend(int(t) for t in row)
        self.position += n
        await self._maybe_replicate()
        return toks

    def _check_decode_n_route(self) -> None:
        """decode_n needs a route over the whole model: span 0 embeds (it
        enters at block 0) and the tail applies the head (it ends at the
        last block). A longer route chains through server-to-server
        push."""
        if not self._spans:
            return  # a closed chain surfaces as RpcError in _decode_n_once
        if (
            self._spans[0].span.start != 0
            or self._spans[-1].span.end != self.manager.num_blocks
        ):
            raise DecodeNUnsupported("route does not cover the whole model")
        if len(self._spans) > 1 and not self.use_push:
            raise DecodeNUnsupported(
                "chained decode_n needs push transport (use_push=True)"
            )

    async def _decode_n_once(
        self, ids, n, eos_token_id, finished, head_dtype=None, step_id=None
    ) -> np.ndarray:
        if not self._spans:
            raise RpcError("session chain is closed (recovery pending)")
        if step_id is None:
            step_id = self._step_counter
            self._step_counter += 1
        # for reconnect-resume: a retransmit reuses this exact id, so a
        # coordinator that finished the call answers from its record
        self._last_sent = (step_id, None)
        meta = {
            "step": step_id,
            "decode_n": int(n),
            "reply": "tensor",
            # the client's own receive budget below: past it the client
            # re-routes, so any server work left is waste
            "deadline_s": 2 * self.step_timeout + float(n),
        }
        if eos_token_id is not None:
            meta["eos_token_id"] = int(eos_token_id)
        if finished is not None:
            meta["finished"] = np.asarray(finished, dtype=bool).tolist()
        if head_dtype is not None:
            meta["head_dtype"] = head_dtype
        if len(self._spans) > 1:
            # chained decode: span 0 coordinates over the downstream hops
            # (the per-step push route's wire shape)
            meta["route"] = [
                {
                    "host": s.span.server_info.host,
                    "port": s.span.server_info.port,
                    "session_id": s.session_id,
                }
                for s in self._spans[1:]
            ]
        span_sess = self._spans[0]
        t_start = time.perf_counter()
        try:
            await span_sess.stream.send(meta, [torch.from_numpy(ids)])
            # one RPC covers n whole-model steps; chained routes also pay
            # per-token server-to-server hops: two step timeouts plus a
            # second a token, so a healthy coordinator is never banned
            item = await asyncio.wait_for(
                span_sess.stream.recv(), 2 * self.step_timeout + float(n)
            )
        except OverloadedError as e:
            self._note_shed_exc(e, span_sess.span.peer_id)
            raise
        except (RpcError, OSError, asyncio.TimeoutError):
            self.manager.ban_peer(span_sess.span.peer_id)
            raise
        if item is None:
            self.manager.ban_peer(span_sess.span.peer_id)
            raise RpcError("span closed mid-session")
        resp_meta, resp_tensors = item
        _raise_if_session_lost(resp_meta)
        self._raise_if_shed(resp_meta, span_sess.span.peer_id)
        if resp_meta.get("decode_n_unsupported"):
            if resp_meta.get("dirty"):
                # a chained call failed mid-way: spans hold extra KV past
                # the committed history; a rebuild and replay on the
                # session's next use restores it
                self._needs_rebuild = True
            if resp_meta.get("transient"):
                # a span died mid-chain (not a capability decline): a wire
                # error, so the retry loop rebuilds the route, replays and
                # RETRIES chained decode
                raise RpcError(
                    resp_meta.get("reason") or "chained decode_n failed"
                )
            raise DecodeNUnsupported(
                resp_meta.get("reason")
                or "server declined decode_n for this session"
            )
        self._note_spans_ok()
        self.timings.append(
            {
                "step": step_id,
                "tokens": n,
                "decode_n": True,
                "span_compute_ms": [resp_meta.get("t_compute_ms")],
                "span_dispatch_ms": [resp_meta.get("t_dispatch_ms")],
                "total_ms": (time.perf_counter() - t_start) * 1000.0,
            }
        )
        return torch.as_tensor(resp_tensors[0]).numpy().astype(np.int64)

    async def send_accept(
        self, accept: list, per_span: list | None = None
    ) -> None:
        """Apply a speculative accept on every span without running compute
        (the final accept of a generation, or an accept with no next tree).
        `per_span` overrides the accept for each span (pruned chains hold
        KV in kept-row order downstream)."""
        step_id = self._step_counter
        self._step_counter += 1
        for i, span_sess in enumerate(self._spans):
            acc = accept if per_span is None else per_span[i]
            meta = {
                "step": step_id,
                "accept": _accept_meta(acc),
                "accept_only": True,
                "reply": "ack",
            }
            await span_sess.stream.send(meta, [])
        for i, span_sess in enumerate(self._spans):
            item = await asyncio.wait_for(
                span_sess.stream.recv(), self.step_timeout
            )
            if item is None:
                raise RpcError(f"span {i} closed during accept")

    def rewind_decoded_tail(self, n_drop: int) -> None:
        """Drop the last `n_drop` tokens of every row from the committed
        history after a decode_n call ran past an EOS stop. The servers'
        KV still holds them, so the chain is marked for a rebuild and
        replay on the session's next use, which restores exactly the
        rewound context. Needs embed_fn (the replay re-embeds ids)."""
        if self.embed_fn is None:
            raise ValueError(
                "rewind_decoded_tail needs a session with embed_fn to "
                "replay the rewound history"
            )
        if n_drop <= 0:
            return
        for row in self._id_rows:
            del row[len(row) - n_drop:]
        self.position -= n_drop
        # the incremental chains cover tokens that no longer exist
        self._chains_by_ps.clear()
        self._needs_rebuild = True

    # -------------------------------------------------------------- recovery
    async def _try_resume(self) -> bool:
        """Cheap half of recovery: reopen each span with `resume:
        session_id` so the server re-attaches our lease-parked session to
        the fresh stream, KV intact. All-or-nothing across spans: any
        decline (lease expired, leases off, parked pages evicted) abandons
        the attempt and the caller falls back to reroute + replay. On
        success the caller retransmits the failed step under its ORIGINAL
        id; spans that already applied it answer from their recorded
        reply, the rest compute it."""
        if not self.resume or not self._spans:
            return False
        old = self._spans
        fresh: list[_SpanSession] = []
        ok = True
        reason = None
        for s in old:
            try:
                conn = await connect(
                    s.span.server_info.host, s.span.server_info.port,
                    keepalive_s=self.keepalive_s,
                )
                stream = await conn.open_stream(
                    "rpc_inference",
                    {
                        "resume": s.session_id,
                        # session_id rides along so the wire trace stays
                        # self-describing; servers key off "resume"
                        "session_id": s.session_id,
                        "client_id": self.client_id,
                    },
                )
                fresh.append(_SpanSession(s.span, conn, stream, s.session_id))
                item = await asyncio.wait_for(
                    stream.recv(), self.resume_timeout
                )
                resp_meta = item[0] if item is not None else {}
                if not resp_meta.get("resumed"):
                    ok = False
                    reason = resp_meta.get("reason", "stream closed")
                    break
            except (RpcError, OSError, asyncio.TimeoutError) as e:
                ok = False
                reason = str(e) or type(e).__name__
                break
        if not ok:
            self.resume_declines += 1
            logger.info("session resume declined (%s); falling back to "
                        "full recovery", reason)
            for sp in fresh:
                await sp.close()
            return False
        # the dead streams' conns linger on our side too: abort them so
        # nothing keeps pinging a connection we just superseded
        for sp in old:
            sp.conn.abort("superseded by resume")
        self._spans = fresh
        self.resumed_streams += len(fresh)
        return True

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
                # the replay rebuilt the full history: a pending rebuild
                # (dirty decode_n decline, EOS rewind) is satisfied
                self._needs_rebuild = False
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
        """One rebuild + replay attempt (see _recover). The route prefers
        the peers holding this session's replicated pages, so the probe
        below usually adopts them and the replay shrinks to the unsealed
        tail."""
        await self.manager.update(force=True)
        route = self.manager.make_sequence(
            cache_tokens_needed=self.batch_size * self.max_length,
            relay=not self.use_push,
            prefer=self._standby_peers() or None,
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
                # pools (this session's earlier prompt pages, a standby's
                # replicated pages) may hold a prefix: probe, so the replay
                # re-ships only the uncached suffix. Chains come from the
                # RAGGED rows, never the padded rectangle; commit_lens are
                # absolute, so the adopted offset needs no adjustment
                skip = 0
                if self.prefix_cache:
                    skip = await self._probe_prefix(
                        [list(r) for r in self._id_rows]
                    )
                replay = self.embed_fn(padded)
                await self._step_once(
                    replay[:, skip:], commit=False, commit_lens=lens,
                    prefix_skip=skip,
                )
                self.failover_replayed_tokens += sum(
                    max(0, ln - skip) for ln in lens
                )
            elif self._history:
                replay = torch.cat(self._history, dim=1)
                skip = 0
                if self.prefix_cache:
                    skip = await self._probe_prefix(
                        hidden_rows=[
                            replay[i] for i in range(replay.shape[0])
                        ]
                    )
                await self._step_once(
                    replay[:, skip:], commit=True,
                    prefix_skip=skip if skip else None,
                )
                self.failover_replayed_tokens += replay.shape[0] * (
                    replay.shape[1] - skip
                )
        except Exception:
            # a half-replayed chain must not be reused: its KV caches are
            # incomplete and a later "successful" step would be garbage
            await self.close()
            raise
        # replicate to a fresh standby from now on (the old one is likely
        # on the new route, often as the new primary)
        self._init_repl()

"""BlockServer: one worker hosting blocks [start, end) of a model (a port
of bloombee_tpu/server/block_server.py).

The same RPCs and frames as the JAX server, so a JAX client, a JAX registry
and JAX servers work with it:

- `rpc_inference` stream: one decode session. Items arrive from the client
  stream or, pushed by the previous span's server, through `rpc_push`; the
  session loop races both. Steps dispatch through the compute queue
  (fetch=False) and the device-to-host fetch runs off the queue:
  - continuous batching (`max_batch`, default 8): plain committing
    single-token decode steps of concurrent sessions that are queued
    together (or arrive within `BBTPU_BATCH_WINDOW_MS`) share ONE span
    dispatch (`executor.decode_group`); a failed merged dispatch rolls
    back and replays row by row;
  - stall-free chunked prefill (`prefill_chunk`, else
    `BBTPU_PREFILL_CHUNK`; 0 = monolithic): a prefill becomes a stream of
    chunk tasks at an aging priority, so decode steps run between chunks;
    the last chunk commits the prompt, an abort frees its pages;
  - mixed batch (`mixed_batch`, else `BBTPU_MIXED_BATCH`; off by default):
    a prefill chunk and queued decode steps fuse into one ragged dispatch
    (`executor.ragged_group`); decodes commit or roll back, the chunk
    commits on its last chunk and is truncated on failure;
  - batched tree verification (`spec_batch`, else `BBTPU_SPEC_BATCH`;
    off by default): concurrent sessions' tree-verify steps pad and stack
    into one ragged dispatch, rolled back per member and replayed solo
    if it fails;
  - every other step (prefills, solo tree verifies, ragged replays) is
    its own dispatch (`executor.prefill` for a causal T>1 step,
    `executor.decode` for T=1 and tree steps).
- speculative decoding: a step's `accept` compacts the previous round's
  surviving tree rows onto the committed prefix before the step runs
  (`CacheManager.accept_speculative`), an `accept_only` step does only
  that, a `tree` step verifies a linearized draft tree (a `[B, T, T]` u8
  mask tensor and `depths`) speculatively, and a `prune` step scores the
  span's output with the MidLMHead (`spec/pruner.py`, the "simple"
  method, head from `model_dir` or BBTPU_PRUNER_CKPT) and replies only
  the surviving rows with their `keep` indices.
- the shared-prefix cache (`prefix_cache`, else BBTPU_PREFIX_CACHE): a
  `prefix_probe` step adopts each row's longest pooled prompt prefix, and
  the next step's `prefix_skip` settles it (solo: an unsettled adoption
  never joins a merged dispatch), so the prefill computes only the suffix;
  the server advertises its `page_size` for the clients' hash chains;
- standby KV replication: a `kv_repl` stream item names a same-span
  standby and the session's full-history hash chains; the server exports
  the newly sealed pages off the critical path and ships them with the
  `kv_put` unary call, which a standby installs as cached pool entries
  (`kv_repl` advertised on a bf16/f32 arena with the prefix cache on);
- session leases (`session_lease_s`, else BBTPU_SESSION_LEASE_S; 0 = off):
  a session whose stream dies parks its pages in the pool and stays
  resumable (`resume: session_id` on a fresh stream) for one lease; with
  leases on, every step's reply is recorded before delivery, so a step
  retransmitted after a resume is answered, not applied twice;
- server-side multi-step decode (`decode_n` step meta, up to
  `decode_n_max` tokens): one RPC returns n greedy token ids. FUSED on a
  whole-model span over a dense arena (`executor.decode_n`: every step's
  plan built before one device loop); LOCAL STEPPED on a whole-model span
  the fused loop does not cover (an int4 arena): embed, per-step decode
  and the head driven from the host; CHAINED when the meta names a
  `route`: this span embeds and coordinates, each hop's hidden state is
  pushed server to server (`chain` meta), and the tail span applies the
  head and pushes the ids back (`chain_ids`, or `chain_error`). A server
  that cannot serve it declines with `decode_n_unsupported` and a reason;
  a chain that fails after committing KV declines `dirty`, so the client
  rebuilds and replays. The embed and head use the checkpoint's
  `client_params` (given, or loaded from `model_dir` on first use).
- `drain()`: announce DRAINING, refuse opens and `kv_put`, flush the
  replication backlog, expire parked leases, wait for live sessions up to
  `drain_timeout`, stop.
- `rpc_push`: a step pushed by an upstream server (buffered briefly when it
  races ahead of its session's open). A step whose meta names a `route`
  pushes its output on to the next hop and acks its own stream; chained
  decode_n's control messages go straight to the waiting coordinator.
- `rpc_info`: the server's counters (the JAX server's batching, prefix,
  replication and lease keys under its names) and its ServerInfo.
- A background announcer re-declares the span in the registry every
  `announce_period`, with expiration as the liveness signal.

What this server does not serve yet is refused loudly, never ignored: an
open asking for a LoRA adapter fails its session with an error frame, and
the server refuses to start with the neural pruner or pruner training
(`BBTPU_PRUNER_METHOD=neural`, `BBTPU_PRUNER_TRAIN`: both learn by
gradient, ROADMAP item 17). The server advertises those features as off.

Two servers in one process on one card share the device's default stream:
each launches from its own compute thread, the split kernels' counters are
keyed by (device, stream) and every launch leaves them at zero, and
launches on one stream run in order, so sharing is safe.
"""

from __future__ import annotations

import asyncio
import dataclasses
import logging
import os
import uuid
from collections import OrderedDict

import numpy as np

import torch

from bloombee_tpu_torch.kv.cache_manager import CacheManager
from bloombee_tpu_torch.kv.quant import QuantSlab, slab_nbytes
from bloombee_tpu_torch.models.head import embed_impl, norm_head_impl
from bloombee_tpu_torch.models.spec import ModelSpec
from bloombee_tpu_torch.ops.cuda import build
from bloombee_tpu_torch.runtime.executor import (
    SpanExecutor,
    plan_prefill_chunks,
)
from bloombee_tpu_torch.server.compute_queue import (
    PRIORITY_INFERENCE,
    PRIORITY_TRAINING,
    ComputeQueue,
    DeadlineExpired,
    aged_chunk_priority,
)
from bloombee_tpu_torch.swarm.data import ServerInfo, ServerState
from bloombee_tpu_torch.swarm.ping import PingAggregator
from bloombee_tpu_torch.utils import clock, env, ledger, lockwatch
from bloombee_tpu_torch.utils.device import resolve_device
from bloombee_tpu_torch.wire.flow import FlowLimiter
from bloombee_tpu_torch.wire.rpc import (
    Connection,
    ConnectionClosed,
    RpcError,
    RpcServer,
    Stream,
    connect,
)
from bloombee_tpu_torch.wire.tensor_codec import (
    dtype_for_name,
    transport_stats,
)

logger = logging.getLogger(__name__)

env.declare(
    "BBTPU_KV_QUANT", str, "none",
    "KV cache quantization of a server that is not told: none | int4 "
    "(group-wise 4-bit device arena)",
)
env.declare(
    "BBTPU_MIXED_BATCH", bool, False,
    "mixed-batch dispatch (Sarathi-Serve fused iterations): let a popped "
    "prefill chunk absorb compatible queued single-token decode steps "
    "(and vice versa) into ONE ragged span dispatch "
    "(executor.ragged_group), so a mid-stream prefill no longer costs "
    "decodes a whole dispatch each. Falls back to separate dispatches on "
    "configs the ragged step doesn't cover, surfacing each declined "
    "reason in rpc_info ragged_declines. Off = the decode-only batcher "
    "and per-chunk prefill tasks",
)

env.declare(
    "BBTPU_SESSION_LEASE_S", float, 0.0,
    "session lease: a session whose client stream died (or went silent past "
    "this long) is PARKED — its KV pages are handed to the prefix pool as "
    "evictable refcount-0 cached entries, so a wedged or partitioned client "
    "can never pin memory — and stays resumable (resume: session_id on a "
    "fresh stream) for one more lease period before final reclaim. 0 "
    "disables leases: a dead stream frees the session immediately. Pair "
    "with BBTPU_KEEPALIVE_S so half-open streams are detected promptly",
)
env.declare(
    "BBTPU_SPEC_BATCH", bool, False,
    "batched tree-speculative verification: let concurrent sessions' "
    "tree-verify steps that share (layers, dtype) pad/stack into ONE "
    "ragged span dispatch (executor.ragged_group; with mixed batch also "
    "on, tree rows fuse with decode rows and a prefill chunk) instead of "
    "a solo dispatch per speculating session; per-session speculative KV "
    "still commits/rolls back row by row. Off = every tree-verify step "
    "dispatches solo",
)
env.declare(
    "BBTPU_PRUNER_METHOD", str, "simple",
    "draft-tree pruning strategy: 'simple' (probability threshold, "
    "reference simple_probability_pruner); 'neural' is refused (it learns "
    "by gradient, ROADMAP item 17)",
)
env.declare(
    "BBTPU_PRUNER_TRAIN", bool, False,
    "train the MidLMHead online from accepted paths: refused by the port "
    "(ROADMAP item 17)",
)
env.declare(
    "BBTPU_PRUNER_CKPT", str, "",
    "pruner-head checkpoint (.npz, as the JAX server saves it): loaded "
    "when present, else the head is the checkpoint's own norm + lm_head",
)

# concurrent standby-replication sweeps a server runs (each holds one
# export and one kv_put at a time): the JAX server's BBTPU_REPL_INFLIGHT
# default
REPL_INFLIGHT = 2

# per-token budget of a chained decode_n round trip through the
# downstream spans (the JAX server's chain_step_timeout)
CHAIN_STEP_TIMEOUT = 120.0


class _Session:
    def __init__(self, session_id: str, handle, batch_size: int,
                 layers: tuple[int, int] | None = None):
        self.id = session_id
        self.handle = handle
        self.batch_size = batch_size
        self.layers = layers  # relative (l0, l1) within this server's span
        self.push_inbox: asyncio.Queue = asyncio.Queue()
        # chained decode_n control messages (the tail span's selected ids
        # or errors) land here straight from rpc_push, not through
        # push_inbox, whose consumer (the session loop) is blocked inside
        # the coordinator waiting for exactly these messages
        self.chain_inbox: asyncio.Queue = asyncio.Queue()
        self.step_tasks: set[asyncio.Task] = set()  # in-flight mb chunks
        self.last_step_at = 0.0
        # per-session timing accumulators (the server half of the
        # reference's [TIMING_TABLE] decomposition)
        self.n_steps = 0
        self.sum_tokens = 0
        self.sum_dispatch_ms = 0.0
        self.sum_fetch_ms = 0.0
        self.opened_at = 0.0
        # measured speculation: drafted tree tokens this session verified
        # and how many its accepts kept (rpc_info session_spec)
        self.spec_drafted = 0
        self.spec_accepted = 0
        # True while the session could contribute a tree-verify row: the
        # kind-aware group_hint bounds a tree-only gather by the sessions
        # speculating. Optimistic start: until a plain decode step reveals
        # the session's kind it might speculate, so the first tree gathers
        # wait for it. (The JAX session's `last_tree` feeds the online
        # head trainer, which the port refuses: ROADMAP item 17.)
        self.speculating = True
        # session-KV replication to a standby (client-directed kv_repl
        # items): standby (host, port), the client's full-history hash
        # chains per row, pages already shipped per row, and a lock so
        # only one sweep drains the backlog at a time
        self.repl_standby: tuple[str, int] | None = None
        self.repl_chains: list[list[str]] | None = None
        self.repl_sent: list[int] | None = None
        self.repl_lock = lockwatch.async_lock("server.repl")
        # session lease / reconnect-resume. The stream-opening handler OWNS
        # the KV pages (allocate context) and survives stream death: it
        # parks, then waits on resume_waiter for either a resume handler
        # (which hands over its fresh stream) or the lease reaper
        self.parked = False
        self.reaped = False  # lease expired / resume impossible
        self.lease_deadline = 0.0  # monotonic; meaningful while parked
        self.cur_stream = None  # the stream the session loop serves now
        self.resume_waiter: asyncio.Event | None = None
        self.resume_stream = None  # set by the resume handler before wake
        # releases the resume handler whose stream the loop now serves
        self.detach_event: asyncio.Event | None = None
        self.stream_epoch = 0  # bumped per adopted stream
        # at-most-once step application: replies are recorded (keyed
        # (step, mb)) BEFORE first delivery, so a step retried after a
        # lost reply resends the recorded reply instead of re-applying KV
        self.last_step_id = -1
        self.applied_steps: dict[tuple[int, int], tuple[dict, list]] = {}
        # a prefix-cache adoption is SETTLED once a step has trimmed it to
        # the client's declared skip; until then the session steps solo
        # (the settle mutates the table), after it batches like any other
        self.adoption_settled = False
        # a stepped decode_n died after committing KV the client was never
        # told about: resuming would desync, so force a full replay
        self.kv_dirty = False


class SessionKVLost(RuntimeError):
    """The session's sequences no longer hold its KV: the step cannot run
    on a zeroed context, so it fails and the client replays."""


class _ChainError(RuntimeError):
    """A downstream span of a chained decode_n reported failure (pushed
    back as `chain_error`). `permanent` tells capability declines (the
    tail has no head parameters, or a dtype mismatch: the same route can
    never work, the client falls back to per-step decoding) from
    transient route failures (a span died mid-chain: the client rebuilds,
    replays and retries chained decode)."""

    def __init__(self, msg: str, permanent: bool = False):
        super().__init__(msg)
        self.permanent = permanent


@dataclasses.dataclass
class _BatchMember:
    """One session's single-token decode step inside a merged dispatch
    (continuous batching). `handle` is the session's cache handle or a row
    slice of it (micro-batch chunks batch like any other member)."""

    session: _Session
    handle: object
    hidden: torch.Tensor  # [b, 1, D] in the wire dtype


@dataclasses.dataclass
class _ChunkMember:
    """One prefill chunk inside a MIXED dispatch (`mixed_batch`): the
    multi-token member that rides a ragged span step alongside other
    sessions' single-token decodes. `first`/`last` carry the chunk
    stream's duties (the first chunk settles a prefix-cache adoption, the
    last commits the prompt) into whichever dispatch runs it."""

    session: _Session
    handle: object
    hidden: torch.Tensor  # [b, t, D] in the wire dtype
    last: bool
    first: bool = False
    prefix_skip: object = None


@dataclasses.dataclass
class _TreeMember:
    """One session's tree-verify step inside a batched ragged dispatch
    (`spec_batch`): the linearized draft tree's rows verify alongside
    other sessions' trees in one executor.ragged_group call. `handle` may
    be a row slice of the session handle (the client's live-row window)."""

    session: _Session
    handle: object
    hidden: torch.Tensor  # [b, t, D] in the wire dtype
    tree_mask: np.ndarray  # [b, t, t] bool ancestor-or-self visibility
    depths: np.ndarray  # [b, t] i32 node depths (rotary offsets)


class _PeerPool:
    """Cached outbound connections for server-to-server push.

    Locking is per-peer so one unreachable peer's connect timeout cannot
    stall pushes to healthy peers."""

    def __init__(self):
        self._conns: dict[tuple[str, int], Connection] = {}
        self._locks: dict[tuple[str, int], asyncio.Lock] = {}
        self._limiters: dict[tuple[str, int], FlowLimiter] = {}

    def limiter(self, host: str, port: int) -> FlowLimiter:
        """Per-peer adaptive push limiter."""
        key = (host, port)
        lim = self._limiters.get(key)
        if lim is None:
            lim = self._limiters[key] = FlowLimiter(name=f"{host}:{port}")
        return lim

    async def get(self, host: str, port: int) -> Connection:
        key = (host, port)
        lock = self._locks.get(key)
        if lock is None:
            lock = self._locks[key] = lockwatch.async_lock("server.peer_pool")
        async with lock:
            conn = self._conns.get(key)
            if conn is None or conn.is_closing():
                conn = await connect(host, port)
                self._conns[key] = conn
            return conn

    async def close(self):
        for c in self._conns.values():
            await c.close()
        self._conns.clear()


def _spec_entry(session: _Session) -> dict:
    """A session's drafted and accepted tree tokens (rpc_info)."""
    return {
        "drafted": session.spec_drafted,
        "accepted": session.spec_accepted,
        "accept_rate": session.spec_accepted / max(session.spec_drafted, 1),
    }


def _dtype_name(dtype: torch.dtype) -> str:
    """A torch dtype under the numpy name the JAX client sends as
    `head_dtype` ("float32", "bfloat16")."""
    return str(dtype).removeprefix("torch.")


def _nbytes(x) -> int:
    if isinstance(x, QuantSlab):
        return slab_nbytes(x)
    return x.numel() * x.element_size()


class BlockServer:
    def __init__(
        self,
        *,
        model_uid: str,
        start: int,
        end: int,
        params: list[dict] | None = None,  # per-layer params of [start, end)
        spec: ModelSpec | None = None,
        model_dir: str | None = None,
        registry=None,
        host: str = "127.0.0.1",
        port: int = 0,
        public_host: str | None = None,
        num_pages: int = 256,
        page_size: int = 16,
        compute_dtype=torch.bfloat16,
        max_chunk_tokens: int = 512,
        max_batch: int = 8,  # continuous batching: coalesce up to this
        # many compatible single-token decode steps (across sessions) into
        # one span dispatch; 1 disables the batcher. The gather window is
        # BBTPU_BATCH_WINDOW_MS (default 0: only already-queued steps
        # coalesce, so idle-server latency is untouched)
        announce_period: float = 5.0,
        alloc_timeout: float = 60.0,
        throughput: float = 1.0,
        kv_quant: str | None = None,  # None -> BBTPU_KV_QUANT
        keepalive_s: float | None = None,  # None -> BBTPU_KEEPALIVE_S
        prefill_chunk: int | None = None,  # stall-free scheduling: split
        # each plain prefill into chunks of at most this many tokens, each
        # its own compute-queue task (0 = monolithic; None ->
        # BBTPU_PREFILL_CHUNK)
        mixed_batch: bool | None = None,  # fuse a prefill chunk and
        # compatible queued decode steps into ONE ragged span dispatch
        # (None -> BBTPU_MIXED_BATCH; off = decode-only batching)
        spec_batch: bool | None = None,  # batched tree verification:
        # concurrent sessions' tree-verify steps share one ragged dispatch
        # (None -> BBTPU_SPEC_BATCH; off = solo tree dispatches)
        prefix_cache: bool | None = None,  # cross-session shared-prefix KV
        # cache: pool committed prompt pages under content hashes, adopt
        # them for sessions whose prompt matches (None ->
        # BBTPU_PREFIX_CACHE)
        session_lease_s: float | None = None,  # park a stream-dead
        # session's KV for this long, resumable by a reconnecting client
        # (None -> BBTPU_SESSION_LEASE_S; 0 = off)
        drain_timeout: float = 30.0,  # how long drain() waits for live
        # sessions before stopping under them (they replay elsewhere)
        client_params: dict | None = None,  # embed/norm/lm_head for the
        # server-side multi-step decode (decode_n); loaded from model_dir
        # on first use when omitted
        decode_n_max: int = 256,  # largest decode_n accepted per RPC (a
        # bigger n commits n KV slots per row before any compute, so an
        # unbounded request could exhaust the arena in one call)
        decode_n_fused: bool = True,  # False sends single-span decode_n
        # through the stepped loop too (a yardstick for the fused loop)
        device="cuda",
    ):
        if env.get("BBTPU_PRUNER_METHOD") == "neural":
            raise NotImplementedError(
                "BBTPU_PRUNER_METHOD=neural: the neural pruner learns by "
                "gradient, which the port does not have yet (ROADMAP Queue "
                "1 item 17)"
            )
        if env.get("BBTPU_PRUNER_TRAIN"):
            raise NotImplementedError(
                "BBTPU_PRUNER_TRAIN: online pruner-head training is not in "
                "the port yet (ROADMAP Queue 1 item 17)"
            )
        self.device = resolve_device(device)
        if params is None:
            from bloombee_tpu_torch.models.checkpoint import load_span_params

            params, spec = load_span_params(
                model_dir, start, end, dtype=compute_dtype,
                device=self.device,
            )
        if spec is None:
            raise ValueError("in-memory params need their spec")
        if kv_quant is None:
            kv_quant = env.get("BBTPU_KV_QUANT")
        self.model_uid = model_uid
        self.model_dir = model_dir
        self.start_block = start
        self.end_block = end
        self.spec = spec
        self.server_id = f"srv-{uuid.uuid4().hex[:8]}"
        self.registry = registry
        self.announce_period = announce_period
        self.alloc_timeout = alloc_timeout
        self.drain_timeout = float(drain_timeout)
        self.public_host = public_host or host
        self.throughput = throughput
        self.inference_rps: float | None = None
        self.manager = CacheManager(
            end - start, num_pages, page_size, spec.num_key_value_heads,
            spec.head_dim, dtype=compute_dtype, device=self.device,
            quant=kv_quant, prefix_cache=prefix_cache,
        )
        self.executor = SpanExecutor(
            params, spec, self.manager, max_chunk_tokens=max_chunk_tokens,
            compute_dtype=compute_dtype, start_block=start,
            device=self.device,
        )
        # replies ship in bf16 from a bf16 server, else f32 (the JAX
        # executor's transfer dtype)
        self.wire_dtype = "bf16" if compute_dtype == torch.bfloat16 else "f32"
        self._wire_torch_dtype = dtype_for_name(self.wire_dtype)
        self.max_batch = max(1, int(max_batch))
        # ragged-path declines, per reason: a requested-but-unsupported
        # fallback to separate dispatches is visible in rpc_info
        self.ragged_declines: dict[str, int] = {}
        if mixed_batch is None:
            mixed_batch = bool(env.get("BBTPU_MIXED_BATCH"))
        if mixed_batch:
            reason = self.executor.mixed_unsupported()
            if reason is not None:
                logger.info("mixed-batch dispatch disabled: %s", reason)
                self.ragged_declines[reason] = (
                    self.ragged_declines.get(reason, 0) + 1
                )
                mixed_batch = False
        self.mixed_batch = bool(mixed_batch)
        if spec_batch is None:
            spec_batch = bool(env.get("BBTPU_SPEC_BATCH"))
        if spec_batch:
            reason = self.executor.tree_group_unsupported()
            if reason is not None:
                logger.info("batched tree verification disabled: %s", reason)
                self.ragged_declines[reason] = (
                    self.ragged_declines.get(reason, 0) + 1
                )
                spec_batch = False
        self.spec_batch = bool(spec_batch)
        if self.mixed_batch or self.spec_batch:
            # one kind-aware gather predicate covers every batchable row
            # kind (decode rows, the prefill chunk, tree-verify rows); with
            # mixed batch the chunk rides one extra group slot so fusing
            # never costs the batcher any of its max_batch seats
            self.compute = ComputeQueue(
                max_group=self.max_batch + (1 if self.mixed_batch else 0),
                compat=self._ragged_compat,
                group_hint=self._batch_group_hint,
            )
        else:
            self.compute = ComputeQueue(
                max_group=self.max_batch, group_hint=self._batch_group_hint
            )
        self.peers = _PeerPool()
        # server-side multi-step decode (decode_n): the checkpoint's
        # embed/norm/lm_head trio, loaded from model_dir on first use
        self.decode_n_max = int(decode_n_max)
        self.decode_n_fused = bool(decode_n_fused)
        self._client_params = client_params
        self._client_params_unavailable = False
        self._client_params_lock: asyncio.Lock | None = None
        # decode_n calls answered, those the fused loop ran, and the span
        # steps they ran here (fused and stepped loops, chained hops)
        self.decode_n_calls = 0
        self.decode_n_fused_calls = 0
        self.decode_n_steps = 0
        # mid-chain draft-tree pruning: the MidLMHead loads lazily from
        # BBTPU_PRUNER_CKPT or the checkpoint's lm_head (model_dir)
        self._pruner_manager = None
        self._pruner_unavailable = False
        self._pruner_lock: asyncio.Lock | None = None
        # measured RTTs to servers of the block after this span, announced
        # in ServerInfo.next_pings for routing
        self.next_pings = PingAggregator()
        self._sessions: dict[str, _Session] = {}
        self._pending_pushes: dict[str, list] = {}
        self.pending_push_ttl = 30.0
        self._announce_task: asyncio.Task | None = None
        # counters (rpc_info)
        self.deadlines_expired = 0
        self.pushes_dropped = 0
        # session-KV replication (fast failover): sealed pages this primary
        # shipped to standbys, and tokens recovering clients replayed into
        # us; the semaphore bounds concurrent replication sweeps so standby
        # traffic can never crowd out live inference
        self.repl_pages_sent = 0
        self.failover_replayed_tokens = 0
        self._repl_sem = asyncio.Semaphore(REPL_INFLIGHT)
        # session leases + reconnect-resume: parked sessions reclaimed by
        # the reaper, parked sessions re-attached by a reconnecting client,
        # retried steps answered from the recorded reply
        self.session_lease_s = (
            float(env.get("BBTPU_SESSION_LEASE_S"))
            if session_lease_s is None else float(session_lease_s)
        )
        self.sessions_reaped = 0
        self.sessions_resumed = 0
        self.steps_deduped = 0
        self._reaper_task: asyncio.Task | None = None
        self._draining = False
        # continuous batching: member steps that shared a merged dispatch,
        # merged dispatches issued, and batcher-routed steps that ran alone
        # (width-1 pops, row-by-row replays after a failed merged dispatch)
        self.batched_steps = 0
        self.batch_dispatches = 0
        self.batch_solo_steps = 0
        # chunked prefill: the chunk budget (None -> BBTPU_PREFILL_CHUNK),
        # chunks and tokens run, decode steps that dispatched while some
        # session's prefill was mid-stream, and the live count of such
        # mid-stream prefills
        self.prefill_chunk = prefill_chunk
        self.prefill_chunks = 0
        self.prefill_chunk_tokens = 0
        self.decode_steps_interleaved = 0
        self._chunking_sessions = 0
        # mixed batch: fused ragged dispatches and the tokens they carried;
        # every inference dispatch counts in step_dispatches/step_tokens
        self.mixed_dispatches = 0
        self.mixed_tokens = 0
        self.step_dispatches = 0
        self.step_tokens = 0
        # ragged dispatches, and those that mixed row kinds
        self.ragged_group_dispatches = 0
        self.ragged_cross_kind_dispatches = 0
        # speculative decoding: tree-verify steps and the session rows they
        # carried, drafted vs accepted tree tokens, batched tree groups and
        # their members, and the acceptance of recently closed sessions
        self.tree_steps = 0
        self.tree_rows = 0
        self.spec_tokens_drafted = 0
        self.spec_tokens_accepted = 0
        self.tree_group_dispatches = 0
        self.tree_group_members = 0
        self._closed_session_spec: OrderedDict[str, dict] = OrderedDict()
        self.rpc = RpcServer(
            unary_handlers={
                "rpc_info": self._rpc_info,
                "kv_put": self._kv_put,
            },
            stream_handlers={"rpc_inference": self._rpc_inference},
            push_handlers={"rpc_push": self._rpc_push},
            host=host,
            port=port,
            keepalive_s=keepalive_s,
        )

    # ------------------------------------------------------------ lifecycle
    @property
    def port(self) -> int:
        return self.rpc.port

    async def start(self) -> None:
        await self.rpc.start()
        self.compute.start()
        if self.session_lease_s > 0:
            self._reaper_task = asyncio.create_task(self._lease_reaper_loop())
        if self.registry is not None:
            await self._announce(ServerState.ONLINE)
            self._announce_task = asyncio.create_task(self._announce_loop())
        logger.info(
            "server %s serving %s[%d:%d] on port %d", self.server_id,
            self.model_uid, self.start_block, self.end_block, self.port,
        )

    async def drain(self, timeout: float | None = None) -> None:
        """Graceful shutdown: announce DRAINING so routing stops starting
        new sessions here, refuse opens and kv_put, flush the standby
        replication backlog (a drained server's sessions then fail over
        with at most the unsealed tail to replay), force-expire parked
        leases (a wedged client never holds the drain), wait for the live
        sessions until `timeout` seconds (default `drain_timeout`) have
        passed, then stop."""
        if self._draining:
            return
        self._draining = True
        deadline = clock.monotonic() + (
            self.drain_timeout if timeout is None else float(timeout)
        )
        logger.info(
            "draining %s: %d in-flight session(s), up to %.0fs",
            self.server_id, len(self._sessions),
            deadline - clock.monotonic(),
        )
        if self.registry is not None:
            try:
                await self._announce(ServerState.DRAINING)
            except Exception as e:
                logger.warning("DRAINING announce failed: %s", e)
        flush = [
            asyncio.create_task(self._replicate_session(s))
            for s in list(self._sessions.values())
            if s.repl_standby is not None
        ]
        if flush:
            try:
                await asyncio.wait_for(
                    asyncio.gather(*flush, return_exceptions=True),
                    timeout=max(1.0, deadline - clock.monotonic()),
                )
            except asyncio.TimeoutError:
                logger.warning(
                    "replication flush outlived the drain window; standbys "
                    "hold a partial backlog"
                )
        reaped = 0
        for s in list(self._sessions.values()):
            if s.parked and not s.reaped:
                s.reaped = True
                if s.resume_waiter is not None:
                    s.resume_waiter.set()
                reaped += 1
        if reaped:
            logger.info(
                "drain force-expired %d parked session lease(s)", reaped
            )
        while self._sessions and clock.monotonic() < deadline:
            # sessions parking DURING the drain are refused (the park path
            # checks _draining), so only live streams remain to wait on
            await clock.async_sleep(0.1)
        if self._sessions:
            logger.warning(
                "%d session(s) outlived the drain; they will replay "
                "elsewhere", len(self._sessions),
            )
        await self.stop()

    async def stop(self) -> None:
        if self._reaper_task is not None:
            self._reaper_task.cancel()
        if self._announce_task is not None:
            self._announce_task.cancel()
        if self.registry is not None:
            try:
                await self.registry.revoke_blocks(
                    self.model_uid, self.server_id,
                    range(self.start_block, self.end_block),
                    # the tombstone must outlive any replica's stale copy of
                    # our announce (expiration = announce_period * 2.5)
                    expiration=max(60.0, self.announce_period * 2.5 + 10.0),
                )
            except Exception:
                # best-effort: the announce record expires on its own
                pass
        await self.compute.stop()
        await self.peers.close()
        await self.rpc.stop()

    def server_info(self) -> ServerInfo:
        return ServerInfo(
            state=(
                ServerState.DRAINING if self._draining else ServerState.ONLINE
            ),
            host=self.public_host,
            port=self.port,
            throughput=self.throughput,
            inference_rps=self.inference_rps,
            cache_tokens_left=self.manager.tokens_left,
            start_block=self.start_block,
            end_block=self.end_block,
            wire_dtype=self.wire_dtype,
            next_pings=self.next_pings.to_wire() or None,
            # clients need the page geometry to build prefix hash chains
            # (0 advertises "no prefix cache here")
            page_size=(
                self.manager.page_size if self.manager.prefix_cache else 0
            ),
            # clients only pick standbys that can install kv_put pages; a
            # draining server must not attract fresh replication traffic
            kv_repl=self.manager.repl_supported and not self._draining,
            # features this server does not serve, advertised off
            adapters=None,
            decode_n_max=self.decode_n_max,
            out_digest=False,
            artifacts=False,
        )

    async def _announce(self, state: ServerState) -> None:
        info = self.server_info()
        info.state = state
        await self.registry.declare_blocks(
            self.model_uid,
            self.server_id,
            range(self.start_block, self.end_block),
            info,
            expiration=self.announce_period * 2.5,
        )

    async def _announce_loop(self) -> None:
        while True:
            await clock.async_sleep(self.announce_period)
            try:
                # announce FIRST (liveness must not wait on pings); the
                # pings measured after ride the NEXT announce
                await self._announce(ServerState.ONLINE)
                await asyncio.wait_for(
                    self._measure_next_pings(), self.announce_period
                )
            except asyncio.TimeoutError:
                pass
            except Exception as e:
                logger.warning("announce failed: %s", e)

    async def _measure_next_pings(self) -> None:
        """Ping servers holding the block right after this span so routing
        can cost our push hop with real RTTs."""
        try:
            infos = await self.registry.get_module_infos(
                self.model_uid, [self.end_block]
            )
        except Exception:
            return
        if not infos or not infos[0].servers:
            return
        peers = [
            (sid, info.host, info.port)
            for sid, info in infos[0].servers.items()
            if sid != self.server_id and self.next_pings.needs_measure(sid)
        ][:8]
        if peers:
            await self.next_pings.measure_many(peers)

    # ------------------------------------------------------------------- RPCs
    def _memory_report(self) -> dict:
        """Bytes this server holds (span params, KV arena) and, on a card,
        the device allocator's counters."""
        report = {
            "span_params_bytes": sum(
                _nbytes(x) for layer in self.executor.params
                for x in layer.values()
            ),
            "kv_arena_bytes": sum(
                _nbytes(x) for x in self.manager.arena.values()
            ),
            "kv_tokens_capacity": self.manager.capacity_tokens,
            "kv_tokens_reserved": (
                self.manager.capacity_tokens - self.manager.tokens_left
            ),
            "device": {},
        }
        if self.device.type == "cuda":
            stats = torch.cuda.memory_stats(self.device)
            report["device"] = {
                "bytes_in_use": int(
                    stats.get("allocated_bytes.all.current", 0)
                ),
                "peak_bytes_in_use": int(
                    stats.get("allocated_bytes.all.peak", 0)
                ),
                "bytes_reserved": int(
                    stats.get("reserved_bytes.all.current", 0)
                ),
                "bytes_limit": int(
                    torch.cuda.get_device_properties(self.device).total_memory
                ),
            }
        return report

    async def _rpc_info(self, meta: dict, tensors):
        fused_decline = self._decode_n_ineligible()
        params_ok = not self._client_params_unavailable and (
            self._client_params is not None or self.model_dir is not None
        )
        whole = (
            self.start_block == 0
            and self.end_block == self.spec.num_hidden_layers
        )
        info = {
            "server_id": self.server_id,
            "server_time": clock.now(),  # NTP-style clock sync anchor
            "transport": transport_stats(),
            "wire_pipeline": self.rpc.pipeline_stats(),
            "deadlines_expired": self.deadlines_expired,
            "draining": self._draining,
            "standby": False,
            # session lifecycle (leases, keepalives, resume)
            "sessions_reaped": self.sessions_reaped,
            "sessions_resumed": self.sessions_resumed,
            "steps_deduped": self.steps_deduped,
            "keepalives_sent": self.rpc.keepalives_sent,
            "pushes_dropped": self.pushes_dropped,
            "session_lease_s": self.session_lease_s,
            "active_sessions": len(self._sessions),
            **self._session_ages(),
            # continuous batching, chunked prefill and mixed batch, under
            # the JAX server's names
            "batched_steps": self.batched_steps,
            "batch_dispatches": self.batch_dispatches,
            "batch_solo_steps": self.batch_solo_steps,
            "mean_batch_width": (
                self.batched_steps / self.batch_dispatches
                if self.batch_dispatches else 0.0
            ),
            # includes per-class sub-dicts ("prefill"/"decode")
            "queue_wait_ms": self.compute.wait_stats_ms(),
            "prefill_chunks": self.prefill_chunks,
            "prefill_chunk_tokens": self.prefill_chunk_tokens,
            "decode_steps_interleaved": self.decode_steps_interleaved,
            "mixed_batch": self.mixed_batch,
            "mixed_dispatches": self.mixed_dispatches,
            "mixed_tokens": self.mixed_tokens,
            "ragged_group_dispatches": self.ragged_group_dispatches,
            "ragged_cross_kind_dispatches": self.ragged_cross_kind_dispatches,
            "ragged_declines": dict(self.ragged_declines),
            # speculative decoding (batched tree verification): tree steps
            # served, the session rows they carried, drafted vs accepted
            # tree tokens (from the accepts riding each next step) and the
            # batched-group counters (mean_tree_batch_width > 1: sessions
            # really fused)
            "spec_batch": self.spec_batch,
            "tree_steps": self.tree_steps,
            "tree_rows": self.tree_rows,
            "spec_tokens_drafted": self.spec_tokens_drafted,
            "spec_tokens_accepted": self.spec_tokens_accepted,
            "spec_accept_rate": (
                self.spec_tokens_accepted / max(self.spec_tokens_drafted, 1)
            ),
            "tree_group_dispatches": self.tree_group_dispatches,
            "tree_group_members": self.tree_group_members,
            "mean_tree_batch_width": (
                self.tree_group_members / self.tree_group_dispatches
                if self.tree_group_dispatches else 0.0
            ),
            # per-session measured acceptance, keyed by session id; closed
            # sessions stay visible through a bounded ring
            "session_spec": {
                **dict(self._closed_session_spec),
                **{
                    sid: _spec_entry(s)
                    for sid, s in self._sessions.items() if s.spec_drafted
                },
            },
            "step_dispatches": self.step_dispatches,
            "step_tokens": self.step_tokens,
            "dispatches_per_token": (
                self.step_dispatches / max(self.step_tokens, 1)
            ),
            # prefix cache: sessions that adopted pooled prompt pages,
            # tokens they skipped prefilling, copy-on-write page splits,
            # cached-pool occupancy and kv_put pages installed here
            **self.manager.prefix_stats(),
            # replication: sealed pages shipped to standbys, the sealed-
            # but-unshipped backlog, tokens recovering clients replayed
            "repl_pages_sent": self.repl_pages_sent,
            "repl_lag_pages": self._repl_lag(),
            "failover_replayed_tokens": self.failover_replayed_tokens,
            **lockwatch.counters(),
            # the decode_n flavors this server serves: decode_n, any
            # single-span flavor (fused or stepped); decode_n_fused, the
            # device loop; decode_n_first / _last, the chained roles
            "decode_n": whole and params_ok,
            "decode_n_fused": fused_decline is None,
            "decode_n_first": self.start_block == 0 and params_ok,
            "decode_n_last": (
                self.end_block == self.spec.num_hidden_layers and params_ok
            ),
            "decode_n_calls": self.decode_n_calls,
            "decode_n_fused_calls": self.decode_n_fused_calls,
            "decode_n_steps": self.decode_n_steps,
            # this process's kernel launches by kernel (`ops/cuda/build.py`
            # counts; CPU runs launch none): a server in its own process
            # shows which kernels its steps went through
            "kernel_launches": dict(build.LAUNCHES),
            "memory": self._memory_report(),
            **self.server_info().to_wire(),
        }
        if fused_decline is not None:
            info["decode_n_decline"] = fused_decline
        return info, []

    # -------------------------------------------- session-KV replication
    async def _kv_put(self, meta: dict, tensors):
        """Standby side of session-KV replication: install hash-addressed
        sealed pages from a primary into the prefix pool as refcount-0
        cached entries. Cached pages are evictable, so replication can
        never run a healthy standby out of pages. Declines (installed=0 +
        reason) instead of erroring, so mixed swarms degrade to full
        replay."""
        decline = None
        if self._draining:
            decline = "draining"
        elif not self.manager.repl_supported:
            decline = (
                "kv replication unsupported (prefix cache off or quantized "
                "arena)"
            )
        elif int(meta.get("page_size", 0)) != self.manager.page_size:
            decline = "page_size mismatch"
        elif (
            int(meta.get("start", -1)) != self.start_block
            or int(meta.get("end", -1)) != self.end_block
        ):
            decline = "span mismatch"
        if decline is not None:
            return {"installed": 0, "reason": decline}, []
        hashes = [str(h) for h in (meta.get("hashes") or [])]
        if not hashes or len(tensors) != 2:
            return {"installed": 0, "reason": "empty or malformed payload"}, []
        try:
            installed = await self.compute.submit(
                PRIORITY_TRAINING, self.manager.install_replicated, hashes,
                tensors[0], tensors[1],
            )
        except ValueError as e:
            return {"installed": 0, "reason": str(e)}, []
        return {"installed": int(installed)}, []

    def _note_kv_repl(self, session: _Session, repl: dict) -> None:
        """Primary side: a client's kv_repl stream item names the standby
        and carries each row's full-history page-hash chain. Publish our
        own freshly sealed decode pages into the local pool under those
        hashes, then sweep the backlog to the standby in the background."""
        standby = repl.get("standby") or {}
        chains = [list(c) for c in (repl.get("chains") or [])]
        if not standby.get("host") or not chains:
            return
        if (
            session.repl_sent is None
            or len(session.repl_sent) != len(chains)
        ):
            session.repl_sent = [0] * len(chains)
        session.repl_standby = (str(standby["host"]), int(standby["port"]))
        session.repl_chains = chains
        self.manager.extend_seq_hashes(session.handle, chains)
        task = asyncio.create_task(self._replicate_session(session))
        # step_tasks membership matters: the session loop gathers these
        # before the allocate context frees the pages a sweep is exporting
        session.step_tasks.add(task)
        task.add_done_callback(session.step_tasks.discard)

    async def _replicate_session(self, session: _Session) -> None:
        """Drain the session's replication backlog. Serialized per session
        (repl_sent is the only progress state); re-sweeps until no pages
        ship, since the chains may grow while a sweep is in flight."""
        if session.repl_lock.locked():
            return  # an earlier trigger is still draining the backlog
        async with session.repl_lock:
            while await self._replicate_pass(session):
                pass

    async def _replicate_pass(self, session: _Session) -> bool:
        """One sweep over the session's rows; True when any pages shipped
        (the caller sweeps again). Failures leave repl_sent untouched so
        the next kv_repl trigger retries; a standby DECLINE stops
        replication for this session (the client re-picks a standby on
        recovery)."""
        standby = session.repl_standby
        chains = session.repl_chains
        sent_by_row = session.repl_sent
        if standby is None or not chains or sent_by_row is None:
            return False
        ps = self.manager.page_size
        seq_ids = session.handle.seq_ids
        progress = False
        for row, chain in enumerate(chains):
            if row >= len(seq_ids) or row >= len(sent_by_row):
                break
            sent = sent_by_row[row]
            if sent >= len(chain):
                continue
            async with self._repl_sem:
                try:
                    res = await self.compute.submit(
                        PRIORITY_TRAINING, self.manager.export_pages,
                        seq_ids[row], sent, len(chain),
                    )
                except Exception as e:
                    logger.debug("kv replication export failed: %s", e)
                    return False
                if res is None:
                    continue  # row parked/adopted/unsupported: skip
                k_dev, v_dev, hi = res
                n = int(hi) - sent

                def _export(dev, n=n):
                    # device [L, n*ps, kv, hd] -> host [n, L, ps, kv, hd]
                    # (one leading page axis: the standby installs per
                    # hash); the copy runs off the event loop
                    a = dev.cpu()
                    return a.reshape(
                        a.shape[0], n, ps, *a.shape[2:]
                    ).transpose(0, 1).contiguous()

                k = await asyncio.to_thread(_export, k_dev)
                v = await asyncio.to_thread(_export, v_dev)
                try:
                    conn = await self.peers.get(*standby)
                    reply, _ = await conn.call(
                        "kv_put",
                        {
                            "page_size": ps,
                            "start": self.start_block,
                            "end": self.end_block,
                            "hashes": list(chain[sent:int(hi)]),
                        },
                        [k, v],
                        timeout=30.0,
                    )
                except Exception as e:
                    logger.debug("kv replication push failed: %s", e)
                    return False
                installed = (
                    int(reply.get("installed", 0))
                    if isinstance(reply, dict) else 0
                )
                if installed <= 0:
                    logger.info(
                        "standby %s:%d declined kv_put (%s); stopping "
                        "replication for session %s", standby[0], standby[1],
                        (reply or {}).get("reason", "?"), session.id,
                    )
                    session.repl_standby = None
                    return False
                sent_by_row[row] = int(hi)
                self.repl_pages_sent += n
                progress = True
        return progress

    def _repl_lag(self) -> int:
        """Gauge: sealed-but-unshipped pages across replicating sessions
        (bounds how much a failover replays beyond the unsealed tail)."""
        lag = 0
        for s in self._sessions.values():
            if not s.repl_chains or s.repl_sent is None:
                continue
            for row, chain in enumerate(s.repl_chains):
                if row < len(s.repl_sent):
                    lag += max(0, len(chain) - s.repl_sent[row])
        return lag

    async def _rpc_inference(self, stream: Stream) -> None:
        """One decode session. Open meta: {session_id, batch_size, max_length,
        start?, end?} or {resume: session_id}; items: {step, commit, reply,
        route, ...} + [hidden (B, T, D)]."""
        meta = stream.open_meta
        if self._draining:
            # routing should already avoid us (DRAINING announce), but a
            # client racing a stale swarm view can still arrive: refuse
            # before allocating KV it could never finish using
            raise RuntimeError("server is draining; open a session elsewhere")
        if meta.get("resume") is not None:
            # reconnect-resume: re-attach a parked session instead of
            # allocating anything; this handler only hands its fresh
            # stream to the surviving page-owning handler
            await self._rpc_resume(stream, str(meta["resume"]))
            return
        if meta.get("adapter"):
            raise ValueError(
                f"open meta 'adapter' ({meta['adapter']!r}): per-request "
                "LoRA adapters are not served here"
            )
        session_id = meta["session_id"]
        batch = int(meta["batch_size"])
        max_length = int(meta["max_length"])
        layers = self._resolve_layers(meta)
        async with self.manager.allocate(
            batch, max_length, timeout=self.alloc_timeout
        ) as handle:
            session = _Session(session_id, handle, batch, layers)
            session.opened_at = clock.monotonic()
            session.last_step_at = session.opened_at
            self._sessions[session_id] = session
            self._drain_pending_pushes(session)
            cur_stream = stream
            try:
                while True:
                    session.cur_stream = cur_stream
                    try:
                        await self._session_loop(session, cur_stream)
                        break  # client half-closed: done
                    except (ConnectionClosed, OSError, RpcError) as e:
                        # the stream died under the session. With leases
                        # on (and KV not run ahead of the client's
                        # history), park and wait for a reconnect instead
                        # of freeing
                        if (
                            self.session_lease_s <= 0
                            or self._draining
                            or session.kv_dirty
                        ):
                            raise
                        cur_stream = await self._park_until_resumed(
                            session, e
                        )
                        if cur_stream is None:
                            break  # lease expired; pages reclaimed below
            finally:
                self._sessions.pop(session_id, None)
                if session.spec_drafted:
                    self._closed_session_spec[session_id] = _spec_entry(
                        session
                    )
                    while len(self._closed_session_spec) > 64:
                        self._closed_session_spec.popitem(last=False)
                session.parked = False
                # release the resume handler carrying the current stream
                if session.detach_event is not None:
                    session.detach_event.set()
                    session.detach_event = None
                if cur_stream is not None and cur_stream is not stream:
                    # the session ended on a RESUMED stream whose client is
                    # live and reading: half-close so it sees end-of-stream
                    try:
                        await cur_stream.close()
                    except Exception:
                        pass
                if session.n_steps:
                    wall = clock.monotonic() - session.opened_at
                    logger.info(
                        "[TIMING_TABLE] session=%s steps=%d tokens=%d "
                        "mean_dispatch_ms=%.2f mean_fetch_ms=%.2f "
                        "wall_s=%.2f steps_per_s=%.2f",
                        session.id, session.n_steps, session.sum_tokens,
                        session.sum_dispatch_ms / session.n_steps,
                        session.sum_fetch_ms / session.n_steps,
                        wall, session.n_steps / max(wall, 1e-9),
                    )

    # ------------------------------------------- session leases & resume
    async def _park_until_resumed(
        self, session: _Session, cause: Exception
    ) -> Stream | None:
        """The session's stream died but its lease keeps it alive: drain
        in-flight work, hand the KV pages to the prefix pool as evictable
        cached entries (under pressure they are evicted and the resume
        degrades to full replay), then sleep until a resume handler
        delivers a fresh stream or the reaper expires the lease. Returns
        the new stream, or None once the session is reclaimed."""
        # fence the dead stream: nothing may still be writing KV when the
        # pages change owner
        if session.step_tasks:
            await asyncio.gather(*session.step_tasks, return_exceptions=True)
        if session.detach_event is not None:
            # the stream that just died was itself a resumed one: let its
            # carrier handler go
            session.detach_event.set()
            session.detach_event = None
        session.cur_stream = None
        session.resume_stream = None
        session.resume_waiter = asyncio.Event()
        session.lease_deadline = clock.monotonic() + self.session_lease_s
        session.parked = True
        await self.manager.lease_park(session.handle)
        ledger.recovery("server.lease_park")
        logger.info(
            "session %s parked after stream death (%s: %s); resumable for "
            "%.1fs", session.id, type(cause).__name__, cause,
            self.session_lease_s,
        )
        await session.resume_waiter.wait()
        session.parked = False
        if session.reaped or session.resume_stream is None:
            self.manager.lease_reclaim(session.handle)
            self.sessions_reaped += 1
            ledger.recovery("server.lease_reap")
            logger.info(
                "session %s lease expired while parked; KV reclaimed",
                session.id,
            )
            return None
        stream = session.resume_stream
        session.resume_stream = None
        session.lease_deadline = 0.0
        return stream

    async def _rpc_resume(self, stream: Stream, session_id: str) -> None:
        """Resume half of reconnect-resume: re-attach a parked session to
        this fresh stream. On success the PARKED handler (which owns the
        pages) serves the stream; this handler holds the stream's RPC frame
        open until the session lets go of it. Declines (resumed: False)
        instead of erroring, so the client falls back to the standby /
        full-replay path."""
        session = self._sessions.get(session_id)
        reason = None
        if session is None:
            reason = "unknown session (lease expired or never parked here)"
        elif session.kv_dirty:
            reason = "session KV ran ahead of acked history; replay"
        elif not session.parked:
            # the old stream looks alive from here (half-open not yet
            # detected): the client knows better, so fence it and wait
            # briefly for the owner to park
            old = session.cur_stream
            if old is not None and old.conn is not stream.conn:
                old.conn.abort("superseded by session resume")
            for _ in range(100):
                if session.parked or session_id not in self._sessions:
                    break
                await clock.async_sleep(0.05)
            if not session.parked:
                reason = "session is still attached to a live stream"
        if reason is None and (
            session.reaped or clock.monotonic() >= session.lease_deadline
        ):
            reason = "session lease expired"
        if reason is None and not await self.manager.lease_resume(
            session.handle
        ):
            # parked pages were evicted under pressure: the copy is gone,
            # so expire the lease and let the parked handler reclaim now
            reason = "parked KV no longer intact; replay"
            session.reaped = True
            session.resume_waiter.set()
        if reason is not None:
            logger.info(
                "refusing resume of session %s: %s", session_id, reason
            )
            await stream.send({"resumed": False, "reason": reason})
            return
        session.stream_epoch += 1
        detach = asyncio.Event()
        session.detach_event = detach
        session.resume_stream = stream
        self.sessions_resumed += 1
        logger.info(
            "session %s resumed on a fresh stream (epoch %d, last applied "
            "step %d)", session_id, session.stream_epoch,
            session.last_step_id,
        )
        # the ack carries the last APPLIED step id so the client knows its
        # unacked tail (a retransmit of an applied step dedups anyway)
        await stream.send(
            {
                "resumed": True,
                "last_step": session.last_step_id,
                "epoch": session.stream_epoch,
            }
        )
        session.resume_waiter.set()
        await detach.wait()

    async def _lease_reaper_loop(self) -> None:
        """Expire parked sessions whose lease ran out, and fence live
        sessions whose client has been silent past the lease: a fenced
        stream fails into the ordinary park path, so even this late
        detection hands the pages to the pool rather than freeing them
        under a client that might still return."""
        interval = max(0.05, self.session_lease_s / 4)
        while True:
            await clock.async_sleep(interval)
            now = clock.monotonic()
            for session in list(self._sessions.values()):
                if session.parked:
                    if now >= session.lease_deadline and not session.reaped:
                        session.reaped = True
                        if session.resume_waiter is not None:
                            session.resume_waiter.set()
                    continue
                stream = session.cur_stream
                conn = stream.conn if stream is not None else None
                # the lease renews on any applied step AND any inbound
                # frame (keepalive pongs included)
                renewed = max(
                    session.last_step_at,
                    conn.last_recv if conn is not None else 0.0,
                )
                if conn is not None and now - renewed >= self.session_lease_s:
                    logger.warning(
                        "session %s silent for %.1fs (lease %.1fs): "
                        "fencing its stream", session.id, now - renewed,
                        self.session_lease_s,
                    )
                    conn.abort("session lease expired (silent client)")

    def _session_ages(self) -> dict:
        """rpc_info gauges: how old and how idle the live sessions are,
        and how many sit parked awaiting a resume."""
        now = clock.monotonic()
        ages = [now - s.opened_at for s in self._sessions.values()]
        idles = [now - s.last_step_at for s in self._sessions.values()]
        return {
            "sessions_parked": sum(
                1 for s in self._sessions.values() if s.parked
            ),
            "session_oldest_s": round(max(ages), 3) if ages else 0.0,
            "session_oldest_idle_s": round(max(idles), 3) if idles else 0.0,
        }

    def _dedup_step(self, session: _Session, meta: dict):
        """At-most-once: a step already applied (recorded reply) must not
        re-apply KV when the client retries it after a lost reply. Returns
        the recorded (resp_meta, tensors) to resend, or None for fresh
        work. Only with leases on: without resume there are no
        retransmits."""
        step = meta.get("step")
        if self.session_lease_s <= 0 or step is None:
            return None
        step = int(step)
        if step < session.last_step_id:
            # a long-superseded retransmit: the client has already acted
            # on newer steps, so ack it
            return {"step": step, "ack": True, "deduped": True}, []
        return session.applied_steps.get((step, int(meta.get("mb") or 0)))

    def _record_reply(
        self, session: _Session, meta: dict, resp: dict, tensors: list
    ) -> None:
        """Record a step's reply BEFORE first delivery (its KV mutation is
        applied by now): if the reply is lost to a dying stream, the
        client's post-resume retransmit gets this exact reply back instead
        of a second application. Only the latest step's replies are kept:
        the client never retries older ones."""
        step = meta.get("step")
        if self.session_lease_s <= 0 or step is None:
            return
        step = int(step)
        if step > session.last_step_id:
            session.last_step_id = step
            session.applied_steps.clear()
        session.applied_steps[(step, int(meta.get("mb") or 0))] = (
            resp, tensors,
        )

    def _resolve_layers(self, meta: dict) -> tuple[int, int] | None:
        """Honor a requested sub-span (the router may enter this server's span
        mid-way)."""
        start = int(meta.get("start", self.start_block))
        end = int(meta.get("end", self.end_block))
        if not (self.start_block <= start < end <= self.end_block):
            raise ValueError(
                f"requested blocks [{start},{end}) outside served span "
                f"[{self.start_block},{self.end_block})"
            )
        if (start, end) == (self.start_block, self.end_block):
            return None
        return (start - self.start_block, end - self.start_block)

    async def _session_loop(self, session: _Session, stream: Stream) -> None:
        """Race client-stream items against pushed items. Micro-batch chunks
        (mb_of > 1) run as concurrent tasks so chunk k+1's compute dispatches
        while chunk k's output is still in flight downstream; whole-batch
        steps keep strict sequential handling."""
        stream_next = asyncio.ensure_future(stream.recv())
        push_next = asyncio.ensure_future(session.push_inbox.get())
        try:
            while True:
                done, _ = await asyncio.wait(
                    {stream_next, push_next},
                    return_when=asyncio.FIRST_COMPLETED,
                )
                if stream_next in done:
                    item = stream_next.result()
                    if item is None:
                        break  # client closed the session
                    await self._handle_item(session, stream, *item)
                    stream_next = asyncio.ensure_future(stream.recv())
                if push_next in done:
                    meta, tensors = push_next.result()
                    await self._handle_item(session, stream, meta, tensors)
                    push_next = asyncio.ensure_future(session.push_inbox.get())
        finally:
            stream_next.cancel()
            if push_next.done() and not push_next.cancelled():
                # a pushed item won the race at teardown: requeue it so a
                # parked session's resume still sees it, and count it
                try:
                    session.push_inbox.put_nowait(push_next.result())
                except Exception:
                    pass
                self.pushes_dropped += 1
            else:
                push_next.cancel()
            # drain in-flight chunk tasks BEFORE the allocate context frees
            # the session's pages: a still-running dispatch must not write
            # KV into pages a new session may reuse
            if session.step_tasks:
                await asyncio.gather(
                    *session.step_tasks, return_exceptions=True
                )

    async def _handle_item(
        self, session: _Session, stream: Stream, meta: dict, tensors: list
    ) -> None:
        if int(meta.get("mb_of", 1)) <= 1:
            await self._run_step(session, stream, meta, tensors)
            return
        task = asyncio.create_task(
            self._run_step_logged(session, stream, meta, tensors)
        )
        session.step_tasks.add(task)
        task.add_done_callback(session.step_tasks.discard)

    async def _run_step_logged(
        self, session: _Session, stream: Stream, meta: dict, tensors: list
    ) -> None:
        try:
            await self._run_step(session, stream, meta, tensors)
        except asyncio.CancelledError:
            raise
        except Exception as e:
            # a failed chunk poisons the whole step: close the stream so the
            # client's retry path rebuilds the chain
            logger.warning("micro-batch step failed: %s", e)
            try:
                await stream.close()
            except Exception:
                pass

    def _note_deadline_expired(self, meta: dict, where: str) -> None:
        self.deadlines_expired += 1
        logger.info(
            "dropping step %s: client deadline expired %s (%d drops total)",
            meta.get("step"), where, self.deadlines_expired,
        )

    @staticmethod
    def _local_deadline(meta: dict) -> float | None:
        """meta['deadline_s'] (the relative remaining seconds stamped by
        the client or shrunk by the previous hop) -> a local monotonic
        cutoff, or None when the item carries no budget."""
        budget = meta.get("deadline_s")
        if budget is None:
            return None
        return clock.monotonic() + float(budget)

    async def _run_step(
        self, session: _Session, stream: Stream, meta: dict, tensors: list
    ) -> None:
        if meta.get("chain") is not None:
            # a pushed hop of a chained decode_n (never from the client
            # stream): errors go back to the coordinator as chain_error,
            # not onto our own client's stream
            await self._run_chain_step(session, meta, tensors)
            return
        repl = meta.get("kv_repl")
        if repl is not None:
            # session-KV replication control: record the standby and the
            # client's full-history hash chains, publish our own sealed
            # decode pages locally under those hashes, and ship the
            # backlog. Fire-and-forget: NO reply (one would desync the
            # client's strictly ordered step stream)
            self._note_kv_repl(session, repl)
            return
        cached = self._dedup_step(session, meta)
        if cached is not None:
            # at-most-once: this step was applied and its reply recorded
            # before the stream died; resend the identical reply instead
            # of mutating KV a second time
            self.steps_deduped += 1
            ledger.recovery("server.resume_dedup")
            resp, out_t = cached
            await stream.send({**resp, "deduped": True}, out_t)
            return
        # "deadline_s" is the RELATIVE time the client has left; a local
        # monotonic cutoff from arrival
        deadline = self._local_deadline(meta)
        if deadline is not None and clock.monotonic() > deadline:
            self._note_deadline_expired(meta, "on arrival")
            return
        probe = meta.get("prefix_probe")
        if probe is not None:
            # prefix-cache probe: adopt each row's longest pooled prompt
            # prefix NOW (refcount-pinning the pages against eviction) and
            # report the per-row hit; the client follows with the
            # chain-wide skip on its prefill. Host-side table work only,
            # under the manager's lock: no reason to queue behind compute
            matched = self.manager.adopt_prefix(session.handle, probe)
            resp = {"step": meta.get("step"), "prefix_matched": matched}
            self._record_reply(session, meta, resp, [])
            await stream.send(resp)
            return
        # speculative accept from the previous round: compact the surviving
        # KV rows onto the committed prefix before this step's compute
        # (full-width, on the whole session handle, before any row window)
        accept = meta.get("accept")
        if accept is not None:
            await self.compute.submit(
                PRIORITY_INFERENCE, self._accept, session,
                [np.asarray(a, dtype=np.int64) for a in accept],
            )
            # node 0 of each row is the previous round's bonus token:
            # certain, not drafted
            kept = sum(max(0, len(a) - 1) for a in accept)
            self.spec_tokens_accepted += kept
            session.spec_accepted += kept
        if meta.get("accept_only"):
            # the accept above compacted KV: record before delivery so a
            # retried accept after a lost reply never compacts twice
            resp = {"step": meta.get("step"), "ack": True}
            self._record_reply(session, meta, resp, [])
            await stream.send(resp)
            return
        if meta.get("decode_n"):
            await self._run_decode_n(session, stream, meta, tensors)
            return
        hidden = tensors[0]  # CPU, in the sender's wire dtype
        tree_mask = depths = None
        # kind-aware group_hint gauge: tree steps mark the session
        # speculating; a plain single-token decode step reveals one that
        # is not. Prefill and chunk steps leave it as it is.
        if meta.get("tree"):
            session.speculating = True
            tree_mask = tensors[1].numpy().astype(bool)
            if meta.get("depths") is not None:
                depths = np.asarray(meta["depths"], dtype=np.int32)
            # node 0 of each row is the previous bonus token
            drafted = int(hidden.shape[0]) * max(0, int(hidden.shape[1]) - 1)
            self.tree_steps += 1
            self.tree_rows += int(hidden.shape[0])
            self.spec_tokens_drafted += drafted
            session.spec_drafted += drafted
        elif hidden.shape[1] == 1:
            session.speculating = False
        commit = bool(meta.get("commit", True))
        # micro-batch chunk or live-row window: a row slice of the
        # session's cache handle
        rows = meta.get("rows")
        handle = session.handle
        if rows is not None and tuple(rows) != (0, session.batch_size):
            handle = dataclasses.replace(
                session.handle, seq_ids=session.handle.seq_ids[rows[0]:rows[1]]
            )
        if hidden.shape[0] != handle.batch_size:
            raise ValueError(
                f"step rows {rows} carry batch {hidden.shape[0]} != "
                f"{handle.batch_size} cache rows"
            )
        # ragged replay: each row commits to its own length after the step
        commit_lens = meta.get("commit_lens")
        if commit_lens is not None:
            commit_lens = [int(x) for x in commit_lens]
            if rows is not None:
                commit_lens = commit_lens[rows[0]:rows[1]]
        # dispatch on the serialized compute queue; the fetch runs here,
        # off the queue, so concurrent sessions overlap their round trips
        prefix_skip = meta.get("prefix_skip")
        try:
            if self._batchable(commit, hidden, tree_mask, commit_lens,
                               prefix_skip):
                # continuous batching: compatible single-token decode steps
                # of OTHER sessions that are queued right now (or arrive
                # within BBTPU_BATCH_WINDOW_MS) share one merged span
                # dispatch; this call still returns only our own rows. With
                # mixed_batch / spec_batch the group may also hold a
                # prefill chunk or tree-verify rows
                out_dev, t_dispatch_ms = await self.compute.submit_group(
                    PRIORITY_INFERENCE,
                    ("decode1", session.layers, None, str(hidden.dtype)),
                    _BatchMember(session, handle, hidden),
                    self._compute_ragged_group
                    if (self.mixed_batch or self.spec_batch)
                    else self._compute_step_group,
                    deadline=deadline,
                    task_class="decode",
                )
            elif self._tree_batchable(commit, tree_mask, depths,
                                      commit_lens, meta):
                # batched tree verification: compatible tree-verify steps
                # of OTHER speculating sessions pad/stack into one ragged
                # span dispatch (tree size is not part of the key)
                out_dev, t_dispatch_ms = await self.compute.submit_group(
                    PRIORITY_INFERENCE,
                    ("tree", session.layers, None, str(hidden.dtype)),
                    _TreeMember(session, handle, hidden, tree_mask, depths),
                    self._compute_ragged_group,
                    deadline=deadline,
                    task_class="decode",
                )
            else:
                spans = self._chunk_spans(hidden, commit, commit_lens)
                if spans is not None:
                    # stall-free scheduling: the prefill becomes a stream
                    # of resumable chunk tasks re-entering the priority
                    # queue, so other sessions' decode steps run between
                    # chunks instead of stalling behind the whole prompt
                    out_dev, t_dispatch_ms = await self._run_chunked_prefill(
                        session, handle, hidden, spans, deadline,
                        prefix_skip,
                    )
                else:
                    is_prefill = hidden.shape[1] > 1 and tree_mask is None
                    out_dev, t_dispatch_ms = await self.compute.submit(
                        PRIORITY_INFERENCE, self._compute_step, session,
                        handle, hidden, commit, commit_lens, tree_mask,
                        depths, prefix_skip,
                        deadline=deadline,
                        task_class="prefill" if is_prefill else "decode",
                    )
        except DeadlineExpired:
            self._note_deadline_expired(meta, "while queued")
            return
        t0 = clock.perf_counter()
        out = await asyncio.to_thread(self._fetch, out_dev)
        t_fetch_ms = (clock.perf_counter() - t0) * 1000.0
        timing_meta = {
            "t_compute_ms": t_dispatch_ms + t_fetch_ms,
            "t_dispatch_ms": t_dispatch_ms,
            "t_fetch_ms": t_fetch_ms,
        }
        session.n_steps += 1
        session.sum_tokens += int(hidden.shape[0]) * int(hidden.shape[1])
        session.sum_dispatch_ms += t_dispatch_ms
        session.sum_fetch_ms += t_fetch_ms

        # mid-chain tree pruning: score this span's output with the
        # MidLMHead and reply only the surviving rows + their indices
        # (reference backend.py:395-410 last-block prune, :763-775)
        keep = None
        prune = meta.get("prune")
        if prune is not None and tree_mask is not None:
            # first use loads the head OFF the event loop
            await self._ensure_pruner_loaded()
            keep = self._prune_tree(out, prune)
            if keep is not None:
                gather = torch.from_numpy(np.where(keep >= 0, keep, 0)).long()
                out = torch.stack(
                    [out[i][gather[i]] for i in range(out.shape[0])]
                )

        route = meta.get("route") or []
        reply = meta.get("reply", "tensor")
        if route:
            nxt = route[0]
            push_meta = {
                "session_id": nxt["session_id"],
                "step": meta.get("step"),
                "commit": commit,
                "tree": meta.get("tree", False),
                "reply": reply,
                "route": route[1:],
            }
            for key in ("mb", "mb_of", "rows", "commit_lens", "prefix_skip"):
                if meta.get(key) is not None:
                    push_meta[key] = meta[key]
            if meta.get("tree"):
                push_meta["depths"] = meta["depths"]
            if accept is not None:
                push_meta["accept"] = accept
            if deadline is not None:
                # forward the REMAINDER of the budget
                remaining = deadline - clock.monotonic()
                if remaining <= 0:
                    self._note_deadline_expired(meta, "before forwarding")
                    return
                push_meta["deadline_s"] = remaining
            push_tensors = [out]
            if tree_mask is not None:
                push_tensors.append(torch.from_numpy(tree_mask.astype(np.uint8)))
            try:
                conn = await self.peers.get(nxt["host"], nxt["port"])
                async with self.peers.limiter(nxt["host"],
                                              nxt["port"]).slot():
                    await conn.push("rpc_push", push_meta, push_tensors)
            except (ConnectionClosed, OSError, RpcError) as e:
                # the NEXT hop failed, not this session's client stream:
                # fail the step with an error frame the client recovers
                # from at once. Re-raised as is, the wire error would park
                # a leased session as if its own stream had died, and the
                # client would wait out its step timeout for a reply
                raise RuntimeError(
                    f"push to the next span at {nxt['host']}:{nxt['port']} "
                    f"failed: {e}"
                ) from e
            # ack our own client stream so it sees this hop succeeded
            # (recorded AFTER the downstream push: a resume-retried step
            # re-pushes only if the push itself never happened)
            resp = {"step": meta.get("step"), "ack": True, **timing_meta}
            self._record_reply(session, meta, resp, [])
            await stream.send(resp)
        elif reply == "ack":
            resp = {"step": meta.get("step"), "ack": True, **timing_meta}
            self._record_reply(session, meta, resp, [])
            await stream.send(resp)
        else:
            resp = {"step": meta.get("step"), **timing_meta}
            for key in ("mb", "rows"):
                if meta.get(key) is not None:
                    resp[key] = meta[key]
            if keep is not None:
                resp["keep"] = keep.tolist()
            # record-then-send: the KV commit already happened at
            # dispatch, so this reply is the step's only at-most-once fence
            self._record_reply(session, meta, resp, [out])
            await stream.send(resp, [out])

    def _accept(self, session: _Session, accept: list) -> None:
        """Runs on the compute thread (the only thread that mutates the
        paged table): compact and commit the previous round's accepted
        tree rows."""
        if not self.manager.epoch_valid(session.handle):
            raise SessionKVLost("session cache lost: replay")
        self.manager.accept_speculative(session.handle, accept)

    def _compute_step(self, session: _Session, handle, hidden, commit,
                      commit_lens, tree_mask=None, depths=None,
                      prefix_skip=None):
        """Runs on the compute thread: plan packing + asynchronous device
        dispatch only (the fetch happens off the queue). Returns the
        device output and the dispatch time in ms."""
        if not self.manager.epoch_valid(handle):
            raise SessionKVLost("session cache lost: replay")
        session.last_step_at = clock.monotonic()
        t0 = clock.perf_counter()
        if self.manager.has_adopted(handle):
            # settle an outstanding probe adoption: shrink each row's
            # adopted prefix to the chain-wide skip the client uses. A step
            # that declares no prefix_skip drops the adoption (skip 0), the
            # safe reading of a client that changed its mind
            self.manager.trim_adopted(handle, int(prefix_skip or 0))
        session.adoption_settled = True
        if hidden.shape[1] > 1 and tree_mask is None:
            out = self.executor.prefill(
                handle, hidden, commit=commit, layers=session.layers,
                fetch=False,
            )
        else:
            if hidden.shape[1] == 1 and self._chunking_sessions:
                # a decode step ran while some session's chunked prefill
                # was mid-stream: the stall this scheduler removes
                self.decode_steps_interleaved += 1
            out = self.executor.decode(
                handle, hidden, commit=commit, tree_mask=tree_mask,
                layers=session.layers, depths=depths, fetch=False,
            )
        if commit_lens is not None:
            # a ragged explicit-length commit is a failover replay: count
            # the replayed tokens (the replication bound reads them)
            self.manager.commit(handle, lengths=commit_lens)
            self.failover_replayed_tokens += int(
                hidden.shape[0] * hidden.shape[1]
            )
        self.step_dispatches += 1
        self.step_tokens += int(hidden.shape[0]) * int(hidden.shape[1])
        return out, (clock.perf_counter() - t0) * 1000.0

    # ------------------------------------------------ server-side decode_n
    async def _run_decode_n(
        self, session: _Session, stream: Stream, meta: dict, tensors: list
    ) -> None:
        """Server-side multi-step greedy decode: one RPC returns n token
        ids, amortizing the client round trip. Three flavors, picked per
        request:

        - FUSED (no route, a whole-model span over a dense arena): every
          step's plan built, then one device loop of embed -> span -> head
          -> select (`executor.decode_n`); the tokens are fetched once.
        - LOCAL STEPPED (no route, a whole-model span the fused loop does
          not cover: an int4 arena): the same loop driven per step from
          the host through the ordinary executor path.
        - CHAINED (a route): this span embeds and runs its blocks, pushes
          the hidden state downstream; the LAST span applies the head and
          pushes the next ids back here; this coordinator replies [B, n]
          ids after n rounds. The client pays one round trip per n tokens;
          the per-token hops ride server-to-server links.

        A server that cannot serve it replies decode_n_unsupported with
        the reason, so the client falls back to per-step decoding without
        banning the peer."""
        n = int(meta["decode_n"])
        route = meta.get("route") or []
        decline = None
        if not (1 <= n <= self.decode_n_max):
            # an unchecked n would let one RPC commit n slots per row
            decline = (
                f"decode_n={n} outside the server's accepted range "
                f"[1, {self.decode_n_max}]"
            )
        if decline is None:
            # every flavor embeds ids here: the session must enter the
            # model at block 0
            rel = session.layers or (0, self.end_block - self.start_block)
            if self.start_block + rel[0] != 0:
                decline = "session does not enter the model at block 0"
            elif (
                not route
                and self.start_block + rel[1] != self.spec.num_hidden_layers
            ):
                decline = (
                    "single-span decode_n needs the whole model on this "
                    "server (send a route for chained decode)"
                )
        if decline is None:
            await self._ensure_client_params()
            if self._client_params is None:
                decline = "server has no embed/norm/lm_head params"
        if decline is None:
            decline = self._head_dtype_mismatch(meta, "server")
        if decline is None:
            try:
                ids, finished = self._decode_n_inputs(session, meta, tensors)
            except ValueError as e:
                decline = str(e)
        if decline is not None:
            # the reason rides the reply so an operator sees why a client
            # fell back to per-step decoding
            logger.warning("decode_n declined: %s", decline)
            await stream.send(
                {
                    "step": meta.get("step"),
                    "decode_n_unsupported": True,
                    "reason": decline,
                }
            )
            return
        self.decode_n_calls += 1
        if route or self._decode_n_ineligible(session) is not None:
            await self._run_decode_n_stepped(
                session, stream, meta, ids, finished, route
            )
            return
        self.decode_n_fused_calls += 1
        await self._run_decode_n_fused(session, stream, meta, ids, finished)

    def _head_dtype_mismatch(self, meta: dict, role: str) -> str | None:
        """A client that loaded its head in another dtype would get other
        logits from this server's head than from its own per-step path."""
        want = meta.get("head_dtype")
        have = _dtype_name(self._client_params["lm_head"].dtype)
        if want is not None and want != have:
            return f"head dtype mismatch: client {want} vs {role} {have}"
        return None

    def _decode_n_inputs(self, session: _Session, meta: dict, tensors: list):
        """The call's first input ids [B] (int64, host) and the rows
        already at EOS [B] (bool numpy), checked before anything commits.
        Every id the loop embeds must index the table: on the card an
        out-of-range gather is a device assert that ends the process's
        CUDA context, every session on it included. Raises ValueError
        with the reason."""
        if not tensors:
            raise ValueError("decode_n carries no input ids")
        ids = torch.as_tensor(tensors[0]).reshape(-1).to(torch.int64)
        b = session.handle.batch_size
        if ids.shape[0] != b:
            raise ValueError(
                f"decode_n ids carry batch {ids.shape[0]} != {b} cache rows"
            )
        vocab = int(self._client_params["embed"].shape[0])
        if ids.numel() and not (0 <= int(ids.min()) and int(ids.max()) < vocab):
            raise ValueError(
                f"decode_n ids outside the vocabulary [0, {vocab})"
            )
        eos = meta.get("eos_token_id")
        if eos is not None and not (0 <= int(eos) < vocab):
            # the EOS clamp feeds eos back in as the next input id
            raise ValueError(
                f"eos_token_id {eos} outside the vocabulary [0, {vocab})"
            )
        finished = np.zeros((b,), dtype=bool)
        if meta.get("finished") is not None:
            finished = np.asarray(meta["finished"], dtype=bool).reshape(-1)
            if finished.shape[0] != b:
                raise ValueError(
                    f"decode_n finished carries {finished.shape[0]} rows "
                    f"!= {b} cache rows"
                )
        return ids, finished

    async def _run_decode_n_fused(
        self, session: _Session, stream: Stream, meta: dict,
        ids: torch.Tensor, finished: np.ndarray,
    ) -> None:
        n = int(meta["decode_n"])
        eos = meta.get("eos_token_id")

        def _dispatch():
            if not self.manager.epoch_valid(session.handle):
                raise SessionKVLost("session cache lost: replay")
            session.last_step_at = clock.monotonic()
            t0 = clock.perf_counter()
            out = self.executor.decode_n(
                session.handle, ids, n, self._client_params,
                eos_token_id=eos, finished=finished,
            )
            self.decode_n_steps += n
            return out, (clock.perf_counter() - t0) * 1000.0

        try:
            out_dev, t_dispatch_ms = await self.compute.submit(
                PRIORITY_INFERENCE, _dispatch,
                deadline=self._local_deadline(meta),
            )
        except DeadlineExpired:
            self._note_deadline_expired(meta, "while queued")
            return
        t0 = clock.perf_counter()
        toks = await asyncio.to_thread(
            lambda: out_dev.cpu().to(torch.int32)
        )
        t_fetch_ms = (clock.perf_counter() - t0) * 1000.0
        session.n_steps += n
        session.sum_tokens += int(ids.shape[0]) * n
        session.sum_dispatch_ms += t_dispatch_ms
        session.sum_fetch_ms += t_fetch_ms
        resp = {
            "step": meta.get("step"),
            "t_compute_ms": t_dispatch_ms + t_fetch_ms,
            "t_dispatch_ms": t_dispatch_ms,
            "t_fetch_ms": t_fetch_ms,
        }
        # the loop committed n slots per row: record before delivery so a
        # retry after a resume resends these tokens instead of decoding
        # (and committing) n more
        self._record_reply(session, meta, resp, [toks])
        await stream.send(resp, [toks])

    async def _run_decode_n_stepped(
        self, session: _Session, stream: Stream, meta: dict,
        ids: torch.Tensor, finished: np.ndarray, route: list,
    ) -> None:
        """The host-driven decode_n loop (the LOCAL STEPPED and CHAINED
        flavors). Each round: embed the current ids, run this span's
        ordinary per-step decode, then apply the head here (no route) or
        push the hidden state downstream and wait for the tail's ids. EOS
        masking happens here, as in the client's per-step loop.

        Failure contract: once any KV was committed in this call, spans
        hold extra tokens, so the decline carries dirty=True and the
        client rebuilds and replays before it goes on."""
        n = int(meta["decode_n"])
        ids = ids.numpy()
        b = int(ids.shape[0])
        eos = meta.get("eos_token_id")
        cid = uuid.uuid4().hex[:12]
        # drop stale control messages of an earlier timed-out chain
        while not session.chain_inbox.empty():
            session.chain_inbox.get_nowait()
        toks = np.zeros((b, n), dtype=np.int32)
        committed = 0
        t_start = clock.perf_counter()
        t_dispatch_sum = 0.0
        # the whole call's budget: one cold-start allowance plus 1 s a
        # token, under the client's receive budget (2 x step_timeout + n),
        # so the server always answers first; never past the client's own
        t_deadline = clock.monotonic() + CHAIN_STEP_TIMEOUT + float(n)
        budget = meta.get("deadline_s")
        if budget is not None:
            t_deadline = min(t_deadline, clock.monotonic() + float(budget))
        try:
            for i in range(n):
                if clock.monotonic() > t_deadline:
                    raise _ChainError(
                        f"chain exceeded its {CHAIN_STEP_TIMEOUT:.0f}s"
                        f"+{n}s budget after {i}/{n} tokens"
                    )

                def _dispatch(ids_now=ids):
                    if not self.manager.epoch_valid(session.handle):
                        raise SessionKVLost("session cache lost: replay")
                    session.last_step_at = clock.monotonic()
                    t0 = clock.perf_counter()
                    out = self.executor.decode(
                        session.handle, self._embed_ids(ids_now),
                        commit=True, layers=session.layers, fetch=False,
                    )
                    self.decode_n_steps += 1
                    return out, (clock.perf_counter() - t0) * 1000.0

                out_dev, dt_ms = await self.compute.submit(
                    PRIORITY_INFERENCE, _dispatch
                )
                committed += 1
                t_dispatch_sum += dt_ms
                if route:
                    out = await asyncio.to_thread(self._fetch, out_dev)
                    chain = {
                        "origin": {
                            "host": self.public_host,
                            "port": self.port,
                            "session_id": session.id,
                        },
                        "cid": cid,
                        "i": i,
                    }
                    await self._push_hop(
                        route, chain, meta.get("step"),
                        meta.get("head_dtype"), out,
                        deadline_s=t_deadline - clock.monotonic(),
                    )
                    nxt = await self._await_chain_ids(
                        session, cid, i, t_deadline
                    )
                else:
                    nxt = await self.compute.submit(
                        PRIORITY_INFERENCE, self._select_head, out_dev
                    )
                # EOS masking: the client's per-step `_mask_finished`
                if eos is not None:
                    nxt = np.where(finished, eos, nxt)
                    finished = finished | (nxt == eos)
                toks[:, i] = nxt
                ids = nxt.astype(np.int64)
        except Exception as e:
            if isinstance(e, SessionKVLost):
                raise
            # committed KV the client was never told about makes a parked
            # resume unsound: if the decline below cannot be delivered,
            # the park path sees kv_dirty and the client replays in full
            session.kv_dirty = committed > 0
            logger.warning(
                "stepped decode_n failed after %d/%d committed steps: %s",
                committed, n, e,
            )
            resp = {
                "step": meta.get("step"),
                "decode_n_unsupported": True,
                "reason": f"{type(e).__name__}: {e}",
                # committed KV ran ahead of the client's history: it must
                # rebuild and replay before it goes on
                "dirty": committed > 0,
                # a span that died mid-chain is worth a rebuild and a retry
                # of chained decode; capability declines are not
                "transient": not getattr(e, "permanent", False),
            }
            # KV was committed: like any applied step, the reply is
            # recorded before delivery, so a retransmit after a resume
            # gets this dirty decline back instead of a second call on top
            # of the extra tokens
            self._record_reply(session, meta, resp, [])
            await stream.send(resp)
            # the decline reached the client, which rebuilds and replays:
            # the extra KV no longer blocks a later park
            session.kv_dirty = False
            return
        total_ms = (clock.perf_counter() - t_start) * 1000.0
        session.n_steps += n
        session.sum_tokens += b * n
        session.sum_dispatch_ms += t_dispatch_sum
        session.sum_fetch_ms += max(total_ms - t_dispatch_sum, 0.0)
        resp = {
            "step": meta.get("step"),
            "t_compute_ms": total_ms,
            "t_dispatch_ms": t_dispatch_sum,
            "t_fetch_ms": max(total_ms - t_dispatch_sum, 0.0),
        }
        toks_t = torch.from_numpy(toks)
        self._record_reply(session, meta, resp, [toks_t])
        await stream.send(resp, [toks_t])

    async def _push_hop(
        self, route: list, chain: dict, step, head_dtype, out,
        deadline_s: float | None = None,
    ) -> None:
        """Push one chained-decode hidden state to the next hop (the
        coordinator's and the middle spans' one copy of the hop's wire
        format, the JAX server's)."""
        nxt_hop = route[0]
        push_meta = {
            "session_id": nxt_hop["session_id"],
            "step": step,
            "commit": True,
            "chain": chain,
            "route": route[1:],
        }
        if head_dtype is not None:
            push_meta["head_dtype"] = head_dtype
        if deadline_s is not None:
            push_meta["deadline_s"] = deadline_s
        conn = await self.peers.get(nxt_hop["host"], nxt_hop["port"])
        async with self.peers.limiter(
            nxt_hop["host"], nxt_hop["port"]
        ).slot():
            await conn.push("rpc_push", push_meta, [out])

    async def _await_chain_ids(
        self, session: _Session, cid: str, i: int, t_deadline: float
    ) -> np.ndarray:
        """Wait for the tail span's selected ids of chain step (cid, i);
        stale messages of earlier chains are dropped, errors raise. Bounded
        by the chain's deadline, so the call always answers inside the
        client's receive budget."""
        while True:
            remaining = t_deadline - clock.monotonic()
            if remaining <= 0:
                raise asyncio.TimeoutError("chain deadline exhausted")
            msg_meta, msg_tensors = await asyncio.wait_for(
                session.chain_inbox.get(), remaining
            )
            if msg_meta.get("cid") != cid:
                continue  # a stale chain
            if msg_meta.get("chain_error"):
                raise _ChainError(
                    msg_meta["chain_error"],
                    permanent=bool(msg_meta.get("permanent")),
                )
            if int(msg_meta.get("i", -1)) != i:
                raise _ChainError(
                    f"chain step mismatch: got {msg_meta.get('i')}, "
                    f"expected {i}"
                )
            nxt = torch.as_tensor(msg_tensors[0]).reshape(-1).numpy().astype(
                np.int64
            )
            vocab = int(self._client_params["embed"].shape[0])
            if nxt.shape[0] != session.handle.batch_size or (
                nxt.size and not (0 <= nxt.min() and nxt.max() < vocab)
            ):
                # the next round embeds these: never gather out of range
                raise _ChainError(
                    f"chain ids of shape {nxt.shape} outside the "
                    f"vocabulary [0, {vocab}) or the batch",
                    permanent=True,
                )
            return nxt

    async def _run_chain_step(
        self, session: _Session, meta: dict, tensors: list
    ) -> None:
        """One pushed hop of a chained decode_n on a MIDDLE or TAIL span:
        run the span step; a middle pushes the hidden state on, the tail
        applies the head and pushes the ids back to the coordinator. Every
        failure travels to the coordinator as a chain_error push, never
        onto this span's own client stream (the client is not reading it
        during a decode_n call)."""
        chain = meta["chain"]
        origin = chain["origin"]
        deadline = self._local_deadline(meta)
        try:
            hidden = tensors[0]

            def _dispatch():
                if not self.manager.epoch_valid(session.handle):
                    raise SessionKVLost("session cache lost: replay")
                session.last_step_at = clock.monotonic()
                out = self.executor.decode(
                    session.handle, hidden, commit=True,
                    layers=session.layers, fetch=False,
                )
                self.decode_n_steps += 1
                return out

            route = meta.get("route") or []
            if not route:
                # the tail's eligibility is checked before it commits: the
                # coordinator committed this round anyway, and a dirty
                # replay covers either order, so fail the cheapest way
                err = await self._chain_tail_ineligible(meta)
                if err is not None:
                    raise _ChainError(err, permanent=True)
            try:
                out_dev = await self.compute.submit(
                    PRIORITY_INFERENCE, _dispatch, deadline=deadline
                )
            except DeadlineExpired:
                # the coordinator's deadline already fired and it answered
                # its client: a chain_error would land on a stale cid
                self._note_deadline_expired(meta, "in chain hop queue")
                return
            session.n_steps += 1
            session.sum_tokens += int(hidden.shape[0])
            if route:
                out = await asyncio.to_thread(self._fetch, out_dev)
                remaining = None
                if deadline is not None:
                    remaining = deadline - clock.monotonic()
                    if remaining <= 0:
                        self._note_deadline_expired(
                            meta, "before chain forward"
                        )
                        return
                await self._push_hop(
                    route, chain, meta.get("step"), meta.get("head_dtype"),
                    out, deadline_s=remaining,
                )
            else:
                nxt = await self.compute.submit(
                    PRIORITY_INFERENCE, self._select_head, out_dev
                )
                conn = await self.peers.get(origin["host"], origin["port"])
                async with self.peers.limiter(
                    origin["host"], origin["port"]
                ).slot():
                    await conn.push(
                        "rpc_push",
                        {
                            "session_id": origin["session_id"],
                            "chain_ids": True,
                            "cid": chain.get("cid"),
                            "i": chain.get("i"),
                        },
                        [torch.from_numpy(nxt.astype(np.int32))],
                    )
        except Exception as e:
            logger.warning("chain step failed: %s", e)
            try:
                conn = await self.peers.get(origin["host"], origin["port"])
                await conn.push(
                    "rpc_push",
                    {
                        "session_id": origin["session_id"],
                        "chain_error": f"{type(e).__name__}: {e}",
                        "permanent": bool(getattr(e, "permanent", False)),
                        "cid": chain.get("cid"),
                    },
                    [],
                )
            except Exception:
                pass  # the coordinator's deadline covers a dead push path

    async def _chain_tail_ineligible(self, meta: dict) -> str | None:
        """Why this span cannot play the TAIL role (norm + head) of a
        chained decode_n; None when it can."""
        if self.end_block != self.spec.num_hidden_layers:
            return (
                f"span ends at block {self.end_block}, not the model's "
                f"last block {self.spec.num_hidden_layers}"
            )
        await self._ensure_client_params()
        if self._client_params is None:
            return "tail has no norm/lm_head params"
        return self._head_dtype_mismatch(meta, "tail")

    def _embed_ids(self, ids: np.ndarray) -> torch.Tensor:
        """ids [B] -> hidden [B, 1, D] in the wire dtype, on the device: the
        client's embed (the table's dtype, then f32) and its wire cast, so
        the stepped loop feeds the span what the per-step path feeds it."""
        ids_t = torch.as_tensor(np.asarray(ids, dtype=np.int64))[:, None]
        h = embed_impl(self._client_params, ids_t.to(self.device),
                       self.spec.embedding_multiplier,
                       "embed_norm" in self._client_params,
                       self.spec.rms_norm_eps).float()
        return h.to(self._wire_torch_dtype)

    def _select_head(self, out_dev) -> np.ndarray:
        """Span output [B, 1, D] -> greedy next ids [B] (int64, host),
        through the client's per-step math: the wire-dtype fetch cast to
        f32, norm + head, first-index argmax."""
        out = out_dev.to(self._wire_torch_dtype).float()
        logits = norm_head_impl(
            self._client_params, out[:, -1:], self.spec.rms_norm_eps,
            self.spec.logits_soft_cap, self.spec.norm_type,
        )[:, 0]
        return logits.argmax(dim=-1).cpu().numpy().astype(np.int64)

    def _decode_n_ineligible(self, session: _Session | None = None):
        """Why this server cannot run the FUSED decode_n loop (for the
        session, when given); None when it can. The stepped loop has
        weaker needs (`_run_decode_n`). Surfaced in rpc_info as
        decode_n_decline."""
        if not self.decode_n_fused:
            return "fused loop off (decode_n_fused=False)"
        if session is not None and session.layers is not None:
            return "session routes a sub-span, not the whole model"
        # the loop applies the head after THIS span: the span must be the
        # whole model
        if not (
            self.start_block == 0
            and self.end_block == self.spec.num_hidden_layers
        ):
            return (
                f"span [{self.start_block},{self.end_block}) is not the "
                f"whole model"
            )
        if self.manager.quant is not None:
            return "quantized KV arena"
        if self._client_params_unavailable or (
            self._client_params is None and self.model_dir is None
        ):
            return "server has no embed/norm/lm_head params"
        return None

    async def _ensure_client_params(self) -> None:
        if (
            self._client_params is not None
            or self._client_params_unavailable
        ):
            return
        if self.model_dir is None:
            self._client_params_unavailable = True
            return
        if self._client_params_lock is None:
            self._client_params_lock = lockwatch.async_lock(
                "server.client_params"
            )
        async with self._client_params_lock:
            if (
                self._client_params is None
                and not self._client_params_unavailable
            ):
                # a multi-GB read: off the event loop
                await asyncio.to_thread(self._load_client_params)

    def _load_client_params(self) -> None:
        from bloombee_tpu_torch.models.checkpoint import load_client_params

        try:
            # the checkpoint's own dtype, as the client loads it, so the
            # server's head gives the client's per-step logits
            self._client_params = load_client_params(
                self.model_dir, device=self.device
            )
        except Exception as e:
            logger.warning("decode_n unavailable (client params): %s", e)
            self._client_params_unavailable = True

    # ------------------------------------------- stall-free chunked prefill
    def _chunk_budget(self) -> int:
        """Per-prefill chunk token budget: the constructor's value wins,
        else BBTPU_PREFILL_CHUNK; 0 disables (monolithic prefill)."""
        if self.prefill_chunk is not None:
            return int(self.prefill_chunk)
        return int(env.get("BBTPU_PREFILL_CHUNK"))

    def _chunk_spans(
        self, hidden, commit, commit_lens
    ) -> list[tuple[int, int]] | None:
        """[start, end) chunk spans for this step, or None when the step
        stays one monolithic compute task. Only plain committing prefills
        chunk: speculative (commit=False) and ragged-replay steps own
        their table side effects."""
        budget = self._chunk_budget()
        if (
            budget <= 0
            or hidden.shape[1] <= 1
            or not commit
            or commit_lens is not None
        ):
            return None
        spans = plan_prefill_chunks(
            hidden.shape[1], budget, cap=self.executor.max_chunk_tokens
        )
        return spans if len(spans) > 1 else None

    async def _run_chunked_prefill(
        self, session: _Session, handle, hidden, spans, deadline,
        prefix_skip=None,
    ):
        """Drive one prefill as a stream of resumable chunk tasks. Each
        chunk is its own compute-queue submission at an AGING chunk
        priority (fresh streams yield to queued decode steps; an old
        stream reaches decode priority, so it cannot starve), with the
        client deadline re-checked between chunks and at each chunk's
        queue pop.

        Chunks write their KV speculatively; the FIRST chunk settles a
        pending prefix-cache adoption (a suffix prefill chunks too), and
        the LAST chunk's compute-thread slot commits the whole prompt, so
        any abort (deadline expiry, a failed chunk) rolls back and frees
        every partial page.
        Returns (per-chunk device outputs, total dispatch ms); `_fetch`
        concatenates the chunk list off the queue."""
        stream_t0 = clock.monotonic()
        outs: list = []
        total_ms = 0.0
        last = len(spans) - 1
        self._chunking_sessions += 1
        try:
            for idx, (s, e) in enumerate(spans):
                if deadline is not None and clock.monotonic() > deadline:
                    raise DeadlineExpired(
                        "client deadline expired between prefill chunks"
                    )
                if self.mixed_batch:
                    # batchable chunk: the worker may fuse it with queued
                    # decode steps into one ragged dispatch (and a popped
                    # decode may likewise absorb it)
                    out, dt_ms = await self.compute.submit_group(
                        aged_chunk_priority(stream_t0),
                        ("chunkm", session.layers, None, str(hidden.dtype),
                         e - s),
                        _ChunkMember(session, handle, hidden[:, s:e],
                                     idx == last, idx == 0, prefix_skip),
                        self._compute_ragged_group,
                        deadline=deadline,
                        task_class="prefill",
                    )
                else:
                    out, dt_ms = await self.compute.submit(
                        aged_chunk_priority(stream_t0),
                        self._compute_prefill_chunk, session, handle,
                        hidden[:, s:e], idx == last, idx == 0, prefix_skip,
                        deadline=deadline,
                        task_class="prefill",
                    )
                outs.append(out)
                total_ms += dt_ms
                self.prefill_chunks += 1
                self.prefill_chunk_tokens += int(hidden.shape[0]) * (e - s)
        except BaseException:
            # free the partial prefill's speculative pages now: a session
            # holding pages for a prompt nobody will finish is a leak until
            # close, and a deadline abort exists to release capacity
            await self._abort_chunked_prefill(handle)
            raise
        finally:
            self._chunking_sessions -= 1
        return outs, total_ms

    async def _abort_chunked_prefill(self, handle) -> None:
        """Roll the handle back to its committed state, freeing the aborted
        prefill's speculative pages, on the compute thread (the only thread
        that mutates the paged table)."""
        try:
            await self.compute.submit(
                PRIORITY_INFERENCE, self._rollback_if_valid, handle
            )
        except Exception:
            logger.warning(
                "chunked-prefill rollback failed; pages free at session "
                "close instead", exc_info=True,
            )

    def _rollback_if_valid(self, handle) -> None:
        if self.manager.epoch_valid(handle):
            self.manager.rollback(handle)

    def _compute_prefill_chunk(self, session: _Session, handle, hidden,
                               last: bool, first: bool = False,
                               prefix_skip=None):
        """Runs on the compute thread: one chunk of a chunked prefill. Same
        contract as _compute_step (dispatch only); the FIRST chunk settles
        a pending prefix-cache adoption, every chunk writes speculatively
        and the LAST chunk commits the whole prompt."""
        if not self.manager.epoch_valid(handle):
            raise SessionKVLost("session cache lost: replay")
        session.last_step_at = clock.monotonic()
        t0 = clock.perf_counter()
        if first and self.manager.has_adopted(handle):
            self.manager.trim_adopted(handle, int(prefix_skip or 0))
        session.adoption_settled = True
        # recovery owner: _run_chunked_prefill's abort (a rollback)
        out = self.executor.prefill_chunk(
            handle, hidden, commit=False, layers=session.layers, fetch=False,
        )
        if last:
            self.manager.commit(handle)
        self.step_dispatches += 1
        self.step_tokens += int(hidden.shape[0]) * int(hidden.shape[1])
        return out, (clock.perf_counter() - t0) * 1000.0

    # ------------------------------------------------ continuous batching
    def _batchable(self, commit, hidden, tree_mask, commit_lens,
                   prefix_skip=None) -> bool:
        """Whether this step may share a merged dispatch: plain committing
        single-token decode only. Tree-verify steps, prefills, ragged
        replays and speculative (commit=False) steps keep their own compute
        task: their table side effects are per session. A step declaring
        prefix_skip is a suffix PREFILL even at one token and settles its
        adoption on the solo path; a draining server stops coalescing."""
        return (
            self.max_batch > 1
            and hidden.shape[1] == 1
            and tree_mask is None
            and commit_lens is None
            and prefix_skip is None
            and commit
            and not self._draining
        )

    def _compute_step_group(self, members: list[_BatchMember]) -> list:
        """Runs on the compute thread: a group of compatible single-token
        decode steps as ONE merged span dispatch. Returns one outcome per
        member: (device out rows, dispatch_ms) or an Exception instance,
        which the queue raises only at that member's caller.

        A member whose KV is gone fails alone; if the merged dispatch
        itself fails, its speculative writes roll back and the group
        replays row by row, so one member's fault never sinks its peers."""
        results: list = [None] * len(members)
        ready: list[int] = []
        for i, m in enumerate(members):
            if not self.manager.epoch_valid(m.handle):
                results[i] = SessionKVLost("session cache lost: replay")
            elif (not m.session.adoption_settled
                  and self.manager.has_adopted(m.handle)):
                # an UNSETTLED prefix adoption takes the solo path
                # (_compute_step trims it to the declared skip first), but
                # only until its first step settles it
                results[i] = self._solo_member_step(m)
            else:
                ready.append(i)
        if len(ready) == 1:
            results[ready[0]] = self._solo_member_step(members[ready[0]])
        elif ready:
            group = [members[i] for i in ready]
            try:
                outs = self._dispatch_batched(group)
            except Exception as e:
                logger.warning(
                    "batched decode of %d sessions failed (%r); "
                    "replaying row-by-row", len(group), e,
                )
                outs = [self._solo_member_step(m) for m in group]
            for i, out in zip(ready, outs):
                results[i] = out
        return results

    def _solo_member_step(self, m: _BatchMember):
        self.batch_solo_steps += 1
        ledger.recovery("server.rollback_solo_replay")
        try:
            return self._compute_step(m.session, m.handle, m.hidden, True,
                                      None)
        except Exception as e:
            return e

    def _dispatch_batched(self, group: list[_BatchMember]) -> list:
        """One row-stacked span dispatch for >= 2 sessions' decode steps.
        KV writes go in speculatively and commit only after the dispatch
        succeeds, so a failure rolls the whole group's tables back to the
        pre-step state and the row-by-row replay appends no ghost tokens."""
        t0 = clock.perf_counter()
        now = clock.monotonic()
        for m in group:
            m.session.last_step_at = now
        handles = [m.handle for m in group]
        try:
            out, combined = self.executor.decode_group(
                handles, [m.hidden for m in group],
                layers=group[0].session.layers,
            )
        except Exception:
            self.manager.rollback(self.manager.combine_handles(handles))
            raise
        self.manager.commit(combined)
        dt_ms = (clock.perf_counter() - t0) * 1000.0
        rows = sum(m.handle.batch_size for m in group)
        self.batch_dispatches += 1
        self.batched_steps += len(group)
        self.step_dispatches += 1
        self.step_tokens += rows
        if self._chunking_sessions:
            self.decode_steps_interleaved += len(group)
        outs = []
        row = 0
        for m in group:
            b = m.handle.batch_size
            outs.append((out[row:row + b], dt_ms))
            row += b
        return outs

    # ----------------------------------------- batched tree verification
    def _tree_batchable(
        self, commit, tree_mask, depths, commit_lens, meta
    ) -> bool:
        """Whether this tree-verify step may share a batched ragged dispatch
        (`spec_batch`): a plain speculative (commit=False) tree step with
        depth positions. Pruned relay steps keep the solo path (their keep
        set is computed per session against the solo step's layout), as do
        failover replays (commit_lens) and prefix-skip settles; a draining
        server stops coalescing."""
        return (
            self.spec_batch
            and self.max_batch > 1
            and tree_mask is not None
            and depths is not None
            and not commit
            and commit_lens is None
            and meta.get("prune") is None
            and meta.get("prefix_skip") is None
            and not self._draining
        )

    def _compute_tree_group(self, members: list[_TreeMember]) -> list:
        """A tree-only group: packs, runs and rolls back through the one
        ragged runner."""
        return self._compute_ragged_group(members)

    def _solo_tree_step(self, m: _TreeMember):
        self.batch_solo_steps += 1
        try:
            return self._compute_step(
                m.session, m.handle, m.hidden, False, None, m.tree_mask,
                m.depths,
            )
        except Exception as e:
            return e

    # ----------------------------------------- universal ragged dispatch
    def _batch_group_hint(self, members: list | None = None) -> int:
        """Upper bound on how many members a ComputeQueue gather window
        could still collect: a session submits at most one step (or
        prefill chunk) at a time, so once every open session is in the
        group the window is dead time, and a solo session never waits it
        out.

        Kind-aware when only one of the batching flags is on: a tree-only
        gather can admit nothing but tree rows, so it is bounded by the
        sessions speculating; a causal gather cannot admit a speculating
        session's tree row. With both flags on every kind fuses, so every
        open session counts."""
        total = len(self._sessions)
        if not members or (self.mixed_batch and self.spec_batch):
            return total
        speculating = sum(
            1 for s in self._sessions.values() if s.speculating
        )
        if all(m.key[0] == "tree" for m in members):
            return speculating
        if self.spec_batch:
            return total - speculating
        return total

    def _ragged_compat(self, members: list, cand) -> bool:
        """The ComputeQueue group-membership predicate of the ragged
        dispatch. Mixable kinds follow the flags: decode steps ("decode1")
        and prefill chunks ("chunkm") with mixed_batch, tree-verify rows
        ("tree") with spec_batch, all three cross-kind when both are on.
        Members must agree on layers, adapter and dtype; a group holds at
        most ONE chunk and at most max_batch other members (the chunk
        rides the +1 group slot). Any other kind coalesces by exact key."""
        mixable = set()
        if self.mixed_batch:
            mixable |= {"decode1", "chunkm"}
        if self.spec_batch:
            mixable.add("tree")
        keys = [m.key for m in members]
        if cand.key[0] not in mixable or keys[0][0] not in mixable:
            return cand.key == keys[0]
        if any(k[1:4] != cand.key[1:4] for k in keys):
            return False
        kinds = [k[0] for k in keys]
        if cand.key[0] == "chunkm":
            return "chunkm" not in kinds
        return sum(1 for k in kinds if k != "chunkm") < self.max_batch

    def _compute_ragged_group(self, members: list) -> list:
        """Runs on the compute thread: ONE group of decode steps, tree-verify
        steps and at most one prefill chunk, as the compat predicate
        admitted them. Returns one outcome per member, as
        _compute_step_group does.

        Members whose KV is gone fail alone; a member with an unsettled
        prefix adoption (a chunk stream's first chunk, or a decode or tree
        step) takes its kind's solo path. A chunk-free, tree-free group
        is a merged decode group; a lone chunk or a lone tree runs solo;
        everything else runs as ONE ragged span dispatch via
        executor.ragged_group, replayed per kind if the fused dispatch
        fails."""
        results: list = [None] * len(members)
        decode_idx: list[int] = []
        tree_idx: list[int] = []
        chunk_idx: list[int] = []
        for i, m in enumerate(members):
            if not isinstance(m, (_BatchMember, _ChunkMember, _TreeMember)):
                raise TypeError(
                    f"ragged group member of kind {type(m).__name__}"
                )
            if not self.manager.epoch_valid(m.handle):
                results[i] = SessionKVLost("session cache lost: replay")
            elif isinstance(m, _ChunkMember):
                if m.first and self.manager.has_adopted(m.handle):
                    # the adoption settle mutates the table mid-group: the
                    # solo chunk path owns that side effect
                    results[i] = self._solo_chunk_step(m)
                else:
                    chunk_idx.append(i)
            elif (not m.session.adoption_settled
                  and self.manager.has_adopted(m.handle)):
                # the unsettled-adoption carve-out of _compute_step_group
                results[i] = (
                    self._solo_tree_step(m) if isinstance(m, _TreeMember)
                    else self._solo_member_step(m)
                )
            elif isinstance(m, _TreeMember):
                tree_idx.append(i)
            else:
                decode_idx.append(i)
        if not chunk_idx and not tree_idx:
            outs = self._compute_step_group([members[i] for i in decode_idx])
            order = decode_idx
        elif not decode_idx and not tree_idx:
            outs = [self._solo_chunk_step(members[chunk_idx[0]])]
            order = chunk_idx
        elif len(tree_idx) == 1 and not decode_idx and not chunk_idx:
            outs = [self._solo_tree_step(members[tree_idx[0]])]
            order = tree_idx
        else:
            # member-major row order: decodes, then trees, then the chunk
            # LAST
            order = decode_idx + tree_idx + chunk_idx
            group = [members[i] for i in order]
            try:
                outs = self._dispatch_ragged(group)
            except Exception as e:
                logger.warning(
                    "ragged dispatch of %d decodes + %d trees + %d chunks "
                    "failed (%r); replaying solo",
                    len(decode_idx), len(tree_idx), len(chunk_idx), e,
                )
                outs = [
                    self._solo_chunk_step(m) if isinstance(m, _ChunkMember)
                    else self._solo_tree_step(m)
                    if isinstance(m, _TreeMember)
                    else self._solo_member_step(m)
                    for m in group
                ]
        for i, out in zip(order, outs):
            results[i] = out
        return results

    def _solo_chunk_step(self, m: _ChunkMember):
        try:
            return self._compute_prefill_chunk(
                m.session, m.handle, m.hidden, m.last, m.first,
                m.prefix_skip,
            )
        except Exception as e:
            return e

    def _dispatch_ragged(self, group: list) -> list:
        """ONE ragged span dispatch for any admitted mix of decode steps,
        tree-verify steps and at most one prefill chunk (group[-1] when
        present). Every member's KV goes in speculatively and commit or
        rollback stays PER KIND:

        - decode members commit after the dispatch succeeds and roll back
          to their committed state on failure;
        - the chunk commits only on its stream's LAST chunk and is
          TRUNCATED to its pre-dispatch length on failure (a rollback
          would also discard the stream's earlier, still-wanted chunks);
        - tree members never commit here: on failure each is truncated to
          its pre-dispatch length and replays solo; on success the
          surviving slots settle when the session's next accept arrives."""
        t0 = clock.perf_counter()
        now = clock.monotonic()
        for m in group:
            m.session.last_step_at = now
        chunk = group[-1] if isinstance(group[-1], _ChunkMember) else None
        decodes = [m for m in group if isinstance(m, _BatchMember)]
        trees = [m for m in group if isinstance(m, _TreeMember)]
        # pre-dispatch speculative lengths: the truncate targets on failure
        snaps = [
            (m, [int(x) for x in self.manager.context_lens(m.handle)])
            for m in ([chunk] if chunk is not None else []) + trees
        ]
        try:
            out, _combined = self.executor.ragged_group(
                [m.handle for m in group], [m.hidden for m in group],
                tree_masks=[
                    m.tree_mask if isinstance(m, _TreeMember) else None
                    for m in group
                ],
                depths_list=[
                    m.depths if isinstance(m, _TreeMember) else None
                    for m in group
                ],
                layers=group[0].session.layers,
            )
        except Exception:
            for m, snap in snaps:
                if self.manager.epoch_valid(m.handle):
                    self.manager.truncate_speculative(m.handle, snap)
            for m in decodes:
                if self.manager.epoch_valid(m.handle):
                    self.manager.rollback(m.handle)
            raise
        for m in decodes:
            self.manager.commit(m.handle)
        if chunk is not None and chunk.last:
            self.manager.commit(chunk.handle)
        dt_ms = (clock.perf_counter() - t0) * 1000.0
        ntok = sum(
            m.handle.batch_size * int(m.hidden.shape[1]) for m in group
        )
        self.ragged_group_dispatches += 1
        kinds = bool(decodes) + bool(trees) + (chunk is not None)
        if kinds > 1:
            self.ragged_cross_kind_dispatches += 1
        if chunk is not None:
            self.mixed_dispatches += 1
            self.mixed_tokens += ntok
            # the others ran inside a mid-stream prefill's dispatch
            self.decode_steps_interleaved += len(group) - 1
        elif self._chunking_sessions:
            self.decode_steps_interleaved += len(group)
        if trees:
            self.tree_group_dispatches += 1
            self.tree_group_members += len(trees)
        self.step_dispatches += 1
        self.step_tokens += ntok
        # slice the member-major token-packed [R, D] result back out:
        # decode members get [b, 1, D], trees and the chunk [b, t, D]
        outs = []
        off = 0
        for m in group:
            b = m.handle.batch_size
            t = int(m.hidden.shape[1])
            outs.append((out[off:off + b * t].reshape(b, t, -1), dt_ms))
            off += b * t
        return outs

    # ------------------------------------------------- mid-chain pruning
    def _prune_tree(self, out: torch.Tensor, prune: dict):
        """Per-row keep indices from the MidLMHead over this span's output
        hidden; None if no pruner head is available (the client then
        verifies the full tree)."""
        mgr = self._ensure_pruner(float(prune.get("threshold", 0.05)))
        if mgr is None:
            return None
        from bloombee_tpu_torch.spec.tree import DraftTree

        tokens = np.asarray(prune["tokens"], dtype=np.int64)  # [B, T]
        parents = np.asarray(prune["parents"], dtype=np.int32)
        max_keep = int(prune.get("max_keep", tokens.shape[1]))
        mgr._pruner.max_keep = max_keep
        bsz, t = tokens.shape
        # one batched head call for every row's nodes
        all_probs = mgr._head.probs(
            out.float().reshape(bsz * t, -1)
        ).reshape(bsz, t, -1)
        rows = []
        for i in range(bsz):
            tree = DraftTree(tokens=tokens[i], parents=parents)
            # node 0 is the certain token: its "root" distribution is a
            # one-hot so it always survives the threshold
            root = np.zeros(all_probs.shape[2], dtype=np.float64)
            root[int(tokens[i, 0])] = 1.0
            rows.append(mgr._pruner.keep_indices(tree, all_probs[i], root))
        return np.stack(rows)

    async def _ensure_pruner_loaded(self) -> None:
        if self._pruner_manager is not None or self._pruner_unavailable:
            return
        if self._pruner_lock is None:
            self._pruner_lock = lockwatch.async_lock("server.pruner")
        async with self._pruner_lock:
            if self._pruner_manager is None and not self._pruner_unavailable:
                await asyncio.to_thread(self._load_pruner)

    def _load_pruner(self) -> None:
        """The MidLMHead: a saved head (BBTPU_PRUNER_CKPT) when present,
        else the checkpoint's final norm + lm_head. A server without a
        model_dir has no head: pruning degrades to the full tree."""
        if self.model_dir is None:
            self._pruner_unavailable = True
            return
        from bloombee_tpu_torch.spec.pruner import (
            MidHeadTrainer,
            PrunerManager,
        )

        dtype = self.executor.compute_dtype
        try:
            mgr = PrunerManager(method=env.get("BBTPU_PRUNER_METHOD"))
            ckpt = env.get("BBTPU_PRUNER_CKPT")
            if ckpt and os.path.exists(MidHeadTrainer.ckpt_path(ckpt)):
                try:
                    mgr._head = MidHeadTrainer.load(
                        ckpt, dtype=dtype, device=self.device
                    ).head
                except Exception as e:
                    # a torn checkpoint degrades to the checkpoint's head
                    logger.warning(
                        "pruner checkpoint unreadable (%s); fresh init", e
                    )
            if mgr._head is None:
                from bloombee_tpu_torch.models.checkpoint import (
                    load_client_params,
                )

                client = load_client_params(
                    self.model_dir, dtype=dtype, device=self.device
                )
                mgr.ensure_head(
                    client["lm_head"], client["norm"], self.spec.rms_norm_eps
                )
            self._pruner_manager = mgr
        except Exception as e:
            logger.warning("pruner unavailable: %s", e)
            self._pruner_unavailable = True

    def _ensure_pruner(self, threshold: float):
        if self._pruner_manager is None:
            return None
        self._pruner_manager.set_request_threshold(threshold)
        return self._pruner_manager

    def _fetch(self, out_dev) -> torch.Tensor:
        """The step's output on the host, in the wire dtype."""
        return self.executor.fetch(out_dev).to(self._wire_torch_dtype)

    async def _rpc_push(self, meta: dict, tensors) -> None:
        session = self._sessions.get(meta["session_id"])
        if meta.get("chain_ids") or meta.get("chain_error"):
            # chained decode_n control message for a waiting coordinator:
            # bypass push_inbox (its consumer, the session loop, is blocked
            # inside the coordinator waiting for exactly this)
            if session is None:
                logger.warning(
                    "chain message for unknown session %s dropped",
                    meta["session_id"],
                )
                return
            session.chain_inbox.put_nowait((meta, tensors))
            return
        if session is None:
            # a push can race ahead of the session's stream-open
            # (allocation may be waiting on cache budget): buffer it
            self._buffer_pending_push(meta, tensors)
            return
        session.push_inbox.put_nowait((meta, tensors))

    def _buffer_pending_push(self, meta: dict, tensors) -> None:
        now = clock.monotonic()
        sid = meta["session_id"]
        self._pending_pushes.setdefault(sid, []).append((now, meta, tensors))
        # drop stale buffers
        for key in list(self._pending_pushes):
            self._pending_pushes[key] = [
                e
                for e in self._pending_pushes[key]
                if now - e[0] < self.pending_push_ttl
            ]
            if not self._pending_pushes[key]:
                del self._pending_pushes[key]

    def _drain_pending_pushes(self, session: _Session) -> None:
        for _, meta, tensors in self._pending_pushes.pop(session.id, []):
            session.push_inbox.put_nowait((meta, tensors))

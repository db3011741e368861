"""Swarm data structures (a copy of bloombee_tpu/swarm/data.py: the same
ServerInfo fields and wire form, so port and JAX peers read each other's
registry records).

Mirrors the reference's data_structures.py:51-83 (ServerInfo is
the DHT-visible metrics surface) and RemoteSpanInfo (client routing unit).
"""

from __future__ import annotations

import dataclasses
import enum


class ServerState(enum.IntEnum):
    OFFLINE = 0
    JOINING = 1
    ONLINE = 2
    # still serving its in-flight sessions but about to exit: routing must
    # not start NEW sessions here (ordered above ONLINE so liveness filters
    # `state >= ONLINE` keep draining servers visible to their open clients)
    DRAINING = 3


@dataclasses.dataclass
class ServerInfo:
    state: ServerState = ServerState.ONLINE
    host: str = ""
    port: int = 0
    version: str = "0.1.0"
    throughput: float = 1.0  # overall rps used by routing / balancing
    network_rps: float | None = None
    inference_rps: float | None = None
    forward_rps: float | None = None
    cache_tokens_left: int | None = None
    next_pings: dict[str, float] | None = None  # server_id -> rtt seconds
    start_block: int | None = None
    end_block: int | None = None
    # dtype this server wants hidden states shipped in ("bf16" when it
    # computes in bf16; "f32" for exact-parity fp32 serving). Halves the
    # bytes of the latency-critical decode payload vs the round-1 fp32 wire.
    wire_dtype: str = "f32"
    # per-request LoRA adapters this server can apply (reference ServerInfo
    # adapters field, data_structures.py); routing filters on these when the
    # client sets ClientConfig.active_adapter
    adapters: list[str] | None = None
    # largest n accepted per decode_n RPC; the client clamps its chunk to
    # this BEFORE the first call (a larger chunk would be declined and
    # silently cost the whole fast path)
    decode_n_max: int | None = None
    # KV page size when this server runs the shared-prefix cache (clients
    # build page-aligned hash chains from it); 0 = no prefix cache, don't
    # probe. Unknown-field filtering in from_wire keeps old peers happy.
    page_size: int = 0
    # True when this server accepts kv_put page replication into its
    # prefix pool (prefix cache on, dense unquantized arena). Standby
    # selection requires it; old peers default to False via from_wire's
    # unknown-field filtering, so mixed swarms just never replicate.
    kv_repl: bool = False
    # live load snapshot for load-aware routing: sliding-window gauges the
    # server republishes every advert. Keys (all optional — adverts are
    # untrusted wire input, consumers must sanitize every field):
    #   ts (writer wall clock), delay_ms (server's own live queue-delay
    #   estimate), queue_depth, wait_ms/{p50,p95},
    #   prefill_wait_ms/decode_wait_ms (same shape, per class),
    #   mean_batch_width, chunk_streams, pages_free, active_sessions,
    #   shedding (admission controller past its high watermark).
    # Old peers drop the whole field via from_wire unknown-field
    # filtering; old adverts leave it None (routing then adds no load term).
    load: dict | None = None
    # True while this server is serving because it PROMOTED itself from a
    # standby (elastic control loop). Promoted replicas are the ones that
    # yield in promotion-storm resolution (lowest server_id keeps serving,
    # the rest demote) and the first to drain back when the span cools —
    # the span's primary server never demotes. Old peers drop the field on
    # the wire (from_wire filtering); default False = primary.
    promoted_standby: bool = False
    # True when this server stamps an out_digest (blake2b over the exact
    # span-output bytes it serialized) into every step reply — the
    # integrity layer's cheap in-flight-corruption fast path. Old peers
    # drop the field via from_wire filtering and default False, so clients
    # simply skip digest checks against them (audits still work).
    out_digest: bool = False
    # True when this server serves a compile-artifact store over
    # artifact_get (swarm-shared persistent compilation cache). JOINing
    # servers and standbys fetch their span's artifacts from covering
    # peers advertising this before falling back to local compile. Old
    # peers drop the field via from_wire filtering and default False, so
    # mixed swarms simply never trade artifacts.
    artifacts: bool = False

    def to_wire(self) -> dict:
        d = dataclasses.asdict(self)
        d["state"] = int(self.state)
        return d

    @classmethod
    def from_wire(cls, d: dict) -> "ServerInfo":
        d = dict(d)
        d["state"] = ServerState(d.get("state", 2))
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})


@dataclasses.dataclass
class ModuleInfo:
    """One block uid's view: which servers serve it."""

    uid: str
    servers: dict[str, ServerInfo]


@dataclasses.dataclass
class RemoteSpanInfo:
    """A contiguous block range on one server (routing unit,
    reference data_structures.py RemoteSpanInfo)."""

    peer_id: str
    start: int
    end: int
    server_info: ServerInfo

    @property
    def length(self) -> int:
        return self.end - self.start

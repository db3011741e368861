"""ClientConfig: one dataclass for every client-side knob (a copy of
bloombee_tpu/client/config.py with the same fields and, where the port
has the feature, the same defaults).

Reference client/config.py:19-42 (timeouts, retries/backoff, push-only
downstream decode, allowed/blocked servers), threaded through model ->
sequence manager -> sessions.

Fields asking for what the port does not have yet default to off, and a
truthy value raises ValueError naming the field and its ROADMAP item (the
loud refusal of the server's `REFUSED_STEP_KEYS`); no `BBTPU_*` switch is
declared for them. `prefix_cache`, `kv_repl_every` and `resume` default to
None, which defers to BBTPU_PREFIX_CACHE (off), BBTPU_REPL_EVERY (0) and
BBTPU_RESUME (on), as in the JAX package.
"""

from __future__ import annotations

import dataclasses

# field -> (what it asks for, ROADMAP Queue 1 item)
UNPORTED_FIELDS = {
    "active_adapter": ("per-request LoRA adapters", 16),
    "audit_p": ("cross-replica activation audits", 19),
}


@dataclasses.dataclass
class ClientConfig:
    # transport topology (reference use_server_to_server +
    # push_only_downstream_decode)
    use_push: bool = True
    # within-stage micro-batch count; "auto" sizes chunks to the pipeline
    # depth; None -> BBTPU_MICROBATCH env default
    microbatch: int | str | None = None
    # per-step failure handling: each failure strike doubles the ban from
    # ban_timeout up to ban_max (with jitter); a success resets it
    max_retries: int = 3
    step_timeout: float = 120.0
    ban_timeout: float = 15.0
    ban_max: float = 120.0
    # routing view refresh (reference _SequenceManagerUpdateThread period)
    update_period: float = 5.0
    # server filters (reference allowed_servers / blocked_servers)
    allowed_servers: list[str] | None = None
    blocked_servers: list[str] | None = None
    # vocab-chunked LM head for low-memory clients (reference
    # LMHead.chunked_forward, client/lm_head.py:50-76)
    use_chunked_head: bool = False
    chunked_head_step: int = 16384
    # not ported (UNPORTED_FIELDS): must stay off
    active_adapter: str | None = None
    # opt-in server-side multi-step decode: a greedy generate over a route
    # covering the whole model asks span 0 for `server_decode_chunk`
    # tokens per RPC (fused or stepped on one span, chained over several);
    # servers that cannot decline and the client goes on per step
    server_decode: bool = False
    server_decode_chunk: int = 32
    # shared-prefix KV cache: probe servers' page pools before the first
    # prefill and ship only the uncached suffix. None -> BBTPU_PREFIX_CACHE;
    # servers with the cache off report zero matches
    prefix_cache: bool | None = None
    # standby KV replication interval in sealed pages: every N newly sealed
    # pages each span's server ships them (kv_put) into a same-span
    # standby's prefix pool, so failover replays at most one interval plus
    # the unsealed tail. Needs prefix_cache; 0 disables; None ->
    # BBTPU_REPL_EVERY
    kv_repl_every: int | None = None
    # load-aware routing: add each server's predicted queue delay (from its
    # live load advert) to the Dijkstra edge cost
    load_aware_routing: bool = True
    # overload penalty class (shorter than fault bans — a shedding server
    # is healthy, just hot)
    overload_timeout: float = 2.0
    overload_max: float = 15.0
    # `overloaded` sheds one step tolerates before surfacing the error
    # (separate from max_retries)
    overload_retries: int = 10
    # fair-share identity reported to servers' admission controllers; None
    # uses one id per client process
    client_id: str | None = None
    # reconnect-resume: after a stream failure, re-attach each span's
    # lease-parked session and retransmit the failed step under its
    # original id (at-most-once server-side, zero replay); declined
    # resumes fall back to reroute + replay. None -> BBTPU_RESUME
    resume: bool | None = None
    # one span's resume handshake budget (the lease clock is running)
    resume_timeout: float = 10.0
    # wire keepalive interval for the client side of every span connection;
    # None -> BBTPU_KEEPALIVE_S env, 0 disables
    keepalive_s: float | None = None
    # integrity layer: every received span output passes the inline sanity
    # gate plus out_digest verification against digest-advertising
    # servers; rejects strike the peer and heal by reroute + replay.
    # None -> BBTPU_INTEGRITY env
    integrity: bool | None = None
    # not ported (UNPORTED_FIELDS): must stay off
    audit_p: float | None = 0.0
    # quarantine penalty class (integrity convictions)
    quarantine_timeout: float = 600.0
    quarantine_max: float = 3600.0
    integrity_strike_limit: int = 2

    def __post_init__(self):
        self.validate()

    def validate(self) -> None:
        """Raise ValueError if a field asks for what the port lacks."""
        for name, (what, item) in UNPORTED_FIELDS.items():
            if getattr(self, name):
                raise ValueError(
                    f"ClientConfig.{name}={getattr(self, name)!r} asks for "
                    f"{what}, which the port does not have yet (ROADMAP "
                    f"Queue 1 item {item})"
                )

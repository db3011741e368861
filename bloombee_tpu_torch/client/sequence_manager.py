"""RemoteSequenceManager: the client routing brain (a copy of
bloombee_tpu/client/sequence_manager.py over the port's swarm modules).

Reference client/routing/sequence_manager.py:66-599: keeps a fresh view of
which server spans cover which blocks, builds a chain of spans covering
[0, num_blocks) by shortest-path search ("min_latency": Dijkstra over block
boundaries with per-span compute cost + per-hop network cost, reference
`_build_inference_graph` :235-296), or length-weighted random choice
("max_throughput", :320-342), and bans failing peers with backoff
(:412-429).
"""

from __future__ import annotations

import dataclasses
import heapq
import itertools
import logging
import random

from bloombee_tpu_torch.swarm.data import RemoteSpanInfo, ServerState
from bloombee_tpu_torch.swarm.load import predicted_queue_delay_s
from bloombee_tpu_torch.swarm.ping import DEFAULT_RTT_S, PingAggregator
from bloombee_tpu_torch.swarm.spans import compute_spans
from bloombee_tpu_torch.utils import clock, ledger

logger = logging.getLogger(__name__)

DEFAULT_HOP_COST_S = DEFAULT_RTT_S  # until a peer has been measured
CACHE_MISSING_PENALTY_S = 10.0  # reference: +10s if cache won't fit


class MissingBlocksError(RuntimeError):
    def __init__(self, blocks):
        super().__init__(
            f"no online server covers block(s) {blocks}; swarm incomplete"
        )
        self.blocks = blocks


@dataclasses.dataclass
class _BanState:
    """Per-peer failure bookkeeping: exponential backoff with jitter plus a
    half-open probe. Each strike doubles the ban (bounded by ban_max);
    once the ban expires the FIRST route that would use the peer becomes
    the trial (probing=True) and other routes keep avoiding it until the
    trial either succeeds (note_peer_ok resets everything) or fails
    (re-banned with the next doubling)."""

    strikes: int = 0
    banned_until: float = 0.0
    probing: bool = False
    probe_until: float = 0.0  # trial lease; expires so an unused or
    # wedged probe route cannot exclude the peer forever


class RemoteSequenceManager:
    def __init__(
        self,
        registry,
        model_uid: str,
        num_blocks: int,
        update_period: float = 5.0,
        ban_timeout: float = 15.0,
        ban_max: float = 120.0,
        rng: random.Random | None = None,
        allowed_servers: list[str] | None = None,
        blocked_servers: list[str] | None = None,
        active_adapter: str | None = None,
        load_aware: bool = True,  # add the predicted-queue-delay term
        # from live load adverts to Dijkstra edge costs
        overload_timeout: float = 2.0,  # base avoid-backoff after an
        # overloaded shed — a distinct, much shorter penalty class than
        # fault bans (the server is healthy, just busy right now)
        overload_max: float = 15.0,  # overload-avoid cap (faults: ban_max)
        quarantine_timeout: float = 600.0,  # base exile after an
        # integrity conviction — a peer that LIED (vs crashed) gets the
        # longest penalty class: minutes, not seconds
        quarantine_max: float = 3600.0,
        integrity_strike_limit: int = 2,  # sanity-gate rejects before a
        # peer tips from "suspicious" into quarantine
    ):
        self.registry = registry
        self.model_uid = model_uid
        self.num_blocks = num_blocks
        self.update_period = update_period
        self.ban_timeout = ban_timeout  # base (first-strike) backoff
        self.ban_max = ban_max
        self.probe_timeout = 30.0  # half-open trial lease
        self.load_aware = load_aware
        self.overload_timeout = overload_timeout
        self.overload_max = overload_max
        self.overload_probe_timeout = 10.0  # half-open lease, hot peers
        self.allowed_servers = (
            set(allowed_servers) if allowed_servers else None
        )
        self.blocked_servers = set(blocked_servers or ())
        self.active_adapter = active_adapter
        self.spans: dict[str, RemoteSpanInfo] = {}
        # dedicated warm standbys (JOINING adverts): invisible to routing,
        # visible to pick_standby as replication/failover targets
        self.standby_spans: dict[str, RemoteSpanInfo] = {}
        self._bans: dict[str, _BanState] = {}
        # overload penalty class: same half-open state machine as fault
        # bans, but a separate map with shorter base/cap so "busy" never
        # escalates into the minutes-long exile reserved for failures
        self._hot: dict[str, _BanState] = {}
        # integrity penalty class (Byzantine, not crash, faults): same
        # half-open machine, much longer base/cap, and — unlike bans —
        # escalation survives a successful probe (a liar that behaves for
        # one probe step re-enters at the doubled backoff next conviction)
        self.quarantine_timeout = quarantine_timeout
        self.quarantine_max = quarantine_max
        self.quarantine_probe_timeout = 60.0
        self.integrity_strike_limit = integrity_strike_limit
        self._quarantine: dict[str, _BanState] = {}
        self._quarantine_history: dict[str, int] = {}  # strikes survive readmit
        self._integrity_strikes: dict[str, int] = {}
        self.peers_quarantined = 0  # counter: quarantine events (bench/health)
        self._last_update = 0.0
        self._rng = rng or random.Random()
        # measured client->server RTTs (reference ping.py PingAggregator);
        # server->server edges come from announced next_pings
        self.pinger = PingAggregator()

    # ---------------------------------------------------------------- updates
    async def update(self, force: bool = False) -> None:
        now = clock.monotonic()
        if not force and now - self._last_update < self.update_period:
            return
        infos = await self.registry.get_module_infos(
            self.model_uid, range(self.num_blocks)
        )
        self.spans = compute_spans(infos)
        # JOINING servers are warm standbys (elastic self-healing): kept
        # OUT of self.spans so no route ever lands on one, but tracked so
        # pick_standby can ship them replicated KV — when one promotes,
        # its next advert is ONLINE and it enters self.spans normally
        self.standby_spans = {
            pid: s
            for pid, s in compute_spans(
                infos, min_state=ServerState.JOINING
            ).items()
            if s.server_info.state == ServerState.JOINING
        }
        self._last_update = now
        self._prune_bans()
        banned_now = {
            p for p, st in self._bans.items()
            if st.banned_until > clock.monotonic()
        }
        to_ping = [
            (s.peer_id, s.server_info.host, s.server_info.port)
            for s in self.spans.values()
            if s.peer_id not in banned_now
            and self.pinger.needs_measure(s.peer_id)
        ]
        if to_ping:
            # timeboxed: recovery and session-open must not stall on a dead
            # peer (its failed ping would only record FAILED_RTT_S anyway)
            await self.pinger.measure_many(to_ping, overall_timeout=2.0)

    # ---------------------------------------------------------------- banning
    def ban_peer(self, peer_id: str) -> None:
        """Failure strike: exponential backoff with jitter (reference
        on_request_failure's flat ban_timeout, hardened). Each strike
        doubles the ban up to ban_max; jitter (0.75-1.25x, seeded rng)
        de-synchronizes many clients re-probing a recovered server at
        once. The peer's measured RTT is dropped so a later re-admission
        re-measures instead of routing on pre-failure latency."""
        state = self._bans.setdefault(peer_id, _BanState())
        state.probing = False
        state.strikes += 1
        backoff = min(
            self.ban_timeout * (2.0 ** (state.strikes - 1)), self.ban_max
        )
        backoff *= 0.75 + 0.5 * self._rng.random()
        state.banned_until = clock.monotonic() + backoff
        self.pinger.forget(peer_id)
        ledger.recovery("client.ban")
        logger.info(
            "banned peer %s for %.1fs (strike %d)", peer_id, backoff,
            state.strikes,
        )

    def note_peer_overloaded(
        self, peer_id: str, retry_after_s: float | None = None
    ) -> None:
        """Overload strike: the peer shed our work with a retriable
        `overloaded` — it is healthy, just busy, so it gets the SHORT
        penalty class (overload_timeout base / overload_max cap), never a
        fault ban. The server's retry_after hint floors the backoff; the
        measured RTT is kept (the peer is alive and its latency is
        current)."""
        state = self._hot.setdefault(peer_id, _BanState())
        state.probing = False
        state.strikes += 1
        backoff = min(
            self.overload_timeout * (2.0 ** (state.strikes - 1)),
            self.overload_max,
        )
        if retry_after_s is not None and retry_after_s > 0:
            backoff = max(backoff, min(retry_after_s, self.overload_max))
        backoff *= 0.75 + 0.5 * self._rng.random()
        state.banned_until = clock.monotonic() + backoff
        ledger.recovery("client.overload_backoff")
        logger.info(
            "avoiding overloaded peer %s for %.1fs (strike %d)", peer_id,
            backoff, state.strikes,
        )

    def note_integrity_strike(self, peer_id: str) -> bool:
        """An integrity check (sanity gate, digest, audit suspicion)
        rejected this peer's output. Strikes accumulate for the life of
        the session — ordinary successes do NOT clear them, because a lie
        is evidence of Byzantine behavior, not a transient fault. Returns
        True when the strike tipped the peer into quarantine."""
        n = self._integrity_strikes.get(peer_id, 0) + 1
        self._integrity_strikes[peer_id] = n
        logger.warning(
            "integrity strike %d/%d against peer %s", n,
            self.integrity_strike_limit, peer_id,
        )
        if n >= self.integrity_strike_limit:
            self.quarantine_peer(peer_id)
            return True
        return False

    def quarantine_peer(self, peer_id: str) -> None:
        """Integrity conviction: exile the peer with the longest penalty
        class. Same exponential backoff + half-open probe machinery as
        fault bans, but escalation is restored from `_quarantine_history`
        so a readmitted liar that re-offends starts from the doubled
        backoff, not from scratch. The accumulated sanity strikes reset:
        after readmission, fresh evidence is required to re-convict."""
        state = self._quarantine.setdefault(peer_id, _BanState())
        state.strikes = max(
            state.strikes, self._quarantine_history.get(peer_id, 0)
        )
        state.probing = False
        state.strikes += 1
        self._quarantine_history[peer_id] = state.strikes
        backoff = min(
            self.quarantine_timeout * (2.0 ** (state.strikes - 1)),
            self.quarantine_max,
        )
        backoff *= 0.75 + 0.5 * self._rng.random()
        state.banned_until = clock.monotonic() + backoff
        self._integrity_strikes.pop(peer_id, None)
        self.peers_quarantined += 1
        ledger.recovery("client.quarantine")
        self.pinger.forget(peer_id)
        logger.warning(
            "QUARANTINED peer %s for %.0fs (conviction %d): excluded from "
            "routing and standby selection", peer_id, backoff, state.strikes,
        )

    def note_peer_ok(self, peer_id: str) -> None:
        """A request through this peer succeeded: the half-open trial (or
        any lingering strike/overload history) is cleared so the next
        failure starts from the base backoff again. A quarantined peer
        that passes its probe is readmitted, but its escalation history
        survives in `_quarantine_history` (and its sanity strikes were
        already reset at conviction) — liars don't earn a clean slate."""
        if self._bans.pop(peer_id, None) is not None:
            logger.info("peer %s recovered; ban history reset", peer_id)
        self._hot.pop(peer_id, None)
        if self._quarantine.pop(peer_id, None) is not None:
            logger.info(
                "quarantined peer %s passed its half-open probe; readmitted "
                "(escalation history retained)", peer_id,
            )

    def _ban_excludes(self, peer_id: str, now: float) -> bool:
        """True when bans, overload-avoidance OR quarantine keep this peer
        out of routing right now. An expired entry admits exactly ONE
        route as the half-open probe; other routes keep avoiding the peer
        until the probe resolves."""
        return self._state_excludes(
            self._bans, peer_id, now, self.probe_timeout, "banned"
        ) or self._state_excludes(
            self._hot, peer_id, now, self.overload_probe_timeout,
            "overloaded",
        ) or self._integrity_excludes(peer_id, now)

    def _integrity_excludes(self, peer_id: str, now: float) -> bool:
        """Quarantine exclusion (half-open like the other classes, with
        the long probe lease). Checked in EVERY pool construction — normal
        routing, the degraded standby pool, and the warm-standby list —
        because a lying peer must never be handed work or replicated KV,
        however desperate the swarm is."""
        return self._state_excludes(
            self._quarantine, peer_id, now, self.quarantine_probe_timeout,
            "quarantined",
        )

    @staticmethod
    def _state_excludes(
        states: dict[str, _BanState], peer_id: str, now: float,
        probe_timeout: float, kind: str,
    ) -> bool:
        state = states.get(peer_id)
        if state is None:
            return False
        if now < state.banned_until:
            return True
        if state.probing and now < state.probe_until:
            return True  # a trial is already in flight elsewhere
        state.probing = True  # this route becomes (or renews) the trial
        state.probe_until = now + probe_timeout
        logger.info("half-open probe: trying %s peer %s", kind, peer_id)
        return False

    def _overload_active(self, peer_id: str, now: float | None = None) -> bool:
        """True while the peer is inside its overload-avoid backoff (no
        probe side effects — a read-only check for standby selection)."""
        state = self._hot.get(peer_id)
        if state is None:
            return False
        if now is None:
            now = clock.monotonic()
        return now < state.banned_until or (
            state.probing and now < state.probe_until
        )

    def _prune_bans(self) -> None:
        """Drop entries that can no longer matter: peers that left the
        swarm view, and long-expired bans whose peer was never re-routed
        (without this the maps grow monotonically with churn)."""
        now = clock.monotonic()
        if self.spans:
            for d in (self._quarantine_history, self._integrity_strikes):
                for pid in list(d):
                    if pid not in self.spans:
                        del d[pid]
        for states, cap in ((self._bans, self.ban_max),
                            (self._hot, self.overload_max),
                            (self._quarantine, self.quarantine_max)):
            for pid in list(states):
                state = states[pid]
                gone = self.spans and pid not in self.spans
                long_expired = (
                    not state.probing
                    and now > state.banned_until + 4 * cap
                )
                if gone or long_expired:
                    del states[pid]

    def _active_spans(
        self, overload_excludes: bool = True
    ) -> list[RemoteSpanInfo]:
        # overload_excludes=False keeps hot (but not fault-banned) peers in
        # the pool: pick_standby prefers cool standbys itself but must be
        # able to degrade to a hot one when nothing else qualifies.
        now = clock.monotonic()
        return [
            s
            for s in self.spans.values()
            if s.server_info.state != ServerState.DRAINING
            and not (
                self._ban_excludes(s.peer_id, now)
                if overload_excludes
                else (
                    self._state_excludes(
                        self._bans, s.peer_id, now, self.probe_timeout,
                        "banned",
                    )
                    or self._integrity_excludes(s.peer_id, now)
                )
            )
            and s.peer_id not in self.blocked_servers
            and (
                self.allowed_servers is None
                or s.peer_id in self.allowed_servers
            )
            and (
                self.active_adapter is None
                or self.active_adapter in (s.server_info.adapters or ())
            )
        ]

    # ---------------------------------------------------------------- routing
    def make_sequence(
        self,
        start: int = 0,
        end: int | None = None,
        mode: str = "min_latency",
        cache_tokens_needed: int | None = None,
        relay: bool = False,  # True: hops go server->client->server
        prefer: set[str] | None = None,  # peers to bias toward (recovery
        # hint: standbys already holding this session's replicated pages)
    ) -> list[RemoteSpanInfo]:
        end = self.num_blocks if end is None else end
        spans = self._active_spans()
        if mode == "max_throughput":
            return self._random_route(spans, start, end)
        return self._dijkstra_route(
            spans, start, end, cache_tokens_needed, relay, prefer=prefer
        )

    def pick_standby(
        self, span: RemoteSpanInfo, exclude: set[str] | None = None
    ) -> RemoteSpanInfo | None:
        """A replication standby for `span`: an active peer serving EXACTLY
        the same block range (replicated pages carry the full span's layers
        at the server's page geometry, so only an identical span + page
        size can install them), advertising kv_repl support, and not on
        the session's current route. Highest-throughput candidate wins;
        None when the swarm has no eligible alternative (the caller
        degrades to plain full-replay recovery)."""
        info = span.server_info
        now = clock.monotonic()
        pool = list(self._active_spans(overload_excludes=False))
        # dedicated warm standbys (JOINING adverts) qualify too — they are
        # what the elastic control loop promotes on failover, so they are
        # exactly where this session's pages should be waiting
        pool += [
            s for s in self.standby_spans.values()
            if not self._state_excludes(
                self._bans, s.peer_id, now, self.probe_timeout, "banned"
            )
            and not self._integrity_excludes(s.peer_id, now)
            and s.peer_id not in self.blocked_servers
            and (
                self.allowed_servers is None
                or s.peer_id in self.allowed_servers
            )
        ]
        cands = [
            s for s in pool
            if s.peer_id != span.peer_id
            and s.peer_id not in (exclude or ())
            and s.server_info.kv_repl
            and s.server_info.start_block == info.start_block
            and s.server_info.end_block == info.end_block
            and s.server_info.page_size == info.page_size
        ]
        # avoid HOT standbys: replicating to (or failing over onto) a
        # server already past its watermark just moves the overload.
        # Recently-shed peers are filtered outright (unless nothing else
        # qualifies); among the rest, advertised load discounts throughput.
        cool = [s for s in cands if not self._overload_active(s.peer_id)]
        if cool:
            cands = cool
        if not cands:
            return None
        return max(
            cands,
            key=lambda s: (
                s.server_info.inference_rps
                or s.server_info.throughput or 0.0
            ) / (1.0 + predicted_queue_delay_s(s.server_info)),
        )

    def _compute_cost(
        self, span: RemoteSpanInfo, blocks: int, cache_tokens_needed
    ) -> float:
        rps = span.server_info.inference_rps or span.server_info.throughput or 1.0
        cost = blocks / max(rps, 1e-6)
        left = span.server_info.cache_tokens_left
        if (
            cache_tokens_needed is not None
            and left is not None
            and left < cache_tokens_needed
        ):
            cost += CACHE_MISSING_PENALTY_S
        if self.load_aware:
            # live-advert term: predicted queue delay ADDS to the cost
            # (bounded, sanitized, staleness-discounted — see
            # predicted_queue_delay_s), so Dijkstra's positivity invariant
            # holds for arbitrary advert garbage
            cost += predicted_queue_delay_s(span.server_info)
        return cost

    def _hop_cost(
        self, prev_peer: str | None, span: RemoteSpanInfo, relay: bool
    ) -> float:
        """Network edge cost: client->server from measured RTTs; server->
        server from the previous server's announced next_pings (reference
        _build_inference_graph, sequence_manager.py:235-296), falling back
        to the client's measurement of the target. Relay sessions
        (use_push=False) route every hop through the client, so announced
        server->server RTTs don't apply — the client's own RTT does."""
        if prev_peer is not None and not relay:
            prev = self.spans.get(prev_peer)
            next_pings = (
                prev.server_info.next_pings if prev is not None else None
            ) or {}
            if span.peer_id in next_pings:
                return float(next_pings[span.peer_id])
        return self.pinger.get(span.peer_id, DEFAULT_HOP_COST_S)

    def _dijkstra_route(
        self, spans, start: int, end: int, cache_tokens_needed,
        relay: bool = False, prefer: set[str] | None = None,
    ) -> list[RemoteSpanInfo]:
        # states = (block boundary, arriving peer); a span [s, e) contributes
        # edges (b, p) -> (e, span.peer) for every b in [s, e) (a server can
        # serve a suffix of its span), costed with the real measured RTT for
        # the p -> span hop plus the span's compute time
        spans_by_block: dict[int, list[RemoteSpanInfo]] = {}
        for span in spans:
            s, e = max(span.start, start), min(span.end, end)
            for b in range(s, e):
                spans_by_block.setdefault(b, []).append(span)
        tie = itertools.count()  # heap tiebreaker (peer ids aren't ordered)
        src = (start, None)
        dist: dict[tuple, float] = {src: 0.0}
        prev: dict[tuple, tuple[tuple, RemoteSpanInfo]] = {}
        heap: list = [(0.0, next(tie), start, None)]
        goal: tuple | None = None
        while heap:
            d, _, node_b, node_p = heapq.heappop(heap)
            state = (node_b, node_p)
            if node_b == end:
                goal = state
                break
            if d > dist.get(state, float("inf")):
                continue
            for span in spans_by_block.get(node_b, []):
                e = min(span.end, end)
                cost = self._hop_cost(node_p, span, relay) + self._compute_cost(
                    span, e - node_b, cache_tokens_needed
                )
                if prefer and span.peer_id in prefer:
                    # recovery hint: a standby holding this session's
                    # replicated KV saves an O(history) replay — worth far
                    # more than a latency edge. Scaling (not zeroing)
                    # keeps edge costs positive, so Dijkstra stays valid.
                    cost *= 0.05
                nxt = (e, span.peer_id)
                nd = d + cost
                if nd < dist.get(nxt, float("inf")):
                    dist[nxt] = nd
                    prev[nxt] = (state, span)
                    heapq.heappush(heap, (nd, next(tie), e, span.peer_id))
        if goal is None:
            if start == end:
                return []
            covered = {b for s in spans for b in range(s.start, s.end)}
            missing = [b for b in range(start, end) if b not in covered]
            raise MissingBlocksError(missing or list(range(start, end)))
        # walk back
        route: list[RemoteSpanInfo] = []
        state = goal
        while state != src:
            pstate, span = prev[state]
            route.append(
                RemoteSpanInfo(
                    span.peer_id, pstate[0], state[0], span.server_info
                )
            )
            state = pstate
        return list(reversed(route))

    def _random_route(self, spans, start: int, end: int):
        """Length-weighted random chaining (reference :320-342)."""
        route = []
        cur = start
        while cur < end:
            options = [s for s in spans if s.start <= cur < s.end]
            if not options:
                raise MissingBlocksError([cur])
            weights = [s.end - cur for s in options]
            chosen = self._rng.choices(options, weights=weights)[0]
            stop = min(chosen.end, end)
            route.append(
                RemoteSpanInfo(chosen.peer_id, cur, stop, chosen.server_info)
            )
            cur = stop
        return route

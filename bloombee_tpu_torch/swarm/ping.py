"""RTT measurement for routing (a copy of bloombee_tpu/swarm/ping.py;
reference utils/ping.py:59-100 PingAggregator).

EMA round-trip times per peer, measured by timing an `rpc_info` unary call.
Used on the client (client->server edges of the routing graph) and on
servers (next-hop pings announced in ServerInfo.next_pings, reference
server.py:1000-1007, so the client's Dijkstra can cost server->server hops
with real measurements instead of a constant).
"""

from __future__ import annotations

import asyncio

from bloombee_tpu_torch.utils import clock

DEFAULT_RTT_S = 0.01  # used until a peer has been measured
FAILED_RTT_S = 5.0  # unreachable peers look very expensive, not infinite


class PingAggregator:
    def __init__(self, alpha: float = 0.3, stale_after: float = 30.0):
        self.alpha = alpha
        self.stale_after = stale_after
        self._rtt: dict[str, float] = {}
        self._measured_at: dict[str, float] = {}
        # NTP-style peer clock offsets (reference handler.py:498-575): lets
        # timing tables attribute ONE-WAY wire time across machines
        self._clock_offset: dict[str, float] = {}

    def clock_offset(self, peer_id: str) -> float | None:
        """Estimated peer_clock - local_clock in seconds (None until the
        peer has replied with a timestamp)."""
        return self._clock_offset.get(peer_id)

    def record(self, peer_id: str, rtt: float) -> None:
        old = self._rtt.get(peer_id)
        self._rtt[peer_id] = (
            rtt if old is None else old * (1 - self.alpha) + rtt * self.alpha
        )
        self._measured_at[peer_id] = clock.monotonic()

    def get(self, peer_id: str, default: float = DEFAULT_RTT_S) -> float:
        return self._rtt.get(peer_id, default)

    def forget(self, peer_id: str) -> None:
        """Drop a peer's RTT (and clock offset) so its next admission to
        routing re-measures. Called when a peer is banned: the pre-failure
        EMA describes a server that no longer exists in that form — a
        recovered peer routing on stale low latency would soak up traffic
        it can't serve (and a stale FAILED_RTT_S would shun a healthy one)."""
        self._rtt.pop(peer_id, None)
        self._measured_at.pop(peer_id, None)
        self._clock_offset.pop(peer_id, None)

    def needs_measure(self, peer_id: str) -> bool:
        at = self._measured_at.get(peer_id)
        return at is None or clock.monotonic() - at > self.stale_after

    def to_wire(self) -> dict[str, float]:
        """Fresh entries only; departed peers (never re-measured) are evicted
        so long-lived servers' announce payloads don't grow with churn."""
        cutoff = clock.monotonic() - 4 * self.stale_after
        for pid in [
            p for p, at in self._measured_at.items() if at < cutoff
        ]:
            self._rtt.pop(pid, None)
            self._measured_at.pop(pid, None)
            self._clock_offset.pop(pid, None)
        return dict(self._rtt)

    async def measure(
        self, peer_id: str, host: str, port: int, timeout: float = 2.0
    ) -> float:
        """One rpc_info round trip on a fresh connection; EMA-recorded.
        Unreachable peers record FAILED_RTT_S (routing avoids, bans expire)."""
        from bloombee_tpu_torch.wire.rpc import connect

        t0 = clock.perf_counter()
        try:
            conn = await asyncio.wait_for(connect(host, port), timeout)
            try:
                # stamp AFTER connect: the NTP midpoint must halve only the
                # rpc round trip, not the TCP handshake
                t_call = clock.perf_counter()
                t_call_wall = clock.now()
                meta, _ = await asyncio.wait_for(
                    conn.call("rpc_info", {}, []), timeout
                )
                call_rtt = clock.perf_counter() - t_call
            finally:
                await conn.close()
            rtt = clock.perf_counter() - t0
            server_time = meta.get("server_time")
            if server_time is not None:
                self._clock_offset[peer_id] = float(server_time) - (
                    t_call_wall + call_rtt / 2.0
                )
        except Exception:
            rtt = FAILED_RTT_S
        self.record(peer_id, rtt)
        return rtt

    async def measure_many(
        self,
        peers: list[tuple[str, str, int]],
        timeout: float = 1.0,
        overall_timeout: float | None = 2.0,
    ) -> None:
        """Ping peers concurrently: [(peer_id, host, port)]. The whole batch
        is timeboxed — each completed measure records its own result, so a
        timeout keeps partial data and never blocks the caller long."""
        task = asyncio.gather(
            *(self.measure(pid, h, p, timeout) for pid, h, p in peers)
        )
        try:
            await asyncio.wait_for(task, overall_timeout)
        except asyncio.TimeoutError:
            pass

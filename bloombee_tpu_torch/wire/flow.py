"""Self-tuning concurrency limiter for server-to-server pushes (a copy of
bloombee_tpu/wire/flow.py).

Capability match for the reference's adaptive push concurrency
(the reference's server/handler.py:255-370): bound the number
of in-flight pushes per peer and adapt the bound from runtime signals only —
no operator knob. The control law is AIMD-flavored:

- repeated send failures  -> shrink (stability first),
- waiters queue while sends stay fast -> grow (sender-side pressure, the
  link has headroom),
- sends slow down while nobody waits  -> shrink (network backpressure;
  more concurrency would only deepen the TCP queue).

Signals are EWMA-smoothed and decisions are made every `decide_every`
completions so one outlier can't flap the limit.
"""

from __future__ import annotations

import asyncio
import logging
import time

logger = logging.getLogger(__name__)


class FlowLimiter:
    def __init__(
        self,
        name: str = "",
        initial: int = 4,
        lo: int = 1,
        hi: int = 16,
        alpha: float = 0.2,
        decide_every: int = 8,
        wait_up_ms: float = 4.0,
        send_ok_ms: float = 100.0,
        send_slow_ms: float = 150.0,
    ):
        self.name = name
        self.lo, self.hi = int(lo), int(hi)
        self.limit = min(self.hi, max(self.lo, int(initial)))
        self._alpha = alpha
        self._decide_every = max(1, decide_every)
        self._wait_up_ms = wait_up_ms
        self._send_ok_ms = send_ok_ms
        self._send_slow_ms = send_slow_ms
        self.in_flight = 0
        self._cond = asyncio.Condition()
        self.ewma_wait_ms = 0.0
        self.ewma_send_ms = 0.0
        self._completions = 0
        self._consecutive_failures = 0

    def _ewma(self, prev: float, sample: float) -> float:
        return sample if prev <= 0.0 else prev * (1 - self._alpha) + sample * self._alpha

    def slot(self) -> "_Slot":
        """One bounded in-flight operation: `async with limiter.slot(): ...`.
        Each slot carries its own send-start time — concurrent holders must
        not share timing state, or slow sends get mismeasured against a
        later holder's start."""
        return _Slot(self)

    async def _acquire(self) -> float:
        t0 = time.perf_counter()
        async with self._cond:
            while self.in_flight >= self.limit:
                await self._cond.wait()
            self.in_flight += 1
        self.ewma_wait_ms = self._ewma(
            self.ewma_wait_ms, (time.perf_counter() - t0) * 1000.0
        )
        return time.perf_counter()

    async def _release(self, send_ms: float, ok: bool):
        async with self._cond:
            self.in_flight = max(0, self.in_flight - 1)
            self.ewma_send_ms = self._ewma(self.ewma_send_ms, send_ms)
            if ok:
                self._consecutive_failures = 0
            else:
                self._consecutive_failures += 1
            self._completions += 1
            if self._completions % self._decide_every == 0:
                self._decide()
            self._cond.notify_all()

    def stats(self) -> dict:
        """Control-law observables (surfaced by the wire pipeline through
        rpc_info → health --probe)."""
        return {
            "limit": self.limit,
            "in_flight": self.in_flight,
            "ewma_wait_ms": round(self.ewma_wait_ms, 3),
            "ewma_send_ms": round(self.ewma_send_ms, 3),
        }

    def _decide(self) -> None:
        old = self.limit
        if self._consecutive_failures >= 2:
            self.limit = max(self.lo, self.limit - 1)
            self._consecutive_failures = 0
            reason = "failures"
        elif (
            self.ewma_wait_ms > self._wait_up_ms
            and self.ewma_send_ms < self._send_ok_ms
        ):
            self.limit = min(self.hi, self.limit + 1)
            reason = "queue_pressure"
        elif (
            self.ewma_send_ms > self._send_slow_ms
            and self.ewma_wait_ms < 1.0
        ):
            self.limit = max(self.lo, self.limit - 1)
            reason = "backpressure"
        else:
            return
        if self.limit != old:
            logger.info(
                "[flow] %s limit %d->%d (%s) wait=%.1fms send=%.1fms",
                self.name, old, self.limit, reason,
                self.ewma_wait_ms, self.ewma_send_ms,
            )


class _Slot:
    """Per-acquisition state for FlowLimiter (send start time lives here)."""

    def __init__(self, limiter: FlowLimiter):
        self._limiter = limiter
        self._t0 = 0.0

    async def __aenter__(self):
        self._t0 = await self._limiter._acquire()
        return self

    async def __aexit__(self, exc_type, exc, tb):
        send_ms = (time.perf_counter() - self._t0) * 1000.0
        await self._limiter._release(send_ms, ok=exc_type is None)
        return False  # never swallow the exception

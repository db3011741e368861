"""Process-wide virtual clock: the single source of time for package code
(a copy of bloombee_tpu/utils/clock.py).

Every timing decision in the package (lease deadlines, ban/quarantine
backoff, keepalive idle detection, promotion sustain windows, admission
watermark ages) reads THIS module instead of ``time`` directly, so tests
can substitute a scaled or hand-stepped clock and run minutes of protocol
time in milliseconds of wall time — with bit-identical state transitions,
because the code under test never sees the substitution.

Three implementations:

- ``RealClock`` (the default): a 1:1 delegate to ``time`` /
  ``asyncio.sleep``. Byte-for-byte identical behavior to the raw calls it
  replaces — production never pays for the indirection with changed
  semantics.
- ``ScaledClock(scale)``: virtual time runs ``scale``× faster than wall
  time from the moment of installation; sleeps shrink by the same factor.
  Deadline math composed before and after installation stays coherent
  because the virtual timeline is anchored at the install instant. Used
  by e2e tests whose background loops (reapers, keepalives, announcers)
  must all speed up *together*.
- ``SteppableClock``: time is frozen until ``advance(dt)`` moves it.
  Sync sleepers block on a condition keyed to virtual time; async
  sleepers park on futures resolved by ``advance`` (thread-safely, via
  their own loop). Used by pure state-machine tests (bans, quarantine)
  that want zero real waiting and exact control of "when".

The module-level helpers (``now``/``monotonic``/``sleep``/``async_sleep``/
``deadline``/``remaining``/``cond_wait``) consult the installed clock on
every call, so installation mid-process retargets all package code at
once. ``perf_counter`` always reads the real clock: it feeds throughput
*measurements* (t_compute_ms stamps), never timing *decisions*, and a
scaled measurement would lie to operators.

"""

from __future__ import annotations

import asyncio
import heapq
import itertools
import threading
import time as _time

from bloombee_tpu_torch.utils import env

env.declare(
    "BBTPU_CLOCK_SCALE", float, 1.0,
    "virtual-clock speedup: >1 installs a ScaledClock running this many "
    "times faster than wall time (sleeps shrink to match), so "
    "timing-dependent recovery paths (leases, bans, promotion windows) "
    "run in compressed wall time; 1.0 = real time, byte-for-byte",
)


class Clock:
    """Time source interface. ``time()`` is wall-clock (registry record
    stamps, NTP-style sync anchors); ``monotonic()`` is for intervals and
    deadlines; both advance on the same virtual timeline."""

    def time(self) -> float:
        raise NotImplementedError

    def monotonic(self) -> float:
        raise NotImplementedError

    def sleep(self, seconds: float) -> None:
        raise NotImplementedError

    async def async_sleep(self, seconds: float) -> None:
        raise NotImplementedError

    async def cond_wait(self, cond: asyncio.Condition,
                        timeout: float | None) -> None:
        """Wait on an already-acquired asyncio.Condition with a timeout
        measured on THIS clock. Raises asyncio.TimeoutError on expiry.
        May wake spuriously (callers re-check their predicate in a loop,
        per the Condition contract)."""
        raise NotImplementedError


class RealClock(Clock):
    """The default: a 1:1 delegate to the stdlib. No added semantics."""

    def time(self) -> float:
        return _time.time()

    def monotonic(self) -> float:
        return _time.monotonic()

    def sleep(self, seconds: float) -> None:
        _time.sleep(seconds)

    async def async_sleep(self, seconds: float) -> None:
        await asyncio.sleep(seconds)

    async def cond_wait(self, cond: asyncio.Condition,
                        timeout: float | None) -> None:
        await asyncio.wait_for(cond.wait(), timeout)


class ScaledClock(Clock):
    """Virtual time = anchor + (real - anchor) * scale, anchored at
    construction so pre-installation timestamps remain meaningful (they
    simply age faster from here on). Sleeps divide by the scale."""

    def __init__(self, scale: float):
        if scale <= 0:
            raise ValueError(f"clock scale must be > 0, got {scale}")
        self.scale = float(scale)
        self._anchor_mono = _time.monotonic()
        self._anchor_wall = _time.time()

    def time(self) -> float:
        return self._anchor_wall + (
            _time.time() - self._anchor_wall
        ) * self.scale

    def monotonic(self) -> float:
        return self._anchor_mono + (
            _time.monotonic() - self._anchor_mono
        ) * self.scale

    def sleep(self, seconds: float) -> None:
        _time.sleep(max(0.0, seconds) / self.scale)

    async def async_sleep(self, seconds: float) -> None:
        await asyncio.sleep(max(0.0, seconds) / self.scale)

    async def cond_wait(self, cond: asyncio.Condition,
                        timeout: float | None) -> None:
        real = None if timeout is None else max(0.0, timeout) / self.scale
        await asyncio.wait_for(cond.wait(), real)


class SteppableClock(Clock):
    """Hand-stepped time: frozen until ``advance(dt)``. Thread-safe —
    sync sleepers may block in worker threads while ``advance`` is called
    from the test thread; async sleepers are resolved on their own event
    loop via ``call_soon_threadsafe``."""

    def __init__(self, start: float = 1000.0):
        self._now = float(start)
        self._wall_anchor = _time.time() - float(start)
        self._cond = threading.Condition()
        self._seq = itertools.count()
        # (virtual deadline, seq, loop, future) min-heap of async sleepers
        self._async_waiters: list = []
        # virtual deadlines of threads currently blocked in sleep();
        # sim engines read these (via next_deadline/blocked_sleepers) to
        # decide how far to auto-advance without overshooting a waker
        self._sync_deadlines: dict = {}

    def time(self) -> float:
        with self._cond:
            return self._wall_anchor + self._now

    def monotonic(self) -> float:
        with self._cond:
            return self._now

    def advance(self, dt: float) -> None:
        """Move virtual time forward, waking every sleeper whose deadline
        has come due (sync sleepers via the condition, async sleepers on
        their own loop)."""
        if dt < 0:
            raise ValueError(f"cannot step time backwards ({dt})")
        due = []
        with self._cond:
            self._now += dt
            while self._async_waiters and (
                self._async_waiters[0][0] <= self._now
            ):
                due.append(heapq.heappop(self._async_waiters))
            self._cond.notify_all()
        for _, _, loop, fut in due:
            loop.call_soon_threadsafe(
                lambda f=fut: f.done() or f.set_result(None)
            )

    def sleep(self, seconds: float) -> None:
        key = (threading.get_ident(), next(self._seq))
        with self._cond:
            deadline = self._now + max(0.0, seconds)
            self._sync_deadlines[key] = deadline
            try:
                while self._now < deadline:
                    self._cond.wait()
            finally:
                del self._sync_deadlines[key]

    def next_deadline(self) -> float | None:
        """Earliest virtual deadline any sleeper (sync or async) is
        waiting for, or None when nobody is sleeping. A discrete-event
        simulator advances exactly to this instant so no sleeper oversleeps
        virtual time."""
        with self._cond:
            cands = list(self._sync_deadlines.values())
            if self._async_waiters:
                cands.append(self._async_waiters[0][0])
            return min(cands) if cands else None

    def blocked_sleepers(self) -> int:
        """Number of threads currently blocked inside sleep() (async
        sleepers are visible via next_deadline, not counted here)."""
        with self._cond:
            return len(self._sync_deadlines)

    async def async_sleep(self, seconds: float) -> None:
        if seconds <= 0:
            await asyncio.sleep(0)
            return
        loop = asyncio.get_running_loop()
        fut = loop.create_future()
        with self._cond:
            heapq.heappush(
                self._async_waiters,
                (self._now + seconds, next(self._seq), loop, fut),
            )
        await fut

    async def cond_wait(self, cond: asyncio.Condition,
                        timeout: float | None) -> None:
        if timeout is None:
            await cond.wait()
            return
        deadline = self.monotonic() + timeout
        # poll in short real slices against the virtual deadline: the
        # notifier may live on another thread and advance() between slices
        while True:
            try:
                await asyncio.wait_for(cond.wait(), 0.005)
                return
            except asyncio.TimeoutError:
                if self.monotonic() >= deadline:
                    raise
                # wait_for re-acquired the condition lock for us; loop


_clock: Clock | None = None
_env_checked = False


def get() -> Clock:
    """The installed clock; lazily built from env once (RealClock unless
    BBTPU_CLOCK_SCALE says otherwise)."""
    global _clock, _env_checked
    if _clock is None:
        if not _env_checked:
            _env_checked = True
            scale = float(env.get("BBTPU_CLOCK_SCALE"))
            _clock = ScaledClock(scale) if scale != 1.0 else RealClock()
        else:
            _clock = RealClock()
    return _clock


def install(clock: Clock | None) -> Clock | None:
    """Install a process-wide clock (tests). None resets to RealClock.
    Returns the previously installed clock."""
    global _clock, _env_checked
    prev = _clock
    _clock = clock
    _env_checked = True  # an explicit clock overrides the env knob
    return prev


def reset() -> None:
    """Back to the pristine lazy state (test teardown): the next get()
    re-reads BBTPU_CLOCK_SCALE, so with no env override this is the
    default RealClock."""
    global _clock, _env_checked
    _clock = None
    _env_checked = False


def now() -> float:
    """Wall-clock seconds (virtual timeline)."""
    return get().time()


def monotonic() -> float:
    """Monotonic seconds (virtual timeline) — intervals and deadlines."""
    return get().monotonic()


def perf_counter() -> float:
    """ALWAYS the real high-resolution counter: measurement, not timing
    decisions. Compute-time stamps must reflect actual hardware speed
    even under a scaled test clock."""
    return _time.perf_counter()


def sleep(seconds: float) -> None:
    get().sleep(seconds)


async def async_sleep(seconds: float) -> None:
    await get().async_sleep(seconds)


def deadline(timeout: float | None) -> float | None:
    """monotonic() + timeout, passing None through."""
    return None if timeout is None else monotonic() + timeout


def remaining(dl: float | None) -> float | None:
    """Seconds until a deadline() value, None for no deadline."""
    return None if dl is None else dl - monotonic()


async def cond_wait(cond: asyncio.Condition,
                    timeout: float | None) -> None:
    """asyncio.Condition.wait with a virtual-clock timeout (raises
    asyncio.TimeoutError on expiry; condition must be held)."""
    await get().cond_wait(cond, timeout)

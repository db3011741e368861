"""Prioritized single-worker compute queue with decode-step coalescing (a
copy of bloombee_tpu/server/compute_queue.py without its jitwatch hooks).

Role of the reference's PrioritizedTaskPool + hivemind Runtime
(the reference's server/task_pool.py:30-236, task_prioritizer.py):
all device work funnels through one worker so steps execute one at a time
(the device is a serial resource), inference outranks forward/backward, and the
asyncio event loop never blocks on device compute.

On top of that, the queue implements the gathering half of Orca-style
continuous batching (Yu et al., OSDI'22): callers may submit *batchable*
tasks (`submit_group`) carrying a compatibility key. When the worker pops
one, it drains every already-queued task with the same key — plus any that
arrive within the `BBTPU_BATCH_WINDOW_MS` gather window — and hands all
their payloads to ONE `run_group` call on the compute thread, scattering
the per-member outcomes back to each caller's future. With N concurrent
decode sessions this turns N serialized span dispatches per round into one.
"""

from __future__ import annotations

import asyncio
import collections
import dataclasses
import functools
import itertools
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Hashable

from bloombee_tpu_torch.utils import clock, env

PRIORITY_INFERENCE = 0.0  # reference DummyTaskPrioritizer: inference=1.0
# resumable prefill chunks re-enter the queue BETWEEN decode steps and
# training work: queued decode(-group) steps preempt the next chunk
# (Sarathi-Serve's stall-free batching), but a chunk still outranks
# forward/backward/warmup
PRIORITY_PREFILL_CHUNK = 0.5
PRIORITY_TRAINING = 1.0  # beats forward/backward=2.0 — same ordering

env.declare(
    "BBTPU_BATCH_WINDOW_MS", float, 0.0,
    "continuous-batching gather window: after popping a batchable decode "
    "step the worker waits this long for more same-key steps before "
    "dispatching (0 = coalesce only steps already queued, no added latency)",
)
env.declare(
    "BBTPU_CHUNK_AGE_S", float, 2.0,
    "chunked-prefill aging horizon: a chunk stream's priority decays "
    "linearly from PRIORITY_PREFILL_CHUNK to decode priority over this "
    "many seconds, so a constant decode load can delay a prefill but "
    "never starve it forever",
)


def aged_chunk_priority(
    stream_started_at: float, now: float | None = None
) -> float:
    """Priority for the next chunk of a prefill stream that began at
    `stream_started_at` (clock.monotonic()). Fresh streams yield to queued
    decode steps; once the stream has aged past BBTPU_CHUNK_AGE_S its
    chunks compete at decode priority (FIFO by submission order), bounding
    worst-case prefill delay under sustained decode pressure."""
    horizon = max(1e-9, float(env.get("BBTPU_CHUNK_AGE_S")))
    if now is None:
        now = clock.monotonic()
    frac = min(1.0, max(0.0, (now - stream_started_at) / horizon))
    return PRIORITY_PREFILL_CHUNK * (1.0 - frac)

# wait-time samples kept for the p50/p95 queue-wait estimate in rpc_info;
# bounded so a long-lived server's stats track recent load, not its lifetime
_WAIT_SAMPLES = 512


class DeadlineExpired(RuntimeError):
    """The task's client-supplied deadline passed while it sat in the
    queue: the client has already given up, so running it would only
    delay work somebody still wants."""


@dataclasses.dataclass
class _Task:
    """A plain (non-batchable) unit of compute: one zero-arg callable."""

    fn: Callable[[], Any]
    fut: asyncio.Future
    deadline: float | None  # clock.monotonic() cutoff, checked at pop time
    enqueued_at: float
    task_class: str | None = None  # "prefill"/"decode" wait-stat bucket


@dataclasses.dataclass
class _GroupTask:
    """One member of a batchable group. Tasks whose `key` compares equal
    may be executed by a single `run_group([payload, ...])` call; the
    callable must return one outcome per payload, in order (a returned
    Exception instance fails just that member's future)."""

    key: Hashable
    payload: Any
    run_group: Callable[[list], list]
    fut: asyncio.Future
    deadline: float | None
    enqueued_at: float
    task_class: str | None = None


class ComputeQueue:
    def __init__(
        self,
        max_group: int = 8,
        compat: Callable[[list, "_GroupTask"], bool] | None = None,
        group_hint: Callable[[list], int] | None = None,
        executor: ThreadPoolExecutor | None = None,
    ) -> None:
        self._queue: asyncio.PriorityQueue = asyncio.PriorityQueue()
        self._seq = itertools.count()
        # injectable for simulation (a counting executor lets a
        # discrete-event simulator see exactly when compute is in flight);
        # default is the same single worker thread as always
        self._thread = executor or ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="compute"
        )
        self._worker_task: asyncio.Task | None = None
        self.max_group = max(1, int(max_group))
        # group-membership predicate: compat(members_so_far, candidate).
        # None = exact key equality, the classic same-shape decode
        # coalescing. A custom predicate lets the server admit
        # heterogeneous members into one dispatch (mixed decode+prefill
        # batching) while still refusing cross-adapter/dtype mixes.
        self.compat = compat
        # upper bound on how many members a gather could EVER collect,
        # given the members gathered so far (the server derives it from
        # its open-session count, kind-aware: a gather that can only
        # admit tree rows is bounded by the sessions currently
        # speculating, not every open session). When the group reaches
        # it, the gather window is pure dead time and the dispatch goes
        # out immediately. None = no bound known; the window always runs
        # to its deadline.
        self.group_hint = group_hint
        # samples are (picked_up_at_monotonic, wait_s) so windowed readers
        # (admission control, load adverts) can discard old load regimes
        # instead of averaging over the whole 512-sample tail
        self._waits: collections.deque = collections.deque(
            maxlen=_WAIT_SAMPLES
        )
        # per-class windows ("prefill"/"decode"): chunked prefill is only
        # stall-free if DECODE queue-wait stays bounded while chunks flow —
        # a blended percentile would hide exactly that signal
        self._class_waits: dict[str, collections.deque] = {}
        # last time the worker popped anything: while the queue is non-empty
        # and nothing pops, (now - _last_pop_at) lower-bounds the wait the
        # NEXT pop will report — the only live signal during a jam, when the
        # sample deques go quiet precisely because nothing completes
        self._last_pop_at: float = clock.monotonic()

    def start(self) -> None:
        self._worker_task = asyncio.create_task(self._worker())

    async def stop(self) -> None:
        self.kill()

    def kill(self) -> None:
        """Synchronous stop — also the crash-fault path, which cannot
        await anything graceful."""
        if self._worker_task is not None:
            self._worker_task.cancel()
        # fail everything still queued: a future that never resolves leaves
        # its awaiter (a session handler) hanging forever on server shutdown
        while True:
            try:
                _, _, task = self._queue.get_nowait()
            except asyncio.QueueEmpty:
                break
            if not task.fut.done():
                task.fut.cancel()
        self._thread.shutdown(wait=False, cancel_futures=True)

    @staticmethod
    def _percentiles(samples) -> dict:
        xs = sorted(w for _, w in samples) if samples else []
        if not xs:
            return {"p50": 0.0, "p95": 0.0}

        def pct(p: float) -> float:
            return xs[min(len(xs) - 1, round(p * (len(xs) - 1)))] * 1000.0

        return {"p50": pct(0.50), "p95": pct(0.95)}

    def wait_stats_ms(self) -> dict:
        """p50/p95 of recent queue-wait times (submit -> worker pickup), in
        milliseconds, overall plus per task class ("prefill"/"decode").
        Rough percentile over a bounded sample window — an operator signal
        for "is the compute queue backed up", not a benchmark."""
        out = self._percentiles(self._waits)
        for cls in ("prefill", "decode"):
            out[cls] = self._percentiles(self._class_waits.get(cls))
        return out

    def depth(self) -> int:
        """Tasks currently waiting for the worker (excludes the one on the
        compute thread right now)."""
        return self._queue.qsize()

    def current_delay_ms(
        self, window_s: float = 5.0, cls: str | None = None
    ) -> float:
        """Best live estimate of the queueing delay a task submitted NOW
        would see, in ms: max of the windowed p95 of recent waits and the
        age of the current jam (time since the last pop, if anything is
        queued). The second term is what makes this usable for admission
        control — during a stall no samples arrive, so a percentile alone
        reads zero exactly when the queue is at its worst."""
        now = clock.monotonic()
        src = self._class_waits.get(cls) if cls is not None else self._waits
        recent = [e for e in (src or ()) if now - e[0] <= window_s]
        p95 = self._percentiles(recent)["p95"]
        stall_ms = 0.0
        if self._queue.qsize() > 0:
            stall_ms = (now - self._last_pop_at) * 1000.0
        return max(p95, stall_ms)

    async def submit(
        self,
        priority: float,
        fn: Callable[..., Any],
        *args,
        deadline: float | None = None,  # clock.monotonic() cutoff: the task
        # is abandoned (DeadlineExpired) if the worker reaches it later
        task_class: str | None = None,  # wait-stat bucket, not passed to fn
        **kwargs,
    ) -> Any:
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        task = _Task(
            # bind fn/args NOW: a late-binding closure would capture the
            # worker loop's variables, not this submission's
            fn=functools.partial(fn, *args, **kwargs),
            fut=fut,
            deadline=deadline,
            enqueued_at=clock.monotonic(),
            task_class=task_class,
        )
        self._queue.put_nowait((priority, next(self._seq), task))
        return await fut

    async def submit_group(
        self,
        priority: float,
        key: Hashable,
        payload: Any,
        run_group: Callable[[list], list],
        *,
        deadline: float | None = None,
        task_class: str | None = None,
    ) -> Any:
        """Submit one member of a batchable group. All queued members whose
        `key` equals this one's (arriving before the worker dispatches, or
        within the gather window) execute as ONE `run_group` call; this
        caller gets back its own member's outcome. Each member keeps its
        own deadline — an expired member is dropped from the group with
        DeadlineExpired, the rest still run."""
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        task = _GroupTask(
            key=key,
            payload=payload,
            run_group=run_group,
            fut=fut,
            deadline=deadline,
            enqueued_at=clock.monotonic(),
            task_class=task_class,
        )
        self._queue.put_nowait((priority, next(self._seq), task))
        return await fut

    async def _worker(self) -> None:
        loop = asyncio.get_running_loop()
        while True:
            _, _, task = await self._queue.get()
            self._last_pop_at = clock.monotonic()
            try:
                if isinstance(task, _GroupTask):
                    await self._run_group(loop, task)
                else:
                    await self._run_one(loop, task)
            except asyncio.CancelledError:
                # stop() cancelled us mid-task: the popped task is no
                # longer in the queue, so stop()'s drain can't see it —
                # resolve its future(s) here or the awaiter hangs
                if not task.fut.done():
                    task.fut.cancel()
                raise

    async def _run_one(self, loop, task: _Task) -> None:
        if task.fut.cancelled():
            return
        self._note_wait(task)
        if self._expired(task):
            return
        try:
            result = await loop.run_in_executor(self._thread, task.fn)
            if not task.fut.done():
                task.fut.set_result(result)
        except asyncio.CancelledError:
            raise
        except Exception as e:
            if not task.fut.done():
                task.fut.set_exception(e)

    async def _run_group(self, loop, first: _GroupTask) -> None:
        members = [first]
        self._gather(members, self.max_group - len(members))
        window_s = float(env.get("BBTPU_BATCH_WINDOW_MS")) / 1000.0
        if window_s > 0 and len(members) < self.max_group:
            # hold the device for one short window: steps of other sessions
            # in the same decode round are typically in flight right now.
            # Sliced, so a member landing mid-window joins at the next
            # slice and the hold ends the moment the group provably cannot
            # grow — group_hint(members) bounds the possible member
            # count for THIS gather's kinds, so a full house dispatches
            # at once instead of sleeping out the window (a solo session
            # skips the hold entirely).
            deadline = clock.monotonic() + window_s
            while len(members) < self.max_group:
                if (
                    self.group_hint is not None
                    and len(members) >= self.group_hint(members)
                ):
                    break
                remaining = deadline - clock.monotonic()
                if remaining <= 0:
                    break
                await clock.async_sleep(min(0.05, remaining))
                self._gather(members, self.max_group - len(members))
        try:
            live = []
            for m in members:
                if m.fut.cancelled():
                    continue
                self._note_wait(m)
                if self._expired(m):
                    continue
                live.append(m)
            if not live:
                return
            outcomes = await loop.run_in_executor(
                self._thread,
                functools.partial(first.run_group, [m.payload for m in live]),
            )
            if len(outcomes) != len(live):
                raise RuntimeError(
                    f"run_group returned {len(outcomes)} outcomes for "
                    f"{len(live)} members"
                )
        except asyncio.CancelledError:
            for m in members:
                if not m.fut.done():
                    m.fut.cancel()
            raise
        except Exception as e:
            # a failure of the group call itself (not a per-member outcome)
            # fails every member; callers own their per-session recovery
            for m in live:
                if not m.fut.done():
                    m.fut.set_exception(e)
            return
        for m, out in zip(live, outcomes):
            if m.fut.done():
                continue
            if isinstance(out, BaseException):
                m.fut.set_exception(out)
            else:
                m.fut.set_result(out)

    def _match(self, members: list[_GroupTask], task: _GroupTask) -> bool:
        """Can `task` join the group gathered so far? Default: exact key
        equality with the first member. A server-supplied `compat`
        predicate sees the whole group, so it can enforce structural rules
        (e.g. at most one prefill chunk per mixed dispatch)."""
        if self.compat is not None:
            return bool(self.compat(members, task))
        return task.key == members[0].key

    def _gather(self, members: list[_GroupTask], limit: int) -> None:
        """Pull up to `limit` queued group tasks compatible with the group
        gathered so far, appending them to `members` in place (each
        admission may widen what the next candidate is matched against);
        everything else goes back with its original (priority, seq) so
        ordering is untouched."""
        taken = 0
        keep: list = []
        while True:
            try:
                entry = self._queue.get_nowait()
            except asyncio.QueueEmpty:
                break
            task = entry[2]
            if (
                taken < limit
                and isinstance(task, _GroupTask)
                and not task.fut.cancelled()
                and self._match(members, task)
            ):
                members.append(task)
                taken += 1
            else:
                keep.append(entry)
        for entry in keep:
            self._queue.put_nowait(entry)

    def _note_wait(self, task) -> None:
        now = clock.monotonic()
        wait = now - task.enqueued_at
        self._waits.append((now, wait))
        if task.task_class is not None:
            dq = self._class_waits.get(task.task_class)
            if dq is None:
                dq = self._class_waits[task.task_class] = collections.deque(
                    maxlen=_WAIT_SAMPLES
                )
            dq.append((now, wait))

    def _expired(self, task) -> bool:
        # checked at execution time, not submit time: a deep queue behind
        # a slow step is exactly when expiry happens
        if task.deadline is not None and clock.monotonic() > task.deadline:
            if not task.fut.done():
                task.fut.set_exception(
                    DeadlineExpired(
                        "deadline passed while queued; dropping compute"
                    )
                )
            return True
        return False

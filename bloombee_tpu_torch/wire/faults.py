"""Deterministic fault injection for the wire layer (a copy of
bloombee_tpu/wire/faults.py over the port's torch tensor codec).

BloomBee's value proposition is surviving a flaky swarm, but the reactive
machinery (session re-route + replay, registry TTL expiry, peer bans) could
only be exercised by killing real servers at uncontrolled moments. This
module makes failures *provokable*: a `FaultPlan` holds an ordered list of
`FaultRule`s plus a seeded RNG, and `Connection._send` / `Connection._read_loop`
consult the installed plan on every frame. Rules match per-site, per-method,
per-peer-port and per-nth-call, so a test can say exactly "reset the
connection to server B on the 3rd decode step" and replay it bit-for-bit.

Actions:

- ``delay``  — sleep ``delay_s`` before the frame proceeds (slow link)
- ``reset``  — abort the transport (RST-style connection reset)
- ``close``  — orderly close mid-stream (FIN after the current frame)
- ``stall``  — on read: swallow the frame and never deliver it (wedged peer);
  on send: sleep until the connection dies (stalled writer)
- ``drop``   — on read: silently discard the frame (lost packet)
- ``corrupt`` — on send: perturb the first float tensor payload in-flight
  (seeded pick of NaN-poison, large scale, or an exponent bit-flip), then
  re-serialize so the frame stays *well-formed* — header, sizes and codec
  all valid, only the numbers are wrong. Unlike every omission action
  above, nothing at the transport layer ever notices; only the integrity
  layer (client sanity gate / out_digest / audits) can.
- ``partition`` — once triggered, blackhole the connection in BOTH
  directions forever: every later send is silently discarded before the
  wire and every later read is swallowed, with no FIN/RST ever delivered.
  Unlike per-frame ``stall``/``drop`` the connection *stays* dead — the
  half-open TCP case only keepalives (wire/rpc.py) can detect.

Probabilistic chaos uses the plan's seeded RNG so a failing soak run can be
reproduced from its seed alone. Env knobs (``BBTPU_CHAOS_*``) build a
process-wide plan at first use for chaos-testing real deployments without
touching code.
"""

from __future__ import annotations

import asyncio
import dataclasses
import logging
import random
from typing import Callable, Optional

import torch

from bloombee_tpu_torch.utils import env, ledger

logger = logging.getLogger(__name__)

env.declare(
    "BBTPU_CHAOS", bool, False,
    "master switch: build a process-wide FaultPlan from the BBTPU_CHAOS_* "
    "knobs below and inject faults into every wire connection",
)
env.declare(
    "BBTPU_CHAOS_SEED", int, 0,
    "seed for the chaos plan's RNG — identical seeds replay identical "
    "fault sequences",
)
env.declare(
    "BBTPU_CHAOS_DELAY_P", float, 0.0,
    "per-frame probability of delaying a sent frame",
)
env.declare(
    "BBTPU_CHAOS_DELAY_S", float, 0.05,
    "how long a chaos-delayed frame sleeps before hitting the wire",
)
env.declare(
    "BBTPU_CHAOS_RESET_P", float, 0.0,
    "per-frame probability of aborting the connection instead of sending",
)
env.declare(
    "BBTPU_CHAOS_STALL_P", float, 0.0,
    "per-frame probability of swallowing a received frame (wedged peer)",
)
env.declare(
    "BBTPU_CHAOS_PARTITION_P", float, 0.0,
    "per-frame probability of partitioning the connection: a permanent "
    "both-direction blackhole with no FIN/RST (detected only by keepalives)",
)
env.declare(
    "BBTPU_CHAOS_CORRUPT_P", float, 0.0,
    "per-frame probability of corrupting a span-output reply tensor "
    "in-flight (well-formed frame, wrong numbers); only the integrity "
    "layer can detect it, so pair with BBTPU_INTEGRITY=1",
)
env.declare(
    "BBTPU_CHAOS_SCHEDULE", str, "",
    "scripted deterministic faults: ';'-separated STEP:ACTION[:PORT] "
    "entries, e.g. '3:reset;7:partition:7711' — at the Nth span-output "
    "decode-step reply (per entry, counted over frames matching the "
    "entry's PORT filter), fire the wire ACTION exactly once. Works with "
    "BBTPU_CHAOS=0 (a schedule alone arms the plan). The 'crash' action "
    "is in-process only (needs a bound callback) and is rejected here",
)


class InjectedFault(ConnectionResetError):
    """Raised on the faulting side so callers see the same exception family
    a real transport failure produces (retry paths must not special-case
    injected faults — that would test nothing)."""


@dataclasses.dataclass
class FaultRule:
    """One programmable fault. A rule matches a frame when every non-None
    constraint holds; it fires on the ``nth`` match (1-based) and the
    following ``count - 1`` matches (count=0 -> every match from nth on)."""

    site: str  # "send" | "read"
    # "delay" | "reset" | "close" | "stall" | "drop" | "partition" | "corrupt"
    action: str
    method: str | None = None  # frame's "m" (rpc method) or "t" (frame type)
    port: int | None = None  # remote peer port (targets one server)
    nth: int = 1
    count: int = 1
    delay_s: float = 0.0
    prob: float | None = None  # None: deterministic; else seeded coin-flip
    predicate: Optional[Callable[[dict], bool]] = None  # extra meta match
    _matches: int = dataclasses.field(default=0, repr=False)
    _fired: int = dataclasses.field(default=0, repr=False)

    def wants(self, site: str, peer: tuple | None, header: dict,
              rng: random.Random) -> bool:
        if site != self.site:
            return False
        if self.method is not None and self.method not in (
            header.get("m"), header.get("t")
        ):
            return False
        if self.port is not None and (peer is None or peer[1] != self.port):
            return False
        if self.predicate is not None and not self.predicate(header):
            return False
        if self.prob is not None:
            return rng.random() < self.prob
        self._matches += 1
        if self._matches < self.nth:
            return False
        if self.count and self._fired >= self.count:
            return False
        self._fired += 1
        return True


@dataclasses.dataclass
class ScheduledFault:
    """One scripted fault: "at decode step N, do X". Unlike a FaultRule
    (which matches frame shapes, possibly probabilistically), a scheduled
    fault counts *span-output decode-step replies* — the swarm's logical
    clock — so a test can script "crash server B at step 3" and assert the
    exact recovery sequence that follows, bit-for-bit, run after run.

    ``action`` is any wire action ("delay"/"reset"/"close"/"stall"/"drop"/
    "partition"/"corrupt") or ``"crash"`` — a hard process-death of the
    server named by ``target``, delivered via a callback the test harness
    binds with FaultSchedule.bind_crash (env schedules cannot express it).
    ``port`` filters which peer's replies advance this entry's counter."""

    at_step: int  # 1-based index among this entry's matching replies
    action: str
    port: int | None = None  # count only replies to/from this peer port
    target: str | None = None  # crash only: bind_crash() callback name
    delay_s: float = 0.05  # delay action only
    fired: bool = dataclasses.field(default=False, repr=False)
    _seen: int = dataclasses.field(default=0, repr=False)


class FaultSchedule:
    """Ordered scripted faults, consulted by the plan on every span-output
    reply frame BEFORE the probabilistic rules. Each entry keeps its own
    step counter, so two entries with different port filters tick
    independently. Fired entries never re-fire."""

    def __init__(self, faults: list[ScheduledFault] | None = None,
                 site: str = "send"):
        # steps are counted at ONE site only: in-process swarms share a
        # single plan between client and server connections, and counting
        # a reply at both its send AND its read would tick every entry
        # twice per step. "send" (the server emitting the reply) is the
        # default; a client-process-only deployment can count at "read".
        self.site = site
        self.faults = list(faults or [])
        self._crash_cbs: dict[str, Callable[[], None]] = {}
        # observability: tests assert exactly which steps faulted
        self.log: list[tuple[int, str, str | int | None]] = []

    def add(self, fault: ScheduledFault) -> "FaultSchedule":
        self.faults.append(fault)
        return self

    def bind_crash(self, name: str, cb: Callable[[], None]) -> "FaultSchedule":
        """Bind a crash target: ``cb`` (typically BlockServer.crash) runs
        when an entry with action='crash', target=name comes due."""
        self._crash_cbs[name] = cb
        return self

    def pending(self) -> list[ScheduledFault]:
        return [f for f in self.faults if not f.fired]

    def due(self, peer: tuple | None) -> list[ScheduledFault]:
        """Advance every live entry's counter by this one matching reply
        frame; return the entries that just came due (usually 0 or 1)."""
        out = []
        for f in self.faults:
            if f.fired:
                continue
            if f.port is not None and (peer is None or peer[1] != f.port):
                continue
            f._seen += 1
            if f._seen >= f.at_step:
                f.fired = True
                out.append(f)
        return out

    @classmethod
    def from_env(cls) -> "FaultSchedule | None":
        """Parse BBTPU_CHAOS_SCHEDULE ('STEP:ACTION[:PORT];...'); None when
        unset. Rejects 'crash' loudly — a process death needs an in-process
        bound callback, which no env string can carry."""
        spec = str(env.get("BBTPU_CHAOS_SCHEDULE")).strip()
        if not spec:
            return None
        faults = []
        for entry in spec.split(";"):
            entry = entry.strip()
            if not entry:
                continue
            parts = [p.strip() for p in entry.split(":")]
            if len(parts) < 2:
                raise ValueError(
                    f"BBTPU_CHAOS_SCHEDULE entry {entry!r}: want "
                    "STEP:ACTION[:PORT]"
                )
            action = parts[1]
            if action == "crash":
                raise ValueError(
                    "BBTPU_CHAOS_SCHEDULE cannot script 'crash': it needs "
                    "an in-process FaultSchedule.bind_crash() callback"
                )
            faults.append(ScheduledFault(
                at_step=int(parts[0]), action=action,
                port=int(parts[2]) if len(parts) > 2 else None,
            ))
        return cls(faults)


class FaultPlan:
    """Seeded, ordered rule set consulted by every Connection."""

    def __init__(self, rules: list[FaultRule] | None = None,
                 seed: int = 0, schedule: FaultSchedule | None = None):
        self.rules = list(rules or [])
        self.rng = random.Random(seed)
        self.schedule = schedule
        # observability: tests assert exactly which faults landed
        self.log: list[tuple[str, str, dict]] = []

    def add(self, rule: FaultRule) -> "FaultPlan":
        self.rules.append(rule)
        return self

    def _pick(self, site: str, peer, header) -> FaultRule | None:
        for rule in self.rules:
            if rule.wants(site, peer, header, self.rng):
                return rule
        return None

    async def on_send(self, conn, header: dict,
                      blobs: list[bytes] | None = None) -> str | None:
        """Consulted by Connection._send before the frame hits the wire.
        May sleep, raise InjectedFault after aborting the transport,
        mutate ``header``/``blobs`` in place (corrupt — the caller encodes
        the frame afterwards, so sizes are recomputed), or return "drop"
        to silently discard the frame (partition)."""
        if getattr(conn, "_bbtpu_partitioned", False):
            return "drop"
        if (
            self.schedule is not None
            and self.schedule.site == "send"
            and _is_span_output_reply(header)
        ):
            verdict = await self._fire_scheduled("send", conn, header, blobs)
            if verdict is not None:
                return verdict
        rule = self._pick("send", conn.peer, header)
        if rule is None:
            return None
        self.log.append(("send", rule.action, dict(header)))
        ledger.fault(f"wire.{rule.action}")
        if rule.action == "partition":
            self._partition(conn)
            return "drop"
        if rule.action == "corrupt":
            self._corrupt(header, blobs)
            return None
        await self._apply(conn, rule, header)
        return None

    async def on_read(self, conn, header: dict) -> str | None:
        """Consulted by Connection._read_loop after decoding a frame and
        before dispatch. Returns "drop" to swallow the frame."""
        if getattr(conn, "_bbtpu_partitioned", False):
            return "drop"
        if (
            self.schedule is not None
            and self.schedule.site == "read"
            and _is_span_output_reply(header)
        ):
            verdict = await self._fire_scheduled("read", conn, header, None)
            if verdict is not None:
                return verdict
        rule = self._pick("read", conn.peer, header)
        if rule is None:
            return None
        self.log.append(("read", rule.action, dict(header)))
        ledger.fault(f"wire.{rule.action}")
        if rule.action == "partition":
            self._partition(conn)
            return "drop"
        if rule.action == "delay":
            await asyncio.sleep(rule.delay_s)
            return None
        if rule.action in ("stall", "drop"):
            logger.info(
                "chaos: swallowing %s frame from %s", header.get("t"),
                conn.peer,
            )
            return "drop"
        if rule.action in ("reset", "close"):
            await self._kill(conn, abort=rule.action == "reset")
            return "drop"
        return None

    async def _fire_scheduled(self, site: str, conn, header: dict,
                              blobs: list | None) -> str | None:
        """Apply every scheduled fault due at this span-output reply.
        Returns "drop" to discard the frame, None to let it proceed.
        Scheduled "stall"/"drop" both swallow the reply (the deterministic
        harness must never hang a writer on a wall-clock wait); "crash"
        runs the bound callback and drops the in-flight reply — it dies
        with the server, exactly like a mid-step kill -9."""
        verdict = None
        for f in self.schedule.due(conn.peer):
            self.schedule.log.append((f._seen, f.action, f.target or f.port))
            self.log.append((site, f"scheduled.{f.action}", dict(header)))
            logger.info(
                "chaos: scheduled %s at decode step %d (peer %s)",
                f.action, f._seen, conn.peer,
            )
            if f.action == "crash":
                cb = self.schedule._crash_cbs.get(f.target or "")
                if cb is None:
                    raise RuntimeError(
                        f"scheduled crash target {f.target!r} has no "
                        "bound callback (FaultSchedule.bind_crash)"
                    )
                # crash() itself ledgers the server.crash fault
                cb()
                verdict = "drop"
                continue
            ledger.fault(f"wire.scheduled.{f.action}")
            if f.action == "partition":
                self._partition(conn)
                verdict = "drop"
            elif f.action == "corrupt":
                self._corrupt(header, blobs)
            elif f.action == "delay":
                await asyncio.sleep(f.delay_s)
            elif f.action in ("stall", "drop"):
                verdict = "drop"
            elif f.action in ("reset", "close"):
                await self._kill(conn, abort=f.action == "reset")
                raise InjectedFault(f"injected scheduled {f.action}")
            else:
                raise ValueError(f"unknown scheduled action {f.action!r}")
        return verdict

    async def _apply(self, conn, rule: FaultRule, header: dict) -> None:
        if rule.action == "delay":
            await asyncio.sleep(rule.delay_s)
            return
        if rule.action == "stall":
            # a wedged writer: hold the frame until the connection dies
            logger.info("chaos: stalling send to %s", conn.peer)
            await conn._closed.wait()
            raise InjectedFault("injected send stall")
        if rule.action in ("reset", "close"):
            logger.info(
                "chaos: %s connection to %s on %s frame", rule.action,
                conn.peer, header.get("t"),
            )
            await self._kill(conn, abort=rule.action == "reset")
            raise InjectedFault(f"injected connection {rule.action}")

    def _corrupt(self, header: dict, blobs: list | None) -> None:
        """Byzantine payload corruption: decode the first float tensor in
        the frame, perturb it with a seeded pick of NaN-poison / ×64 scale
        / exponent bit-flip, and re-serialize. The frame stays well-formed
        (valid header, codec, sizes) — only the numbers lie. Non-float
        frames are left untouched (corrupting int token ids would be
        undetectable by activation checks and is a different failure
        class) — EXCEPT compile-artifact transfers, whose raw uint8
        blobs get a single bit flipped: the blake2b digest check on
        install must convict it, exactly like a corrupt span output must
        be convicted by the integrity layer."""
        tms = header.get("tm") or []
        if not tms or not blobs:
            return
        from bloombee_tpu_torch.wire import tensor_codec

        try:
            meta = tensor_codec.TensorMeta.from_wire(tms[0])
            arr = tensor_codec.deserialize_tensor(meta, blobs[0]).clone()
        except Exception:  # pragma: no cover - malformed frames ship as-is
            return
        is_float = arr.is_floating_point()  # bf16 included
        if arr.numel() == 0:
            return
        flat = arr.reshape(-1)
        size = arr.element_size()
        idx = self.rng.randrange(flat.numel())
        if not is_float:
            if not _is_artifact_transfer(header):
                return
            flat.view(torch.uint8)[idx * size] ^= 0x40
        else:
            mode = ("nan", "scale", "bitflip")[self.rng.randrange(3)]
            if mode == "nan":
                flat[idx] = float("nan")
            elif mode == "scale":
                arr.mul_(64)
            else:
                # flip the top exponent bit of one element via its raw
                # bytes — the classic single-bit memory fault
                flat.view(torch.uint8)[idx * size + (size - 1)] ^= 0x40
        m, b = tensor_codec.serialize_tensor(arr, compression=True)
        tms[0] = m.to_wire()
        blobs[0] = b
        header["tm"] = tms

    @staticmethod
    def _partition(conn) -> None:
        """Mark the connection blackholed: the flag lives on the Connection
        (not the plan) so one marking silences both directions as observed
        by BOTH endpoints — our sends never reach the wire's effects and
        every arriving frame is swallowed before dispatch. No FIN/RST is
        ever generated; only a keepalive timeout can notice."""
        logger.info("chaos: partitioning connection to %s", conn.peer)
        conn._bbtpu_partitioned = True

    @staticmethod
    async def _kill(conn, abort: bool) -> None:
        try:
            if abort:
                transport = conn.writer.transport
                if transport is not None:
                    transport.abort()
            else:
                conn.writer.close()
        except Exception:
            pass

    @classmethod
    def from_env(cls) -> "FaultPlan | None":
        """Build a plan from the BBTPU_CHAOS_* knobs; None when chaos is
        off. A BBTPU_CHAOS_SCHEDULE alone arms the plan (deterministic
        scripts should not require enabling the probabilistic machinery)."""
        schedule = FaultSchedule.from_env()
        if not env.get("BBTPU_CHAOS") and schedule is None:
            return None
        plan = cls(seed=env.get("BBTPU_CHAOS_SEED"), schedule=schedule)
        if not env.get("BBTPU_CHAOS"):
            return plan
        delay_p = env.get("BBTPU_CHAOS_DELAY_P")
        if delay_p > 0:
            plan.add(FaultRule(
                site="send", action="delay", prob=delay_p,
                delay_s=env.get("BBTPU_CHAOS_DELAY_S"),
            ))
        reset_p = env.get("BBTPU_CHAOS_RESET_P")
        if reset_p > 0:
            plan.add(FaultRule(site="send", action="reset", prob=reset_p))
        stall_p = env.get("BBTPU_CHAOS_STALL_P")
        if stall_p > 0:
            plan.add(FaultRule(site="read", action="stall", prob=stall_p))
        partition_p = env.get("BBTPU_CHAOS_PARTITION_P")
        if partition_p > 0:
            plan.add(FaultRule(
                site="send", action="partition", prob=partition_p,
            ))
        corrupt_p = env.get("BBTPU_CHAOS_CORRUPT_P")
        if corrupt_p > 0:
            # only span-output step replies ("sitem" frames whose meta
            # carries compute timing) are corrupted: a process-wide plan is
            # shared by in-proc client AND servers, and corrupting a
            # client->server prefill frame would poison server KV in a way
            # no client-side check can see (the lie becomes the ground
            # truth both replicas agree on)
            plan.add(FaultRule(
                site="send", action="corrupt", method="sitem",
                prob=corrupt_p, predicate=_is_span_output_reply,
            ))
        return plan


def _is_span_output_reply(header: dict) -> bool:
    """True for stream items that carry a span-output tensor (step replies
    stamp t_compute_ms into their meta; acks and client-side frames don't)."""
    meta = header.get("meta") or {}
    return bool(header.get("tm")) and "t_compute_ms" in meta


def _is_artifact_transfer(header: dict) -> bool:
    """True for compile-artifact frames (artifact_get/put requests and
    their blob-carrying replies — both stamp "artifact" into their meta,
    since unary "res" frames carry no method name to match on). Chaos
    rules use this to corrupt/stall/kill the artifact stream without
    touching the inference path."""
    meta = header.get("meta") or {}
    return bool(meta.get("artifact"))


_active_plan: FaultPlan | None = None
_env_checked = False


def set_plan(plan: FaultPlan | None) -> None:
    """Install the process-wide plan (tests). None disarms injection."""
    global _active_plan, _env_checked
    _active_plan = plan
    _env_checked = True  # an explicit plan overrides the env knobs


def get_plan() -> FaultPlan | None:
    """Plan consulted by new Connections; lazily built from env once."""
    global _active_plan, _env_checked
    if not _env_checked:
        _env_checked = True
        _active_plan = FaultPlan.from_env()
    return _active_plan

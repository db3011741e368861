"""The port's session leases, reconnect-resume and standby replication, on
the CPU, against HF and the JAX package (the analogs of
tests/test_session_lease.py and tests/test_kv_replication.py).

- the wire: a send on an aborted connection raises the wire's own
  ConnectionClosed, and a connection opened right after it works. (The
  JAX package's `_send` writes to the aborted transport instead: on
  Python 3.12 `writelines` either raises TypeError after the transport
  closed, or, in the same loop tick as the abort, buffers and registers a
  writer on the dying socket's fd, a registration that outlives the socket
  and swallows the next socket that reuses the fd number, so a resume's
  `connect` waits forever. The port checks `is_closing()` first.)
- leases: a partitioned client's session parks (every page reclaimable
  at once) and is reaped within the lease; drain does not wait on a
  wedged parked session;
- resume: a session whose connections are aborted resumes on fresh
  streams with zero replay and HF's tokens (one port server, and a push
  chain of two); a reply lost in a partition is answered from the
  recorded reply on the retransmit (at-most-once, `steps_deduped` == 1);
  a resume after the lease expired is declined and the session replays
  its whole history, still with HF's tokens;
- replication: a standby (port or JAX) installs the primary's (port or
  JAX) sealed pages through `kv_put`, the primary dies, and the client
  recovers onto the standby replaying at most one interval, with HF's
  tokens; `kv_put` declines on an unsupported server.

Every networked test bounds itself (`run(..., timeout)`: at most 60 s).
"""

import asyncio
import time

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bloombee_tpu.server.block_server import BlockServer as JaxServer
from bloombee_tpu.swarm import registry as j_registry
from bloombee_tpu_torch.client import ClientConfig, DistributedModelForCausalLM
from bloombee_tpu_torch.client.session import InferenceSession
from bloombee_tpu_torch.client.sequence_manager import RemoteSequenceManager
from bloombee_tpu_torch.server.block_server import BlockServer
from bloombee_tpu_torch.swarm.registry import RegistryClient
from bloombee_tpu_torch.utils import clock
from bloombee_tpu_torch.utils.clock import ScaledClock
from bloombee_tpu_torch.wire import faults
from bloombee_tpu_torch.wire.faults import FaultPlan, FaultRule
from bloombee_tpu_torch.wire.rpc import (
    ConnectionClosed,
    RpcServer,
    connect,
)
from test_torch_server import (  # noqa: F401  (fixtures)
    REGISTRY_CLIENTS,
    hf_greedy,
    loop,
    port_server,
    registry,
    start_all,
    stop_all,
    tiny_model_dir,
)

LIMIT = 60  # seconds: every networked test fails instead of stalling


def run(loop, coro, timeout=LIMIT):
    return asyncio.run_coroutine_threadsafe(coro, loop).result(timeout)


@pytest.fixture(autouse=True)
def no_leaked_plan():
    yield
    faults.set_plan(None)


def lease_server(model_dir, reg_port, uid, start, end, **kw):
    kw.setdefault("prefix_cache", True)
    return port_server(model_dir, reg_port, uid, start, end, **kw)


def lease_client(model_dir, reg_port, uid, **cfg):
    rc = RegistryClient("127.0.0.1", reg_port)
    REGISTRY_CLIENTS.append(rc)
    cfg.setdefault("use_push", False)
    return DistributedModelForCausalLM.from_pretrained(
        model_dir, rc, model_uid=uid, device="cpu",
        config=ClientConfig(**cfg),
    )


def counts(server):
    table = server.manager.table
    c = table.counts()
    assert c["free"] + c["referenced"] + c["cached"] == table.num_pages, c
    return c


async def wait_for(pred, timeout_s, what):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if pred():
            return
        await asyncio.sleep(0.05)
    raise AssertionError(f"timed out waiting for {what}")


async def greedy_decode(model, session, out, n):
    """`n` greedy tokens from the last-position output `out`, one step
    each; returns (new ids [B, n], out)."""
    new = np.zeros((out.shape[0], 0), dtype=np.int64)
    for _ in range(n):
        nxt = model.logits(out[:, -1:])[:, 0].argmax(-1).numpy()[:, None]
        new = np.concatenate([new, nxt], axis=1)
        out = await session.step(model.embed(nxt), ids=nxt)
    return new, out


def partition(session):
    """Blackhole every span connection (no FIN/RST): only keepalives and
    the lease detect it. A conn captures its fault plan at creation, so
    arm the open conns directly."""
    for sp in session._spans:
        sp.conn.fault_plan = FaultPlan()
        sp.conn._bbtpu_partitioned = True


def prompt(config, seed, n=10):
    return np.random.default_rng(seed).integers(
        0, config.vocab_size, size=(1, n)
    )


# ------------------------------------------------------------------ wire
def test_send_after_abort_fails_cleanly_and_next_connect_works(loop):
    """The repair the JAX resume test lacks: a frame sent in the same loop
    tick as `abort()` raises ConnectionClosed (not asyncio's TypeError,
    and without registering a writer on the dying socket), and a fresh
    connection to the same server opens and answers at once."""

    async def echo(meta, tensors):
        return meta, []

    async def go():
        server = RpcServer(unary_handlers={"echo": echo}, host="127.0.0.1")
        await server.start()
        try:
            for _ in range(3):
                conn = await connect("127.0.0.1", server.port)
                stream = await conn.open_stream("echo_stream", {})
                conn.abort("test: injected failure")
                with pytest.raises(ConnectionClosed):
                    await stream.send({"x": 1})
                with pytest.raises(ConnectionClosed):
                    await conn.call("echo", {"x": 1})
                fresh = await asyncio.wait_for(
                    connect("127.0.0.1", server.port), 5
                )
                meta, _ = await asyncio.wait_for(
                    fresh.call("echo", {"x": 2}), 5
                )
                assert meta["x"] == 2
                await fresh.close()
        finally:
            await server.stop()

    run(loop, go(), timeout=30)


# ----------------------------------------------------------- lease reaper
def test_abandoned_session_reaped_within_lease(loop, tiny_model_dir,
                                               registry):
    """A client partitioned mid-decode never comes back: the keepalive
    fences the half-open stream, the session parks (every page
    reclaimable at once) and the reaper frees it within the lease. No page
    leaks, none is freed twice (the counts invariant)."""
    model_dir, _, config = tiny_model_dir
    server = lease_server(model_dir, registry.port, "reap", 0, 3,
                          session_lease_s=1.0, keepalive_s=0.2)

    async def go():
        await start_all(server)
        rc = RegistryClient("127.0.0.1", registry.port)
        REGISTRY_CLIENTS.append(rc)
        manager = RemoteSequenceManager(rc, "reap", 3)
        rng = np.random.default_rng(2)
        s = InferenceSession(manager, max_length=24, batch_size=1)
        try:
            async with s:
                await s.step(rng.standard_normal(
                    (1, 8, config.hidden_size)).astype(np.float32) * 0.02)
                await s.step(rng.standard_normal(
                    (1, 1, config.hidden_size)).astype(np.float32) * 0.02)
                assert counts(server)["referenced"] > 0
                partition(s)
                # the fence -> park -> reap sequence on a 20x process
                # clock (every loop involved reads clock.*)
                prev = clock.install(ScaledClock(scale=20.0))
                try:
                    await wait_for(lambda: counts(server)["referenced"] == 0,
                                   5.0, "pages reclaimable at park")
                    await wait_for(lambda: server.sessions_reaped >= 1, 5.0,
                                   "lease reap")
                finally:
                    clock.install(prev)
                assert not server._sessions
                assert counts(server)["referenced"] == 0
        finally:
            await stop_all(server)

    run(loop, go())


def test_drain_does_not_wait_on_wedged_session(loop, tiny_model_dir,
                                               registry):
    """Drain with a parked (wedged-client) session and a long lease
    returns at once: parked leases are force-expired, their pages
    reclaimed; a draining server refuses opens and kv_put and advertises
    no replication."""
    model_dir, _, config = tiny_model_dir
    server = lease_server(model_dir, registry.port, "drain", 0, 3,
                          session_lease_s=30.0, keepalive_s=0.2)

    async def go():
        await start_all(server)
        rc = RegistryClient("127.0.0.1", registry.port)
        REGISTRY_CLIENTS.append(rc)
        manager = RemoteSequenceManager(rc, "drain", 3)
        s = InferenceSession(manager, max_length=24, batch_size=1)
        try:
            async with s:
                await s.step(np.random.default_rng(3).standard_normal(
                    (1, 8, config.hidden_size)).astype(np.float32) * 0.02)
                partition(s)
                await wait_for(
                    lambda: any(x.parked for x in server._sessions.values()),
                    5.0, "session to park",
                )
                assert all(server.manager.has_lease_parked(x.handle)
                           for x in server._sessions.values())
                t0 = time.monotonic()
                drain = asyncio.ensure_future(server.drain(timeout=20.0))
                await wait_for(lambda: server._draining, 5.0, "draining")
                assert not server.server_info().kv_repl
                meta, _ = await server._kv_put(
                    {"page_size": 4, "start": 0, "end": 3, "hashes": ["h"]},
                    [],
                )
                assert meta == {"installed": 0, "reason": "draining"}
                await drain
                assert time.monotonic() - t0 < 5.0
                assert not server._sessions
                assert counts(server)["referenced"] == 0
                assert server.sessions_reaped == 1
        finally:
            await stop_all(server)

    run(loop, go())


# ------------------------------------------------------- reconnect-resume
@pytest.mark.parametrize("spans", [1, 2], ids=["one_server", "push_chain"])
def test_reconnect_resume_token_identical_zero_replay(loop, tiny_model_dir,
                                                      registry, spans):
    """Every span connection of the session is aborted mid-decode; the
    client resumes each lease-parked session on a fresh stream and the
    generation finishes with HF's tokens and zero replay."""
    model_dir, hf_model, config = tiny_model_dir
    uid = f"resume{spans}"
    bounds = [(0, 3)] if spans == 1 else [(0, 2), (2, 3)]
    servers = [lease_server(model_dir, registry.port, uid, a, b,
                            session_lease_s=30.0) for a, b in bounds]
    ids = prompt(config, 4)
    ref = hf_greedy(hf_model, ids, 8)

    async def go():
        await start_all(*servers)
        model = lease_client(model_dir, registry.port, uid,
                             use_push=spans > 1, resume=True)
        session = model.inference_session(24, 1)
        try:
            async with session:
                out = await session.step(model.embed(ids), ids=ids)
                first, out = await greedy_decode(model, session, out, 4)
                for sp in session._spans:
                    sp.conn.abort("test: injected failure")
                rest, _ = await greedy_decode(model, session, out, 4)
            np.testing.assert_array_equal(
                np.concatenate([ids, first, rest], axis=1), ref
            )
            assert session.resumed_streams == spans
            assert session.resume_declines == 0
            assert session.failover_replayed_tokens == 0
            for s in servers:
                assert s.sessions_resumed == 1
                assert s.failover_replayed_tokens == 0
            await wait_for(
                lambda: all(counts(s)["referenced"] == 0 for s in servers),
                5.0, "teardown",
            )
        finally:
            await stop_all(*servers)

    run(loop, go())


def test_lost_reply_dedup_at_most_once(loop, tiny_model_dir, registry):
    """The server APPLIES a decode step but its reply vanishes in a
    partition; the resumed client retransmits under the original id and
    the server answers from the recorded reply without re-applying KV
    (steps_deduped == 1): HF's tokens, zero replay."""
    model_dir, hf_model, config = tiny_model_dir
    server = lease_server(model_dir, registry.port, "dedup", 0, 3,
                          session_lease_s=30.0)
    ids = prompt(config, 5)
    ref = hf_greedy(hf_model, ids, 8)

    async def go():
        await start_all(server)
        # the 3rd stream reply read from the server (prefill #1, decode
        # step 1 #2, decode step 2 #3) is lost in a partition
        faults.set_plan(FaultPlan(seed=1).add(FaultRule(
            site="read", action="partition", method="sitem",
            port=server.port, nth=3,
        )))
        model = lease_client(model_dir, registry.port, "dedup",
                             resume=True, step_timeout=2.0)
        session = model.inference_session(24, 1)
        try:
            async with session:
                out = await session.step(model.embed(ids), ids=ids)
                toks, _ = await greedy_decode(model, session, out, 8)
            np.testing.assert_array_equal(
                np.concatenate([ids, toks], axis=1), ref
            )
            assert session.resumed_streams == 1
            assert session.failover_replayed_tokens == 0
            assert server.steps_deduped == 1
            assert server.sessions_resumed == 1
            info = (await server._rpc_info({}, []))[0]
            assert info["steps_deduped"] == 1
            assert info["session_lease_s"] == 30.0
            assert "sessions_reaped" in info and "sessions_parked" in info
        finally:
            faults.set_plan(None)
            await stop_all(server)

    run(loop, go())


def test_resume_declined_after_lease_expiry_full_replay(
    loop, tiny_model_dir, registry
):
    """A client that comes back after its lease expired is declined and
    replays its whole committed history (10 prompt + 4 decoded tokens)
    onto a fresh session: still HF's tokens."""
    model_dir, hf_model, config = tiny_model_dir
    server = lease_server(model_dir, registry.port, "expire", 0, 3,
                          session_lease_s=0.5)
    ids = prompt(config, 6)
    ref = hf_greedy(hf_model, ids, 8)

    async def go():
        await start_all(server)
        model = lease_client(model_dir, registry.port, "expire",
                             resume=True, ban_timeout=0.2, ban_max=0.5)
        session = model.inference_session(24, 1)
        try:
            async with session:
                out = await session.step(model.embed(ids), ids=ids)
                first, out = await greedy_decode(model, session, out, 4)
                for sp in session._spans:
                    sp.conn.abort("test: injected failure")
                prev = clock.install(ScaledClock(scale=20.0))
                try:
                    await wait_for(lambda: server.sessions_reaped >= 1, 5.0,
                                   "lease reap")
                finally:
                    clock.install(prev)
                rest, _ = await greedy_decode(model, session, out, 4)
            np.testing.assert_array_equal(
                np.concatenate([ids, first, rest], axis=1), ref
            )
            assert session.resume_declines >= 1
            assert session.resumed_streams == 0
            assert session.failover_replayed_tokens == 14
            assert server.failover_replayed_tokens == 14
            await wait_for(lambda: counts(server)["referenced"] == 0, 5.0,
                           "teardown")
        finally:
            await stop_all(server)

    run(loop, go())


# ------------------------------------------------------------ replication
def jax_repl_server(model_dir, reg_port, uid, throughput):
    return JaxServer(
        model_uid=uid, start=0, end=3, model_dir=model_dir,
        registry=j_registry.RegistryClient("127.0.0.1", reg_port),
        compute_dtype=jnp.float32, num_pages=64, page_size=4,
        prefix_cache=True, throughput=throughput,
    )


def installed(server) -> int:
    return server.manager.prefix_stats()["repl_pages_installed"]


@pytest.mark.parametrize(
    "primary,standby",
    [("port", "port"), ("jax", "port"), ("port", "jax")],
)
def test_failover_replays_one_interval(loop, tiny_model_dir, registry,
                                       primary, standby):
    """The primary exports each sealed page through kv_put into the
    standby's pool (across the packages both ways); the primary dies and
    the port client recovers onto the standby, whose probe adopts the
    replicated pages: the replay is at most one interval plus the
    unsealed tail, the tokens HF's."""
    model_dir, hf_model, config = tiny_model_dir
    uid = f"repl-{primary}-{standby}"

    def make(kind, throughput):
        if kind == "jax":
            return jax_repl_server(model_dir, registry.port, uid, throughput)
        s = lease_server(model_dir, registry.port, uid, 0, 3)
        s.throughput = throughput
        return s

    prim = make(primary, 10.0)
    stby = make(standby, 1.0)
    # 12-token prompt + 4 decoded = 16 tokens: 4 sealed pages at page
    # size 4, so a caught-up standby bounds the replay to one token
    ids = (np.arange(12)[None, :] * 5 + 3) % config.vocab_size
    ref = hf_greedy(hf_model, ids, 9)

    async def go():
        await start_all(prim, stby)
        model = lease_client(model_dir, registry.port, uid,
                             prefix_cache=True, kv_repl_every=1,
                             ban_timeout=0.5, ban_max=2.0)
        session = model.inference_session(28, 1)
        try:
            await session.__aenter__()
            assert session._spans[0].span.server_info.port == prim.port
            assert session._standby_peers()
            out = await session.step(model.embed(ids), ids=ids)
            first, out = await greedy_decode(model, session, out, 4)
            await wait_for(lambda: installed(stby) >= 4, 10.0,
                           "standby installs")
            await wait_for(lambda: prim.repl_pages_sent >= 4, 5.0,
                           "sender bookkeeping")
            await prim.stop()
            rest, _ = await greedy_decode(model, session, out, 5)
            await session.__aexit__(None, None, None)
            np.testing.assert_array_equal(
                np.concatenate([ids, first, rest], axis=1), ref
            )
            page_size, repl_every = 4, 1
            assert 0 < session.failover_replayed_tokens \
                <= page_size * repl_every + 1
            assert session.resume_declines == 1  # primary gone: no resume
            assert stby.failover_replayed_tokens == \
                session.failover_replayed_tokens
            await wait_for(lambda: counts(stby)["referenced"] == 0, 5.0,
                           "teardown")
        finally:
            await session.close()
            for s in (prim, stby):
                if s is not prim:
                    await s.stop()
                await s.registry.close()

    run(loop, go())


def test_kv_put_declines_on_unsupported_server(loop, tiny_model_dir):
    """kv_put against a server without the prefix cache, an int4 arena,
    a mismatched page size or span declines with installed=0 and a
    reason; a well-formed put installs."""
    model_dir, _, _ = tiny_model_dir

    def make(**kw):
        return BlockServer(
            model_uid="kvput", start=0, end=3, model_dir=model_dir,
            compute_dtype=torch.float32, num_pages=16, page_size=4,
            throughput=1.0, device="cpu", **kw,
        )

    off, int4, on = (make(prefix_cache=False),
                     make(prefix_cache=True, kv_quant="int4"),
                     make(prefix_cache=True))
    k = torch.zeros((1, 3, 4, 2, 16))
    payload = {"page_size": 4, "start": 0, "end": 3, "hashes": ["h"]}

    async def go():
        await start_all(off, int4, on)
        try:
            for s, reason in ((off, "unsupported"), (int4, "unsupported")):
                conn = await connect("127.0.0.1", s.port)
                meta, _ = await conn.call("kv_put", payload, [k, k])
                assert meta["installed"] == 0 and reason in meta["reason"]
                assert not s.server_info().kv_repl
                await conn.close()
            conn = await connect("127.0.0.1", on.port)
            meta, _ = await conn.call("kv_put", {**payload, "page_size": 8},
                                      [k, k])
            assert meta["installed"] == 0 and "page_size" in meta["reason"]
            meta, _ = await conn.call("kv_put", {**payload, "end": 2},
                                      [k, k])
            assert meta["installed"] == 0 and "span" in meta["reason"]
            meta, _ = await conn.call("kv_put", payload, [k, k])
            assert meta == {"installed": 1}
            assert counts(on) == {"free": 15, "referenced": 0, "cached": 1}
            await conn.close()
        finally:
            for s in (off, int4, on):
                await s.stop()

    run(loop, go())


def test_lease_and_repl_defaults(monkeypatch):
    """The JAX defaults: leases off, replication off, resume on, prefix
    cache off; the env switches reach the server and the session."""
    from bloombee_tpu_torch.utils import env

    assert env.get("BBTPU_SESSION_LEASE_S") == 0.0
    assert env.get("BBTPU_REPL_EVERY") == 0
    assert env.get("BBTPU_RESUME") is True
    assert env.get("BBTPU_PREFIX_CACHE") is False
    assert env.get("BBTPU_PREFIX_MAX_PAGES") == 0
    cfg = ClientConfig()
    assert (cfg.prefix_cache, cfg.kv_repl_every, cfg.resume) == \
        (None, None, None)
    s = InferenceSession(manager=None, max_length=8)
    assert (s.prefix_cache, s.repl_every, s.resume) == (False, 0, True)
    monkeypatch.setenv("BBTPU_RESUME", "0")
    monkeypatch.setenv("BBTPU_REPL_EVERY", "4")
    monkeypatch.setenv("BBTPU_PREFIX_CACHE", "1")
    s = InferenceSession(manager=None, max_length=8)
    assert (s.prefix_cache, s.repl_every, s.resume) == (True, 4, False)


def test_dead_next_hop_fails_the_step_not_parks_the_session(
    loop, tiny_model_dir, registry
):
    """A push chain with leases on loses its downstream server between
    steps. The upstream server's push to it fails: that is no death of
    the client's stream, so the session must not park (the client would
    wait out its 30 s step timeout for a reply that never comes). The step
    fails with an error frame, the declined resume and a reroute follow at
    once, and the tokens stay HF's. (The JAX server parks here.)"""
    model_dir, hf_model, config = tiny_model_dir
    head = lease_server(model_dir, registry.port, "nexthop", 0, 2,
                        session_lease_s=30.0)
    tails = [lease_server(model_dir, registry.port, "nexthop", 2, 3,
                          session_lease_s=30.0) for _ in range(2)]
    ids = prompt(config, 7)
    ref = hf_greedy(hf_model, ids, 8)

    async def go():
        dead = None
        await start_all(head, *tails)
        model = lease_client(model_dir, registry.port, "nexthop",
                             use_push=True, step_timeout=30.0,
                             ban_timeout=0.5, ban_max=2.0)
        session = model.inference_session(24, 1)
        try:
            async with session:
                out = await session.step(model.embed(ids), ids=ids)
                first, out = await greedy_decode(model, session, out, 4)
                port = session._spans[1].span.server_info.port
                dead = next(t for t in tails if t.port == port)
                await dead.stop()
                t0 = time.monotonic()
                rest, _ = await greedy_decode(model, session, out, 4)
                assert time.monotonic() - t0 < 15.0
            np.testing.assert_array_equal(
                np.concatenate([ids, first, rest], axis=1), ref
            )
            assert session.resume_declines == 1
            assert session.failover_replayed_tokens == 14
            assert head.sessions_reaped == 0
        finally:
            await head.stop()
            await head.registry.close()
            for t in tails:
                if t is not dead:
                    await t.stop()
                await t.registry.close()

    run(loop, go())

"""The port server's continuous batcher on the CPU, against HF and the JAX
package (analogs of tests/test_batched_decode.py, test_chunked_prefill.py,
test_mixed_batch.py and the server half of test_universal_ragged.py).

Port servers (`device="cpu"`, f32) serve the tiny Llama of
tests/test_torch_server.py, whose fixtures and helpers this module imports
(one event loop in a background thread, one port registry):

- lockstep groups: 4 port-client sessions stepping together through a
  batching port server (`max_batch=8`, `BBTPU_BATCH_WINDOW_MS=50`) share
  one dispatch per round (width >= 3) with HF greedy tokens, and their
  logits are within 1e-5 of a `max_batch=1` server's;
- a JAX client drives a batching port server, and a mixed chain (a JAX
  span then a port span, both batching) matches HF greedy with logits
  within 1e-5 of an all-JAX chain; rpc_info carries the JAX server's
  batching keys;
- a merged or mixed dispatch that fails after writing its KV rolls back
  (decodes) or truncates (the chunk) and replays solo: outputs and
  context lengths equal the unfailed run's;
- chunked prefill: HF-exact at a budget of 4, decode steps interleave
  between chunks, and a deadline expiring mid-stream frees the partial
  prefill's pages;
- mixed batch: decode steps fuse into the chunk's ragged dispatch with HF
  tokens; it is off by default;
- `_ragged_compat` and `_batch_group_hint` answer as the JAX server's on
  the same member keys (tree members: tests/test_torch_spec.py).
"""

import asyncio
import contextlib
import itertools
import logging
import types

import numpy as np
import pytest
import torch

from bloombee_tpu.server.block_server import BlockServer as JaxServer
from bloombee_tpu_torch.client import ClientConfig, DistributedModelForCausalLM
from bloombee_tpu_torch.server import block_server as t_server
from bloombee_tpu_torch.server.block_server import (
    BlockServer,
    _BatchMember,
    _ChunkMember,
    _Session,
)
from bloombee_tpu_torch.swarm.registry import RegistryClient
from bloombee_tpu_torch.utils import clock
from bloombee_tpu_torch.wire import rpc as t_rpc
from test_torch_server import (  # noqa: F401  (fixtures)
    REGISTRY_CLIENTS,
    client as jax_client,
    hf_greedy,
    jax_server,
    loop,
    port_server,
    registry,
    run,
    start_all,
    stop_all,
    tiny_model_dir,
)

EPS = 1e-5
N, ROUNDS = 4, 6
# the JAX server's batching keys (its rpc_info without the tree keys)
BATCH_KEYS = (
    "batched_steps", "batch_dispatches", "batch_solo_steps",
    "mean_batch_width", "prefill_chunks", "prefill_chunk_tokens",
    "decode_steps_interleaved", "mixed_batch", "mixed_dispatches",
    "mixed_tokens", "ragged_group_dispatches",
    "ragged_cross_kind_dispatches", "ragged_declines",
)


def port_client(model_dir, reg_port, uid, use_push=True):
    rc = RegistryClient("127.0.0.1", reg_port)
    REGISTRY_CLIENTS.append(rc)
    return DistributedModelForCausalLM.from_pretrained(
        model_dir, rc, model_uid=uid, device="cpu",
        config=ClientConfig(use_push=use_push),
    )


def lockstep_prompts(config, seed=7):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, config.vocab_size, size=(1, 5 + i))
            for i in range(N)]


async def lockstep(model, prompts, rounds=ROUNDS, inspect=None):
    """N sessions step in lockstep: all prefills, then `rounds` decode
    rounds. Returns each session's greedy tokens [rounds + 1] and
    last-position logits [rounds + 1, V] (numpy; `model` is either
    package's client). `inspect()` runs before the sessions close."""
    sessions = [model.inference_session(32, 1) for _ in prompts]
    async with contextlib.AsyncExitStack() as stack:
        for sess in sessions:
            await stack.enter_async_context(sess)
        outs = await asyncio.gather(*(
            sess.step(model.embed(p)) for sess, p in zip(sessions, prompts)
        ))
        logits = [[np.asarray(model.logits(o))[:, -1]] for o in outs]
        for _ in range(rounds):
            toks = [np.argmax(lg[-1], axis=-1) for lg in logits]
            outs = await asyncio.gather(*(
                sess.step(model.embed(t[:, None]))
                for sess, t in zip(sessions, toks)
            ))
            for lg, o in zip(logits, outs):
                lg.append(np.asarray(model.logits(o))[:, -1])
        if inspect is not None:
            inspect()
    logits = [np.concatenate(lg) for lg in logits]
    return [np.argmax(lg, axis=-1) for lg in logits], logits


def session_lens(server):
    """Every open session's context length on `server`, sorted."""
    return sorted(
        int(server.manager.context_lens(s.handle)[0])
        for s in server._sessions.values()
    )


def assert_hf(hf_model, prompts, tokens):
    for p, got in zip(prompts, tokens):
        ref = hf_greedy(hf_model, p, len(got))
        np.testing.assert_array_equal(got, ref[0, p.shape[1]:])


def counters(server):
    return {k: getattr(server, k) for k in (
        "batched_steps", "batch_dispatches", "batch_solo_steps",
        "prefill_chunks", "decode_steps_interleaved", "mixed_dispatches",
    )}


def delta(server, before):
    now = counters(server)
    return {k: now[k] - before[k] for k in now}


@pytest.fixture(scope="module")
def window_50ms():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("BBTPU_BATCH_WINDOW_MS", "50")
        yield


@pytest.fixture(scope="module")
def batch_server(loop, tiny_model_dir, registry):
    """One batching port server (the default max_batch=8) over all 3
    blocks, model uid "batch8"."""
    server = port_server(tiny_model_dir[0], registry.port, "batch8", 0, 3)
    assert server.max_batch == 8 and not server.mixed_batch
    run(loop, start_all(server))
    yield server
    run(loop, stop_all(server))


@pytest.fixture(scope="module")
def lockstep_runs(loop, tiny_model_dir, registry, batch_server, window_50ms):
    """The lockstep run on the batching server and on a max_batch=1
    server: (tokens, logits, lens, counter deltas, rpc_info) each."""
    model_dir, _, config = tiny_model_dir
    prompts = lockstep_prompts(config)
    unbatched = port_server(model_dir, registry.port, "batch1", 0, 3,
                            max_batch=1)
    run(loop, start_all(unbatched))
    runs = {}
    try:
        for name, server in (("batched", batch_server),
                             ("unbatched", unbatched)):
            model = port_client(model_dir, registry.port, server.model_uid)
            before = counters(server)
            lens = []
            tokens, logits = run(loop, lockstep(
                model, prompts, inspect=lambda s=server: lens.extend(
                    session_lens(s)
                ),
            ))

            async def info(server=server):
                conn = await t_rpc.connect("127.0.0.1", server.port)
                try:
                    return (await conn.call("rpc_info", {}))[0]
                finally:
                    await conn.close()

            runs[name] = (tokens, logits, lens, delta(server, before),
                          run(loop, info()))
    finally:
        run(loop, stop_all(unbatched))
    return prompts, runs


# ------------------------------------------------------------ decode groups
def test_lockstep_sessions_share_one_dispatch_per_round(tiny_model_dir,
                                                        lockstep_runs):
    """4 lockstep sessions: each decode round costs about one merged
    dispatch (width >= 3) and every session's tokens equal HF greedy."""
    prompts, runs = lockstep_runs
    tokens, _, lens, d, info = runs["batched"]
    assert_hf(tiny_model_dir[1], prompts, tokens)
    assert d["batched_steps"] + d["batch_solo_steps"] == N * ROUNDS
    assert d["batch_dispatches"] + d["batch_solo_steps"] <= ROUNDS + 2
    assert d["batched_steps"] / max(d["batch_dispatches"], 1) >= 3.0
    assert lens == sorted(p.shape[1] + ROUNDS for p in prompts)
    assert info["batched_steps"] >= d["batched_steps"]
    assert info["mean_batch_width"] == pytest.approx(
        info["batched_steps"] / info["batch_dispatches"]
    )
    assert info["queue_wait_ms"]["decode"]["p95"] >= 0.0
    assert set(BATCH_KEYS) <= set(info)


def test_batched_matches_unbatched(tiny_model_dir, lockstep_runs):
    """max_batch=1 really disables the batcher; max_batch=8 gives the same
    tokens and context lengths, with logits within 1e-5 (f32)."""
    prompts, runs = lockstep_runs
    tok_b, logits_b, lens_b, d_b, _ = runs["batched"]
    tok_u, logits_u, lens_u, d_u, info_u = runs["unbatched"]
    assert d_u["batched_steps"] == d_u["batch_dispatches"] == 0
    assert info_u["mean_batch_width"] == 0.0
    assert d_b["batched_steps"] > 0
    assert lens_b == lens_u
    for tb, tu, lb, lu in zip(tok_b, tok_u, logits_b, logits_u):
        np.testing.assert_array_equal(tb, tu)
        np.testing.assert_allclose(lb, lu, atol=EPS, rtol=0)


def test_jax_client_through_batching_port_server(
    loop, tiny_model_dir, registry, batch_server, window_50ms
):
    """The JAX client's 4 lockstep sessions batch on a port server."""
    model_dir, hf_model, config = tiny_model_dir
    prompts = lockstep_prompts(config, seed=3)
    before = counters(batch_server)
    model = jax_client(model_dir, registry.port, "batch8")
    tokens, _ = run(loop, lockstep(model, prompts))
    assert_hf(hf_model, prompts, tokens)
    d = delta(batch_server, before)
    assert d["batched_steps"] + d["batch_solo_steps"] == N * ROUNDS
    assert d["batched_steps"] / max(d["batch_dispatches"], 1) >= 3.0


def test_mixed_chain_batching_matches_all_jax(
    loop, tiny_model_dir, registry, window_50ms
):
    """A JAX span [0, 2) then a port span [2, 3), both batching (push),
    serve the port client's 4 lockstep sessions: HF tokens, and logits
    within 1e-5 of the JAX client's through two JAX servers. Both packages'
    rpc_info carry the same batching keys."""
    model_dir, hf_model, config = tiny_model_dir
    prompts = lockstep_prompts(config, seed=5)
    mixed = [jax_server(model_dir, registry.port, "mixb", 0, 2),
             port_server(model_dir, registry.port, "mixb", 2, 3)]
    all_jax = [jax_server(model_dir, registry.port, "jaxb", 0, 2),
               jax_server(model_dir, registry.port, "jaxb", 2, 3)]
    run(loop, start_all(*mixed, *all_jax))

    async def infos():
        got = []
        for server in mixed:
            conn = await t_rpc.connect("127.0.0.1", server.port)
            try:
                got.append((await conn.call("rpc_info", {}))[0])
            finally:
                await conn.close()
        return got

    try:
        tokens, logits = run(loop, lockstep(
            port_client(model_dir, registry.port, "mixb"), prompts
        ))
        _, want = run(loop, lockstep(
            jax_client(model_dir, registry.port, "jaxb"), prompts
        ))
        info_jax, info_port = run(loop, infos())
    finally:
        run(loop, stop_all(*mixed, *all_jax))
    assert_hf(hf_model, prompts, tokens)
    for got, ref in zip(logits, want):
        np.testing.assert_allclose(got, ref, atol=EPS, rtol=0)
    for info in (info_jax, info_port):
        assert info["batch_dispatches"] > 0
        assert info["batched_steps"] + info["batch_solo_steps"] == N * ROUNDS
    assert set(BATCH_KEYS) <= set(info_jax) & set(info_port)
    for key in BATCH_KEYS:
        assert type(info_port[key]) is type(info_jax[key]), key


# -------------------------------------------------------- a failed group
def flaky(monkeypatch, executor, name):
    """Make executor.<name> raise once, after its call wrote the KV."""
    orig = getattr(executor, name)
    calls = {"n": 0}

    def once(*a, **kw):
        out = orig(*a, **kw)
        if calls["n"] == 0:
            calls["n"] += 1
            raise RuntimeError("injected post-write fault")
        return out

    monkeypatch.setattr(executor, name, once)
    return calls


def test_failed_decode_group_replays_solo(
    loop, tiny_model_dir, registry, batch_server, lockstep_runs,
    monkeypatch, caplog,
):
    """decode_group fails once after writing: the group rolls back, replays
    row by row, and the sessions end with the unbatched run's tokens and
    context lengths (no ghost tokens)."""
    model_dir, _, _ = tiny_model_dir
    prompts, runs = lockstep_runs
    tok_u, logits_u, lens_u, _, _ = runs["unbatched"]
    calls = flaky(monkeypatch, batch_server.executor, "decode_group")
    before = counters(batch_server)
    lens = []
    with caplog.at_level(logging.WARNING, logger=t_server.__name__):
        tokens, logits = run(loop, lockstep(
            port_client(model_dir, registry.port, "batch8"), prompts,
            inspect=lambda: lens.extend(session_lens(batch_server)),
        ))
    assert calls["n"] == 1
    assert "replaying row-by-row" in caplog.text
    d = delta(batch_server, before)
    assert d["batch_solo_steps"] >= 2
    assert lens == lens_u
    for t, tu, lg, lu in zip(tokens, tok_u, logits, logits_u):
        np.testing.assert_array_equal(t, tu)
        np.testing.assert_allclose(lg, lu, atol=EPS, rtol=0)


def test_failed_ragged_group_rolls_back_per_kind(tiny_model_dir,
                                                 monkeypatch, caplog):
    """ragged_group fails once after writing 2 decodes and a chunk: the
    decodes roll back and the chunk is truncated to its pre-dispatch
    length (its stream's earlier speculative chunk survives, which a
    rollback would discard); the solo replays give the clean-state solo
    outputs, and every length equals the unfailed path's."""
    model_dir, _, config = tiny_model_dir
    d = config.hidden_size
    s = BlockServer(
        model_uid="rb", start=0, end=3, model_dir=model_dir,
        compute_dtype=torch.float32, num_pages=64, page_size=4,
        mixed_batch=True, prefill_chunk=4, device="cpu",
    )
    rng = np.random.default_rng(3)

    def hid(t):
        return torch.from_numpy(
            (rng.standard_normal((1, t, d)) * 0.1).astype(np.float32)
        )

    async def go():
        async with s.manager.allocate(1, 32) as h_a, \
                s.manager.allocate(1, 32) as h_b, \
                s.manager.allocate(1, 32) as h_c:
            handles = (h_a, h_b, h_c)
            for h in handles:
                s.executor.prefill(h, hid(6))
            sessions = [_Session(f"rb-{i}", h, 1)
                        for i, h in enumerate(handles)]
            # the chunk stream's first chunk, written speculatively
            s._compute_prefill_chunk(sessions[2], h_c, hid(4), False)
            snaps = [s.manager.context_lens(h).tolist() for h in handles]
            dec = [hid(1), hid(1)]
            chunk = hid(4)
            refs = []
            for sess, h, x in zip(sessions[:2], handles[:2], dec):
                refs.append(s._compute_step(sess, h, x, False, None)[0])
            refs.append(s._compute_prefill_chunk(sessions[2], h_c, chunk,
                                                 False)[0])
            for h, snap in zip(handles, snaps):
                s.manager.truncate_speculative(h, snap)
            calls = flaky(monkeypatch, s.executor, "ragged_group")
            members = [
                _BatchMember(sessions[0], h_a, dec[0]),
                _ChunkMember(sessions[2], h_c, chunk, False),
                _BatchMember(sessions[1], h_b, dec[1]),
            ]
            outs = s._compute_ragged_group(members)
            lens = [s.manager.context_lens(h).tolist() for h in handles]
            committed = [s.manager.context_lens(h, committed_only=True)
                         .tolist() for h in handles]
            return calls, refs, outs, snaps, lens, committed

    with caplog.at_level(logging.WARNING, logger=t_server.__name__):
        calls, refs, outs, snaps, lens, committed = asyncio.run(go())
    assert calls["n"] == 1 and "replaying solo" in caplog.text
    assert not any(isinstance(o, Exception) for o in outs)
    for (got, _), want in zip(
        (outs[0], outs[2], outs[1]), refs
    ):
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=EPS,
                                   rtol=0)
    assert snaps == [[6], [6], [10]]
    # decodes committed one token each; the chunk wrote its 4 on top of
    # the earlier chunk's 4 and stays speculative (not its last chunk)
    assert lens == [[7], [7], [14]]
    assert committed == [[7], [7], [6]]
    assert s.batch_solo_steps == 2 and s.mixed_dispatches == 0


# ---------------------------------------------------------- chunked prefill
def test_chunked_prefill_token_identical(loop, tiny_model_dir, registry,
                                         batch_server, monkeypatch):
    """A 13-token prompt in 4-token chunks through two port spans (one
    chunking by its constructor, one by BBTPU_PREFILL_CHUNK): HF tokens,
    the monolithic server's tokens, 4 chunks of 13 tokens on each span,
    and no mixed dispatch (mixed batch is off by default)."""
    model_dir, hf_model, config = tiny_model_dir
    input_ids = (np.arange(13)[None, :] * 5 + 3) % config.vocab_size
    monkeypatch.setenv("BBTPU_PREFILL_CHUNK", "4")
    servers = [
        port_server(model_dir, registry.port, "chunk4", 0, 2,
                    prefill_chunk=4),
        port_server(model_dir, registry.port, "chunk4", 2, 3),
    ]
    run(loop, start_all(*servers))
    try:
        ids = run(loop, port_client(
            model_dir, registry.port, "chunk4", use_push=False
        ).generate(input_ids, max_new_tokens=6))
        mono = run(loop, port_client(
            model_dir, registry.port, "batch8"
        ).generate(input_ids, max_new_tokens=6))
    finally:
        run(loop, stop_all(*servers))
    np.testing.assert_array_equal(ids.numpy(), hf_greedy(hf_model,
                                                         input_ids, 6))
    np.testing.assert_array_equal(ids.numpy(), mono.numpy())
    for s in servers:
        assert (s.prefill_chunks, s.prefill_chunk_tokens) == (4, 13)
        assert s.decode_steps_interleaved == 0  # nothing concurrent
        assert s.mixed_batch is False and s.mixed_dispatches == 0
        assert s.manager.table.free_pages == s.manager.table.num_pages


async def interleaved(model, config, n_long=40):
    """Two sessions decode continuously while a third prefills an
    `n_long`-token prompt; returns (the decoders' prompts and tokens, the
    long prompt and its 4 tokens)."""
    rng = np.random.default_rng(5)
    dec_prompts = [rng.integers(0, config.vocab_size, size=(1, 5 + i))
                   for i in range(2)]
    long_ids = (np.arange(n_long)[None, :] * 5 + 3) % config.vocab_size

    def greedy(out):
        return model.logits(out)[:, -1].argmax(-1)

    async with model.inference_session(40, 1) as s0, \
            model.inference_session(40, 1) as s1, \
            model.inference_session(48, 1) as long_sess:
        dec_sessions = (s0, s1)
        generated = [
            [greedy(await sess.step(model.embed(p)))]
            for sess, p in zip(dec_sessions, dec_prompts)
        ]
        prefill_done = asyncio.Event()

        async def decode_loop(i):
            while not prefill_done.is_set() and len(generated[i]) < 28:
                out = await dec_sessions[i].step(
                    model.embed(generated[i][-1][:, None])
                )
                generated[i].append(greedy(out))

        async def long_prefill():
            try:
                return await long_sess.step(model.embed(long_ids))
            finally:
                prefill_done.set()

        out_long, _, _ = await asyncio.gather(
            long_prefill(), decode_loop(0), decode_loop(1)
        )
        got_long = [greedy(out_long)]
        for _ in range(3):
            got_long.append(greedy(await long_sess.step(
                model.embed(got_long[-1][:, None])
            )))
    return (
        [(p, torch.cat(g).numpy()) for p, g in zip(dec_prompts, generated)],
        (long_ids, torch.cat(got_long).numpy()),
    )


@pytest.mark.parametrize("mixed", [False, True], ids=["chunked", "mixed"])
def test_decodes_interleave_with_chunks(loop, tiny_model_dir, registry,
                                        monkeypatch, mixed):
    """Two sessions decode while a third prefills 40 tokens in 4-token
    chunks. Chunked: decode steps run between chunks
    (decode_steps_interleaved > 0). Mixed (BBTPU_BATCH_WINDOW_MS=8): decode
    steps fuse INTO the chunks' ragged dispatches (mixed_dispatches > 0,
    each carrying a chunk and >= 1 decode). Every session stays HF-exact
    and no page leaks."""
    model_dir, hf_model, config = tiny_model_dir
    monkeypatch.setenv("BBTPU_BATCH_WINDOW_MS", "8" if mixed else "0")
    uid = f"interleave-{mixed}"
    server = port_server(model_dir, registry.port, uid, 0, 3,
                         prefill_chunk=4, mixed_batch=mixed)
    run(loop, start_all(server))
    try:
        model = port_client(model_dir, registry.port, uid)
        decoders, (long_ids, got_long) = run(
            loop, interleaved(model, config)
        )
        run(loop, asyncio.sleep(0.2))  # the server's teardown is async
        table = server.manager.table
        assert table.free_pages == table.num_pages
    finally:
        run(loop, stop_all(server))
    assert server.prefill_chunks >= 10
    assert server.decode_steps_interleaved > 0
    if mixed:
        assert server.mixed_batch is True and server.mixed_dispatches > 0
        assert server.mixed_tokens >= 2 * server.mixed_dispatches
        assert (server.ragged_cross_kind_dispatches
                == server.ragged_group_dispatches == server.mixed_dispatches)
        assert server.step_dispatches < server.step_tokens
    else:
        assert server.mixed_dispatches == 0
    ref = hf_greedy(hf_model, long_ids, 4)
    np.testing.assert_array_equal(got_long, ref[0, long_ids.shape[1]:])
    for p, got in decoders:
        ref = hf_greedy(hf_model, p, len(got))
        np.testing.assert_array_equal(got, ref[0, p.shape[1]:])


def test_mixed_batch_off_by_default(tiny_model_dir, monkeypatch):
    """Mixed batch is off unless asked (BBTPU_MIXED_BATCH or the argument);
    on, the chunk rides one extra group slot and the kind-aware predicate
    gathers."""
    kw = dict(model_uid="mixflag", start=0, end=3,
              model_dir=tiny_model_dir[0], compute_dtype=torch.float32,
              num_pages=8, page_size=4, device="cpu")
    off = BlockServer(**kw)
    assert off.mixed_batch is False and off.compute.compat is None
    assert off.compute.max_group == 8
    monkeypatch.setenv("BBTPU_MIXED_BATCH", "1")
    on = BlockServer(**kw)
    assert on.mixed_batch is True and on.ragged_declines == {}
    assert on.compute.max_group == 9
    assert on.compute.compat == on._ragged_compat
    assert BlockServer(**kw, mixed_batch=False).mixed_batch is False


def test_deadline_abort_mid_stream_frees_partial_pages(
    tiny_model_dir, monkeypatch
):
    """A client deadline expiring between chunks aborts the stream: the
    step is dropped (deadlines_expired, no reply) and the rollback frees
    every speculative page the completed chunks wrote."""
    model_dir, _, config = tiny_model_dir

    class FakeStream:
        def __init__(self):
            self.sent = []

        async def send(self, msg, tensors=None):
            self.sent.append(msg)

    s = BlockServer(
        model_uid="dl", start=0, end=3, model_dir=model_dir,
        compute_dtype=torch.float32, num_pages=64, page_size=4,
        prefill_chunk=4, device="cpu",
    )
    orig = s.executor.prefill_chunk

    def slow_chunk(handle, hidden, **kw):
        # 4 chunks x 60 virtual ms >> the 100 ms budget
        clock.sleep(0.06)
        return orig(handle, hidden, **kw)

    monkeypatch.setattr(s.executor, "prefill_chunk", slow_chunk)

    async def go():
        s.compute.start()
        try:
            async with s.manager.allocate(1, 17, timeout=5.0) as handle:
                stream = FakeStream()
                await s._run_step(
                    _Session("dl", handle, 1), stream,
                    {"step": 0, "deadline_s": 0.1, "commit": True},
                    [torch.zeros((1, 16, config.hidden_size))],
                )
                return stream.sent, s.manager.context_lens(handle).tolist()
        finally:
            await s.compute.stop()

    # the deadline, the chunk sleeps and the expiry checks read one
    # installed clock: a 2x scale keeps every comparison, halves the wait
    prev = clock.install(clock.ScaledClock(scale=2.0))
    try:
        sent, lens = asyncio.run(go())
    finally:
        clock.install(prev)
    assert s.deadlines_expired == 1 and sent == []
    assert 1 <= s.prefill_chunks < 4  # some chunks ran, then the abort
    assert lens == [0]
    assert s.manager.table.free_pages == s.manager.table.num_pages


# --------------------------------------------------- gather predicates
def member(kind, layers=None, dtype="float32", t=4):
    key = (kind, layers, None, dtype) + ((t,) if kind == "chunkm" else ())
    return types.SimpleNamespace(key=key)


KEY_POOL = [
    member("decode1"), member("decode1", layers=(0, 2)),
    member("decode1", dtype="bfloat16"), member("chunkm"),
    member("chunkm", t=2), member("chunkm", layers=(0, 2)),
]


@pytest.mark.parametrize("mixed_batch,max_batch",
                         list(itertools.product([False, True], [1, 2, 3])))
def test_ragged_compat_and_group_hint_match_jax(mixed_batch, max_batch):
    """On every group of up to 3 decode/chunk members from a pool of keys
    (layers, dtype and chunk length varied) and every candidate, the
    port's predicate and gather bound answer as the JAX server's (spec
    batch off, no tree members)."""
    jax_self = types.SimpleNamespace(
        mixed_batch=mixed_batch, spec_batch=False, max_batch=max_batch,
        _sessions={
            sid: types.SimpleNamespace(speculating=sid == "b")
            for sid in "abc"
        },
    )
    port_self = types.SimpleNamespace(
        mixed_batch=mixed_batch, spec_batch=False, max_batch=max_batch,
        _sessions=jax_self._sessions,
    )
    checked = 0
    for n in (1, 2, 3):
        for group in itertools.product(KEY_POOL, repeat=n):
            group = list(group)
            assert BlockServer._batch_group_hint(port_self, group) == \
                JaxServer._batch_group_hint(jax_self, group)
            for cand in KEY_POOL:
                want = JaxServer._ragged_compat(jax_self, group, cand)
                got = BlockServer._ragged_compat(port_self, group, cand)
                assert got == want, (group, cand)
                checked += 1
    assert BlockServer._batch_group_hint(port_self) == \
        JaxServer._batch_group_hint(jax_self) == 3
    assert checked == 6 * (6 + 36 + 216)

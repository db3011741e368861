"""The port's server-side multi-step decode (decode_n) on the CPU, against
the JAX package and HF (the analogs of tests/test_decode_n.py).

- `decode_loop_impl` against the JAX `decode_loop_impl` on the same
  parameters and plans, dense and paged (the JAX kernel in interpret
  mode, the port's plain version): identical tokens, arenas within 1e-5;
- `SpanExecutor.decode_n` against the JAX executor's, for a call that
  starts below BBTPU_PAGED_MIN_CONTEXT and ends above it with an EOS
  inside the call, and for one over the paged route;
- port servers and the port client (the tiny Llama of
  tests/test_torch_server.py, f32, page_size 4): fused, chained over two
  and three spans, batched, with EOS, a declining tail, a middle span
  that dies between calls, the stepped flavor over an int4 arena, an EOS
  mid-chunk with session reuse, a server without client parameters; each
  against HF greedy and the per-step path;
- interop: the JAX client's server_decode through port servers, the port
  client's through JAX servers, and mixed JAX/port chains, each giving
  the all-JAX chain's tokens;
- leases: a session whose chained call failed after committing KV, on a
  stream that died before the decline reached the client, is not resumed:
  the client replays.

Every networked test bounds itself (`run(..., timeout)`: at most 60 s).
"""

import asyncio

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bloombee_tpu.client.config import ClientConfig as JaxConfig
from bloombee_tpu.client.model import (
    DistributedModelForCausalLM as JaxModel,
)
from bloombee_tpu.runtime import decode_loop as j_loop
from bloombee_tpu.runtime.step import pack_plan
from bloombee_tpu.swarm import registry as j_registry
from bloombee_tpu_torch.client import ClientConfig, DistributedModelForCausalLM
from bloombee_tpu_torch.client.session import DecodeNUnsupported
from bloombee_tpu_torch.kv.arena import write_plan
from bloombee_tpu_torch.models.checkpoint import load_span_params
from bloombee_tpu_torch.runtime import decode_loop as t_loop
from bloombee_tpu_torch.server.block_server import BlockServer
from bloombee_tpu_torch.swarm.registry import RegistryClient
from test_torch_server import (  # noqa: F401  (fixtures)
    REGISTRY_CLIENTS,
    hf_greedy,
    jax_server,
    loop,
    port_server,
    registry,
    start_all,
    stop_all,
    tiny_model_dir,
)
from test_torch_slice import (
    JaxSide,
    TorchSide,
    count_routes,
    model_and_inputs,
)

LIMIT = 60  # seconds: every networked test fails instead of stalling
ARENA_TOL = 1e-5


def run(loop, coro, timeout=LIMIT):
    return asyncio.run_coroutine_threadsafe(coro, loop).result(timeout)


# ------------------------------------------------------- executor level
def sides():
    """The JAX and the port executor of test_torch_slice (2 layers, f32,
    64 pages of 16) over the same weights."""
    params, client, _ = model_and_inputs()
    return JaxSide(params, client), TorchSide(params, client)


def with_sessions(prompt, body):
    """Run `body(js, ts, jax handle, port handle)` with one session of
    `prompt` ([B, T] ids) prefilled on each executor; returns its
    result."""
    js, ts = sides()

    async def go():
        b = prompt.shape[0]
        async with js.manager.allocate(b, 160) as jh, \
                ts.manager.allocate(b, 160) as th:
            js.ex.prefill(jh, js.embed(prompt))
            ts.ex.prefill(th, ts.embed(prompt))
            return body(js, ts, jh, th)

    return asyncio.run(go())


def arenas_close(js, ts):
    for name in ("k", "v"):
        np.testing.assert_allclose(
            ts.manager.arena[name].numpy(),
            np.asarray(js.manager.arena[name]), atol=ARENA_TOL, rtol=0,
        )


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_decode_loop_matches_jax(paged):
    """The same 4 plans (the slots, page table, positions and lengths of 4
    committed steps of a batch of 3, padded to the batch bucket 4) through
    both loops: the same tokens, the arenas within 1e-5."""
    prompt = np.random.default_rng(5).integers(0, 96, (3, 40))
    n, b, bb, pb = 4, 3, 4, 4

    def body(js, ts, jh, th):
        oob = ts.manager.capacity_tokens
        packed, plans = [], []
        for _ in range(n):
            js.manager.write_slots(jh, 1, commit=True)
            slots = ts.manager.write_slots(th, 1, commit=True)
            lens = ts.manager.context_lens(th)
            np.testing.assert_array_equal(js.manager.context_lens(jh), lens)
            slots_pad = np.full((bb, 1), oob, np.int32)
            slots_pad[:b, 0] = slots
            pt = np.zeros((bb, pb), np.int32)
            pt[:b] = ts.manager.page_table(th, pb)
            lens_pad = np.zeros((bb,), np.int32)
            lens_pad[:b] = lens
            pos = np.zeros((bb, 1), np.int32)
            pos[:b, 0] = lens - 1
            packed.append(pack_plan(slots_pad, pt, pos, lens_pad,
                                    np.ones((2,), np.int32)))
            plans.append(t_loop.StepPlan(
                write_plan(slots_pad.reshape(-1), oob, "cpu"),
                torch.from_numpy(pt), torch.from_numpy(pos),
                torch.from_numpy(lens_pad),
            ))
        ids = np.array([3, 17, 41, 0], np.int32)
        fin = np.array([False, False, False, True])
        arena = js.manager.arena
        want, k, v = j_loop.decode_loop(
            js.client, js.ex.params, arena["k"], arena["v"],
            jnp.asarray(ids), jnp.asarray(fin), jnp.asarray(np.stack(packed)),
            spec=js.ex.spec, page_size=16, max_pages=pb,
            compute_dtype=jnp.float32, use_paged=paged,
        )
        js.manager.arena = {"k": k, "v": v}
        arena = ts.manager.arena
        got = t_loop.decode_loop_impl(
            ts.client, ts.ex.params, arena["k"], arena["v"],
            torch.from_numpy(ids).long(), torch.from_numpy(fin), plans,
            np.ones((2,), np.int32), spec=ts.ex.spec, page_size=16,
            compute_dtype=torch.float32, use_paged=paged, rows=b,
        )
        np.testing.assert_array_equal(got[:b].numpy(), np.asarray(want)[:b])
        arenas_close(js, ts)

    with_sessions(prompt, body)


@pytest.mark.parametrize("case", ["crossing_eos", "paged"])
def test_executor_decode_n_matches_jax(monkeypatch, case):
    """`SpanExecutor.decode_n` of both packages on the same session: a
    call that starts below BBTPU_PAGED_MIN_CONTEXT (128; the route stays
    dense) and ends above it with an EOS mid-call, or one that starts
    past it (paged; the JAX kernel in interpret mode). Identical tokens,
    arenas within 1e-5, the lengths advanced by n."""
    crossing = case == "crossing_eos"
    monkeypatch.setenv("BBTPU_PAGED_MIN_CONTEXT", "128" if crossing else "0")
    monkeypatch.setenv("BBTPU_PAGED_INTERPRET", "1")
    prompt = np.random.default_rng(9).integers(
        0, 96, (3, 60 if crossing else 30)
    )
    n = 80 if crossing else 6
    ids = np.array([5, 7, 11])
    fin = np.array([False, False, True])
    eos = None
    if crossing:
        # the port's tokens without EOS pick an EOS that lands mid-call
        free = with_sessions(prompt, lambda js, ts, jh, th: ts.ex.decode_n(
            th, ids, n, ts.client).numpy())
        eos = int(free[0, n // 3])

    def body(js, ts, jh, th):
        want = np.asarray(js.ex.decode_n(
            jh, ids, n, js.client, eos_token_id=eos, finished=fin
        ))
        got = ts.ex.decode_n(th, ids, n, ts.client, eos_token_id=eos,
                             finished=fin).numpy()
        np.testing.assert_array_equal(got, want)
        assert list(ts.manager.context_lens(th)) == [prompt.shape[1] + n] * 3
        arenas_close(js, ts)
        return got

    routes = count_routes(monkeypatch)
    got = with_sessions(prompt, body)
    # the port's route over the call: dense from below the threshold,
    # the paged decode kernel's plain version (2 layers a step) past it
    assert routes.get("paged_decode_attention_reference", 0) == (
        0 if crossing else 2 * n
    )
    if crossing:
        row = list(got[0])
        assert eos in row[: n - 1] and set(row[row.index(eos):]) == {eos}
        assert set(got[2]) == {eos}


def test_executor_decode_n_refuses_an_int4_arena():
    from bloombee_tpu_torch.kv.cache_manager import CacheManager
    from bloombee_tpu_torch.models.llama.block import params_from_jax
    from bloombee_tpu_torch.models.spec import ModelSpec
    from bloombee_tpu_torch.runtime.executor import SpanExecutor
    from test_torch_slice import HD, SPEC

    params, client, _ = model_and_inputs()
    manager = CacheManager(2, 64, 16, 2, HD, dtype=torch.float32,
                           device="cpu", quant="int4")
    ex = SpanExecutor(params_from_jax(params, device="cpu"),
                      ModelSpec(**SPEC), manager,
                      compute_dtype=torch.float32, device="cpu")
    with pytest.raises(ValueError, match="quantized KV arena"):
        ex.decode_n(None, np.zeros(1), 2, {})


# ---------------------------------------------------------- served
def pclient(model_dir, reg_port, uid, **config):
    rc = RegistryClient("127.0.0.1", reg_port)
    REGISTRY_CLIENTS.append(rc)
    config.setdefault("use_push", True)
    return DistributedModelForCausalLM.from_pretrained(
        model_dir, rc, model_uid=uid, device="cpu",
        config=ClientConfig(**config),
    )


def jclient(model_dir, reg_port, uid, **config):
    rc = j_registry.RegistryClient("127.0.0.1", reg_port)
    REGISTRY_CLIENTS.append(rc)
    return JaxModel.from_pretrained(model_dir, rc, model_uid=uid,
                                    config=JaxConfig(**config))


def spans(model_dir, reg_port, uid, bounds, make=None, **kw):
    make = make or port_server
    return [make(model_dir, reg_port, uid, a, b, **kw) for a, b in bounds]


async def greedy_ref(model, input_ids, n_new, max_length=16):
    """Per-step greedy tokens after the prompt's: [B, n_new]."""
    async with model.inference_session(max_length, input_ids.shape[0]) as s:
        out = await s.step(model.embed(input_ids), ids=input_ids)
        cur = model.logits(out[:, -1:])[:, 0].argmax(-1).numpy()
        toks = []
        for _ in range(n_new):
            out = await s.step(model.embed(cur[:, None]), ids=cur[:, None])
            cur = model.logits(out[:, -1:])[:, 0].argmax(-1).numpy()
            toks.append(cur)
    return cur, np.stack(toks, axis=1)


def served(loop, servers, coro_fn, timeout=LIMIT):
    """Start `servers`, run `coro_fn()` on the loop, stop them."""
    async def go():
        await start_all(*servers)
        try:
            return await coro_fn()
        finally:
            await stop_all(*servers)

    return run(loop, go(), timeout)


def test_server_decode_matches_per_step_and_hf(loop, tiny_model_dir,
                                               registry):
    """One whole-model span (the fused loop): server_decode generate ==
    per-step generate == HF greedy over several chunks (chunk 4, 11 new
    tokens: the prefill's token, then 4, 4, 2)."""
    model_dir, hf_model, config = tiny_model_dir
    servers = spans(model_dir, registry.port, "dn-fused", [(0, 3)])
    model = pclient(model_dir, registry.port, "dn-fused",
                    server_decode=True, server_decode_chunk=4)
    x = np.random.default_rng(7).integers(0, config.vocab_size, (2, 5))

    async def go():
        sd = await model.generate(x, max_new_tokens=11)
        ps = await model.generate(x, max_new_tokens=11, server_decode=False)
        return sd, ps, (await servers[0]._rpc_info({}, []))[0]

    sd, ps, info = served(loop, servers, go)
    np.testing.assert_array_equal(sd.numpy(), ps.numpy())
    np.testing.assert_array_equal(sd.numpy(), hf_greedy(hf_model, x, 11))
    assert info["decode_n_calls"] == 3 and info["decode_n_steps"] == 10
    # every call took the device loop, none the stepped one
    assert info["decode_n_fused"] and info["decode_n_fused_calls"] == 3


def test_server_decode_stepped_over_a_dense_arena(loop, tiny_model_dir,
                                                  registry):
    """A whole-model span with the fused loop switched off
    (`decode_n_fused=False`): the stepped loop serves every call over the
    dense arena, with the per-step path's and HF's tokens."""
    model_dir, hf_model, config = tiny_model_dir
    servers = spans(model_dir, registry.port, "dn-stepped", [(0, 3)],
                    decode_n_fused=False)
    model = pclient(model_dir, registry.port, "dn-stepped",
                    server_decode=True, server_decode_chunk=4)
    x = np.random.default_rng(7).integers(0, config.vocab_size, (2, 5))

    async def go():
        sd = await model.generate(x, max_new_tokens=11)
        ps = await model.generate(x, max_new_tokens=11, server_decode=False)
        return sd, ps, (await servers[0]._rpc_info({}, []))[0]

    sd, ps, info = served(loop, servers, go)
    np.testing.assert_array_equal(sd.numpy(), ps.numpy())
    np.testing.assert_array_equal(sd.numpy(), hf_greedy(hf_model, x, 11))
    assert info["decode_n_calls"] == 3 and info["decode_n_steps"] == 10
    assert not info["decode_n_fused"] and info["decode_n_fused_calls"] == 0
    assert "decode_n_fused=False" in info["decode_n_decline"]


@pytest.mark.parametrize("case", [
    "id_past_vocab", "negative_id", "eos_past_vocab", "short_finished",
])
def test_decode_n_declines_malformed_inputs(loop, tiny_model_dir, registry,
                                            case):
    """Ids the loop would embed out of the table's range (the inputs, or
    an EOS the clamp feeds back in) and a `finished` of the wrong length
    are declined before anything commits: the context lengths stay, and
    the session goes on with the per-step tokens."""
    model_dir, _, config = tiny_model_dir
    vocab = config.vocab_size
    servers = spans(model_dir, registry.port, "dn-malformed", [(0, 3)])
    model = pclient(model_dir, registry.port, "dn-malformed")
    x = np.random.default_rng(43).integers(0, vocab, (2, 4))
    bad = {
        "id_past_vocab": dict(ids=np.array([1, vocab])),
        "negative_id": dict(ids=np.array([-1, 1])),
        "eos_past_vocab": dict(eos_token_id=vocab),
        "short_finished": dict(finished=np.array([True])),
    }[case]

    async def go():
        _, ref = await greedy_ref(model, x, 3)
        async with model.inference_session(16, 2) as sess:
            out = await sess.step(model.embed(x), ids=x)
            first = model.logits(out[:, -1:])[:, 0].argmax(-1).numpy()
            (srv_sess,) = servers[0]._sessions.values()
            lens = servers[0].manager.context_lens(srv_sess.handle).tolist()
            kw = dict(bad)
            with pytest.raises(DecodeNUnsupported, match="decode_n|eos"):
                await sess.decode_n(kw.pop("ids", first), 3, **kw)
            after = servers[0].manager.context_lens(srv_sess.handle).tolist()
            position = sess.position
            got = await sess.decode_n(first, 3)
        return ref, got, lens, after, position

    ref, got, lens, after, position = served(loop, servers, go)
    assert after == lens == [x.shape[1]] * 2
    assert position == x.shape[1]
    np.testing.assert_array_equal(got, ref)


def test_server_decode_chained_two_spans(loop, tiny_model_dir, registry):
    """Two spans run CHAINED decode_n: span 0 embeds and coordinates, the
    tail selects and pushes ids back, one client round trip a chunk; the
    tokens are HF's and decode_n really ran."""
    model_dir, hf_model, config = tiny_model_dir
    servers = spans(model_dir, registry.port, "dn-chain2", [(0, 2), (2, 3)])
    model = pclient(model_dir, registry.port, "dn-chain2",
                    server_decode=True, server_decode_chunk=4)
    x = np.random.default_rng(3).integers(0, config.vocab_size, (1, 4))

    async def go():
        async with model.inference_session(16, 1) as sess:
            assert len(sess._spans) == 2
            ids = await model.generate(x, max_new_tokens=6, session=sess)
            return ids, [t for t in sess.timings if t.get("decode_n")]

    ids, dn = served(loop, servers, go)
    assert dn, "chained decode_n was not used"
    np.testing.assert_array_equal(ids.numpy(), hf_greedy(hf_model, x, 6))
    assert [s.decode_n_steps for s in servers] == [5, 5]


def test_chained_decode_three_spans_batched_eos(loop, tiny_model_dir,
                                                registry):
    """Three spans (a MIDDLE hop), a batch of 2, at the session level:
    chunks of decode_n give the per-step tokens; rows already finished
    clamp to eos through the chain."""
    model_dir, _, config = tiny_model_dir
    servers = spans(model_dir, registry.port, "dn-chain3",
                    [(0, 1), (1, 2), (2, 3)])
    model = pclient(model_dir, registry.port, "dn-chain3")
    x = np.random.default_rng(17).integers(0, config.vocab_size, (2, 4))

    async def go():
        _, ref = await greedy_ref(model, x, 5)
        async with model.inference_session(16, 2) as sess:
            assert len(sess._spans) == 3
            out = await sess.step(model.embed(x), ids=x)
            first = model.logits(out[:, -1:])[:, 0].argmax(-1).numpy()
            t1 = await sess.decode_n(first, 3)
            t2 = await sess.decode_n(t1[:, -1], 2)
            assert sess.position == x.shape[1] + 5
        async with model.inference_session(16, 2) as sess:
            await sess.step(model.embed(x), ids=x)
            fin = await sess.decode_n(np.array([1, 2]), 4, eos_token_id=5,
                                      finished=np.array([True, True]))
        return ref, np.concatenate([t1, t2], axis=1), fin

    ref, got, fin = served(loop, servers, go)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(fin, np.full((2, 4), 5))


def test_chained_decode_dirty_fallback_on_tail_without_params(
    loop, tiny_model_dir, registry
):
    """The tail has no norm/head parameters: the chain declines dirty after
    span 0 committed a token; the client rebuilds, replays, goes on per
    step and still gives HF's tokens."""
    model_dir, hf_model, config = tiny_model_dir
    params, spec = load_span_params(model_dir, 2, 3, dtype=torch.float32,
                                    device="cpu")
    tail = BlockServer(  # in-memory params: no model_dir, so no head
        model_uid="dn-nohead", start=2, end=3, params=params, spec=spec,
        registry=RegistryClient("127.0.0.1", registry.port),
        compute_dtype=torch.float32, num_pages=64, page_size=4,
        throughput=1.0, device="cpu",
    )
    servers = [port_server(model_dir, registry.port, "dn-nohead", 0, 2), tail]
    model = pclient(model_dir, registry.port, "dn-nohead",
                    server_decode=True, server_decode_chunk=4)
    x = np.random.default_rng(23).integers(0, config.vocab_size, (1, 4))

    async def go():
        return await model.generate(x, max_new_tokens=6)

    ids = served(loop, servers, go)
    np.testing.assert_array_equal(ids.numpy(), hf_greedy(hf_model, x, 6))


def test_chained_decode_mid_span_death_recovers(loop, tiny_model_dir,
                                                registry):
    """The middle server dies between two calls: the transient decline
    (or the dead push) makes the client rebuild and replay onto a
    replacement and RETRY chained decode, with the per-step tokens."""
    model_dir, _, config = tiny_model_dir
    uid = "dn-death"
    s1, s2, s3 = spans(model_dir, registry.port, uid,
                       [(0, 1), (1, 2), (2, 3)])
    s2b = port_server(model_dir, registry.port, uid, 1, 2)
    model = pclient(model_dir, registry.port, uid)
    x = np.random.default_rng(31).integers(0, config.vocab_size, (2, 4))

    async def go():
        await start_all(s1, s2, s3)
        try:
            _, ref = await greedy_ref(model, x, 8, max_length=40)
            sess = model.inference_session(40, 2)
            async with sess:
                out = await sess.step(model.embed(x), ids=x)
                first = model.logits(out[:, -1:])[:, 0].argmax(-1).numpy()
                t1 = await sess.decode_n(first, 4)
                await stop_all(s2)  # the middle hop dies between calls
                await start_all(s2b)
                t2 = await sess.decode_n(t1[:, -1], 4)
                dn = [t for t in sess.timings if t.get("decode_n")]
            return ref, np.concatenate([t1, t2], axis=1), dn
        finally:
            await stop_all(s1, s3, s2b)

    ref, got, dn = run(loop, go())
    assert len(dn) >= 2, "the retry did not go back through decode_n"
    np.testing.assert_array_equal(got, ref)


def test_local_stepped_decode_n_with_int4_kv(loop, tiny_model_dir,
                                             registry):
    """One server with an int4 arena: the fused loop declines, the stepped
    loop serves decode_n with the per-step path's tokens on the same
    (quantized) server."""
    model_dir, _, config = tiny_model_dir
    servers = spans(model_dir, registry.port, "dn-int4", [(0, 3)],
                    kv_quant="int4")
    assert servers[0]._decode_n_ineligible() == "quantized KV arena"
    model = pclient(model_dir, registry.port, "dn-int4")
    x = np.random.default_rng(29).integers(0, config.vocab_size, (2, 4))

    async def go():
        _, ref = await greedy_ref(model, x, 4)
        async with model.inference_session(16, 2) as sess:
            out = await sess.step(model.embed(x), ids=x)
            first = model.logits(out[:, -1:])[:, 0].argmax(-1).numpy()
            return ref, await sess.decode_n(first, 4)

    ref, got = served(loop, servers, go)
    np.testing.assert_array_equal(got, ref)
    assert servers[0].decode_n_steps == 4
    assert servers[0].decode_n_fused_calls == 0


def test_decode_n_session_level_exactness_and_eos(loop, tiny_model_dir,
                                                  registry):
    """Session decode_n on one span vs the per-step loop: the same tokens
    and position; finished rows clamp to eos."""
    model_dir, _, config = tiny_model_dir
    servers = spans(model_dir, registry.port, "dn-session", [(0, 3)])
    model = pclient(model_dir, registry.port, "dn-session")
    x = np.random.default_rng(11).integers(0, config.vocab_size, (2, 4))

    async def go():
        _, ref = await greedy_ref(model, x, 5)
        async with model.inference_session(16, 2) as sess:
            out = await sess.step(model.embed(x), ids=x)
            first = model.logits(out[:, -1:])[:, 0].argmax(-1).numpy()
            t1 = await sess.decode_n(first, 3)
            t2 = await sess.decode_n(t1[:, -1], 2)
            assert sess.position == x.shape[1] + 5
        async with model.inference_session(16, 2) as sess:
            await sess.step(model.embed(x), ids=x)
            fin = await sess.decode_n(np.array([1, 2]), 4, eos_token_id=5,
                                      finished=np.array([True, True]))
        return ref, np.concatenate([t1, t2], axis=1), fin

    ref, got, fin = served(loop, servers, go)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(fin, np.full((2, 4), 5))


def test_server_decode_eos_mid_chunk_and_session_reuse(loop, tiny_model_dir,
                                                       registry):
    """An EOS mid-chunk: the output stops where the per-step loop stops,
    and a REUSED session sees the same context (the over-run KV is rewound
    by a rebuild and replay)."""
    model_dir, _, config = tiny_model_dir
    servers = spans(model_dir, registry.port, "dn-eos", [(0, 3)])
    model = pclient(model_dir, registry.port, "dn-eos",
                    server_decode=True, server_decode_chunk=4)
    rng = np.random.default_rng(13)
    x = rng.integers(0, config.vocab_size, (1, 4))
    y = rng.integers(0, config.vocab_size, (1, 3))

    async def go():
        plain = await model.generate(x, max_new_tokens=8,
                                     server_decode=False)
        # the 3rd new token as "eos": it lands mid-chunk (the prefill's
        # token, then a chunk of 4 -> its column 1)
        eos = int(plain[0, x.shape[1] + 2])
        ps = await model.generate(x, max_new_tokens=8, eos_token_id=eos,
                                  server_decode=False)
        sd = await model.generate(x, max_new_tokens=8, eos_token_id=eos,
                                  server_decode=True)

        async def two_turns(server_decode):
            async with model.inference_session(40, 1) as sess:
                a1 = await model.generate(
                    x, max_new_tokens=8, eos_token_id=eos, session=sess,
                    server_decode=server_decode,
                )
                a2 = await model.generate(
                    y, max_new_tokens=5, session=sess,
                    server_decode=server_decode,
                )
            return a1, a2

        return ps, sd, await two_turns(True), await two_turns(False)

    ps, sd, (sd1, sd2), (ps1, ps2) = served(loop, servers, go)
    np.testing.assert_array_equal(sd.numpy(), ps.numpy())
    np.testing.assert_array_equal(sd1.numpy(), ps1.numpy())
    np.testing.assert_array_equal(sd2.numpy(), ps2.numpy())


def test_decode_n_declined_without_client_params(loop, tiny_model_dir,
                                                 registry):
    """A server from in-memory params (no model_dir, no client_params)
    declines decode_n instead of failing the stream, and generate with
    server_decode goes on per step on the same session with HF's
    tokens."""
    model_dir, hf_model, config = tiny_model_dir
    params, spec = load_span_params(model_dir, 0, 3, dtype=torch.float32,
                                    device="cpu")
    server = BlockServer(
        model_uid="dn-noparams", start=0, end=3, params=params, spec=spec,
        registry=RegistryClient("127.0.0.1", registry.port),
        compute_dtype=torch.float32, num_pages=64, page_size=4,
        throughput=1.0, device="cpu",
    )
    model = pclient(model_dir, registry.port, "dn-noparams")
    x = np.random.default_rng(5).integers(0, config.vocab_size, (2, 4))

    async def go():
        async with model.inference_session(16, 1) as sess:
            ids = np.array([[3, 4, 5]])
            await sess.step(model.embed(ids), ids=ids)
            with pytest.raises(DecodeNUnsupported, match="no embed"):
                await sess.decode_n(np.array([1]), 2)
        info = (await server._rpc_info({}, []))[0]
        return await model.generate(x, max_new_tokens=6,
                                    server_decode=True), info

    ids, info = served(loop, [server], go)
    np.testing.assert_array_equal(ids.numpy(), hf_greedy(hf_model, x, 6))
    assert info["decode_n"] is False and info["decode_n_max"] == 256
    assert "no embed" in info["decode_n_decline"]


# ---------------------------------------------------------- interop
X_INTEROP = np.random.default_rng(41).integers(0, 128, (2, 6))


@pytest.fixture(scope="module")
def all_jax_tokens(loop, tiny_model_dir, registry):
    """The JAX client's server_decode through an all-JAX chain."""
    model_dir, hf_model, _ = tiny_model_dir
    servers = spans(model_dir, registry.port, "dn-alljax", [(0, 2), (2, 3)],
                    make=jax_server)
    model = jclient(model_dir, registry.port, "dn-alljax",
                    server_decode=True, server_decode_chunk=4)

    async def go():
        async with model.inference_session(16, 2) as sess:
            ids = await model.generate(X_INTEROP, max_new_tokens=8,
                                       session=sess)
            assert [t for t in sess.timings if t.get("decode_n")]
        return ids

    ids = np.asarray(served(loop, servers, go))
    np.testing.assert_array_equal(ids, hf_greedy(hf_model, X_INTEROP, 8))
    return ids


@pytest.mark.parametrize("client,kinds", [
    ("jax", ("port",)),  # the fused loop
    ("jax", ("port", "port")),
    ("port", ("jax", "jax")),
    ("port", ("jax", "port")),
    ("port", ("port", "jax")),
], ids=["jax-client-port-whole", "jax-client-port-chain",
        "port-client-jax-chain", "mixed-jax-then-port",
        "mixed-port-then-jax"])
def test_interop_server_decode_matches_all_jax(loop, tiny_model_dir,
                                               registry, all_jax_tokens,
                                               client, kinds):
    model_dir = tiny_model_dir[0]
    uid = f"dn-{client}-{'-'.join(kinds)}"
    bounds = [(0, 3)] if len(kinds) == 1 else [(0, 2), (2, 3)]
    make = {"port": port_server, "jax": jax_server}
    servers = [make[k](model_dir, registry.port, uid, a, b)
               for k, (a, b) in zip(kinds, bounds)]
    model = (jclient if client == "jax" else pclient)(
        model_dir, registry.port, uid, server_decode=True,
        server_decode_chunk=4,
    )

    async def go():
        async with model.inference_session(16, 2) as sess:
            ids = await model.generate(X_INTEROP, max_new_tokens=8,
                                       session=sess)
            dn = [t for t in sess.timings if t.get("decode_n")]
        return ids, dn

    ids, dn = served(loop, servers, go)
    assert dn, "server-side decode was not used"
    np.testing.assert_array_equal(np.asarray(ids), all_jax_tokens)


# ---------------------------------------------------------- leases
def test_dirty_chain_replays_instead_of_resuming(loop, tiny_model_dir,
                                                 registry):
    """A chained call fails at its second hop after span 0 committed, and
    span 0's stream dies before its dirty decline can go out: the session
    is not parked (kv_dirty), the client's resume is declined, and it
    replays its history and finishes with the per-step tokens."""
    model_dir, _, config = tiny_model_dir
    uid = "dn-dirty-lease"
    servers = spans(model_dir, registry.port, uid, [(0, 2), (2, 3)],
                    session_lease_s=30.0)
    coord = servers[0]
    # each span has one server: a short ban lets the recovery route back
    model = pclient(model_dir, registry.port, uid, ban_timeout=0.2,
                    ban_max=0.4)
    x = np.random.default_rng(43).integers(0, config.vocab_size, (1, 5))
    orig = coord._await_chain_ids
    fired = []

    async def failing(session, cid, i, t_deadline):
        if i == 1 and not fired:
            fired.append(session.id)
            # the stream dies first, then the chain fails: the decline
            # cannot be delivered
            session.cur_stream.conn.abort("injected stream death")
            raise RuntimeError("injected chain failure")
        return await orig(session, cid, i, t_deadline)

    async def go():
        _, ref = await greedy_ref(model, x, 6, max_length=24)
        async with model.inference_session(24, 1) as sess:
            out = await sess.step(model.embed(x), ids=x)
            first = model.logits(out[:, -1:])[:, 0].argmax(-1).numpy()
            coord._await_chain_ids = failing
            t1 = await sess.decode_n(first, 4)
            t2 = await sess.decode_n(t1[:, -1], 2)
            return (ref, np.concatenate([t1, t2], axis=1),
                    sess.resume_declines, sess.failover_replayed_tokens)

    ref, got, declines, replayed = served(loop, servers, go)
    assert fired
    np.testing.assert_array_equal(got, ref)
    assert declines >= 1 and replayed > 0
    assert coord.sessions_resumed == 0

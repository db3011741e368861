"""The port's span server on the wire, on the CPU, against the JAX package.

Port servers (`device="cpu"`, `throughput=1.0`) serve a tiny Llama built
locally (the fixture of tests/test_e2e_swarm.py), and the JAX client drives
them through a port registry:

- two port servers ([0, 2), [2, 3)) match HF greedy, with and without push
  and in micro-batches (the analog of tests/test_e2e_swarm.py:65), and the
  full chain's logits match HF within 1e-3 (the analog of :94);
- bf16 port servers advertise wire_dtype "bf16" and the logits stay close
  (the analog of test_bf16_wire_logits_close);
- mixed chains, a JAX server then a port server and the reverse, with
  push, match HF greedy: the frames are byte-compatible both ways;
- a port server announces to a JAX registry, and the JAX registry client
  reads the record back; rpc_info answers a JAX connection.

And the routing repair: outside the CUDA kernels' shape domain (GQA group
3, head_dim 96) every route of the executor is dense, as on the card, and
at group 3 the port executor matches the JAX executor within 1e-4 (f32).

All servers, registries and clients of the module live on one event loop
in a background thread, so the f32 chain and the registry are started once.
"""

import asyncio
import threading

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bloombee_tpu.client.model import DistributedModelForCausalLM
from bloombee_tpu.kv.cache_manager import CacheManager as JaxManager
from bloombee_tpu.models.spec import ModelSpec as JaxSpec
from bloombee_tpu.runtime.executor import SpanExecutor as JaxExecutor
from bloombee_tpu.server.block_server import BlockServer as JaxServer
from bloombee_tpu.swarm import registry as j_registry
from bloombee_tpu.wire import rpc as j_rpc
from bloombee_tpu_torch.kv.cache_manager import CacheManager
from bloombee_tpu_torch.models.llama.block import params_from_jax
from bloombee_tpu_torch.models.spec import ModelSpec
from bloombee_tpu_torch.ops.cuda import flash_attention as t_flash
from bloombee_tpu_torch.ops.cuda import paged_attention as t_paged
from bloombee_tpu_torch.runtime.executor import SpanExecutor
from bloombee_tpu_torch.server.block_server import BlockServer
from bloombee_tpu_torch.swarm.registry import RegistryClient, RegistryServer

TIMEOUT = 120
# the JAX clients' registry connections, closed with the loop (a dropped
# client would leave its connection's reader task to the garbage collector)
REGISTRY_CLIENTS = []


@pytest.fixture(scope="module")
def loop():
    loop = asyncio.new_event_loop()
    thread = threading.Thread(target=loop.run_forever, daemon=True)
    thread.start()
    yield loop

    async def cancel_rest():
        for rc in REGISTRY_CLIENTS:
            await rc.close()
        rest = [t for t in asyncio.all_tasks()
                if t is not asyncio.current_task()]
        for t in rest:
            t.cancel()
        await asyncio.gather(*rest, return_exceptions=True)

    run(loop, cancel_rest())
    loop.call_soon_threadsafe(loop.stop)
    thread.join(10)
    loop.close()


def run(loop, coro):
    return asyncio.run_coroutine_threadsafe(coro, loop).result(TIMEOUT)


@pytest.fixture(scope="module")
def tiny_model_dir(tmp_path_factory):
    from transformers import LlamaConfig, LlamaForCausalLM

    config = LlamaConfig(
        hidden_size=64,
        intermediate_size=128,
        num_attention_heads=4,
        num_key_value_heads=2,
        num_hidden_layers=3,
        vocab_size=128,
        max_position_embeddings=256,
        rms_norm_eps=1e-5,
        tie_word_embeddings=False,
    )
    torch.manual_seed(0)
    model = LlamaForCausalLM(config).eval().to(torch.float32)
    d = tmp_path_factory.mktemp("tiny_llama")
    model.save_pretrained(d, safe_serialization=True)
    return str(d), model, config


@pytest.fixture(scope="module")
def registry(loop):
    reg = RegistryServer(host="127.0.0.1")
    run(loop, reg.start())
    yield reg
    run(loop, reg.stop())


def port_server(model_dir, reg_port, uid, start, end, **kw):
    kw.setdefault("compute_dtype", torch.float32)
    return BlockServer(
        model_uid=uid, start=start, end=end, model_dir=model_dir,
        registry=RegistryClient("127.0.0.1", reg_port), num_pages=64,
        page_size=4, throughput=1.0, device="cpu", **kw,
    )


def jax_server(model_dir, reg_port, uid, start, end):
    return JaxServer(
        model_uid=uid, start=start, end=end, model_dir=model_dir,
        registry=j_registry.RegistryClient("127.0.0.1", reg_port),
        compute_dtype=jnp.float32, num_pages=64, page_size=4,
    )


async def start_all(*servers):
    for s in servers:
        await s.start()


async def stop_all(*servers):
    for s in servers:
        await s.stop()
        await s.registry.close()  # the caller owns a server's registry


@pytest.fixture(scope="module")
def port_chain(loop, tiny_model_dir, registry):
    """Two f32 port servers, blocks [0, 2) and [2, 3), model uid "tiny"."""
    model_dir = tiny_model_dir[0]
    servers = [
        port_server(model_dir, registry.port, "tiny", 0, 2),
        port_server(model_dir, registry.port, "tiny", 2, 3),
    ]
    run(loop, start_all(*servers))
    yield servers
    run(loop, stop_all(*servers))


def client(model_dir, reg_port, uid, use_push=True):
    rc = j_registry.RegistryClient("127.0.0.1", reg_port)
    REGISTRY_CLIENTS.append(rc)
    return DistributedModelForCausalLM.from_pretrained(
        model_dir, rc, model_uid=uid, use_push=use_push,
    )


def hf_greedy(model, input_ids, max_new_tokens):
    with torch.no_grad():
        out = model.generate(
            torch.tensor(input_ids), max_new_tokens=max_new_tokens,
            do_sample=False, use_cache=True,
        )
    return out.numpy()


def greedy_matches_hf(loop, tiny_model_dir, reg_port, uid, use_push=True):
    model_dir, hf_model, config = tiny_model_dir
    model = client(model_dir, reg_port, uid, use_push)
    input_ids = np.random.default_rng(0).integers(
        0, config.vocab_size, size=(2, 6)
    )
    ids = run(loop, model.generate(input_ids, max_new_tokens=8))
    np.testing.assert_array_equal(ids, hf_greedy(hf_model, input_ids, 8))


async def step_logits(model, input_ids, check_session=None):
    async with model.inference_session(16, 1) as sess:
        if check_session is not None:
            check_session(sess)
        out = await sess.step(model.embed(input_ids))
    return model.logits(out)


def hf_logits(hf_model, input_ids):
    with torch.no_grad():
        return hf_model(torch.tensor(input_ids)).logits.numpy()


@pytest.mark.parametrize("use_push", [False, True], ids=["relay", "push"])
def test_jax_client_through_port_servers_matches_hf(
    loop, tiny_model_dir, registry, port_chain, use_push
):
    greedy_matches_hf(loop, tiny_model_dir, registry.port, "tiny", use_push)


def test_microbatched_push_matches_hf(loop, tiny_model_dir, registry,
                                     port_chain):
    """A batch of 4 in micro-batches of 2 rows (mb_of 2, `rows` row slices
    of each session's cache) through the push chain: the servers run the
    chunks as concurrent tasks and forward each one on (the analog of
    tests/test_microbatch.py)."""
    model_dir, hf_model, config = tiny_model_dir
    model = client(model_dir, registry.port, "tiny")
    input_ids = np.random.default_rng(3).integers(
        0, config.vocab_size, size=(4, 6)
    )

    async def go():
        session = model.inference_session(24, 4, microbatch=2)
        async with session:
            return await model.generate(input_ids, max_new_tokens=8,
                                        session=session)

    np.testing.assert_array_equal(
        run(loop, go()), hf_greedy(hf_model, input_ids, 8)
    )


def test_logits_parity_full_chain(loop, tiny_model_dir, registry, port_chain):
    model_dir, hf_model, config = tiny_model_dir
    model = client(model_dir, registry.port, "tiny")
    input_ids = np.arange(10)[None, :] % config.vocab_size
    logits = run(loop, step_logits(model, input_ids))
    np.testing.assert_allclose(
        logits, hf_logits(hf_model, input_ids), atol=1e-3, rtol=1e-3
    )


def test_bf16_wire_logits_close(loop, tiny_model_dir, registry):
    model_dir, hf_model, config = tiny_model_dir
    servers = [
        port_server(model_dir, registry.port, "tiny-bf16", a, b,
                    compute_dtype=torch.bfloat16)
        for a, b in ((0, 2), (2, 3))
    ]
    run(loop, start_all(*servers))
    try:
        model = client(model_dir, registry.port, "tiny-bf16", use_push=False)
        input_ids = np.arange(10)[None, :] % config.vocab_size

        def wire_dtypes(sess):
            assert [s.span.server_info.wire_dtype for s in sess._spans] == [
                "bf16", "bf16"
            ]

        logits = run(loop, step_logits(model, input_ids, wire_dtypes))
    finally:
        run(loop, stop_all(*servers))
    # bf16 has an 8-bit mantissa: the JAX test's tolerance
    np.testing.assert_allclose(
        logits, hf_logits(hf_model, input_ids), atol=0.3, rtol=0.1
    )


@pytest.mark.parametrize("order", ["jax-then-port", "port-then-jax"])
def test_mixed_chain_matches_hf(loop, tiny_model_dir, registry, order):
    """One JAX span and one port span in a push chain: each server reads
    the other's pushed frames and the client reads both."""
    model_dir = tiny_model_dir[0]
    uid = f"tiny-{order}"
    first, second = (
        (jax_server, port_server) if order == "jax-then-port"
        else (port_server, jax_server)
    )
    servers = [first(model_dir, registry.port, uid, 0, 2),
               second(model_dir, registry.port, uid, 2, 3)]
    run(loop, start_all(*servers))
    try:
        greedy_matches_hf(loop, tiny_model_dir, registry.port, uid)
    finally:
        run(loop, stop_all(*servers))


def test_announce_to_jax_registry_and_rpc_info(loop, tiny_model_dir):
    """A port server announces to a JAX RegistryServer; the JAX registry
    client reads its record, and rpc_info answers a JAX connection."""
    model_dir = tiny_model_dir[0]

    async def go():
        reg = j_registry.RegistryServer(host="127.0.0.1")
        await reg.start()
        server = port_server(model_dir, reg.port, "tiny-jreg", 0, 3)
        await server.start()
        try:
            reader = j_registry.RegistryClient("127.0.0.1", reg.port)
            infos = await reader.get_module_infos("tiny-jreg", range(3))
            await reader.close()
            conn = await j_rpc.connect("127.0.0.1", server.port)
            info, _ = await conn.call("rpc_info", {})
            await conn.close()
            return server.server_id, server.port, infos, info
        finally:
            await stop_all(server)
            await reg.stop()

    sid, port, infos, info = run(loop, go())
    for m in infos:
        assert list(m.servers) == [sid]
        rec = m.servers[sid]
        assert (rec.port, rec.start_block, rec.end_block) == (port, 0, 3)
        assert rec.wire_dtype == "f32" and rec.decode_n_max == 256
        assert rec.page_size == 0 and not rec.kv_repl and not rec.out_digest
    assert info["server_id"] == sid and info["wire_dtype"] == "f32"
    assert info["memory"]["kv_tokens_capacity"] == 64 * 4
    assert "wire_pipeline" in info and "transport" in info


# ------------------------------------------------------------------ routing
@pytest.mark.parametrize("dtype,h,hkv,hd,want", [
    (torch.bfloat16, 32, 8, 128, True),
    (torch.float32, 4, 2, 64, True),
    (torch.bfloat16, 24, 8, 128, True),  # GQA group 3
    (torch.bfloat16, 71, 1, 64, True),  # Falcon-7B: group 71
    (torch.float32, 128, 8, 64, True),  # Falcon-40B: group 16
    (torch.bfloat16, 232, 8, 64, True),  # Falcon-180B: group 29
    (torch.bfloat16, 32, 8, 96, False),
    (torch.bfloat16, 16, 8, 256, False),
    (torch.bfloat16, 12, 8, 64, False),  # H not a multiple of Hkv
    (torch.float16, 32, 8, 128, False),
])
def test_kernel_domain(dtype, h, hkv, hd, want):
    assert t_paged.supports(h, hkv, hd, dtype) is want
    assert t_flash.supports(h, hkv, hd, dtype) is want


def geometry_model(h, hkv, hd, seed=0):
    rng = np.random.default_rng(seed)
    shapes = {
        "input_layernorm": (64,), "post_attention_layernorm": (64,),
        "q_proj": (64, h * hd), "k_proj": (64, hkv * hd),
        "v_proj": (64, hkv * hd), "o_proj": (h * hd, 64),
        "gate_proj": (64, 128), "up_proj": (64, 128), "down_proj": (128, 64),
    }
    params = {  # JAX layout, stacked with a leading L
        k: (rng.standard_normal((2, *s)) / (8 if len(s) == 2 else 1)).astype(
            np.float32
        )
        for k, s in shapes.items()
    }
    spec = dict(
        family="llama", hidden_size=64, intermediate_size=128,
        num_attention_heads=h, num_key_value_heads=hkv, head_dim=hd,
        num_hidden_layers=2, vocab_size=96, rms_norm_eps=1e-5,
    )
    inputs = [
        rng.standard_normal(shape).astype(np.float32)
        for shape in ((1, 256, 64), (1, 1, 64), (1, 24, 64), (1, 1, 64),
                      (1, 40, 64))
    ]
    return params, spec, inputs


def drive_routes(manager, ex, inputs):
    """A 256-token prefill (flash bucket), a decode (T=1), a 24-token
    chunk, then one ragged group of a decode row and a second session's
    40-token chunk."""
    prompt, dec, chunk, dec2, chunk_b = inputs
    outs = []

    async def go():
        async with manager.allocate(1, 320) as a, \
                manager.allocate(1, 64) as b:
            for x in (prompt, dec, chunk):
                outs.append(np.asarray(
                    ex.prefill(a, x) if x.shape[1] > 1 else ex.decode(a, x),
                    np.float32,
                ))
            out, combined = ex.ragged_group([a, b], [dec2, chunk_b])
            manager.commit(combined)
            outs.append(np.asarray(out, np.float32))

    asyncio.run(go())
    return outs


def counted_routes(monkeypatch) -> list:
    """The names of the kernels' plain versions as they run (the CPU's
    kernel routes), in call order."""
    calls = []
    for mod, name in (
        (t_flash, "flash_attention_reference"),
        (t_paged, "paged_decode_attention_reference"),
        (t_paged, "paged_chunk_attention_reference"),
        (t_paged, "paged_ragged_attention_reference"),
    ):
        def counted(*a, _fn=getattr(mod, name), _name=name, **kw):
            calls.append(_name)
            return _fn(*a, **kw)

        monkeypatch.setattr(mod, name, counted)
    return calls


def geometry_routes(monkeypatch, h, hkv, hd):
    """(the port executor's outputs of `drive_routes` for a 2-layer model
    of this head geometry with every kernel route eligible by context
    (BBTPU_PAGED_MIN_CONTEXT 0), the kernels' plain versions that ran, its
    executor, the JAX executor's outputs on the same inputs: its CPU
    route)."""
    params, spec, inputs = geometry_model(h, hkv, hd)
    calls = counted_routes(monkeypatch)
    monkeypatch.setenv("BBTPU_PAGED_MIN_CONTEXT", "0")
    manager = CacheManager(2, 32, 16, hkv, hd, dtype=torch.float32,
                           device="cpu")
    ex = SpanExecutor(
        params_from_jax(params, device="cpu"), ModelSpec(**spec), manager,
        compute_dtype=torch.float32, device="cpu",
    )
    got = drive_routes(manager, ex, inputs)
    jm = JaxManager(
        num_layers=2, num_pages=32, page_size=16, n_kv_heads=hkv,
        head_dim=hd, dtype=jnp.float32,
    )
    jex = JaxExecutor(params, JaxSpec(**spec), jm, compute_dtype=jnp.float32)
    return got, calls, ex, drive_routes(jm, jex, inputs)


@pytest.mark.parametrize("h,hkv,hd", [(4, 2, 256), (4, 2, 96)],
                         ids=["head_dim256", "head_dim96"])
def test_routes_outside_kernel_domain_are_dense(monkeypatch, h, hkv, hd):
    """A geometry outside the CUDA kernels' domain runs no kernel's plain
    version: prefill, decode, chunk and ragged steps all take the dense
    routes, as they would on the card, and match the JAX executor's
    outputs within 1e-4."""
    got, calls, ex, want = geometry_routes(monkeypatch, h, hkv, hd)
    assert not ex.paged_supported and not ex.flash_supported
    assert calls == []
    for g, w in zip(got, want, strict=True):
        np.testing.assert_allclose(
            g.reshape(w.shape), w, atol=1e-4, rtol=1e-4
        )


def test_group3_takes_the_kernel_routes_and_matches_jax(monkeypatch):
    """GQA group 3 (6 query heads over 2 KV heads, hd 64) is inside the
    kernels' domain: the prefill takes the flash route, the decode the
    paged decode route, the chunk the paged chunk route and the ragged
    group the ragged route (their plain versions here), and the outputs
    match the JAX executor's within 1e-4."""
    got, calls, ex, want = geometry_routes(monkeypatch, 6, 2, 64)
    assert ex.paged_supported and ex.flash_supported
    assert set(calls) == {
        "flash_attention_reference", "paged_decode_attention_reference",
        "paged_chunk_attention_reference",
        "paged_ragged_attention_reference",
    }
    for g, w in zip(got, want, strict=True):
        np.testing.assert_allclose(
            g.reshape(w.shape), w, atol=1e-4, rtol=1e-4
        )


def test_server_kv_quant_defaults_to_env(monkeypatch):
    """A server not told its KV quantization takes BBTPU_KV_QUANT, as the
    JAX cache manager does; an explicit argument wins."""
    params, spec, _ = geometry_model(4, 2, 64)
    kw = dict(
        model_uid="quant", start=0, end=2, spec=ModelSpec(**spec),
        params=params_from_jax(params, device="cpu"), num_pages=8,
        compute_dtype=torch.float32, device="cpu",
    )
    assert BlockServer(**kw).manager.quant is None
    monkeypatch.setenv("BBTPU_KV_QUANT", "int4")
    assert BlockServer(**kw).manager.quant == "int4"
    assert BlockServer(**kw, kv_quant="none").manager.quant is None

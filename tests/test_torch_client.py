"""The port's client on the CPU, against HF and the JAX package.

The port's `DistributedModelForCausalLM` (`device="cpu"`) drives the tiny
Llama of tests/test_torch_server.py (3 layers, hidden 64, 4 heads, 2 KV
heads, vocab 128, f32 servers, page_size 4), whose fixtures and helpers
this module imports:

- the head promotes as JAX does (f32 hidden with bf16 parameters gives f32
  logits), and the vocab-chunked head matches JAX's `_norm_head_chunked`;
- the port client matches HF greedy through port servers (relay, push,
  push in micro-batches of 1 row), through JAX servers and through mixed
  JAX/port chains; its logits match HF within 1e-3 and the JAX client's on
  the same chain within 1e-5;
- failover: the preferred [2, 3) server stops mid-generation; the session
  re-routes to the backup, replays by token ids with `commit_lens`, and
  the tokens still equal HF's;
- `RemoteSequenceManager` picks the JAX manager's routes on the same
  records and seeded rng; `out_digest`, `SanityGate` and `tensors_close`
  agree with the JAX package, and an integrity client verifies a JAX
  integrity server's digests;
- every refused config field raises and names what it asks for (the
  speculative step arguments are served since the port has speculative
  decoding: tests/test_torch_spec.py; server-side decode since it has
  decode_n: tests/test_torch_decode_n.py).
"""

import random

import ml_dtypes
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bloombee_tpu.client import integrity as j_integrity
from bloombee_tpu.client.model import _norm_head_chunked as jax_head_chunked
from bloombee_tpu.client.sequence_manager import (
    RemoteSequenceManager as JaxManager,
)
from bloombee_tpu.kv.prefix import out_digest as jax_out_digest
from bloombee_tpu.models.checkpoint import (
    load_client_params as jax_client_params,
)
from bloombee_tpu.models.head import norm_head_impl as jax_head
from bloombee_tpu.server.block_server import BlockServer as JaxServer
from bloombee_tpu.swarm import data as j_data
from bloombee_tpu.swarm import registry as j_registry
from bloombee_tpu.swarm.spans import compute_spans as jax_compute_spans
from bloombee_tpu_torch.client import (
    ClientConfig,
    DistributedModelForCausalLM,
    RemoteSequenceManager,
)
from bloombee_tpu_torch.client import integrity
from bloombee_tpu_torch.models.checkpoint import load_client_params
from bloombee_tpu_torch.models.head import (
    client_params_from_jax,
    norm_head_chunked,
    norm_head_impl,
)
from bloombee_tpu_torch.swarm import data as t_data
from bloombee_tpu_torch.swarm.registry import RegistryClient
from bloombee_tpu_torch.swarm.spans import compute_spans
from bloombee_tpu_torch.utils import ledger
from test_torch_server import (  # noqa: F401  (fixtures)
    REGISTRY_CLIENTS,
    client as jax_client,
    hf_greedy,
    hf_logits,
    jax_server,
    loop,
    port_chain,
    port_server,
    registry,
    run,
    start_all,
    stop_all,
    tiny_model_dir,
)

EPS = 1e-5


def port_client(model_dir, reg_port, uid, use_push=True, **config):
    rc = RegistryClient("127.0.0.1", reg_port)
    REGISTRY_CLIENTS.append(rc)
    return DistributedModelForCausalLM.from_pretrained(
        model_dir, rc, model_uid=uid, device="cpu",
        config=ClientConfig(use_push=use_push, **config),
    )


def prompts(config, seed=0):
    return np.random.default_rng(seed).integers(
        0, config.vocab_size, size=(2, 6)
    )


def generate(loop, model, input_ids, new=8, microbatch=None, check=None):
    """Greedy tokens through one explicit session (numpy), and the
    session after it closed."""
    async def go():
        session = model.inference_session(
            input_ids.shape[1] + new, input_ids.shape[0],
            microbatch=microbatch,
        )
        async with session:
            ids = await model.generate(input_ids, max_new_tokens=new,
                                       session=session)
            if check is not None:
                check(session)
        return ids, session

    ids, session = run(loop, go())
    assert ids.dtype == torch.int64 and ids.device.type == "cpu"
    return ids.numpy(), session


# ------------------------------------------------------------------- head
def bf16(x):
    """A float numpy array rounded to ml_dtypes bf16 (as JAX rounds)."""
    return np.asarray(x, np.float32).astype(ml_dtypes.bfloat16)


def as_torch(x):
    if x.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(x.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(x))


def head_inputs(hidden_dtype, param_dtype, v=128, seed=0):
    rng = np.random.default_rng(seed)
    cast = {"f32": lambda a: a.astype(np.float32), "bf16": bf16}
    hidden = cast[hidden_dtype](rng.standard_normal((2, 3, 64)))
    params = {
        "norm": cast[param_dtype](1 + 0.1 * rng.standard_normal(64)),
        "lm_head": cast[param_dtype](rng.standard_normal((64, v)) / 8),
    }
    return hidden, params


@pytest.mark.parametrize("hidden_dtype,param_dtype", [
    ("f32", "bf16"), ("f32", "f32"), ("bf16", "bf16"),
])
def test_head_promotes_like_jax(hidden_dtype, param_dtype):
    """f32 hidden states against bf16 parameters give f32 logits from an
    f32 product, as JAX's `norm_head_impl` promotes (the port used to raise
    on the mixed dtypes); equal dtypes keep working."""
    hidden, params = head_inputs(hidden_dtype, param_dtype)
    want = np.asarray(jax_head(
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(hidden),
        EPS,
    ))
    got = norm_head_impl(
        {k: as_torch(v) for k, v in params.items()}, as_torch(hidden), EPS
    )
    assert got.dtype == torch.float32 and want.dtype == np.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("param_dtype", ["bf16", "f32"])
def test_norm_head_chunked_matches_jax(param_dtype):
    """48-column chunks over V=128: the last start is clamped to 80, so
    columns 80-95 are written twice."""
    hidden, params = head_inputs("f32", param_dtype)
    want = np.asarray(jax_head_chunked(
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(hidden),
        eps=EPS, step=48,
    ))
    tparams = {k: as_torch(v) for k, v in params.items()}
    got = norm_head_chunked(tparams, as_torch(hidden), EPS, step=48)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    np.testing.assert_allclose(
        got.numpy(), norm_head_impl(tparams, as_torch(hidden), EPS).numpy(),
        atol=1e-5, rtol=0,
    )


def test_client_params_from_jax(tiny_model_dir):
    """The JAX client's bf16 parameters carry over to the port's tensors
    bit for bit, equal to the port's own checkpoint load."""
    model_dir = tiny_model_dir[0]
    tree = {
        k: np.asarray(v)
        for k, v in jax_client_params(model_dir, dtype=jnp.bfloat16).items()
    }
    got = client_params_from_jax(tree, device="cpu")
    want = load_client_params(model_dir, dtype=torch.bfloat16, device="cpu")
    for name in ("embed", "norm", "lm_head"):
        assert got[name].dtype == torch.bfloat16
        assert torch.equal(got[name], want[name])


# ------------------------------------------------------------- end to end
@pytest.mark.parametrize("use_push,microbatch", [
    (False, None), (True, None), (True, 2),
], ids=["relay", "push", "push-mb2"])
def test_port_client_through_port_servers_matches_hf(
    loop, tiny_model_dir, registry, port_chain, use_push, microbatch
):
    model_dir, hf_model, config = tiny_model_dir
    model = port_client(model_dir, registry.port, "tiny", use_push)
    input_ids = prompts(config)
    ids, session = generate(loop, model, input_ids, microbatch=microbatch)
    np.testing.assert_array_equal(ids, hf_greedy(hf_model, input_ids, 8))
    assert session.timings and session.timing_summary()["steps"] == 7


@pytest.mark.parametrize("first,second", [
    (jax_server, jax_server), (jax_server, port_server),
    (port_server, jax_server),
], ids=["jax-jax", "jax-port", "port-jax"])
def test_port_client_through_jax_and_mixed_chains(
    loop, tiny_model_dir, registry, first, second
):
    """The port client reads JAX servers' replies and drives a push route
    across both packages' servers."""
    model_dir, hf_model, config = tiny_model_dir
    uid = f"tiny-client-{first.__name__}-{second.__name__}"
    servers = [first(model_dir, registry.port, uid, 0, 2),
               second(model_dir, registry.port, uid, 2, 3)]
    run(loop, start_all(*servers))
    try:
        model = port_client(model_dir, registry.port, uid)
        input_ids = prompts(config, seed=1)
        ids, _ = generate(loop, model, input_ids)
    finally:
        run(loop, stop_all(*servers))
    np.testing.assert_array_equal(ids, hf_greedy(hf_model, input_ids, 8))


def test_port_client_logits_full_chain(loop, tiny_model_dir, registry,
                                       port_chain):
    """One 10-token step through the port chain: the port client's logits
    are within 1e-3 of HF's and within 1e-5 of the JAX client's on the
    same chain."""
    model_dir, hf_model, config = tiny_model_dir
    input_ids = np.arange(10)[None, :] % config.vocab_size
    model = port_client(model_dir, registry.port, "tiny")
    jmodel = jax_client(model_dir, registry.port, "tiny")

    async def go():
        async with model.inference_session(16, 1) as sess:
            got = model.logits(await sess.step(model.embed(input_ids)))
        async with jmodel.inference_session(16, 1) as sess:
            want = jmodel.logits(await sess.step(jmodel.embed(input_ids)))
        return got, want

    got, want = run(loop, go())
    assert got.dtype == torch.float32
    np.testing.assert_allclose(
        got.numpy(), hf_logits(hf_model, input_ids), atol=1e-3, rtol=1e-3
    )
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("replay", ["ids", "hidden"])
def test_failover_reroute_and_replay(loop, tiny_model_dir, registry, replay):
    """Stop the preferred [2, 3) server mid-generation (relay): the session
    re-routes to the backup and replays its history, by token ids with
    commit_lens or (a session without an embed_fn) by the stored hidden
    states, and the tokens equal HF's (the analog of
    tests/test_e2e_swarm.py::test_failover_rereoute_and_replay)."""
    model_dir, hf_model, config = tiny_model_dir
    uid = f"tiny-failover-{replay}"
    s_a = port_server(model_dir, registry.port, uid, 0, 2)
    s_b = port_server(model_dir, registry.port, uid, 2, 3)  # preferred
    s_c = port_server(model_dir, registry.port, uid, 2, 3)  # backup
    s_a.throughput = s_b.throughput = 10.0
    run(loop, start_all(s_a, s_b, s_c))
    model = port_client(model_dir, registry.port, uid, use_push=False)
    input_ids = np.arange(5)[None, :] % config.vocab_size
    ledger.reset()

    async def go():
        session = model.inference_session(16, 1)
        if replay == "hidden":
            session.embed_fn = None
        async with session:
            used = {s.span.server_info.port for s in session._spans}
            assert s_b.port in used and s_c.port not in used
            ids = await model.generate(input_ids, max_new_tokens=3,
                                       session=session)
            await s_b.stop()  # the preferred server dies mid-session
            more = await model.generate(ids[:, -1:], max_new_tokens=3,
                                        session=session)
            used = {s.span.server_info.port for s in session._spans}
        return torch.cat([ids, more[:, 1:]], dim=1), session, used

    try:
        final, session, used = run(loop, go())
    finally:
        run(loop, stop_all(s_a, s_c))
        run(loop, s_b.registry.close())
    np.testing.assert_array_equal(
        final.numpy(), hf_greedy(hf_model, input_ids, 6)
    )
    assert s_c.port in used and s_b.port not in used
    # 5 prompt + 2 generated tokens were committed before the failure
    assert session.failover_replayed_tokens == 7
    assert bool(session._history) == (replay == "hidden")
    assert any(session._id_rows) == (replay == "ids")
    assert ledger.snapshot()["recoveries"]["client.reroute_replay"] == 1


# ---------------------------------------------------------------- routing
def swarm(data):
    """Both packages' ModuleInfo lists for 6 blocks served by 4 peers with
    different throughputs (and one server-to-server ping)."""
    records = [
        ("p0", 0, 3, 4.0, None),
        ("p1", 0, 6, 1.0, {"p3": 0.001}),
        ("p2", 2, 6, 3.0, None),
        ("p3", 3, 6, 5.0, None),
    ]
    infos = [data.ModuleInfo(f"m.{b}", {}) for b in range(6)]
    for pid, a, b, tput, pings in records:
        info = data.ServerInfo(
            host="127.0.0.1", port=1, throughput=tput, start_block=a,
            end_block=b, next_pings=pings,
        )
        for blk in range(a, b):
            infos[blk].servers[pid] = info
    return infos


def route(manager_cls, data, mode, penalize):
    manager = manager_cls(None, "m", 6, rng=random.Random(5))
    spans_of = compute_spans if data is t_data else jax_compute_spans
    manager.spans = spans_of(swarm(data))
    for pid, rtt in (("p0", 0.02), ("p1", 0.005), ("p2", 0.03)):
        manager.pinger.record(pid, rtt)
    if penalize is not None:
        getattr(manager, penalize)("p3")
    picks = [
        [(s.peer_id, s.start, s.end) for s in manager.make_sequence(mode=mode)]
        for _ in range(4)
    ]
    return picks, {k: (v.start, v.end) for k, v in manager.spans.items()}


@pytest.mark.parametrize("mode,penalize", [
    ("min_latency", None), ("max_throughput", None),
    ("min_latency", "ban_peer"), ("min_latency", "note_peer_overloaded"),
], ids=["dijkstra", "random", "banned", "overloaded"])
def test_sequence_manager_matches_jax(mode, penalize):
    got, got_spans = route(RemoteSequenceManager, t_data, mode, penalize)
    want, want_spans = route(JaxManager, j_data, mode, penalize)
    assert got == want and got_spans == want_spans
    if penalize is not None:
        assert all("p3" not in {p for p, _, _ in r} for r in got)


# -------------------------------------------------------------- integrity
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_out_digest_matches_jax(dtype):
    arr = np.random.default_rng(2).standard_normal((2, 1, 64))
    arr = bf16(arr) if dtype == "bf16" else arr.astype(np.float32)
    assert integrity.out_digest(as_torch(arr)) == jax_out_digest(arr)
    assert integrity.out_digest(as_torch(arr)[:1]) == jax_out_digest(arr[:1])


def test_sanity_gate_and_tolerance_match_jax():
    rng = np.random.default_rng(3)
    base = rng.standard_normal((1, 2, 64)).astype(np.float32)
    nan = base.copy()
    nan[0, 1, 5] = np.nan
    seq = [base, base * 1.1, base * 0.9, base, base * 64, nan, base * 3,
           base * 5, bf16(base * 64), base]
    jgate, tgate = j_integrity.SanityGate(), integrity.SanityGate()
    got = [tgate.check((0, 2), as_torch(a)) for a in seq]
    want = [jgate.check((0, 2), a) for a in seq]
    assert got == want and got.count(None) == 7
    for a, b, dt in ((base, base * 1.01, "f32"), (base, base * 1.05, "f32"),
                     (base, base * 1.05, "bf16"), (base, base[:, :1], None)):
        assert integrity.tensors_close(
            as_torch(a), as_torch(b), dtype=dt
        ) == j_integrity.tensors_close(a, b, dtype=dt)


def test_integrity_client_through_jax_integrity_server(loop, tiny_model_dir,
                                                       registry):
    """A JAX server with integrity on stamps out_digest over each reply's
    numpy bytes; the port client with integrity on recomputes it over the
    received tensor and accepts every reply."""
    model_dir, hf_model, config = tiny_model_dir
    uid = "tiny-integrity"
    server = JaxServer(
        model_uid=uid, start=0, end=3, model_dir=model_dir,
        registry=j_registry.RegistryClient("127.0.0.1", registry.port),
        compute_dtype=jnp.float32, num_pages=64, page_size=4,
        integrity=True,
    )
    run(loop, start_all(server))
    try:
        model = port_client(model_dir, registry.port, uid, integrity=True)
        input_ids = prompts(config, seed=4)

        def digests_on(session):
            assert session._gate is not None
            assert session._spans[0].span.server_info.out_digest

        ids, session = generate(loop, model, input_ids, check=digests_on)
    finally:
        run(loop, stop_all(server))
    np.testing.assert_array_equal(ids, hf_greedy(hf_model, input_ids, 8))
    assert session.sanity_rejects == 0


# --------------------------------------------------------------- refusals
@pytest.mark.parametrize("field,value,item", [
    ("active_adapter", "lora-a", "16"), ("audit_p", 0.1, "19"),
])
def test_refused_config_fields(field, value, item):
    with pytest.raises(ValueError, match=f"{field}.*item {item}"):
        ClientConfig(**{field: value})
    config = ClientConfig()
    setattr(config, field, value)  # set after construction: caught on use
    with pytest.raises(ValueError, match=field):
        config.validate()


def test_from_pretrained_reads_local_directories_only(tmp_path):
    with pytest.raises(FileNotFoundError, match="local model directory"):
        DistributedModelForCausalLM.from_pretrained(
            "meta-llama/Llama-3-8B", None, device="cpu"
        )


# ---------------------------------------------------------------- sampling
def test_select_and_eos_masking():
    """Greedy picks the argmax; sampling is reproducible from its seed and
    top-p keeps only the nucleus; finished rows keep emitting eos."""
    select = DistributedModelForCausalLM._select
    logits = torch.tensor([[0.0, 5.0, 1.0, 0.5], [3.0, 0.0, 2.9, 0.0]])
    assert select(logits, False, 1.0, 1.0, None).tolist() == [1, 0]
    draws = [
        select(logits, True, 1.0, 0.5,
               torch.Generator().manual_seed(7)).tolist()
        for _ in range(2)
    ]
    assert draws[0] == draws[1]
    for _ in range(20):
        row = select(logits, True, 1.0, 0.5, torch.Generator()).tolist()
        assert row[0] == 1 and row[1] in (0, 2)
    nxt, fin = DistributedModelForCausalLM._greedy_next(
        logits, torch.tensor([False, True]), eos_token_id=3
    )
    assert nxt.tolist() == [1, 3] and fin.tolist() == [False, True]

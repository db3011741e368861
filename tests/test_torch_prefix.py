"""The port's shared-prefix cache against the JAX package, on the CPU.

- (a) `page_hash_chain` / `hidden_hash_chain` equal JAX's on the same rows
  (ids of any integer dtype, hidden rows in f32 and bf16), extend
  incrementally to the same chain, and a hidden chain never equals an id
  chain;
- (b) one seeded random sequence of table operations (add, write, commit,
  rollback, truncate, accept, adopt, trim, copy-on-write, install_cached,
  park, unpark, purge, reset, eviction under `max_cached_pages`) runs on
  the port's and JAX's `PagedKVTable` with identical results, pages,
  lengths, `counts()`, pool keys, LRU order and pending copies after every
  step;
- (c) the managers' copy-on-write, `export_pages` and
  `install_replicated` leave the same arena bytes as the JAX
  `CacheManager`'s (bf16 stored, compared as bits; int4 for the
  copy-on-write only: replication declines on int4);
- (d) served, through the port's wire: port servers with the prefix cache
  give HF's greedy tokens to the port client and to the JAX client, with
  hit counters equal to a JAX chain's on the same prompts; a port client
  adopts on JAX servers; a spec_batch server verifies trees after an
  adoption. The networked tests bound themselves (`run(..., timeout)`,
  at most 60 s each).
"""

import asyncio

import ml_dtypes
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bloombee_tpu.client.config import ClientConfig as JaxClientConfig
from bloombee_tpu.client.model import (
    DistributedModelForCausalLM as JaxModel,
)
from bloombee_tpu.kv import paged as j_paged
from bloombee_tpu.kv import prefix as j_prefix
from bloombee_tpu.kv.cache_manager import CacheManager as JaxManager
from bloombee_tpu.kv.quant import QuantSlab as JaxQuantSlab
from bloombee_tpu.server.block_server import BlockServer as JaxServer
from bloombee_tpu.swarm import registry as j_registry
from bloombee_tpu_torch.client import ClientConfig, DistributedModelForCausalLM
from bloombee_tpu_torch.kv import paged, prefix
from bloombee_tpu_torch.kv.cache_manager import CacheManager
from bloombee_tpu_torch.kv.quant import QuantSlab
from bloombee_tpu_torch.swarm.registry import RegistryClient
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


# ------------------------------------------------------------ (a) chains
@pytest.mark.parametrize("dtype", [np.int32, np.int64])
def test_page_hash_chain_matches_jax(dtype):
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 32000, size=45).astype(dtype)
    for ps in (4, 16):
        want = j_prefix.page_hash_chain(ids, ps)
        assert prefix.page_hash_chain(ids, ps) == want
        assert prefix.page_hash_chain(torch.from_numpy(ids), ps) == want
        # incremental extension from a shorter chain gives the same chain
        part = prefix.page_hash_chain(ids[:ps * 2 + 1], ps)
        assert prefix.page_hash_chain(ids, ps, chain=part) == want
        assert len(want) == len(ids) // ps


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_hidden_hash_chain_matches_jax_and_never_an_id_chain(dtype):
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((10, 8)).astype(np.float32))
    x = x.to(dtype)
    host = x.float().numpy()
    want = j_prefix.hidden_hash_chain(
        host.astype(ml_dtypes.bfloat16) if dtype == torch.bfloat16 else host,
        4,
    )
    assert prefix.hidden_hash_chain(x, 4) == want
    assert prefix.hidden_hash_chain(host, 4) == want
    ids = np.zeros(10, np.int64)
    id_chain = prefix.page_hash_chain(ids, 4)
    zero_chain = prefix.hidden_hash_chain(np.zeros((10, 1), np.float32), 4)
    assert not set(id_chain) & set(want)
    assert not set(id_chain) & set(zero_chain)
    with pytest.raises(ValueError):
        prefix.hidden_hash_chain(host[None], 4)
    with pytest.raises(ValueError):
        prefix.page_hash_chain(ids, 0)


# --------------------------------------------------- (b) table operations
def table_state(t):
    seqs = {
        sid: (list(s.pages), s.l_acc, s.l_seq, s.hashes, s.published)
        for sid, s in sorted(t._seqs.items())
    }
    return (
        seqs, list(t._free), list(t._ref), dict(t._pool),
        dict(t._page_hash), list(t._lru), t.cow_count, t.counts(),
        t.free_pages, t.cached_pages,
    )


def apply(t, op, args):
    """One operation on a table; returns (result or exception type)."""
    try:
        out = getattr(t, op)(*args)
    except Exception as e:  # the same inputs must fail the same way
        return ("raised", type(e).__name__)
    if isinstance(out, np.ndarray):
        return out.tolist()
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_table_operation_sequence_matches_jax(seed):
    rng = np.random.default_rng(seed)
    ps = 4
    ours = paged.PagedKVTable(14, ps)
    theirs = j_paged.PagedKVTable(14, ps)
    for t in (ours, theirs):
        t.max_cached_pages = 3
    # a few prompts sharing prefixes, so chains collide and adopt
    base = rng.integers(0, 50, size=24)
    prompts = [base, np.concatenate([base[:8], rng.integers(0, 50, 16)]),
               rng.integers(0, 50, size=24)]
    chains = [j_prefix.page_hash_chain(p, ps) for p in prompts]
    parked: dict[int, tuple] = {}
    next_sid = 0
    ops = ["add", "write", "write", "write", "commit", "rollback",
           "truncate", "accept", "hashes", "adopt", "trim", "install",
           "park", "unpark", "purge", "drop", "reset", "restore", "match",
           "range"]
    for step in range(400):
        sids = sorted(theirs._seqs)
        op = ops[rng.integers(len(ops))]
        if op in ("add", "adopt") or not sids:
            sid = next_sid
            next_sid += 1
            calls = [("add_seq", (sid,))]
            if op == "adopt":
                c = chains[rng.integers(len(chains))]
                cap = [None, int(rng.integers(0, 24))][rng.integers(2)]
                calls.append(("adopt_prefix", (sid, c, cap)))
                # settle at a random skip and write on: a skip inside an
                # adopted page makes the write copy it
                calls.append(("trim_adopted", (sid, int(rng.integers(24)))))
                calls.append(("assign_write_slots",
                              (sid, int(rng.integers(1, 6)), True)))
        else:
            sid = sids[rng.integers(len(sids))]
            st = theirs.seq(sid)
            if op == "write":
                calls = [("assign_write_slots",
                          (sid, int(rng.integers(0, 7)),
                           bool(rng.integers(2))))]
            elif op == "commit":
                length = (None if rng.integers(2) else
                          int(rng.integers(st.l_acc, st.l_seq + 1)))
                calls = [("commit", (sid, length))]
            elif op == "rollback":
                calls = [("rollback", (sid,))]
            elif op == "truncate":
                calls = [("truncate_speculative",
                          (sid, int(rng.integers(st.l_acc, st.l_seq + 1))))]
            elif op == "accept":
                calls = [("accept",
                          (sid, int(rng.integers(0, st.l_seq - st.l_acc + 1))))]
            elif op == "hashes":
                calls = [("set_seq_hashes",
                          (sid, chains[rng.integers(len(chains))]))]
            elif op == "trim":
                calls = [("trim_adopted", (sid, int(rng.integers(0, 24))))]
            elif op == "install":
                h = (chains[rng.integers(3)][rng.integers(6)]
                     if rng.integers(2) else f"ext-{rng.integers(5)}")
                calls = [("install_cached", (h,))]
            elif op == "park":
                calls = [("park_seq_cached", (sid,))]
            elif op == "unpark":
                if sid not in parked:
                    continue
                keys, l_acc = parked[sid]
                calls = [("unpark_seq_cached", (sid, keys, l_acc))]
            elif op == "purge":
                if sid not in parked:
                    continue
                calls = [("purge_parked", (parked.pop(sid)[0],))]
            elif op == "drop":
                parked.pop(sid, None)
                calls = [("drop_seq", (sid,))]
            elif op == "reset":
                calls = [("reset_seq", (sid,))]
            elif op == "restore":
                calls = [("restore_committed",
                          (sid, int(rng.integers(0, st.l_seq + 1))))]
            elif op == "match":
                calls = [("match_prefix", (chains[rng.integers(3)],))]
            else:
                hi = int(rng.integers(0, len(st.pages) * ps + 2))
                calls = [("range_slots", (sid, 0, hi)),
                         ("prefix_slots", (sid,))]
        for name, args in calls:
            got = apply(ours, name, args)
            want = apply(theirs, name, args)
            assert got == want, (step, name, args)
            if name == "park_seq_cached" and want[0] != "raised":
                parked[sid] = want
        assert table_state(ours) == table_state(theirs), (step, op)
        assert ours.take_pending_copies() == theirs.take_pending_copies()
    # the run exercised what it claims to
    assert theirs.cow_count > 0 and len(theirs._pool) > 0


def test_table_pool_invariants():
    """free + referenced + cached == num_pages through adopt, copy-on-write,
    park, install and eviction; invalidate_pool forgets every cached page."""
    ps = 4
    t = paged.PagedKVTable(8, ps)
    t.max_cached_pages = 2
    chain = prefix.page_hash_chain(np.arange(12), ps)

    def check():
        c = t.counts()
        assert c["free"] + c["referenced"] + c["cached"] == t.num_pages

    t.add_seq(0)
    t.set_seq_hashes(0, chain)
    t.assign_write_slots(0, 12)
    check()
    t.drop_seq(0)  # three published pages, cap 2: one evicted
    assert t.cached_pages == 2
    t.add_seq(1)
    assert t.adopt_prefix(1, chain) == 0  # page 0 was the coldest
    t.drop_seq(1)
    t.add_seq(2)
    t.assign_write_slots(2, 5)
    keys, l_acc = t.park_seq_cached(2)
    check()
    assert t.unpark_seq_cached(2, keys, l_acc)
    assert t.seq(2).l_acc == 5
    t.invalidate_pool()
    check()
    assert t.cached_pages == 0 and not t._pool


# ------------------------------------------------------- (c) arena bytes
def fill(manager, jax_manager, quant, rng):
    """The same random contents in both managers' arenas."""
    for name in ("k", "v"):
        slab = manager.arena[name]
        if quant:
            leaves = []
            for leaf in slab:
                if leaf.dtype == torch.uint8:
                    x = rng.integers(0, 256, size=leaf.shape, dtype=np.uint8)
                else:
                    x = rng.standard_normal(leaf.shape).astype(np.float16)
                leaf.copy_(torch.from_numpy(x))
                leaves.append(jnp.asarray(x))
            jax_manager.arena[name] = JaxQuantSlab(*leaves)
        else:
            x = rng.standard_normal(slab.shape).astype(np.float32)
            slab.copy_(torch.from_numpy(x).to(slab.dtype))
            jax_manager.arena[name] = jnp.asarray(x).astype(
                jax_manager.arena[name].dtype
            )


def host_bits(x) -> np.ndarray:
    """A tensor or array as numpy, bf16 viewed as its 16-bit pattern."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        return x.numpy()
    x = np.asarray(x)
    return x.view(np.uint16) if x.dtype == ml_dtypes.bfloat16 else x


def arena_bits(manager):
    out = []
    for name in ("k", "v"):
        slab = manager.arena[name]
        leaves = slab if isinstance(slab, (QuantSlab, JaxQuantSlab)) else [slab]
        out.extend(host_bits(leaf) for leaf in leaves)
    return out


def managers(quant, num_pages=16):
    kw = dict(num_layers=2, num_pages=num_pages, page_size=4, n_kv_heads=2,
              head_dim=64, quant=quant, prefix_cache=True)
    return (CacheManager(**kw, dtype=torch.bfloat16, device="cpu"),
            JaxManager(**kw, dtype=jnp.bfloat16))


@pytest.mark.parametrize("quant", [None, "int4"])
def test_copy_on_write_export_install_match_jax(quant):
    """A published 3-page prompt, a second session adopting it and
    settling at 11 tokens (its next token writes into the shared third
    page: one copy-on-write), an export of the second session's sealed
    pages and (bf16) their install into a fresh standby pair: identical
    slots, lengths, counters, exports and arena bits on both sides."""
    ours, theirs = managers(quant)
    fill(ours, theirs, quant, np.random.default_rng(7))
    chain = prefix.page_hash_chain(np.arange(12) * 3, 4)

    async def drive(m):
        seen = []
        async with m.allocate(1, 20) as h:
            assert m.adopt_prefix(h, [chain]) == [0]
            seen.append(m.write_slots(h, 12))
        async with m.allocate(1, 20) as h:
            seen.append(m.adopt_prefix(h, [chain]))
            m.trim_adopted(h, 11)
            seen.append(m.write_slots(h, 1))  # copy-on-write of page 2
            seen.append(m.write_slots(h, 4))
            seen.append(m.table.seq(h.seq_ids[0]).pages)
            seen.append(sorted(m.prefix_stats().items()))
            seen.extend(arena_bits(m))
            exp = m.export_pages(h.seq_ids[0], 0, 4)
            if quant is None:
                seen.extend(host_bits(x) for x in exp[:2])
                seen.append(exp[2])
            else:
                assert exp is None and not m.repl_supported
        seen.append(m.table.counts())
        return seen, exp

    got, exp_ours = asyncio.run(drive(ours))
    want, exp_theirs = asyncio.run(drive(theirs))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    assert ours.table.cow_count == 1
    if quant is not None:
        return

    # install the exported pages into fresh standbys, as kv_put does:
    # [L, n*ps, kv, hd] -> [n, L, ps, kv, hd], in chain order
    n = exp_theirs[2]
    sb_ours, sb_theirs = managers(None, num_pages=8)
    fill(sb_ours, sb_theirs, None, np.random.default_rng(8))
    full = prefix.page_hash_chain(np.arange(16) * 3, 4)

    def pages(x):
        a = host_bits(x)
        if a.dtype == np.uint16:
            a = a.view(ml_dtypes.bfloat16)
        a = a.reshape(a.shape[0], n, 4, *a.shape[2:]).swapaxes(0, 1)
        return np.ascontiguousarray(a)

    k, v = pages(exp_theirs[0]), pages(exp_theirs[1])
    k_t = torch.from_numpy(k.astype(np.float32)).to(torch.bfloat16)
    v_t = torch.from_numpy(v.astype(np.float32)).to(torch.bfloat16)
    assert sb_ours.install_replicated(full[:n], k_t, v_t) == n
    assert sb_theirs.install_replicated(full[:n], k, v) == n
    # already pooled: nothing to install the second time
    assert sb_ours.install_replicated(full[:n], k_t, v_t) == 0
    assert sb_theirs.install_replicated(full[:n], k, v) == 0
    for g, w in zip(arena_bits(sb_ours), arena_bits(sb_theirs)):
        np.testing.assert_array_equal(g, w)
    assert sb_ours.table.counts() == sb_theirs.table.counts()
    assert sb_ours.prefix_stats() == {
        **sb_theirs.prefix_stats(), "arena_epoch": 0
    }
    with pytest.raises(ValueError):
        sb_ours.install_replicated(full[:1], k_t, v_t)


# -------------------------------------------------------------- (d) served
def jax_prefix_server(model_dir, reg_port, uid, start, end, **kw):
    return JaxServer(
        model_uid=uid, start=start, end=end, model_dir=model_dir,
        registry=j_registry.RegistryClient("127.0.0.1", reg_port),
        compute_dtype=jnp.float32, num_pages=64, page_size=4,
        prefix_cache=True, **kw,
    )


def port_prefix_client(model_dir, reg_port, uid, use_push=False):
    rc = RegistryClient("127.0.0.1", reg_port)
    REGISTRY_CLIENTS.append(rc)
    return DistributedModelForCausalLM.from_pretrained(
        model_dir, rc, model_uid=uid, device="cpu",
        config=ClientConfig(use_push=use_push, prefix_cache=True),
    )


def jax_prefix_client(model_dir, reg_port, uid, use_push=False):
    rc = j_registry.RegistryClient("127.0.0.1", reg_port)
    REGISTRY_CLIENTS.append(rc)
    return JaxModel.from_pretrained(
        model_dir, rc, model_uid=uid,
        config=JaxClientConfig(use_push=use_push, prefix_cache=True),
    )


def prefix_prompts(config):
    """A: 3 pages; B: A's first 2 pages + 5 tokens of its own; A again."""
    rng = np.random.default_rng(11)
    a = rng.integers(0, config.vocab_size, size=(1, 12))
    b = np.concatenate([a[:, :8], rng.integers(0, config.vocab_size,
                                               size=(1, 5))], axis=1)
    return [a, b, a]


def pool_counters(server):
    stats = server.manager.prefix_stats()
    return {k: stats[k] for k in ("prefix_hits", "prefix_hit_tokens",
                                  "cow_copies")}


def no_referenced_pages(server):
    c = server.manager.table.counts()
    assert c["free"] + c["referenced"] + c["cached"] == \
        server.manager.table.num_pages
    return c["referenced"] == 0


async def settle(servers, timeout=5.0):
    """Wait for the servers' session teardown (asynchronous after the
    client closes) to release every referenced page."""
    for _ in range(int(timeout / 0.05)):
        if all(no_referenced_pages(s) for s in servers):
            return
        await asyncio.sleep(0.05)
    raise AssertionError("pages still referenced after every session closed")


@pytest.mark.parametrize("use_push", [False, True], ids=["relay", "push"])
def test_prefix_cache_served_matches_hf_and_jax_counters(
    loop, tiny_model_dir, registry, use_push
):
    """The port client through two port servers with the prefix cache, and
    the JAX client through two JAX servers, run A, B and A again: HF's
    greedy tokens on both, and every server's hits, hit tokens and copies
    equal across the packages (B adopts 2 pages, the second A adopts 3
    and is trimmed to 11 tokens, so its suffix copies the third page)."""
    model_dir, hf_model, config = tiny_model_dir
    uid = f"pfx-{use_push}"
    ours = [port_server(model_dir, registry.port, uid, 0, 2,
                        prefix_cache=True),
            port_server(model_dir, registry.port, uid, 2, 3,
                        prefix_cache=True)]
    theirs = [jax_prefix_server(model_dir, registry.port, uid + "j", 0, 2),
              jax_prefix_server(model_dir, registry.port, uid + "j", 2, 3)]
    run(loop, start_all(*ours, *theirs))
    try:
        assert all(s.server_info().page_size == 4 for s in ours)
        assert all(s.server_info().kv_repl for s in ours)
        model = port_prefix_client(model_dir, registry.port, uid, use_push)
        jmodel = jax_prefix_client(model_dir, registry.port, uid + "j",
                                   use_push)
        for p in prefix_prompts(config):
            want = hf_greedy(hf_model, p, 6)
            got = run(loop, model.generate(p, max_new_tokens=6))
            np.testing.assert_array_equal(got.numpy(), want)
            np.testing.assert_array_equal(
                run(loop, jmodel.generate(p, max_new_tokens=6)), want
            )
        run(loop, settle(ours + theirs))
        for s, js in zip(ours, theirs):
            assert pool_counters(s) == pool_counters(js)
            assert pool_counters(s) == {
                "prefix_hits": 2, "prefix_hit_tokens": 8 + 11,
                "cow_copies": 1,
            }
        info = run(loop, ours[0]._rpc_info({}, []))[0]
        assert info["prefix_hit_tokens"] == 19
        assert info["page_size"] == 4 and info["kv_repl"] is True
    finally:
        run(loop, stop_all(*ours, *theirs))


def test_prefix_cache_mixed_packages(loop, tiny_model_dir, registry):
    """A JAX client adopts on port servers, and the port client on JAX
    servers, both with HF's tokens: the chains and the probe, skip and
    adoption frames cross the packages."""
    model_dir, hf_model, config = tiny_model_dir
    ports = [port_server(model_dir, registry.port, "pfxm", 0, 2,
                         prefix_cache=True),
             port_server(model_dir, registry.port, "pfxm", 2, 3,
                         prefix_cache=True)]
    jaxs = [jax_prefix_server(model_dir, registry.port, "pfxmj", 0, 2),
            jax_prefix_server(model_dir, registry.port, "pfxmj", 2, 3)]
    run(loop, start_all(*ports, *jaxs))
    try:
        a, b, _ = prefix_prompts(config)
        for model, servers in (
            (jax_prefix_client(model_dir, registry.port, "pfxm"), ports),
            (port_prefix_client(model_dir, registry.port, "pfxmj"), jaxs),
        ):
            for p in (a, b):
                got = np.asarray(run(loop, model.generate(
                    p, max_new_tokens=6)))
                np.testing.assert_array_equal(got, hf_greedy(hf_model, p, 6))
            run(loop, settle(servers))
            for s in servers:
                assert pool_counters(s)["prefix_hit_tokens"] == 8
    finally:
        run(loop, stop_all(*ports, *jaxs))


def test_spec_batch_after_prefix_adoption(
    loop, tiny_model_dir, registry, monkeypatch
):
    """Prefix adoption composes with batched tree verification: a cold
    speculating session publishes a shared prompt prefix; two later
    speculating sessions (one adopting that prefix, its first tree step
    on the solo path until the adoption settles) group their tree-verify
    steps and stay HF-exact (the analog of test_spec_decode.py's
    test_e2e_spec_batch_after_prefix_adoption)."""
    from bloombee_tpu_torch.client.speculative import generate_speculative
    from bloombee_tpu_torch.spec.drafter import (
        GreedyTreeDrafter,
        LocalDraftModel,
    )

    model_dir, hf_model, config = tiny_model_dir
    monkeypatch.setenv("BBTPU_BATCH_WINDOW_MS", "500")
    server = port_server(model_dir, registry.port, "pfxspec", 0, 3,
                         spec_batch=True, prefix_cache=True)
    run(loop, start_all(server))
    try:
        model = port_prefix_client(model_dir, registry.port, "pfxspec")
        draft = LocalDraftModel.from_dir(model_dir, device="cpu")
        shared = (np.arange(8)[None, :] * 7 + 1) % config.vocab_size
        long_ids = np.concatenate(
            [shared, (np.arange(8)[None, :] * 3 + 2) % config.vocab_size],
            axis=1,
        )
        other = np.random.default_rng(29).integers(
            0, config.vocab_size, size=(1, 6)
        )

        def spec(p):
            return generate_speculative(
                model, GreedyTreeDrafter(draft, branching=(2, 1)), p,
                max_new_tokens=6,
            )

        cold = run(loop, spec(shared)).numpy()
        np.testing.assert_array_equal(cold, hf_greedy(hf_model, shared, 6))

        async def both():
            return await asyncio.gather(spec(long_ids), spec(other))

        for p, got in zip((long_ids, other), run(loop, both())):
            np.testing.assert_array_equal(got.numpy(),
                                          hf_greedy(hf_model, p, 6))
        assert server.manager.prefix_stats()["prefix_hits"] >= 1
        assert server.tree_group_dispatches > 0
        run(loop, settle([server]))
    finally:
        run(loop, stop_all(server))


def test_adoption_settles_on_first_chunk_of_chunked_mixed_prefill(
    loop, tiny_model_dir, registry
):
    """Servers that chunk prefills (4 tokens) and fuse chunks with decodes
    (mixed batch): an adopting session's suffix prefill is a chunk stream
    whose first chunk settles the adoption on the solo chunk path; HF's
    tokens, the same hits as a monolithic server, no page left
    referenced."""
    model_dir, hf_model, config = tiny_model_dir
    servers = [port_server(model_dir, registry.port, "pfxchunk", a, b,
                           prefix_cache=True, prefill_chunk=4,
                           mixed_batch=True)
               for a, b in ((0, 2), (2, 3))]
    run(loop, start_all(*servers))
    try:
        model = port_prefix_client(model_dir, registry.port, "pfxchunk")
        for p in prefix_prompts(config):
            got = run(loop, model.generate(p, max_new_tokens=6)).numpy()
            np.testing.assert_array_equal(got, hf_greedy(hf_model, p, 6))
        run(loop, settle(servers))
        for s in servers:
            assert pool_counters(s) == {
                "prefix_hits": 2, "prefix_hit_tokens": 19, "cow_copies": 1,
            }
            assert s.prefill_chunks > 0
    finally:
        run(loop, stop_all(*servers))

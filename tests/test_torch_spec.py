"""The port's speculative decoding on the CPU, against HF and the JAX
package.

A tiny Llama at head_dim 64 (3 layers, hidden 128, 2 heads, 1 KV head,
vocab 128, f32), inside the CUDA kernels' shape domain, served by port
servers built with BBTPU_PAGED_MIN_CONTEXT=0 (page_size 4): a solo tree
verify takes the paged chunk route and a tree group the paged ragged
route, whose plain versions run here, on real trees (node 0 the bonus
token, siblings at equal depths). The loop, registry and server helpers
are tests/test_torch_server.py's:

- the numpy tree, accept and shape functions equal JAX's exactly;
- `accept_speculative` leaves a bf16 and an int4 `CacheManager` with the
  JAX manager's arena contents and lengths, bit for bit;
- `LocalDraftModel`'s logits (cached and uncached) are within 1e-5 of
  `LocalJaxDraftModel`'s and its trees identical; `MidLMHead`'s
  probabilities are within 1e-5 and the simple pruner's keep sets
  identical;
- end to end through two port servers, the port client's
  `generate_speculative` equals HF greedy and the port's plain `generate`
  (B=1, B=4 with ragged accepts, the adaptive drafter, pruned relay
  chains), and a seeded sampling run draws the JAX client's tokens;
- mixed chains both ways: the JAX client speculates through port servers,
  the port client through a JAX span and a port span;
- `spec_batch`: 4 concurrent sessions share tree groups with the same
  tokens, and a failed tree group replays solo with the same tokens;
  the gather predicates with tree keys answer as the JAX server's;
- the refusals that remain: the neural pruner and pruner training.
"""

import asyncio
import itertools
import logging
import types

import ml_dtypes
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bloombee_tpu.client.speculative import (
    generate_speculative as jax_generate_speculative,
)
from bloombee_tpu.kv.cache_manager import CacheManager as JaxManager
from bloombee_tpu.kv.quant import QuantSlab as JaxQuantSlab
from bloombee_tpu.models.checkpoint import (
    load_client_params as jax_client_params,
)
from bloombee_tpu.server.block_server import BlockServer as JaxServer
from bloombee_tpu.spec import pruner as j_pruner
from bloombee_tpu.spec import shape as j_shape
from bloombee_tpu.spec import tree as j_tree
from bloombee_tpu.spec import verify as j_verify
from bloombee_tpu.spec.drafter import GreedyTreeDrafter as JaxDrafter
from bloombee_tpu.spec.drafter import LocalJaxDraftModel
from bloombee_tpu_torch.client import ClientConfig, DistributedModelForCausalLM
from bloombee_tpu_torch.client.speculative import generate_speculative
from bloombee_tpu_torch.kv.cache_manager import CacheManager
from bloombee_tpu_torch.kv.quant import QuantSlab
from bloombee_tpu_torch.models.checkpoint import (
    load_client_params,
    load_span_params,
)
from bloombee_tpu_torch.server import block_server as t_server
from bloombee_tpu_torch.server.block_server import BlockServer
from bloombee_tpu_torch.spec import pruner, shape, tree, verify
from bloombee_tpu_torch.spec.drafter import GreedyTreeDrafter, LocalDraftModel
from bloombee_tpu_torch.swarm.registry import RegistryClient
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
)

EPS = 1e-5
N_NEW = 8


@pytest.fixture(scope="module")
def tiny_model_dir(tmp_path_factory):
    from transformers import LlamaConfig, LlamaForCausalLM

    config = LlamaConfig(
        hidden_size=128,
        intermediate_size=256,
        num_attention_heads=2,
        num_key_value_heads=1,
        num_hidden_layers=3,
        vocab_size=128,
        max_position_embeddings=256,
        rms_norm_eps=1e-5,
        tie_word_embeddings=False,
    )
    torch.manual_seed(0)
    model = LlamaForCausalLM(config).eval().to(torch.float32)
    d = tmp_path_factory.mktemp("tiny_llama_hd64")
    model.save_pretrained(d, safe_serialization=True)
    return str(d), model, config


def kernel_route_server(model_dir, reg_port, uid, start, end, **kw):
    """A port server whose executor takes the kernel routes at any
    context (their plain versions on the CPU)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("BBTPU_PAGED_MIN_CONTEXT", "0")
        server = port_server(model_dir, reg_port, uid, start, end, **kw)
    assert server.executor.paged_min_context == 0
    return server


@pytest.fixture(scope="module")
def port_chain(loop, tiny_model_dir, registry):
    """Two port servers, blocks [0, 2) and [2, 3), model uid "tiny"."""
    model_dir = tiny_model_dir[0]
    servers = [
        kernel_route_server(model_dir, registry.port, "tiny", 0, 2),
        kernel_route_server(model_dir, registry.port, "tiny", 2, 3),
    ]
    run(loop, start_all(*servers))
    yield servers
    run(loop, stop_all(*servers))


def port_client(model_dir, reg_port, uid, use_push=True):
    rc = RegistryClient("127.0.0.1", reg_port)
    REGISTRY_CLIENTS.append(rc)
    return DistributedModelForCausalLM.from_pretrained(
        model_dir, rc, model_uid=uid, device="cpu",
        config=ClientConfig(use_push=use_push),
    )


def prompts(config, b, seed, s=5):
    return np.random.default_rng(seed).integers(
        0, config.vocab_size, size=(b, s)
    )


@pytest.fixture(scope="module")
def drafters(tiny_model_dir):
    """The port's draft models: the whole tiny model (self-drafting, every
    draft accepted) and its first block under the client head (a shallow
    drafter whose drafts are often rejected, so rows accept raggedly)."""
    model_dir = tiny_model_dir[0]
    full = LocalDraftModel.from_dir(model_dir, device="cpu")
    blocks, spec = load_span_params(model_dir, 0, 1, device="cpu")
    shallow = LocalDraftModel(
        spec, blocks, load_client_params(model_dir, device="cpu"),
        device="cpu",
    )
    return full, shallow


def spec_tokens(loop, model, drafter, input_ids, **kw):
    return run(loop, generate_speculative(
        model, drafter, input_ids, max_new_tokens=N_NEW, **kw
    ))


def plain_tokens(loop, model, input_ids, new=N_NEW):
    return run(loop, model.generate(input_ids, max_new_tokens=new)).numpy()


# ------------------------------------------------- tree / verify / shape
def random_tree(rng, t):
    parents = [-1] + [int(rng.integers(-1, i)) for i in range(1, t)]
    return rng.integers(0, 16, size=t), np.asarray(parents, np.int32)


@pytest.mark.parametrize("seed", range(4))
def test_tree_functions_match_jax(seed):
    rng = np.random.default_rng(seed)
    toks, parents = random_tree(rng, 9)
    jt, tt = j_tree.DraftTree(toks, parents), tree.DraftTree(toks, parents)
    np.testing.assert_array_equal(tt.depths(), jt.depths())
    np.testing.assert_array_equal(tree.tree_attention_mask(tt),
                                  j_tree.tree_attention_mask(jt))
    for node in range(-1, 9):
        np.testing.assert_array_equal(tt.children_of(node),
                                      jt.children_of(node))
        if node >= 0:
            assert tt.path_to(node) == jt.path_to(node)
    mask = np.stack([tree.tree_attention_mask(tt)] * 2)
    depths = np.stack([tt.depths()] * 2)
    keep = np.asarray([[0, 2, 5, -1], [1, 3, -1, -1]], np.int32)
    for got, want in zip(tree.pruned_step_arrays(mask, depths, keep),
                         j_tree.pruned_step_arrays(mask, depths, keep)):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tree.chain_tree(toks).parents,
                                  j_tree.chain_tree(toks).parents)
    with pytest.raises(ValueError):
        tree.DraftTree([1, 2], [1, -1])


@pytest.mark.parametrize("seed", range(4))
def test_accept_rules_match_jax(seed):
    """Greedy and sampling accepts on seeded logits (peaked so that paths
    get accepted), with the same seeded numpy generator each."""
    rng = np.random.default_rng(seed)
    toks, parents = random_tree(rng, 10)
    v = 16
    logits = rng.standard_normal((10, v)).astype(np.float32)
    root = rng.standard_normal(v).astype(np.float32)
    # make the target agree with some drafted children
    root[toks[0]] += 4.0
    for i in range(10):
        kids = np.nonzero(parents == i)[0]
        if len(kids):
            logits[i, toks[kids[0]]] += 4.0 * (seed % 2)
    verifiable = rng.random(10) > 0.2
    jt, tt = j_tree.DraftTree(toks, parents), tree.DraftTree(toks, parents)
    for ver in (None, verifiable):
        assert verify.accept_greedy(tt, root, logits, ver) == \
            j_verify.accept_greedy(jt, root, logits, ver)
    probs = np.abs(rng.standard_normal((10, v)))
    for temp in (0.7, 1.0):
        got = verify.accept_sampling(tt, root, logits, probs,
                                     np.random.default_rng(seed), temp)
        want = j_verify.accept_sampling(jt, root, logits, probs,
                                        np.random.default_rng(seed), temp)
        assert got == want


def test_shape_chooser_matches_jax():
    rng = np.random.default_rng(3)
    ours, theirs = shape.AcceptanceStats(), j_shape.AcceptanceStats()
    for cand in shape.DEFAULT_CANDIDATES:
        assert shape.tree_nodes(cand) == j_shape.tree_nodes(cand)
    for _ in range(60):
        branching = shape.DEFAULT_CANDIDATES[rng.integers(8)]
        a = int(rng.integers(0, len(branching) + 1))
        ours.observe(a, branching)
        theirs.observe(a, branching)
        for d in range(4):
            assert ours.per_child_rate(d) == theirs.per_child_rate(d)
        for cand in shape.DEFAULT_CANDIDATES:
            assert shape.expected_accepted(cand, ours) == \
                j_shape.expected_accepted(cand, theirs)
        for budget, cost in ((16, 0.0), (11, 0.05), (4, 0.2)):
            assert shape.choose_branching(
                ours, budget_nodes=budget, cost_per_node=cost,
                current=(2, 2), grow_margin=0.1,
            ) == j_shape.choose_branching(
                theirs, budget_nodes=budget, cost_per_node=cost,
                current=(2, 2), grow_margin=0.1,
            )


# ------------------------------------------------------ accept_speculative
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
            slab.copy_(torch.from_numpy(x).to(torch.bfloat16))
            jax_manager.arena[name] = jnp.asarray(x).astype(jnp.bfloat16)


def arena_host(manager, jax_side):
    out = []
    for name in ("k", "v"):
        slab = manager.arena[name]
        leaves = slab if isinstance(slab, (QuantSlab, JaxQuantSlab)) else [slab]
        for leaf in leaves:
            if jax_side:
                x = np.asarray(leaf)
                out.append(x.view(np.uint16) if x.dtype == ml_dtypes.bfloat16
                           else x)
            else:
                x = leaf.view(torch.int16) if leaf.dtype == torch.bfloat16 \
                    else leaf
                x = x.numpy()
                out.append(x.view(np.uint16) if x.dtype == np.int16 else x)
    return out


@pytest.mark.parametrize("quant", [None, "int4"])
def test_accept_speculative_matches_jax(quant):
    """Two rounds of tree writes and accepts on a 2-row handle: the same
    arena contents (bit for bit) and lengths. Row 0's accept [0, 2, 5]
    reads slot 2, which is also the destination of its index 2, so the
    reads must all happen before the writes."""
    kw = dict(num_layers=2, num_pages=32, page_size=4, n_kv_heads=2,
              head_dim=64, quant=quant)
    ours = CacheManager(**kw, dtype=torch.bfloat16, device="cpu")
    theirs = JaxManager(**kw, dtype=jnp.bfloat16)
    fill(ours, theirs, quant, np.random.default_rng(5))

    async def drive(manager):
        seen = []
        async with manager.allocate(2, 60) as h:
            seen.append(manager.write_slots(h, 9))
            seen.append(manager.write_slots(h, 7, commit=False))
            manager.accept_speculative(h, [[0, 2, 5], [0, 1, 3, 6]])
            seen.append(manager.context_lens(h))
            seen.append(manager.write_slots(h, 5, commit=False))
            manager.accept_speculative(h, [[0, 4], []])
            seen.append(manager.context_lens(h))
            seen.append(manager.context_lens(h, committed_only=True))
            seen.append(manager.page_table(h, 8))
            seen.extend(arena_host(manager, manager is theirs))
        return seen

    for got, want in zip(asyncio.run(drive(ours)),
                         asyncio.run(drive(theirs))):
        np.testing.assert_array_equal(got, want)


# -------------------------------------------------------- drafter, pruner
@pytest.fixture(scope="module")
def draft_pair(tiny_model_dir):
    model_dir = tiny_model_dir[0]
    return (LocalDraftModel.from_dir(model_dir, device="cpu"),
            LocalJaxDraftModel.from_dir(model_dir))


def test_draft_model_logits_and_trees_match_jax(draft_pair):
    ours, theirs = draft_pair
    contexts = [[1, 5, 9, 2], [3, 3, 3, 3, 3, 7, 100]]
    np.testing.assert_allclose(ours.last_logits_ragged(contexts),
                               theirs.last_logits_ragged(contexts),
                               atol=EPS, rtol=0)
    caches, lens, logits = ours.prefill_ragged(contexts)
    j_caches, j_lens, j_logits = theirs.prefill_ragged(contexts)
    np.testing.assert_array_equal(lens, j_lens)
    np.testing.assert_allclose(logits, j_logits, atol=EPS, rtol=0)
    # the first tree level's shape: build_batch below reuses its compile
    row_of = np.asarray([0, 0, 1, 1])
    suffix = np.asarray([[4], [9], [11], [12]])
    np.testing.assert_allclose(
        ours._suffix_logits(caches, lens, row_of, suffix),
        np.asarray(theirs._suffix_logits(
            j_caches, jnp.asarray(j_lens), jnp.asarray(row_of),
            jnp.asarray(suffix),
        )),
        atol=EPS, rtol=0,
    )
    trees, probs = GreedyTreeDrafter(ours).build_batch(contexts)
    j_trees, j_probs = JaxDrafter(theirs).build_batch(contexts)
    for t, jt, p, jp in zip(trees, j_trees, probs, j_probs):
        np.testing.assert_array_equal(t.tokens, jt.tokens)
        np.testing.assert_array_equal(t.parents, jt.parents)
        np.testing.assert_allclose(p, jp, atol=EPS, rtol=0)


def test_drafter_refuses_a_family_the_port_cannot_run(draft_pair):
    import dataclasses

    spec = dataclasses.replace(draft_pair[0].spec, family="bloom",
                               alibi=True)
    with pytest.raises(NotImplementedError, match="bloom.*ALiBi"):
        LocalDraftModel(spec, [], {}, device="cpu")


def test_mid_head_and_simple_pruner_match_jax(tiny_model_dir, tmp_path):
    """The head over the checkpoint's norm + lm_head (and over a head the
    JAX trainer saved), and the simple pruner's keep sets on each
    package's own probabilities."""
    model_dir, _, config = tiny_model_dir
    rng = np.random.default_rng(9)
    hidden = rng.standard_normal(
        (12, config.hidden_size)
    ).astype(np.float32) * 3
    jc = jax_client_params(model_dir, dtype=jnp.float32)
    tc = load_client_params(model_dir, device="cpu")
    j_head = j_pruner.MidLMHead(jc["lm_head"], jc["norm"], 1e-5)
    head = pruner.MidLMHead(tc["lm_head"], tc["norm"], 1e-5)
    probs, j_probs = head.probs(hidden), j_head.probs(hidden)
    np.testing.assert_allclose(probs, j_probs, atol=EPS, rtol=0)

    ckpt = str(tmp_path / "head")
    j_pruner.MidHeadTrainer(j_head).save(ckpt)
    loaded = pruner.MidHeadTrainer.load(ckpt, device="cpu").head
    np.testing.assert_allclose(loaded.probs(hidden), j_probs, atol=EPS,
                               rtol=0)

    toks = np.argsort(-probs, axis=-1)[:, 1]
    parents = np.asarray([-1, 0, 0, 1, 1, 2, 2, 3, 4, 5, 6], np.int32)
    t_tree = tree.DraftTree(toks[:11], parents)
    j_tree_ = j_tree.DraftTree(toks[:11], parents)
    for threshold, cap in ((0.05, None), (0.3, None), (0.05, 5)):
        got = pruner.SimpleProbabilityPruner(threshold, cap).keep_indices(
            t_tree, probs[1:], probs[0]
        )
        want = j_pruner.SimpleProbabilityPruner(threshold, cap).keep_indices(
            j_tree_, j_probs[1:], j_probs[0]
        )
        np.testing.assert_array_equal(got, want)
    mgr, j_mgr = pruner.PrunerManager(0.2), j_pruner.PrunerManager(0.2)
    np.testing.assert_array_equal(
        mgr.prune(t_tree, hidden[1:], hidden[0], tc["lm_head"]),
        j_mgr.prune(j_tree_, hidden[1:], hidden[0], jc["lm_head"]),
    )


def test_neural_pruner_and_training_refused(tiny_model_dir, monkeypatch):
    """Both learn by gradient (ROADMAP item 17): refused loudly, at the
    pruner and at the server's start, never downgraded."""
    with pytest.raises(NotImplementedError, match="item 17"):
        pruner.PrunerManager(method="neural")
    for var, value in (("BBTPU_PRUNER_METHOD", "neural"),
                       ("BBTPU_PRUNER_TRAIN", "1")):
        with monkeypatch.context() as mp:
            mp.setenv(var, value)
            with pytest.raises(NotImplementedError, match=f"{var}.*item 17"):
                port_server(tiny_model_dir[0], 1, "refused", 0, 1)


def test_prune_without_a_head_keeps_the_full_tree(tiny_model_dir):
    """A server built from in-memory parameters has no checkpoint head:
    `_prune_tree` returns None, as the JAX server's does, and the client
    then verifies the full tree."""
    model_dir, _, config = tiny_model_dir
    params, spec = load_span_params(model_dir, 0, 1, device="cpu")
    server = BlockServer(model_uid="nohead", start=0, end=1, params=params,
                         spec=spec, num_pages=8, page_size=4,
                         compute_dtype=torch.float32, device="cpu")
    asyncio.run(server._ensure_pruner_loaded())
    prune = {"threshold": 0.5, "tokens": [[1, 2, 3]],
             "parents": [-1, 0, 0]}
    out = torch.zeros(1, 3, config.hidden_size)
    assert server._prune_tree(out, prune) is None


# --------------------------------------------------------- end to end
@pytest.mark.parametrize("b,which", [(1, "full"), (4, "shallow")])
def test_speculative_matches_hf_and_plain_generate(
    loop, tiny_model_dir, registry, port_chain, drafters, b, which
):
    """B=1 self-drafted (every draft accepted: multi-token compaction)
    and B=4 with the shallow drafter (rows accept different counts and
    finish in different rounds: live-row windows)."""
    model_dir, hf_model, config = tiny_model_dir
    model = port_client(model_dir, registry.port, "tiny")
    drafter = GreedyTreeDrafter(drafters[which == "shallow"])
    input_ids = prompts(config, b, seed=b)
    got = spec_tokens(loop, model, drafter, input_ids)
    assert got.shape == (b, 5 + N_NEW)
    np.testing.assert_array_equal(got, hf_greedy(hf_model, input_ids, N_NEW))
    np.testing.assert_array_equal(got, plain_tokens(loop, model, input_ids))
    rate = drafter.accept_rate
    assert rate > 0.9 if which == "full" else 0.0 < rate < 0.9


def test_adaptive_drafter_stays_exact(loop, tiny_model_dir, registry,
                                      port_chain, drafters):
    model_dir, hf_model, config = tiny_model_dir
    model = port_client(model_dir, registry.port, "tiny", use_push=False)
    drafter = GreedyTreeDrafter(drafters[1], branching=(2, 2, 1),
                                adaptive=True, retune_every=2)
    input_ids = prompts(config, 2, seed=11)
    got = run(loop, generate_speculative(model, drafter, input_ids,
                                         max_new_tokens=16))
    np.testing.assert_array_equal(got, hf_greedy(hf_model, input_ids, 16))
    assert drafter._rounds >= 2


def test_sampling_draws_the_jax_clients_tokens(
    loop, tiny_model_dir, registry, port_chain, drafters, draft_pair
):
    """Seeded rejection sampling through the same port servers: the port
    client and the JAX client (each with its own self-drafter) draw the
    same tokens."""
    model_dir, _, config = tiny_model_dir
    input_ids = prompts(config, 2, seed=13)
    kw = dict(max_new_tokens=N_NEW, do_sample=True, temperature=0.8, seed=3)
    got = run(loop, generate_speculative(
        port_client(model_dir, registry.port, "tiny"),
        GreedyTreeDrafter(drafters[0]), input_ids, **kw,
    ))
    want = run(loop, jax_generate_speculative(
        jax_client(model_dir, registry.port, "tiny"),
        JaxDrafter(draft_pair[1]), input_ids, **kw,
    ))
    np.testing.assert_array_equal(got, want)


def test_pruned_relay_chain_matches_hf_and_jax_keep_sets(
    loop, tiny_model_dir, registry, port_chain, drafters, monkeypatch
):
    """Mid-chain pruning in relay mode: span 0 keeps the MidLMHead's
    survivors, span 1 verifies the smaller tree, tokens stay HF greedy;
    each keep set equals the JAX server's `_prune_tree` on the same span
    output, and some nodes were pruned."""
    model_dir, hf_model, config = tiny_model_dir
    first = port_chain[0]
    calls = []
    orig = first._prune_tree

    def spy(out, prune):
        keep = orig(out, prune)
        calls.append((out.float().numpy(), prune, keep))
        return keep

    monkeypatch.setattr(first, "_prune_tree", spy)
    model = port_client(model_dir, registry.port, "tiny", use_push=False)
    input_ids = prompts(config, 2, seed=5)
    got = spec_tokens(loop, model, GreedyTreeDrafter(drafters[1],
                                                     branching=(2, 2)),
                      input_ids, prune_threshold=0.45)
    np.testing.assert_array_equal(got, hf_greedy(hf_model, input_ids, N_NEW))
    jc = jax_client_params(model_dir, dtype=jnp.float32)
    j_mgr = j_pruner.PrunerManager()
    j_mgr.ensure_head(jc["lm_head"], jc["norm"], 1e-5)
    j_self = types.SimpleNamespace(
        _ensure_pruner=lambda th: (j_mgr.set_request_threshold(th), j_mgr)[1]
    )
    assert calls
    for out, prune, keep in calls:
        np.testing.assert_array_equal(
            keep, JaxServer._prune_tree(j_self, out, prune)
        )
    assert any((keep < 0).any() for _, _, keep in calls)


def test_jax_client_speculates_through_port_servers(
    loop, tiny_model_dir, registry, port_chain, draft_pair
):
    model_dir, hf_model, config = tiny_model_dir
    input_ids = prompts(config, 2, seed=17)
    got = run(loop, jax_generate_speculative(
        jax_client(model_dir, registry.port, "tiny"),
        JaxDrafter(draft_pair[1], branching=(2, 1)), input_ids,
        max_new_tokens=N_NEW,
    ))
    np.testing.assert_array_equal(got, hf_greedy(hf_model, input_ids, N_NEW))
    assert sum(s.tree_steps for s in port_chain) > 0


def test_port_client_speculates_through_a_mixed_chain(
    loop, tiny_model_dir, registry, drafters
):
    """A JAX span [0, 2) then a port span [2, 3), push routing: the JAX
    server forwards the tree mask, depths and accept to the port server."""
    model_dir, hf_model, config = tiny_model_dir
    servers = [jax_server(model_dir, registry.port, "mixspec", 0, 2),
               kernel_route_server(model_dir, registry.port, "mixspec", 2,
                                   3)]
    run(loop, start_all(*servers))
    try:
        model = port_client(model_dir, registry.port, "mixspec")
        input_ids = prompts(config, 2, seed=19)
        got = spec_tokens(loop, model, GreedyTreeDrafter(drafters[0]),
                          input_ids)
    finally:
        run(loop, stop_all(*servers))
    np.testing.assert_array_equal(got, hf_greedy(hf_model, input_ids, N_NEW))
    assert servers[1].tree_steps > 0 and servers[1].spec_tokens_accepted > 0


# ------------------------------------------------------------- spec_batch
@pytest.fixture(scope="module")
def spec_batch_server(loop, tiny_model_dir, registry):
    """One port server over all 3 blocks with batched tree verification,
    model uid "specb"."""
    server = kernel_route_server(tiny_model_dir[0], registry.port, "specb",
                                 0, 3, spec_batch=True)
    assert server.spec_batch and server.max_batch == 8
    run(loop, start_all(server))
    yield server
    run(loop, stop_all(server))


def concurrent(loop, tiny_model_dir, registry, drafters, n=4):
    model_dir, _, config = tiny_model_dir
    model = port_client(model_dir, registry.port, "specb")
    inputs = [prompts(config, 1, seed=30 + i, s=5 + i) for i in range(n)]

    async def go():
        return await asyncio.gather(*(
            generate_speculative(model, GreedyTreeDrafter(drafters[i % 2]),
                                 p, max_new_tokens=N_NEW)
            for i, p in enumerate(inputs)
        ))

    return inputs, run(loop, go()), model


def test_spec_batch_groups_concurrent_sessions(
    loop, tiny_model_dir, registry, spec_batch_server, drafters, monkeypatch
):
    """4 concurrent speculating sessions (two self-drafted, two shallow):
    tree groups form, their tokens equal HF greedy and the port's plain
    generate, and rpc_info reports the tree counters."""
    monkeypatch.setenv("BBTPU_BATCH_WINDOW_MS", "200")
    _, hf_model, _ = tiny_model_dir
    server = spec_batch_server
    inputs, outs, model = concurrent(loop, tiny_model_dir, registry,
                                     drafters)
    for p, got in zip(inputs, outs):
        np.testing.assert_array_equal(got, hf_greedy(hf_model, p, N_NEW))
        np.testing.assert_array_equal(got, plain_tokens(loop, model, p))
    info = run(loop, server._rpc_info({}, []))[0]
    assert info["spec_batch"] is True
    assert info["tree_group_dispatches"] > 0
    assert info["mean_tree_batch_width"] > 1
    assert info["tree_steps"] == server.tree_steps > 0
    assert 0.0 < info["spec_accept_rate"] <= 1.0
    assert len(info["session_spec"]) >= 4


def test_failed_tree_group_replays_solo(
    loop, tiny_model_dir, registry, spec_batch_server, drafters, monkeypatch,
    caplog,
):
    """ragged_group fails once after it wrote every member's tree rows:
    each member is truncated to its pre-dispatch length and replays solo,
    and the tokens stay HF greedy."""
    monkeypatch.setenv("BBTPU_BATCH_WINDOW_MS", "200")
    _, hf_model, _ = tiny_model_dir
    server = spec_batch_server
    orig = server.executor.ragged_group
    calls = {"n": 0}

    def once(*a, **kw):
        out = orig(*a, **kw)
        calls["n"] += 1
        if calls["n"] == 1:
            raise RuntimeError("injected post-write fault")
        return out

    monkeypatch.setattr(server.executor, "ragged_group", once)
    solo_before = server.batch_solo_steps
    with caplog.at_level(logging.WARNING, logger=t_server.__name__):
        inputs, outs, _ = concurrent(loop, tiny_model_dir, registry,
                                     drafters, n=2)
    assert calls["n"] >= 1
    assert "replaying solo" in caplog.text
    assert server.batch_solo_steps - solo_before >= 2
    for p, got in zip(inputs, outs):
        np.testing.assert_array_equal(got, hf_greedy(hf_model, p, N_NEW))


def member(kind, layers=None, dtype="float32", t=4):
    key = (kind, layers, None, dtype) + ((t,) if kind == "chunkm" else ())
    return types.SimpleNamespace(key=key)


KEY_POOL = [
    member("decode1"), member("decode1", layers=(0, 2)), member("chunkm"),
    member("tree"), member("tree", layers=(0, 2)),
    member("tree", dtype="bfloat16"),
]


@pytest.mark.parametrize("mixed_batch,spec_batch,max_batch",
                         [(m, s, b) for m, s, b in itertools.product(
                             [False, True], [False, True], [1, 2, 3])
                          if s])
def test_tree_gather_predicates_match_jax(mixed_batch, spec_batch,
                                          max_batch):
    """With tree keys in the pool, the port's predicate and gather bound
    answer as the JAX server's on every group of up to 3 members and every
    candidate; `_tree_batchable` too."""
    sessions = {sid: types.SimpleNamespace(speculating=sid in "bd")
                for sid in "abcd"}
    ns = types.SimpleNamespace(
        mixed_batch=mixed_batch, spec_batch=spec_batch, max_batch=max_batch,
        _sessions=sessions, _draining=False,
    )
    for n in (1, 2, 3):
        for group in itertools.product(KEY_POOL, repeat=n):
            group = list(group)
            assert BlockServer._batch_group_hint(ns, group) == \
                JaxServer._batch_group_hint(ns, group)
            for cand in KEY_POOL:
                assert BlockServer._ragged_compat(ns, group, cand) == \
                    JaxServer._ragged_compat(ns, group, cand), (group, cand)
    mask, depths = np.ones((1, 3, 3), bool), np.zeros((1, 3), np.int32)
    for commit, tm, dep, lens, meta in itertools.product(
        (False, True), (None, mask), (None, depths), (None, [3]),
        ({}, {"prune": {"threshold": 0.1}}),
    ):
        assert BlockServer._tree_batchable(ns, commit, tm, dep, lens, meta) \
            == JaxServer._tree_batchable(ns, commit, tm, dep, lens, meta)


def test_remaining_step_refusals_and_spec_env():
    """Speculative keys are served, and so are chained decode_n's since
    the server serves decode_n: no step key is refused any more."""
    assert not hasattr(t_server, "REFUSED_STEP_KEYS")
    from bloombee_tpu_torch.utils import env

    for name in ("BBTPU_SPEC_BATCH", "BBTPU_PRUNER_METHOD",
                 "BBTPU_PRUNER_TRAIN", "BBTPU_PRUNER_CKPT"):
        assert name in env._REGISTRY
    assert env.get("BBTPU_SPEC_BATCH") is False


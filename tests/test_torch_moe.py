"""The port's mixture-of-experts families (Mixtral, Qwen3-MoE) on the CPU,
against HF and the JAX package.

- Router and MLP (f32, inputs from one numpy seed): `router_topk_weights`
  in both semantics (Mixtral's mask-then-softmax, Qwen3-MoE's
  softmax-then-top-k with and without renormalisation) equals JAX's within
  1e-6, a constructed tie at the k-th value included (every tied expert is
  kept, as JAX keeps it: more than k selected); bf16 logits with ties
  select JAX's experts; `moe_mlp` within 1e-5, and a zero row (every
  expert tied) gives an exact 0.
- Registry: the port's spec of tiny HF `MixtralConfig` / `Qwen3MoeConfig`
  models and of the published Mixtral-8x7B-v0.1 and Qwen3-30B-A3B configs
  equals the JAX spec field for field; a Qwen3-MoE config with dense
  layers interleaved is refused by both with JAX's message.
- Weights: `init_block_params` draws the router and stacked experts in
  place of the dense MLP and the attention draws of the same seed as a
  dense spec; `params_from_jax` carries the expert keys, per layer and
  stacked [L, E, ...]; the port's loaders give the JAX loaders' tensors
  exactly, and HF's per-expert matrices transposed and stacked.
- Per layer (f32, within 1e-5): `layer_body` on the dense, paged decode,
  chunk, tree chunk and flash routes (the kernels' plain versions) and on
  an int4 arena's decode route; `layer_body_ragged` on decode, mixed and
  tree rows (dense and the ragged kernel's plain version; padding rows
  finite) against the JAX functions on its dense route.
- Executor: a 2-layer span of each family at BBTPU_PAGED_MIN_CONTEXT=0
  (prefill, decodes, a follow-up, a decode group, a mixed and a tree
  ragged group) against a JAX executor on its Pallas kernels in interpret
  mode (BBTPU_PAGED_INTERPRET=1), within 1e-5.
- Full chain: a tiny HF Mixtral and Qwen3-MoE (head_dim 64) saved
  locally, served by two port servers built from the directory with
  BBTPU_PAGED_MIN_CONTEXT=0, read by the port client's `from_pretrained`:
  logits within 2e-3 of HF's, greedy tokens equal to HF's; a mixed chain
  (a JAX span server and a port span server) driven by the JAX client;
  `generate(server_decode=True)` on a whole-model port server;
  `run_server.main` builds and warms a span from each directory; a MoE
  self-drafter drafts JAX's trees and `generate_speculative` gives plain
  `generate`'s tokens.

The loop, registry and server helpers are tests/test_torch_server.py's;
every networked call here is bounded at 60 s.
"""

import asyncio
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import ml_dtypes

from bloombee_tpu.kv.cache_manager import CacheManager as JaxManager
from bloombee_tpu.kv.quant import QuantSlab as JaxQuantSlab
from bloombee_tpu.models import auto as j_auto
from bloombee_tpu.models import checkpoint as j_ckpt
from bloombee_tpu.models.spec import ModelSpec as JaxSpec
from bloombee_tpu.ops import moe as j_moe
from bloombee_tpu.ops.rotary import rotary_cos_sin as j_rope
from bloombee_tpu.runtime.executor import SpanExecutor as JaxExecutor
from bloombee_tpu.spec.drafter import GreedyTreeDrafter as JaxDrafter
from bloombee_tpu.spec.drafter import LocalJaxDraftModel
from bloombee_tpu_torch.cli import run_server
from bloombee_tpu_torch.client import ClientConfig, DistributedModelForCausalLM
from bloombee_tpu_torch.client.speculative import generate_speculative
from bloombee_tpu_torch.kv import quant as t_quant
from bloombee_tpu_torch.kv.arena import write_plan
from bloombee_tpu_torch.kv.cache_manager import CacheManager
from bloombee_tpu_torch.models import auto
from bloombee_tpu_torch.models import checkpoint as t_ckpt
from bloombee_tpu_torch.models.llama import block as t_block
from bloombee_tpu_torch.models.spec import ModelSpec
from bloombee_tpu_torch.ops import moe as t_moe
from bloombee_tpu_torch.ops.cuda import paged_attention as t_paged
from bloombee_tpu_torch.ops.rotary import rotary_cos_sin as t_rope
from bloombee_tpu_torch.runtime import layer_body as t_body
from bloombee_tpu_torch.runtime.executor import SpanExecutor
from bloombee_tpu_torch.server.block_server import BlockServer
from bloombee_tpu_torch.spec.drafter import GreedyTreeDrafter, LocalDraftModel
from bloombee_tpu_torch.swarm.registry import RegistryClient
from test_torch_families import (
    PAGES,
    PAST,
    PS,
    ROUTES,
    arena_and_steps,
    j_layer_body,
    j_layer_body_ragged,
    kernel_route_server,
    port_client,
    prompt_ids,
    run,
    tree_mask,
)
from test_torch_server import (  # noqa: F401  (fixtures)
    REGISTRY_CLIENTS,
    client as jax_client,
    hf_logits,
    jax_server,
    loop,
    registry,
    start_all,
    stop_all,
)
from test_torch_gemma import hf_greedy  # no EOS stop, explicit mask
from test_torch_slice import count_routes

EPS = 1e-5
FAMILIES = ("mixtral", "qwen3_moe")


# ---------------------------------------------------------- router, MLP
# semantics -> (pre_softmax, norm_topk)
ROUTERS = {"mixtral": (False, False), "qwen3": (True, False),
           "qwen3-norm": (True, True)}


def router_logits(kind, dtype=np.float32):
    """[2, 3, 8] logits: random, or with ties at the 2nd top value (rows
    with 3 and 4 experts tied there, one with every expert tied)."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 3, 8))
    if kind == "tie":
        x[0, 0] = [0.1, 2.0, -1.0, 0.5, 2.0, -2.0, 2.0, 1.9]
        x[0, 1] = [3.0, -1.0, 1.5, 1.5, -0.5, 1.5, 0.0, 1.5]
        x[1, 2] = 0.25
    return x.astype(dtype)


@pytest.mark.parametrize("kind", ["random", "tie"])
@pytest.mark.parametrize("semantics", list(ROUTERS))
def test_router_topk_weights_matches_jax(semantics, kind):
    pre, norm = ROUTERS[semantics]
    x = router_logits(kind)
    got = t_moe.router_topk_weights(torch.from_numpy(x), 2, pre, norm)
    want = np.asarray(j_moe.router_topk_weights(jnp.asarray(x), 2, pre, norm))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)
    picked = (got > 0).sum(-1)
    if kind == "tie":  # a top-k index scatter would keep exactly 2
        assert picked[0, 0] == 3 and picked[0, 1] == 5 and picked[1, 2] == 8
    else:
        assert (picked == 2).all()


@pytest.mark.parametrize("semantics", list(ROUTERS))
def test_router_on_bf16_ties_picks_jax_experts(semantics):
    """bf16 logits (as the card computes them) quantised so that ties
    happen: the same experts as JAX, weights within one bf16 step."""
    pre, norm = ROUTERS[semantics]
    x = np.round(router_logits("random") * 4) / 4
    got = t_moe.router_topk_weights(
        torch.from_numpy(x).to(torch.bfloat16), 2, pre, norm
    )
    want = np.asarray(j_moe.router_topk_weights(
        jnp.asarray(x.astype(ml_dtypes.bfloat16)), 2, pre, norm
    )).astype(np.float32)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    np.testing.assert_array_equal(got > 0, want > 0)
    assert ((got > 0).sum(-1) > 2).any()  # a tie was taken
    np.testing.assert_allclose(got, want, atol=2**-8, rtol=0)


def moe_weights(rng, d=16, e=4, i=24):
    return (rng.standard_normal((d, e)) / np.sqrt(d),
            rng.standard_normal((e, d, i)) / np.sqrt(d),
            rng.standard_normal((e, d, i)) / np.sqrt(d),
            rng.standard_normal((e, i, d)) / np.sqrt(i))


@pytest.mark.parametrize("semantics", list(ROUTERS))
def test_moe_mlp_matches_jax(semantics):
    pre, norm = ROUTERS[semantics]
    rng = np.random.default_rng(1)
    ws = [w.astype(np.float32) for w in moe_weights(rng)]
    x = rng.standard_normal((2, 5, 16)).astype(np.float32)
    x[1, 4] = 0.0  # a zero row: every expert tied, an exact 0 out
    want = np.asarray(j_moe.moe_mlp(jnp.asarray(x), *map(jnp.asarray, ws), 2,
                                    pre_softmax=pre, norm_topk=norm))
    got = t_moe.moe_mlp(torch.from_numpy(x), *map(torch.from_numpy, ws), 2,
                        pre_softmax=pre, norm_topk=norm)
    np.testing.assert_allclose(got.numpy(), want, atol=EPS, rtol=EPS)
    assert (got[1, 4] == 0).all()


# ---------------------------------------------------------------- configs
def hf_config(family):
    """A tiny HF config per family at head_dim 64 (the CUDA kernels'
    domain): Mixtral 4 experts top-2, Qwen3-MoE 8 experts top-2 with
    renormalised weights and q/k norms."""
    import transformers as tf

    common = dict(num_hidden_layers=2, vocab_size=128, rms_norm_eps=1e-5,
                  max_position_embeddings=256, tie_word_embeddings=False,
                  head_dim=64, rope_theta=1e6)
    if family == "mixtral":
        return tf.MixtralConfig(
            hidden_size=128, intermediate_size=96, num_attention_heads=2,
            num_key_value_heads=1, num_local_experts=4,
            num_experts_per_tok=2, sliding_window=None, **common,
        ), tf.MixtralForCausalLM
    return tf.Qwen3MoeConfig(
        hidden_size=64, intermediate_size=128, moe_intermediate_size=48,
        num_attention_heads=4, num_key_value_heads=2, num_experts=8,
        num_experts_per_tok=2, norm_topk_prob=True, **common,
    ), tf.Qwen3MoeForCausalLM


# the published configs (each model's config.json on the hub)
PUBLISHED = {
    "mixtral-8x7b-v0.1": {
        "model_type": "mixtral", "architectures": ["MixtralForCausalLM"],
        "hidden_size": 4096, "intermediate_size": 14336,
        "num_attention_heads": 32, "num_key_value_heads": 8,
        "num_hidden_layers": 32, "num_local_experts": 8,
        "num_experts_per_tok": 2, "vocab_size": 32000, "rms_norm_eps": 1e-5,
        "rope_theta": 1e6, "max_position_embeddings": 32768,
        "sliding_window": None, "tie_word_embeddings": False,
    },
    "qwen3-30b-a3b": {
        "model_type": "qwen3_moe", "architectures": ["Qwen3MoeForCausalLM"],
        "hidden_size": 2048, "intermediate_size": 6144,
        "moe_intermediate_size": 768, "num_attention_heads": 32,
        "num_key_value_heads": 4, "head_dim": 128, "num_hidden_layers": 48,
        "num_experts": 128, "num_experts_per_tok": 8,
        "norm_topk_prob": True, "decoder_sparse_step": 1,
        "mlp_only_layers": [], "vocab_size": 151936, "rms_norm_eps": 1e-6,
        "rope_theta": 1e6, "max_position_embeddings": 40960,
        "use_sliding_window": False, "sliding_window": None,
        "tie_word_embeddings": False,
    },
}


@pytest.mark.parametrize("name", [*FAMILIES, *PUBLISHED])
def test_spec_matches_jax(name):
    if name in PUBLISHED:
        config = PUBLISHED[name]
    else:
        hf, _ = hf_config(name)
        config = hf.to_dict()
        assert dataclasses.asdict(auto.spec_from_hf_config(hf)) == \
            dataclasses.asdict(j_auto.spec_from_hf_config(hf))
    got = auto.spec_from_config_dict(config)
    want = j_auto.spec_from_config_dict(config)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.family == config["model_type"] and got.num_experts
    assert auto.get_family(got.family).name == got.family
    assert t_body.unsupported(got) is None
    assert t_body.dense_unsupported(got) is None


@pytest.mark.parametrize("dense", [{"mlp_only_layers": [3]},
                                   {"decoder_sparse_step": 2}],
                         ids=["mlp_only_layers", "decoder_sparse_step"])
def test_qwen3_moe_dense_layers_refused_as_jax_refuses_them(dense):
    config = {**PUBLISHED["qwen3-30b-a3b"], **dense}
    for spec_from in (auto.spec_from_config_dict,
                      j_auto.spec_from_config_dict):
        with pytest.raises(NotImplementedError,
                           match="mlp_only_layers / decoder_sparse_step"):
            spec_from(config)


# ------------------------------------------------------------- per layer
LAYER_SPECS = {
    "mixtral": dict(family="mixtral", hidden_size=128,
                    intermediate_size=96, num_attention_heads=2,
                    num_key_value_heads=1, head_dim=64, rope_theta=1e6,
                    num_experts=4, num_experts_per_tok=2),
    "qwen3_moe": dict(family="qwen3_moe", hidden_size=64,
                      intermediate_size=48, num_attention_heads=4,
                      num_key_value_heads=2, head_dim=64, rope_theta=1e6,
                      qk_norm=True, num_experts=8, num_experts_per_tok=2,
                      moe_pre_softmax=True, moe_norm_topk=True),
}


def specs(case, layers=1):
    kw = dict(num_hidden_layers=layers, vocab_size=64, rms_norm_eps=1e-5,
              **LAYER_SPECS[case])
    return JaxSpec(**kw), ModelSpec(**kw)


def layer_np(case, rng):
    """One MoE layer's JAX-layout params from numpy: N(0, 1/fan_in)
    matrices, norms near 1."""
    spec, _ = specs(case)
    d, i, e = spec.hidden_size, spec.intermediate_size, spec.num_experts
    h, kv, hd = spec.num_attention_heads, spec.num_key_value_heads, \
        spec.head_dim
    shapes = {
        "input_layernorm": (d,), "post_attention_layernorm": (d,),
        "q_proj": (d, h * hd), "k_proj": (d, kv * hd),
        "v_proj": (d, kv * hd), "o_proj": (h * hd, d), "router": (d, e),
        "experts_gate": (e, d, i), "experts_up": (e, d, i),
        "experts_down": (e, i, d),
    }
    if spec.qk_norm:
        shapes.update(q_norm=(hd,), k_norm=(hd,))
    out = {}
    for k, s in shapes.items():
        x = rng.standard_normal(s)
        out[k] = (x / np.sqrt(s[-2]) if len(s) > 1 else 1 + 0.1 * x).astype(
            np.float32
        )
    return out


@pytest.fixture(scope="module")
def layers():
    rng = np.random.default_rng(0)
    return {case: layer_np(case, rng) for case in LAYER_SPECS}


def test_init_block_params_draws_experts_in_place_of_the_mlp():
    """An MoE spec gets the router and stacked experts and no dense MLP;
    its attention keys are the draws a dense spec of the same seed gets."""
    for case, extras in (("mixtral", set()),
                         ("qwen3_moe", {"q_norm", "k_norm"})):
        _, spec = specs(case)
        d, i, e = spec.hidden_size, spec.intermediate_size, spec.num_experts
        got = t_block.init_block_params(torch.Generator().manual_seed(3),
                                        spec, device="cpu")
        dense = t_block.init_block_params(
            torch.Generator().manual_seed(3),
            dataclasses.replace(spec, num_experts=0), device="cpu",
        )
        shapes = {"router": (d, e), "experts_gate": (e, d, i),
                  "experts_up": (e, d, i), "experts_down": (e, i, d)}
        mlp = {"gate_proj", "up_proj", "down_proj"}
        assert set(got) == (set(dense) - mlp) | set(shapes)
        assert extras <= set(got)
        for k, s in shapes.items():
            assert got[k].shape == s
        for k in set(dense) - mlp:
            torch.testing.assert_close(got[k], dense[k], atol=0, rtol=0)


def test_params_from_jax_carries_the_experts(layers):
    for case, layer in layers.items():
        stacked = {k: np.stack([v, 2 * v]) for k, v in layer.items()}
        for tree in ([layer], stacked):
            port = t_block.params_from_jax(tree, device="cpu")
            assert set(port[0]) == set(layer)
            for k, w in layer.items():
                np.testing.assert_array_equal(port[0][k].numpy(), w)
            if isinstance(tree, dict):
                np.testing.assert_array_equal(
                    port[1]["experts_down"].numpy(), 2 * layer["experts_down"]
                )


@pytest.mark.parametrize("case,route",
                         [(c, r) for c in LAYER_SPECS for r in ROUTES],
                         ids=[f"{c}-{r}" for c in LAYER_SPECS for r in ROUTES])
def test_layer_body_matches_jax(layers, case, route):
    t, use_paged, use_flash, tree = ROUTES[route]
    j_spec, t_spec = specs(case)
    rng = np.random.default_rng(1)
    k, v, table, pos, slots, hidden, lens = arena_and_steps(j_spec, t, rng)
    tm = tree_mask(t) if tree else None
    if tree:  # tree depths are the rotary positions of a tree step
        depth = tm[0].sum(-1) - 1
        pos = (lens - t)[:, None] + depth[None].astype(np.int32)

    want, wk, wv = j_layer_body(
        j_spec, PS, jnp.asarray(hidden),
        jax.tree.map(jnp.asarray, layers[case]), jnp.asarray(k),
        jnp.asarray(v),
        *j_rope(jnp.asarray(pos), j_spec.head_dim, j_spec.rope_theta),
        jnp.asarray(slots), jnp.asarray(table), jnp.asarray(pos),
        jnp.asarray(lens), None if tm is None else jnp.asarray(tm), 0,
    )
    (params,) = t_block.params_from_jax([layers[case]], device="cpu")
    tk, tv = torch.from_numpy(k.copy()), torch.from_numpy(v.copy())
    got = t_body.layer_body(
        t_spec, PS, torch.from_numpy(hidden), params, tk, tv,
        *t_rope(torch.from_numpy(pos), t_spec.head_dim, t_spec.rope_theta),
        write_plan(slots, PAGES * PS, "cpu"), torch.from_numpy(table),
        torch.from_numpy(pos), torch.from_numpy(lens),
        None if tm is None else torch.from_numpy(tm), 0,
        use_flash=use_flash, use_paged=use_paged, t_real=t,
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=EPS,
                               rtol=EPS)
    np.testing.assert_allclose(tk.numpy(), np.asarray(wk), atol=EPS, rtol=0)
    np.testing.assert_allclose(tv.numpy(), np.asarray(wv), atol=EPS, rtol=0)


@pytest.mark.parametrize("case", list(LAYER_SPECS))
def test_layer_body_int4_decode_matches_jax(layers, case):
    """A decode step over an int4 arena: the port's int4 decode route (the
    kernel's plain version) against JAX's dense route over the same codes,
    scales and zeros; the new token's codes are written alike."""
    j_spec, t_spec = specs(case)
    rng = np.random.default_rng(4)
    k, v, table, pos, slots, hidden, lens = arena_and_steps(j_spec, 1, rng)
    tq = [t_quant.quantize(torch.from_numpy(x)) for x in (k, v)]
    jq = [JaxQuantSlab(*(jnp.asarray(a.numpy()) for a in s)) for s in tq]
    want, wk, _ = j_layer_body(
        j_spec, PS, jnp.asarray(hidden),
        jax.tree.map(jnp.asarray, layers[case]), *jq,
        *j_rope(jnp.asarray(pos), j_spec.head_dim, j_spec.rope_theta),
        jnp.asarray(slots), jnp.asarray(table), jnp.asarray(pos),
        jnp.asarray(lens), None, 0,
    )
    (params,) = t_block.params_from_jax([layers[case]], device="cpu")
    calls = []
    plain = t_paged.paged_decode_attention_int4_reference

    def counted(*a, **kw):
        calls.append(1)
        return plain(*a, **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(t_paged, "paged_decode_attention_int4_reference",
                   counted)
        got = t_body.layer_body(
            t_spec, PS, torch.from_numpy(hidden), params, *tq,
            *t_rope(torch.from_numpy(pos), t_spec.head_dim,
                    t_spec.rope_theta),
            write_plan(slots, PAGES * PS, "cpu"), torch.from_numpy(table),
            torch.from_numpy(pos), torch.from_numpy(lens), None, 0,
            use_paged=True, t_real=1,
        )
    assert calls == [1]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=EPS,
                               rtol=EPS)
    np.testing.assert_array_equal(tq[0].codes.numpy(), np.asarray(wk.codes))


def ragged_rows(mix):
    """A ragged step of sequence 0's decode row and sequence 1's decode
    row ("decode"), 4-token chunk ("mixed") or 4-node tree ("tree"), then
    padding rows (owner 2, slots out of the arena) up to 8: q_seq, q_pos,
    slots' owners, lens and, for a tree, (nt, tree_rows)."""
    t1 = 1 if mix == "decode" else 4
    r_real, rb = 1 + t1, 8
    q_seq = np.asarray([0] + [1] * t1 + [2] * (rb - r_real), np.int32)
    rel = np.arange(t1)
    tree = None
    if mix == "tree":
        tm = tree_mask(t1)[0]
        rel = tm.sum(-1) - 1  # depths
        rows = np.zeros((rb, t1), np.int32)
        rows[0, 0] = 1
        rows[1 : 1 + t1] = tm
        tree = {"nt": np.asarray([1, t1], np.int32), "tree_rows": rows}
    q_pos = np.asarray([PAST[0]] + list(PAST[1] + rel)
                       + [0] * (rb - r_real), np.int32)
    # a tree's nodes are written in slot order at PAST[1] + node index
    write_pos = np.asarray([PAST[0]] + [PAST[1] + j for j in range(t1)]
                           + [0] * (rb - r_real), np.int32)
    lens = np.asarray([PAST[0] + 1, PAST[1] + t1], np.int32)
    return q_seq, q_pos, write_pos, lens, r_real, tree


@pytest.mark.parametrize("case", list(LAYER_SPECS))
@pytest.mark.parametrize("mix", ["decode", "mixed", "tree"])
@pytest.mark.parametrize("use_kernel", [False, True],
                         ids=["dense", "kernel"])
def test_layer_body_ragged_matches_jax(layers, case, mix, use_kernel):
    """The packed [1, R, D] rows through the MoE tail as one [1, R] batch:
    the real rows within 1e-5 of JAX, every padding row finite."""
    j_spec, t_spec = specs(case)
    rng = np.random.default_rng(2)
    k, v, table, _, _, _, _ = arena_and_steps(j_spec, 1, rng)
    q_seq, q_pos, write_pos, lens, r_real, tree = ragged_rows(mix)
    owner = np.minimum(q_seq, 1)
    slots = table[owner, write_pos // PS] * PS + write_pos % PS
    slots[r_real:] = PAGES * PS  # padding rows: dropped
    hidden = rng.standard_normal((1, 8, j_spec.hidden_size)).astype(
        np.float32
    )
    tree = tree or {}

    want, wk, _ = j_layer_body_ragged(
        j_spec, PS, jnp.asarray(hidden),
        jax.tree.map(jnp.asarray, layers[case]), jnp.asarray(k),
        jnp.asarray(v),
        *j_rope(jnp.asarray(q_pos[None]), j_spec.head_dim,
                j_spec.rope_theta),
        jnp.asarray(slots.astype(np.int32)), jnp.asarray(table),
        jnp.asarray(q_pos[None]), jnp.asarray(lens), jnp.asarray(q_seq), 0,
        **{n: jnp.asarray(x) for n, x in tree.items()},
    )
    (params,) = t_block.params_from_jax([layers[case]], device="cpu")
    tk, tv = torch.from_numpy(k.copy()), torch.from_numpy(v.copy())
    got = t_body.layer_body_ragged(
        t_spec, PS, torch.from_numpy(hidden), params, tk, tv,
        *t_rope(torch.from_numpy(q_pos[None]), t_spec.head_dim,
                t_spec.rope_theta),
        write_plan(slots, PAGES * PS, "cpu"), torch.from_numpy(table),
        torch.from_numpy(q_pos[None]), torch.from_numpy(lens),
        torch.from_numpy(q_seq), 0, use_kernel=use_kernel,
        **{n: torch.from_numpy(x) for n, x in tree.items()},
    )
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got[0, :r_real].numpy(),
                               np.asarray(want)[0, :r_real], atol=EPS,
                               rtol=EPS)
    np.testing.assert_allclose(tk.numpy(), np.asarray(wk), atol=EPS, rtol=0)


# -------------------------------------------------------------- executor
def executor_pair(case):
    """A 2-layer span of `case` on both packages, f32, 64 pages of 4
    tokens, from one seed."""
    j_spec, t_spec = specs(case, layers=2)
    rng = np.random.default_rng(5)
    first, second = layer_np(case, rng), layer_np(case, rng)
    stacked = {k: np.stack([first[k], second[k]]) for k in first}
    kv, hd = t_spec.num_key_value_heads, t_spec.head_dim
    jm = JaxManager(num_layers=2, num_pages=64, page_size=PS,
                    n_kv_heads=kv, head_dim=hd, dtype=jnp.float32)
    tm = CacheManager(2, 64, PS, kv, hd, dtype=torch.float32, device="cpu")
    return (
        (jm, JaxExecutor(stacked, j_spec, jm, compute_dtype=jnp.float32)),
        (tm, SpanExecutor(t_block.params_from_jax(stacked, device="cpu"),
                          t_spec, tm, compute_dtype=torch.float32,
                          device="cpu")),
        rng.standard_normal((4, 40, t_spec.hidden_size)).astype(np.float32),
    )


def drive_executor(manager, ex, h):
    """Two sessions: a 20-token prefill of two rows, 3 decodes, a 5-token
    follow-up; a second session's 12-token prefill; a decode group over
    both; a mixed ragged group (A's decode rows and a 4-token chunk of B);
    a tree ragged group (A's decode rows and a 4-node tree of B)."""
    outs = []
    tm = tree_mask(4)[:1]
    depths = (tm[0].sum(-1) - 1)[None].astype(np.int32)

    def keep(x):
        outs.append(np.asarray(x if not torch.is_tensor(x)
                               else x.detach().cpu(), np.float32))

    async def go():
        async with manager.allocate(2, 40) as a, manager.allocate(1, 40) as b:
            keep(ex.prefill(a, h[:2, :20]))
            for i in range(3):
                keep(ex.decode(a, h[:2, 20 + i : 21 + i]))
            keep(ex.decode(a, h[:2, 23:28]))
            keep(ex.prefill(b, h[2:3, :12]))
            out, combined = ex.decode_group([a, b], [h[:2, 28:29],
                                                     h[2:3, 12:13]])
            manager.commit(combined)
            keep(out)
            out, _ = ex.ragged_group([a, b], [h[:2, 29:30], h[2:3, 13:17]])
            manager.commit(a)
            manager.commit(b)
            keep(out)
            out, _ = ex.ragged_group(
                [a, b], [h[:2, 30:31], h[2:3, 17:21]],
                tree_masks=[None, tm], depths_list=[None, depths],
            )
            keep(out)

    asyncio.run(go())
    return outs


@pytest.mark.parametrize("case", FAMILIES)
def test_executor_routes_and_matches_jax(monkeypatch, case):
    """At BBTPU_PAGED_MIN_CONTEXT=0 and head_dim 64 the span's decode,
    follow-up and ragged steps take the paged routes (their plain versions
    here) against JAX's Pallas kernels in interpret mode, hidden states
    within 1e-5; MoE gates no route."""
    monkeypatch.setenv("BBTPU_PAGED_MIN_CONTEXT", "0")
    monkeypatch.setenv("BBTPU_PAGED_INTERPRET", "1")
    (jm, jex), (tm, tex), h = executor_pair(case)
    assert tex.paged_supported and tex.flash_supported
    routes = count_routes(monkeypatch)
    ragged = {"n": 0}
    plain = t_paged.paged_ragged_attention_reference

    def counted(*a, **kw):
        ragged["n"] += 1
        return plain(*a, **kw)

    monkeypatch.setattr(t_paged, "paged_ragged_attention_reference", counted)
    want = drive_executor(jm, jex, h)
    got = drive_executor(tm, tex, h)
    for g, w in zip(got, want, strict=True):
        np.testing.assert_allclose(g, w, atol=EPS, rtol=EPS)
    # 2 layers x (3 decodes + the group) on decode; the two prefills and
    # the follow-up (buckets < 128) on chunk, whose plain version the
    # decode one also runs (6 + 8); two ragged groups
    assert routes["paged_decode_attention_reference"] == 8
    assert routes["paged_chunk_attention_reference"] == 6 + 8
    assert ragged["n"] == 4


# ------------------------------------------------------------ full chain
@pytest.fixture(scope="module")
def moe_dirs(tmp_path_factory):
    """family -> (model dir, HF model, HF config)."""
    out = {}
    for family in FAMILIES:
        config, cls = hf_config(family)
        torch.manual_seed(0)
        model = cls(config).eval().to(torch.float32)
        with torch.no_grad():  # spread the router logits past HF's init
            for name, p in model.named_parameters():
                if name.endswith(".gate.weight"):
                    p.normal_(0.0, config.hidden_size**-0.5)
        d = tmp_path_factory.mktemp(f"tiny_{family}")
        model.save_pretrained(d, safe_serialization=True)
        out[family] = (str(d), model, config)
    return out


@pytest.mark.parametrize("family", FAMILIES)
def test_loaders_match_jax_and_hf(moe_dirs, family):
    """The port's loader stacks HF's per-expert matrices transposed to
    [in, out] and the router as [D, E], and its tensors are the JAX
    loader's exactly (`params_from_jax` of JAX's stacked tree)."""
    d, hf, config = moe_dirs[family]
    layers, spec = t_ckpt.load_span_params(d, 0, 2, device="cpu")
    assert spec == auto.spec_from_hf_config(config)
    sd = hf.state_dict()
    moe, names = (("block_sparse_moe", ("w1", "w3", "w2"))
                  if family == "mixtral"
                  else ("mlp", ("gate_proj", "up_proj", "down_proj")))
    p = f"model.layers.1.{moe}"
    torch.testing.assert_close(layers[1]["router"],
                               sd[f"{p}.gate.weight"].t(), atol=0, rtol=0)
    for e in range(spec.num_experts):
        for key, name in zip(("experts_gate", "experts_up", "experts_down"),
                             names):
            torch.testing.assert_close(
                layers[1][key][e], sd[f"{p}.experts.{e}.{name}.weight"].t(),
                atol=0, rtol=0,
            )
    assert not {"gate_proj", "up_proj", "down_proj"} & set(layers[0])

    j_layers, _ = j_ckpt.load_span_params(d, 0, 2, dtype=jnp.float32)
    carried = t_block.params_from_jax(jax.tree.map(np.asarray, j_layers),
                                      device="cpu")
    for got, want in zip(carried, layers, strict=True):
        assert set(got) == set(want)
        for k in want:
            torch.testing.assert_close(got[k], want[k], atol=0, rtol=0)
    bf16, _ = t_ckpt.load_span_params(d, 1, 2, dtype=torch.bfloat16,
                                      device="cpu")
    for k, w in bf16[0].items():
        assert w.dtype == torch.bfloat16 and w.is_contiguous()
        torch.testing.assert_close(w, layers[1][k].to(torch.bfloat16),
                                   atol=0, rtol=0)


@pytest.fixture(scope="module")
def chains(loop, moe_dirs, registry):
    """Per family: two port servers ([0, 1), [1, 2)) under uid "<family>";
    for Mixtral also a mixed chain under "mixtral-mixed": a JAX server
    over [0, 1) and a port server over [1, 2)."""
    servers = []
    for family, (d, _, _) in moe_dirs.items():
        servers += [
            kernel_route_server(d, registry.port, family, 0, 1),
            kernel_route_server(d, registry.port, family, 1, 2),
        ]
    d = moe_dirs["mixtral"][0]
    servers += [
        jax_server(d, registry.port, "mixtral-mixed", 0, 1),
        kernel_route_server(d, registry.port, "mixtral-mixed", 1, 2),
    ]
    run(loop, start_all(*servers))
    yield servers
    run(loop, stop_all(*servers))


@pytest.mark.parametrize("family", FAMILIES)
def test_full_chain_logits_match_hf(loop, moe_dirs, registry, chains,
                                    family):
    d, hf, config = moe_dirs[family]
    model = port_client(d, registry.port, family)
    assert model.spec.family == family and model.spec.num_experts
    input_ids = prompt_ids(config, b=1)

    async def go():
        async with model.inference_session(16, 1) as sess:
            return model.logits(await sess.step(model.embed(input_ids)))

    got = run(loop, go())
    np.testing.assert_allclose(got.numpy(), hf_logits(hf, input_ids),
                               atol=2e-3, rtol=2e-3)


@pytest.mark.parametrize("family", FAMILIES)
def test_full_chain_greedy_matches_hf(loop, moe_dirs, registry, chains,
                                      family):
    """Greedy tokens through the port chain equal HF's; both port servers
    took the kernel routes (their plain versions)."""
    d, hf, config = moe_dirs[family]
    input_ids = prompt_ids(config, seed=1)
    model = port_client(d, registry.port, family)
    got = run(loop, model.generate(input_ids, max_new_tokens=8)).numpy()
    np.testing.assert_array_equal(got, hf_greedy(hf, input_ids, 8))
    ports = [s for s in chains if isinstance(s, BlockServer)
             and s.model_uid == family]
    assert len(ports) == 2
    assert all(s.executor.paged_supported for s in ports)


def test_mixed_chain_driven_by_the_jax_client(loop, moe_dirs, registry,
                                              chains):
    """The JAX client through a JAX span server then a port span server
    of the same Mixtral: HF's greedy tokens."""
    d, hf, config = moe_dirs["mixtral"]
    input_ids = prompt_ids(config, seed=2)
    got = run(loop, jax_client(d, registry.port, "mixtral-mixed").generate(
        input_ids, max_new_tokens=8
    ))
    np.testing.assert_array_equal(np.asarray(got),
                                  hf_greedy(hf, input_ids, 8))


@pytest.mark.parametrize("family", FAMILIES)
def test_server_decode_matches_per_step(loop, moe_dirs, registry, family):
    """One whole-model port server (the fused decode loop through the MoE
    tail): `generate(server_decode=True)` gives per-step `generate`'s and
    HF's tokens."""
    d, hf, config = moe_dirs[family]
    uid = f"{family}-dn"
    server = kernel_route_server(d, registry.port, uid, 0, 2)
    rc = RegistryClient("127.0.0.1", registry.port)
    REGISTRY_CLIENTS.append(rc)
    model = DistributedModelForCausalLM.from_pretrained(
        d, rc, model_uid=uid, device="cpu",
        config=ClientConfig(use_push=True, server_decode=True,
                            server_decode_chunk=4),
    )
    x = prompt_ids(config, s=8, seed=3)

    async def go():
        await start_all(server)
        try:
            sd = await model.generate(x, max_new_tokens=9)
            ps = await model.generate(x, max_new_tokens=9,
                                      server_decode=False)
            return sd, ps, (await server._rpc_info({}, []))[0]
        finally:
            await stop_all(server)

    sd, ps, info = run(loop, go())
    np.testing.assert_array_equal(sd.numpy(), ps.numpy())
    np.testing.assert_array_equal(sd.numpy(), hf_greedy(hf, x, 9))
    assert info["decode_n_fused_calls"] == info["decode_n_calls"] > 0


@pytest.mark.parametrize("family", FAMILIES)
def test_run_server_builds_and_warms_a_moe_span(moe_dirs, monkeypatch,
                                                family):
    """`run_server.main` takes the directory through the registry, loads
    the span's experts, runs the warmup and reaches start."""
    d, hf, _ = moe_dirs[family]
    seen = {}

    class Reached(Exception):
        pass

    async def start(self):
        seen["server"] = self
        raise Reached

    monkeypatch.setattr(BlockServer, "start", start)
    with pytest.raises(Reached):
        run_server.main([d, "--blocks", "1:2", "--device", "cpu",
                         "--dtype", "float32", "--registry", "127.0.0.1:1",
                         "--host", "127.0.0.1", "--num-pages", "16",
                         "--page-size", "4", "--log-level", "WARNING"])
    server = seen["server"]
    assert server.spec == t_ckpt.load_spec(d)
    (layer,) = server.executor.params
    assert layer["experts_down"].shape[0] == server.spec.num_experts


def test_moe_self_drafter_matches_jax(loop, moe_dirs, registry, chains):
    """A Qwen3-MoE checkpoint drafts as `LocalJaxDraftModel` does (logits
    and greedy trees), and drafts for itself through the port chain (tree
    verifies on the chunk kernel's plain version): plain `generate`'s
    tokens."""
    d, _, config = moe_dirs["qwen3_moe"]
    ours = LocalDraftModel.from_dir(d, device="cpu")
    theirs = LocalJaxDraftModel.from_dir(d)
    contexts = [[1, 5, 9, 2], [3, 3, 3, 3, 3, 7, 100]]
    np.testing.assert_allclose(ours.last_logits_ragged(contexts),
                               theirs.last_logits_ragged(contexts),
                               atol=EPS, rtol=0)
    trees, probs = GreedyTreeDrafter(ours).build_batch(contexts)
    j_trees, j_probs = JaxDrafter(theirs).build_batch(contexts)
    for t, jt, p, jp in zip(trees, j_trees, probs, j_probs):
        np.testing.assert_array_equal(t.tokens, jt.tokens)
        np.testing.assert_array_equal(t.parents, jt.parents)
        np.testing.assert_allclose(p, jp, atol=EPS, rtol=0)

    model = port_client(d, registry.port, "qwen3_moe")
    drafter = GreedyTreeDrafter(ours, branching=(2, 1))
    input_ids = prompt_ids(config, b=1, s=5, seed=4)
    got = run(loop, generate_speculative(model, drafter, input_ids,
                                         max_new_tokens=8))
    assert got.shape[1] >= input_ids.shape[1] + 8
    plain = run(loop, model.generate(
        input_ids, max_new_tokens=got.shape[1] - input_ids.shape[1]
    ))
    np.testing.assert_array_equal(np.asarray(got), plain.numpy())

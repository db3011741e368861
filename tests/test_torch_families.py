"""The port's Llama-like families (Mistral, Qwen2, Qwen3) on the CPU, against
HF and the JAX package.

- Registry: the port's spec of each family's config (tiny HF configs and
  the published Qwen3-8B, Qwen2.5-3B and Mistral-7B-v0.1 configs) equals
  the JAX spec field for field; the Gemma model types are served (their
  tests are tests/test_torch_gemma.py), and so are the MoE ones
  (tests/test_torch_moe.py), Bloom (tests/test_torch_bloom.py) and Falcon
  (tests/test_torch_falcon.py); every
  JAX family the port does not serve yet is refused naming ROADMAP Queue 1
  item 15 by the registry, `BlockServer(model_dir=...)`, `run_server.main`,
  `from_pretrained` and `LocalDraftModel.from_dir`; an unknown model_type
  is a KeyError in both.
- Weights: `init_block_params` makes the family extras (Qwen2's q/k/v
  biases, Qwen3's q/k norms) after the Llama keys, and `params_from_jax`
  keeps them.
- Per layer (f32, within 1e-5, weights from one numpy seed): the port's
  `layer_body` on each of its routes (dense, paged decode, paged chunk,
  tree chunk, flash; the kernels' plain versions here),
  `layer_body_ragged` (dense and kernel) and `dense_block_forward` against
  the JAX functions of the same names on the JAX dense route. Cases: Qwen2
  biases, Qwen3 q/k norms with head_dim != hidden / heads, Mistral with a
  window shorter than the context (no flash or tree route, as the executor
  gates them, and no dense block forward, refused by both packages).
- Full chain: a tiny HF model of each family (head_dim 64, inside the CUDA
  kernels' domain; Qwen2 with tied embeddings, Mistral with a 6-token
  window) saved locally, served by two port servers built from the
  directory with BBTPU_PAGED_MIN_CONTEXT=0 (so the paged kernels' plain
  versions carry the window), read by the port client's
  `from_pretrained`: logits within 2e-3 of HF's, greedy tokens equal to
  HF's and to a JAX server + JAX client on the same directory.
- Speculative decoding on Qwen3: a `LocalDraftModel.from_dir` drafter's
  `generate_speculative` gives plain `generate`'s tokens; a Mistral
  checkpoint is refused as a local drafter, as JAX refuses it.

The loop, registry and server helpers are tests/test_torch_server.py's;
every networked call here is bounded at 60 s.
"""

import asyncio
import dataclasses
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bloombee_tpu.models import auto as j_auto
from bloombee_tpu.models.llama import block as j_block
from bloombee_tpu.models.spec import ModelSpec as JaxSpec
from bloombee_tpu.ops.rotary import rotary_cos_sin as j_rope
from bloombee_tpu.runtime import layer_body as j_body
from bloombee_tpu.spec.drafter import LocalJaxDraftModel
from bloombee_tpu_torch.cli import run_server
from bloombee_tpu_torch.client import ClientConfig, DistributedModelForCausalLM
from bloombee_tpu_torch.client.speculative import generate_speculative
from bloombee_tpu_torch.kv.arena import write_plan
from bloombee_tpu_torch.models import auto
from bloombee_tpu_torch.models.llama import block as t_block
from bloombee_tpu_torch.models.spec import ModelSpec
from bloombee_tpu_torch.ops.rotary import rotary_cos_sin as t_rope
from bloombee_tpu_torch.runtime import layer_body as t_body
from bloombee_tpu_torch.server.block_server import BlockServer
from bloombee_tpu_torch.spec.drafter import GreedyTreeDrafter, LocalDraftModel
from bloombee_tpu_torch.swarm.registry import RegistryClient
from test_torch_server import (  # noqa: F401  (fixtures)
    REGISTRY_CLIENTS,
    client as jax_client,
    hf_greedy,
    hf_logits,
    jax_server,
    loop,
    port_server,
    registry,
    start_all,
    stop_all,
)

EPS = 1e-5
BOUND_S = 60
FAMILIES = ("mistral", "qwen2", "qwen3")
UNPORTED = ("gemma4",)


def run(loop, coro):
    return asyncio.run_coroutine_threadsafe(coro, loop).result(BOUND_S)


# the JAX functions compiled whole (op by op they compile every primitive)
j_layer_body = jax.jit(j_body.layer_body, static_argnums=(0, 1))
j_layer_body_ragged = jax.jit(j_body.layer_body_ragged,
                              static_argnums=(0, 1))
j_dense_block_forward = jax.jit(j_body.dense_block_forward,
                                static_argnums=(1, 5))


# ---------------------------------------------------------------- configs
def hf_config(family):
    """A tiny HF config per family at head_dim 64 (the CUDA kernels'
    domain): Qwen3 with head_dim != hidden / heads, Qwen2 with tied
    embeddings, Mistral with a window shorter than the test prompts."""
    import transformers as tf

    common = dict(intermediate_size=128, num_hidden_layers=2,
                  vocab_size=128, rms_norm_eps=1e-5,
                  max_position_embeddings=256)
    if family == "qwen3":
        return tf.Qwen3Config(
            hidden_size=64, num_attention_heads=4, num_key_value_heads=2,
            head_dim=64, tie_word_embeddings=False, **common,
        ), tf.Qwen3ForCausalLM
    if family == "qwen2":
        return tf.Qwen2Config(
            hidden_size=128, num_attention_heads=2, num_key_value_heads=1,
            tie_word_embeddings=True, **common,
        ), tf.Qwen2ForCausalLM
    return tf.MistralConfig(
        hidden_size=128, num_attention_heads=2, num_key_value_heads=1,
        sliding_window=6, tie_word_embeddings=False, **common,
    ), tf.MistralForCausalLM


# the published configs the card runs (chip_smoke.py phase 10)
PUBLISHED = {
    "qwen3-8b": {
        "model_type": "qwen3", "hidden_size": 4096,
        "intermediate_size": 12288, "num_attention_heads": 32,
        "num_key_value_heads": 8, "head_dim": 128, "num_hidden_layers": 36,
        "vocab_size": 151936, "rms_norm_eps": 1e-6, "rope_theta": 1e6,
        "tie_word_embeddings": False, "max_position_embeddings": 40960,
        "use_sliding_window": False, "sliding_window": None,
    },
    "qwen2.5-3b": {
        "model_type": "qwen2", "hidden_size": 2048,
        "intermediate_size": 11008, "num_attention_heads": 16,
        "num_key_value_heads": 2, "num_hidden_layers": 36,
        "vocab_size": 151936, "rms_norm_eps": 1e-6, "rope_theta": 1e6,
        "tie_word_embeddings": True, "max_position_embeddings": 32768,
        "use_sliding_window": False, "sliding_window": 32768,
    },
    "mistral-7b-v0.1": {
        "model_type": "mistral", "hidden_size": 4096,
        "intermediate_size": 14336, "num_attention_heads": 32,
        "num_key_value_heads": 8, "num_hidden_layers": 32,
        "vocab_size": 32000, "rms_norm_eps": 1e-5, "rope_theta": 10000.0,
        "tie_word_embeddings": False, "max_position_embeddings": 32768,
        "sliding_window": 4096,
    },
}


# --------------------------------------------------------------- registry
@pytest.mark.parametrize("name", [*FAMILIES, *PUBLISHED, "llama"])
def test_spec_matches_jax(name):
    if name in PUBLISHED:
        config = PUBLISHED[name]
    elif name == "llama":
        from transformers import LlamaConfig

        config = LlamaConfig(hidden_size=64, num_attention_heads=4).to_dict()
    else:
        hf, _ = hf_config(name)
        config = hf.to_dict()
        assert dataclasses.asdict(auto.spec_from_hf_config(hf)) == \
            dataclasses.asdict(j_auto.spec_from_hf_config(hf))
    got = auto.spec_from_config_dict(config)
    want = j_auto.spec_from_config_dict(config)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.family == config["model_type"]


def test_qwen2_sliding_window_refused_as_jax_refuses_it():
    config = {**PUBLISHED["qwen2.5-3b"], "use_sliding_window": True}
    for spec_from in (auto.spec_from_config_dict,
                      j_auto.spec_from_config_dict):
        with pytest.raises(NotImplementedError, match="use_sliding_window"):
            spec_from(config)


def test_unknown_model_type_is_a_key_error_in_both():
    for get in (auto.get_family, j_auto.get_family):
        with pytest.raises(KeyError, match="unknown model family"):
            get("no-such-family")


@pytest.mark.parametrize("model_type", ["gemma2", "gemma3", "gemma3_text"])
def test_gemma_model_types_are_served(model_type):
    """The Gemma model types the JAX registry knows are served by the
    port's (tests/test_torch_gemma.py), neither refused nor unknown."""
    assert model_type not in auto.UNPORTED
    assert auto.get_family(model_type).name == model_type
    assert j_auto.get_family(model_type).name == model_type


@pytest.fixture(scope="module")
def unported_dirs(tmp_path_factory):
    """A checkpoint directory per unported model_type: its config.json and
    one small tensor (nothing past the refusal reads it)."""
    from safetensors.torch import save_file

    dirs = {}
    for model_type in UNPORTED:
        d = tmp_path_factory.mktemp(model_type)
        cfg = {**PUBLISHED["qwen3-8b"], "model_type": model_type}
        (d / "config.json").write_text(json.dumps(cfg))
        save_file({"model.norm.weight": torch.ones(4)},
                  str(d / "model.safetensors"))
        dirs[model_type] = str(d)
    return dirs


@pytest.mark.parametrize("model_type", UNPORTED)
def test_unported_family_refused_everywhere(model_type, unported_dirs,
                                            capsys):
    """The JAX package serves this family; the port refuses it naming item
    15 in the registry, the server, the CLI, the client and the drafter,
    before any weight loads or anything is announced."""
    assert j_auto.get_family(model_type).name == model_type
    d = unported_dirs[model_type]
    match = f"{model_type}.*ROADMAP Queue 1 item 15"
    with pytest.raises(NotImplementedError, match=match):
        auto.get_family(model_type)
    with pytest.raises(NotImplementedError, match=match):
        BlockServer(model_uid="x", start=0, end=1, model_dir=d,
                    registry=None, device="cpu")
    with pytest.raises(NotImplementedError, match=match):
        DistributedModelForCausalLM.from_pretrained(d, None, device="cpu")
    with pytest.raises(NotImplementedError, match=match):
        LocalDraftModel.from_dir(d, device="cpu")
    with pytest.raises(SystemExit) as err:
        run_server.main([d, "--blocks", "0:1", "--device", "cpu",
                         "--registry", "127.0.0.1:1"])
    assert err.value.code == 2
    assert "ROADMAP Queue 1 item 15" in capsys.readouterr().err


# ------------------------------------------------------------- per layer
LAYER_SPECS = {
    "qwen2": dict(family="qwen2", hidden_size=128, num_attention_heads=2,
                  num_key_value_heads=1, head_dim=64, rope_theta=1e6),
    "qwen3": dict(family="qwen3", hidden_size=64, num_attention_heads=4,
                  num_key_value_heads=2, head_dim=64, rope_theta=1e6,
                  qk_norm=True),
    "mistral": dict(family="mistral", hidden_size=128,
                    num_attention_heads=2, num_key_value_heads=1,
                    head_dim=64, layer_types=("sliding",), sliding_window=5),
}
PS, PAGES, PAST = 4, 16, (13, 9)  # page size, arena pages, past lengths


def specs(case):
    kw = dict(intermediate_size=96, num_hidden_layers=1, vocab_size=64,
              rms_norm_eps=1e-5, **LAYER_SPECS[case])
    return JaxSpec(**kw), ModelSpec(**kw)


def layer_np(case, rng):
    """One layer's JAX-layout params from numpy, with the family's
    extras."""
    spec, _ = specs(case)
    d, i = spec.hidden_size, spec.intermediate_size
    h, kv, hd = spec.num_attention_heads, spec.num_key_value_heads, \
        spec.head_dim
    shapes = {
        "input_layernorm": (d,), "post_attention_layernorm": (d,),
        "q_proj": (d, h * hd), "k_proj": (d, kv * hd),
        "v_proj": (d, kv * hd), "o_proj": (h * hd, d),
        "gate_proj": (d, i), "up_proj": (d, i), "down_proj": (i, d),
    }
    if case == "qwen2":
        shapes.update(q_bias=(h * hd,), k_bias=(kv * hd,), v_bias=(kv * hd,))
    if case == "qwen3":
        shapes.update(q_norm=(hd,), k_norm=(hd,))
    out = {}
    for k, s in shapes.items():
        x = rng.standard_normal(s)
        if len(s) == 2:
            x = x / np.sqrt(s[0])
        elif "norm" in k or "layernorm" in k:
            x = 1 + 0.1 * x
        out[k] = x.astype(np.float32)
    return out


@pytest.fixture(scope="module")
def layers():
    rng = np.random.default_rng(0)
    return {case: layer_np(case, rng) for case in LAYER_SPECS}


def test_init_block_params_makes_the_family_extras():
    """Qwen2 gets biases, Qwen3 q/k norms, drawn after the Llama keys: the
    same seed gives a Llama spec of that geometry the same base weights."""
    for case, extras in (("qwen2", {"q_bias": 128, "k_bias": 64,
                                    "v_bias": 64}),
                         ("qwen3", {"q_norm": 64, "k_norm": 64}),
                         ("mistral", {})):
        _, spec = specs(case)
        llama = dataclasses.replace(spec, family="llama", qk_norm=False)
        got = t_block.init_block_params(
            torch.Generator().manual_seed(3), spec, device="cpu"
        )
        base = t_block.init_block_params(
            torch.Generator().manual_seed(3), llama, device="cpu"
        )
        assert set(got) == set(base) | set(extras)
        for k, n in extras.items():
            assert got[k].shape == (n,)
        for k, w in base.items():
            torch.testing.assert_close(got[k], w, atol=0, rtol=0)


def test_layer_body_serves_the_families_and_names_item_15_otherwise():
    for case in LAYER_SPECS:
        assert t_body.unsupported(specs(case)[1]) is None
    shared_kv = dataclasses.replace(specs("qwen3")[1], family="gemma4",
                                    k_eq_v_full=True)
    assert t_body.unsupported(shared_kv) == (
        "shared K=V projections (ROADMAP Queue 1 item 15)"
    )


def test_params_from_jax_keeps_the_extras(layers):
    for case, layer in layers.items():
        (port,) = t_block.params_from_jax([layer], device="cpu")
        assert set(port) == set(layer)
        for k, w in layer.items():
            np.testing.assert_array_equal(port[k].numpy(), w)


def arena_and_steps(spec, t, rng):
    """An arena whose two sequences hold PAST tokens of random K/V (pages
    scattered through the arena), the t-token step's slots, page table,
    positions, lengths and input hidden states, as numpy."""
    kv, hd = spec.num_key_value_heads, spec.head_dim
    n_pages = PAGES // 2
    perm = rng.permutation(PAGES)
    table = np.stack([perm[:n_pages], perm[n_pages:]]).astype(np.int32)
    k = rng.standard_normal((PAGES * PS, kv, hd)).astype(np.float32)
    v = rng.standard_normal((PAGES * PS, kv, hd)).astype(np.float32)
    pos = np.stack([np.arange(p, p + t) for p in PAST]).astype(np.int32)
    slots = (table[np.arange(2)[:, None], pos // PS] * PS + pos % PS)
    hidden = rng.standard_normal((2, t, spec.hidden_size)).astype(np.float32)
    lens = np.asarray([p + t for p in PAST], np.int32)
    return k, v, table, pos, slots.reshape(-1).astype(np.int32), hidden, \
        lens


def tree_mask(t):
    """Node 0 the root, nodes 1.. its children then a chain below node 1."""
    parents = [-1, 0, 0, 1, 3][:t]
    m = np.eye(t, dtype=bool)
    for i in range(t):
        j = parents[i]
        while j >= 0:
            m[i, j] = True
            j = parents[j]
    return np.broadcast_to(m, (2, t, t)).copy()


# route -> (step tokens, use_paged, use_flash, tree)
ROUTES = {
    "dense": (5, False, False, False),
    "paged-decode": (1, True, False, False),
    "paged-chunk": (5, True, False, False),
    "paged-tree": (5, True, False, True),
    "flash": (5, False, True, False),
}
# the executor's gates: no flash and no tree rows with a sliding window
LAYER_CASES = [
    (case, route) for case in LAYER_SPECS for route in ROUTES
    if not (case == "mistral" and route in ("flash", "paged-tree"))
]


@pytest.mark.parametrize("case,route", LAYER_CASES,
                         ids=[f"{c}-{r}" for c, r in LAYER_CASES])
def test_layer_body_matches_jax(layers, case, route):
    t, use_paged, use_flash, tree = ROUTES[route]
    j_spec, t_spec = specs(case)
    rng = np.random.default_rng(1)
    k, v, table, pos, slots, hidden, lens = arena_and_steps(j_spec, t, rng)
    window = t_spec.window_for_layer(0)
    assert window < min(PAST) or case != "mistral"
    tm = tree_mask(t) if tree else None
    if tree:  # tree depths are the rotary positions of a tree step
        depth = tm[0].sum(-1) - 1
        pos = (lens - t)[:, None] + depth[None].astype(np.int32)

    want, wk, wv = j_layer_body(
        j_spec, PS, jnp.asarray(hidden), jax.tree.map(jnp.asarray,
                                                     layers[case]),
        jnp.asarray(k), jnp.asarray(v),
        *j_rope(jnp.asarray(pos), j_spec.head_dim, j_spec.rope_theta),
        jnp.asarray(slots), jnp.asarray(table), jnp.asarray(pos),
        jnp.asarray(lens), None if tm is None else jnp.asarray(tm), window,
    )
    (params,) = t_block.params_from_jax([layers[case]], device="cpu")
    tk, tv = torch.from_numpy(k.copy()), torch.from_numpy(v.copy())
    got = t_body.layer_body(
        t_spec, PS, torch.from_numpy(hidden), params, tk, tv,
        *t_rope(torch.from_numpy(pos), t_spec.head_dim, t_spec.rope_theta),
        write_plan(slots, PAGES * PS, "cpu"), torch.from_numpy(table),
        torch.from_numpy(pos), torch.from_numpy(lens),
        None if tm is None else torch.from_numpy(tm), window,
        use_flash=use_flash, use_paged=use_paged, t_real=t,
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=EPS,
                               rtol=EPS)
    np.testing.assert_allclose(tk.numpy(), np.asarray(wk), atol=EPS, rtol=0)
    np.testing.assert_allclose(tv.numpy(), np.asarray(wv), atol=EPS, rtol=0)


@pytest.mark.parametrize("case", list(LAYER_SPECS))
@pytest.mark.parametrize("use_kernel", [False, True],
                         ids=["dense", "kernel"])
def test_layer_body_ragged_matches_jax(layers, case, use_kernel):
    """A ragged step: sequence 0's decode row, sequence 1's 4-token chunk
    and 3 padding rows (slots out of the arena, owner 2)."""
    j_spec, t_spec = specs(case)
    rng = np.random.default_rng(2)
    k, v, table, _, _, _, _ = arena_and_steps(j_spec, 1, rng)
    r_real, rb = 5, 8
    q_seq = np.asarray([0, 1, 1, 1, 1, 2, 2, 2], np.int32)
    q_pos = np.asarray([PAST[0]] + [PAST[1] + i for i in range(4)]
                       + [0] * 3, np.int32)
    owner = np.minimum(q_seq, 1)
    slots = table[owner, q_pos // PS] * PS + q_pos % PS
    slots[r_real:] = PAGES * PS  # padding rows: dropped
    lens = np.asarray([PAST[0] + 1, PAST[1] + 4], np.int32)
    hidden = rng.standard_normal((1, rb, j_spec.hidden_size)).astype(
        np.float32
    )
    window = t_spec.window_for_layer(0)

    want, wk, _ = j_layer_body_ragged(
        j_spec, PS, jnp.asarray(hidden),
        jax.tree.map(jnp.asarray, layers[case]), jnp.asarray(k),
        jnp.asarray(v),
        *j_rope(jnp.asarray(q_pos[None]), j_spec.head_dim,
                j_spec.rope_theta),
        jnp.asarray(slots.astype(np.int32)), jnp.asarray(table),
        jnp.asarray(q_pos[None]), jnp.asarray(lens), jnp.asarray(q_seq),
        window,
    )
    (params,) = t_block.params_from_jax([layers[case]], device="cpu")
    tk, tv = torch.from_numpy(k.copy()), torch.from_numpy(v.copy())
    got = t_body.layer_body_ragged(
        t_spec, PS, torch.from_numpy(hidden), params, tk, tv,
        *t_rope(torch.from_numpy(q_pos[None]), t_spec.head_dim,
                t_spec.rope_theta),
        write_plan(slots, PAGES * PS, "cpu"), torch.from_numpy(table),
        torch.from_numpy(q_pos[None]), torch.from_numpy(lens),
        torch.from_numpy(q_seq), window, use_kernel=use_kernel,
    )
    np.testing.assert_allclose(got[0, :r_real].numpy(),
                               np.asarray(want)[0, :r_real], atol=EPS,
                               rtol=EPS)
    np.testing.assert_allclose(tk.numpy(), np.asarray(wk), atol=EPS, rtol=0)


@pytest.mark.parametrize("case", list(LAYER_SPECS))
def test_dense_block_forward_matches_jax(layers, case):
    j_spec, t_spec = specs(case)
    rng = np.random.default_rng(3)
    hidden = rng.standard_normal((2, 7, j_spec.hidden_size)).astype(
        np.float32
    )
    pos = np.broadcast_to(np.arange(7), (2, 7)).astype(np.int32)
    (params,) = t_block.params_from_jax([layers[case]], device="cpu")
    j_args = (jax.tree.map(jnp.asarray, layers[case]), j_spec,
              jnp.asarray(hidden),
              *j_rope(jnp.asarray(pos), j_spec.head_dim, j_spec.rope_theta),
              j_block.dense_attend())
    t_args = (params, t_spec, torch.from_numpy(hidden),
              *t_rope(torch.from_numpy(pos), t_spec.head_dim,
                      t_spec.rope_theta),
              t_block.dense_attend())
    if case == "mistral":  # the window would drop with injected attention
        for fn, args in ((j_dense_block_forward, j_args),
                         (t_body.dense_block_forward, t_args)):
            with pytest.raises(NotImplementedError, match="sliding-window"):
                fn(*args)
        return
    want, (wk, wv) = j_dense_block_forward(*j_args)
    got, (gk, gv) = t_body.dense_block_forward(*t_args)
    for g, w in ((got, want), (gk, wk), (gv, wv)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=EPS,
                                   rtol=EPS)


# ------------------------------------------------------------ full chain
@pytest.fixture(scope="module")
def family_dirs(tmp_path_factory):
    """family -> (model dir, HF model, HF config)."""
    out = {}
    for family in FAMILIES:
        config, cls = hf_config(family)
        torch.manual_seed(0)
        model = cls(config).eval().to(torch.float32)
        d = tmp_path_factory.mktemp(f"tiny_{family}")
        model.save_pretrained(d, safe_serialization=True)
        out[family] = (str(d), model, config)
    return out


def kernel_route_server(model_dir, reg_port, uid, start, end):
    """A port server from `model_dir` whose executor takes the kernel
    routes at any context (their plain versions on the CPU)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("BBTPU_PAGED_MIN_CONTEXT", "0")
        server = port_server(model_dir, reg_port, uid, start, end)
    assert server.executor.paged_min_context == 0
    return server


@pytest.fixture(scope="module")
def chains(loop, family_dirs, registry):
    """Per family: two port servers ([0, 1), [1, 2)) under uid
    "<family>" and a JAX server ([0, 2)) under "<family>-jax"."""
    servers = []
    for family, (d, _, _) in family_dirs.items():
        servers += [
            kernel_route_server(d, registry.port, family, 0, 1),
            kernel_route_server(d, registry.port, family, 1, 2),
            jax_server(d, registry.port, f"{family}-jax", 0, 2),
        ]
    run(loop, start_all(*servers))
    yield servers
    run(loop, stop_all(*servers))


def port_client(model_dir, reg_port, uid):
    rc = RegistryClient("127.0.0.1", reg_port)
    REGISTRY_CLIENTS.append(rc)
    return DistributedModelForCausalLM.from_pretrained(
        model_dir, rc, model_uid=uid, device="cpu",
        config=ClientConfig(use_push=True),
    )


def prompt_ids(config, b=2, s=10, seed=0):
    return np.random.default_rng(seed).integers(0, config.vocab_size, (b, s))


@pytest.mark.parametrize("family", FAMILIES)
def test_full_chain_logits_match_hf(loop, family_dirs, registry, chains,
                                    family):
    d, hf, config = family_dirs[family]
    model = port_client(d, registry.port, family)
    assert model.spec.family == family
    input_ids = prompt_ids(config, b=1)

    async def go():
        async with model.inference_session(16, 1) as sess:
            return model.logits(await sess.step(model.embed(input_ids)))

    got = run(loop, go())
    np.testing.assert_allclose(got.numpy(), hf_logits(hf, input_ids),
                               atol=2e-3, rtol=2e-3)


@pytest.mark.parametrize("family", FAMILIES)
def test_full_chain_greedy_matches_hf_and_jax(loop, family_dirs, registry,
                                              chains, family):
    """Greedy tokens past the window (Mistral) through the port chain equal
    HF's and the JAX client's through the JAX server."""
    d, hf, config = family_dirs[family]
    input_ids = prompt_ids(config, seed=1)
    model = port_client(d, registry.port, family)
    got = run(loop, model.generate(input_ids, max_new_tokens=8)).numpy()
    want = run(loop, jax_client(d, registry.port, f"{family}-jax").generate(
        input_ids, max_new_tokens=8
    ))
    np.testing.assert_array_equal(got, hf_greedy(hf, input_ids, 8))
    np.testing.assert_array_equal(got, np.asarray(want))


def test_speculative_decoding_on_qwen3(loop, family_dirs, registry, chains):
    """A Qwen3 checkpoint drafts for itself through the port chain (tree
    verifies on the paged chunk kernel's plain version): the same tokens
    as plain `generate`."""
    d, _, config = family_dirs["qwen3"]
    model = port_client(d, registry.port, "qwen3")
    drafter = GreedyTreeDrafter(
        LocalDraftModel.from_dir(d, device="cpu"), branching=(2, 1)
    )
    input_ids = prompt_ids(config, b=1, s=5, seed=2)
    got = run(loop, generate_speculative(model, drafter, input_ids,
                                         max_new_tokens=8))
    assert got.shape[1] >= input_ids.shape[1] + 8
    plain = run(loop, model.generate(
        input_ids, max_new_tokens=got.shape[1] - input_ids.shape[1]
    ))
    np.testing.assert_array_equal(np.asarray(got), plain.numpy())


def test_mistral_refused_as_a_local_drafter(family_dirs):
    d = family_dirs["mistral"][0]
    with pytest.raises(NotImplementedError, match="sliding-window"):
        LocalDraftModel.from_dir(d, device="cpu")
    with pytest.raises(NotImplementedError, match="sliding-window"):
        LocalJaxDraftModel.from_dir(d)

"""The port's Gemma families (Gemma2, Gemma3, Gemma3-text) on the CPU,
against HF and the JAX package.

- Registry: the port's spec of tiny HF `Gemma2Config` / `Gemma3TextConfig`
  models and of the published Gemma-2-9B, Gemma-2-27B and Gemma-3-27B
  configs (a nested `text_config`; a config without `layer_types`, the
  two-layer fallback) equals the JAX spec field for field.
- Per layer (f32, within 1e-5, weights from one numpy seed): `layer_body`
  on each route the executor lets the family take, `layer_body_ragged`
  (dense, and the ragged kernel's plain version for Gemma3) and the span
  step over a sliding and a full layer (per-layer rope theta) against the
  JAX functions. Cases: Gemma2 with an attention soft-cap that bites,
  window 5 < context, head_dim 64, group 2 (dense routes only: its kernel
  routes raise); Gemma3 with q/k norms, a local rope base and window 5.
- Executor: a Gemma2 span at an in-domain geometry stays dense at
  BBTPU_PAGED_MIN_CONTEXT=0 (no kernel's plain version runs) and a Gemma3
  span takes the paged routes; both match a JAX executor (Gemma3's on its
  Pallas kernels in interpret mode, BBTPU_PAGED_INTERPRET=1).
- Head: `embed_impl` with the embedding multiplier, `norm_head_impl` and
  `norm_head_chunked` with the final soft-cap against the JAX functions.
- Weights: the port's loaders store every Gemma RMSNorm as 1 + w (q/k
  norms included) and tie the head, as the JAX loaders do
  (`params_from_jax`, `client_params_from_jax` carry them over exactly); a
  multimodal-prefixed Gemma3 checkpoint loads the same tensors.
- Full chain: tiny HF Gemma2 and Gemma3 models (head_dim 64) saved
  locally, served by two port servers built from the directory with
  BBTPU_PAGED_MIN_CONTEXT=0, read by the port client's `from_pretrained`:
  logits within 2e-3 of HF's, greedy tokens equal to HF's and to a JAX
  server + JAX client; `generate(server_decode=True)` equals per-step
  `generate`; `run_server.main` builds and warms a server from each
  directory; both packages refuse Gemma as a local drafter.

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

from bloombee_tpu.client.model import _norm_head_chunked as j_head_chunked
from bloombee_tpu.kv.cache_manager import CacheManager as JaxManager
from bloombee_tpu.models import auto as j_auto
from bloombee_tpu.models import checkpoint as j_ckpt
from bloombee_tpu.models import head as j_head
from bloombee_tpu.models.spec import ModelSpec as JaxSpec
from bloombee_tpu.ops.rotary import rotary_cos_sin as j_rope
from bloombee_tpu.runtime import step as j_step
from bloombee_tpu.runtime.executor import SpanExecutor as JaxExecutor
from bloombee_tpu.spec.drafter import LocalJaxDraftModel
from bloombee_tpu_torch.cli import run_server
from bloombee_tpu_torch.client import ClientConfig, DistributedModelForCausalLM
from bloombee_tpu_torch.kv.arena import write_plan
from bloombee_tpu_torch.kv.cache_manager import CacheManager
from bloombee_tpu_torch.models import auto
from bloombee_tpu_torch.models import checkpoint as t_ckpt
from bloombee_tpu_torch.models import head as t_head
from bloombee_tpu_torch.models.llama import block as t_block
from bloombee_tpu_torch.models.spec import ModelSpec
from bloombee_tpu_torch.ops.cuda import paged_attention as t_paged
from bloombee_tpu_torch.ops.rotary import rotary_cos_sin as t_rope
from bloombee_tpu_torch.runtime import layer_body as t_body
from bloombee_tpu_torch.runtime.executor import SpanExecutor
from bloombee_tpu_torch.runtime.step import span_step
from bloombee_tpu_torch.server.block_server import BlockServer
from bloombee_tpu_torch.spec.drafter import LocalDraftModel
from bloombee_tpu_torch.swarm.registry import RegistryClient
from test_torch_families import (
    PAGES,
    PAST,
    PS,
    arena_and_steps,
    j_layer_body,
    j_layer_body_ragged,
    kernel_route_server,
    port_client,
    prompt_ids,
    run,
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
from test_torch_slice import count_routes

EPS = 1e-5
FAMILIES = ("gemma2", "gemma3")


# ---------------------------------------------------------------- configs
def hf_config(family):
    """A tiny HF config per family at head_dim 64 (the CUDA kernels'
    domain), a window shorter than the test prompts and a query scale from
    `query_pre_attn_scalar` != head_dim. Gemma2's soft-caps are small
    enough to bite at HF's init scale; eager attention, the HF path that
    applies the attention soft-cap."""
    import transformers as tf

    common = dict(intermediate_size=128, num_hidden_layers=2,
                  vocab_size=128, rms_norm_eps=1e-6, head_dim=64,
                  max_position_embeddings=256, sliding_window=6,
                  query_pre_attn_scalar=48)
    if family == "gemma2":
        config = tf.Gemma2Config(
            hidden_size=128, num_attention_heads=2, num_key_value_heads=1,
            attn_logit_softcapping=0.05, final_logit_softcapping=0.5,
            **common,
        )
        cls = tf.Gemma2ForCausalLM
    else:
        config = tf.Gemma3TextConfig(
            hidden_size=64, num_attention_heads=4, num_key_value_heads=2,
            rope_theta=1e6, rope_local_base_freq=1e4,
            layer_types=["sliding_attention", "full_attention"], **common,
        )
        cls = tf.Gemma3ForCausalLM
    config._attn_implementation = "eager"
    return config, cls


# the published configs (each model's config.json on the hub; Gemma-3's
# text_config with the fields HF's Gemma3TextConfig fills in by default
# and its layer_types written out)
GEMMA3_27B_TEXT = {
    "model_type": "gemma3_text", "hidden_size": 5376,
    "intermediate_size": 21504, "num_attention_heads": 32,
    "num_key_value_heads": 16, "head_dim": 128, "num_hidden_layers": 62,
    "vocab_size": 262208, "rms_norm_eps": 1e-6, "rope_theta": 1e6,
    "rope_local_base_freq": 1e4, "query_pre_attn_scalar": 168,
    "sliding_window": 1024, "max_position_embeddings": 131072,
    "layer_types": [
        "full_attention" if (i + 1) % 6 == 0 else "sliding_attention"
        for i in range(62)
    ],
}
PUBLISHED = {
    "gemma-2-9b": {
        "model_type": "gemma2", "hidden_size": 3584,
        "intermediate_size": 14336, "num_attention_heads": 16,
        "num_key_value_heads": 8, "head_dim": 256, "num_hidden_layers": 42,
        "vocab_size": 256000, "rms_norm_eps": 1e-6, "rope_theta": 10000.0,
        "query_pre_attn_scalar": 256, "sliding_window": 4096,
        "attn_logit_softcapping": 50.0, "final_logit_softcapping": 30.0,
        "max_position_embeddings": 8192,
    },
    "gemma-2-27b": {
        "model_type": "gemma2", "hidden_size": 4608,
        "intermediate_size": 36864, "num_attention_heads": 32,
        "num_key_value_heads": 16, "head_dim": 128, "num_hidden_layers": 46,
        "vocab_size": 256000, "rms_norm_eps": 1e-6, "rope_theta": 10000.0,
        "query_pre_attn_scalar": 144, "sliding_window": 4096,
        "attn_logit_softcapping": 50.0, "final_logit_softcapping": 30.0,
        "max_position_embeddings": 8192,
    },
    "gemma-3-27b": {
        "model_type": "gemma3",
        "architectures": ["Gemma3ForConditionalGeneration"],
        "text_config": GEMMA3_27B_TEXT,
    },
    # no layer_types: both packages fall back to ("sliding", "full")
    "gemma3-no-layer-types": {
        k: v for k, v in GEMMA3_27B_TEXT.items() if k != "layer_types"
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
    assert got.sandwich_norms and got.mlp_type == "gelu_tanh_gated"
    if name == "gemma-3-27b":
        assert got.family == "gemma3" and got.qk_norm
        assert [got.window_for_layer(i) for i in range(6)] == \
            [1024] * 5 + [0]
        assert got.theta_for_layer(0) == 1e4
        assert got.theta_for_layer(5) == 1e6
    if name == "gemma3-no-layer-types":
        assert got.layer_types == ("sliding", "full")


# ------------------------------------------------------------- per layer
LAYER_SPECS = {
    "gemma2": dict(family="gemma2", hidden_size=128, num_attention_heads=2,
                   num_key_value_heads=1, head_dim=64,
                   attn_logit_softcap=1.5),
    "gemma3": dict(family="gemma3", hidden_size=64, num_attention_heads=4,
                   num_key_value_heads=2, head_dim=64, qk_norm=True,
                   rope_theta=1e6, rope_local_theta=1e4),
}
GEMMA = dict(layer_types=("sliding", "full"), sliding_window=5,
             attention_multiplier=48**-0.5, mlp_type="gelu_tanh_gated",
             sandwich_norms=True, tie_word_embeddings=True)


def specs(case, layers=1):
    kw = dict(intermediate_size=96, num_hidden_layers=layers,
              vocab_size=64, rms_norm_eps=1e-6, **GEMMA,
              **LAYER_SPECS[case])
    return JaxSpec(**kw), ModelSpec(**kw)


def layer_np(case, rng):
    """One layer's JAX-layout params from numpy, with the Gemma norms
    (stored as 1 + w, near 1) and Gemma3's q/k norms."""
    spec, _ = specs(case)
    d, i = spec.hidden_size, spec.intermediate_size
    h, kv, hd = spec.num_attention_heads, spec.num_key_value_heads, \
        spec.head_dim
    shapes = {
        "input_layernorm": (d,), "post_attention_layernorm": (d,),
        "pre_feedforward_layernorm": (d,),
        "post_feedforward_layernorm": (d,),
        "q_proj": (d, h * hd), "k_proj": (d, kv * hd),
        "v_proj": (d, kv * hd), "o_proj": (h * hd, d),
        "gate_proj": (d, i), "up_proj": (d, i), "down_proj": (i, d),
    }
    if spec.qk_norm:
        shapes.update(q_norm=(hd,), k_norm=(hd,))
    out = {}
    for k, s in shapes.items():
        x = rng.standard_normal(s)
        out[k] = (x / np.sqrt(s[0]) if len(s) == 2 else 1 + 0.1 * x).astype(
            np.float32
        )
    return out


@pytest.fixture(scope="module")
def layers():
    rng = np.random.default_rng(0)
    return {case: layer_np(case, rng) for case in LAYER_SPECS}


def test_layer_body_serves_gemma():
    for case in LAYER_SPECS:
        assert t_body.unsupported(specs(case)[1]) is None
    shared = dataclasses.replace(specs("gemma2")[1], k_eq_v_full=True)
    assert t_body.unsupported(shared).endswith("(ROADMAP Queue 1 item 15)")


def test_init_block_params_makes_the_gemma_norms():
    """The sandwich norms and Gemma3's q/k norms come after the Llama keys:
    the same seed gives the base weights of a Llama spec of that
    geometry."""
    for case, extras in (("gemma2", set()),
                         ("gemma3", {"q_norm", "k_norm"})):
        _, spec = specs(case)
        llama = dataclasses.replace(
            spec, family="llama", qk_norm=False, sandwich_norms=False,
            mlp_type="silu",
        )
        got = t_block.init_block_params(
            torch.Generator().manual_seed(3), spec, device="cpu"
        )
        base = t_block.init_block_params(
            torch.Generator().manual_seed(3), llama, device="cpu"
        )
        assert set(got) == set(base) | extras | {
            "pre_feedforward_layernorm", "post_feedforward_layernorm"
        }
        for k, w in base.items():
            torch.testing.assert_close(got[k], w, atol=0, rtol=0)


# route -> (step tokens, use_paged, use_flash)
ROUTES = {
    "dense": (5, False, False),
    "paged-decode": (1, True, False),
    "paged-chunk": (5, True, False),
}
# the executor's gates: Gemma2's soft-cap keeps it dense; a window keeps
# flash and tree rows off
LAYER_CASES = [("gemma2", "dense"), ("gemma2", "dense-decode"),
               *(("gemma3", r) for r in ROUTES)]
ROUTES["dense-decode"] = (1, False, False)


def layer_inputs(case, t, seed):
    j_spec, t_spec = specs(case)
    rng = np.random.default_rng(seed)
    k, v, table, pos, slots, hidden, lens = arena_and_steps(j_spec, t, rng)
    window = t_spec.window_for_layer(0)
    assert 0 < window < min(PAST)
    theta = t_spec.theta_for_layer(0)
    return j_spec, t_spec, (k, v, table, pos, slots, hidden, lens), window, \
        theta


@pytest.mark.parametrize("case,route", LAYER_CASES,
                         ids=[f"{c}-{r}" for c, r in LAYER_CASES])
def test_layer_body_matches_jax(layers, case, route):
    t, use_paged, use_flash = ROUTES[route]
    j_spec, t_spec, (k, v, table, pos, slots, hidden, lens), window, theta \
        = layer_inputs(case, t, 1)
    want, wk, wv = j_layer_body(
        j_spec, PS, jnp.asarray(hidden), jax.tree.map(jnp.asarray,
                                                     layers[case]),
        jnp.asarray(k), jnp.asarray(v),
        *j_rope(jnp.asarray(pos), j_spec.head_dim, theta),
        jnp.asarray(slots), jnp.asarray(table), jnp.asarray(pos),
        jnp.asarray(lens), None, window,
    )
    (params,) = t_block.params_from_jax([layers[case]], device="cpu")
    tk, tv = torch.from_numpy(k.copy()), torch.from_numpy(v.copy())
    got = t_body.layer_body(
        t_spec, PS, torch.from_numpy(hidden), params, tk, tv,
        *t_rope(torch.from_numpy(pos), t_spec.head_dim, theta),
        write_plan(slots, PAGES * PS, "cpu"), torch.from_numpy(table),
        torch.from_numpy(pos), torch.from_numpy(lens), None, window,
        use_flash=use_flash, use_paged=use_paged, t_real=t,
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=EPS,
                               rtol=EPS)
    np.testing.assert_allclose(tk.numpy(), np.asarray(wk), atol=EPS, rtol=0)
    np.testing.assert_allclose(tv.numpy(), np.asarray(wv), atol=EPS, rtol=0)


def test_soft_cap_bites_and_kernel_routes_refuse_it(layers):
    """The Gemma2 case's cap changes the output (so the match above pins
    it), and asking a kernel route for a soft-capped layer raises rather
    than drop the cap."""
    _, t_spec, (k, v, table, pos, slots, hidden, lens), window, theta = \
        layer_inputs("gemma2", 5, 1)
    (params,) = t_block.params_from_jax([layers["gemma2"]], device="cpu")

    def body(spec, **route):
        return t_body.layer_body(
            spec, PS, torch.from_numpy(hidden), params,
            torch.from_numpy(k.copy()), torch.from_numpy(v.copy()),
            *t_rope(torch.from_numpy(pos), spec.head_dim, theta),
            write_plan(slots, PAGES * PS, "cpu"), torch.from_numpy(table),
            torch.from_numpy(pos), torch.from_numpy(lens), None, window,
            t_real=5, **route,
        )

    uncapped = dataclasses.replace(t_spec, attn_logit_softcap=0.0)
    assert (body(t_spec) - body(uncapped)).abs().max() > 1e-2
    for route in ({"use_paged": True}, {"use_flash": True}):
        with pytest.raises(ValueError, match="soft-cap"):
            body(t_spec, **route)
    with pytest.raises(ValueError, match="soft-cap"):
        t_body.layer_body_ragged(
            t_spec, PS, torch.from_numpy(hidden[:1]), params, None, None,
            None, None, None, None, None, None, None, window,
            use_kernel=True,
        )


@pytest.mark.parametrize("case,use_kernel",
                         [("gemma2", False), ("gemma3", False),
                          ("gemma3", True)],
                         ids=["gemma2-dense", "gemma3-dense",
                              "gemma3-kernel"])
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
    window, theta = t_spec.window_for_layer(0), t_spec.theta_for_layer(0)

    want, wk, _ = j_layer_body_ragged(
        j_spec, PS, jnp.asarray(hidden),
        jax.tree.map(jnp.asarray, layers[case]), jnp.asarray(k),
        jnp.asarray(v), *j_rope(jnp.asarray(q_pos[None]), j_spec.head_dim,
                                theta),
        jnp.asarray(slots.astype(np.int32)), jnp.asarray(table),
        jnp.asarray(q_pos[None]), jnp.asarray(lens), jnp.asarray(q_seq),
        window,
    )
    (params,) = t_block.params_from_jax([layers[case]], device="cpu")
    tk, tv = torch.from_numpy(k.copy()), torch.from_numpy(v.copy())
    got = t_body.layer_body_ragged(
        t_spec, PS, torch.from_numpy(hidden), params, tk, tv,
        *t_rope(torch.from_numpy(q_pos[None]), t_spec.head_dim, theta),
        write_plan(slots, PAGES * PS, "cpu"), torch.from_numpy(table),
        torch.from_numpy(q_pos[None]), torch.from_numpy(lens),
        torch.from_numpy(q_seq), window, use_kernel=use_kernel,
    )
    np.testing.assert_allclose(got[0, :r_real].numpy(),
                               np.asarray(want)[0, :r_real], atol=EPS,
                               rtol=EPS)
    np.testing.assert_allclose(tk.numpy(), np.asarray(wk), atol=EPS, rtol=0)


@pytest.mark.parametrize("case,use_paged",
                         [("gemma2", False), ("gemma3", False),
                          ("gemma3", True)],
                         ids=["gemma2-dense", "gemma3-dense",
                              "gemma3-paged"])
def test_span_step_per_layer_theta_matches_jax(case, use_paged):
    """Two layers, sliding then full (window 5, then 0): the span step
    ropes the first with the local base and the second with the global
    one, as JAX's scan selects them; 3-token steps of two sequences."""
    j_spec, t_spec = specs(case, layers=2)
    rng = np.random.default_rng(4)
    stacked = {k: np.stack([a, b]) for (k, a), b in zip(
        layer_np(case, rng).items(), layer_np(case, rng).values()
    )}
    k, v, table, pos, slots, hidden, lens = arena_and_steps(j_spec, 3, rng)
    k2, v2 = np.stack([k, 1 - k]), np.stack([v, 1 - v])
    windows = (5, 0)
    plan = j_step.pack_plan(slots, table, pos, lens, np.ones(2, np.int32))
    j_fn = jax.jit(j_step.span_step_impl, static_argnames=(
        "spec", "page_size", "max_pages", "windows",
    ))
    want, wk, _ = j_fn(
        jax.tree.map(jnp.asarray, stacked), jnp.asarray(k2),
        jnp.asarray(v2), jnp.asarray(hidden), jnp.asarray(plan),
        spec=j_spec, page_size=PS, max_pages=table.shape[1],
        windows=windows,
    )
    params = t_block.params_from_jax(stacked, device="cpu")
    tk, tv = torch.from_numpy(k2.copy()), torch.from_numpy(v2.copy())
    got = span_step(
        params, tk, tv, torch.from_numpy(hidden),
        write_plan(slots, PAGES * PS, "cpu"), torch.from_numpy(table),
        torch.from_numpy(pos), torch.from_numpy(lens), [1, 1],
        spec=t_spec, page_size=PS, windows=windows, use_paged=use_paged,
        t_real=3,
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=EPS,
                               rtol=EPS)
    np.testing.assert_allclose(tk.numpy(), np.asarray(wk), atol=EPS, rtol=0)
    if case == "gemma3":  # the local base matters: one global table differs
        same = span_step(
            params, torch.from_numpy(k2.copy()), torch.from_numpy(v2.copy()),
            torch.from_numpy(hidden), write_plan(slots, PAGES * PS, "cpu"),
            torch.from_numpy(table), torch.from_numpy(pos),
            torch.from_numpy(lens), [1, 1],
            spec=dataclasses.replace(t_spec, rope_local_theta=0.0),
            page_size=PS, windows=windows, use_paged=use_paged, t_real=3,
        )
        assert (same - got).abs().max() > 1e-3


# -------------------------------------------------------------- executor
def executor_pair(case):
    """A 2-layer span (sliding, full) of `case` on both packages, f32, 64
    pages of 4 tokens, from one seed."""
    j_spec, t_spec = specs(case, layers=2)
    rng = np.random.default_rng(5)
    stacked = {k: np.stack([a, b]) for (k, a), b in zip(
        layer_np(case, rng).items(), layer_np(case, rng).values()
    )}
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
    both; then a ragged (mixed) group of session A's decode rows and a
    4-token chunk of session B."""
    outs = []

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

    asyncio.run(go())
    return outs


@pytest.mark.parametrize("case", FAMILIES)
def test_executor_routes_and_matches_jax(monkeypatch, case):
    """At BBTPU_PAGED_MIN_CONTEXT=0 and head_dim 64 (inside the kernels'
    domain) Gemma2's soft-capped steps all stay dense, as the JAX gates
    keep them; Gemma3's decode, follow-up and ragged steps take the paged
    routes (their plain versions here) against JAX's Pallas kernels in
    interpret mode. Hidden states within 1e-5 (f32)."""
    monkeypatch.setenv("BBTPU_PAGED_MIN_CONTEXT", "0")
    monkeypatch.setenv("BBTPU_PAGED_INTERPRET", "1")
    (jm, jex), (tm, tex), h = executor_pair(case)
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
    if case == "gemma2":
        assert not (tex.paged_supported or tex.flash_supported)
        assert routes == {} and ragged["n"] == 0
    else:
        assert tex.paged_supported
        # 2 layers x (3 decodes + the group) on decode; the follow-up and
        # the 20-token prefill (bucket 32 < 128) on chunk; the mixed group
        # on ragged; no flash with a window
        assert routes["paged_decode_attention_reference"] == 8
        assert "flash_attention_reference" not in routes
        assert ragged["n"] == 2


# ------------------------------------------------------------------ head
def test_head_with_multiplier_and_soft_cap_matches_jax():
    rng = np.random.default_rng(6)
    embed = rng.standard_normal((96, 64)).astype(np.float32)
    client = {"embed": embed, "norm": 1 + 0.1 * rng.standard_normal(64),
              "lm_head": (embed.T / 2).copy()}
    client = {k: np.asarray(v, np.float32) for k, v in client.items()}
    ids = rng.integers(0, 96, (2, 5))
    hidden = rng.standard_normal((2, 3, 64)).astype(np.float32)
    tc = {k: torch.from_numpy(v) for k, v in client.items()}
    jc = {k: jnp.asarray(v) for k, v in client.items()}
    for dt, jdt in ((torch.float32, jnp.float32),
                    (torch.bfloat16, jnp.bfloat16)):
        got = t_head.embed_impl({"embed": tc["embed"].to(dt)},
                                torch.from_numpy(ids), 8.0)
        want = j_head.embed_impl({"embed": jc["embed"].astype(jdt)},
                                 jnp.asarray(ids), 8.0)
        assert got.dtype == dt
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(want, np.float32))
    for cap in (0.0, 2.0):
        want = np.asarray(j_head.norm_head_impl(jc, jnp.asarray(hidden),
                                                1e-6, cap))
        got = t_head.norm_head_impl(tc, torch.from_numpy(hidden), 1e-6, cap)
        np.testing.assert_allclose(got.numpy(), want, atol=EPS, rtol=EPS)
        got = t_head.norm_head_chunked(tc, torch.from_numpy(hidden), 1e-6,
                                       cap, step=40)
        want_c = np.asarray(j_head_chunked(jc, jnp.asarray(hidden), 1e-6,
                                           cap, step=40))
        np.testing.assert_allclose(got.numpy(), want_c, atol=EPS, rtol=EPS)
        assert (np.abs(got.numpy()) <= 2.0).all() or not cap


# --------------------------------------------------------------- weights
@pytest.fixture(scope="module")
def gemma_dirs(tmp_path_factory):
    """family -> (model dir, HF model, HF config)."""
    out = {}
    for family in FAMILIES:
        config, cls = hf_config(family)
        torch.manual_seed(0)
        model = cls(config).eval().to(torch.float32)
        with torch.no_grad():  # Gemma inits its norms at 0: make them bite
            for name, p in model.named_parameters():
                if "norm" in name:
                    p.normal_(0.0, 0.1)
        d = tmp_path_factory.mktemp(f"tiny_{family}")
        model.save_pretrained(d, safe_serialization=True)
        out[family] = (str(d), model, config)
    return out


@pytest.mark.parametrize("family", FAMILIES)
def test_loaders_store_one_plus_w_and_match_jax(gemma_dirs, family):
    """Every Gemma RMSNorm loads as 1 + w (Gemma3's q/k norms too), the
    head is the embedding's transpose, and the JAX loaders' trees carried
    over with `params_from_jax` / `client_params_from_jax` are the port
    loaders' tensors exactly."""
    d, hf, config = gemma_dirs[family]
    layers, spec = t_ckpt.load_span_params(d, 0, 2, device="cpu")
    client = t_ckpt.load_client_params(d, device="cpu")
    sd = hf.state_dict()
    norms = {"input_layernorm", "post_attention_layernorm",
             "pre_feedforward_layernorm", "post_feedforward_layernorm"}
    if family == "gemma3":
        norms |= {"q_norm", "k_norm"}
    assert norms <= set(layers[1])
    for name in norms:
        sub = "self_attn." if name in ("q_norm", "k_norm") else ""
        w = sd[f"model.layers.1.{sub}{name}.weight"]
        torch.testing.assert_close(layers[1][name], 1 + w, atol=0, rtol=0)
    torch.testing.assert_close(client["norm"], 1 + sd["model.norm.weight"],
                               atol=0, rtol=0)
    torch.testing.assert_close(client["lm_head"], client["embed"].t(),
                               atol=0, rtol=0)

    j_layers, _ = j_ckpt.load_span_params(d, 0, 2, dtype=jnp.float32)
    j_layers = [jax.tree.map(np.asarray, p) for p in j_layers] \
        if isinstance(j_layers, (list, tuple)) else \
        jax.tree.map(np.asarray, j_layers)
    carried = t_block.params_from_jax(j_layers, device="cpu")
    for got, want in zip(carried, layers, strict=True):
        assert set(got) == set(want)
        for k in want:
            torch.testing.assert_close(got[k], want[k], atol=0, rtol=0)
    j_client = j_ckpt.load_client_params(d, dtype=jnp.float32)
    carried = t_head.client_params_from_jax(
        jax.tree.map(np.asarray, j_client), device="cpu"
    )
    for k in ("embed", "norm", "lm_head"):
        torch.testing.assert_close(carried[k], client[k], atol=0, rtol=0)


def test_multimodal_gemma3_checkpoint_loads(gemma_dirs, tmp_path):
    """A Gemma3 bundle (model_type gemma3, the text tower under
    text_config and language_model.model.*) loads the text-only
    checkpoint's spec and tensors, in both packages."""
    from safetensors.torch import save_file

    d, hf, config = gemma_dirs["gemma3"]
    with open(f"{d}/config.json") as f:
        text = json.load(f)
    (tmp_path / "config.json").write_text(json.dumps({
        "model_type": "gemma3", "text_config": text,
    }))
    save_file({f"language_model.{k}": v.contiguous()
               for k, v in hf.state_dict().items()
               if k.startswith("model.")},
              str(tmp_path / "model.safetensors"))
    mm = str(tmp_path)
    assert t_ckpt.load_spec(mm) == dataclasses.replace(
        t_ckpt.load_spec(d), family="gemma3"
    )
    want, _ = t_ckpt.load_span_params(d, 0, 2, device="cpu")
    got, spec = t_ckpt.load_span_params(mm, 0, 2, device="cpu")
    assert spec.family == "gemma3" and spec.qk_norm
    for g, w in zip(got, want, strict=True):
        for k in w:
            torch.testing.assert_close(g[k], w[k], atol=0, rtol=0)
    got_c = t_ckpt.load_client_params(mm, device="cpu")
    want_c = t_ckpt.load_client_params(d, device="cpu")
    for k in want_c:
        torch.testing.assert_close(got_c[k], want_c[k], atol=0, rtol=0)
    j_client = j_ckpt.load_client_params(mm, dtype=jnp.float32)
    np.testing.assert_array_equal(np.asarray(j_client["norm"]),
                                  want_c["norm"].numpy())


# ------------------------------------------------------------ full chain
@pytest.fixture(scope="module")
def chains(loop, gemma_dirs, registry):
    """Per family: two port servers ([0, 1), [1, 2)) under uid
    "<family>" and a JAX server ([0, 2)) under "<family>-jax"."""
    servers = []
    for family, (d, _, _) in gemma_dirs.items():
        servers += [
            kernel_route_server(d, registry.port, family, 0, 1),
            kernel_route_server(d, registry.port, family, 1, 2),
            jax_server(d, registry.port, f"{family}-jax", 0, 2),
        ]
    run(loop, start_all(*servers))
    yield servers
    run(loop, stop_all(*servers))


def hf_greedy(model, input_ids, max_new_tokens):
    """HF greedy tokens with an explicit mask: Gemma's pad id is 0, and
    `generate` would otherwise mask every prompt token 0 as padding."""
    x = torch.tensor(input_ids)
    with torch.no_grad():
        return model.generate(
            x, attention_mask=torch.ones_like(x),
            max_new_tokens=max_new_tokens, do_sample=False, use_cache=True,
            eos_token_id=None, pad_token_id=0,
        ).numpy()


@pytest.mark.parametrize("family", FAMILIES)
def test_full_chain_logits_match_hf(loop, gemma_dirs, registry, chains,
                                    family):
    d, hf, config = gemma_dirs[family]
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
def test_full_chain_greedy_matches_hf_and_jax(loop, gemma_dirs, registry,
                                              chains, family):
    """Greedy tokens past the window through the port chain equal HF's and
    the JAX client's through the JAX server; the port servers of Gemma2
    stayed off the kernels' plain versions (soft-cap), Gemma3's took
    them."""
    d, hf, config = gemma_dirs[family]
    input_ids = prompt_ids(config, seed=1)
    model = port_client(d, registry.port, family)
    got = run(loop, model.generate(input_ids, max_new_tokens=8)).numpy()
    want = run(loop, jax_client(d, registry.port, f"{family}-jax").generate(
        input_ids, max_new_tokens=8
    ))
    np.testing.assert_array_equal(got, hf_greedy(hf, input_ids, 8))
    np.testing.assert_array_equal(got, np.asarray(want))
    ports = [s for s in chains if isinstance(s, BlockServer)
             and s.model_uid == family]
    assert len(ports) == 2
    assert all(s.executor.paged_supported == (family == "gemma3")
               for s in ports)


@pytest.mark.parametrize("family", FAMILIES)
def test_server_decode_matches_per_step(loop, gemma_dirs, registry, family):
    """One whole-model port server (the fused decode loop: the embedding
    multiplier, Gemma2's final soft-cap, Gemma3's per-layer rope bases):
    `generate(server_decode=True)` gives per-step `generate`'s tokens."""
    d, hf, config = gemma_dirs[family]
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
def test_run_server_builds_and_warms_a_gemma_span(gemma_dirs, monkeypatch,
                                                  family):
    """`run_server.main` takes the directory through the registry, loads
    the span, runs the warmup (a decode step and the checkpoint's client
    parameters through the family's client loader) and reaches start."""
    d, hf, _ = gemma_dirs[family]
    seen = {}

    class Reached(Exception):
        pass

    async def start(self):
        seen["server"] = self
        raise Reached

    monkeypatch.setattr(BlockServer, "start", start)
    with pytest.raises(Reached):
        run_server.main([d, "--blocks", "0:2", "--device", "cpu",
                         "--dtype", "float32", "--registry", "127.0.0.1:1",
                         "--host", "127.0.0.1", "--num-pages", "16",
                         "--page-size", "4", "--log-level", "WARNING"])
    server = seen["server"]
    assert server.spec == t_ckpt.load_spec(d)
    torch.testing.assert_close(
        server._client_params["norm"],
        1 + hf.state_dict()["model.norm.weight"], atol=0, rtol=0,
    )


@pytest.mark.parametrize("family", FAMILIES)
def test_gemma_refused_as_a_local_drafter(gemma_dirs, family):
    d = gemma_dirs[family][0]
    with pytest.raises(NotImplementedError, match="sliding-window"):
        LocalDraftModel.from_dir(d, device="cpu")
    with pytest.raises(NotImplementedError, match="sliding-window"):
        LocalJaxDraftModel.from_dir(d)

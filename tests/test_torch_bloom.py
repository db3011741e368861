"""The port's Bloom family on the CPU, against HF and the JAX package.

- Registry: the port's spec of tiny HF `BloomConfig`s (tests/test_families
  .py's, and the chain's below) and of the published bloom-7b1 and
  BLOOM-176B configs equals the JAX spec field for field; `alibi_slopes`
  equals JAX's for every head count in 1..130 (the odd-head extension:
  112 = 64 + 48).
- Weights: `init_block_params` makes the LayerNorm and projection biases
  after the existing keys, and draws no gate for the plain MLP.
- Per layer (f32, within 1e-5, weights from one numpy seed, head_dim 64:
  inside the CUDA kernels' domain, so the ALiBi gate alone keeps them
  off): `layer_body` on every dense route (a prefill from position 0, a
  decode, a 5-token follow-up and a tree verify past a history) and
  `layer_body_ragged` on its dense route, against the JAX functions. The
  ALiBi bias changes the attention output, and every kernel route asked
  for an ALiBi layer raises.
- Executor: `paged_supported` / `flash_supported` are False for an ALiBi
  spec at every geometry of the kernels' domain; a 2-layer span at
  BBTPU_PAGED_MIN_CONTEXT=0 runs no kernel's plain version and matches a
  JAX executor (prefill, decodes, follow-up, decode group, mixed group).
- Head: `embed_impl` with the embedding LayerNorm (f32 and bf16 tables),
  `norm_head_impl` and `norm_head_chunked` with the LayerNorm head against
  the JAX functions.
- Loader: on a checkpoint saved by HF's `BloomForCausalLM` (the
  `transformer.` prefix, the fused per-head QKV), the port's loaders give
  the JAX loaders' tensors exactly, the head is a view of the embedding,
  and the same tensors without the prefix (the hub's layout) load the
  same.
- Full chain: the tiny HF Bloom served by two port servers built from the
  directory with BBTPU_PAGED_MIN_CONTEXT=0, read by the port client's
  `from_pretrained`: logits within 2e-3 of HF's; greedy tokens equal to
  HF's, through the port client and through the JAX client on the same
  port chain; `generate(server_decode=True)` equals per-step `generate`;
  `run_server.main` builds and warms a Bloom span; both packages refuse
  Bloom as a local drafter, naming ALiBi.

The loop, registry and server helpers are tests/test_torch_server.py's;
every networked call here is bounded at 60 s.
"""

import dataclasses
import shutil

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
from bloombee_tpu.ops.alibi import alibi_slopes as j_alibi_slopes
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
from bloombee_tpu_torch.ops.alibi import alibi_slopes
from bloombee_tpu_torch.ops.cuda import paged_attention as t_paged
from bloombee_tpu_torch.runtime import layer_body as t_body
from bloombee_tpu_torch.runtime.executor import SpanExecutor
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
    tree_mask,
)
from test_torch_gemma import drive_executor
from test_torch_server import (  # noqa: F401  (fixtures)
    REGISTRY_CLIENTS,
    client as jax_client,
    hf_logits,
    loop,
    registry,
    start_all,
    stop_all,
)
from test_torch_slice import count_routes

EPS = 1e-5
UID = "bloom"


# ---------------------------------------------------------------- configs
def hf_config(hidden=256, n_head=4):
    """A tiny HF Bloom: by default 4 heads of 64 (the CUDA kernels'
    domain), 2 layers, vocab 128; hidden 64 is tests/test_families.py's
    (heads of 16)."""
    import transformers as tf

    return tf.BloomConfig(hidden_size=hidden, n_head=n_head, n_layer=2,
                          vocab_size=128, layer_norm_epsilon=1e-5)


# the published configs (config.json of bigscience/bloom-7b1 and
# bigscience/bloom), the fields both packages read
PUBLISHED = {
    "bloom-7b1": {"model_type": "bloom", "hidden_size": 4096, "n_head": 32,
                  "n_layer": 30, "vocab_size": 250880,
                  "layer_norm_epsilon": 1e-5},
    "bloom": {"model_type": "bloom", "hidden_size": 14336, "n_head": 112,
              "n_layer": 70, "vocab_size": 250880,
              "layer_norm_epsilon": 1e-5},
}


@pytest.mark.parametrize("name", ["tiny-64", "tiny-256", *PUBLISHED])
def test_spec_matches_jax(name):
    if name in PUBLISHED:
        config = PUBLISHED[name]
    else:
        hf = hf_config(64) if name == "tiny-64" else hf_config()
        config = hf.to_dict()
        assert dataclasses.asdict(auto.spec_from_hf_config(hf)) == \
            dataclasses.asdict(j_auto.spec_from_hf_config(hf))
    got = auto.spec_from_config_dict(config)
    want = j_auto.spec_from_config_dict(config)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.alibi and got.norm_type == "ln" and \
        got.mlp_type == "gelu_tanh" and got.tie_word_embeddings
    assert got.intermediate_size == 4 * got.hidden_size
    assert t_body.unsupported(got) is None
    assert "bloom" not in auto.UNPORTED


def test_alibi_slopes_match_jax():
    for n in range(1, 131):
        got, want = alibi_slopes(n), j_alibi_slopes(n)
        assert got.dtype == np.float32 and got.shape == (n,)
        np.testing.assert_array_equal(got, want)


# ------------------------------------------------------------- per layer
def specs(layers=1):
    kw = dict(family="bloom", hidden_size=256, intermediate_size=1024,
              num_attention_heads=4, num_key_value_heads=4, head_dim=64,
              num_hidden_layers=layers, vocab_size=128, rms_norm_eps=1e-5,
              tie_word_embeddings=True, alibi=True, norm_type="ln",
              mlp_type="gelu_tanh")
    return JaxSpec(**kw), ModelSpec(**kw)


def layer_np(rng):
    """One Bloom layer's JAX-layout params from numpy: LayerNorm weights
    near 1 with biases, every projection biased, no gate."""
    spec, _ = specs()
    d, i = spec.hidden_size, spec.intermediate_size
    hd = spec.num_attention_heads * spec.head_dim
    shapes = {
        "input_layernorm": (d,), "post_attention_layernorm": (d,),
        "q_proj": (d, hd), "k_proj": (d, hd), "v_proj": (d, hd),
        "o_proj": (hd, d), "up_proj": (d, i), "down_proj": (i, d),
        "input_layernorm_bias": (d,), "post_attention_layernorm_bias": (d,),
        "q_bias": (hd,), "k_bias": (hd,), "v_bias": (hd,), "o_bias": (d,),
        "up_bias": (i,), "down_bias": (d,),
    }
    out = {}
    for k, s in shapes.items():
        x = rng.standard_normal(s)
        if len(s) == 2:
            x = x / np.sqrt(s[0])
        elif k.endswith("layernorm"):
            x = 1 + 0.1 * x
        else:
            x = 0.1 * x
        out[k] = x.astype(np.float32)
    return out


@pytest.fixture(scope="module")
def layer():
    return layer_np(np.random.default_rng(0))


def test_init_block_params_makes_the_bloom_biases():
    """The biases come after the other keys: the same seed gives a
    bias-free spec of the same structure the same weights; no gate."""
    _, spec = specs()
    plain = dataclasses.replace(spec, norm_type="rms", alibi=False)
    got = t_block.init_block_params(torch.Generator().manual_seed(3), spec,
                                    device="cpu")
    base = t_block.init_block_params(torch.Generator().manual_seed(3),
                                     plain, device="cpu")
    biases = {"input_layernorm_bias", "post_attention_layernorm_bias",
              "q_bias", "k_bias", "v_bias", "o_bias", "up_bias",
              "down_bias"}
    assert set(got) == set(base) | biases and "gate_proj" not in got
    assert set(got) == set(layer_np(np.random.default_rng(0)))
    for k, w in base.items():
        torch.testing.assert_close(got[k], w, atol=0, rtol=0)
    assert got["up_bias"].shape == (spec.intermediate_size,)


def layer_inputs(t, route, seed=1):
    """Numpy inputs of a t-token step of two sequences: past PAST tokens
    ("decode", "chunk", "tree"; tree positions are the nodes' depths) or
    from position 0 ("prefill")."""
    j_spec, _ = specs()
    rng = np.random.default_rng(seed)
    k, v, table, pos, slots, hidden, lens = arena_and_steps(j_spec, t, rng)
    tm = None
    if route == "prefill":
        pos = np.broadcast_to(np.arange(t), (2, t)).astype(np.int32)
        slots = (table[np.arange(2)[:, None], pos // PS] * PS
                 + pos % PS).reshape(-1).astype(np.int32)
        lens = np.full(2, t, np.int32)
    if route == "tree":
        tm = tree_mask(t)
        pos = (lens - t)[:, None] + (tm[0].sum(-1) - 1)[None].astype(
            np.int32
        )
    return k, v, table, pos, slots, hidden, lens, tm


def port_layer(params, inputs, spec=None, **route):
    k, v, table, pos, slots, hidden, lens, tm = inputs
    spec = spec or specs()[1]
    tk, tv = torch.from_numpy(k.copy()), torch.from_numpy(v.copy())
    cos = torch.ones(*pos.shape, spec.head_dim)  # ALiBi reads no rotary
    out = t_body.layer_body(
        spec, PS, torch.from_numpy(hidden), params, tk, tv, cos,
        torch.zeros_like(cos), write_plan(slots, PAGES * PS, "cpu"),
        torch.from_numpy(table), torch.from_numpy(pos),
        torch.from_numpy(lens), None if tm is None else torch.from_numpy(tm),
        0, t_real=hidden.shape[1], **route,
    )
    return out, tk, tv


ROUTES = {"prefill": 7, "decode": 1, "chunk": 5, "tree": 5}


@pytest.mark.parametrize("route", list(ROUTES))
def test_layer_body_matches_jax(layer, route):
    inputs = layer_inputs(ROUTES[route], route)
    k, v, table, pos, slots, hidden, lens, tm = inputs
    j_spec, _ = specs()
    ones = jnp.ones((*pos.shape, j_spec.head_dim), jnp.float32)
    want, wk, wv = j_layer_body(
        j_spec, PS, jnp.asarray(hidden), jax.tree.map(jnp.asarray, layer),
        jnp.asarray(k), jnp.asarray(v), ones, jnp.zeros_like(ones),
        jnp.asarray(slots), jnp.asarray(table), jnp.asarray(pos),
        jnp.asarray(lens), None if tm is None else jnp.asarray(tm), 0,
    )
    (params,) = t_block.params_from_jax([layer], device="cpu")
    got, tk, tv = port_layer(params, inputs)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=EPS,
                               rtol=EPS)
    np.testing.assert_allclose(tk.numpy(), np.asarray(wk), atol=EPS, rtol=0)
    np.testing.assert_allclose(tv.numpy(), np.asarray(wv), atol=EPS, rtol=0)


def test_alibi_bites_and_kernel_routes_refuse_it(layer):
    """The bias changes the dense attention of the chunk step (so the match
    above pins it), and a kernel route asked for an ALiBi layer raises
    rather than drop the bias."""
    inputs = layer_inputs(5, "chunk")
    k, v, table, pos, _, _, lens, _ = inputs
    _, spec = specs()
    rng = np.random.default_rng(2)
    q = torch.from_numpy(rng.standard_normal((2, 5, 4, 64)).astype(
        np.float32))
    ctx = [torch.from_numpy(x.reshape(PAGES, PS, 4, 64)[table].reshape(
        2, -1, 4, 64)) for x in (k, v)]
    args = (q, *ctx, torch.from_numpy(pos), torch.from_numpy(lens), None, 0)
    biased = t_body.attend_paged(spec, *args)
    plain = t_body.attend_paged(dataclasses.replace(spec, alibi=False),
                                *args)
    assert (biased - plain).abs().max() > 1e-2

    (params,) = t_block.params_from_jax([layer], device="cpu")
    for route in ({"use_paged": True}, {"use_flash": True}):
        with pytest.raises(ValueError, match="ALiBi"):
            port_layer(params, inputs, **route)
    with pytest.raises(ValueError, match="ALiBi"):
        t_body.layer_body_ragged(
            spec, PS, torch.zeros(1, 8, 256), params, None, None, None,
            None, None, None, None, None, None, 0, use_kernel=True,
        )


def test_layer_body_ragged_matches_jax(layer):
    """A ragged step on the dense route: sequence 0's decode row, sequence
    1's 4-token chunk and 3 padding rows (slots out of the arena)."""
    j_spec, t_spec = specs()
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
    ones = np.ones((1, rb, j_spec.head_dim), np.float32)
    want, wk, _ = j_layer_body_ragged(
        j_spec, PS, jnp.asarray(hidden), jax.tree.map(jnp.asarray, layer),
        jnp.asarray(k), jnp.asarray(v), jnp.asarray(ones),
        jnp.asarray(1 - ones), jnp.asarray(slots.astype(np.int32)),
        jnp.asarray(table), jnp.asarray(q_pos[None]), jnp.asarray(lens),
        jnp.asarray(q_seq), 0,
    )
    (params,) = t_block.params_from_jax([layer], device="cpu")
    tk, tv = torch.from_numpy(k.copy()), torch.from_numpy(v.copy())
    got = t_body.layer_body_ragged(
        t_spec, PS, torch.from_numpy(hidden), params, tk, tv,
        torch.from_numpy(ones), torch.from_numpy(1 - ones),
        write_plan(slots, PAGES * PS, "cpu"), torch.from_numpy(table),
        torch.from_numpy(q_pos[None]), torch.from_numpy(lens),
        torch.from_numpy(q_seq), 0,
    )
    np.testing.assert_allclose(got[0, :r_real].numpy(),
                               np.asarray(want)[0, :r_real], atol=EPS,
                               rtol=EPS)
    np.testing.assert_allclose(tk.numpy(), np.asarray(wk), atol=EPS, rtol=0)


# -------------------------------------------------------------- executor
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_no_kernel_route_for_alibi_at_any_geometry(dtype):
    """Every geometry of the kernels' domain: the same spec without ALiBi
    takes the kernels, the ALiBi spec neither the paged nor the flash
    kernels."""
    for h in (1, 2, 4, 8):
        for hd in (64, 128):
            spec = dataclasses.replace(
                specs()[1], hidden_size=h * hd, intermediate_size=4 * h * hd,
                num_attention_heads=h, num_key_value_heads=h, head_dim=hd,
            )
            for alibi in (True, False):
                manager = CacheManager(1, 4, PS, h, hd, dtype=dtype,
                                       device="cpu")
                ex = SpanExecutor([{}], dataclasses.replace(spec,
                                                            alibi=alibi),
                                  manager, compute_dtype=dtype,
                                  device="cpu")
                assert ex.paged_supported == ex.flash_supported == \
                    (not alibi)


def test_executor_stays_dense_and_matches_jax(monkeypatch):
    """At BBTPU_PAGED_MIN_CONTEXT=0 and head_dim 64 every step of a 2-layer
    Bloom span takes the dense routes (no kernel's plain version runs), as
    the JAX gates keep it; hidden states within 1e-5 (f32) of a JAX
    executor's."""
    monkeypatch.setenv("BBTPU_PAGED_MIN_CONTEXT", "0")
    j_spec, t_spec = specs(layers=2)
    rng = np.random.default_rng(5)
    a, b = layer_np(rng), layer_np(rng)
    stacked = {k: np.stack([a[k], b[k]]) for k in a}
    jm = JaxManager(num_layers=2, num_pages=64, page_size=PS, n_kv_heads=4,
                    head_dim=64, dtype=jnp.float32)
    tm = CacheManager(2, 64, PS, 4, 64, dtype=torch.float32, device="cpu")
    jex = JaxExecutor(stacked, j_spec, jm, compute_dtype=jnp.float32)
    tex = SpanExecutor(t_block.params_from_jax(stacked, device="cpu"),
                       t_spec, tm, compute_dtype=torch.float32, device="cpu")
    h = rng.standard_normal((4, 40, 256)).astype(np.float32)
    routes = count_routes(monkeypatch)
    plain = t_paged.paged_ragged_attention_reference

    def counted(*a, **kw):
        routes["ragged"] = routes.get("ragged", 0) + 1
        return plain(*a, **kw)

    monkeypatch.setattr(t_paged, "paged_ragged_attention_reference", counted)
    want = drive_executor(jm, jex, h)
    got = drive_executor(tm, tex, h)
    for g, w in zip(got, want, strict=True):
        np.testing.assert_allclose(g, w, atol=EPS, rtol=EPS)
    assert not (tex.paged_supported or tex.flash_supported)
    assert routes == {}


# ------------------------------------------------------------------ head
def test_head_with_embedding_layernorm_matches_jax():
    rng = np.random.default_rng(6)
    embed = (0.1 * rng.standard_normal((96, 64))).astype(np.float32)
    client = {"embed": embed, "lm_head": embed.T.copy(),
              "embed_norm": 1 + 0.1 * rng.standard_normal(64),
              "embed_norm_bias": 0.1 * rng.standard_normal(64),
              "norm": 1 + 0.1 * rng.standard_normal(64),
              "norm_bias": 0.1 * rng.standard_normal(64)}
    client = {k: np.asarray(v, np.float32) for k, v in client.items()}
    ids = rng.integers(0, 96, (2, 5))
    hidden = rng.standard_normal((2, 3, 64)).astype(np.float32)
    tc = {k: torch.from_numpy(v) for k, v in client.items()}
    jc = {k: jnp.asarray(v) for k, v in client.items()}
    # bf16 tables: the f32 statistics may round to a neighbouring bf16
    for dt, jdt, tol in ((torch.float32, jnp.float32, EPS),
                         (torch.bfloat16, jnp.bfloat16, 2**-7)):
        got = t_head.embed_impl({k: v.to(dt) for k, v in tc.items()},
                                torch.from_numpy(ids), 1.0, True, 1e-5)
        want = j_head.embed_impl({k: v.astype(jdt) for k, v in jc.items()},
                                 jnp.asarray(ids), 1.0, True, 1e-5)
        assert got.dtype == dt
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32), atol=tol,
                                   rtol=tol)
    plain = t_head.embed_impl(tc, torch.from_numpy(ids))
    assert (plain - got.float()).abs().max() > 0.5  # the norm bites
    want = np.asarray(j_head.norm_head_impl(jc, jnp.asarray(hidden), 1e-5,
                                            0.0, "ln"))
    got = t_head.norm_head_impl(tc, torch.from_numpy(hidden), 1e-5, 0.0,
                                "ln")
    np.testing.assert_allclose(got.numpy(), want, atol=EPS, rtol=EPS)
    got = t_head.norm_head_chunked(tc, torch.from_numpy(hidden), 1e-5, 0.0,
                                   "ln", step=40)
    want_c = np.asarray(j_head_chunked(jc, jnp.asarray(hidden), 1e-5, 0.0,
                                       "ln", step=40))
    np.testing.assert_allclose(got.numpy(), want_c, atol=EPS, rtol=EPS)
    rms = t_head.norm_head_impl(tc, torch.from_numpy(hidden), 1e-5)
    assert (rms - got).abs().max() > 1e-2  # LayerNorm, not RMSNorm


# --------------------------------------------------------------- weights
@pytest.fixture(scope="module")
def bloom_dir(tmp_path_factory):
    """(model dir, HF model, HF config): the tiny HF Bloom with its biases
    and LayerNorm parameters re-drawn (HF inits them to 0 and 1) so they
    bite."""
    from transformers import BloomForCausalLM

    config = hf_config()
    torch.manual_seed(0)
    model = BloomForCausalLM(config).eval().to(torch.float32)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("bias"):
                p.normal_(0.0, 0.1)
            elif "layernorm" in name or "ln_f" in name:
                p.normal_(1.0, 0.1)
    d = tmp_path_factory.mktemp("tiny_bloom")
    model.save_pretrained(d, safe_serialization=True)
    return str(d), model, config


def test_loaders_match_jax_and_hf(bloom_dir, tmp_path):
    """The port's loaders on HF's own checkpoint give the JAX loaders'
    tensors exactly (carried with `params_from_jax` /
    `client_params_from_jax`), q/k/v are HF's fused rows per head, the head
    is a view of the embedding; the hub's prefix-free names load the
    same."""
    from safetensors.torch import save_file

    d, hf, config = bloom_dir
    layers, spec = t_ckpt.load_span_params(d, 0, 2, device="cpu")
    client = t_ckpt.load_client_params(d, device="cpu")
    assert spec == t_ckpt.load_spec(d) and spec.family == "bloom"
    assert set(client) == {"embed", "norm", "lm_head",
                           *auto.get_family("bloom").client_extras}
    sd = hf.state_dict()
    fused = sd["transformer.h.1.self_attention.query_key_value.weight"]
    per_head = fused.reshape(4, 3, 64, 256)
    torch.testing.assert_close(layers[1]["k_proj"],
                               per_head[:, 1].reshape(256, 256).t(),
                               atol=0, rtol=0)
    assert client["lm_head"].data_ptr() == client["embed"].data_ptr()
    torch.testing.assert_close(client["embed_norm_bias"], sd[
        "transformer.word_embeddings_layernorm.bias"], atol=0, rtol=0)

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
    assert set(carried) == set(client)
    for k in client:
        torch.testing.assert_close(carried[k], client[k], atol=0, rtol=0)

    shutil.copy(f"{d}/config.json", tmp_path / "config.json")
    save_file({k.removeprefix("transformer."): v.contiguous()
               for k, v in sd.items() if k.startswith("transformer.")},
              str(tmp_path / "model.safetensors"))
    bare, _ = t_ckpt.load_span_params(str(tmp_path), 0, 2, device="cpu")
    bare_client = t_ckpt.load_client_params(str(tmp_path), device="cpu")
    for g, w in zip(bare + [bare_client], layers + [client], strict=True):
        assert set(g) == set(w)
        for k in w:
            torch.testing.assert_close(g[k], w[k], atol=0, rtol=0)


# ------------------------------------------------------------ full chain
@pytest.fixture(scope="module")
def chain(loop, bloom_dir, registry):
    """Two port servers ([0, 1), [1, 2)) under uid "bloom", built from the
    directory with the kernel routes' threshold at 0."""
    d = bloom_dir[0]
    servers = [kernel_route_server(d, registry.port, UID, 0, 1),
               kernel_route_server(d, registry.port, UID, 1, 2)]
    run(loop, start_all(*servers))
    yield servers
    run(loop, stop_all(*servers))


def hf_greedy(model, input_ids, max_new_tokens):
    """HF greedy tokens with an explicit mask and no EOS stop."""
    x = torch.tensor(input_ids)
    with torch.no_grad():
        return model.generate(
            x, attention_mask=torch.ones_like(x),
            max_new_tokens=max_new_tokens, do_sample=False, use_cache=True,
            eos_token_id=None, pad_token_id=0,
        ).numpy()


def test_full_chain_logits_match_hf(loop, bloom_dir, registry, chain):
    d, hf, config = bloom_dir
    model = port_client(d, registry.port, UID)
    assert model.spec.family == "bloom" and "embed_norm" in model.params
    input_ids = prompt_ids(config, b=1)

    async def go():
        async with model.inference_session(16, 1) as sess:
            return model.logits(await sess.step(model.embed(input_ids)))

    got = run(loop, go())
    np.testing.assert_allclose(got.numpy(), hf_logits(hf, input_ids),
                               atol=2e-3, rtol=2e-3)


def test_full_chain_greedy_matches_hf_and_jax_client(loop, bloom_dir,
                                                     registry, chain):
    """Greedy tokens through the port chain, by the port client and by the
    JAX client, equal HF's; the servers stayed off every kernel route."""
    d, hf, config = bloom_dir
    input_ids = prompt_ids(config, seed=1)
    model = port_client(d, registry.port, UID)
    got = run(loop, model.generate(input_ids, max_new_tokens=8)).numpy()
    want = run(loop, jax_client(d, registry.port, UID).generate(
        input_ids, max_new_tokens=8
    ))
    np.testing.assert_array_equal(got, hf_greedy(hf, input_ids, 8))
    np.testing.assert_array_equal(np.asarray(want), got)
    assert not any(s.executor.paged_supported or s.executor.flash_supported
                   for s in chain)


def test_server_decode_matches_per_step(loop, bloom_dir, registry):
    """One whole-model port server (the fused decode loop: the embedding
    LayerNorm and the LayerNorm head): `generate(server_decode=True)` gives
    per-step `generate`'s tokens and HF's."""
    d, hf, config = bloom_dir
    uid = "bloom-dn"
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


def test_run_server_builds_and_warms_a_bloom_span(bloom_dir, monkeypatch):
    """`run_server.main` takes the directory through the registry, loads
    the span, runs the warmup (a decode step and the checkpoint's client
    parameters through Bloom's client loader) and reaches start."""
    d, hf, _ = bloom_dir
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
        server._client_params["norm_bias"],
        hf.state_dict()["transformer.ln_f.bias"], atol=0, rtol=0,
    )


def test_bloom_refused_as_a_local_drafter(bloom_dir):
    d = bloom_dir[0]
    with pytest.raises(NotImplementedError, match="ALiBi"):
        LocalDraftModel.from_dir(d, device="cpu")
    with pytest.raises(NotImplementedError, match="ALiBi"):
        LocalJaxDraftModel.from_dir(d)

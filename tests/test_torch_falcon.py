"""The port's Falcon family on the CPU, against HF and the JAX package.

- Registry: the port's spec of tests/test_families.py's tiny "falcon" and
  "falcon40b" HF configs and of the published Falcon-7B, 40B and 180B
  configs equals the JAX spec field for field; falcon-rw (ALiBi, biases)
  is refused by both with the same words.
- Weights: `init_block_params` draws no post-attention norm for a parallel
  spec and puts `mlp_layernorm` and its bias after the other keys.
- Per layer (f32, within 1e-5, weights from one numpy seed): `layer_body`
  on every route (dense, flash, paged decode, paged chunk, tree; the
  kernels' plain versions here, each counted) and `layer_body_ragged` on
  its dense and kernel routes, against the JAX functions, for one
  LayerNorm at group 71 (Falcon-7B's heads) and two at group 16
  (Falcon-40B's), at a narrow width. The parallel residual changes the
  output.
- Planners: at groups 3, 16, 29 and 71 the chunk kernel's units (row
  tiles x head tiles) and the ragged kernel's (segments x head tiles)
  cover every (row, query head) exactly once with at most RAGGED_ROWS
  query rows a unit, their scratch rows and counters are their own, and
  the plans' grids hold them.
- Plain versions at groups 29 and 71 against the Pallas kernels in
  interpret mode: flash, decode, int4 decode, chunk (causal and tree),
  ragged (causal and tree).
- Loaders: on checkpoints saved by HF's `FalconForCausalLM` (multi-query
  and the new decoder architecture's grouped QKV with two LayerNorms),
  the port's loaders give the JAX loaders' tensors exactly.
- Full chain, for a tiny multi-query Falcon (3 heads of 64 over one KV
  head) and a tiny new-architecture one (4 heads of 64 over 2): two port
  servers built from the directory with BBTPU_PAGED_MIN_CONTEXT=0 (the
  kernels' plain versions), read by the port client: logits within 2e-3
  of HF's; greedy tokens equal to HF's through the port client and
  through the JAX client; `generate(server_decode=True)` equals per-step
  `generate`; `run_server.main` builds a Falcon span; a tiny Falcon
  drafts for itself locally.

The loop, registry and server helpers are tests/test_torch_server.py's;
every networked call here is bounded at 60 s.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bloombee_tpu.kv import quant as j_quant
from bloombee_tpu.models import auto as j_auto
from bloombee_tpu.models import checkpoint as j_ckpt
from bloombee_tpu.models.spec import ModelSpec as JaxSpec
from bloombee_tpu.ops.pallas.flash_attention import (
    flash_attention as j_flash,
)
from bloombee_tpu.ops.pallas.paged_attention import (
    paged_chunk_attention as j_chunk,
    paged_decode_attention as j_decode,
    paged_decode_attention_int4 as j_int4,
    paged_ragged_attention as j_ragged,
)
from bloombee_tpu.ops.rotary import rotary_cos_sin as j_rope
from bloombee_tpu_torch.cli import run_server
from bloombee_tpu_torch.client import ClientConfig, DistributedModelForCausalLM
from bloombee_tpu_torch.client.speculative import generate_speculative
from bloombee_tpu_torch.kv import quant as t_quant
from bloombee_tpu_torch.kv.arena import write_plan
from bloombee_tpu_torch.models import auto
from bloombee_tpu_torch.models import checkpoint as t_ckpt
from bloombee_tpu_torch.models import head as t_head
from bloombee_tpu_torch.models.llama import block as t_block
from bloombee_tpu_torch.models.spec import ModelSpec
from bloombee_tpu_torch.ops.cuda import flash_attention as t_flash
from bloombee_tpu_torch.ops.cuda import paged_attention as t_paged
from bloombee_tpu_torch.ops.rotary import rotary_cos_sin as t_rope
from bloombee_tpu_torch.runtime import layer_body as t_body
from bloombee_tpu_torch.server.block_server import BlockServer
from bloombee_tpu_torch.spec.drafter import GreedyTreeDrafter, LocalDraftModel
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
j_quantize = jax.jit(j_quant.quantize)


# ---------------------------------------------------------------- configs
def hf_config(case):
    """Tiny HF Falcon configs: tests/test_families.py's "falcon" (4 heads
    of 16 over one KV head) and "falcon40b" (4 over 2, the new decoder
    architecture), and the full chain's, heads of 64 (the CUDA kernels'
    domain): "mq" 3 heads over one KV head (group 3), "new" 4 over 2."""
    import transformers as tf

    common = dict(num_hidden_layers=2, vocab_size=128, bias=False,
                  alibi=False, layer_norm_epsilon=1e-5)
    return {
        "falcon": lambda: tf.FalconConfig(
            hidden_size=64, num_attention_heads=4, multi_query=True,
            parallel_attn=True, new_decoder_architecture=False, **common),
        "falcon40b": lambda: tf.FalconConfig(
            hidden_size=64, num_attention_heads=4, num_kv_heads=2,
            new_decoder_architecture=True, **common),
        "mq": lambda: tf.FalconConfig(
            hidden_size=192, num_attention_heads=3, multi_query=True,
            parallel_attn=True, new_decoder_architecture=False, **common),
        "new": lambda: tf.FalconConfig(
            hidden_size=256, num_attention_heads=4, num_kv_heads=2,
            new_decoder_architecture=True, **common),
    }[case]()


# the published configs (config.json of tiiuae/falcon-7b, falcon-40b and
# falcon-180B), the fields both packages read
PUBLISHED = {
    "falcon-7b": {"model_type": "falcon", "hidden_size": 4544,
                  "num_attention_heads": 71, "num_hidden_layers": 32,
                  "vocab_size": 65024, "multi_query": True,
                  "parallel_attn": True, "new_decoder_architecture": False,
                  "bias": False, "alibi": False,
                  "layer_norm_epsilon": 1e-5},
    "falcon-40b": {"model_type": "falcon", "hidden_size": 8192,
                   "num_attention_heads": 128, "num_kv_heads": 8,
                   "num_hidden_layers": 60, "vocab_size": 65024,
                   "parallel_attn": True, "new_decoder_architecture": True,
                   "bias": False, "alibi": False,
                   "layer_norm_epsilon": 1e-5},
    "falcon-180b": {"model_type": "falcon", "hidden_size": 14848,
                    "num_attention_heads": 232, "num_kv_heads": 8,
                    "num_hidden_layers": 80, "vocab_size": 65024,
                    "parallel_attn": True, "new_decoder_architecture": True,
                    "bias": False, "alibi": False,
                    "layer_norm_epsilon": 1e-5},
}


@pytest.mark.parametrize("name", ["falcon", "falcon40b", *PUBLISHED])
def test_spec_matches_jax(name):
    if name in PUBLISHED:
        config = PUBLISHED[name]
    else:
        hf = hf_config(name)
        config = hf.to_dict()
        assert dataclasses.asdict(auto.spec_from_hf_config(hf)) == \
            dataclasses.asdict(j_auto.spec_from_hf_config(hf))
    got = auto.spec_from_config_dict(config)
    want = j_auto.spec_from_config_dict(config)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.parallel_attn and got.norm_type == "ln" and \
        got.mlp_type == "gelu" and not got.alibi
    two = config.get("new_decoder_architecture", False)
    assert got.num_ln_in_parallel_attn == (2 if two else 1)
    assert t_body.unsupported(got) is None
    assert "falcon" not in auto.UNPORTED
    if name == "falcon-7b":
        assert (got.num_attention_heads, got.num_key_value_heads,
                got.head_dim) == (71, 1, 64)


def test_falcon_rw_refused_by_both():
    config = {**PUBLISHED["falcon-7b"], "alibi": True, "bias": True,
              "multi_query": False, "parallel_attn": False}
    for registry_ in (auto, j_auto):
        with pytest.raises(NotImplementedError, match="falcon-rw"):
            registry_.spec_from_config_dict(config)


# ------------------------------------------------------------- per layer
# case -> (heads, KV heads, norms): Falcon-7B's group 71 with one
# LayerNorm, Falcon-40B's group 16 with two, heads of 64 at width 128
LAYER_CASES = {"one-norm-g71": (71, 1, 1), "two-norm-g16": (32, 2, 2)}


def specs(case, layers=1):
    h, hkv, n_ln = LAYER_CASES[case]
    kw = dict(family="falcon", hidden_size=128, intermediate_size=512,
              num_attention_heads=h, num_key_value_heads=hkv, head_dim=64,
              num_hidden_layers=layers, vocab_size=128, rms_norm_eps=1e-5,
              tie_word_embeddings=True, norm_type="ln", mlp_type="gelu",
              parallel_attn=True, num_ln_in_parallel_attn=n_ln)
    return JaxSpec(**kw), ModelSpec(**kw)


def layer_np(case, rng):
    """One Falcon layer's JAX-layout params from numpy: LayerNorms near 1
    with biases, bias-free projections, no gate."""
    spec, _ = specs(case)
    d, i = spec.hidden_size, spec.intermediate_size
    q = spec.num_attention_heads * spec.head_dim
    kv = spec.num_key_value_heads * spec.head_dim
    shapes = {"input_layernorm": (d,), "input_layernorm_bias": (d,),
              "q_proj": (d, q), "k_proj": (d, kv), "v_proj": (d, kv),
              "o_proj": (q, d), "up_proj": (d, i), "down_proj": (i, d)}
    if spec.num_ln_in_parallel_attn == 2:
        shapes.update(mlp_layernorm=(d,), mlp_layernorm_bias=(d,))
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
def layers():
    rng = np.random.default_rng(0)
    return {case: layer_np(case, rng) for case in LAYER_CASES}


def test_init_block_params_makes_the_falcon_norms():
    """A parallel spec draws no post-attention norm, and the LayerNorm
    biases (and the MLP's norm of a two-norm spec) come after the other
    keys: the same seed gives a Llama-structured spec's projections."""
    for case in LAYER_CASES:
        _, spec = specs(case)
        got = t_block.init_block_params(torch.Generator().manual_seed(3),
                                        spec, device="cpu")
        assert set(got) == set(layer_np(case, np.random.default_rng(0)))
        base = t_block.init_block_params(
            torch.Generator().manual_seed(3),
            dataclasses.replace(spec, norm_type="rms", parallel_attn=False,
                                num_ln_in_parallel_attn=0),
            device="cpu",
        )
        for k in set(got) & set(base):
            torch.testing.assert_close(got[k], base[k], atol=0, rtol=0)


# route -> (step tokens, use_paged, use_flash, tree, the plain version)
ROUTES = {
    "dense": (5, False, False, False, None),
    "flash": (7, False, True, False, "flash_attention_reference"),
    "paged-decode": (1, True, False, False,
                     "paged_decode_attention_reference"),
    "paged-chunk": (5, True, False, False,
                    "paged_chunk_attention_reference"),
    "paged-tree": (5, True, False, True, "paged_chunk_attention_reference"),
}


def port_layer(spec, params, inputs, **route):
    k, v, table, pos, slots, hidden, lens, tm = inputs
    tk, tv = torch.from_numpy(k.copy()), torch.from_numpy(v.copy())
    out = t_body.layer_body(
        spec, PS, torch.from_numpy(hidden), params, tk, tv,
        *t_rope(torch.from_numpy(pos), spec.head_dim, spec.rope_theta),
        write_plan(slots, PAGES * PS, "cpu"), torch.from_numpy(table),
        torch.from_numpy(pos), torch.from_numpy(lens),
        None if tm is None else torch.from_numpy(tm), 0,
        t_real=hidden.shape[1], **route,
    )
    return out, tk, tv


@pytest.mark.parametrize("case", list(LAYER_CASES))
@pytest.mark.parametrize("route", list(ROUTES))
def test_layer_body_matches_jax(layers, monkeypatch, case, route):
    t, use_paged, use_flash, tree, plain = ROUTES[route]
    j_spec, t_spec = specs(case)
    rng = np.random.default_rng(1)
    k, v, table, pos, slots, hidden, lens = arena_and_steps(j_spec, t, rng)
    tm = tree_mask(t) if tree else None
    if tree:  # tree depths are the rotary positions of a tree step
        pos = (lens - t)[:, None] + (tm[0].sum(-1) - 1)[None].astype(
            np.int32)
    if use_flash:  # a prefill from position 0
        pos = np.broadcast_to(np.arange(t), (2, t)).astype(np.int32)
        slots = (table[np.arange(2)[:, None], pos // PS] * PS
                 + pos % PS).reshape(-1).astype(np.int32)
        lens = np.full(2, t, np.int32)
    want, wk, wv = j_layer_body(
        j_spec, PS, jnp.asarray(hidden),
        jax.tree.map(jnp.asarray, layers[case]), jnp.asarray(k),
        jnp.asarray(v),
        *j_rope(jnp.asarray(pos), j_spec.head_dim, j_spec.rope_theta),
        jnp.asarray(slots), jnp.asarray(table), jnp.asarray(pos),
        jnp.asarray(lens), None if tm is None else jnp.asarray(tm), 0,
    )
    (params,) = t_block.params_from_jax([layers[case]], device="cpu")
    routes = count_routes(monkeypatch)
    got, tk, tv = port_layer(
        t_spec, params, (k, v, table, pos, slots, hidden, lens, tm),
        use_paged=use_paged, use_flash=use_flash,
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=EPS,
                               rtol=EPS)
    np.testing.assert_allclose(tk.numpy(), np.asarray(wk), atol=EPS, rtol=0)
    np.testing.assert_allclose(tv.numpy(), np.asarray(wv), atol=EPS, rtol=0)
    if plain is None:
        assert routes == {}
    else:
        assert routes.get(plain) == 1


def test_parallel_residual_bites(layers):
    """Falcon's tail differs from the sequential Llama/Bloom one (the MLP
    reads the layer's input, not hidden + attn), and the MLP's own norm of
    a two-norm layer is used."""
    _, spec = specs("two-norm-g16")
    (params,) = t_block.params_from_jax([layers["two-norm-g16"]],
                                        device="cpu")
    rng = np.random.default_rng(3)
    hidden = torch.from_numpy(rng.standard_normal((2, 3, 128)).astype(
        np.float32))
    attn = torch.from_numpy(rng.standard_normal((2, 3, 128)).astype(
        np.float32))
    x = t_block.norm(hidden, params, "input_layernorm", spec)
    got = t_block.finish_layer(params, spec, hidden, x, attn)
    one = t_block.finish_layer(
        params, dataclasses.replace(spec, num_ln_in_parallel_attn=1),
        hidden, x, attn)
    assert (got - one).abs().max() > 1e-2
    sequential = dict(params, post_attention_layernorm=params[
        "mlp_layernorm"], post_attention_layernorm_bias=params[
        "mlp_layernorm_bias"])
    seq = t_block.finish_layer(
        sequential, dataclasses.replace(spec, parallel_attn=False), hidden,
        x, attn)
    assert (got - seq).abs().max() > 1e-2


@pytest.mark.parametrize("case", list(LAYER_CASES))
@pytest.mark.parametrize("use_kernel", [False, True],
                         ids=["dense", "kernel"])
def test_layer_body_ragged_matches_jax(layers, monkeypatch, case,
                                       use_kernel):
    """A ragged step: sequence 0's decode row, sequence 1's 4-token chunk
    and 3 padding rows (slots out of the arena)."""
    j_spec, t_spec = specs(case)
    rng = np.random.default_rng(2)
    k, v, table, _, _, _, _ = arena_and_steps(j_spec, 1, rng)
    r_real, rb = 5, 8
    q_seq = np.asarray([0, 1, 1, 1, 1, 2, 2, 2], np.int32)
    q_pos = np.asarray([PAST[0]] + [PAST[1] + i for i in range(4)]
                       + [0] * 3, np.int32)
    slots = table[np.minimum(q_seq, 1), q_pos // PS] * PS + q_pos % PS
    slots[r_real:] = PAGES * PS  # padding rows: dropped
    lens = np.asarray([PAST[0] + 1, PAST[1] + 4], np.int32)
    hidden = rng.standard_normal((1, rb, j_spec.hidden_size)).astype(
        np.float32)
    want, wk, _ = j_layer_body_ragged(
        j_spec, PS, jnp.asarray(hidden),
        jax.tree.map(jnp.asarray, layers[case]), jnp.asarray(k),
        jnp.asarray(v),
        *j_rope(jnp.asarray(q_pos[None]), j_spec.head_dim,
                j_spec.rope_theta),
        jnp.asarray(slots.astype(np.int32)), jnp.asarray(table),
        jnp.asarray(q_pos[None]), jnp.asarray(lens), jnp.asarray(q_seq), 0,
    )
    (params,) = t_block.params_from_jax([layers[case]], device="cpu")
    calls = []
    plain = t_paged.paged_ragged_attention_reference

    def counted(*a, **kw):
        calls.append(1)
        return plain(*a, **kw)

    monkeypatch.setattr(t_paged, "paged_ragged_attention_reference", counted)
    tk, tv = torch.from_numpy(k.copy()), torch.from_numpy(v.copy())
    got = t_body.layer_body_ragged(
        t_spec, PS, torch.from_numpy(hidden), params, tk, tv,
        *t_rope(torch.from_numpy(q_pos[None]), t_spec.head_dim,
                t_spec.rope_theta),
        write_plan(slots, PAGES * PS, "cpu"), torch.from_numpy(table),
        torch.from_numpy(q_pos[None]), torch.from_numpy(lens),
        torch.from_numpy(q_seq), 0, use_kernel=use_kernel,
    )
    np.testing.assert_allclose(got[0, :r_real].numpy(),
                               np.asarray(want)[0, :r_real], atol=EPS,
                               rtol=EPS)
    np.testing.assert_allclose(tk.numpy(), np.asarray(wk), atol=EPS, rtol=0)
    assert len(calls) == int(use_kernel)


# -------------------------------------------------------------- planners
GROUPS = (3, 16, 29, 71)


def chunk_units(b, t, hkv, g):
    """The chunk kernel's units as its grid lays them out (blockIdx.y the
    head tile of a KV head, blockIdx.z the (sequence, row tile)): (first
    token row, tokens, first query head, heads) per unit."""
    heads, width = t_paged.head_tiles(g)
    tr = t_paged.RAGGED_ROWS // width
    _, tiles = t_paged.chunk_split(b, t, hkv, g, 64)
    units = []
    for y in range(hkv * heads):
        kvh, off = y // heads, y % heads * width
        w = min(width, g - off)
        for z in range(b * tiles):
            t0 = z % tiles * tr
            rows = min(tr, t - t0)
            units.append((z // tiles * t + t0, rows, kvh * g + off, w))
    return units


@pytest.mark.parametrize("g", GROUPS)
def test_chunk_units_cover_every_row_and_head_once(g):
    b, t, hkv = 2, 40, 2
    units = chunk_units(b, t, hkv, g)
    seen = np.zeros((b * t, hkv * g), np.int64)
    for row, rows, head, w in units:
        assert 0 < rows * w <= t_paged.RAGGED_ROWS
        seen[row:row + rows, head:head + w] += 1
    assert (seen == 1).all()
    chunks, tiles = t_paged.chunk_split(b, t, hkv, g, 64)
    heads = t_paged.head_tiles(g)[0]
    assert len(units) == b * tiles * hkv * heads
    assert 1 <= chunks <= t_paged.CHUNK_CLUSTER
    assert len(units) * chunks <= max(t_paged.CHUNK_CTAS, len(units))


def ragged_segments(q_seq, b, tr):
    """The ragged kernel's segments (first row, rows): a segment starts at
    every multiple of tr rows and wherever the owner changes (padding rows
    count as one owner)."""
    owner = [s if s < b else -1 for s in q_seq]
    starts = [i for i in range(len(q_seq))
              if i % tr == 0 or owner[i] != owner[i - 1]]
    ends = starts[1:] + [len(q_seq)]
    return [(s, e - s) for s, e in zip(starts, ends)]


@pytest.mark.parametrize("g", GROUPS)
def test_ragged_units_cover_every_row_and_head_once(g):
    """Decode rows, a 37-row chunk, a 1-row member and padding rows: every
    (row, query head) in one unit of at most RAGGED_ROWS query rows; each
    unit's scratch rows (R*g rows a KV head and chunk) contiguous and its
    own, its counter (first row x head tiles) its own; the planned grid
    holds every segment of the executor's packing."""
    b, hkv = 5, 2
    q_seq = [0, 1, 2] + [3] * 37 + [4] + [9] * 7
    r = len(q_seq)
    heads, width = t_paged.head_tiles(g)
    tr = t_paged.RAGGED_ROWS // width
    segs = ragged_segments(q_seq, b, tr)
    _, chunks, grid = t_paged.ragged_split(64, 16, r, hkv, g, b)
    assert len(segs) <= grid and 1 <= chunks <= t_paged.RAGGED_MAX_CHUNKS
    seen = np.zeros((r, hkv * g), np.int64)
    scratch = np.zeros((hkv, r * g), np.int64)
    counters = set()
    for i0, rows in segs:
        for y in range(hkv * heads):
            kvh, off = y // heads, y % heads * width
            w = min(width, g - off)
            assert 0 < rows * w <= t_paged.RAGGED_ROWS
            assert heads == 1 or rows == 1  # contiguous scratch rows
            seen[i0:i0 + rows, kvh * g + off:kvh * g + off + w] += 1
            u0 = i0 * g + off
            for qr in range(rows * w):  # scratch row of query row qr
                at = (i0 + qr // w) * g + off + qr % w
                assert at == u0 + qr
                scratch[kvh, at] += 1
            counters.add(i0 * hkv * heads + y)
    assert (seen == 1).all() and (scratch == 1).all()
    assert len(counters) == len(segs) * hkv * heads
    assert max(counters) < r * hkv * heads  # the pool's size


@pytest.mark.parametrize("g", GROUPS)
def test_decode_tiles_cover_the_group(g):
    tiles, width = t_paged.decode_tiles(g)
    assert tiles * width >= g > (tiles - 1) * width
    chunk, chunks = t_paged.decode_split(64, 16, 2, 2, g)
    assert 2 * 2 * tiles * chunks <= max(t_paged.SPLIT_CTAS, 2 * 2 * tiles)


# ------------------------------------------------- plain vs Pallas at g
@pytest.mark.parametrize("h", [29, 71], ids=["g29", "g71"])
def test_plain_versions_match_pallas_at_wide_groups(h):
    """One KV head under 29 or 71 query heads (Falcon-180B's and
    Falcon-7B's groups), hd 64, f32, within 1e-5: flash (causal, mixed
    starts/lens), decode and int4 decode with a window and a lens=0 row,
    chunk (follow-up with t_real < T, and a tree), ragged (causal mix
    with padding rows, and trees)."""
    rng = np.random.default_rng(h)
    hd, ps = 64, 16

    def rand(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    def close(got, want):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=EPS, rtol=EPS)

    def both(*xs):
        return [jnp.asarray(x) for x in xs], [torch.from_numpy(x)
                                             for x in xs]

    q, k, v = rand(2, 32, h, hd), rand(2, 48, 1, hd), rand(2, 48, 1, hd)
    starts, lens = np.array([16, 0], np.int32), np.array([48, 20], np.int32)
    (jq, jk, jv, js, jl), tx = both(q, k, v, starts, lens)
    close(t_flash.flash_attention_reference(*tx[:3], True, None, *tx[3:]),
          j_flash(jq, jk, jv, causal=True, block_q=32, block_k=16,
                  interpret=True, starts=js, lens=jl))

    ks, vs = rand(12 * ps, 1, hd), rand(12 * ps, 1, hd)
    pt = np.array([[7, 2, 9, 0], [1, 4, 5, 8], [11, 3, 6, 10]], np.int32)
    lens = np.array([55, 33, 0], np.int32)
    qd = rand(3, h, hd)
    (jq, jks, jvs, jpt, jl), tx = both(qd, ks, vs, pt, lens)
    close(t_paged.paged_decode_attention_reference(*tx, ps, window=20),
          j_decode(jq, jks, jvs, jpt, jl, page_size=ps, interpret=True,
                   window=20))
    jkq, jvq = j_quantize(jks), j_quantize(jvs)
    got = t_paged.paged_decode_attention_int4_reference(
        tx[0], t_quant.quantize(tx[1]), t_quant.quantize(tx[2]), *tx[3:],
        ps, window=20)
    close(got, j_int4(jq, jkq, jvq, jpt, jl, page_size=ps, interpret=True,
                      window=20))
    assert not got[2].any()

    qc = rand(3, 8, h, hd)
    lens = np.array([55, 8, 40], np.int32)
    (jq, jks, jvs, jpt, jl), tx = both(qc, ks, vs, pt, lens)
    close(t_paged.paged_chunk_attention_reference(*tx, ps, t_real=6),
          j_chunk(jq, jks, jvs, jpt, jl, page_size=ps, interpret=True,
                  t_real=6))
    tm = tree_mask(5)[:1].repeat(3, 0)
    tm = np.pad(tm, ((0, 0), (0, 3), (0, 3)))
    tm[:, 5:, 5:] = np.eye(3, dtype=bool)
    close(t_paged.paged_chunk_attention_reference(
              *tx, ps, tree_mask=torch.from_numpy(tm)),
          j_chunk(jq, jks, jvs, jpt, jl, page_size=ps,
                  tree_mask=jnp.asarray(tm), interpret=True, has_tree=True))

    q_seq = np.array([0, 0, 0, 1, 2, 3, 3], np.int32)
    q_pos = np.array([52, 53, 54, 32, 0, 0, 0], np.int32)
    lens = np.array([55, 33, 0], np.int32)
    qr = rand(7, h, hd)
    (jq, jks, jvs, jpt, jl, jqs, jqp), tx = both(qr, ks, vs, pt, lens,
                                                q_seq, q_pos)
    close(t_paged.paged_ragged_attention_reference(*tx, ps, window=10)[:5],
          np.asarray(j_ragged(jq, jks, jvs, jpt, jl, jqs, jqp, page_size=ps,
                              interpret=True, window=10))[:5])
    nt = np.array([3, 1, 0], np.int32)
    tree_rows = np.zeros((7, 3), np.int32)
    tree_rows[:3] = np.tril(np.ones((3, 3), np.int32))
    tree_rows[3, 0] = 1
    kw_t = dict(nt=torch.from_numpy(nt), tree_rows=torch.from_numpy(
        tree_rows))
    close(t_paged.paged_ragged_attention_reference(*tx, ps, **kw_t)[:4],
          np.asarray(j_ragged(jq, jks, jvs, jpt, jl, jqs, jqp, page_size=ps,
                              interpret=True, nt=jnp.asarray(nt),
                              tree_rows=jnp.asarray(tree_rows),
                              has_tree=True))[:4])


# --------------------------------------------------------------- weights
def hf_falcon(case):
    """A tiny HF Falcon with its LayerNorm parameters re-drawn (HF inits
    them to 1 and 0) so that they bite."""
    from transformers import FalconForCausalLM

    torch.manual_seed(0)
    model = FalconForCausalLM(hf_config(case)).eval().to(torch.float32)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("bias"):
                p.normal_(0.0, 0.1)
            elif "ln" in name or "layernorm" in name:
                p.normal_(1.0, 0.1)
    return model


@pytest.fixture(scope="module")
def falcon_dirs(tmp_path_factory):
    """case -> (model dir, HF model, HF config) for the chain's two tiny
    Falcons."""
    out = {}
    for case in ("mq", "new"):
        model = hf_falcon(case)
        d = tmp_path_factory.mktemp(f"tiny_falcon_{case}")
        model.save_pretrained(d, safe_serialization=True)
        out[case] = (str(d), model, model.config)
    return out


@pytest.mark.parametrize("case", ["mq", "new"])
def test_loaders_match_jax_and_hf(falcon_dirs, case):
    """The port's loaders on HF's own checkpoint give the JAX loaders'
    tensors exactly; q/k/v are HF's fused rows in their layout; the head
    is the embedding's transpose."""
    d, hf, config = falcon_dirs[case]
    layers, spec = t_ckpt.load_span_params(d, 0, 2, device="cpu")
    client = t_ckpt.load_client_params(d, device="cpu")
    assert spec == t_ckpt.load_spec(d) and spec.family == "falcon"
    assert set(client) == {"embed", "norm", "lm_head",
                           *auto.get_family("falcon").client_extras}
    sd = hf.state_dict()
    fused = sd["transformer.h.1.self_attention.query_key_value.weight"]
    h, hd = config.num_attention_heads, 64
    if case == "mq":  # [H q | 1 k | 1 v]
        want_k = fused[h * hd:(h + 1) * hd]
        assert "mlp_layernorm" not in layers[1]
    else:  # per KV group [2 q | 1 k | 1 v]
        want_k = fused.reshape(2, 4, hd, -1)[:, 2].reshape(2 * hd, -1)
        torch.testing.assert_close(layers[1]["mlp_layernorm_bias"],
                                   sd["transformer.h.1.ln_mlp.bias"],
                                   atol=0, rtol=0)
    torch.testing.assert_close(layers[1]["k_proj"], want_k.t(), atol=0,
                               rtol=0)
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
        jax.tree.map(np.asarray, j_client), device="cpu")
    assert set(carried) == set(client)
    for k in client:
        torch.testing.assert_close(carried[k], client[k], atol=0, rtol=0)


# ------------------------------------------------------------ full chain
@pytest.fixture(scope="module")
def chains(loop, falcon_dirs, registry):
    """Per case: two port servers ([0, 1), [1, 2)) under uid
    "falcon-<case>", the kernel routes' threshold at 0."""
    servers = []
    for case, (d, _, _) in falcon_dirs.items():
        servers += [kernel_route_server(d, registry.port, f"falcon-{case}",
                                        0, 1),
                    kernel_route_server(d, registry.port, f"falcon-{case}",
                                        1, 2)]
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


@pytest.mark.parametrize("case", ["mq", "new"])
def test_full_chain_logits_match_hf(loop, falcon_dirs, registry, chains,
                                    case):
    d, hf, config = falcon_dirs[case]
    model = port_client(d, registry.port, f"falcon-{case}")
    assert model.spec.family == "falcon" and "norm_bias" in model.params
    input_ids = prompt_ids(config, b=1)

    async def go():
        async with model.inference_session(16, 1) as sess:
            return model.logits(await sess.step(model.embed(input_ids)))

    got = run(loop, go())
    np.testing.assert_allclose(got.numpy(), hf_logits(hf, input_ids),
                               atol=2e-3, rtol=2e-3)


@pytest.mark.parametrize("case", ["mq", "new"])
def test_full_chain_greedy_matches_hf_and_jax_client(loop, falcon_dirs,
                                                     registry, chains, case):
    """Greedy tokens through the port chain, by the port client and by the
    JAX client, equal HF's; the servers took the kernel routes."""
    d, hf, config = falcon_dirs[case]
    uid = f"falcon-{case}"
    input_ids = prompt_ids(config, seed=1)
    got = run(loop, port_client(d, registry.port, uid).generate(
        input_ids, max_new_tokens=8)).numpy()
    want = run(loop, jax_client(d, registry.port, uid).generate(
        input_ids, max_new_tokens=8))
    np.testing.assert_array_equal(got, hf_greedy(hf, input_ids, 8))
    np.testing.assert_array_equal(np.asarray(want), got)
    assert all(s.executor.paged_supported and s.executor.flash_supported
               for s in chains)


def test_server_decode_matches_per_step(loop, falcon_dirs, registry):
    """One whole-model port server (the fused decode loop with the
    LayerNorm head): `generate(server_decode=True)` gives per-step
    `generate`'s tokens and HF's."""
    d, hf, config = falcon_dirs["new"]
    uid = "falcon-dn"
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


def test_run_server_builds_and_warms_a_falcon_span(falcon_dirs,
                                                   monkeypatch):
    """`run_server.main` takes the directory through the registry, loads
    the span, runs the warmup and reaches start."""
    d, hf, _ = falcon_dirs["mq"]
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


def test_falcon_drafts_for_itself_locally(loop, falcon_dirs, registry,
                                          chains):
    """A tiny Falcon checkpoint is a local drafter (the dense block forward
    takes the parallel residual), as in the JAX package: speculative
    decoding through the port chain gives plain `generate`'s tokens."""
    d, _, config = falcon_dirs["mq"]
    model = port_client(d, registry.port, "falcon-mq")
    drafter = GreedyTreeDrafter(LocalDraftModel.from_dir(d, device="cpu"),
                                branching=(2, 1))
    input_ids = prompt_ids(config, b=1, s=5, seed=2)
    got = run(loop, generate_speculative(model, drafter, input_ids,
                                         max_new_tokens=8))
    assert got.shape[1] >= input_ids.shape[1] + 8
    plain = run(loop, model.generate(
        input_ids, max_new_tokens=got.shape[1] - input_ids.shape[1]))
    np.testing.assert_array_equal(np.asarray(got), plain.numpy())

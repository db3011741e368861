"""The port's int4 KV format and int4 arena vs the JAX package's on the CPU.

`quantize` must give JAX's codes, scales and zeros bit for bit (pages move
between the packages); the int4 decode kernel's plain version must match
the Pallas kernel in interpret mode (f32, atol 1e-5: the same dequantized
values, summed in another order); and the port's executor over an int4
arena must match the JAX executor over one, with identical greedy tokens.
The CUDA kernel itself runs only on the card (chip_smoke.py).
"""

import asyncio

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bloombee_tpu.kv import quant as j_quant
from bloombee_tpu.kv.cache_manager import CacheManager as JaxManager
from bloombee_tpu.models.spec import ModelSpec as JaxSpec
from bloombee_tpu.ops.pallas.paged_attention import (
    paged_decode_attention_int4 as j_int4,
)
from bloombee_tpu.runtime.executor import SpanExecutor as JaxExecutor
from bloombee_tpu_torch.kv import quant as t_quant
from bloombee_tpu_torch.kv.cache_manager import CacheManager
from bloombee_tpu_torch.models.llama.block import params_from_jax
from bloombee_tpu_torch.models.spec import ModelSpec
from bloombee_tpu_torch.ops.cuda import paged_attention as t_paged
from bloombee_tpu_torch.runtime.executor import SpanExecutor
from test_torch_slice import HD, SPEC, count_routes, model_and_inputs

# jitted as the JAX executor runs them (and one compile each, not one per
# eager op)
j_quantize = jax.jit(j_quant.quantize)
j_dequantize = jax.jit(j_quant.dequantize, static_argnums=1)


def test_quantize_matches_jax_bit_for_bit():
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((3, 5, 2, 64)) * 3).astype(np.float32)
    x[0, 0, 0, :32] = 1.25  # a constant group: scale 0, codes 0
    x[1, 2, 1, 7] = 1e4  # one outlier group
    want = j_quantize(jnp.asarray(x))
    got = t_quant.quantize(torch.from_numpy(x))
    for name in ("codes", "scale", "zero"):
        g, w = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)
    np.testing.assert_allclose(
        t_quant.dequantize(got, torch.float32).numpy(),
        np.asarray(j_dequantize(want, jnp.float32)),
        atol=1e-6, rtol=0,
    )
    assert not got.codes[0, 0, 0, :16].any()


@pytest.mark.parametrize("window", [0, 20])
def test_int4_decode_plain_matches_pallas(window):
    """int4 paged decode over shuffled pages, ragged lengths, and a lens=0
    row that must come out as exact zeros; with and without a window."""
    rng = np.random.default_rng(1)
    b, h, hkv, hd, ps = 3, 8, 2, 64, 16
    q = rng.standard_normal((b, h, hd)).astype(np.float32)
    dense = rng.standard_normal((2, 12 * ps, hkv, hd)).astype(np.float32)
    pt = np.array([[7, 2, 9, 0], [1, 4, 5, 8], [11, 3, 6, 10]], np.int32)
    lens = np.array([55, 33, 0], np.int32)
    jk, jv = (j_quantize(jnp.asarray(d)) for d in dense)
    want = j_int4(
        jnp.asarray(q), jk, jv, jnp.asarray(pt), jnp.asarray(lens),
        page_size=ps, interpret=True, window=window,
    )
    tk, tv = (t_quant.quantize(torch.from_numpy(d)) for d in dense)
    got = t_paged.paged_decode_attention_int4_reference(
        torch.from_numpy(q), tk, tv, torch.from_numpy(pt),
        torch.from_numpy(lens), ps, window=window,
    )
    np.testing.assert_allclose(
        got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5
    )
    assert not got[2].any()


# Over an int4 arena the two packages' K/V differ by float32 summation
# order (~1e-6) before quantization, and that can move the f16 rounding of
# a group's stored scale or zero by one f16 step (2^-11 relative, ~1e-3 at
# |zero| ~ 2), shifting all 16 dequantized values of the group. Hidden
# states are held to what one such step allows; the arenas are held to at
# most one f16 step per scale/zero and identical codes but for rounding
# ties (the dense arena holds 1e-4: test_torch_slice).
INT4_TOL = 2e-3


def drive(manager, ex, embed, greedy, prompt):
    """Prefill, then 4 greedy decodes; returns hidden states and tokens."""
    outs, tokens = [], []

    async def go():
        async with manager.allocate(2, 160) as a:
            out = np.asarray(ex.prefill(a, embed(prompt)), np.float32)
            outs.append(out)
            for _ in range(4):
                nxt = greedy(out)
                tokens.append(nxt)
                out = np.asarray(
                    ex.decode(a, embed(nxt[:, None])), np.float32
                )
                outs.append(out)

    asyncio.run(go())
    return outs, tokens


def test_int4_arena_executor_matches_jax(monkeypatch):
    """Prefill 100 x2 (flash over the dequantized pages) and 4 greedy
    decodes (the int4 decode route on the port, forced by a zero
    BBTPU_PAGED_MIN_CONTEXT) against the JAX executor over an int4 arena
    (its CPU route: dense attention over the dequantized gather)."""
    from bloombee_tpu.models import head as j_head
    from bloombee_tpu_torch.models import head as t_head

    params, client, (prompt, _, _) = model_and_inputs()
    prompt = prompt[:, :100]
    table = client["embed"]

    def j_greedy(hidden):
        logits = j_head.norm_head_impl(
            {k: jnp.asarray(v) for k, v in client.items()},
            jnp.asarray(hidden[:, -1]), 1e-5,
        )
        return np.asarray(logits.argmax(-1))

    jm = JaxManager(
        num_layers=2, num_pages=64, page_size=16, n_kv_heads=2, head_dim=HD,
        dtype=jnp.float32, quant="int4",
    )
    jex = JaxExecutor(params, JaxSpec(**SPEC), jm, compute_dtype=jnp.float32)
    want, want_tok = drive(jm, jex, lambda ids: table[ids], j_greedy, prompt)

    routes = count_routes(monkeypatch)
    int4_calls = []
    ref = t_paged.paged_decode_attention_int4_reference

    def counted(*a, **kw):
        int4_calls.append(1)
        return ref(*a, **kw)

    monkeypatch.setattr(
        t_paged, "paged_decode_attention_int4_reference", counted
    )
    monkeypatch.setenv("BBTPU_PAGED_MIN_CONTEXT", "0")
    tm = CacheManager(
        2, 64, 16, 2, HD, dtype=torch.float32, device="cpu", quant="int4"
    )
    assert isinstance(tm.arena["k"], t_quant.QuantSlab)
    tex = SpanExecutor(
        params_from_jax(params, device="cpu"), ModelSpec(**SPEC), tm,
        compute_dtype=torch.float32, device="cpu",
    )
    t_client = {k: torch.from_numpy(v) for k, v in client.items()}

    def t_greedy(hidden):
        h = torch.as_tensor(hidden)[:, -1]
        return t_head.norm_head_impl(t_client, h, 1e-5).argmax(-1).numpy()

    got, got_tok = drive(tm, tex, lambda ids: table[ids], t_greedy, prompt)
    for g, w in zip(got, want, strict=True):
        np.testing.assert_allclose(g, w, atol=INT4_TOL, rtol=INT4_TOL)
    for g, w in zip(got_tok, want_tok, strict=True):
        np.testing.assert_array_equal(g, w)
    for side in ("k", "v"):
        j_slab, t_slab = jm.arena[side], tm.arena[side]
        codes = np.asarray(j_slab.codes) != t_slab.codes.numpy()
        assert codes.mean() < 1e-3, codes.sum()
        for name in ("scale", "zero"):
            w = np.asarray(getattr(j_slab, name))
            g = getattr(t_slab, name).numpy()
            assert np.all(np.abs(g - w) <= np.spacing(np.abs(w))), name
    # 2 layers x 4 decodes on the int4 route; the prefill on flash
    assert len(int4_calls) == 8
    assert routes["flash_attention_reference"] == 2

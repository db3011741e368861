"""The whole slice on the CPU: a port SpanExecutor vs a JAX SpanExecutor on
the same weights and inputs, through prefill (flash route), 8 greedy
decodes (paged-decode route), a 24-token follow-up (paged-chunk route) and
one decode_group of two sessions (paged-decode route).

The JAX side runs its default CPU path (dense attention); the port runs its
kernels' plain versions, which the routing counters below prove. Hidden
states agree to atol/rtol 1e-4 (f32; float32 sums in another order plus the
online-vs-direct softmax); greedy tokens from each package's head must be
identical.
"""

import asyncio

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bloombee_tpu.kv.cache_manager import CacheManager as JaxManager
from bloombee_tpu.models import head as j_head
from bloombee_tpu.models.spec import ModelSpec as JaxSpec
from bloombee_tpu.runtime.executor import SpanExecutor as JaxExecutor
from bloombee_tpu_torch.kv.cache_manager import CacheManager
from bloombee_tpu_torch.models import head as t_head
from bloombee_tpu_torch.models.llama.block import params_from_jax
from bloombee_tpu_torch.models.spec import ModelSpec
from bloombee_tpu_torch.ops.cuda import flash_attention as t_flash
from bloombee_tpu_torch.ops.cuda import paged_attention as t_paged
from bloombee_tpu_torch.runtime.executor import SpanExecutor

SPEC = dict(
    family="llama", hidden_size=64, intermediate_size=128,
    num_attention_heads=4, num_key_value_heads=2, head_dim=64,
    num_hidden_layers=2, vocab_size=96, rms_norm_eps=1e-5,
)
# head_dim and GQA group inside the CUDA kernels' shape domain, so the
# executor takes the kernel routes (their plain versions on the CPU)
HD = SPEC["head_dim"]
LAYER_SHAPES = {
    "input_layernorm": (64,), "post_attention_layernorm": (64,),
    "q_proj": (64, 4 * HD), "k_proj": (64, 2 * HD), "v_proj": (64, 2 * HD),
    "o_proj": (4 * HD, 64), "gate_proj": (64, 128), "up_proj": (64, 128),
    "down_proj": (128, 64),
}
TOL = 1e-4


class JaxSide:
    def __init__(self, params, client):
        self.manager = JaxManager(
            num_layers=2, num_pages=64, page_size=16, n_kv_heads=2,
            head_dim=HD, dtype=jnp.float32,
        )
        self.ex = JaxExecutor(
            params, JaxSpec(**SPEC), self.manager, compute_dtype=jnp.float32
        )
        self.table = client["embed"]
        self.client = {k: jnp.asarray(v) for k, v in client.items()}

    def embed(self, ids):
        # JAX's embed_impl is this gather; done in numpy it costs no compile
        # per ids shape (test_torch_block holds the two embeds equal)
        return self.table[ids]

    def greedy(self, hidden):
        # rows padded to the batch of 2 so the JAX head compiles once
        h = hidden[:, -1]
        h = np.concatenate([h, np.zeros((2 - len(h), h.shape[1]), h.dtype)])
        logits = j_head.norm_head_impl(self.client, jnp.asarray(h), 1e-5)
        return np.asarray(logits.argmax(-1))[: len(hidden)]

    def group_out(self, out):
        return np.asarray(out, np.float32)


class TorchSide:
    def __init__(self, params, client):
        self.manager = CacheManager(
            2, 64, 16, 2, HD, dtype=torch.float32, device="cpu"
        )
        self.ex = SpanExecutor(
            params_from_jax(params, device="cpu"), ModelSpec(**SPEC),
            self.manager, compute_dtype=torch.float32, device="cpu",
        )
        self.client = {k: torch.from_numpy(v) for k, v in client.items()}

    def embed(self, ids):
        return t_head.embed_impl(self.client, torch.from_numpy(ids)).numpy()

    def greedy(self, hidden):
        h = torch.as_tensor(hidden)[:, -1]
        return t_head.norm_head_impl(self.client, h, 1e-5).argmax(-1).numpy()

    def group_out(self, out):
        return self.ex.fetch(out).numpy()


def drive(side, prompt, follow, prompt_b):
    """prefill 300 x2 -> 8 greedy decodes -> 24-token follow-up; a second
    session prefills 100; one decode_group over both sessions."""
    outs, tokens = [], []

    async def go():
        m, ex = side.manager, side.ex
        async with m.allocate(2, 400) as a, m.allocate(1, 200) as b:
            out = np.asarray(ex.prefill(a, side.embed(prompt)), np.float32)
            outs.append(out)
            for _ in range(8):
                nxt = side.greedy(out)
                tokens.append(nxt)
                out = np.asarray(
                    ex.decode(a, side.embed(nxt[:, None])), np.float32
                )
                outs.append(out)
            tokens.append(side.greedy(out))
            outs.append(
                np.asarray(ex.decode(a, side.embed(follow)), np.float32)
            )
            out_b = np.asarray(ex.prefill(b, side.embed(prompt_b)), np.float32)
            outs.append(out_b)
            nxt = np.concatenate([tokens[-1], side.greedy(out_b)])
            hid = side.embed(nxt[:, None])
            out, combined = ex.decode_group([a, b], [hid[:2], hid[2:]])
            m.commit(combined)
            outs.append(side.group_out(out))

    asyncio.run(go())
    return outs, tokens


def model_and_inputs():
    """Stacked JAX-layout params, client params and the drive's token ids,
    from one seed."""
    rng = np.random.default_rng(0)
    params = {  # JAX layout, stacked with a leading L
        k: (rng.standard_normal((2, *s)) / (8 if len(s) == 2 else 1)).astype(
            np.float32
        )
        for k, s in LAYER_SHAPES.items()
    }
    client = {
        "embed": rng.standard_normal((96, 64)).astype(np.float32),
        "norm": np.ones((64,), np.float32),
        "lm_head": (rng.standard_normal((64, 96)) / 8).astype(np.float32),
    }
    prompt = rng.integers(0, 96, (2, 300))
    follow = rng.integers(0, 96, (2, 24))
    prompt_b = rng.integers(0, 96, (1, 100))
    return params, client, (prompt, follow, prompt_b)


def count_routes(monkeypatch) -> dict:
    """Count calls of each kernel's plain version (the CPU route)."""
    routes = {}
    for mod, name in (
        (t_flash, "flash_attention_reference"),
        (t_paged, "paged_decode_attention_reference"),
        (t_paged, "paged_chunk_attention_reference"),
    ):
        def counted(*a, _fn=getattr(mod, name), _name=name, **kw):
            routes[_name] = routes.get(_name, 0) + 1
            return _fn(*a, **kw)

        monkeypatch.setattr(mod, name, counted)
    return routes


def test_port_executor_matches_jax_executor(monkeypatch):
    params, client, inputs = model_and_inputs()
    routes = count_routes(monkeypatch)
    want, want_tok = drive(JaxSide(params, client), *inputs)
    got, got_tok = drive(TorchSide(params, client), *inputs)
    for g, w in zip(got, want, strict=True):
        np.testing.assert_allclose(g, w, atol=TOL, rtol=TOL)
    for g, w in zip(got_tok, want_tok, strict=True):
        np.testing.assert_array_equal(g, w)
    # 2 layers x (prefill 300 + prefill 100) on flash; 2 x (8 decodes +
    # the group) on paged decode; 2 x the follow-up on paged chunk (the
    # decode plain version is a one-token chunk, hence its calls there too)
    assert routes["flash_attention_reference"] == 4
    assert routes["paged_decode_attention_reference"] == 18
    assert routes["paged_chunk_attention_reference"] == 18 + 2


def test_paged_min_context_routes_to_the_dense_path(monkeypatch):
    """Above BBTPU_PAGED_MIN_CONTEXT's threshold every decode and the
    follow-up take the dense attend_paged path instead of the paged
    kernels, with the same results (f32, atol/rtol 1e-4)."""
    params, client, inputs = model_and_inputs()
    want, want_tok = drive(TorchSide(params, client), *inputs)
    routes = count_routes(monkeypatch)
    monkeypatch.setenv("BBTPU_PAGED_MIN_CONTEXT", str(1 << 20))
    got, got_tok = drive(TorchSide(params, client), *inputs)
    for g, w in zip(got, want, strict=True):
        np.testing.assert_allclose(g, w, atol=TOL, rtol=TOL)
    for g, w in zip(got_tok, want_tok, strict=True):
        np.testing.assert_array_equal(g, w)
    assert routes == {"flash_attention_reference": 4}


def test_layers_subspan_and_guards_match_jax():
    """`layers=(1, 2)` runs only the span's second layer (a session entering
    mid-span) on both packages; the port's decode_group takes a multi-token
    member, and the port refuses specs its Llama layer body cannot serve.
    The prefill has the shape of the test above's second session, so the
    JAX side reuses that step's compile."""
    rng = np.random.default_rng(1)
    params = {
        k: (rng.standard_normal((2, *s)) / (8 if len(s) == 2 else 1)).astype(
            np.float32
        )
        for k, s in LAYER_SHAPES.items()
    }
    client = {
        "embed": np.zeros((96, 64), np.float32),
        "norm": np.ones((64,), np.float32),
        "lm_head": np.zeros((64, 96), np.float32),
    }
    hidden = rng.standard_normal((1, 100, 64)).astype(np.float32)
    outs = []
    for side in (JaxSide(params, client), TorchSide(params, client)):
        async def go(side=side):
            async with side.manager.allocate(1, 200) as h:
                outs.append(np.asarray(
                    side.ex.prefill(h, hidden, layers=(1, 2)), np.float32
                ))
                assert not np.asarray(side.manager.arena["k"][0]).any()

        asyncio.run(go())
    np.testing.assert_allclose(outs[1], outs[0], atol=TOL, rtol=TOL)

    port = TorchSide(params, client)

    async def guards():
        # decode_group takes a multi-token member as the JAX package's does
        # (one ragged dispatch; tests/test_torch_ragged.py holds the values
        # against JAX)
        async with port.manager.allocate(1, 32) as h:
            out, combined = port.ex.decode_group([h], [hidden[:, :2]])
            assert tuple(out.shape) == (2, 1, 64)
            assert port.manager.context_lens(combined).tolist() == [2]

    asyncio.run(guards())
    with pytest.raises(ValueError, match="does not cover"):
        SpanExecutor(
            params_from_jax(params, device="cpu"),
            ModelSpec(**SPEC, k_eq_v_full=True), port.manager,
            device="cpu",
        )

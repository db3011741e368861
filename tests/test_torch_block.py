"""The port's Llama block, its parameter conversion and the client head vs
the JAX package on the CPU (f32, atol 1e-5 unless stated)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bloombee_tpu.models import head as j_head
from bloombee_tpu.models.llama import block as j_block
from bloombee_tpu.models.spec import ModelSpec as JaxSpec
from bloombee_tpu.ops.rotary import rotary_cos_sin as j_rope
from bloombee_tpu.utils.tree import stack_params
from bloombee_tpu_torch.models import head as t_head
from bloombee_tpu_torch.models.llama import block as t_block
from bloombee_tpu_torch.models.spec import ModelSpec
from bloombee_tpu_torch.ops.rotary import rotary_cos_sin as t_rope

SPEC = dict(
    family="llama", hidden_size=64, intermediate_size=128,
    num_attention_heads=4, num_key_value_heads=2, head_dim=16,
    num_hidden_layers=2, vocab_size=96, rms_norm_eps=1e-5,
)


def jax_layers(n=2):
    """Per-layer JAX-layout params ([in, out] projections) from numpy."""
    rng = np.random.default_rng(42)
    shapes = {
        "input_layernorm": (64,), "post_attention_layernorm": (64,),
        "q_proj": (64, 64), "k_proj": (64, 32), "v_proj": (64, 32),
        "o_proj": (64, 64), "gate_proj": (64, 128), "up_proj": (64, 128),
        "down_proj": (128, 64),
    }
    return [
        {
            k: (rng.standard_normal(s) / (8 if len(s) == 2 else 1)).astype(
                np.float32
            )
            for k, s in shapes.items()
        }
        for _ in range(n)
    ]


@pytest.mark.parametrize("stacked", [False, True])
def test_params_from_jax_is_a_copy(stacked):
    layers = jax_layers()
    tree = (
        jax.tree.map(np.asarray, stack_params(layers)) if stacked else layers
    )
    port = t_block.params_from_jax(tree, device="cpu")
    assert len(port) == 2
    for i in range(2):
        assert set(port[i]) == {n for n, _ in t_block.HF_BLOCK_KEYS.values()}
        for name, w in layers[i].items():
            np.testing.assert_array_equal(port[i][name].numpy(), w)


def test_block_forward_with_past_matches_jax():
    """Prefill then a 3-token continuation against a dense past, both
    packages, same weights."""
    rng = np.random.default_rng(0)
    (p_j,) = jax_layers(1)
    (p_t,) = t_block.params_from_jax([p_j], device="cpu")
    spec_j, spec_t = JaxSpec(**SPEC), ModelSpec(**SPEC)
    x = rng.standard_normal((2, 7, 64)).astype(np.float32)
    x2 = rng.standard_normal((2, 3, 64)).astype(np.float32)
    pos = np.broadcast_to(np.arange(7), (2, 7)).astype(np.int32)
    pos2 = pos[:, :3] + 7

    @jax.jit
    def j_prefill(p, x, pos):
        return j_block.block_forward(
            p, spec_j, x, *j_rope(pos, 16), j_block.dense_attend()
        )

    @jax.jit
    def j_continue(p, x, pos, k, v):
        return j_block.block_forward(
            p, spec_j, x, *j_rope(pos, 16),
            j_block.dense_attend(k, v, offset=7),
        )

    hj, (kj, vj) = j_prefill(p_j, jnp.asarray(x), jnp.asarray(pos))
    ht, (kt, vt) = t_block.block_forward(
        p_t, spec_t, torch.from_numpy(x), *t_rope(torch.from_numpy(pos), 16),
        t_block.dense_attend(),
    )
    np.testing.assert_allclose(ht.numpy(), np.asarray(hj), atol=1e-5, rtol=1e-5)
    hj2, _ = j_continue(p_j, jnp.asarray(x2), jnp.asarray(pos2), kj, vj)
    ht2, _ = t_block.block_forward(
        p_t, spec_t, torch.from_numpy(x2), *t_rope(torch.from_numpy(pos2), 16),
        t_block.dense_attend(kt, vt),
    )
    np.testing.assert_allclose(ht2.numpy(), np.asarray(hj2), atol=1e-5, rtol=1e-5)


def test_init_block_params_seeded_and_shaped():
    spec = ModelSpec(**SPEC)
    a = t_block.init_block_params(
        torch.Generator().manual_seed(3), spec, device="cpu"
    )
    b = t_block.init_block_params(
        torch.Generator().manual_seed(3), spec, device="cpu"
    )
    want = {  # shapes only: traced, never compiled
        k: v.shape
        for k, v in jax.eval_shape(
            lambda key: j_block.init_block_params(key, JaxSpec(**SPEC)),
            jax.ShapeDtypeStruct((2,), jnp.uint32),
        ).items()
    }
    assert {k: tuple(v.shape) for k, v in a.items()} == want
    for k in a:
        assert torch.equal(a[k], b[k])


def test_embed_and_norm_head_match_jax():
    rng = np.random.default_rng(1)
    params = {
        "embed": rng.standard_normal((96, 64)).astype(np.float32),
        "norm": rng.standard_normal((64,)).astype(np.float32),
        "lm_head": rng.standard_normal((64, 96)).astype(np.float32) / 8,
    }
    ids = rng.integers(0, 96, (2, 5))
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.from_numpy(v) for k, v in params.items()}
    he = t_head.embed_impl(tp, torch.from_numpy(ids))
    np.testing.assert_array_equal(
        he.numpy(), np.asarray(j_head.embed_impl(jp, jnp.asarray(ids)))
    )
    np.testing.assert_allclose(
        t_head.norm_head_impl(tp, he, 1e-5).numpy(),
        np.asarray(j_head.norm_head_impl(jp, jnp.asarray(he.numpy()), 1e-5)),
        atol=1e-5, rtol=1e-5,
    )

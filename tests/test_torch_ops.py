"""Port ops (bloombee_tpu_torch.ops) vs their JAX counterparts on the CPU.

Same numpy inputs through both; f32 throughout, atol 1e-5 (only the order of
float32 sums differs between the two frameworks)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bloombee_tpu.ops import attention as j_att
from bloombee_tpu.ops import mlp as j_mlp
from bloombee_tpu.ops import norms as j_norms
from bloombee_tpu.ops import rotary as j_rot
from bloombee_tpu_torch.ops import attention as t_att
from bloombee_tpu_torch.ops import mlp as t_mlp
from bloombee_tpu_torch.ops import norms as t_norms
from bloombee_tpu_torch.ops import rotary as t_rot

ATOL = 1e-5


def close(port, ref, atol=ATOL):
    np.testing.assert_allclose(
        port.detach().float().numpy(), np.asarray(ref, np.float32),
        atol=atol, rtol=atol,
    )


@pytest.mark.parametrize("shape", [(2, 5, 64), (3, 48)])
def test_rms_norm_matches_jax(shape):
    rng = np.random.default_rng(0)
    x = rng.standard_normal(shape).astype(np.float32) * 3
    w = rng.standard_normal(shape[-1:]).astype(np.float32)
    close(
        t_norms.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-5),
        j_norms.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5),
    )


def test_layer_norm_matches_jax():
    rng = np.random.default_rng(1)
    x, w, b = (
        rng.standard_normal(s).astype(np.float32)
        for s in ((2, 7, 32), (32,), (32,))
    )
    close(
        t_norms.layer_norm(*map(torch.from_numpy, (x, w, b)), 1e-5),
        j_norms.layer_norm(*map(jnp.asarray, (x, w, b)), 1e-5),
    )


@pytest.mark.parametrize("theta", [10000.0, 500000.0])
def test_rotary_matches_jax(theta):
    rng = np.random.default_rng(2)
    b, t, h, hkv, hd = 2, 6, 4, 2, 16
    pos = rng.integers(0, 3000, (b, t)).astype(np.int32)
    q = rng.standard_normal((b, t, h, hd)).astype(np.float32)
    k = rng.standard_normal((b, t, hkv, hd)).astype(np.float32)
    tc, ts = t_rot.rotary_cos_sin(torch.from_numpy(pos), hd, theta)
    jc, js = j_rot.rotary_cos_sin(jnp.asarray(pos), hd, theta)
    close(tc, jc)
    close(ts, js)
    tq, tk = t_rot.apply_rotary(torch.from_numpy(q), torch.from_numpy(k), tc, ts)
    jq, jk = j_rot.apply_rotary(jnp.asarray(q), jnp.asarray(k), jc, js)
    close(tq, jq)
    close(tk, jk)


def test_silu_mlp_matches_jax():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 5, 32)).astype(np.float32)
    g, u = (rng.standard_normal((32, 48)).astype(np.float32) / 6 for _ in "gu")
    d = rng.standard_normal((48, 32)).astype(np.float32) / 7
    close(
        t_mlp.silu_mlp(*map(torch.from_numpy, (x, g, u, d))),
        j_mlp.silu_mlp(*map(jnp.asarray, (x, g, u, d))),
    )


@pytest.mark.parametrize("hkv", [4, 2, 1])
def test_masked_attention_matches_jax(hkv):
    rng = np.random.default_rng(4)
    b, t, s, h, hd = 2, 5, 9, 4, 16
    q = rng.standard_normal((b, t, h, hd)).astype(np.float32)
    k = rng.standard_normal((b, s, hkv, hd)).astype(np.float32)
    v = rng.standard_normal((b, s, hkv, hd)).astype(np.float32)
    mask = rng.random((b, t, s)) < 0.6
    mask[:, :, 0] = True
    close(
        t_att.masked_attention(*map(torch.from_numpy, (q, k, v, mask))),
        j_att.masked_attention(*map(jnp.asarray, (q, k, v, mask))),
    )
    np.testing.assert_array_equal(
        t_att.causal_mask(4, offset=3, s=9).numpy(),
        np.asarray(j_att.causal_mask(4, offset=3, s=9)),
    )

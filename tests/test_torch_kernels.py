"""The port's plain kernel versions vs the Pallas kernels (interpret mode) on
the CPU, and the wrappers' routing.

Every case feeds the same numpy inputs to both; f32, atol 1e-5 (both sides
compute the same masked f32 softmax; only summation order differs). Shapes
are tiny so the Pallas interpreter stays fast, and cases share shapes
where they can (window and t_real are traced, not static, so those cases
reuse one compile). The CUDA kernels themselves
run only on the card (chip_smoke.py holds them against these same plain
versions there).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bloombee_tpu.ops.pallas.flash_attention import (
    flash_attention as j_flash,
)
from bloombee_tpu.ops.pallas.paged_attention import (
    paged_chunk_attention as j_chunk,
    paged_decode_attention as j_decode,
)
from bloombee_tpu_torch.kv.quant import make_quant_slab, quantize
from bloombee_tpu_torch.ops.cuda import build
from bloombee_tpu_torch.ops.cuda import flash_attention as t_flash
from bloombee_tpu_torch.ops.cuda import paged_attention as t_paged

ATOL = 1e-5


def close(port, ref):
    np.testing.assert_allclose(
        port.numpy(), np.asarray(ref, np.float32), atol=ATOL, rtol=ATOL
    )


def rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


# ------------------------------------------------------------------- flash
@pytest.mark.parametrize("causal,hkv", [(True, 2), (False, 1), (True, 4)])
def test_flash_plain_matches_pallas(causal, hkv):
    rng = np.random.default_rng(0)
    b, t, s, h, hd = 2, 64, 96, 4, 32
    q = rand(rng, b, t, h, hd)
    k, v = rand(rng, b, s, hkv, hd), rand(rng, b, s, hkv, hd)
    want = j_flash(
        *map(jnp.asarray, (q, k, v)), causal=causal, block_q=32, block_k=32,
        interpret=True,
    )
    got = t_flash.flash_attention_reference(
        *map(torch.from_numpy, (q, k, v)), causal=causal
    )
    close(got, want)


def test_flash_plain_mixed_starts_lens_matches_pallas():
    """Per-row starts/lens (mixed-length batch) with a poisoned tail past
    each row's lens; one row sees no key at all and must be zeros."""
    rng = np.random.default_rng(1)
    b, t, s, h, hkv, hd = 3, 32, 96, 4, 2, 32
    q = rand(rng, b, t, h, hd)
    k, v = rand(rng, b, s, hkv, hd), rand(rng, b, s, hkv, hd)
    starts = np.array([0, 37, 64], np.int32)
    lens = np.array([32, 69, 0], np.int32)
    for r in range(b):
        k[r, lens[r]:] = 100.0
        v[r, lens[r]:] = 100.0
    want = j_flash(
        *map(jnp.asarray, (q, k, v)), causal=True, block_q=32, block_k=32,
        interpret=True, starts=jnp.asarray(starts), lens=jnp.asarray(lens),
    )
    got = t_flash.flash_attention_reference(
        *map(torch.from_numpy, (q, k, v)), causal=True,
        starts=torch.from_numpy(starts), lens=torch.from_numpy(lens),
    )
    close(got, want)
    assert not got[2].any()


# ------------------------------------------------------------ paged decode
def paged_inputs(rng, b, h, hkv, hd=64, page_size=16, n_phys=12, t=None):
    q = rand(rng, b, h, hd) if t is None else rand(rng, b, t, h, hd)
    k_slab = rand(rng, n_phys * page_size, hkv, hd)
    v_slab = rand(rng, n_phys * page_size, hkv, hd)
    # shuffled physical pages; per-sequence lens not page-aligned
    pt = np.array([[7, 2, 9, 0], [1, 4, 5, 8], [11, 3, 6, 10]], np.int32)[:b]
    return q, k_slab, v_slab, pt


@pytest.mark.parametrize("hkv,h", [(2, 8), (1, 6)])
def test_paged_decode_plain_matches_pallas(hkv, h):
    rng = np.random.default_rng(2)
    q, ks, vs, pt = paged_inputs(rng, 3, h, hkv)
    lens = np.array([55, 17, 64], np.int32)
    want = j_decode(
        *map(jnp.asarray, (q, ks, vs, pt, lens)), page_size=16,
        interpret=True,
    )
    got = t_paged.paged_decode_attention_reference(
        *map(torch.from_numpy, (q, ks, vs, pt, lens)), page_size=16
    )
    close(got, want)


@pytest.mark.parametrize("window", [5, 40])
def test_paged_decode_plain_window_and_empty_row(window):
    """Sliding window plus a lens=0 padding row, which must be exact
    zeros."""
    rng = np.random.default_rng(3)
    q, ks, vs, pt = paged_inputs(rng, 3, 8, 2)
    lens = np.array([55, 33, 0], np.int32)
    want = j_decode(
        *map(jnp.asarray, (q, ks, vs, pt, lens)), page_size=16,
        interpret=True, window=window,
    )
    got = t_paged.paged_decode_attention_reference(
        *map(torch.from_numpy, (q, ks, vs, pt, lens)), page_size=16,
        window=window,
    )
    close(got, want)
    assert not got[2].any()


# ------------------------------------------------------------- paged chunk
@pytest.mark.parametrize("hkv,h,t_real", [(2, 8, 5), (1, 4, 8)])
def test_paged_chunk_plain_causal_padded_matches_pallas(hkv, h, t_real):
    """Causal chunk in a padded bucket of 8 query rows: rows >= t_real are
    padding and come out zero on both sides."""
    rng = np.random.default_rng(5)
    q, ks, vs, pt = paged_inputs(rng, 2, h, hkv, t=8)
    lens = np.array([55, 38], np.int32)
    want = j_chunk(
        *map(jnp.asarray, (q, ks, vs, pt, lens)), page_size=16,
        interpret=True, t_real=t_real,
    )
    got = t_paged.paged_chunk_attention_reference(
        *map(torch.from_numpy, (q, ks, vs, pt, lens)), page_size=16,
        t_real=t_real,
    )
    close(got, want)
    assert not got[:, t_real:].any()


@pytest.mark.parametrize("window", [20])
def test_paged_chunk_plain_window_matches_pallas(window):
    rng = np.random.default_rng(6)
    q, ks, vs, pt = paged_inputs(rng, 2, 8, 2, t=8)
    lens = np.array([55, 38], np.int32)
    want = j_chunk(
        *map(jnp.asarray, (q, ks, vs, pt, lens)), page_size=16,
        interpret=True, window=window,
    )
    got = t_paged.paged_chunk_attention_reference(
        *map(torch.from_numpy, (q, ks, vs, pt, lens)), page_size=16,
        window=window,
    )
    close(got, want)


def test_paged_chunk_plain_tree_matches_pallas():
    """Tree verify: committed prefix fully visible, the [T, T] ancestor mask
    governs the in-step keys."""
    rng = np.random.default_rng(7)
    t_q = 6
    q, ks, vs, pt = paged_inputs(rng, 2, 8, 2, t=t_q)
    lens = np.array([55, 38], np.int32)
    parents = [-1, 0, 0, 1, 2, 3]
    tm = np.zeros((t_q, t_q), bool)
    for n in range(t_q):
        node = n
        while node >= 0:
            tm[n, node] = True
            node = parents[node]
    tree = np.broadcast_to(tm, (2, t_q, t_q)).copy()
    want = j_chunk(
        *map(jnp.asarray, (q, ks, vs, pt, lens)), page_size=16,
        tree_mask=jnp.asarray(tree), interpret=True, has_tree=True,
    )
    got = t_paged.paged_chunk_attention_reference(
        *map(torch.from_numpy, (q, ks, vs, pt, lens)), page_size=16,
        tree_mask=torch.from_numpy(tree),
    )
    close(got, want)


# ----------------------------------------------------------------- routing
def test_wrappers_run_plain_version_on_cpu_without_counting():
    rng = np.random.default_rng(8)
    q, ks, vs, pt = paged_inputs(rng, 2, 4, 2)
    lens = torch.tensor([40, 9], dtype=torch.int32)
    args = (*map(torch.from_numpy, (q, ks, vs, pt)), lens, 16)
    build.reset_launch_counts()
    assert torch.equal(
        t_paged.paged_decode_attention(*args, window=7),
        t_paged.paged_decode_attention_reference(*args, window=7),
    )
    qf = torch.from_numpy(rand(rng, 1, 8, 4, 64))
    kf = torch.from_numpy(rand(rng, 1, 16, 2, 64))
    assert torch.equal(
        t_flash.flash_attention(qf, kf, kf),
        t_flash.flash_attention_reference(qf, kf, kf),
    )
    qk, qv = (quantize(x) for x in args[1:3])
    int4_args = (args[0], qk, qv, *args[3:])
    assert torch.equal(
        t_paged.paged_decode_attention_int4(*int4_args),
        t_paged.paged_decode_attention_int4_reference(*int4_args),
    )
    rows = torch.tensor([0, 0, 1], dtype=torch.int32)
    pos = torch.tensor([38, 39, 8], dtype=torch.int32)
    ragged_args = (args[0][rows], *args[1:5], rows, pos, 16)
    assert torch.equal(
        t_paged.paged_ragged_attention(*ragged_args, window=7),
        t_paged.paged_ragged_attention_reference(*ragged_args, window=7),
    )
    assert not build.LAUNCHES


@pytest.mark.parametrize(
    "kernel", ["flash", "decode", "chunk", "int4", "ragged"]
)
def test_wrappers_never_fall_back_off_the_cpu(kernel):
    """A tensor that is not on the CPU never reaches a plain version: on a
    non-CUDA device the wrapper raises before any launch."""
    meta = dict(device="meta", dtype=torch.float32)
    pt = torch.zeros((1, 2), dtype=torch.int32, device="meta")
    lens = torch.zeros((1,), dtype=torch.int32, device="meta")
    slab = torch.empty((32, 2, 64), **meta)
    build.reset_launch_counts()
    with pytest.raises(ValueError, match="must be on CUDA"):
        if kernel == "flash":
            q = torch.empty((1, 4, 4, 64), **meta)
            t_flash.flash_attention(
                q, q[:, :, :2], q[:, :, :2], starts=lens, lens=lens
            )
        elif kernel == "decode":
            t_paged.paged_decode_attention(
                torch.empty((1, 4, 64), **meta), slab, slab, pt, lens, 16
            )
        elif kernel == "chunk":
            t_paged.paged_chunk_attention(
                torch.empty((1, 3, 4, 64), **meta), slab, slab, pt, lens, 16
            )
        elif kernel == "int4":
            quant = make_quant_slab((32, 2, 64), device="meta")
            t_paged.paged_decode_attention_int4(
                torch.empty((1, 4, 64), **meta), quant, quant, pt, lens, 16
            )
        else:
            rows = torch.zeros((3,), dtype=torch.int32, device="meta")
            t_paged.paged_ragged_attention(
                torch.empty((3, 4, 64), **meta), slab, slab, pt, lens, rows,
                rows, 16,
            )
    assert not build.LAUNCHES

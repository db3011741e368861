"""The port's ragged dispatch, chunked prefill and ragged writes vs the JAX
package's on the CPU.

- `paged_ragged_attention_reference` vs the Pallas `paged_ragged_attention`
  in interpret mode (f32, atol 1e-5: the same masked f32 softmax, summed in
  another order): causal with and without a window, tree mode, padding rows
  and an empty sequence.
- `write_slots_ragged` vs the JAX manager's, call for call.
- `prefill_chunked` is token-identical to `prefill` (the port alone).
- `ragged_group` vs the JAX executor's on the same weights and inputs
  (atol/rtol 1e-4 as in test_torch_slice): the JAX side runs its CPU dense
  route, the port its ragged kernel's plain version (BBTPU_PAGED_MIN_CONTEXT
  = 0), which a routing counter proves; `decode_group` with a multi-token
  member likewise.
- A fused dispatch equals its members run alone (atol 1e-5), over the mixes
  of tests/test_universal_ragged.py.
"""

import asyncio
import contextlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bloombee_tpu.kv.cache_manager import CacheManager as JaxManager
from bloombee_tpu.models.spec import ModelSpec as JaxSpec
from bloombee_tpu.ops.pallas.paged_attention import (
    paged_ragged_attention as j_ragged,
)
from bloombee_tpu.runtime.executor import SpanExecutor as JaxExecutor
from bloombee_tpu_torch.kv.cache_manager import CacheManager
from bloombee_tpu_torch.kv.paged import OutOfPages
from bloombee_tpu_torch.models.llama.block import params_from_jax
from bloombee_tpu_torch.models.spec import ModelSpec
from bloombee_tpu_torch.ops.cuda import paged_attention as t_paged
from bloombee_tpu_torch.runtime.executor import (
    SpanExecutor,
    plan_prefill_chunks,
)
from test_torch_slice import HD, SPEC, TOL, model_and_inputs

ATOL = 1e-5


# ------------------------------------------------------- kernel plain version
def ragged_case(rng, tree: bool):
    """8 rows over 3 sequences of a shuffled 12-page arena: sequence 0 owns
    a 5-row chunk (or tree), sequence 1 a decode row (or a 1-node tree),
    sequence 2 is empty (lens 0), and 2 padding rows own none (q_seq 3)."""
    h, hkv, hd = 8, 2, 64
    q = rng.standard_normal((8, h, hd)).astype(np.float32)
    ks, vs = rng.standard_normal((2, 12 * 16, hkv, hd)).astype(np.float32)
    pt = np.array([[7, 2, 9, 0], [1, 4, 5, 8], [11, 3, 6, 10]], np.int32)
    lens = np.array([55, 33, 0], np.int32)
    q_seq = np.array([0, 0, 0, 0, 0, 1, 3, 3], np.int32)
    q_pos = np.array([50, 51, 52, 53, 54, 32, 0, 0], np.int32)
    args = [q, ks, vs, pt, lens, q_seq, q_pos]
    if not tree:
        return args, {}
    nt = np.array([5, 1, 0], np.int32)
    tree_rows = np.zeros((8, 8), np.int32)
    parents = [-1, 0, 0, 1, 2]
    for n in range(5):
        node = n
        while node >= 0:
            tree_rows[n, node] = 1
            node = parents[node]
        q_pos[n] = 50 + bin(n).count("1")  # any depths: the tree decides
    tree_rows[5, 0] = 1
    return args, {"nt": nt, "tree_rows": tree_rows}


@pytest.mark.parametrize("tree,window", [(False, 0), (False, 20), (True, 0)])
def test_ragged_plain_matches_pallas(tree, window):
    rng = np.random.default_rng(10)
    args, extra = ragged_case(rng, tree)
    want = j_ragged(
        *map(jnp.asarray, args), page_size=16, interpret=True,
        window=window, has_tree=tree,
        **{k: jnp.asarray(v) for k, v in extra.items()},
    )
    got = t_paged.paged_ragged_attention_reference(
        *map(torch.from_numpy, args), page_size=16, window=window,
        **{k: torch.from_numpy(v) for k, v in extra.items()},
    )
    np.testing.assert_allclose(
        got.numpy(), np.asarray(want), atol=ATOL, rtol=ATOL
    )
    assert not got[6:].any()  # padding rows


# ------------------------------------------------------------ ragged writes
def test_write_slots_ragged_matches_jax():
    """Same allocations and writes on both managers give the same slots;
    a ragged write past the free pages raises on both and touches no
    member."""
    outs = []
    for make in (
        lambda: JaxManager(
            num_layers=1, num_pages=12, page_size=4, n_kv_heads=1,
            head_dim=8, dtype=jnp.float32,
        ),
        lambda: CacheManager(1, 12, 4, 1, 8, torch.float32, device="cpu"),
    ):
        m = make()

        async def go(m=m):
            seen = []
            async with m.allocate(2, 12) as a, m.allocate(1, 16) as b:
                seen.append(m.write_slots(a, 3))
                both = m.combine_handles([a, b])
                seen.append(m.write_slots_ragged(both, [1, 5, 6]))
                m.commit(both)
                seen.append(m.write_slots_ragged(both, [2, 0, 1]))
                before = m.context_lens(both).tolist()
                with pytest.raises(Exception) as err:
                    m.write_slots_ragged(both, [1, 1, 40])
                seen.append(np.asarray(before))
                seen.append(m.context_lens(both))
                seen.append(err.type.__name__)
            return seen

        outs.append(asyncio.run(go()))
    want, got = outs
    assert got[-1] == want[-1] == "OutOfPages"
    for g, w in zip(got[:-1], want[:-1], strict=True):
        np.testing.assert_array_equal(g, w)
    assert issubclass(OutOfPages, RuntimeError)


# --------------------------------------------------------- chunked prefill
def tiny_executor(pages=64, page_size=16, max_chunk_tokens=512):
    params, client, _ = model_and_inputs()
    manager = CacheManager(
        2, pages, page_size, 2, HD, dtype=torch.float32, device="cpu"
    )
    ex = SpanExecutor(
        params_from_jax(params, device="cpu"), ModelSpec(**SPEC), manager,
        max_chunk_tokens=max_chunk_tokens, compute_dtype=torch.float32,
        device="cpu",
    )
    return manager, ex, params


def test_prefill_chunked_is_token_identical_and_rolls_back():
    assert plan_prefill_chunks(150, 100, cap=64) == [
        (0, 64), (64, 128), (128, 150)
    ]
    assert plan_prefill_chunks(150, 0) == [(0, 150)]
    manager, ex, _ = tiny_executor(pages=24, max_chunk_tokens=64)
    hidden = torch.from_numpy(
        np.random.default_rng(3).standard_normal((1, 150, 64))
        .astype(np.float32)
    )

    async def go():
        async with contextlib.AsyncExitStack() as stack:
            a, b, c = [
                await stack.enter_async_context(manager.allocate(1, n))
                for n in (160, 160, 64)
            ]
            whole = ex.prefill(a, hidden)
            chunked = ex.prefill_chunked(b, hidden, chunk_tokens=100)
            assert torch.equal(whole, chunked)
            assert manager.context_lens(b, committed_only=True).tolist() == [
                150
            ]
            # a and b hold 10 pages each of 24: c's second 64-token chunk
            # finds no pages, and every chunk of c rolls back
            free = manager.table.free_pages
            with pytest.raises(OutOfPages):
                ex.prefill_chunked(c, hidden, chunk_tokens=64)
            assert manager.context_lens(c).tolist() == [0]
            assert manager.table.free_pages == free

    asyncio.run(go())


# ----------------------------------------------------------- ragged groups
def rand_tree(rng, t):
    """A random linearized tree: node j's parent has a lower index; the mask
    row is ancestors-or-self, the depths are the rotary offsets."""
    mask = np.zeros((t, t), dtype=bool)
    depth = np.zeros((t,), dtype=np.int32)
    mask[0, 0] = True
    for j in range(1, t):
        p = int(rng.integers(0, j))
        mask[j] = mask[p]
        mask[j, j] = True
        depth[j] = depth[p] + 1
    return mask[None], depth[None]


def make_members(rng, mix):
    """(hidden, tree mask, depths) per member; contexts to prefill first."""
    members, contexts = [], []
    for kind in mix:
        contexts.append(
            (rng.standard_normal((1, int(rng.integers(4, 10)), 64)) * 0.1)
            .astype(np.float32)
        )
        t = {"decode": 1, "tree": int(rng.choice([3, 5, 7])),
             "chunk": int(rng.integers(3, 7))}[kind]
        hid = (rng.standard_normal((1, t, 64)) * 0.1).astype(np.float32)
        tm, dep = rand_tree(rng, t) if kind == "tree" else (None, None)
        members.append((hid, tm, dep))
    return members, contexts


def run_mix(manager, ex, mix, seed, solo=False, group="ragged_group"):
    """Prefill one session per member, then dispatch the members fused
    (and, with solo=True, first each alone, rewinding after each); returns
    the per-member outputs [(solo, fused)] or [fused] as numpy."""
    rng = np.random.default_rng(seed)
    members, contexts = make_members(rng, mix)

    async def go():
        async with contextlib.AsyncExitStack() as stack:
            handles = [
                await stack.enter_async_context(manager.allocate(1, 32))
                for _ in mix
            ]
            for h, ctx in zip(handles, contexts):
                ex.prefill(h, ctx)
            snaps = [[int(x) for x in manager.context_lens(h)]
                     for h in handles]
            alone = []
            if solo:
                for h, (hid, tm, dep), snap in zip(handles, members, snaps):
                    out, _ = ex.ragged_group(
                        [h], [hid], tree_masks=[tm], depths_list=[dep]
                    )
                    alone.append(np.asarray(out))
                    manager.truncate_speculative(h, snap)
            hids = [m[0] for m in members]
            if group == "decode_group":
                out, _ = ex.decode_group(handles, hids)
            else:
                out, _ = ex.ragged_group(
                    handles, hids, tree_masks=[m[1] for m in members],
                    depths_list=[m[2] for m in members],
                )
            out = np.asarray(out)
            fused, off = [], 0
            for hid in hids:
                fused.append(out[off : off + hid.shape[1]])
                off += hid.shape[1]
            return list(zip(alone, fused)) if solo else fused

    return asyncio.run(go())


@pytest.mark.parametrize("mix,group", [
    (["decode", "chunk"], "ragged_group"),
    (["decode", "tree", "chunk"], "ragged_group"),
    # the repair: decode_group takes a multi-token member as JAX's does
    (["decode", "chunk"], "decode_group"),
], ids=["decode+chunk", "decode+tree+chunk", "decode_group"])
def test_ragged_group_matches_jax(monkeypatch, mix, group):
    params, _, _ = model_and_inputs()
    jm = JaxManager(
        num_layers=2, num_pages=64, page_size=16, n_kv_heads=2, head_dim=HD,
        dtype=jnp.float32,
    )
    jex = JaxExecutor(params, JaxSpec(**SPEC), jm, compute_dtype=jnp.float32)
    want = run_mix(jm, jex, mix, seed=5, group=group)

    calls = []
    ref = t_paged.paged_ragged_attention_reference

    def counted(*a, **kw):
        calls.append(kw.get("tree_rows") is not None)
        return ref(*a, **kw)

    monkeypatch.setattr(t_paged, "paged_ragged_attention_reference", counted)
    monkeypatch.setenv("BBTPU_PAGED_MIN_CONTEXT", "0")
    manager, ex, _ = tiny_executor()
    got = run_mix(manager, ex, mix, seed=5, group=group)
    for g, w in zip(got, want, strict=True):
        np.testing.assert_allclose(
            g.reshape(w.shape), w, atol=TOL, rtol=TOL
        )
    # one ragged kernel call per layer, in the tree variant iff a tree rode
    assert calls == ["tree" in mix] * 2


@pytest.mark.parametrize("mix", [
    ["decode", "decode", "decode"],
    ["decode", "chunk"],
    ["decode", "tree"],
    ["tree", "tree", "chunk"],
    ["decode", "decode", "tree", "chunk"],
], ids=lambda m: "+".join(m))
def test_fused_matches_solo(monkeypatch, mix):
    """ONE ragged dispatch over mixed row kinds equals each member
    dispatched alone (causal rows ride the tree variant as lower-triangular
    rows), on the ragged kernel's route."""
    monkeypatch.setenv("BBTPU_PAGED_MIN_CONTEXT", "0")
    manager, ex, _ = tiny_executor(page_size=4)
    for solo, fused in run_mix(manager, ex, mix, seed=7, solo=True):
        np.testing.assert_allclose(
            solo.reshape(fused.shape), fused, atol=ATOL, rtol=ATOL
        )


def test_tree_rows_refuse_sliding_window_layers():
    """The ragged gate of this slice: tree rows need full-attention layers;
    causal ragged dispatches take sliding windows."""
    params, _, _ = model_and_inputs()
    manager = CacheManager(2, 8, 16, 2, HD, torch.float32, device="cpu")
    ex = SpanExecutor(
        params_from_jax(params, device="cpu"),
        ModelSpec(**SPEC, layer_types=("sliding", "full"), sliding_window=8),
        manager, compute_dtype=torch.float32, device="cpu",
    )
    assert ex.ragged_unsupported(has_tree=False) is None
    assert ex.ragged_unsupported(has_tree=True) == "sliding-window layers"
    with pytest.raises(ValueError, match="sliding-window"):
        ex.tree_group([], [], [], [])

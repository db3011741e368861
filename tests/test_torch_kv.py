"""The port's KV substrate vs the JAX package's on the CPU: arena ops, the
paged table and the cache manager, driven with the same calls."""

import asyncio

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bloombee_tpu.kv import arena as j_arena
from bloombee_tpu.kv.cache_manager import CacheManager as JaxManager
from bloombee_tpu.kv.paged import OutOfPages as JaxOutOfPages
from bloombee_tpu.kv.paged import PagedKVTable as JaxTable
from bloombee_tpu_torch.kv import arena as t_arena
from bloombee_tpu_torch.kv.cache_manager import (
    AllocationTimeout,
    CacheManager,
)
from bloombee_tpu_torch.kv.paged import OutOfPages, PagedKVTable


def test_arena_write_drops_out_of_bounds_slots_like_jax():
    rng = np.random.default_rng(0)
    cap, hkv, hd = 32, 2, 8
    k0 = rng.standard_normal((cap, hkv, hd)).astype(np.float32)
    v0 = rng.standard_normal((cap, hkv, hd)).astype(np.float32)
    kn = rng.standard_normal((5, hkv, hd)).astype(np.float32)
    vn = rng.standard_normal((5, hkv, hd)).astype(np.float32)
    slots = np.array([3, cap, 17, cap + 9, 31], np.int32)  # 2 padding rows
    jk, jv = j_arena.arena_write(
        *map(jnp.asarray, (k0, v0, slots, kn, vn))
    )
    tk, tv = torch.from_numpy(k0.copy()), torch.from_numpy(v0.copy())
    t_arena.arena_write(
        tk, tv, torch.from_numpy(slots), *map(torch.from_numpy, (kn, vn))
    )
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    # untouched rows stay; the three real rows landed
    np.testing.assert_array_equal(tk.numpy()[[3, 17, 31]], kn[[0, 2, 4]])


def test_gather_pages_matches_jax():
    rng = np.random.default_rng(1)
    slab = rng.standard_normal((12 * 4, 2, 8)).astype(np.float32)
    pt = np.array([[5, 0, 11], [2, 7, 1]], np.int32)
    np.testing.assert_array_equal(
        t_arena.gather_pages(
            torch.from_numpy(slab), torch.from_numpy(pt), 4
        ).numpy(),
        np.asarray(
            j_arena.gather_pages(jnp.asarray(slab), jnp.asarray(pt), 4)
        ),
    )


@pytest.mark.parametrize("seed", [0, 1])
def test_paged_table_random_ops_match_jax(seed):
    """Random write/commit/rollback/truncate/drop sequences give identical
    slots, page tables, lengths and free counts on both tables."""
    rng = np.random.default_rng(seed)
    jt, tt = JaxTable(24, 4), PagedKVTable(24, 4)
    live: list[int] = []
    for step in range(300):
        op = rng.integers(0, 6)
        if op == 0 or not live:
            sid = step
            jt.add_seq(sid)
            tt.add_seq(sid)
            live.append(sid)
            continue
        sid = int(rng.choice(live))
        if op == 1:
            n, commit = int(rng.integers(0, 9)), bool(rng.integers(0, 2))
            st = jt.seq(sid)
            if commit and st.l_acc != st.l_seq:
                commit = False
            try:
                want = jt.assign_write_slots(sid, n, commit=commit)
            except JaxOutOfPages:
                with pytest.raises(OutOfPages):
                    tt.assign_write_slots(sid, n, commit=commit)
                continue
            np.testing.assert_array_equal(
                tt.assign_write_slots(sid, n, commit=commit), want
            )
        elif op == 2:
            jt.commit(sid)
            tt.commit(sid)
        elif op == 3:
            jt.rollback(sid)
            tt.rollback(sid)
        elif op == 4:
            st = jt.seq(sid)
            length = int(rng.integers(st.l_acc, st.l_seq + 1))
            jt.truncate_speculative(sid, length)
            tt.truncate_speculative(sid, length)
        else:
            jt.drop_seq(sid)
            tt.drop_seq(sid)
            live.remove(sid)
        assert tt.free_pages == jt.free_pages
        if live:
            np.testing.assert_array_equal(
                tt.page_table(live, 8), jt.page_table(live, 8)
            )
            np.testing.assert_array_equal(
                tt.context_lens(live), jt.context_lens(live)
            )
            np.testing.assert_array_equal(
                tt.context_lens(live, committed_only=True),
                jt.context_lens(live, committed_only=True),
            )


def test_cache_manager_sequence_matches_jax():
    """allocate / write / commit / rollback / truncate / combine on both
    managers: same slots, page tables and lengths throughout."""

    async def drive(manager):
        seen = []
        async with manager.allocate(2, 40) as a, manager.allocate(1, 30) as b:
            seen.append(manager.write_slots(a, 9))
            seen.append(manager.write_slots(b, 5, commit=False))
            manager.commit(b)
            seen.append(manager.write_slots(a, 3, commit=False))
            manager.rollback(a)
            seen.append(manager.write_slots(a, 6, commit=False))
            snap = [int(x) for x in manager.context_lens(a)]
            seen.append(manager.write_slots(a, 2, commit=False))
            manager.truncate_speculative(a, snap)
            manager.commit(a)
            both = manager.combine_handles([a, b])
            seen.append(manager.write_slots(both, 1, commit=False))
            manager.commit(both)
            seen.append(manager.page_table(both, 8))
            seen.append(manager.context_lens(both))
            seen.append(manager.context_lens(both, committed_only=True))
        return seen

    kw = dict(num_layers=1, num_pages=32, page_size=4, n_kv_heads=1, head_dim=8)
    want = asyncio.run(drive(JaxManager(**kw, dtype=jnp.float32)))
    got = asyncio.run(
        drive(CacheManager(**kw, dtype=torch.float32, device="cpu"))
    )
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_cache_manager_admission_waits_then_times_out():
    manager = CacheManager(1, 4, 4, 1, 8, dtype=torch.float32, device="cpu")

    async def go():
        async with manager.allocate(1, 16):
            assert manager.tokens_left == 0
            with pytest.raises(AllocationTimeout):
                async with manager.allocate(1, 4, timeout=0.05):
                    pass
        assert manager.tokens_left == 16
        with pytest.raises(AllocationTimeout):  # can never fit
            async with manager.allocate(2, 16):
                pass

    asyncio.run(go())


def test_entry_points_refuse_cuda_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: device='cuda' is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        CacheManager(1, 4, 4, 1, 8)

"""The split chunk kernel's host side, and the decomposition it computes, on
the CPU.

The kernel runs only on the card (chip_smoke.py holds it against its plain
version there). Here: the chunk planner (`chunk_split`), the device's cut
of a unit's keys (`chunk_range`), the wrapper's checks, and a plain-torch
emulation of the kernel's decomposition (row tiles of RAGGED_ROWS // g
tokens, page-aligned key chunks walked in key tiles with one max and one
sum per tile, then the same-launch merge) against
`paged_chunk_attention_reference`. Torch only, no JAX: every case is a few
milliseconds.
"""

import numpy as np
import pytest
import torch
from test_torch_ragged_split import unit_split_merge

from bloombee_tpu_torch.ops.cuda import build
from bloombee_tpu_torch.ops.cuda import paged_attention as t_paged

SHAPES = [  # (B, T, Hkv, g, num_pages)
    (1, 32, 8, 4, 128),  # the follow-up turn: 2 row tiles
    (1, 8, 8, 4, 128),  # the tree verify: 1 row tile
    (4, 32, 8, 4, 65),  # PR 1-4's table shape
    (1, 32, 8, 4, 512),  # 8000 tokens
    (8, 64, 2, 8, 64),  # 8 row tiles of 8 tokens
    (1, 2, 1, 1, 1),  # one page: one chunk
    (3, 40, 4, 1, 5),
    (64, 64, 8, 4, 128),  # more units than the target: one chunk each
]


@pytest.mark.parametrize("b,t,hkv,g,num_pages", SHAPES)
def test_chunk_split_fills_one_wave_of_clusters(b, t, hkv, g, num_pages):
    """Row tiles of RAGGED_ROWS // g tokens; as many chunks per unit as
    keep all CTAs within CHUNK_CTAS (one wave), at least one, at most a
    cluster's CHUNK_CLUSTER and one per page."""
    chunks, tiles = t_paged.chunk_split(b, t, hkv, g, num_pages)
    assert tiles == -(-t // (t_paged.RAGGED_ROWS // g))
    units = b * tiles * hkv
    assert 1 <= chunks <= min(t_paged.CHUNK_CLUSTER, num_pages)
    assert units * chunks <= max(t_paged.CHUNK_CTAS, units)
    if chunks < min(t_paged.CHUNK_CLUSTER, num_pages):
        assert units * (chunks + 1) > t_paged.CHUNK_CTAS


@pytest.mark.parametrize("t", [32, 8])
def test_chunk_split_fills_the_card_at_b1(t):
    """The main path's two launches are B=1 over the executor's 128-page
    bucket: without the split they would have 16 and 8 CTAs; split, every
    unit gets a full cluster of chunks."""
    chunks, tiles = t_paged.chunk_split(1, t, 8, 4, 128)
    assert tiles * 8 in (16, 8)
    assert chunks == t_paged.CHUNK_CLUSTER


@pytest.mark.parametrize("chunks", [1, 3, 8, 16])
@pytest.mark.parametrize("lo,hi", [(0, 1056), (0, 1040), (37, 1000),
                                   (700, 701), (0, 16), (5, 130), (0, 8000)])
def test_chunk_range_is_page_aligned_and_covers_once(chunks, lo, hi):
    """The chunks of a unit's keys [lo, hi) start and end on page
    boundaries, cover every key of the range once, and differ by at most
    one page where the range allows."""
    ps = 16
    covered = np.zeros(hi, np.int64)
    sizes = []
    for c in range(chunks):
        klo, khi = t_paged.chunk_range(c, chunks, lo, hi, ps)
        assert klo % ps == 0 and khi % ps == 0 and klo <= khi
        a, z = max(lo, klo), min(hi, khi)
        if a < z:
            covered[a:z] += 1
            sizes.append(khi - klo)
    assert (covered[lo:] == 1).all() and not covered[:lo].any()
    pages = -(-hi // ps) - lo // ps
    assert len(sizes) == -(-pages // -(-pages // chunks))
    assert max(sizes) == -(-pages // chunks) * ps


def test_chunk_wrapper_allocates_nothing_before_its_checks():
    """A non-CUDA tensor that is not on the CPU raises before the wrapper
    checks alignment, plans, allocates or launches; the kernel needs no
    counters (its merge runs within a cluster)."""
    meta = dict(device="meta", dtype=torch.bfloat16)
    slab = torch.empty((32, 2, 64), **meta)
    pt = torch.zeros((1, 2), dtype=torch.int32, device="meta")
    lens = torch.zeros((1,), dtype=torch.int32, device="meta")
    build.reset_launch_counts()
    before = dict(t_paged._counters)
    with pytest.raises(ValueError, match="must be on CUDA"):
        t_paged.paged_chunk_attention(
            torch.empty((1, 4, 4, 64), **meta), slab, slab, pt, lens, 16
        )
    assert t_paged._counters == before
    assert not build.LAUNCHES


def chunk_split_merge(q, k_slab, v_slab, pt, lens, ps, tree_mask=None,
                      window=0, t_real=None, tk=64):
    """The chunk kernel's decomposition in plain torch: each sequence's
    tokens in row tiles of RAGGED_ROWS // g, each row tile a unit of
    `unit_split_merge` over the planned number of key chunks, cut from the
    unit's own keys by `chunk_range`. Causal rows see keys
    <= their position (> position - window when window > 0), rows >=
    t_real none; tree rows see the prefix below lens - t_real and the
    in-step keys their mask row admits."""
    b, t, h, hd = q.shape
    num_pages = pt.shape[1]
    hkv = k_slab.shape[1]
    g = h // hkv
    t_real = t if t_real is None else t_real
    chunks, tiles = t_paged.chunk_split(b, t, hkv, g, num_pages)
    tr = t_paged.RAGGED_ROWS // g
    cap = num_pages * ps
    k = t_paged._gather(k_slab, pt, ps).repeat_interleave(g, 2)
    v = t_paged._gather(v_slab, pt, ps).repeat_interleave(g, 2)
    qf = q.float() * hd**-0.5
    out = torch.zeros((b, t, h, hd))
    for s in range(b):
        length = int(lens[s])
        start = length - t_real

        def rng(qt):  # row qt's visible keys [lo, hi)
            if tree_mask is not None:
                return 0, min(length, cap)
            if qt >= t_real:
                return 0, 0
            qpos = start + qt
            lo = max(qpos + 1 - window, 0) if window > 0 else 0
            return lo, min(length, qpos + 1, cap)

        def visible(qt, pos):
            lo, hi = rng(qt)
            if pos < lo or pos >= hi:
                return False
            m = pos - start
            if tree_mask is None or m < 0:
                return True
            return m < t and bool(tree_mask[s, qt, m])

        for tile in range(tiles):
            rows = list(range(tile * tr, min(t, (tile + 1) * tr)))
            out[s, rows] = unit_split_merge(
                qf[s, rows], k[s], v[s],
                lambda x, pos: visible(rows[x], pos),
                [rng(qt) for qt in rows],
                lambda lo, hi: [t_paged.chunk_range(c, chunks, lo, hi, ps)
                                for c in range(chunks)],
                tk,
            )
    return out


def _tree_mask(rng, b, t):
    """[b, t, t] ancestor-or-self masks of random trees."""
    mask = torch.zeros((b, t, t), dtype=torch.bool)
    for s in range(b):
        parents = [-1] + [int(rng.integers(0, n)) for n in range(1, t)]
        for n in range(t):
            node = n
            while node >= 0:
                mask[s, n, node] = True
                node = parents[node]
    return mask


@pytest.mark.parametrize("tk", [8, 64])
@pytest.mark.parametrize("b", [1, 3])
@pytest.mark.parametrize("h,hkv", [(4, 4), (8, 2), (8, 1)])
@pytest.mark.parametrize("mode", ["causal", "window", "tree"])
def test_chunk_split_and_merge_equals_the_plain_chunk(mode, h, hkv, b, tk):
    """T=40 tokens with t_real 29 (a row-tile boundary inside t_real at g 4
    and 8), causal, with a window that starts mid-chunk, or tree mode
    (rows >= t_real still see the prefix and their tree row); B=1, and B=3
    with a lens-0 sequence; g 1, 4 and 8: the kernel's row tiles, key
    tiles and chunks, attended apart and merged, give the plain version's
    output, and the lens-0 sequence and causal padding rows exact zeros."""
    rng = np.random.default_rng(7)
    t, t_real, hd, ps, num_pages = 40, 29, 32, 16, 24
    k_slab, v_slab = (
        torch.from_numpy(rng.standard_normal(
            (num_pages * b * ps, hkv, hd), np.float32))
        for _ in range(2)
    )
    pt = torch.from_numpy(
        rng.permutation(num_pages * b).astype(np.int32).reshape(b, -1)
    )
    lens = torch.tensor([300, 0, 77][:b], dtype=torch.int32)
    q = torch.from_numpy(rng.standard_normal((b, t, h, hd), np.float32))
    window = 37 if mode == "window" else 0
    tree = _tree_mask(rng, b, t) if mode == "tree" else None
    chunks, tiles = t_paged.chunk_split(b, t, hkv, h // hkv, num_pages)
    assert chunks > 4
    if h // hkv > 1:
        assert t_paged.RAGGED_ROWS // (h // hkv) < t_real
    if window:  # row 0's window starts mid-page: its first chunk clipped
        assert (300 - t_real + 1 - window) % ps
    args = (q, k_slab, v_slab, pt, lens, ps)
    got = chunk_split_merge(*args, tree_mask=tree, window=window,
                            t_real=t_real, tk=tk)
    want = t_paged.paged_chunk_attention_reference(
        *args, tree_mask=tree, window=window, t_real=t_real
    )
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    if b == 3:
        assert not got[1].any()
    if tree is None:
        assert not got[:, t_real:].any()

"""The split ragged kernel's and the split int4 decode kernel's host side,
and the chunk-and-merge arithmetic they compute, on the CPU.

The kernels run only on the card (chip_smoke.py holds them against their
plain versions there). Here: the ragged planner (`ragged_split`) and the
buffers it sizes, a plain-torch emulation of the ragged kernel's
decomposition (row tiles, runs of one sequence's rows, page-aligned key
chunks walked in key tiles with one max and one sum per tile, then the
merge) against `paged_ragged_attention_reference`, the split decode
decomposition over an int4 arena against
`paged_decode_attention_int4_reference`, and the int4 and ragged wrappers'
checks. Torch only, no JAX: every case is a few milliseconds.
"""

import numpy as np
import pytest
import torch
from test_torch_decode_split import split_merge

from bloombee_tpu_torch.kv.quant import make_quant_slab, quantize
from bloombee_tpu_torch.ops.cuda import build
from bloombee_tpu_torch.ops.cuda import paged_attention as t_paged

SHAPES = [  # (num_pages, page_size, R, Hkv, g, B)
    (128, 16, 64, 8, 4, 8),  # the mixed ragged step: 4 row tiles, 5 seqs
    (128, 16, 32, 8, 4, 4),  # the tree step: 4 x 8 tree rows
    (64, 16, 1, 8, 4, 1),  # R = 1
    (64, 16, 64, 8, 1, 2),  # R = 64 at g = 1: one row tile
    (64, 16, 64, 2, 8, 16),  # R = 64 at g = 8: 8 row tiles
    (1, 16, 3, 1, 1, 1),
    (5, 32, 40, 2, 4, 6),
]


def segments(q_seq, b, tile_rows):
    """The kernel's segments of rows: [start, end) pairs, a start at every
    multiple of tile_rows and wherever the owner changes (every padding
    row, q_seq >= b, the same owner)."""
    owner = [int(s) if int(s) < b else -1 for s in q_seq]
    starts = [i for i in range(len(owner))
              if i % tile_rows == 0 or owner[i] != owner[i - 1]]
    return list(zip(starts, starts[1:] + [len(owner)]))


def cta_segments(n_segments, grid):
    """The segments each CTA along the grid's segment axis attends: CTA z
    segment z (none past the last segment), and the last CTA every segment
    past the grid as well."""
    return [[z] if z < n_segments else [] for z in range(grid - 1)] + [
        list(range(grid - 1, n_segments))
    ]


@pytest.mark.parametrize("num_pages,page_size,r,hkv,g,b", SHAPES)
def test_ragged_split_chunks_are_page_aligned_and_cover_once(
    num_pages, page_size, r, hkv, g, b
):
    chunk, chunks, segs = t_paged.ragged_split(
        num_pages, page_size, r, hkv, g, b
    )
    tile_rows = t_paged.RAGGED_ROWS // g
    # the grid's segment axis holds every packed segmentation of r rows
    # over b sequences: row tiles, plus at most one cut per sequence
    # boundary, and never more segments than rows
    assert segs == min(r, -(-r // tile_rows) + b)
    worst = [i * b // r if r > b else min(i, b) for i in range(r)]
    assert len(segments(worst, b, tile_rows)) <= segs
    assert chunk % page_size == 0 and chunk > 0
    assert 1 <= chunks <= min(num_pages, t_paged.RAGGED_MAX_CHUNKS)
    # every key of every row's range [0, capacity) in exactly one chunk
    cap = num_pages * page_size
    covered = np.zeros(cap, np.int64)
    for c in range(chunks):
        lo, hi = c * chunk, min((c + 1) * chunk, cap)
        assert lo < hi  # no chunk lies wholly past the table
        covered[lo:hi] += 1
    assert (covered == 1).all()
    want = min(-(-t_paged.RAGGED_CTAS // (segs * hkv)), num_pages,
               t_paged.RAGGED_MAX_CHUNKS)
    assert want / 2 < chunks <= want


@pytest.mark.parametrize("layout", ["interleaved", "padding_between"])
def test_segments_past_the_grid_are_walked_once(layout):
    """Rows of one sequence need not be contiguous, nor the padding rows
    last: such a layout forms more segments than the planned grid holds,
    and the grid's last CTAs walk the rest, so every segment is attended
    by exactly one CTA per (chunk, KV head), and each segment's counter
    (one per first row and KV head) is its own."""
    r, g, b = 24, 4, 4
    if layout == "interleaved":
        q_seq = [0, 1] * 8 + [2, 3] * 4
    else:
        q_seq = [0] * 5 + [9, 9] + [1] * 3 + [9] + [2] * 6 + [9] + [3] * 6
    assert len(q_seq) == r
    segs = segments(q_seq, b, t_paged.RAGGED_ROWS // g)
    grid = t_paged.ragged_split(64, 16, r, 8, g, b)[2]
    assert len(segs) > grid
    walked = sorted(z for zs in cta_segments(len(segs), grid) for z in zs)
    assert walked == list(range(len(segs)))
    firsts = [start for start, _ in segs]
    assert len(set(firsts)) == len(firsts) and max(firsts) < r


@pytest.mark.parametrize("r,g,b", [(64, 4, 8), (1, 4, 1), (64, 1, 2),
                                   (33, 8, 5)])
def test_ragged_buffers_match_the_launch_on_meta(r, g, b):
    """A launch of grid (chunks, hkv, segments) needs f32 chunk states of
    hkv*chunks*R*g*(hd+2) floats and R*hkv counters (one per first row of
    a segment and KV head), taken from the same per-(device, stream) pool
    as decode's."""
    hkv, hd, num_pages = 8, 128, 128
    q = torch.empty((r, hkv * g, hd), dtype=torch.bfloat16, device="meta")
    pt = torch.empty((b, num_pages), dtype=torch.int32, device="meta")
    try:
        chunk, chunks, segs, part, counter = t_paged.ragged_buffers(
            q, hkv, pt, 16, stream=-1
        )
        want = t_paged.ragged_split(num_pages, 16, r, hkv, g, b)
        assert (chunk, chunks, segs) == want
        assert part.dtype == torch.float32 and part.device == q.device
        assert part.shape == (hkv * chunks * r * g * (hd + 2),)
        assert counter.dtype == torch.int32
        assert counter.numel() >= r * hkv
        dq = torch.empty((2, hkv * g, hd), dtype=torch.bfloat16,
                         device="meta")
        assert t_paged.decode_buffers(dq, hkv, num_pages, 16, -1)[3] is (
            t_paged._counters[(q.device, -1)]
        )
    finally:
        t_paged._counters.pop((q.device, -1), None)


def unit_split_merge(qf, k, v, visible, spans, ranges, tk):
    """One unit of rows as the row-tile kernels' `attend_unit` computes
    it (the ragged kernel's segments, the chunk kernel's row tiles): qf
    [rows, h, hd] the scaled query rows, k / v [S, h, hd] the sequence's
    keys (heads repeated), spans each row's visible range (lo, hi) and
    visible(r, pos) its keys. No row with a key: zeros. Otherwise each
    chunk's keys (the union of the ranges within the chunk's keys
    ranges(lo, hi)[c]) walked in tiles of `tk` keys with one max and one
    sum per (row, head) and tile, and the chunks merged weighted by
    exp(m_c - m), empty ones skipped."""
    rows, h, hd = qf.shape
    neg = float("-inf")
    live = [(lo, hi) for lo, hi in spans if lo < hi]
    if not live:
        return torch.zeros((rows, h, hd))
    ulo, uhi = min(x for x, _ in live), max(y for _, y in live)
    bounds = ranges(ulo, uhi)
    chunks = len(bounds)
    m = torch.full((chunks, rows, h), neg)
    l = torch.zeros((chunks, rows, h))
    acc = torch.zeros((chunks, rows, h, hd))
    for c, (klo, khi) in enumerate(bounds):
        lo, hi = max(ulo, klo), min(uhi, khi)
        for kb in range(lo, hi, tk):
            keys = range(kb, min(kb + tk, hi))
            mask = torch.tensor(
                [[visible(r, p) for p in keys] for r in range(rows)]
            )[:, None, :]  # [rows, 1, keys]
            sc = torch.einsum(
                "rhd,khd->rhk", qf, k[kb:kb + len(keys)]
            ).masked_fill(~mask, neg)
            m_new = torch.maximum(m[c], sc.amax(-1))
            base = torch.where(m_new == neg, 0.0, m_new)
            corr = torch.exp(m[c] - base)
            p = torch.exp(sc - base[..., None])
            l[c] = l[c] * corr + p.sum(-1)
            acc[c] = acc[c] * corr[..., None] + torch.einsum(
                "rhk,khd->rhd", p, v[kb:kb + len(keys)]
            )
            m[c] = m_new
    ok = l > 0
    mx = torch.where(ok, m, neg).amax(0)
    e = torch.where(ok, torch.exp(m - mx), 0.0)
    total = (l * e).sum(0)
    merged = (acc * e[..., None]).sum(0)
    return torch.where(total[..., None] > 0,
                       merged / total.clamp_min(1e-30)[..., None], 0.0)


def ragged_split_merge(q, k_slab, v_slab, pt, lens, q_seq, q_pos, ps,
                       window=0, nt=None, tree_rows=None, tk=64):
    """The ragged kernel's decomposition in plain torch: the rows' segments
    (at most RAGGED_ROWS // g rows of one owner), attended by the CTAs of
    the planned grid (the last one also walking any past it), each
    segment a unit of `unit_split_merge`."""
    r, h, hd = q.shape
    b, num_pages = pt.shape
    hkv = k_slab.shape[1]
    g = h // hkv
    chunk, chunks, n_seg = t_paged.ragged_split(num_pages, ps, r, hkv, g, b)
    all_segs = segments(q_seq, b, t_paged.RAGGED_ROWS // g)
    segs = [all_segs[z] for zs in cta_segments(len(all_segs), n_seg)
            for z in zs]
    cap = num_pages * ps
    k = t_paged._gather(k_slab, pt, ps).repeat_interleave(g, 2)
    v = t_paged._gather(v_slab, pt, ps).repeat_interleave(g, 2)
    qf = q.float() * hd**-0.5

    def rng(i):  # (seq or -1, lo, hi, ss) of row i
        s = int(q_seq[i])
        if s >= b:
            return -1, 0, 0, cap
        length = int(lens[s])
        if tree_rows is not None:
            return s, 0, min(length, cap), length - int(nt[s])
        qpos = int(q_pos[i])
        lo = max(qpos + 1 - window, 0) if window > 0 else 0
        return s, lo, min(length, qpos + 1, cap), cap

    def visible(i, pos):
        _, lo, hi, ss = rng(i)
        if pos < lo or pos >= hi:
            return False
        m = pos - ss
        return m < 0 or (m < tree_rows.shape[1] and bool(tree_rows[i, m]))

    out = torch.zeros((r, h, hd))
    for start, end in segs:
        run = list(range(start, end))
        s = rng(start)[0]
        if s < 0:
            continue  # padding rows: zeros
        out[run] = unit_split_merge(
            qf[run], k[s], v[s], lambda x, pos: visible(run[x], pos),
            [rng(i)[1:3] for i in run],
            lambda lo, hi: [(c * chunk, min((c + 1) * chunk, cap))
                            for c in range(chunks)],
            tk,
        )
    return out


def _ragged_case(rng, tree: bool):
    """R = 40 rows at g = 4 (row tiles of 16): in causal mode 3 decode
    rows, a 20-row chunk that crosses the first tile boundary, a row of a
    lens-0 sequence and padding rows; in tree mode 3 sequences x 8 tree
    rows over long prefixes, a 1-row decode member, a lens-0 row and
    padding rows."""
    h, hkv, hd, ps, num_pages = 8, 2, 32, 16, 24
    seqs = 6
    k_slab, v_slab = (
        torch.from_numpy(rng.standard_normal(
            (num_pages * seqs * ps, hkv, hd), np.float32))
        for _ in range(2)
    )
    pt = torch.from_numpy(
        rng.permutation(num_pages * seqs).astype(np.int32).reshape(seqs, -1)
    )
    i32 = dict(dtype=torch.int32)
    if not tree:
        lens = torch.tensor([300, 17, 384, 290, 0, 1], **i32)
        q_seq = torch.tensor([0, 1, 2] + [3] * 20 + [4] + [7] * 16, **i32)
        q_pos = torch.cat([
            lens[:3] - 1, torch.arange(270, 290, **i32),
            torch.zeros((17,), **i32),
        ])
        extra = {}
    else:
        t_max = 8
        lens = torch.tensor([300, 264, 100, 151, 0, 1], **i32)
        nt = torch.tensor([8, 8, 8, 1, 0, 0], **i32)
        q_seq = torch.tensor([0] * 8 + [1] * 8 + [2] * 8 + [3, 4]
                             + [6] * 14, **i32)
        tree_rows = torch.zeros((40, t_max), **i32)
        for s in range(3):
            parents = [-1] + [int(rng.integers(0, n)) for n in range(1, 8)]
            for n in range(8):
                node = n
                while node >= 0:
                    tree_rows[8 * s + n, node] = 1
                    node = parents[node]
        tree_rows[24, 0] = 1  # the decode member: its own token
        q_pos = torch.zeros((40,), **i32)  # not read in tree mode
        extra = dict(nt=nt, tree_rows=tree_rows)
    q = torch.from_numpy(rng.standard_normal((40, h, hd), np.float32))
    return (q, k_slab, v_slab, pt, lens, q_seq, q_pos, ps), extra


@pytest.mark.parametrize("layout", ["packed", "scattered"])
@pytest.mark.parametrize("tk", [8, 64])
@pytest.mark.parametrize("mode", ["causal", "window", "tree"])
def test_ragged_split_and_merge_equals_the_plain_ragged(mode, tk, layout):
    """Causal rows (a chunk crossing a row-tile boundary), a window that
    starts mid-chunk, tree rows over long prefixes, padding rows and a
    lens-0 row, packed as the executor packs them or with the rows
    shuffled (more segments than the planned grid): the kernel's tiles,
    runs, key tiles and chunks, attended apart and merged, give the plain
    version's output, and padding and lens-0 rows exact zeros."""
    rng = np.random.default_rng(3)
    args, extra = _ragged_case(rng, tree=mode == "tree")
    window = 37 if mode == "window" else 0
    chunk, chunks, n_seg = t_paged.ragged_split(
        args[3].shape[1], args[7], 40, 2, 4, args[3].shape[0]
    )
    assert chunks > 4
    if layout == "scattered":
        perm = torch.from_numpy(rng.permutation(40))
        q, k, v, pt, lens, q_seq, q_pos, ps = args
        args = (q[perm], k, v, pt, lens, q_seq[perm], q_pos[perm], ps)
        extra = {n: x[perm] if n == "tree_rows" else x
                 for n, x in extra.items()}
        segs = segments(args[5], args[3].shape[0], t_paged.RAGGED_ROWS // 4)
        assert len(segs) > n_seg
    elif mode != "tree":  # the chunk's 20 rows cut at the row-tile edge
        segs = segments(args[5], args[3].shape[0], t_paged.RAGGED_ROWS // 4)
        assert (3, 16) in segs and (16, 23) in segs
    if window:
        assert (300 - window) % chunk  # row 0's window starts mid-chunk
    got = ragged_split_merge(*args, window=window, tk=tk, **extra)
    want = t_paged.paged_ragged_attention_reference(
        *args, window=window, **extra
    )
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    dead = [i for i in range(40) if int(args[5][i]) >= 4]
    assert not got[dead].any()


@pytest.mark.parametrize("window", [0, 300])
def test_int4_split_and_merge_equals_the_plain_int4_decode(window):
    """The split decode decomposition over an int4 arena (dequantized as
    the kernel dequantizes, code * scale + zero in f32): lens of 1, 15, 16,
    17, one chunk + 1, 0, the table's capacity and 1000, with and without a
    window that starts mid-chunk, gives the plain int4 version's output,
    and a lens=0 row exact zeros."""
    rng = np.random.default_rng(12)
    b, h, hkv, hd, ps, num_pages = 8, 8, 2, 64, 16, 64
    chunk, chunks = t_paged.decode_split(num_pages, ps, b, hkv, h // hkv)
    q = torch.from_numpy(rng.standard_normal((b, h, hd), np.float32))
    k_slab, v_slab = (
        quantize(torch.from_numpy(rng.standard_normal(
            (num_pages * b * ps, hkv, hd), np.float32)))
        for _ in range(2)
    )
    pt = torch.from_numpy(
        rng.permutation(num_pages * b).astype(np.int32).reshape(b, -1)
    )
    lens = torch.tensor([1, 15, 16, 17, chunk + 1, 0, num_pages * ps, 1000],
                        dtype=torch.int32)
    if window:
        assert (1000 - window) % chunk  # row 7's window starts mid-chunk
    got = split_merge(q, k_slab, v_slab, pt, lens, ps, window)
    want = t_paged.paged_decode_attention_int4_reference(
        q, k_slab, v_slab, pt, lens, ps, window=window
    )
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    assert not got[5].any()


@pytest.mark.parametrize("kernel", ["int4", "ragged"])
def test_split_wrappers_allocate_nothing_before_their_checks(kernel):
    """A non-CUDA tensor that is not on the CPU raises before the wrapper
    checks alignment, plans, allocates counters or launches."""
    meta = dict(device="meta", dtype=torch.bfloat16)
    pt = torch.zeros((1, 2), dtype=torch.int32, device="meta")
    lens = torch.zeros((1,), dtype=torch.int32, device="meta")
    build.reset_launch_counts()
    before = dict(t_paged._counters)
    with pytest.raises(ValueError, match="must be on CUDA"):
        if kernel == "int4":
            slab = make_quant_slab((32, 2, 64), device="meta")
            t_paged.paged_decode_attention_int4(
                torch.empty((1, 4, 64), **meta), slab, slab, pt, lens, 16
            )
        else:
            slab = torch.empty((32, 2, 64), **meta)
            rows = torch.zeros((3,), dtype=torch.int32, device="meta")
            t_paged.paged_ragged_attention(
                torch.empty((3, 4, 64), **meta), slab, slab, pt, lens, rows,
                rows, 16,
            )
    assert t_paged._counters == before
    assert not build.LAUNCHES


def test_alignment_check_names_the_misaligned_tensor():
    """The split kernels copy whole rows with cp.async: the wrappers'
    alignment check raises on a tensor that starts off the copy size
    (int4 codes 16 bytes, scale and zero hd/16 bytes) and passes aligned
    ones."""
    slab = quantize(torch.zeros((64, 2, 128)))
    t_paged._aligned("k", (("codes", slab.codes),), 16)
    t_paged._aligned("k", (("scale", slab.scale), ("zero", slab.zero)), 8)
    codes = slab.codes.flatten()[8:]  # 8 bytes in
    with pytest.raises(ValueError, match="codes must be 16-byte aligned"):
        t_paged._aligned("k", (("codes", codes),), 16)
    scale = slab.scale.flatten()[2:]  # 4 bytes in
    with pytest.raises(ValueError, match="scale must be 8-byte aligned"):
        t_paged._aligned("k", (("scale", scale),), 8)

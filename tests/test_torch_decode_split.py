"""The split decode kernel's host side, and the arithmetic both redesigned
kernels rest on, on the CPU.

The kernels themselves run only on the card (chip_smoke.py holds them
against their plain versions there). Here: the chunk planner
(`decode_split`) and the launch buffers it sizes (`decode_buffers`), the
chunk-and-merge decomposition the decode kernel computes, and the flash
kernel's choice of a two-term bf16 P for its P.V product. Torch only, no
JAX: every case is a few milliseconds.
"""

import numpy as np
import pytest
import torch

from bloombee_tpu_torch.ops.cuda import build
from bloombee_tpu_torch.ops.cuda import flash_attention as t_flash
from bloombee_tpu_torch.ops.cuda import paged_attention as t_paged

SHAPES = [  # (num_pages, page_size, B, Hkv)
    (64, 16, 4, 8),  # the serving decode step: 8 chunks of 128 keys
    (500, 16, 1, 8),  # one long context: 32 chunks
    (64, 16, 64, 8),  # enough sequences to fill the card: one chunk
    (1, 16, 1, 1),
    (7, 16, 2, 2),  # fewer pages than wanted chunks: one page each
    (65, 16, 4, 8),  # pages not a multiple of the chunk
    (33, 32, 3, 4),
]


@pytest.mark.parametrize("num_pages,page_size,b,hkv", SHAPES)
def test_decode_split_chunks_are_page_aligned_and_cover_once(
    num_pages, page_size, b, hkv
):
    chunk, chunks = t_paged.decode_split(num_pages, page_size, b, hkv, 4)
    cap = num_pages * page_size
    assert chunk % page_size == 0 and chunk > 0
    assert 1 <= chunks <= num_pages
    # chunk c holds keys [c * chunk, (c + 1) * chunk) clipped to the table
    covered = np.zeros(cap, np.int64)
    for c in range(chunks):
        lo, hi = c * chunk, min((c + 1) * chunk, cap)
        assert lo < hi  # no chunk lies wholly past the table
        covered[lo:hi] += 1
    assert (covered == 1).all()
    # the chunks wanted to fill SPLIT_CTAS CTAs (one per page at most):
    # never more, and at least half of them after rounding to whole pages
    want = min(-(-t_paged.SPLIT_CTAS // (b * hkv)), num_pages)
    assert want / 2 < chunks <= want


@pytest.mark.parametrize("num_pages,page_size,b,hkv", SHAPES[:3])
def test_decode_buffers_match_the_launch_on_meta(num_pages, page_size, b,
                                                 hkv):
    """The scratch and counters a launch of grid (chunks, hkv, B) needs,
    sized from the shapes alone: f32 chunk states of B*hkv*chunks*g*(hd+2)
    floats (none for one chunk), int32 counters for every (sequence, KV
    head), on q's device."""
    g, hd = 4, 128
    q = torch.empty((b, hkv * g, hd), dtype=torch.bfloat16, device="meta")
    chunk, chunks, part, counter = t_paged.decode_buffers(
        q, hkv, num_pages, page_size, stream=-1
    )
    try:
        assert (chunk, chunks) == t_paged.decode_split(
            num_pages, page_size, b, hkv, g
        )
        if chunks == 1:
            assert part is None
        else:
            assert part.dtype == torch.float32 and part.device == q.device
            assert part.shape == (b * hkv * chunks * g * (hd + 2),)
        assert counter.dtype == torch.int32 and counter.device == q.device
        assert counter.dim() == 1 and counter.numel() >= b * hkv
        # the counters are kept per (device, stream) and reused
        again = t_paged.decode_buffers(q, hkv, num_pages, page_size, -1)[3]
        assert again is counter
    finally:
        t_paged._counters.pop((q.device, -1), None)


def test_decode_wrapper_allocates_nothing_before_its_checks():
    """A non-CUDA tensor that is not on the CPU raises before the wrapper
    plans, allocates counters or launches."""
    meta = dict(device="meta", dtype=torch.bfloat16)
    slab = torch.empty((32, 2, 64), **meta)
    pt = torch.zeros((1, 2), dtype=torch.int32, device="meta")
    lens = torch.zeros((1,), dtype=torch.int32, device="meta")
    build.reset_launch_counts()
    before = dict(t_paged._counters)
    with pytest.raises(ValueError, match="must be on CUDA"):
        t_paged.paged_decode_attention(
            torch.empty((1, 4, 64), **meta), slab, slab, pt, lens, 16
        )
    assert t_paged._counters == before
    assert not build.LAUNCHES


def split_merge(q, k_slab, v_slab, page_table, lens, page_size, window):
    """The decode kernel's decomposition in plain torch: every (sequence,
    chunk) attends only its chunk's visible keys to an (m, l, acc) state,
    then the chunks merge weighted by exp(m_c - m), empty ones skipped."""
    b, h, hd = q.shape
    hkv = k_slab.shape[1]
    num_pages = page_table.shape[1]
    chunk, chunks = t_paged.decode_split(num_pages, page_size, b, hkv,
                                         h // hkv)
    k = t_paged._gather(k_slab, page_table, page_size)  # [B, S, Hkv, hd]
    v = t_paged._gather(v_slab, page_table, page_size)
    k, v = (x.repeat_interleave(h // hkv, 2) for x in (k, v))
    out = torch.zeros((b, h, hd))
    for r in range(b):
        length = int(lens[r])
        lo_row = max(length - window, 0) if window > 0 else 0
        hi_row = min(length, num_pages * page_size)
        m = torch.full((chunks, h), float("-inf"))
        l = torch.zeros((chunks, h))
        acc = torch.zeros((chunks, h, hd))
        for c in range(chunks):
            lo, hi = max(lo_row, c * chunk), min(hi_row, (c + 1) * chunk)
            if lo >= hi:
                continue  # empty state: m = -inf, l = 0
            s = torch.einsum("hd,shd->hs", q[r] * hd**-0.5, k[r, lo:hi])
            m[c] = s.amax(-1)
            p = torch.exp(s - m[c][:, None])
            l[c] = p.sum(-1)
            acc[c] = torch.einsum("hs,shd->hd", p, v[r, lo:hi])
        live = l > 0
        mx = torch.where(live, m, float("-inf")).amax(0)
        e = torch.where(live, torch.exp(m - mx), 0.0)
        total = (l * e).sum(0)
        merged = (acc * e[:, :, None]).sum(0)
        out[r] = torch.where(total[:, None] > 0,
                             merged / total.clamp_min(1e-30)[:, None], 0.0)
    return out


@pytest.mark.parametrize("window", [0, 300])
def test_split_and_merge_equals_the_plain_decode(window):
    """Lens of 1, 15, 16, 17, one chunk + 1, 0, the table's capacity and
    1000, with and without a window that starts mid-chunk: the planner's
    chunks, attended apart and merged, give the plain version's output,
    and a lens=0 row exact zeros."""
    rng = np.random.default_rng(11)
    b, h, hkv, hd, ps, num_pages = 8, 8, 2, 32, 16, 64
    chunk, chunks = t_paged.decode_split(num_pages, ps, b, hkv, h // hkv)
    assert chunks > 4
    q = torch.from_numpy(rng.standard_normal((b, h, hd), np.float32))
    k_slab, v_slab = (
        torch.from_numpy(
            rng.standard_normal((num_pages * b * ps, hkv, hd), np.float32)
        )
        for _ in range(2)
    )
    pt = torch.from_numpy(
        rng.permutation(num_pages * b).astype(np.int32).reshape(b, -1)
    )
    lens = torch.tensor([1, 15, 16, 17, chunk + 1, 0, num_pages * ps, 1000],
                        dtype=torch.int32)
    got = split_merge(q, k_slab, v_slab, pt, lens, ps, window)
    want = t_paged.paged_decode_attention_reference(
        q, k_slab, v_slab, pt, lens, ps, window=window
    )
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    assert not got[5].any()


def tiled_flash_bf16(q, k, v, starts, lens, p_terms, block_k=64):
    """The bf16 flash kernel's arithmetic in plain torch: f32 scores and
    online softmax over 64-key tiles, the P.V product over P as `p_terms`
    bf16 terms (hi, then hi + lo) with f32 sums, the output rounded to
    bf16."""
    b, t, h, hd = q.shape
    s, hkv = k.shape[1], k.shape[2]
    kf, vf = (x.float().repeat_interleave(h // hkv, 2) for x in (k, v))
    logits = torch.einsum("bthd,bshd->bhts", q.float(), kf) * hd**-0.5
    kpos = torch.arange(s)
    qpos = starts.long()[:, None] + torch.arange(t)
    mask = (kpos[None, None] < lens.long()[:, None, None]) & (
        kpos[None, None] <= qpos[:, :, None]
    )
    logits = logits.masked_fill(~mask[:, None], float("-inf"))
    out = torch.zeros((b, h, t, hd))
    m = torch.full((b, h, t, 1), float("-inf"))
    l = torch.zeros((b, h, t, 1))
    for k0 in range(0, s, block_k):
        tile = logits[..., k0:k0 + block_k]
        m_new = torch.maximum(m, tile.amax(-1, keepdim=True))
        base = torch.where(m_new == float("-inf"), 0.0, m_new)
        corr = torch.exp(m - base)
        p = torch.exp(tile - base)
        l = l * corr + p.sum(-1, keepdim=True)
        hi = p.bfloat16().float()
        p_used = hi if p_terms == 1 else hi + (p - hi).bfloat16().float()
        out = out * corr + torch.einsum(
            "bhts,bshd->bhtd", p_used, vf[:, k0:k0 + block_k]
        )
        m = m_new
    out = torch.where(l > 0, out / l.clamp_min(1e-30), 0.0)
    return out.permute(0, 2, 1, 3).bfloat16()


def test_flash_bf16_needs_a_two_term_p_for_the_elementwise_limit():
    """chip_smoke holds the bf16 kernel to max |err| <= 2e-2 and every
    element within 1e-2 |plain| + 1e-3. Rows that see few keys (a causal
    chunk from position 0) break the element limit when P enters P.V as
    one bf16 term, as SDPA rounds it; P as hi + lo bf16 terms (the
    kernel's choice) keeps every element well inside it."""
    rng = np.random.default_rng(0)
    b, t, s, h, hkv, hd = 4, 64, 64, 8, 2, 64
    q, k, v = (
        torch.from_numpy(rng.standard_normal(shape, np.float32)).bfloat16()
        for shape in ((b, t, h, hd), (b, s, hkv, hd), (b, s, hkv, hd))
    )
    starts = torch.zeros((b,), dtype=torch.int32)  # row i sees i + 1 keys
    lens = torch.full((b,), s, dtype=torch.int32)
    want = t_flash.flash_attention_reference(
        q, k, v, True, None, starts, lens
    ).float()

    def worst(p_terms):
        got = tiled_flash_bf16(q, k, v, starts, lens, p_terms).float()
        assert (got - want).abs().max() <= 2e-2
        return ((got - want).abs() / (1e-2 * want.abs() + 1e-3)).max().item()

    assert worst(1) > 1.0
    assert worst(2) < 0.8

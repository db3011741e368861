"""The paged attention kernels for Hopper and their plain PyTorch versions:
`csrc/paged_decode.cu` (decode over a dense or an int4 arena),
`csrc/paged_ragged.cu` and `csrc/paged_attention.cu` (chunk), all split
over keys on the body of `csrc/paged_split.cuh`, the last two through the
row-tile body of `csrc/paged_rows.cuh`.

Replaces, in bloombee_tpu/ops/pallas/paged_attention.py:

- `paged_decode_attention`: T=1 attention straight off the paged arena. The
  decode query sits at position lens[b]-1 and sees keys at positions
  < lens[b] (and >= lens[b]-window when window > 0). Its kernel splits each
  sequence's keys into page-aligned chunks (`decode_split`, planned on the
  host from the table's shape) and merges them in the same launch.
- `paged_decode_attention_int4`: the same over an int4-quantized arena
  (`kv.quant.QuantSlab`), dequantized as it is read, on the same split
  kernel body and plan.
- `paged_chunk_attention`: T>1 steps (short follow-up chunks, tree verify).
  The step's tokens sit at [lens[b]-t_real, lens[b]). Causal mode takes an
  optional per-query window and treats query rows >= t_real as padding;
  tree mode keeps the committed prefix fully visible and lets a [T, T] tree
  mask govern the in-step keys. Its kernel cuts each sequence's rows into
  tiles of RAGGED_ROWS // g tokens that share every staged K/V tile (a
  group wider than RAGGED_ROWS into head tiles first: `head_tiles`), and
  each tile's keys into page-aligned chunks (`chunk_split`, `chunk_range`)
  merged within a thread block cluster.
- `paged_ragged_attention`: R query rows spread unevenly over B sequences
  in one launch. Row i belongs to sequence q_seq[i] at position q_pos[i]
  (q_seq >= B: a padding row). Causal mode: keys at positions < lens[b]
  and <= q_pos, with an optional window. Tree mode: keys below
  lens[b] - nt[b] (the committed prefix) are visible, and the m-th
  in-step key iff tree_rows[i, m]. Its kernel splits the keys like decode
  and the rows into segments of one sequence (`ragged_split`), the rows of
  a segment sharing every K/V tile it reads. Any layout of q_seq is
  computed right; the kernel is fast when each sequence's rows are
  contiguous and the padding rows come last, as the executor packs them.

All read keys only through the page table, keep the softmax and the P.V
sum in f32 (as the Pallas kernels do), and output zeros for a row with no
visible key. Query head h reads KV head h // g for any group g = H / Hkv,
as the Pallas kernels do: every kernel takes the group at run time, in
head tiles (`decode_tiles`, `head_tiles`).
Each wrapper runs its plain version for tensors on the CPU and its kernel
for CUDA tensors; it never falls back.
"""

from __future__ import annotations

import ctypes

import torch

from bloombee_tpu_torch.kv.quant import QuantSlab, dequantize, take
from bloombee_tpu_torch.ops.attention import NEG_INF, repeat_kv
from bloombee_tpu_torch.ops.cuda import build

SOURCE = "paged_attention"
DECODE_SOURCE = "paged_decode"
RAGGED_SOURCE = "paged_ragged"
DECODE = "paged_decode_attention"
INT4 = "paged_decode_attention_int4"
CHUNK = "paged_chunk_attention"
RAGGED = "paged_ragged_attention"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128)
# the decode kernels' widest head tile (DECODE_TILE in csrc/paged_decode.cu)
DECODE_TILE = 16
_libs: dict = {}
# CTAs the split decode kernel aims for: two per SM of an H100's 132
SPLIT_CTAS = 264
# the ragged kernel: CTAs it aims for; it and the chunk kernel: the plan's
# view of their limits (QROWS and MAX_CHUNKS in csrc/paged_rows.cuh): the
# most query rows (rows x g) of a unit, which sizes the ragged grid's
# segment axis (too small a grid stays right, only slower) and the chunk
# kernel's row tiles, and the ragged kernel's most chunks (it refuses more)
RAGGED_CTAS = 528
RAGGED_ROWS = 64
RAGGED_MAX_CHUNKS = 64
# the chunk kernel: the most chunks per unit, its cluster size (MAX_CLUSTER
# in csrc/paged_attention.cu: the portable cluster size, which the C entry
# point does not exceed), and the CTAs it aims for: what one wave of its
# clusters holds at two CTAs an SM (an H100's
# cudaOccupancyMaxActiveClusters: 62 clusters of 4, 30 of 8)
CHUNK_CLUSTER = 8
CHUNK_CTAS = 240
# per (device, stream): the split kernels' int32 counters, zeroed once when
# allocated and shared by every split launch on that stream (launches on
# one stream run in order); every launch leaves them at zero again
_counters: dict = {}


def supports(h: int, hkv: int, hd: int, dtype) -> bool:
    """Whether the paged kernels (decode, int4 decode, chunk, ragged) take
    this head geometry and dtype: the domain `_check` enforces at launch,
    and the gate the executor routes by. Any GQA group H/Hkv, as the
    Pallas kernels."""
    return (
        dtype in _DTYPES
        and hd in _HEAD_DIMS
        and hkv > 0
        and h % hkv == 0
    )


def decode_tiles(group: int) -> tuple[int, int]:
    """The decode kernels' head tiles of one KV head's `group` query heads:
    (tiles, heads a tile): tiles of the least power of two >= group, at
    most DECODE_TILE heads, the last one masked (a group of 3 is one tile
    of 4; Falcon-7B's 71 five of 16). `decode_tile_width` and
    `split_decode_kernel` in csrc/paged_decode.cu."""
    width = min(1 << (group - 1).bit_length(), DECODE_TILE)
    return -(-group // width), width


def head_tiles(group: int) -> tuple[int, int]:
    """The chunk and ragged kernels' head tiles of one KV head's `group`
    query heads: (tiles, heads a tile): ceil(group / RAGGED_ROWS) tiles of
    ceil(group / tiles) heads, the last one short (one tile for a group of
    at most RAGGED_ROWS; Falcon-7B's 71 as 36 + 35). A unit's rows are
    RAGGED_ROWS // (heads a tile) tokens. `head_tile_count` and
    `head_tile_width` in csrc/paged_rows.cuh."""
    tiles = -(-group // RAGGED_ROWS)
    return tiles, -(-group // tiles)


def _gather(slab, page_table, page_size):
    """[B, NP * page_size, Hkv, hd] f32: each row's pages of a dense slab
    or, dequantized, of a QuantSlab."""
    b = page_table.shape[0]
    slots = (
        page_table.long()[:, :, None] * page_size
        + torch.arange(page_size, device=page_table.device)
    ).reshape(b, -1)
    if isinstance(slab, QuantSlab):
        return dequantize(take(slab, slots), torch.float32)
    return slab[slots].float()


def _softmax_pv(logits, mask, v):
    """Masked f32 softmax then P.V with zeros for fully masked rows:
    logits [B, H, T, S], mask broadcastable to it, v [B, S, H, hd]."""
    logits = logits.masked_fill(~mask, NEG_INF)
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.exp(logits - m) * mask
    denom = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    out = torch.einsum("bhts,bshd->bthd", p, v)
    return out / denom.permute(0, 2, 1, 3)


def paged_chunk_attention_reference(
    q: torch.Tensor,  # [B, T, H, hd]
    k_slab: torch.Tensor,  # [S_tot, Hkv, hd]
    v_slab: torch.Tensor,
    page_table: torch.Tensor,  # [B, NP] i32
    lens: torch.Tensor,  # [B] i32, including the step's tokens
    page_size: int,
    tree_mask: torch.Tensor | None = None,  # [B, T, T] bool (tree mode)
    scale: float | None = None,
    window: int = 0,
    t_real: int | None = None,
) -> torch.Tensor:
    """Plain PyTorch version of the chunk kernel: gather the pages, then the
    kernel's masks over a materialized [B, H, T, S] logit tensor."""
    b, t, h, hd = q.shape
    hkv = k_slab.shape[1]
    if scale is None:
        scale = hd**-0.5
    if t_real is None:
        t_real = t
    k = repeat_kv(_gather(k_slab, page_table, page_size), h // hkv)
    v = repeat_kv(_gather(v_slab, page_table, page_size), h // hkv)
    s = k.shape[1]
    dev = q.device
    lens = lens.long()
    start = lens - t_real  # [B]
    pos = torch.arange(s, device=dev)
    qt = torch.arange(t, device=dev)
    valid = pos[None, None, :] < lens[:, None, None]  # [B, 1, S]
    if tree_mask is None:
        q_pos = start[:, None] + qt[None, :]  # [B, T]
        mask = (
            valid
            & (pos[None, None, :] <= q_pos[:, :, None])
            & (qt < t_real)[None, :, None]
        )
        if window > 0:
            mask = mask & (pos[None, None, :] > q_pos[:, :, None] - window)
    else:
        rel = pos[None, :] - start[:, None]  # [B, S] in-step key index
        in_step = (rel >= 0) & (rel < t)
        tree_on_keys = torch.gather(
            tree_mask.bool(), 2, rel.clamp(0, t - 1)[:, None, :].expand(b, t, s)
        )  # [B, T, S]
        mask = valid & (
            (pos[None, None, :] < start[:, None, None])
            | (in_step[:, None, :] & tree_on_keys)
        )
    logits = torch.einsum("bthd,bshd->bhts", q.float() * scale, k)
    return _softmax_pv(logits, mask[:, None], v).to(q.dtype)


def paged_decode_attention_reference(
    q: torch.Tensor,  # [B, H, hd]
    k_slab: torch.Tensor,  # [S_tot, Hkv, hd]
    v_slab: torch.Tensor,
    page_table: torch.Tensor,  # [B, NP] i32
    lens: torch.Tensor,  # [B] i32, including this token
    page_size: int,
    scale: float | None = None,
    window: int = 0,
) -> torch.Tensor:
    """Plain PyTorch version of the decode kernel: a one-token causal chunk
    (query at lens-1, window counted back from it)."""
    return paged_chunk_attention_reference(
        q[:, None], k_slab, v_slab, page_table, lens, page_size,
        scale=scale, window=window, t_real=1,
    )[:, 0]


def paged_decode_attention_int4_reference(
    q: torch.Tensor,  # [B, H, hd]
    k_slab: QuantSlab,  # codes [S_tot, Hkv, hd/2] u8, scale/zero f16
    v_slab: QuantSlab,
    page_table: torch.Tensor,  # [B, NP] i32
    lens: torch.Tensor,  # [B] i32, including this token
    page_size: int,
    scale: float | None = None,
    window: int = 0,
) -> torch.Tensor:
    """Plain PyTorch version of the int4 decode kernel: the decode plain
    version over the dequantized (f32) pages."""
    return paged_decode_attention_reference(
        q, k_slab, v_slab, page_table, lens, page_size, scale, window
    )


def paged_ragged_attention_reference(
    q: torch.Tensor,  # [R, H, hd]
    k_slab: torch.Tensor,  # [S_tot, Hkv, hd]
    v_slab: torch.Tensor,
    page_table: torch.Tensor,  # [B, NP] i32
    lens: torch.Tensor,  # [B] i32, including each sequence's new tokens
    q_seq: torch.Tensor,  # [R] i32 owning sequence (>= B: padding row)
    q_pos: torch.Tensor,  # [R] i32 position of each row
    page_size: int,
    scale: float | None = None,
    window: int = 0,
    nt: torch.Tensor | None = None,  # [B] i32 in-step tokens (tree mode)
    tree_rows: torch.Tensor | None = None,  # [R, t_max] (tree mode)
) -> torch.Tensor:
    """Plain PyTorch version of the ragged kernel: each row gathers its own
    sequence's pages and applies the kernel's mask over [R, H, 1, S]
    logits."""
    r, h, hd = q.shape
    b = page_table.shape[0]
    hkv = k_slab.shape[1]
    if scale is None:
        scale = hd**-0.5
    live = q_seq.long() < b
    seq = torch.where(live, q_seq.long(), 0)
    k = repeat_kv(_gather(k_slab, page_table[seq], page_size), h // hkv)
    v = repeat_kv(_gather(v_slab, page_table[seq], page_size), h // hkv)
    pos = torch.arange(k.shape[1], device=q.device)[None, :]  # [1, S]
    length = lens.long()[seq][:, None]  # [R, 1]
    mask = live[:, None] & (pos < length)
    if tree_rows is None:
        qp = q_pos.long()[:, None]
        mask = mask & (pos <= qp)
        if window > 0:
            mask = mask & (pos > qp - window)
    else:
        t_max = tree_rows.shape[1]
        m = pos - (length - nt.long()[seq][:, None])  # in-step slot index
        in_step = (m >= 0) & (m < t_max)
        vis = torch.gather(tree_rows.long(), 1, m.clamp(0, t_max - 1)) > 0
        mask = mask & ((m < 0) | (in_step & vis))
    logits = torch.einsum("rhd,rshd->rhs", q.float() * scale, k)[:, :, None]
    out = _softmax_pv(logits, mask[:, None, None], v)  # [R, 1, H, hd]
    return out[:, 0].to(q.dtype)


def _library(source: str):
    lib = _libs.get(source)
    if lib is not None:
        return lib
    lib = build.library(source)
    vp, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    split = [
        vp, vp,  # part, counter
        i32, i32, i32, i32, i32, i32, i32,  # B, H, Hkv, hd, NP, ps, window
        i32, i32,  # chunk, chunks
        f32, i32, vp,  # scale, dtype, stream
    ]
    if source == DECODE_SOURCE:
        lib.bb_paged_decode_attention.argtypes = [
            vp, vp, vp, vp, vp, vp,  # q, k_slab, v_slab, page_table, lens, out
            *split,
        ]
        lib.bb_paged_decode_attention_int4.argtypes = [
            vp, vp, vp, vp,  # q, k_slab codes, scale, zero
            vp, vp, vp,  # v_slab codes, scale, zero
            vp, vp, vp,  # page_table, lens, out
            *split,
        ]
        fns = (lib.bb_paged_decode_attention,
               lib.bb_paged_decode_attention_int4)
    elif source == SOURCE:
        lib.bb_paged_chunk_attention.argtypes = [
            vp, vp, vp, vp, vp, vp, vp,  # q, k, v, page_table, lens, tree, out
            i32, i32, i32, i32, i32, i32, i32, i32, i32,  # B T H Hkv hd NP
            # ps window t_real
            i32,  # chunks
            f32, i32, vp,  # scale, dtype, stream
        ]
        fns = (lib.bb_paged_chunk_attention,)
    else:
        lib.bb_paged_ragged_attention.argtypes = [
            vp, vp, vp, vp, vp,  # q, k_slab, v_slab, page_table, lens
            vp, vp, vp, vp, vp,  # q_seq, q_pos, nt, tree_rows, out
            vp, vp,  # part, counter
            i32, i32, i32, i32, i32, i32, i32, i32, i32, i32,  # R B H Hkv
            # hd NP ps window t_max chunk
            i32, i32,  # chunks, segments
            f32, i32, vp,  # scale, dtype, stream
        ]
        fns = (lib.bb_paged_ragged_attention,)
    for fn in fns:
        fn.restype = i32
    _libs[source] = lib
    return lib


def _check(kernel, q, k_slab, v_slab, page_table, lens, page_size, b=None):
    """Validate a launch's arguments (`b`: the page table's rows, q's
    leading dim unless given); raise on anything the kernel does not take."""
    h, hd = q.shape[-2], q.shape[-1]
    b = q.shape[0] if b is None else b
    if q.device.type != "cuda":
        raise ValueError(f"{kernel}: tensors must be on CUDA, not {q.device}")
    if q.dtype not in _DTYPES:
        raise ValueError(f"{kernel}: dtype {q.dtype} not in {list(_DTYPES)}")
    if hd not in _HEAD_DIMS:
        raise ValueError(f"{kernel}: head_dim {hd} not in {_HEAD_DIMS}")
    if isinstance(k_slab, QuantSlab):
        s_tot, hkv = k_slab.codes.shape[:2]
        want = {
            "codes": ((s_tot, hkv, hd // 2), torch.uint8),
            "scale": ((s_tot, hkv, hd // 32), torch.float16),
            "zero": ((s_tot, hkv, hd // 32), torch.float16),
        }
        leaves = []
        for side, slab in (("k", k_slab), ("v", v_slab)):
            if not isinstance(slab, QuantSlab):
                raise ValueError(f"{kernel}: {side}_slab must be a QuantSlab")
            for name, x in slab._asdict().items():
                if (tuple(x.shape), x.dtype) != want[name]:
                    raise ValueError(
                        f"{kernel}: {side}_slab.{name} {tuple(x.shape)} "
                        f"{x.dtype}, want {want[name]}"
                    )
                leaves.append((f"{side}_slab.{name}", x))
    else:
        if (k_slab.dim() != 3 or k_slab.shape[2] != hd
                or k_slab.shape != v_slab.shape):
            raise ValueError(
                f"{kernel}: slab {tuple(k_slab.shape)} vs hd {hd}"
            )
        s_tot, hkv = k_slab.shape[:2]
        leaves = [("k_slab", k_slab), ("v_slab", v_slab)]
        for name, x in leaves:
            if x.dtype != q.dtype:
                raise ValueError(f"{kernel}: {name} must match q's dtype")
    if hkv == 0 or h % hkv:
        raise ValueError(f"{kernel}: H = {h} is not a multiple of "
                         f"Hkv = {hkv}")
    if s_tot % page_size:
        raise ValueError(f"{kernel}: arena slots % page_size {page_size}")
    if page_table.dim() != 2 or page_table.shape[0] != b:
        raise ValueError(f"{kernel}: page_table must be [B, NP]")
    for name, x in (("page_table", page_table), ("lens", lens)):
        if x.dtype != torch.int32:
            raise ValueError(f"{kernel}: {name} must be int32")
    if lens.shape != (b,):
        raise ValueError(f"{kernel}: lens must be [B]")
    for name, x in (("q", q), *leaves, ("page_table", page_table),
                    ("lens", lens)):
        if x.device != q.device:
            raise ValueError(f"{kernel}: {name} must be on q's device")
        if not x.is_contiguous():
            raise ValueError(f"{kernel}: {name} must be contiguous")


def _scale(scale, hd) -> float:
    return float(hd**-0.5 if scale is None else scale)


def _stream(q) -> int:
    return torch.cuda.current_stream(q.device).cuda_stream


def decode_split(
    num_pages: int, page_size: int, b: int, hkv: int, group: int
) -> tuple[int, int]:
    """The split decode kernel's plan: (chunk_keys, chunks). Each sequence's
    key range [0, num_pages * page_size) is cut into `chunks` chunks of
    `chunk_keys` keys, a whole number of pages each (the last may run past
    the range: the kernel clips it), enough that the b * hkv * tiles *
    chunks CTAs (`decode_tiles(group)`) fill SPLIT_CTAS, and at most one
    chunk per page. A function of the shapes alone: the host never reads
    lens from the device."""
    num_pages = max(num_pages, 1)
    units = b * hkv * decode_tiles(group)[0]
    want = min(max(1, -(-SPLIT_CTAS // units)), num_pages)
    pages = -(-num_pages // want)
    return pages * page_size, -(-num_pages // pages)


def _counter(device, stream, n: int) -> torch.Tensor:
    """The split kernels' int32 counters of (device, stream): >= n, zero
    between launches; grown (a new zeroed tensor) when a launch needs
    more."""
    key = (device, stream)
    counter = _counters.get(key)
    if counter is None or counter.numel() < n:
        counter = torch.zeros((n,), dtype=torch.int32, device=device)
        _counters[key] = counter
    return counter


def decode_buffers(q, hkv, num_pages, page_size, stream):
    """(chunk_keys, chunks, part, counter) for one split decode launch of
    grid (chunks, hkv * tiles, B), (tiles, width) = `decode_tiles(g)`:
    `part` (f32, one launch's chunk states, None when chunks == 1) holds
    B*hkv*tiles*chunks*width*(hd+2) floats, allocated per call; `counter`
    (int32, >= B*hkv*tiles, zero) is kept per (device, stream) and grows
    when a launch needs more."""
    b, h, hd = q.shape
    tiles, width = decode_tiles(h // hkv)
    chunk, chunks = decode_split(num_pages, page_size, b, hkv, h // hkv)
    part = None
    if chunks > 1:
        part = torch.empty(
            (b * hkv * tiles * chunks * width * (hd + 2),),
            dtype=torch.float32, device=q.device,
        )
    return chunk, chunks, part, _counter(q.device, stream, b * hkv * tiles)


def ragged_split(
    num_pages: int, page_size: int, r: int, hkv: int, group: int, b: int
) -> tuple[int, int, int]:
    """The ragged kernel's plan: (chunk_keys, chunks, segments). The kernel
    cuts the group into head tiles (`head_tiles`: (tiles, width)) and the
    rows into segments of at most tr = RAGGED_ROWS // width rows of one
    sequence; `segments` = min(r, ceil(r / tr) + b), its grid's segment
    axis, bounds how many the r rows of b sequences form when each
    sequence's rows are contiguous and the padding rows come last (more
    segments are walked by the grid's last CTAs, one after another). The
    key range [0, num_pages * page_size) is cut into `chunks` chunks of
    `chunk_keys` keys, a whole number of pages each (the last may run past
    the range: the kernel clips it), enough that segments * hkv * tiles *
    chunks CTAs fill RAGGED_CTAS, at most one chunk per page and at most
    RAGGED_MAX_CHUNKS. A function of the shapes alone: the host never
    reads lens, q_seq or q_pos."""
    r = max(r, 1)
    tiles, width = head_tiles(group)
    segments = min(r, -(-r // (RAGGED_ROWS // width)) + b)
    num_pages = max(num_pages, 1)
    want = min(max(1, -(-RAGGED_CTAS // (segments * hkv * tiles))),
               num_pages, RAGGED_MAX_CHUNKS)
    pages = -(-num_pages // want)
    return pages * page_size, -(-num_pages // pages), segments


def ragged_buffers(q, hkv, page_table, page_size, stream):
    """(chunk_keys, chunks, segments, part, counter) for one ragged launch
    of grid (chunks, hkv * tiles, segments), tiles = `head_tiles(g)[0]`:
    `part` (f32, allocated per call) holds hkv*chunks*R*g*(hd+2) floats of
    chunk states; `counter` (int32, >= R*hkv*tiles, one per first row of a
    segment and head tile, zero) comes from the per-(device, stream) pool
    that the decode kernels use too."""
    r, h, hd = q.shape
    b, num_pages = page_table.shape
    chunk, chunks, segments = ragged_split(
        num_pages, page_size, r, hkv, h // hkv, b
    )
    part = torch.empty(
        (hkv * chunks * r * h // hkv * (hd + 2),),
        dtype=torch.float32, device=q.device,
    )
    tiles = head_tiles(h // hkv)[0]
    return (chunk, chunks, segments, part,
            _counter(q.device, stream, r * hkv * tiles))


def chunk_split(
    b: int, t: int, hkv: int, group: int, num_pages: int
) -> tuple[int, int]:
    """The chunk kernel's plan: (chunks, tiles). Each KV head's group is cut
    into head tiles (`head_tiles`: (heads, width)), each sequence's t
    tokens into `tiles` row tiles of RAGGED_ROWS // width tokens (one unit
    per row tile and head tile), each unit's keys into `chunks` runs of
    whole pages (`chunk_range`, on the device): as many as keep the
    b * tiles * hkv * heads * chunks CTAs within CHUNK_CTAS (one wave), at
    least one, at most CHUNK_CLUSTER (a unit's chunks are one thread block
    cluster) and at most one per page of the table. A function of the
    shapes alone: the host never reads lens."""
    heads, width = head_tiles(group)
    tiles = -(-max(t, 1) // (RAGGED_ROWS // width))
    chunks = min(max(1, CHUNK_CTAS // (b * tiles * hkv * heads)),
                 CHUNK_CLUSTER, max(num_pages, 1))
    return chunks, tiles


def chunk_range(c: int, chunks: int, lo: int, hi: int,
                page_size: int) -> tuple[int, int]:
    """Keys [klo, khi) of chunk c of a unit whose rows see keys in [lo,
    hi): the pages the range touches, cut into `chunks` runs of whole pages
    as even as pages allow (the last runs may be short or empty). The
    kernel's `chunk_range` (csrc/paged_attention.cu)."""
    p0, p1 = lo // page_size, -(-hi // page_size)
    per = -(-(p1 - p0) // chunks)
    return (p0 + c * per) * page_size, (p0 + (c + 1) * per) * page_size


def _aligned(kernel, named, align: int) -> None:
    """Raise unless every (name, tensor) starts on an `align`-byte
    boundary (the kernels copy rows with cp.async of that size)."""
    for name, x in named:
        if x.data_ptr() % align:
            raise ValueError(f"{kernel}: {name} must be {align}-byte aligned")


def paged_decode_attention(
    q: torch.Tensor,  # [B, H, hd]
    k_slab: torch.Tensor,  # [S_tot, Hkv, hd]
    v_slab: torch.Tensor,
    page_table: torch.Tensor,  # [B, NP] i32
    lens: torch.Tensor,  # [B] i32
    page_size: int,
    scale: float | None = None,
    window: int = 0,
) -> torch.Tensor:  # [B, H, hd]
    if q.device.type == "cpu":
        return paged_decode_attention_reference(
            q, k_slab, v_slab, page_table, lens, page_size, scale, window
        )
    _check(DECODE, q, k_slab, v_slab, page_table, lens, page_size)
    _aligned(DECODE, (("k_slab", k_slab), ("v_slab", v_slab)), 16)
    lib = _library(DECODE_SOURCE)
    b, h, hd = q.shape
    stream = _stream(q)
    chunk, chunks, part, counter = decode_buffers(
        q, k_slab.shape[1], page_table.shape[1], page_size, stream
    )
    out = torch.empty_like(q)
    err = lib.bb_paged_decode_attention(
        q.data_ptr(), k_slab.data_ptr(), v_slab.data_ptr(),
        page_table.data_ptr(), lens.data_ptr(), out.data_ptr(),
        None if part is None else part.data_ptr(), counter.data_ptr(),
        b, h, k_slab.shape[1], hd, page_table.shape[1], page_size,
        int(window), chunk, chunks, _scale(scale, hd), _DTYPES[q.dtype],
        stream,
    )
    build.check(err, DECODE)
    build.count_launch(DECODE)
    return out


def paged_chunk_attention(
    q: torch.Tensor,  # [B, T, H, hd]
    k_slab: torch.Tensor,  # [S_tot, Hkv, hd]
    v_slab: torch.Tensor,
    page_table: torch.Tensor,  # [B, NP] i32
    lens: torch.Tensor,  # [B] i32
    page_size: int,
    tree_mask: torch.Tensor | None = None,  # [B, T, T] bool
    scale: float | None = None,
    window: int = 0,
    t_real: int | None = None,
) -> torch.Tensor:  # [B, T, H, hd]
    if q.device.type == "cpu":
        return paged_chunk_attention_reference(
            q, k_slab, v_slab, page_table, lens, page_size, tree_mask,
            scale, window, t_real,
        )
    _check(CHUNK, q, k_slab, v_slab, page_table, lens, page_size)
    b, t, h, hd = q.shape
    if tree_mask is not None:
        if (
            tree_mask.dtype != torch.bool
            or tree_mask.shape != (b, t, t)
            or tree_mask.device != q.device
            or not tree_mask.is_contiguous()
        ):
            raise ValueError(f"{CHUNK}: tree_mask must be contiguous bool "
                             "[B, T, T] on q's device")
        if window:
            raise ValueError(f"{CHUNK}: tree mode takes no window")
    _aligned(CHUNK, (("q", q), ("k_slab", k_slab), ("v_slab", v_slab)), 16)
    lib = _library(SOURCE)
    out = torch.empty_like(q)
    if b * t == 0:
        return out
    hkv = k_slab.shape[1]
    chunks, _ = chunk_split(b, t, hkv, h // hkv, page_table.shape[1])
    err = lib.bb_paged_chunk_attention(
        q.data_ptr(), k_slab.data_ptr(), v_slab.data_ptr(),
        page_table.data_ptr(), lens.data_ptr(),
        None if tree_mask is None else tree_mask.data_ptr(), out.data_ptr(),
        b, t, h, hkv, hd, page_table.shape[1], page_size,
        int(window), int(t if t_real is None else t_real), chunks,
        _scale(scale, hd), _DTYPES[q.dtype], _stream(q),
    )
    build.check(err, CHUNK)
    build.count_launch(CHUNK)
    return out


def paged_decode_attention_int4(
    q: torch.Tensor,  # [B, H, hd]
    k_slab: QuantSlab,  # codes [S_tot, Hkv, hd/2] u8, scale/zero f16
    v_slab: QuantSlab,
    page_table: torch.Tensor,  # [B, NP] i32
    lens: torch.Tensor,  # [B] i32
    page_size: int,
    scale: float | None = None,
    window: int = 0,
) -> torch.Tensor:  # [B, H, hd]
    if q.device.type == "cpu":
        return paged_decode_attention_int4_reference(
            q, k_slab, v_slab, page_table, lens, page_size, scale, window
        )
    _check(INT4, q, k_slab, v_slab, page_table, lens, page_size)
    b, h, hd = q.shape
    for side, slab in (("k_slab", k_slab), ("v_slab", v_slab)):
        # whole rows: codes in 16-byte pieces, scale and zero hd/16 bytes
        _aligned(INT4, ((f"{side}.codes", slab.codes),), 16)
        _aligned(INT4, ((f"{side}.scale", slab.scale),
                        (f"{side}.zero", slab.zero)), hd // 16)
    lib = _library(DECODE_SOURCE)
    hkv = k_slab.codes.shape[1]
    stream = _stream(q)
    chunk, chunks, part, counter = decode_buffers(
        q, hkv, page_table.shape[1], page_size, stream
    )
    out = torch.empty_like(q)
    err = lib.bb_paged_decode_attention_int4(
        q.data_ptr(), *(x.data_ptr() for x in k_slab),
        *(x.data_ptr() for x in v_slab), page_table.data_ptr(),
        lens.data_ptr(), out.data_ptr(),
        None if part is None else part.data_ptr(), counter.data_ptr(),
        b, h, hkv, hd, page_table.shape[1], page_size, int(window), chunk,
        chunks, _scale(scale, hd), _DTYPES[q.dtype], stream,
    )
    build.check(err, INT4)
    build.count_launch(INT4)
    return out


def paged_ragged_attention(
    q: torch.Tensor,  # [R, H, hd]
    k_slab: torch.Tensor,  # [S_tot, Hkv, hd]
    v_slab: torch.Tensor,
    page_table: torch.Tensor,  # [B, NP] i32
    lens: torch.Tensor,  # [B] i32
    q_seq: torch.Tensor,  # [R] i32
    q_pos: torch.Tensor,  # [R] i32
    page_size: int,
    scale: float | None = None,
    window: int = 0,
    nt: torch.Tensor | None = None,  # [B] i32 (tree mode)
    tree_rows: torch.Tensor | None = None,  # [R, t_max] i32 (tree mode)
) -> torch.Tensor:  # [R, H, hd]
    if q.device.type == "cpu":
        return paged_ragged_attention_reference(
            q, k_slab, v_slab, page_table, lens, q_seq, q_pos, page_size,
            scale=scale, window=window, nt=nt, tree_rows=tree_rows,
        )
    r, h, hd = q.shape
    b = page_table.shape[0]
    _check(RAGGED, q, k_slab, v_slab, page_table, lens, page_size, b=b)
    rows = [("q_seq", q_seq, (r,)), ("q_pos", q_pos, (r,))]
    if (nt is None) != (tree_rows is None):
        raise ValueError(f"{RAGGED}: tree mode takes both nt and tree_rows")
    if tree_rows is not None:
        if window:
            raise ValueError(f"{RAGGED}: tree mode takes no window")
        rows += [("nt", nt, (b,)),
                 ("tree_rows", tree_rows, (r, tree_rows.shape[-1]))]
    for name, x, shape in rows:
        if (x.dtype != torch.int32 or tuple(x.shape) != shape
                or x.device != q.device or not x.is_contiguous()):
            raise ValueError(f"{RAGGED}: {name} must be contiguous int32 "
                             f"{list(shape)} on q's device")
    _aligned(RAGGED, (("q", q), ("k_slab", k_slab), ("v_slab", v_slab)),
             16)
    lib = _library(RAGGED_SOURCE)
    out = torch.empty_like(q)
    if r == 0:
        return out
    hkv = k_slab.shape[1]
    stream = _stream(q)
    chunk, chunks, segments, part, counter = ragged_buffers(
        q, hkv, page_table, page_size, stream
    )
    err = lib.bb_paged_ragged_attention(
        q.data_ptr(), k_slab.data_ptr(), v_slab.data_ptr(),
        page_table.data_ptr(), lens.data_ptr(), q_seq.data_ptr(),
        q_pos.data_ptr(), None if nt is None else nt.data_ptr(),
        None if tree_rows is None else tree_rows.data_ptr(), out.data_ptr(),
        part.data_ptr(), counter.data_ptr(),
        r, b, h, hkv, hd, page_table.shape[1], page_size, int(window),
        0 if tree_rows is None else tree_rows.shape[1], chunk, chunks,
        segments, _scale(scale, hd), _DTYPES[q.dtype], stream,
    )
    build.check(err, RAGGED)
    build.count_launch(RAGGED)
    return out

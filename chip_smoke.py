#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (`bloombee_tpu_torch`) on one GPU.

    python3 chip_smoke.py            # all phases, one CUDA device
    python3 chip_smoke.py --quick    # phases 1-2 only (build + kernel checks)
    python3 chip_smoke.py --profile  # all phases + torch.profiler breakdowns
                                     # (decode, ragged mixed and tree and
                                     # int4 decode steps, 4 solo tree
                                     # verifies, a prefill chunk)

Phases:
1. Build the five CUDA kernels from `bloombee_tpu_torch/ops/cuda/csrc/`
   with nvcc for sm_90a (the four sources compile in parallel).
2. Hold each kernel against its plain PyTorch version on the card at
   Llama-3-8B head geometry (H=32, Hkv=8, hd=128, page_size 16): f32 max abs
   error <= 1e-4; bf16 max abs error <= 2e-2 on unit-scale inputs and, for
   every element, <= 1e-2 x |plain| + 1e-3; shapes include a
   sliding window, a lens=0 row, a tree-mode chunk, ragged causal and tree
   mixes with padding rows, and int4 decode, plus small cases of every
   other compiled geometry (hd 64; GQA groups 1, 2, 8), and the edge cases
   of the flash, split decode, int4 decode, ragged and chunk kernels
   (`phase_kernels_edges`; the split kernels' cases launched twice, equal
   bit for bit). Times each kernel, its plain version and (flash) the
   library call computing the same function, with CUDA events after
   warmup, launches queued behind a device sleep so the time is the
   device's (`cuda_ms`); also host-paced, decode and int4 decode with a
   cold L2, flash at both prefill-chunk shapes and in f32, ragged at the
   mixed and the tree step's shapes, chunk at the serving path's two B=1
   launches (warm and cold) and at PR 1-4's B=4 table shape.
3. The executor's path in f32 (TF32 off) at full Llama-3-8B width, 4
   layers, random weights from a seeded generator: a 1000-token prefill of
   batch 2, 8 greedy decodes and a 24-token follow-up must match
   `block_forward` + `dense_attend` over the whole sequence (max abs error
   <= 1e-3 x the reference's max abs value) with identical greedy tokens.
   Then a ragged_group of 2 decode rows + a 24-token chunk and one of 2
   decode rows + an 8-node tree (ragged kernel) must match the members run
   solo and the dense attend_ragged route; and an int4 arena's 8 greedy
   decodes on the int4 kernel must match its dense route (same limit,
   identical greedy tokens). Served: a port registry and two port
   BlockServers over the same 4 layers (blocks [0, 2) and [2, 4)); the
   port client (`DistributedModelForCausalLM`, f32 parameters, push
   routing) generates 9 greedy tokens for the batch-2 1000-token prompt
   (a prefill and 8 decode steps), matching the executor (same limit,
   identical greedy tokens). Routing: H=24, Hkv=8 (GQA group 3,
   outside the kernels' domain), 2 layers, a 600-token prefill and 4
   decodes take the dense routes (no paged or flash launch) and match
   `block_forward` + `dense_attend` (same limit).
4. Serving run in bf16: the whole Llama-3-8B (32 layers, full width),
   1024 arena pages, three paths, each with the launch counts reset just
   before it and read just after it (before any profiling):
   - serving: four sessions allocated through `CacheManager.allocate`
     each prefill 1000 tokens (chunks of 512 + 488 -> flash), then 32
     `decode_group` steps (-> paged decode), one 24-token follow-up turn
     and one 8-token tree-verify step (-> paged chunk);
   - ragged: a ragged step of the 4 sessions' decode rows + a fifth
     session's 32-token chunk, and a tree step of 4 x 8-node trees (->
     ragged), each timed beside the same work dispatched separately
     (counted apart, as `ragged_yardstick`);
   - int4: an int4 arena, 4 sessions x 1000-token prefill (flash over the
     dequantized pages) and 32 `decode_group` steps (-> int4 decode),
     timed beside the bf16 arena's decode step.
   Every kernel must show launches on its path, the bf16 decode step
   exactly one decode launch per layer, and the serving path one chunk
   launch per layer for each of its two T>1 steps.
5. Served in bf16 over phase 4's weights (no second copy): a port registry
   and two port BlockServers on the card (blocks [0, 16) and [16, 32),
   1024-page arenas) on one event loop, and four concurrent sessions of
   the port client (`DistributedModelForCausalLM` over phase 4's bf16
   client parameters, a `RemoteSequenceManager` over the port registry,
   push) on another: each `generate`s 32 greedy tokens from a 1000-token
   prompt, then on the same session a 24-token follow-up turn with 2 more
   tokens. The same sessions solo on one SpanExecutor with the server's
   calls, their tokens picked by the client's own head on the executor's
   output gathered in f32, must give identical greedy tokens and
   last-position hidden states within 1e-2 x |ref| + 1e-3 each. The
   launch counts of the served run (path "served") must show flash, paged
   decode and paged chunk, and exactly one decode launch per layer per
   session step. Prints each session's time to first token (prefill round
   trip + head, codec default) and per-token time (step + head + embed),
   its `timing_summary()`, the head's device time, the replies' dispatch
   and fetch medians, one session alone, the bytes a decode step moves on
   the wire, and the card's name and power limit.

Prints the card's name and power limit, per-phase results, a
`{"kernels": [...]}` line, and as its last line
`{"ok": true, "device": {...}}`. Any failed phase exits non-zero with no
result line; so does a machine without CUDA or a directory without the
package.
"""

from __future__ import annotations

import argparse
import asyncio
import contextlib
import json
import pathlib
import subprocess
import sys
import time
import traceback

REPO = pathlib.Path(__file__).resolve().parent
H, HKV, HD, PS = 32, 8, 128, 16
PEAK_BYTES = 3.35e12  # H100 SXM HBM3, bytes/s
PEAK_OPS = {"bfloat16": 989e12, "float32": 67e12}  # dense, FLOP/s
SOURCES = ("flash_attention", "paged_attention", "paged_decode",
           "paged_ragged")
REPLACES = {
    "flash_attention": "bloombee_tpu/ops/pallas/flash_attention.py:124",
    "paged_decode_attention": "bloombee_tpu/ops/pallas/paged_attention.py:545",
    "paged_chunk_attention": "bloombee_tpu/ops/pallas/paged_attention.py:445",
    "paged_ragged_attention": "bloombee_tpu/ops/pallas/paged_attention.py:733",
    "paged_decode_attention_int4":
        "bloombee_tpu/ops/pallas/paged_attention.py:235",
}
SOURCE_OF = {
    "flash_attention": "flash_attention",
    "paged_decode_attention": "paged_decode",
    "paged_chunk_attention": "paged_attention",
    "paged_ragged_attention": "paged_ragged",
    "paged_decode_attention_int4": "paged_decode",
}


def say(*parts):
    print(*parts, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, warmup=3, iters=20, host_paced=False, reps=3) -> float:
    """Device ms per call of fn: the median over `reps` runs of the mean
    of `iters` back-to-back calls (CUDA events). Before each run the
    device sleeps ~25 ms so that the host queues every call before the
    first runs: the time is the device's, not the host's Python and launch
    overhead. `host_paced` skips the sleep (PR 1 and PR 2's method, which
    reads a kernel shorter than its wrapper's host time as the host's
    pace)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    runs = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if not host_paced:
            torch.cuda._sleep(50_000_000)  # cycles: ~25 ms at 2 GHz
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        runs.append(start.elapsed_time(end) / iters)
    return sorted(runs)[reps // 2]


def cuda_ms_cold(fn, iters=60) -> float:
    """Device ms per call of fn with a cold L2: a 256 MiB buffer (over the
    H100's 50 MB L2) is overwritten before each call, and each call is
    timed alone with CUDA events (queued behind a device sleep, as in
    cuda_ms); the mean of `iters` calls."""
    import torch

    flush = torch.empty((64 << 20,), dtype=torch.float32, device="cuda")
    fn()
    torch.cuda.synchronize()
    events = [
        (torch.cuda.Event(enable_timing=True),
         torch.cuda.Event(enable_timing=True))
        for _ in range(iters)
    ]
    torch.cuda._sleep(50_000_000)
    for start, end in events:
        flush.zero_()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in events) / iters


def host_us(fn, iters=50) -> float:
    """Host microseconds per call of fn: its Python and launch cost. The
    calls are queued behind a ~25 ms device sleep, so none waits for the
    device."""
    import torch

    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(50_000_000)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    seconds = time.perf_counter() - t0
    torch.cuda.synchronize()
    return seconds / iters * 1e6


def bound(nbytes: float, flops: float, dtype) -> tuple[float, str]:
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = flops / PEAK_OPS[str(dtype).removeprefix("torch.")] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


# ------------------------------------------------------------- phase 1
def phase_build():
    from bloombee_tpu_torch.ops.cuda import build

    t0 = time.perf_counter()
    logs = build.build(SOURCES)
    say(f"[build] {list(SOURCES)} built in "
        f"{time.perf_counter() - t0:.1f} s (cached: "
        f"{[s for s in SOURCES if s not in logs]})")
    for name, log in logs.items():
        for kernel, report in ptxas_report(log):
            say(f"[build] {name}: {kernel}: {report}")
        for line in log.splitlines():
            if "Performance Loss" in line:  # e.g. serialized wgmma
                say(f"[build] {name}: {line.strip()}")
    for name in SOURCES:
        say(f"[build] {name}: tensor-core instructions in the SASS "
            f"(cuobjdump): {tensor_core_ops(build, name)}")


def tensor_core_ops(build, name) -> dict[str, int] | str:
    """Counts of the tensor-core SASS opcodes (HGMMA: wgmma; HMMA:
    mma.sync) in a built library, from `cuobjdump -sass`."""
    import re
    import shutil

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not pathlib.Path(tool).exists():
        return "cuobjdump not found"
    sass = subprocess.run(
        [tool, "-sass", str(build._output(name))], capture_output=True,
        text=True, timeout=120,
    ).stdout
    counts: dict[str, int] = {}
    for op in re.findall(r"\b(HGMMA|HMMA)\.", sass):
        counts[op] = counts.get(op, 0) + 1
    return counts


def ptxas_report(log: str) -> list[tuple[str, str]]:
    """(kernel, "N registers, spills, smem") per entry function of an
    `nvcc -Xptxas -v` log, kernel names demangled when a demangler is on
    the PATH."""
    import re
    import shutil

    rows, kernel, spill = [], None, ""
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            kernel = m.group(1)
        elif "spill stores" in line:
            spill = line.strip()
        elif "Used" in line and "registers" in line and kernel:
            used = line.split(":", 1)[1].strip()
            rows.append((kernel, f"{used}; {spill}"))
            kernel = None
    tool = shutil.which("cu++filt") or shutil.which("c++filt")
    if tool and rows:
        out = subprocess.run([tool], input="\n".join(k for k, _ in rows),
                             capture_output=True, text=True)
        names = out.stdout.splitlines()
        if len(names) == len(rows):
            rows = [(n.replace("(anonymous namespace)::", "")
                     .replace("(int)", "").split("(")[0], r)
                    for n, (_, r) in zip(names, rows)]
    return rows


# ------------------------------------------------------------- phase 2
def _unit(gen, shape, dtype):
    import torch

    return torch.randn(shape, generator=gen, device="cuda").to(dtype)


def _tree(t, gen):
    """[t, t] ancestor-or-self mask of a random tree (node i's parent is
    drawn among nodes < i)."""
    import torch

    parents = [-1] + [
        int(torch.randint(0, i, (1,), generator=gen, device="cuda"))
        for i in range(1, t)
    ]
    tm = torch.zeros((t, t), dtype=torch.bool)
    for n in range(t):
        node = n
        while node >= 0:
            tm[n, node] = True
            node = parents[node]
    return tm


def _arena(gen, dtype, pages):
    return (
        _unit(gen, (pages * PS, HKV, HD), dtype),
        _unit(gen, (pages * PS, HKV, HD), dtype),
    )


def _page_table(gen, b, n_pages, phys):
    import torch

    perm = torch.randperm(phys, generator=gen, device="cuda")[: b * n_pages]
    return perm.view(b, n_pages).to(torch.int32).contiguous()


def phase_kernels() -> list[dict]:
    import torch

    from bloombee_tpu_torch.kv.quant import quantize
    from bloombee_tpu_torch.ops.cuda import flash_attention as fa
    from bloombee_tpu_torch.ops.cuda import paged_attention as pa

    gen = torch.Generator(device="cuda").manual_seed(1234)
    tol = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
    errs: dict[str, dict] = {}

    def check(name, dtype, case, got, want):
        torch.cuda.synchronize()
        diff = (got.float() - want.float()).abs()
        err = diff.max().item()
        ok = err <= tol[dtype] and torch.isfinite(got.float()).all().item()
        rule = f"max {tol[dtype]:.0e}"
        if dtype == torch.bfloat16:
            # outputs over ~1000 keys are ~0.05, far below the absolute
            # limit; one bf16 rounding step is <= 2^-7 |x|, so hold every
            # element to 1e-2 of its plain value (+1e-3 for values near 0)
            ok = ok and bool((diff <= 1e-2 * want.float().abs() + 1e-3).all())
            rule += ", each <= 1e-2|plain|+1e-3"
        say(f"[kernels] {name} {str(dtype)[6:]} {case}: max_abs_err="
            f"{err:.3e} ({rule}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{name} {case} {dtype}: err {err}")
        slot = errs.setdefault(name, {})
        slot[str(dtype)] = max(slot.get(str(dtype), 0.0), err)

    i32 = dict(dtype=torch.int32, device="cuda")
    for dtype in (torch.float32, torch.bfloat16):
        # flash: the serving prefill's second chunk (512-token bucket over a
        # 1024-token context) plus a full-attention mixed starts/lens case
        q = _unit(gen, (4, 512, H, HD), dtype)
        k = _unit(gen, (4, 1024, HKV, HD), dtype)
        v = _unit(gen, (4, 1024, HKV, HD), dtype)
        starts = torch.tensor([512, 512, 0, 300], **i32)
        lens = torch.tensor([1000, 1024, 512, 700], **i32)
        for causal in (True, False):
            args = (q, k, v, causal, None, starts, lens)
            check("flash_attention", dtype, f"causal={causal}",
                  fa.flash_attention(*args),
                  fa.flash_attention_reference(*args))

        phys = 1024
        ks, vs = _arena(gen, dtype, phys)
        pt = _page_table(gen, 4, 64, phys)
        lens = torch.tensor([1000, 777, 0, 1024], **i32)
        qd = _unit(gen, (4, H, HD), dtype)
        for window in (0, 100):
            args = (qd, ks, vs, pt, lens, PS, None, window)
            check("paged_decode_attention", dtype,
                  f"window={window} lens=0 row",
                  pa.paged_decode_attention(*args),
                  pa.paged_decode_attention_reference(*args))

        qc = _unit(gen, (4, 32, H, HD), dtype)
        for window in (0, 40):
            args = (qc, ks, vs, pt, lens.clamp_min(24), PS, None, None,
                    window, 24)
            check("paged_chunk_attention", dtype,
                  f"causal t_real=24/32 window={window}",
                  pa.paged_chunk_attention(*args),
                  pa.paged_chunk_attention_reference(*args))
        tree = torch.stack([_tree(8, gen) for _ in range(4)]).cuda()
        qt = _unit(gen, (4, 8, H, HD), dtype)
        args = (qt, ks, vs, pt, lens.clamp_min(8), PS, tree, None, 0, 8)
        check("paged_chunk_attention", dtype, "tree T=8",
              pa.paged_chunk_attention(*args),
              pa.paged_chunk_attention_reference(*args))

        # the other compiled geometries: hd 64, and GQA groups 1, 2 and 8
        # (small shapes, ragged lengths, S not a multiple of the key tile)
        for hd, h, hkv in ((64, 8, 8), (64, 16, 2), (128, 4, 2)):
            geo = f"hd={hd} H={h} Hkv={hkv}"
            q = _unit(gen, (2, 100, h, hd), dtype)
            k = _unit(gen, (2, 150, hkv, hd), dtype)
            v = _unit(gen, (2, 150, hkv, hd), dtype)
            st = torch.tensor([50, 0], **i32)
            ln = torch.tensor([150, 77], **i32)
            args = (q, k, v, True, None, st, ln)
            check("flash_attention", dtype, geo, fa.flash_attention(*args),
                  fa.flash_attention_reference(*args))
            ks = _unit(gen, (64 * PS, hkv, hd), dtype)
            vs = _unit(gen, (64 * PS, hkv, hd), dtype)
            pt = _page_table(gen, 2, 8, 64)
            ln = torch.tensor([100, 37], **i32)
            args = (_unit(gen, (2, h, hd), dtype), ks, vs, pt, ln, PS, None,
                    0)
            check("paged_decode_attention", dtype, geo,
                  pa.paged_decode_attention(*args),
                  pa.paged_decode_attention_reference(*args))
            args = (_unit(gen, (2, 8, h, hd), dtype), ks, vs, pt, ln, PS,
                    None, None, 0, 5)
            check("paged_chunk_attention", dtype, geo,
                  pa.paged_chunk_attention(*args),
                  pa.paged_chunk_attention_reference(*args))
            args = (_unit(gen, (2, h, hd), dtype), quantize(ks),
                    quantize(vs), pt, ln, PS, None, 0)
            check("paged_decode_attention_int4", dtype, geo,
                  pa.paged_decode_attention_int4(*args),
                  pa.paged_decode_attention_int4_reference(*args))
            # rows: 5 of a chunk of sequence 0, a decode row of sequence 1,
            # a padding row
            q_seq = torch.tensor([0] * 5 + [1, 2], **i32)
            q_pos = torch.tensor([95, 96, 97, 98, 99, 36, 0], **i32)
            args = (_unit(gen, (7, h, hd), dtype), ks, vs, pt, ln, q_seq,
                    q_pos, PS, None, 0)
            check("paged_ragged_attention", dtype, geo,
                  pa.paged_ragged_attention(*args),
                  pa.paged_ragged_attention_reference(*args))

        phase_kernels_ragged_int4(gen, dtype, check)
        phase_kernels_edges(gen, dtype, check)

    # times at the serving run's bf16 shapes (phase 4)
    extra: dict[str, dict] = {}  # per kernel: times beyond the row's own
    flash_row, extra["flash_attention"] = time_flash(gen)
    decode_row, extra["paged_decode_attention"] = time_decode(gen)
    rows = [flash_row, decode_row]
    chunk_row, extra["paged_chunk_attention"] = time_chunk(gen, check)
    rows.append(chunk_row)
    rows += time_ragged_int4(gen, extra)

    out = []
    for name, ms, plain, b_ms, by, library in rows:
        say(f"[kernels] {name} bf16 main-path shape: {ms:.4f} ms (plain "
            f"{plain:.4f} ms, library "
            f"{'n/a' if library is None else f'{library:.4f} ms'}, "
            f"bound {b_ms:.4f} ms by {by}) {extra.get(name, {})}")
        out.append({
            "name": name,
            "route": "cuda",
            "source": f"bloombee_tpu_torch/ops/cuda/csrc/{SOURCE_OF[name]}.cu",
            "replaces": REPLACES[name],
            "launches": 0,
            "max_abs_err": errs[name][str(torch.bfloat16)],
            "f32_max_abs_err": errs[name][str(torch.float32)],
            "ms": ms,
            "plain_ms": plain,
            "bound_ms": b_ms,
            "bound_by": by,
            "library_ms": library,
            **extra.get(name, {}),
        })
    return out


def sdpa_ms(q, k, v, starts, lens, scale):
    """(ms, mask): the time of one scaled_dot_product_attention call
    computing the flash kernel's causal function (GQA pre-expanded, the
    mask as a bool tensor), the library yardstick used nowhere in the
    port; and that mask."""
    import torch

    from bloombee_tpu_torch.ops.attention import repeat_kv

    t, s = q.shape[1], k.shape[1]
    kr, vr = repeat_kv(k, H // HKV), repeat_kv(v, H // HKV)
    pos_q = starts[:, None] + torch.arange(t, device="cuda")
    kpos = torch.arange(s, device="cuda")
    mask = (kpos[None, None] <= pos_q[:, :, None]) & (
        kpos[None, None] < lens[:, None, None]
    )
    qt_, kt_, vt_ = (x.transpose(1, 2) for x in (q, kr, vr))
    m4 = mask[:, None]
    return cuda_ms(
        lambda: torch.nn.functional.scaled_dot_product_attention(
            qt_, kt_, vt_, attn_mask=m4, scale=scale
        )
    ), mask


def time_flash(gen) -> tuple[tuple, dict]:
    """The flash kernel at the serving prefill's two chunk shapes: the
    second (q [4,512,32,128] over a 1024-token context, starts 512, lens
    1000: the row's own numbers, comparable with PR 1 and 2) and the first
    (starts 0, T 512 over S 512), each beside its SDPA call; and the f32
    kernel at the second shape."""
    import torch

    from bloombee_tpu_torch.ops.cuda import flash_attention as fa

    dt = torch.bfloat16
    i32 = dict(dtype=torch.int32, device="cuda")
    scale = HD**-0.5
    extra = {}
    for label, s, start, length in (("second", 1024, 512, 1000),
                                    ("first", 512, 0, 512)):
        q = _unit(gen, (4, 512, H, HD), dt)
        k = _unit(gen, (4, s, HKV, HD), dt)
        v = _unit(gen, (4, s, HKV, HD), dt)
        starts = torch.full((4,), start, **i32)
        lens = torch.full((4,), length, **i32)
        args = (q, k, v, True, scale, starts, lens)
        ms = cuda_ms(lambda: fa.flash_attention(*args))
        library, mask = sdpa_ms(q, k, v, starts, lens, scale)
        vis = mask.sum().item() * H  # visible (query, key) pairs, all heads
        b_ms, by = bound(
            nbytes(q, k[:, :length], v[:, :length], q, starts, lens),
            4 * vis * HD, dt,
        )
        if label == "second":
            plain = cuda_ms(lambda: fa.flash_attention_reference(*args),
                            iters=5)
            row = ("flash_attention", ms, plain, b_ms, by, library)
            f32 = tuple(x.float() for x in (q, k, v))
            extra["f32_ms"] = cuda_ms(
                lambda: fa.flash_attention(*f32, True, scale, starts, lens)
            )
            extra["host_paced_ms"] = cuda_ms(
                lambda: fa.flash_attention(*args), host_paced=True
            )
        else:
            extra.update(first_chunk_ms=ms, first_chunk_library_ms=library,
                         first_chunk_bound_ms=b_ms)
    return row, extra


def time_decode(gen) -> tuple[tuple, dict]:
    """The decode kernel at the serving decode shape (q [4,32,128] over
    4 x 1001-token contexts in a 1024-page arena): warm L2 (back-to-back
    launches over the same pages: the row's own time, comparable with PR 1
    and 2), cold L2 (as a decode step finds each layer's slab), and
    host-paced (PR 1 and 2's method)."""
    import torch

    from bloombee_tpu_torch.ops.cuda import paged_attention as pa

    dt = torch.bfloat16
    i32 = dict(dtype=torch.int32, device="cuda")
    ks, vs = _arena(gen, dt, 1024)
    pt = _page_table(gen, 4, 64, 1024)
    lens = torch.full((4,), 1001, **i32)
    qd = _unit(gen, (4, H, HD), dt)
    args = (qd, ks, vs, pt, lens, PS, HD**-0.5, 0)
    ms = cuda_ms(lambda: pa.paged_decode_attention(*args))
    plain = cuda_ms(lambda: pa.paged_decode_attention_reference(*args))
    kv_rows = 4 * 1001
    b_ms, by = bound(
        2 * kv_rows * HKV * HD * 2 + nbytes(qd, qd, pt, lens),
        4 * kv_rows * H * HD, dt,
    )
    chunk, chunks = pa.decode_split(64, PS, 4, HKV)
    extra = {
        "cold_ms": cuda_ms_cold(lambda: pa.paged_decode_attention(*args)),
        "host_paced_ms": cuda_ms(lambda: pa.paged_decode_attention(*args),
                                 host_paced=True),
        "split": f"{chunks} chunks of {chunk} keys, "
                 f"{4 * HKV * chunks} CTAs",
    }
    return ("paged_decode_attention", ms, plain, b_ms, by, None), extra


def time_chunk(gen, check) -> tuple[tuple, dict]:
    """The chunk kernel at the serving run's two launches, both B=1 over
    the executor's 128-page bucket: the follow-up turn (q [1,32,32,128],
    t_real 24, 1056 tokens: the row's own time) and the tree verify (q
    [1,8,32,128], an 8-node tree, 1040 tokens; `tree_*` keys), each warm,
    cold L2 and beside its plain version and bound; and PR 1-4's table
    shape (q [4,32,32,128], t_real 24, 1032 tokens; `b4_*` keys), with its
    host-paced time; and the wrapper's host time per call at each shape
    (`*host_us`). Each shape's output is first checked against the plain
    version's on the same inputs."""
    import torch

    from bloombee_tpu_torch.ops.cuda import paged_attention as pa

    dt = torch.bfloat16
    i32 = dict(dtype=torch.int32, device="cuda")
    scale = HD**-0.5
    ks, vs = _arena(gen, dt, 1024)
    extra, row = {}, None
    for label, b, t, t_real, length, pages, tree in (
        ("", 1, 32, 24, 1056, 128, False),
        ("tree_", 1, 8, 8, 1040, 128, True),
        ("b4_", 4, 32, 24, 1032, 65, False),
    ):
        q = _unit(gen, (b, t, H, HD), dt)
        pt = _page_table(gen, b, pages, 1024)
        lens = torch.full((b,), length, **i32)
        mask = (torch.stack([_tree(t, gen) for _ in range(b)]).cuda()
                if tree else None)
        args = (q, ks, vs, pt, lens, PS, mask, scale, 0, t_real)
        check("paged_chunk_attention", dt,
              f"timed shape q {list(q.shape)} t_real {t_real} over "
              f"{length} tokens, {pages}-page table"
              f"{', tree' if tree else ''}",
              pa.paged_chunk_attention(*args),
              pa.paged_chunk_attention_reference(*args))
        ms = cuda_ms(lambda: pa.paged_chunk_attention(*args))
        plain = cuda_ms(lambda: pa.paged_chunk_attention_reference(*args))
        extra[f"{label}host_us"] = host_us(
            lambda: pa.paged_chunk_attention(*args))
        start = length - t_real
        if tree:  # the prefix for every row, in-step keys by the tree
            pairs = b * (t * start + int(mask.sum()))
            small = nbytes(mask)
        else:
            pairs = b * sum(start + i + 1 for i in range(t_real))
            small = 0
        b_ms, by = bound(
            2 * b * length * HKV * HD * 2 + nbytes(q, q, lens) + small
            + b * -(-length // PS) * 4,
            4 * pairs * H * HD, dt,
        )
        chunks, tiles = pa.chunk_split(b, t, HKV, H // HKV, pages)
        extra[f"{label}split"] = (f"{b * tiles * HKV} units (row tile, KV "
                                  f"head) x {chunks} chunks")
        if not label:
            row = ("paged_chunk_attention", ms, plain, b_ms, by, None)
        else:
            extra.update({f"{label}ms": ms, f"{label}plain_ms": plain,
                          f"{label}bound_ms": b_ms})
        if label != "b4_":
            extra[f"{label}cold_ms"] = cuda_ms_cold(
                lambda: pa.paged_chunk_attention(*args))
        else:
            extra["b4_host_paced_ms"] = cuda_ms(
                lambda: pa.paged_chunk_attention(*args), host_paced=True)
    return row, extra


def phase_kernels_edges(gen, dtype, check):
    """Phase 2 edge cases of the flash kernel and the split decode kernels
    (bf16/f32 here; int4 in `int4_edges`) and of the split ragged kernel
    (`ragged_edges`).

    Flash: T=100 and S=150 (not multiples of the 64-query and 64-key
    tiles), starts 37 and 13 (off a tile edge), lens 137 (inside the last
    key tile), a lens=0 row (exact zeros), causal and not, at hd 64 with
    GQA groups 1 and 8 and at Llama-3-8B heads.
    Decode (Llama-3-8B heads): lens 1, 15, 16, 17, one chunk + 1, 0 (exact
    zeros), the table's full capacity and 1000, without and with a window
    that starts mid-chunk, each launched twice in a row (the second finds
    the counters the first reset; both must agree bit for bit); and B=1
    over 8000 tokens, so that 32 chunks merge."""
    import torch

    from bloombee_tpu_torch.ops.cuda import flash_attention as fa
    from bloombee_tpu_torch.ops.cuda import paged_attention as pa

    i32 = dict(dtype=torch.int32, device="cuda")

    def zeros(name, case, x):
        if torch.count_nonzero(x).item():
            raise AssertionError(f"{name} {case}: lens=0 row not zeros")

    for hd, h, hkv in ((64, 8, 8), (64, 16, 2), (128, H, HKV)):
        q = _unit(gen, (3, 100, h, hd), dtype)
        k = _unit(gen, (3, 150, hkv, hd), dtype)
        v = _unit(gen, (3, 150, hkv, hd), dtype)
        st = torch.tensor([37, 0, 13], **i32)
        ln = torch.tensor([137, 0, 150], **i32)
        for causal in (True, False):
            case = f"edges hd={hd} H={h} Hkv={hkv} causal={causal}"
            args = (q, k, v, causal, None, st, ln)
            got = fa.flash_attention(*args)
            check("flash_attention", dtype, case, got,
                  fa.flash_attention_reference(*args))
            zeros("flash_attention", case, got[1])

    ks, vs = _arena(gen, dtype, 1024)
    pt = _page_table(gen, 8, 64, 1024)
    chunk, chunks = pa.decode_split(64, PS, 8, HKV)
    lens = torch.tensor([1, 15, 16, 17, chunk + 1, 0, 64 * PS, 1000], **i32)
    qd = _unit(gen, (8, H, HD), dtype)
    mid = 1000 - (2 * chunk + chunk // 2)  # row 7's window starts mid-chunk
    for window in (0, mid):
        case = (f"lens {lens.tolist()} ({chunks} chunks of {chunk}) "
                f"window={window}")
        args = (qd, ks, vs, pt, lens, PS, None, window)
        first = pa.paged_decode_attention(*args)
        second = pa.paged_decode_attention(*args)
        want = pa.paged_decode_attention_reference(*args)
        check("paged_decode_attention", dtype, case, first, want)
        check("paged_decode_attention", dtype, case + " 2nd launch", second,
              want)
        if not torch.equal(first, second):
            raise AssertionError(f"decode {case}: launches disagree")
        zeros("paged_decode_attention", case, first[5])
    ks, vs = _arena(gen, dtype, 512)
    pt = _page_table(gen, 1, 500, 512)
    chunk, chunks = pa.decode_split(500, PS, 1, HKV)
    args = (_unit(gen, (1, H, HD), dtype), ks, vs, pt,
            torch.tensor([8000], **i32), PS, None, 0)
    check("paged_decode_attention", dtype,
          f"B=1 lens=8000 ({chunks} chunks of {chunk})",
          pa.paged_decode_attention(*args),
          pa.paged_decode_attention_reference(*args))
    int4_edges(gen, dtype, check, zeros)
    ragged_edges(gen, dtype, check, zeros)
    chunk_edges(gen, dtype, check, zeros)


def twice(name, dtype, case, check, launch, want):
    """Launch a split kernel twice in a row (the second finds the counters
    the first reset): both within the limit of the plain result, and equal
    bit for bit."""
    import torch

    first, second = launch(), launch()
    check(name, dtype, case, first, want)
    check(name, dtype, case + " 2nd launch", second, want)
    if not torch.equal(first, second):
        raise AssertionError(f"{name} {case}: launches disagree")
    return first


def int4_edges(gen, dtype, check, zeros):
    """Phase 2 edge cases of the int4 decode kernel, as decode's: lens 1,
    15, 16, 17, one chunk + 1, 0 (exact zeros), the table's full capacity
    and 1000, without and with a window that starts mid-chunk, each
    launched twice; B=1 over 8000 tokens; hd 64 at g = 1, 2 and 8."""
    import torch

    from bloombee_tpu_torch.kv.quant import quantize
    from bloombee_tpu_torch.ops.cuda import paged_attention as pa

    name = "paged_decode_attention_int4"
    i32 = dict(dtype=torch.int32, device="cuda")
    ks, vs = (quantize(x) for x in _arena(gen, torch.float32, 1024))
    pt = _page_table(gen, 8, 64, 1024)
    chunk, chunks = pa.decode_split(64, PS, 8, HKV)
    lens = torch.tensor([1, 15, 16, 17, chunk + 1, 0, 64 * PS, 1000], **i32)
    qd = _unit(gen, (8, H, HD), dtype)
    mid = 1000 - (2 * chunk + chunk // 2)  # row 7's window starts mid-chunk
    for window in (0, mid):
        case = (f"lens {lens.tolist()} ({chunks} chunks of {chunk}) "
                f"window={window}")
        args = (qd, ks, vs, pt, lens, PS, None, window)
        got = twice(name, dtype, case, check,
                    lambda: pa.paged_decode_attention_int4(*args),
                    pa.paged_decode_attention_int4_reference(*args))
        zeros(name, case, got[5])
    ks, vs = (quantize(x) for x in _arena(gen, torch.float32, 512))
    pt = _page_table(gen, 1, 500, 512)
    chunk, chunks = pa.decode_split(500, PS, 1, HKV)
    args = (_unit(gen, (1, H, HD), dtype), ks, vs, pt,
            torch.tensor([8000], **i32), PS, None, 0)
    check(name, dtype, f"B=1 lens=8000 ({chunks} chunks of {chunk})",
          pa.paged_decode_attention_int4(*args),
          pa.paged_decode_attention_int4_reference(*args))
    for h, hkv in ((8, 8), (16, 8), (16, 2)):
        kq, vq = (quantize(_unit(gen, (256 * PS, hkv, 64), torch.float32))
                  for _ in range(2))
        pt = _page_table(gen, 3, 80, 256)
        ln = torch.tensor([1200, 7, 0], **i32)
        args = (_unit(gen, (3, h, 64), dtype), kq, vq, pt, ln, PS, None, 0)
        check(name, dtype, f"hd=64 H={h} Hkv={hkv} lens {ln.tolist()}",
              pa.paged_decode_attention_int4(*args),
              pa.paged_decode_attention_int4_reference(*args))


def ragged_edges(gen, dtype, check, zeros):
    """Phase 2 edge cases of the split ragged kernel, each launched twice
    (bit for bit): at Llama-3-8B heads (segments of at most 16 rows) runs
    of 1, 3, 8 and 24 rows, the 24-row run crossing two row-tile
    boundaries, a lens=0 row and padding rows, causal without and with a
    window that starts mid-chunk; the same runs at g = 1 (segments of up
    to 64 rows, all four runs in one row tile); tree rows (3 x 8 over
    prefixes of 3000, 100 and 1500 tokens, a 1-row member, a lens=0 row,
    padding); and the causal and tree cases with their rows shuffled, so
    that one sequence's rows interleave with others' and padding rows sit
    between members (more segments than the planned grid: its last CTAs
    walk the rest)."""
    import torch

    from bloombee_tpu_torch.ops.cuda import paged_attention as pa

    name = "paged_ragged_attention"
    i32 = dict(dtype=torch.int32, device="cuda")
    runs = (1, 3, 8, 24)
    lens = torch.tensor([1000, 40, 700, 2000, 0, 5], **i32)
    q_seq = torch.cat([torch.full((n,), s, **i32) for s, n in enumerate(runs)]
                      + [torch.tensor([4, 7, 7, 7], **i32)])
    q_pos = torch.cat([torch.arange(int(lens[s]) - n, int(lens[s]), **i32)
                       for s, n in enumerate(runs)]
                      + [torch.zeros((4,), **i32)])
    dead = [36, 37, 38, 39]  # the lens=0 row and the padding rows
    for h, hkv in ((H, HKV), (8, 8)):
        ks = _unit(gen, (1024 * PS, hkv, HD), dtype)
        vs = _unit(gen, (1024 * PS, hkv, HD), dtype)
        pt = _page_table(gen, 6, 128, 1024)
        chunk, chunks, _ = pa.ragged_split(128, PS, 40, hkv, h // hkv, 6)
        mid = 300 if (2000 - 300) % chunk else 301  # row 35's window
        for window in (0, mid):
            case = (f"H={h} Hkv={hkv} runs {runs} + lens=0 + 3 padding "
                    f"(segments of <= {pa.RAGGED_ROWS * hkv // h} rows, "
                    f"{chunks} chunks of {chunk}) window={window}")
            args = (_unit(gen, (40, h, HD), dtype), ks, vs, pt, lens, q_seq,
                    q_pos, PS, None, window)
            got = twice(name, dtype, case, check,
                        lambda: pa.paged_ragged_attention(*args),
                        pa.paged_ragged_attention_reference(*args))
            zeros(name, case, got[dead])
        if h == H:  # the same rows shuffled
            perm = torch.randperm(40, generator=gen, device="cuda")
            args = (_unit(gen, (40, h, HD), dtype), ks, vs, pt, lens,
                    q_seq[perm].contiguous(), q_pos[perm].contiguous(), PS,
                    None, mid)
            case = f"H={h} Hkv={hkv} the causal rows shuffled, window={mid}"
            got = twice(name, dtype, case, check,
                        lambda: pa.paged_ragged_attention(*args),
                        pa.paged_ragged_attention_reference(*args))
            zeros(name, case, got[torch.argsort(perm)[dead]])

    prefix = torch.tensor([3000, 100, 1500, 600], **i32)
    nt = torch.tensor([8, 8, 8, 1, 0], **i32)
    lens = torch.cat([prefix + nt[:4], torch.zeros((1,), **i32)])
    tree_rows = torch.zeros((32, 8), **i32)
    for s in range(3):
        tree_rows[8 * s:8 * s + 8] = _tree(8, gen).to(torch.int32).cuda()
    tree_rows[24, 0] = 1
    q_seq = torch.tensor([0] * 8 + [1] * 8 + [2] * 8 + [3, 4] + [9] * 6,
                         **i32)
    ks, vs = _arena(gen, dtype, 1536)
    pt = _page_table(gen, 5, 256, 1536)
    args = (_unit(gen, (32, H, HD), dtype), ks, vs, pt, lens, q_seq,
            torch.zeros((32,), **i32), PS)
    tree = dict(nt=nt, tree_rows=tree_rows)
    case = "tree 3 x 8 rows over 3000/100/1500 + 1-row member + lens=0 + pad"
    got = twice(name, dtype, case, check,
                lambda: pa.paged_ragged_attention(*args, **tree),
                pa.paged_ragged_attention_reference(*args, **tree))
    zeros(name, case, got[25:])
    perm = torch.randperm(32, generator=gen, device="cuda")
    args = (args[0][perm].contiguous(), *args[1:5],
            q_seq[perm].contiguous(), *args[6:])
    tree = dict(nt=nt, tree_rows=tree_rows[perm].contiguous())
    case = "tree rows shuffled"
    got = twice(name, dtype, case, check,
                lambda: pa.paged_ragged_attention(*args, **tree),
                pa.paged_ragged_attention_reference(*args, **tree))
    zeros(name, case, got[torch.argsort(perm)[25:]])


def chunk_edges(gen, dtype, check, zeros):
    """Phase 2 edge cases of the split chunk kernel, each launched twice
    (bit for bit): at Llama-3-8B heads (row tiles of 16 tokens), B=8 with a
    lens 0 sequence and a context shorter than the step, T 2, 8, 32 and 64
    with t_real < T (padding rows exact zeros), windows that start
    mid-chunk, tree mode at T 8 and 64; B=1 over 8000 tokens (every chunk
    of a full cluster ~1000 keys long) causal and tree; and hd 64 at g 1
    and 8 and hd 128 at g 2, causal and tree, with a tree of 544 tokens at
    g 1 whose full row tiles read the mask from device memory (too wide to
    pack)."""
    import torch

    from bloombee_tpu_torch.ops.cuda import paged_attention as pa

    name = "paged_chunk_attention"
    i32 = dict(dtype=torch.int32, device="cuda")

    def run(case, q, ks, vs, pt, lens, tree=None, window=0, t_real=None):
        args = (q, ks, vs, pt, lens, PS, tree, None, window, t_real)
        b, t, h = q.shape[:3]
        chunks, tiles = pa.chunk_split(b, t, ks.shape[1], h // ks.shape[1],
                                       pt.shape[1])
        got = twice(name, dtype, f"{case} ({tiles} row tiles x {chunks} "
                    f"chunks)", check,
                    lambda: pa.paged_chunk_attention(*args),
                    pa.paged_chunk_attention_reference(*args))
        for i in range(b):
            if int(lens[i]) == 0:
                zeros(name, case, got[i])
        if tree is None and t_real is not None and t_real < t:
            zeros(name, case, got[:, t_real:])

    ks, vs = _arena(gen, dtype, 1024)
    pt = _page_table(gen, 8, 128, 1024)
    for t, t_real in ((2, 2), (8, 5), (32, 24), (64, 64)):
        lens = torch.tensor([1000, t_real, 17 + t_real, 2047, 0, 300,
                             t_real - 1, 129], **i32)
        q = _unit(gen, (8, t, H, HD), dtype)
        run(f"B=8 T={t} t_real={t_real} lens {lens.tolist()}", q, ks, vs,
            pt, lens, t_real=t_real)
        if t == 32:  # the windows start mid-page, so mid-chunk
            run(f"B=8 T=32 t_real=24 window=300", q, ks, vs, pt, lens,
                window=300, t_real=t_real)
    for t in (8, 64):
        lens = torch.tensor([1000, t, 17 + t, 2047, 0, 300, 640, 129],
                            **i32)
        tree = torch.stack([_tree(t, gen) for _ in range(8)]).cuda()
        run(f"B=8 tree T={t} lens {lens.tolist()}",
            _unit(gen, (8, t, H, HD), dtype), ks, vs, pt, lens, tree=tree)
    pt = _page_table(gen, 1, 512, 1024)
    lens = torch.tensor([8000], **i32)
    run("B=1 T=32 t_real=24 lens 8000", _unit(gen, (1, 32, H, HD), dtype),
        ks, vs, pt, lens, t_real=24)
    run("B=1 tree T=8 lens 8000", _unit(gen, (1, 8, H, HD), dtype), ks, vs,
        pt, lens, tree=_tree(8, gen)[None].cuda())

    for hd, h, hkv in ((64, 8, 8), (64, 16, 2), (128, 4, 2)):
        geo = f"hd={hd} H={h} Hkv={hkv}"
        ks = _unit(gen, (256 * PS, hkv, hd), dtype)
        vs = _unit(gen, (256 * PS, hkv, hd), dtype)
        pt = _page_table(gen, 3, 64, 256)
        lens = torch.tensor([1000, 0, 77], **i32)
        run(f"{geo} B=3 T=32 t_real=20 lens {lens.tolist()}",
            _unit(gen, (3, 32, h, hd), dtype), ks, vs, pt, lens, t_real=20)
        tree = torch.stack([_tree(40, gen) for _ in range(3)]).cuda()
        run(f"{geo} B=3 tree T=40 lens {lens.tolist()}",
            _unit(gen, (3, 40, h, hd), dtype), ks, vs, pt, lens, tree=tree)
        if h == hkv:
            pt = _page_table(gen, 1, 128, 256)
            run(f"{geo} B=1 tree T=544 lens 1400",
                _unit(gen, (1, 544, h, hd), dtype), ks, vs, pt,
                torch.tensor([1400], **i32), tree=_tree(544, gen)[None].cuda())


def ragged_mix(gen, dtype, window_case: bool):
    """The ragged kernel's causal mix at Llama-3-8B heads: 4 decode rows,
    a 24-row chunk, a row of a lens=0 sequence, 3 padding rows (R=32,
    B=6); or (tree) 4 sessions x 8 tree rows."""
    import torch

    i32 = dict(dtype=torch.int32, device="cuda")
    phys = 1024
    ks, vs = _arena(gen, dtype, phys)
    if not window_case:
        lens = torch.tensor([1000, 777, 1024, 500], **i32) + 8
        nt = torch.full((4,), 8, **i32)
        tree_rows = torch.cat(
            [_tree(8, gen) for _ in range(4)]
        ).to(torch.int32).cuda()
        q_seq = torch.arange(4, **i32).repeat_interleave(8)
        q_pos = (lens - 8).repeat_interleave(8)  # depths do not matter
        pt = _page_table(gen, 4, 80, phys)
        q = _unit(gen, (32, H, HD), dtype)
        return (q, ks, vs, pt, lens, q_seq, q_pos, PS), dict(
            nt=nt, tree_rows=tree_rows
        )
    lens = torch.tensor([1000, 777, 1024, 1, 1032, 0], **i32)
    q_seq = torch.tensor([0, 1, 2, 3] + [4] * 24 + [5, 6, 6, 6], **i32)
    q_pos = torch.cat([
        lens[:4] - 1, torch.arange(1008, 1032, **i32),
        torch.zeros((4,), **i32),
    ])
    pt = _page_table(gen, 6, 80, phys)
    q = _unit(gen, (32, H, HD), dtype)
    return (q, ks, vs, pt, lens, q_seq, q_pos, PS), {}


def phase_kernels_ragged_int4(gen, dtype, check):
    """Phase 2 cases of the ragged and the int4 decode kernel at Llama-3-8B
    head geometry."""
    import torch

    from bloombee_tpu_torch.kv.quant import quantize
    from bloombee_tpu_torch.ops.cuda import paged_attention as pa

    args, _ = ragged_mix(gen, dtype, window_case=True)
    for window in (0, 100):
        check("paged_ragged_attention", dtype,
              f"4 decode + 24-row chunk + lens=0 row + 3 padding, "
              f"window={window}",
              pa.paged_ragged_attention(*args, window=window),
              pa.paged_ragged_attention_reference(*args, window=window))
    args, tree = ragged_mix(gen, dtype, window_case=False)
    check("paged_ragged_attention", dtype, "tree 4 x 8 rows",
          pa.paged_ragged_attention(*args, **tree),
          pa.paged_ragged_attention_reference(*args, **tree))

    i32 = dict(dtype=torch.int32, device="cuda")
    ks, vs = _arena(gen, torch.float32, 1024)
    kq, vq = quantize(ks), quantize(vs)
    pt = _page_table(gen, 4, 64, 1024)
    lens = torch.tensor([1000, 777, 0, 1024], **i32)
    qd = _unit(gen, (4, H, HD), dtype)
    for window in (0, 100):
        args = (qd, kq, vq, pt, lens, PS, None, window)
        check("paged_decode_attention_int4", dtype,
              f"window={window} lens=0 row",
              pa.paged_decode_attention_int4(*args),
              pa.paged_decode_attention_int4_reference(*args))


def ragged_mixed_shape(gen, ks, vs):
    """The ragged kernel's args at the serving mixed step's shape: 4
    decode rows at 1057/1033 tokens + a fresh session's 32-token chunk +
    28 padding rows (R bucket 64), the executor's 128-page bucket."""
    import torch

    i32 = dict(dtype=torch.int32, device="cuda")
    lens = torch.tensor([1057, 1033, 1033, 1033, 32], **i32)
    q_seq = torch.tensor([0, 1, 2, 3] + [4] * 32 + [5] * 28, **i32)
    q_pos = torch.cat([
        lens[:4] - 1, torch.arange(32, **i32), torch.zeros((28,), **i32)
    ])
    pt = _page_table(gen, 5, 128, 1024)
    q = _unit(gen, (64, H, HD), torch.bfloat16)
    return (q, ks, vs, pt, lens, q_seq, q_pos, PS, HD**-0.5, 0)


def ragged_tree_shape(gen, ks, vs):
    """The ragged kernel's args at the serving tree step's shape: 4
    sessions x 8 tree rows (t_max 8) over 1056/1032-token prefixes, the
    executor's 128-page bucket."""
    import torch

    i32 = dict(dtype=torch.int32, device="cuda")
    lens = torch.tensor([1064, 1040, 1040, 1040], **i32)
    trees = [_tree(8, gen) for _ in range(4)]
    tree_rows = torch.cat(trees).to(torch.int32).cuda()
    depths = torch.cat([t.sum(-1) - 1 for t in trees]).to(torch.int32).cuda()
    q_seq = torch.arange(4, **i32).repeat_interleave(8)
    q_pos = (lens - 8).repeat_interleave(8) + depths
    pt = _page_table(gen, 4, 128, 1024)
    q = _unit(gen, (32, H, HD), torch.bfloat16)
    nt = torch.full((4,), 8, **i32)
    args = (q, ks, vs, pt, lens, q_seq, q_pos, PS, HD**-0.5, 0)
    return args, dict(nt=nt, tree_rows=tree_rows)


def time_ragged_int4(gen, extra) -> list[tuple]:
    """bf16 times of the ragged and int4 kernels at the serving run's
    shapes (phase 4): the ragged step of 4 decode rows at ~1.05k tokens +
    a fresh session's 32-token chunk (R bucket 64; the row's own time),
    the ragged tree step of 4 x 8 tree rows (`tree_*` keys), and int4
    decode of 4 sessions at 1001 tokens (warm; cold L2 and host-paced
    into `extra`)."""
    import torch

    from bloombee_tpu_torch.kv.quant import quantize
    from bloombee_tpu_torch.ops.cuda import paged_attention as pa

    dt = torch.bfloat16
    i32 = dict(dtype=torch.int32, device="cuda")
    scale = HD**-0.5
    rows = []

    ks, vs = _arena(gen, dt, 1024)
    args = ragged_mixed_shape(gen, ks, vs)
    q, pt, lens, q_seq, q_pos = (args[i] for i in (0, 3, 4, 5, 6))
    ms = cuda_ms(lambda: pa.paged_ragged_attention(*args))
    plain = cuda_ms(lambda: pa.paged_ragged_attention_reference(*args))
    ragged = extra["paged_ragged_attention"] = {"host_paced_ms": cuda_ms(
        lambda: pa.paged_ragged_attention(*args), host_paced=True
    )}
    kv_rows = int(lens[:4].sum()) + 32  # each member's visible rows, once
    pairs = int(lens[:4].sum()) + 32 * 33 // 2  # visible (query, key)
    b_ms, by = bound(
        2 * kv_rows * HKV * HD * 2 + 2 * 36 * H * HD * 2
        + nbytes(pt[:, :67], lens, q_seq[:36], q_pos[:36]),
        4 * pairs * H * HD, dt,
    )
    rows.append(("paged_ragged_attention", ms, plain, b_ms, by, None))

    args, tree = ragged_tree_shape(gen, ks, vs)
    q, lens, pt = args[0], args[4], args[3]
    ragged["tree_ms"] = cuda_ms(lambda: pa.paged_ragged_attention(
        *args, **tree))
    ragged["tree_plain_ms"] = cuda_ms(
        lambda: pa.paged_ragged_attention_reference(*args, **tree))
    prefix = int((lens - 8).sum())  # each sequence's prefix, read once
    vis = int(tree["tree_rows"].sum())  # visible in-step (row, key) pairs
    ragged["tree_bound_ms"], ragged["tree_bound_by"] = bound(
        2 * (prefix + 32) * HKV * HD * 2 + nbytes(q, q, lens, *tree.values())
        + nbytes(args[5], args[6], pt[:, :67]),
        4 * (8 * prefix + vis) * H * HD, dt,
    )

    kq, vq = quantize(ks), quantize(vs)
    lens = torch.full((4,), 1001, **i32)
    pt = _page_table(gen, 4, 64, 1024)
    qd = _unit(gen, (4, H, HD), dt)
    args = (qd, kq, vq, pt, lens, PS, scale, 0)
    ms = cuda_ms(lambda: pa.paged_decode_attention_int4(*args))
    plain = cuda_ms(lambda: pa.paged_decode_attention_int4_reference(*args))
    extra["paged_decode_attention_int4"] = {
        "cold_ms": cuda_ms_cold(
            lambda: pa.paged_decode_attention_int4(*args)),
        "host_paced_ms": cuda_ms(
            lambda: pa.paged_decode_attention_int4(*args), host_paced=True),
    }
    kv_rows = 4 * 1001
    per_row = HD // 2 + 2 * (HD // 32) * 2  # codes + f16 scale and zero
    b_ms, by = bound(
        2 * kv_rows * HKV * per_row + nbytes(qd, qd, pt, lens),
        4 * kv_rows * H * HD, dt,
    )
    rows.append(("paged_decode_attention_int4", ms, plain, b_ms, by, None))
    return rows


# ------------------------------------------------------------- model
def llama3_8b(layers: int):
    from bloombee_tpu_torch.models.spec import ModelSpec

    return ModelSpec(
        family="llama", hidden_size=4096, intermediate_size=14336,
        num_attention_heads=H, num_key_value_heads=HKV, head_dim=HD,
        num_hidden_layers=layers, vocab_size=128256, rms_norm_eps=1e-5,
        rope_theta=500000.0,
    )


def random_model(spec, dtype, seed):
    import torch

    from bloombee_tpu_torch.models.llama.block import init_block_params

    gen = torch.Generator(device="cuda").manual_seed(seed)
    layers = [
        init_block_params(gen, spec, dtype=dtype, device="cuda")
        for _ in range(spec.num_hidden_layers)
    ]
    d, vocab = spec.hidden_size, spec.vocab_size
    client = {
        "embed": torch.randn(
            (vocab, d), generator=gen, device="cuda"
        ).to(dtype),
        "norm": torch.ones((d,), device="cuda", dtype=dtype),
        "lm_head": (
            torch.randn((d, vocab), generator=gen, device="cuda") * d**-0.5
        ).to(dtype),
    }
    return layers, client, gen


# ------------------------------------------------------------- phase 3
def phase_f32_path():
    import torch

    from bloombee_tpu_torch.kv.cache_manager import CacheManager
    from bloombee_tpu_torch.models.head import embed_impl, norm_head_impl
    from bloombee_tpu_torch.models.llama.block import (
        block_forward,
        dense_attend,
    )
    from bloombee_tpu_torch.ops.cuda import build
    from bloombee_tpu_torch.ops.rotary import rotary_cos_sin
    from bloombee_tpu_torch.runtime.executor import SpanExecutor

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    spec = llama3_8b(4)
    layers, client, gen = random_model(spec, torch.float32, seed=7)
    eps = spec.rms_norm_eps

    def head(h):
        return norm_head_impl(client, h, eps).argmax(-1)

    async def run():
        manager = CacheManager(
            4, 256, PS, HKV, HD, dtype=torch.float32, device="cuda"
        )
        ex = SpanExecutor(
            layers, spec, manager, max_chunk_tokens=512,
            compute_dtype=torch.float32, device="cuda",
        )
        ids = torch.randint(
            0, spec.vocab_size, (2, 1000), generator=gen, device="cuda"
        )
        build.reset_launch_counts()
        async with manager.allocate(2, 1100) as handle:
            outs = [ex.prefill(handle, embed_impl(client, ids), fetch=False)]
            fed = [ids]
            nxt = head(outs[-1][:, -1])
            greedy = [nxt]
            for _ in range(8):
                fed.append(nxt[:, None])
                outs.append(
                    ex.decode(handle, embed_impl(client, nxt[:, None]),
                              fetch=False)
                )
                nxt = head(outs[-1][:, -1])
                greedy.append(nxt)
            follow = torch.randint(
                0, spec.vocab_size, (2, 24), generator=gen, device="cuda"
            )
            fed.append(follow)
            outs.append(
                ex.decode(handle, embed_impl(client, follow), fetch=False)
            )
        return torch.cat(outs, 1), torch.cat(fed, 1), torch.stack(greedy, 1)

    out, fed, greedy = asyncio.run(run())
    torch.cuda.synchronize()
    launches = dict(build.LAUNCHES)
    with torch.no_grad():
        h = embed_impl(client, fed)
        pos = torch.arange(fed.shape[1], device="cuda")[None].expand(2, -1)
        cos, sin = rotary_cos_sin(pos, HD, spec.rope_theta)
        for p in layers:
            h, _ = block_forward(p, spec, h, cos, sin, dense_attend())
        ref_greedy = head(h[:, 999:1008])
    err = (out - h).abs().max().item()
    lim = 1e-3 * h.abs().max().item()
    tokens_ok = torch.equal(ref_greedy, greedy) and torch.equal(
        head(out[:, -1]), head(h[:, -1])
    )
    say(f"[f32-path] 4 layers, hidden {spec.hidden_size}: prefill 1000 x2 + "
        f"8 decodes + 24-token follow-up vs dense reference: max_abs_err="
        f"{err:.3e} (limit {lim:.3e}), greedy tokens identical: {tokens_ok}, "
        f"launches {launches}")
    if not (err <= lim and tokens_ok and torch.isfinite(out).all().item()):
        raise AssertionError("f32 whole-path check failed")
    want = {"flash_attention", "paged_decode_attention",
            "paged_chunk_attention"}
    if set(launches) != want:
        raise AssertionError(f"f32 path missed kernels: {launches}")
    f32_ragged(layers, client, spec, gen)
    f32_int4(layers, client, spec, gen)
    f32_served(layers, client, spec, fed, out, greedy)
    del layers, client
    torch.cuda.empty_cache()
    f32_group3()


def executor_pair(layers, spec, manager, dtype):
    """An executor on the kernel routes and one on the dense routes (its
    BBTPU_PAGED_MIN_CONTEXT above any context), on the same manager."""
    import os

    from bloombee_tpu_torch.runtime.executor import SpanExecutor

    def make():
        return SpanExecutor(
            layers, spec, manager, max_chunk_tokens=512,
            compute_dtype=dtype, device="cuda",
        )

    kernel = make()
    old = os.environ.get("BBTPU_PAGED_MIN_CONTEXT")
    os.environ["BBTPU_PAGED_MIN_CONTEXT"] = str(1 << 30)
    try:
        dense = make()
    finally:
        if old is None:
            del os.environ["BBTPU_PAGED_MIN_CONTEXT"]
        else:
            os.environ["BBTPU_PAGED_MIN_CONTEXT"] = old
    return kernel, dense


def tree_member(t, gen):
    """[1, t, t] ancestor mask and [1, t] depths of a random tree."""
    import torch

    tm = _tree(t, gen)
    depths = tm.sum(-1).to(torch.int32) - 1  # ancestors, self excluded
    return tm[None].numpy(), depths[None].numpy()


def f32_ragged(layers, client, spec, gen):
    """Phase 3, ragged: one ragged_group of 2 decode rows + a 24-token
    chunk, and one of 2 decode rows + an 8-node tree, on the ragged
    kernel's route, against the same members run solo and against the
    dense attend_ragged route."""
    import torch

    from bloombee_tpu_torch.kv.cache_manager import CacheManager
    from bloombee_tpu_torch.models.head import embed_impl, norm_head_impl
    from bloombee_tpu_torch.ops.cuda import build

    def head(h):
        return norm_head_impl(client, h, spec.rms_norm_eps).argmax(-1)

    def ids(n, b=1):
        return torch.randint(
            0, spec.vocab_size, (b, n), generator=gen, device="cuda"
        )

    manager = CacheManager(4, 512, PS, HKV, HD, dtype=torch.float32,
                           device="cuda")
    ex, ex_dense = executor_pair(layers, spec, manager, torch.float32)
    results = []

    async def run():
        async with manager.allocate(2, 1100) as a, \
                manager.allocate(1, 700) as c:
            nxt = head(ex.prefill(a, embed_impl(client, ids(1000, 2)),
                                  fetch=False)[:, -1])
            ex.prefill(c, embed_impl(client, ids(600)), fetch=False)
            dec = embed_impl(client, nxt[:, None])  # 2 decode rows
            tm, dep = tree_member(8, gen)
            for name, member, tree, depths in (
                ("24-token chunk", embed_impl(client, ids(24)), None, None),
                ("8-node tree", embed_impl(client, ids(8)), tm, dep),
            ):
                snap = [manager.context_lens(h).tolist() for h in (a, c)]

                def rewind():
                    for h, lens in zip((a, c), snap):
                        manager.truncate_speculative(h, lens)

                solo_a, _ = ex.ragged_group([a], [dec])
                rewind()
                solo_c, _ = ex.ragged_group(
                    [c], [member], tree_masks=[tree], depths_list=[depths]
                )
                rewind()
                solo = torch.cat([solo_a, solo_c])
                outs = {}
                for route, e in (("kernel", ex), ("dense", ex_dense)):
                    build.reset_launch_counts()
                    out, _ = e.ragged_group(
                        [a, c], [dec, member], tree_masks=[None, tree],
                        depths_list=[None, depths],
                    )
                    torch.cuda.synchronize()
                    outs[route] = (out, dict(build.LAUNCHES))
                    rewind()
                results.append((name, solo, outs))

    asyncio.run(run())
    for name, solo, outs in results:
        (fused, launches), (dense, dense_launches) = (
            outs["kernel"], outs["dense"]
        )
        lim = 1e-3 * solo.abs().max().item()
        err_solo = (fused - solo).abs().max().item()
        err_dense = (fused - dense).abs().max().item()
        tokens = torch.equal(head(fused), head(solo)) and torch.equal(
            head(fused), head(dense)
        )
        say(f"[f32-ragged] 2 decode rows + {name}: fused vs solo "
            f"max_abs_err={err_solo:.3e}, vs dense attend_ragged "
            f"{err_dense:.3e} (limit {lim:.3e}), greedy tokens identical: "
            f"{tokens}, launches kernel route {launches}, dense route "
            f"{dense_launches}")
        ok = (
            err_solo <= lim and err_dense <= lim and tokens
            and torch.isfinite(fused).all().item()
            and launches.get("paged_ragged_attention", 0) == 4
            and "paged_ragged_attention" not in dense_launches
        )
        if not ok:
            raise AssertionError(f"f32 ragged check failed: {name}")


def f32_int4(layers, client, spec, gen):
    """Phase 3, int4: an int4 arena prefilled with 1000 tokens x2, then 8
    greedy decodes on the int4 kernel's route against the same 8 decodes
    on the dense route over the same arena."""
    import torch

    from bloombee_tpu_torch.kv.cache_manager import CacheManager
    from bloombee_tpu_torch.models.head import embed_impl, norm_head_impl
    from bloombee_tpu_torch.ops.cuda import build

    def head(h):
        return norm_head_impl(client, h, spec.rms_norm_eps).argmax(-1)

    manager = CacheManager(4, 256, PS, HKV, HD, dtype=torch.float32,
                           device="cuda", quant="int4")
    ex, ex_dense = executor_pair(layers, spec, manager, torch.float32)
    runs = {}

    async def run():
        async with manager.allocate(2, 1100) as h:
            ids = torch.randint(0, spec.vocab_size, (2, 1000), generator=gen,
                                device="cuda")
            first = head(ex.prefill(h, embed_impl(client, ids),
                                    fetch=False)[:, -1])
            for route, e in (("kernel", ex), ("dense", ex_dense)):
                build.reset_launch_counts()
                nxt, outs, tokens = first, [], []
                for _ in range(8):
                    out = e.decode(h, embed_impl(client, nxt[:, None]),
                                   commit=False, fetch=False)
                    nxt = head(out[:, -1])
                    outs.append(out)
                    tokens.append(nxt)
                manager.rollback(h)
                torch.cuda.synchronize()
                runs[route] = (torch.cat(outs, 1), torch.stack(tokens, 1),
                               dict(build.LAUNCHES))

    asyncio.run(run())
    (out, tokens, launches), (ref, ref_tokens, dense_launches) = (
        runs["kernel"], runs["dense"]
    )
    lim = 1e-3 * ref.abs().max().item()
    err = (out - ref).abs().max().item()
    same = torch.equal(tokens, ref_tokens)
    say(f"[f32-int4] int4 arena, prefill 1000 x2 + 8 greedy decodes, int4 "
        f"kernel route vs dense route: max_abs_err={err:.3e} (limit "
        f"{lim:.3e}), greedy tokens identical: {same}, launches kernel "
        f"route {launches}, dense route {dense_launches}")
    if not (err <= lim and same and torch.isfinite(out).all().item()
            and launches.get("paged_decode_attention_int4", 0) == 32
            and "paged_decode_attention_int4" not in dense_launches):
        raise AssertionError("f32 int4 check failed")


def f32_group3():
    """Phase 3, routing outside the kernels' shape domain: H=24, Hkv=8
    (GQA group 3), hd=128, 2 layers in f32. A 600-token prefill (a 512-token
    flash bucket and an 88-token chunk) and 4 decodes past the paged
    crossover must take the dense routes, with no paged or flash launch,
    and match block_forward + dense_attend."""
    import torch

    from bloombee_tpu_torch.kv.cache_manager import CacheManager
    from bloombee_tpu_torch.models.llama.block import (
        block_forward,
        dense_attend,
        init_block_params,
    )
    from bloombee_tpu_torch.models.spec import ModelSpec
    from bloombee_tpu_torch.ops.cuda import build
    from bloombee_tpu_torch.ops.rotary import rotary_cos_sin
    from bloombee_tpu_torch.runtime.executor import SpanExecutor

    spec = ModelSpec(
        family="llama", hidden_size=3072, intermediate_size=8192,
        num_attention_heads=24, num_key_value_heads=8, head_dim=HD,
        num_hidden_layers=2, vocab_size=32000, rms_norm_eps=1e-5,
        rope_theta=500000.0,
    )
    gen = torch.Generator(device="cuda").manual_seed(3)
    layers = [
        init_block_params(gen, spec, dtype=torch.float32, device="cuda")
        for _ in range(2)
    ]
    manager = CacheManager(2, 64, PS, 8, HD, dtype=torch.float32,
                           device="cuda")
    ex = SpanExecutor(layers, spec, manager, max_chunk_tokens=512,
                      compute_dtype=torch.float32, device="cuda")
    x = torch.randn((1, 604, spec.hidden_size), generator=gen, device="cuda")

    async def run():
        async with manager.allocate(1, 640) as h:
            outs = [ex.prefill(h, x[:, :600], fetch=False)]
            for i in range(600, 604):
                outs.append(ex.decode(h, x[:, i : i + 1], fetch=False))
        return torch.cat(outs, 1)

    torch.cuda.synchronize()
    build.reset_launch_counts()
    out = asyncio.run(run())
    torch.cuda.synchronize()
    launches = dict(build.LAUNCHES)
    with torch.no_grad():
        ref = x
        pos = torch.arange(604, device="cuda")[None]
        cos, sin = rotary_cos_sin(pos, HD, spec.rope_theta)
        for p in layers:
            ref, _ = block_forward(p, spec, ref, cos, sin, dense_attend())
    err = (out - ref).abs().max().item()
    lim = 1e-3 * ref.abs().max().item()
    say(f"[f32-group3] H=24 Hkv=8 hd=128, 2 layers: prefill 600 + 4 decodes "
        f"on the dense routes (paged_supported={ex.paged_supported}, "
        f"flash_supported={ex.flash_supported}) vs dense reference: "
        f"max_abs_err={err:.3e} (limit {lim:.3e}), launches {launches}")
    if (ex.paged_supported or ex.flash_supported or launches
            or not err <= lim or not torch.isfinite(out).all().item()):
        raise AssertionError("group-3 routing check failed")


class ServerLoop:
    """An event loop in a background thread for the port registry and
    servers, so the client's loop (the caller's `asyncio.run`) and its
    device syncs never stall the servers' RPC handling."""

    def __enter__(self) -> "ServerLoop":
        import threading

        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self.loop.run_forever,
                                       daemon=True)
        self.thread.start()
        return self

    def run(self, coro, timeout: float = 600.0):
        return asyncio.run_coroutine_threadsafe(coro, self.loop).result(
            timeout
        )

    def __exit__(self, *exc) -> None:
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(30)
        self.loop.close()


async def start_span_servers(layers, spec, uid, spans, dtype, num_pages):
    """A port registry and one port BlockServer per span [(start, end)] on
    the card, over slices of `layers` (shared tensors, no copy)."""
    from bloombee_tpu_torch.server.block_server import BlockServer
    from bloombee_tpu_torch.swarm.registry import (
        RegistryClient,
        RegistryServer,
    )

    reg = RegistryServer(host="127.0.0.1")
    await reg.start()
    servers = []
    for start, end in spans:
        server = BlockServer(
            model_uid=uid, start=start, end=end, params=layers[start:end],
            spec=spec, registry=RegistryClient("127.0.0.1", reg.port),
            num_pages=num_pages, page_size=PS, compute_dtype=dtype,
            max_chunk_tokens=512, throughput=1.0, device="cuda",
        )
        await server.start()
        servers.append(server)
    return reg, servers


async def stop_span_servers(reg, servers):
    for server in servers:
        await server.stop()
        await server.registry.close()
    await reg.stop()


def port_client(client, spec, reg_port, uid):
    """The port's DistributedModelForCausalLM over the in-memory client
    parameters, routing with a RemoteSequenceManager over the port
    registry (push on). The caller closes `model.manager.registry`."""
    from bloombee_tpu_torch.client import (
        ClientConfig,
        DistributedModelForCausalLM,
        RemoteSequenceManager,
    )
    from bloombee_tpu_torch.swarm.registry import RegistryClient

    manager = RemoteSequenceManager(
        RegistryClient("127.0.0.1", reg_port), uid, spec.num_hidden_layers
    )
    return DistributedModelForCausalLM(
        spec, client, manager, config=ClientConfig(use_push=True),
        device="cuda",
    )


def tap(session, model) -> dict:
    """Record, without changing them, what an open session's steps return
    ("outs"), every reply meta its span streams receive ("metas": (span,
    meta)) and when the model embeds ("embeds": host clock). generate
    embeds the prompt first and then each token as soon as it is selected
    (the selection's copy to the host has synchronized the device), so the
    first gap is the time to the first token and later gaps are per-token
    times: step + head + embed."""
    rec = {"outs": [], "metas": [], "embeds": []}
    step, embed = session.step, model.embed

    async def tapped_step(*args, **kwargs):
        out = await step(*args, **kwargs)
        rec["outs"].append(out)
        return out

    def tapped_embed(ids):
        rec["embeds"].append(time.perf_counter())
        return embed(ids)

    def tapped_recv(k, recv):
        async def recv_meta():
            item = await recv()
            if item is not None:
                rec["metas"].append((k, item[0]))
            return item
        return recv_meta

    session.step, model.embed = tapped_step, tapped_embed
    for k, span in enumerate(session._spans):
        span.stream.recv = tapped_recv(k, span.stream.recv)
    return rec


def f32_served(layers, client, spec, fed, want_out, want_greedy):
    """Phase 3, served: two port BlockServers on the card over the same 4
    layers (blocks [0, 2) and [2, 4)) and a port registry; the port
    client (f32 parameters) generates 9 greedy tokens through push
    routing for the batch-2 prompt of 1000 tokens (a prefill and 8 decode
    steps). Outputs must match the executor's within 1e-3 x max|ref| with
    identical greedy tokens."""
    import torch

    async def run(reg_port):
        model = port_client(client, spec, reg_port, "chip-f32")
        try:
            async with model.inference_session(1100, 2) as session:
                rec = tap(session, model)
                ids = await model.generate(fed[:, :1000], max_new_tokens=9,
                                           session=session)
                route = [(s.span.start, s.span.end) for s in session._spans]
        finally:
            await model.manager.registry.close()
        return route, torch.cat(rec["outs"], 1), ids[:, 1000:]

    with ServerLoop() as servers_loop:
        reg, servers = servers_loop.run(start_span_servers(
            layers, spec, "chip-f32", ((0, 2), (2, 4)), torch.float32, 256
        ))
        try:
            route, out, greedy = asyncio.run(run(reg.port))
        finally:
            servers_loop.run(stop_span_servers(reg, servers))
    ref = want_out[:, :1008]
    err = (out - ref).abs().max().item()
    lim = 1e-3 * ref.abs().max().item()
    same = torch.equal(greedy, want_greedy.cpu())
    say(f"[f32-served] port client through 2 port servers {route} via a "
        f"port registry, push route: prefill 1000 x2 + 8 greedy decodes vs "
        f"the executor: max_abs_err={err:.3e} (limit {lim:.3e}), greedy "
        f"tokens identical: {same}")
    if not (err <= lim and same and torch.isfinite(out).all().item()):
        raise AssertionError("f32 served chain check failed")


# ------------------------------------------------------------- phase 4
def profiled(label: str, fn, top: int = 12):
    """Time one untraced call of fn(), then trace it with torch.profiler
    (after one traced warmup call that absorbs the tracer's start-up), and
    print each kernel's device time and the kernels' share of the untraced
    wall time (tracing itself slows the host, so the traced wall time is
    not the baseline)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    for _ in range(2):  # the first traced call warms the tracer up
        with profile(activities=activities) as prof:
            fn()
            torch.cuda.synchronize()
    rows = sorted(
        (
            (evt.self_device_time_total / 1e3, evt.count, evt.key)
            for evt in prof.key_averages()
            if evt.device_type == DeviceType.CUDA
            and evt.self_device_time_total > 0
        ),
        reverse=True,
    )
    busy = sum(r[0] for r in rows)
    say(f"[profile] {label}: untraced wall {wall_ms:.2f} ms, traced kernels "
        f"{busy:.2f} ms -> device busy {100 * busy / wall_ms:.1f}%, idle "
        f"{100 - 100 * busy / wall_ms:.1f}%")
    for ms, count, key in rows[:top]:
        say(f"[profile]   {ms:9.3f} ms  x{count:<5d} {key[:90]}")


def median_s(fn, reps: int = 5) -> float:
    """Median host time of fn() ending in a device synchronize, after one
    untimed call."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return sorted(times)[reps // 2]


def serving_ragged(ex, manager, sessions, fresh, client, gen, outs):
    """Phase 4's ragged path, on the serving sessions: a ragged step of the
    4 sessions' decode rows + a fresh fifth session's 32-token chunk
    (r=36 -> rb=64, 64 x 32 heads = 2048: the ragged kernel's route), and a
    tree ragged step of 4 x 8-node trees; each beside the same work
    dispatched separately. Every step is rewound after it runs. Returns
    the median times, the launch counts of the fused steps ("ragged") and
    of the separately dispatched yardstick ("ragged_yardstick"), each set
    to 0 just before its steps run, and the steps by name (profiling)."""
    import collections

    import torch

    from bloombee_tpu_torch.models.head import embed_impl
    from bloombee_tpu_torch.ops.cuda import build

    vocab = client["embed"].shape[0]

    def embed(n):
        return embed_impl(client, torch.randint(
            0, vocab, (1, n), generator=gen, device="cuda"
        ))

    members = [*sessions, fresh]

    def rewound(fn):
        """fn as a step that leaves every member's length as it found it."""
        def step():
            snap = [manager.context_lens(h).tolist() for h in members]
            fn()
            for h, lens in zip(members, snap):
                manager.truncate_speculative(h, lens)
        return step

    decs = [embed(1) for _ in sessions]
    chunk = embed(32)
    trees = [tree_member(8, gen) for _ in sessions]
    drafts = [embed(8) for _ in sessions]

    @rewound
    def mixed():
        outs.append(ex.mixed_group(members, [*decs, chunk])[0])

    @rewound
    def mixed_separate():
        outs.append(ex.decode_group(sessions, decs)[0])
        outs.append(ex.prefill_chunk(fresh, chunk))

    @rewound
    def tree():
        outs.append(ex.tree_group(
            sessions, drafts, [t[0] for t in trees], [t[1] for t in trees]
        )[0])

    @rewound
    def tree_separate():
        for h, d, (tm, dep) in zip(sessions, drafts, trees):
            outs.append(ex.decode(h, d, commit=False, tree_mask=tm,
                                  depths=dep, fetch=False))

    launches = collections.defaultdict(collections.Counter)

    def timed(fn, path):
        build.reset_launch_counts()
        seconds = median_s(fn)
        torch.cuda.synchronize()
        launches[path].update(build.LAUNCHES)
        return seconds

    stats = {
        "mixed_s": timed(mixed, "ragged"),
        "mixed_separate_s": timed(mixed_separate, "ragged_yardstick"),
        "tree_s": timed(tree, "ragged"),
        "tree_separate_s": timed(tree_separate, "ragged_yardstick"),
    }
    steps = {"mixed": mixed, "tree": tree, "tree_separate": tree_separate}
    return stats, {k: dict(v) for k, v in launches.items()}, steps


def arena_gib(manager) -> float:
    from bloombee_tpu_torch.kv.quant import slab_nbytes

    return sum(slab_nbytes(slab) for slab in manager.arena.values()) / 2**30


def serving_int4(layers, spec, client, gen, profile: bool) -> dict:
    """Phase 4's int4 path: an int4 arena of 1024 pages, 4 sessions, a
    1000-token prefill each (flash over the dequantized pages), then 32
    decode_group steps (the int4 decode kernel); with `profile`, 4 more
    steps traced after the launch counts are read."""
    import torch

    from bloombee_tpu_torch.kv.cache_manager import CacheManager
    from bloombee_tpu_torch.models.head import embed_impl, norm_head_impl
    from bloombee_tpu_torch.ops.cuda import build
    from bloombee_tpu_torch.runtime.executor import SpanExecutor

    def head(h):
        return norm_head_impl(client, h, spec.rms_norm_eps).argmax(-1)

    manager = CacheManager(32, 1024, PS, HKV, HD, dtype=torch.bfloat16,
                           device="cuda", quant="int4")
    ex = SpanExecutor(layers, spec, manager, max_chunk_tokens=512,
                      compute_dtype=torch.bfloat16, device="cuda")
    prompts = torch.randint(0, spec.vocab_size, (4, 1000), generator=gen,
                            device="cuda")
    stats = {"arena_gib": arena_gib(manager)}

    async def run():
        async with contextlib.AsyncExitStack() as stack:
            handles = [
                await stack.enter_async_context(manager.allocate(1, 1600))
                for _ in range(4)
            ]
            torch.cuda.synchronize()
            build.reset_launch_counts()
            t0 = time.perf_counter()
            nxt = torch.cat([
                head(ex.prefill(h, embed_impl(client, prompts[i : i + 1]),
                                fetch=False)[:, -1])
                for i, h in enumerate(handles)
            ])
            torch.cuda.synchronize()
            stats["prefill_s"] = time.perf_counter() - t0
            outs, step_s = [], []

            def decode_step():
                nonlocal nxt
                hid = embed_impl(client, nxt[:, None])
                out, combined = ex.decode_group(
                    handles, [hid[i : i + 1] for i in range(4)]
                )
                manager.commit(combined)
                nxt = head(out[:, -1])
                outs.append(out)

            for _ in range(32):
                t1 = time.perf_counter()
                decode_step()
                torch.cuda.synchronize()
                step_s.append(time.perf_counter() - t1)
            stats["launches"] = dict(build.LAUNCHES)
            stats["finite"] = all(
                torch.isfinite(o.float()).all().item() for o in outs
            )
            if profile:
                profiled("4 decode_group steps (4 sessions, int4 arena)",
                         lambda: [decode_step() for _ in range(4)])
            steady = sorted(step_s[2:])
            stats["decode_step_s"] = steady[len(steady) // 2]

    asyncio.run(run())
    return stats


def phase_serving(profile: bool = False) -> dict[str, dict]:
    """Phase 4; returns each path's launch counts."""
    import torch

    from bloombee_tpu_torch.kv.cache_manager import CacheManager
    from bloombee_tpu_torch.models.head import embed_impl, norm_head_impl
    from bloombee_tpu_torch.ops.cuda import build
    from bloombee_tpu_torch.runtime.executor import SpanExecutor

    spec = llama3_8b(32)
    layers, client, gen = random_model(spec, torch.bfloat16, seed=11)
    torch.cuda.synchronize()
    say(f"[serving] Llama-3-8B bf16, 32 layers, weights "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card")
    eps = spec.rms_norm_eps

    def head(h):
        return norm_head_impl(client, h, eps).argmax(-1)

    async def run():
        manager = CacheManager(
            32, 1024, PS, HKV, HD, dtype=torch.bfloat16, device="cuda"
        )
        ex = SpanExecutor(
            layers, spec, manager, max_chunk_tokens=512,
            compute_dtype=torch.bfloat16, device="cuda",
        )
        prompts = torch.randint(
            0, spec.vocab_size, (4, 1000), generator=gen, device="cuda"
        )
        stats = {"launches": {}, "arena_gib": arena_gib(manager)}
        async with contextlib.AsyncExitStack() as stack:
            # four serving sessions, and a fifth whose first chunk rides
            # the ragged step
            *handles, fresh = [
                await stack.enter_async_context(manager.allocate(1, 1600))
                for _ in range(5)
            ]
            torch.cuda.synchronize()
            build.reset_launch_counts()
            t0 = time.perf_counter()
            nxt = []
            for i, hd in enumerate(handles):
                out = ex.prefill(
                    hd, embed_impl(client, prompts[i : i + 1]), fetch=False
                )
                nxt.append(head(out[:, -1]))
            torch.cuda.synchronize()
            stats["prefill_s"] = time.perf_counter() - t0
            nxt = torch.cat(nxt)
            step_s = []
            outs = []

            def decode_step():
                nonlocal nxt
                hid = embed_impl(client, nxt[:, None])
                out, combined = ex.decode_group(
                    handles, [hid[i : i + 1] for i in range(4)]
                )
                manager.commit(combined)
                nxt = head(out[:, -1])
                outs.append(out)

            for _ in range(32):
                t1 = time.perf_counter()
                decode_step()
                torch.cuda.synchronize()
                step_s.append(time.perf_counter() - t1)
            follow = torch.randint(
                0, spec.vocab_size, (1, 24), generator=gen, device="cuda"
            )
            outs.append(
                ex.decode(handles[0], embed_impl(client, follow), fetch=False)
            )
            tree = torch.zeros((1, 8, 8), dtype=torch.bool)
            parents = [-1, 0, 0, 1, 1, 2, 3, 5]
            depths = torch.zeros((1, 8), dtype=torch.int32)
            for n in range(8):
                node = n
                while node >= 0:
                    tree[0, n, node] = True
                    depths[0, n] += node != n
                    node = parents[node]
            draft = torch.randint(
                0, spec.vocab_size, (1, 8), generator=gen, device="cuda"
            )
            outs.append(
                ex.decode(
                    handles[1], embed_impl(client, draft), commit=False,
                    tree_mask=tree.numpy(), depths=depths.numpy(),
                    fetch=False,
                )
            )
            manager.rollback(handles[1])
            torch.cuda.synchronize()
            stats["launches"]["serving"] = dict(build.LAUNCHES)

            ragged, ragged_launches, ragged_steps = serving_ragged(
                ex, manager, handles, fresh, client, gen, outs
            )
            stats["launches"].update(ragged_launches)
            stats.update(ragged)
            stats["finite"] = all(
                torch.isfinite(o.float()).all().item() for o in outs
            )
            if profile:
                profiled("4 decode_group steps (4 sessions)",
                         lambda: [decode_step() for _ in range(4)])
                profiled("one ragged step (4 decode rows + a 32-token "
                         "chunk)", ragged_steps["mixed"])
                profiled("one tree ragged step (4 x 8-node trees)",
                         ragged_steps["tree"])
                profiled("4 solo tree verifies (the tree step's yardstick)",
                         ragged_steps["tree_separate"])
                extra = torch.randint(
                    0, spec.vocab_size, (1, 512), generator=gen,
                    device="cuda",
                )
                ctx = int(manager.context_lens(handles[3])[0])

                def prefill_chunk():
                    outs.append(ex.prefill(
                        handles[3], embed_impl(client, extra), commit=False,
                        fetch=False,
                    ))
                    manager.rollback(handles[3])

                profiled(
                    f"one 512-token prefill chunk (session 3, after its "
                    f"{ctx} tokens)", prefill_chunk,
                )
            steady = sorted(step_s[2:])
            stats["decode_step_s"] = steady[len(steady) // 2]
        return stats

    stats = asyncio.run(run())
    tok_s = 4 / stats["decode_step_s"]
    launches = stats["launches"]
    say(f"[serving] prefill 4 x 1000 tokens: {stats['prefill_s']:.3f} s "
        f"({4000 / stats['prefill_s']:.0f} tok/s); decode_group of 4, median "
        f"step {stats['decode_step_s'] * 1e3:.2f} ms ({tok_s:.1f} tok/s, "
        f"{tok_s / 4:.1f} tok/s/session); finite={stats['finite']}; "
        f"launches {launches['serving']}")
    say(f"[serving-ragged] ragged step of 4 decode rows + a 32-token chunk: "
        f"median {stats['mixed_s'] * 1e3:.2f} ms vs the same work "
        f"dispatched separately (decode_group + prefill_chunk) "
        f"{stats['mixed_separate_s'] * 1e3:.2f} ms; tree ragged step of 4 x "
        f"8-node trees {stats['tree_s'] * 1e3:.2f} ms vs 4 solo tree "
        f"verifies {stats['tree_separate_s'] * 1e3:.2f} ms; launches "
        f"{launches['ragged']}, yardstick {launches['ragged_yardstick']}")
    torch.cuda.synchronize()
    int4 = serving_int4(layers, spec, client, gen, profile)
    launches["int4"] = int4["launches"]
    say(f"[serving-int4] int4 arena of {int4['arena_gib']:.3f} GiB (bf16: "
        f"{stats['arena_gib']:.3f} GiB): prefill 4 x 1000 tokens "
        f"{int4['prefill_s']:.3f} s; decode_group of 4, median step "
        f"{int4['decode_step_s'] * 1e3:.2f} ms vs the bf16 arena's "
        f"{stats['decode_step_s'] * 1e3:.2f} ms; finite={int4['finite']}; "
        f"launches {launches['int4']}")
    if not (stats["finite"] and int4["finite"]):
        raise AssertionError("serving run produced non-finite outputs")
    want = {
        "serving": ("flash_attention", "paged_decode_attention",
                    "paged_chunk_attention"),
        "ragged": ("paged_ragged_attention",),
        "int4": ("paged_decode_attention_int4", "flash_attention"),
    }
    missing = [
        (path, k) for path, ks in want.items() for k in ks
        if launches[path].get(k, 0) == 0
    ]
    if missing:
        raise AssertionError(f"serving run never launched {missing}")
    per_step = launches["serving"]["paged_decode_attention"] / 32
    if per_step != spec.num_hidden_layers:
        raise AssertionError(
            f"{per_step} decode launches per bf16 decode step, want one per "
            f"layer ({spec.num_hidden_layers})"
        )
    chunk = launches["serving"]["paged_chunk_attention"]
    if chunk != 2 * spec.num_hidden_layers:
        raise AssertionError(
            f"{chunk} chunk launches on the serving path, want one per layer "
            f"for the follow-up turn and the tree verify "
            f"({2 * spec.num_hidden_layers})"
        )
    torch.cuda.empty_cache()
    launches["served"] = phase_served(layers, spec, client, gen)
    return launches


# ------------------------------------------------------------- phase 5
def phase_served(layers, spec, client, gen) -> dict:
    """Phase 5: the whole Llama-3-8B served on the wire to the port's own
    client. Two port BlockServers on the card over phase 4's weights
    (blocks [0, 16) and [16, 32), 1024-page arenas each) and a port
    registry on one event loop; four port-client sessions (bf16 client
    parameters, push) on another, concurrently: each `generate`s 32 greedy
    tokens from a 1000-token prompt, then on the same session a 24-token
    follow-up turn with 2 more tokens. The reference runs the same
    sessions solo on one in-process SpanExecutor with the server's calls
    (prefill for T>1, B=1 decode for T=1) and picks its tokens with the
    client's own head on the executor's output, gathered in f32. Returns
    the served run's launch counts."""
    import torch

    from bloombee_tpu_torch.client import DistributedModelForCausalLM
    from bloombee_tpu_torch.kv.cache_manager import CacheManager
    from bloombee_tpu_torch.ops.cuda import build
    from bloombee_tpu_torch.runtime.executor import SpanExecutor
    from bloombee_tpu_torch.wire import tensor_codec

    bf16, vocab, n_new = torch.bfloat16, spec.vocab_size, 32
    n_layers = spec.num_hidden_layers
    spans = ((0, n_layers // 2), (n_layers // 2, n_layers))
    prompts = torch.randint(0, vocab, (4, 1000), generator=gen, device="cuda")
    follows = torch.randint(0, vocab, (4, 24), generator=gen, device="cuda")
    local = DistributedModelForCausalLM(spec, client, None, device="cuda")

    def head(out):
        """The client's greedy token from a step's f32-gathered output."""
        return local.logits(out[:, -1:].float())[:, 0].argmax(-1)

    def reference():
        manager = CacheManager(n_layers, 1024, PS, HKV, HD, dtype=bf16,
                               device="cuda")
        ex = SpanExecutor(layers, spec, manager, max_chunk_tokens=512,
                          compute_dtype=bf16, device="cuda")
        sessions, step_s = [], []

        def embed(ids):
            return local.embed(ids).to(bf16)  # what the wire carries

        def decode(h, token):
            hid = embed(token[:, None])
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = ex.decode(h, hid, fetch=False)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
            return out

        async def run():
            for i in range(4):
                async with manager.allocate(1, 1100) as h:
                    outs = [ex.prefill(h, embed(prompts[i : i + 1]),
                                       fetch=False)]
                    tokens = [head(outs[-1])]
                    for _ in range(n_new - 1):
                        outs.append(decode(h, tokens[-1]))
                        tokens.append(head(outs[-1]))
                    outs.append(ex.prefill(h, embed(follows[i : i + 1]),
                                           fetch=False))
                    tokens.append(head(outs[-1]))
                    outs.append(decode(h, tokens[-1]))
                    tokens.append(head(outs[-1]))
                    sessions.append((
                        torch.cat([o[:, -1] for o in outs]).float(),
                        torch.cat(tokens).cpu(),
                    ))

        asyncio.run(run())
        del ex, manager
        return sessions, step_s

    ref_sessions, ref_step_s = reference()
    torch.cuda.empty_cache()
    # the head's device time on one f32 position (bf16 parameters: the
    # per-call upcast of lm_head to f32 included)
    h1 = ref_sessions[0][0][-1:][None]
    head_ms = cuda_ms(lambda: local.logits(h1))
    head_bound = bound(nbytes(client["norm"], client["lm_head"], h1)
                       + 4 * vocab, 2 * spec.hidden_size * vocab,
                       torch.float32)

    async def one_session(model, session, i):
        ids = await model.generate(prompts[i : i + 1], max_new_tokens=n_new,
                                   session=session)
        more = await model.generate(follows[i : i + 1], max_new_tokens=2,
                                    session=session)
        return torch.cat([ids[0, -n_new:], more[0, -2:]])

    async def served(reg_port):
        models = [port_client(client, spec, reg_port, "llama3-8b")
                  for _ in range(4)]
        try:
            async with contextlib.AsyncExitStack() as stack:
                sessions = [
                    await stack.enter_async_context(
                        m.inference_session(1100, 1)
                    )
                    for m in models
                ]
                recs = [tap(s, m) for s, m in zip(sessions, models)]
                torch.cuda.synchronize()
                build.reset_launch_counts()
                before = tensor_codec.transport_stats()
                t0 = time.perf_counter()
                tokens = await asyncio.gather(*(
                    one_session(models[i], sessions[i], i) for i in range(4)
                ))
                torch.cuda.synchronize()
                wall_s = time.perf_counter() - t0
                launches = dict(build.LAUNCHES)
                after = tensor_codec.transport_stats()
                summaries = [s.timing_summary() for s in sessions]
                firsts = [
                    (len(r["embeds"]), len(r["metas"])) for r in recs
                ]
                # 8 more decode steps of session 0 alone: the served step
                # without other sessions in the queues, and its wire bytes
                k0 = len(sessions[0].timings)
                tx0 = tensor_codec.transport_stats()["tx"]
                await models[0].generate(tokens[0][-1:][None],
                                         max_new_tokens=8,
                                         session=sessions[0])
                tx1 = tensor_codec.transport_stats()["tx"]
                alone = {
                    "timings": sessions[0].timings[k0:],
                    "embeds": recs[0]["embeds"][firsts[0][0]:],
                    "metas": recs[0]["metas"][firsts[0][1]:],
                    "tx": (tx0, tx1),
                }
                route = [(s.span.start, s.span.end)
                         for s in sessions[0]._spans]
        finally:
            for m in models:
                await m.manager.registry.close()
        return (route, tokens, recs, firsts, summaries, launches, wall_s,
                (before, after), alone)

    with ServerLoop() as servers_loop:
        reg, servers = servers_loop.run(start_span_servers(
            layers, spec, "llama3-8b", spans, bf16, 1024
        ))
        try:
            (route, tokens, recs, firsts, summaries, launches, wall_s,
             (st0, st1), alone) = asyncio.run(served(reg.port))
        finally:
            servers_loop.run(stop_span_servers(reg, servers))

    ok = True
    worst = 0.0
    for toks, rec, (ref_last, ref_tokens) in zip(tokens, recs, ref_sessions):
        # the 34 steps of the 4-session run (the alone steps come after)
        last = torch.cat([o[:, -1] for o in rec["outs"][: n_new + 2]])
        diff = (last - ref_last).abs()
        worst = max(worst, diff.max().item())
        ok = ok and torch.equal(toks, ref_tokens) and bool(
            (diff <= 1e-2 * ref_last.abs() + 1e-3).all()
        ) and torch.isfinite(last).all().item()

    def med(xs):
        xs = sorted(xs)
        return xs[len(xs) // 2]

    def gaps(ts):
        return [(b - a) * 1e3 for a, b in zip(ts, ts[1:])]

    # embeds of the first generate: the prompt, then tokens 1..31
    ttft_ms = [gaps(r["embeds"][:2])[0] for r in recs]
    per_token_ms = [med(gaps(r["embeds"][1:n_new])) for r in recs]
    hop_ms = {
        f"server{k}": {
            key: med([m[key] for r, (_, m0) in zip(recs, firsts)
                      for kk, m in r["metas"][:m0] if kk == k and key in m])
            for key in ("t_dispatch_ms", "t_fetch_ms")
        }
        for k in range(len(route))
    }
    tx0, tx1 = alone["tx"]
    n_alone = len(alone["timings"])
    one = {k: (tx1[k] - tx0[k]) / n_alone
           for k in ("n", "raw_bytes", "wire_bytes", "compressed")}
    alone_ms = {
        "decode_step_ms_median": med(
            [t["total_ms"] for t in alone["timings"]]
        ),
        "per_token_ms_median": med(gaps(alone["embeds"])),
        **{
            f"server{k}_{key}": med(
                [m[key] for kk, m in alone["metas"] if kk == k and key in m]
            )
            for k in range(len(route))
            for key in ("t_dispatch_ms", "t_fetch_ms")
        },
    }
    total = {k: st1["tx"][k] - st0["tx"][k]
             for k in ("n", "raw_bytes", "wire_bytes", "compressed")}
    # codec seconds, summed over the threads that ran them
    total["encode_s"] = st1["tx"]["s"] - st0["tx"]["s"]
    total["decode_s"] = st1["rx"]["s"] - st0["rx"]["s"]
    stats = {
        "route": [list(r) for r in route],
        "served_run_s": wall_s,
        "ttft_ms": ttft_ms,
        "per_token_ms_median": per_token_ms,
        "timing_summary": [
            {k: s[k] for k in ("steps", "mean_total_ms",
                               "mean_compute_ms_per_span",
                               "mean_wire_and_overhead_ms")}
            for s in summaries
        ],
        "head_ms": head_ms,
        "head_bound_ms": head_bound[0],
        "reference_decode_step_ms_median": med(ref_step_s) * 1e3,
        "reply_ms_median": hop_ms,
        "one_session_alone": alone_ms,
        "decode_step_wire": one,
        "served_run_wire": total,
        "codecs": sorted(tensor_codec.supported_codecs()),
        "tokens_identical_and_close": ok,
        "last_hidden_max_abs_err": worst,
    }
    say(f"[served] Llama-3-8B bf16 over {stats['route']} via a port "
        f"registry, 4 concurrent port-client sessions x (generate 32 tokens "
        f"from 1000, then a 24-token follow-up turn + 2 tokens) vs the same "
        f"sessions solo on one executor + the client's head: greedy tokens "
        f"identical and last hidden states within 1e-2|ref|+1e-3: {ok} "
        f"(max_abs_err {worst:.3e}); time to first token "
        f"{[round(x, 2) for x in ttft_ms]} ms; per-token medians "
        f"{[round(x, 3) for x in per_token_ms]} ms (the executor's solo "
        f"step {stats['reference_decode_step_ms_median']:.3f} ms); head "
        f"{head_ms:.4f} ms on the device (bound {head_bound[0]:.4f} ms, "
        f"{head_bound[1]}); replies' medians {hop_ms}; one session alone "
        f"(8 more steps): step {alone_ms['decode_step_ms_median']:.3f} ms, "
        f"per token {alone_ms['per_token_ms_median']:.3f} ms; a decode step "
        f"moves {one['n']:.0f} tensors, {one['wire_bytes']:.0f} payload "
        f"bytes ({one['compressed']:.0f} compressed; codecs "
        f"{stats['codecs']}); launches {launches}")
    say("[served] " + json.dumps(stats))
    say(card_line())
    if not ok:
        raise AssertionError("served run differs from the solo executor")
    missing = [k for k in ("flash_attention", "paged_decode_attention",
                           "paged_chunk_attention") if not launches.get(k)]
    if missing:
        raise AssertionError(f"served run never launched {missing}")
    per_step = launches["paged_decode_attention"] / (4 * n_new)
    if per_step != spec.num_hidden_layers:
        raise AssertionError(
            f"{per_step} decode launches per served session step, want one "
            f"per layer ({spec.num_hidden_layers})"
        )
    return launches


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument(
        "--quick", action="store_true",
        help="build and check the kernels only (phases 1-2); prints no "
        "result line",
    )
    parser.add_argument(
        "--profile", action="store_true",
        help="after each serving path (and its launch counts), trace 4 "
        "more decode steps, a mixed and a tree ragged step, 4 solo tree "
        "verifies, one prefill chunk and 4 int4 decode steps with "
        "torch.profiler and print where the time goes",
    )
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (REPO / "bloombee_tpu_torch" / "ops" / "cuda" / "csrc").is_dir():
        print("chip_smoke: bloombee_tpu_torch not found beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    say(f"python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    card = card_line()
    say(card)
    try:
        phase_build()
        kernels = phase_kernels()
        if args.quick:
            say(json.dumps({"kernels": kernels}))
            return 3
        phase_f32_path()
        torch.cuda.empty_cache()
        by_path = phase_serving(args.profile)
    except Exception:
        traceback.print_exc()
        return 1
    for row in kernels:
        row["launches_by_path"] = {
            path: counts[row["name"]]
            for path, counts in by_path.items() if row["name"] in counts
        }
        # the yardstick re-dispatches the ragged steps' work only to time
        # it: not a main path's launches
        row["launches"] = sum(
            n for path, n in row["launches_by_path"].items()
            if path != "ragged_yardstick"
        )
    say(json.dumps({"kernels": kernels}))
    say(card_line())
    say(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())

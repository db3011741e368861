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
   other compiled geometry (hd 64; GQA groups 1, 2, 8), the edge cases
   of the flash, split decode, int4 decode, ragged and chunk kernels
   (`phase_kernels_edges`; the split kernels' cases launched twice, equal
   bit for bit), and every kernel at wide and odd groups
   (`phase_kernels_groups`: Falcon-7B's 71 heads over one KV head,
   Falcon-40B's 128 over 8, Falcon-180B's 232 over 8 at hd 64, and group
   3 at hd 128; windows, lens=0 rows, a follow-up and a tree chunk, ragged
   mixes and trees with padding rows, every paged case launched twice). Times each kernel, its plain version and (flash) the
   library call computing the same function, with CUDA events after
   warmup, launches queued behind a device sleep so the time is the
   device's (`cuda_ms`); also host-paced, decode and int4 decode with a
   cold L2, flash at both prefill-chunk shapes and in f32, ragged at the
   mixed and the tree step's shapes, chunk at the serving path's two B=1
   launches (warm and cold), at phase 7's adopted-prefix suffix (40
   tokens over 1000) and at PR 1-4's B=4 table shape; and each kernel at
   Falcon-7B's heads (`time_groups`, `falcon7b_*` keys; flash beside
   SDPA).
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
   identical greedy tokens). Routing, 2 layers, a 600-token prefill and
   4 decodes matching `block_forward` + `dense_attend` (same limit): at
   H=24, Hkv=8, hd=128 (GQA group 3, inside the kernels' domain) on the
   flash and paged decode kernels; at H=12, Hkv=4, hd=256 (outside it) on
   the dense routes, with no paged or flash launch.
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
5. Served in bf16 over phase 4's weights (no second copy), three runs, each
   with its own registry and two port BlockServers on the card (blocks
   [0, 16) and [16, 32), 1024-page arenas) on one event loop, and four
   sessions of the port client (`DistributedModelForCausalLM` over phase
   4's bf16 client parameters, a `RemoteSequenceManager` over the port
   registry, push) on another: each `generate`s 32 greedy tokens from a
   1000-token prompt, then on the same session a 24-token follow-up turn
   with 2 more tokens. Launch counts are reset just before each run's
   sessions step and read just after (paths "served", "served_batched",
   "served_mixed"):
   (a) `max_batch=1`: the same sessions solo on one
       SpanExecutor with the server's calls, their tokens picked by the
       client's own head on the executor's output gathered in f32, must
       give identical greedy tokens and last-position hidden states within
       1e-2 x |ref| + 1e-3 each; exactly one decode launch per layer per
       session step; then 8 more tokens of one session alone;
   (b) the server defaults (`max_batch=8`, monolithic prefill): both
       servers merge decode steps (`batch_dispatches` > 0, mean width >=
       2) and the decode launches equal each server's layers times its
       dispatches that carry decode rows;
   (c) `mixed_batch=True`, `prefill_chunk=32`, the fourth session's prompt
       sent once the other three have decoded 8 tokens each: mixed
       dispatches and decode steps interleaved with chunks on the servers,
       and the ragged kernel launched on the served path.
   (b) and (c) are held teacher-forced: the solo executor (cutting the
   prompt into the server's chunks in (c)) is fed the served run's tokens
   in bf16 and, as the truth, in f32 on the same inputs. At every step
   the served last hidden state must be no further from the f32 truth
   than 1.5 x the bf16 reference's own distance (relative norms; the
   elements over 1e-2 x |ref| + 1e-3 against the bf16 reference are
   printed: two bf16 paths that round differently are each ~3% from the
   truth at 32 layers), and a greedy token may differ from the bf16
   reference's only where its top-1 minus top-2 logit gap is below the
   largest logit difference between the served and the reference output
   at that position. No run may replay a failed group
   (the server's "replaying" warnings) or decline the ragged path. Prints
   each run's time to first token, per-token medians, `timing_summary()`,
   the replies' dispatch and fetch medians, the launch counts and both
   servers' batching counters from `rpc_info`; for (a) also one session
   alone, the bytes a decode step moves on the wire and the head's device
   time; and the card's name and power limit.
6. Speculative decoding served in bf16 over phase 4's weights, two runs,
   each with its own registry and two port BlockServers (blocks [0, 16)
   and [16, 32)), four push sessions of the port client, each
   `generate_speculative`-ing 32 greedy tokens from a 1000-token prompt
   (so every tree verify sees more than 512 tokens of context) with a
   `GreedyTreeDrafter` (2, 2, 1) over a `LocalDraftModel` that shares
   the target's tensors; launch counts reset and read around each run
   (paths "spec_solo", "spec_batched"):
   (d) server defaults and the self-drafter (all 32 layers, the client's
       head): every tree verify a solo dispatch on the paged chunk kernel,
       chunk launches = each server's layers x its tree steps, the
       drafters' accept rate (accepted over drafted levels) above 0.5;
   (e) `spec_batch=True`, a 2-layer drafter and a 100 ms gather window:
       tree groups on both servers (mean width > 1), ragged launches =
       each server's layers x its tree groups, chunk launches = its
       layers x its solo tree dispatches.
   Both are held teacher-forced as (b) and (c) are, at every committed
   position (the prompt's last, then each round's accepted tree nodes).
   No run may replay a group or decline the ragged path. Prints per-token
   time, rounds, tokens per round, the drafters' and the servers' accept
   rates and the launches by kernel, and the card's name and power limit.
7. The shared-prefix cache, session leases and standby replication
   served in bf16 over phase 4's weights: a registry and two port
   BlockServers (blocks [0, 16) and [16, 32)) with `prefix_cache=True`,
   `session_lease_s=30`, `max_batch=1`, 1024-page arenas, push sessions
   of the port client, 16-token pages of random ids; launch counts reset
   and read around each run (paths "prefix", "lease", "repl"):
   (f) A (992 tokens) publishes its pages; B and C (A's first 960 tokens
       + 40 of their own) each adopt 60 pages and prefill 40 tokens on
       the paged chunk kernel; D (A again) adopts 62 pages, is trimmed to
       991, and its one-token suffix copies the shared last page and runs
       on the decode kernel; 16 greedy tokens each. Each server: 3 hits
       of 960 + 960 + 991 tokens and a copy-on-write; flash only for A
       (2 a layer), chunk launches = 2 a layer, decode launches = a layer
       per decode step; no page referenced after close; B, C and D held
       teacher-forced as (b)-(e) against the solo executor prefilling the
       full prompt.
   (g) E (1000 tokens) decodes 8 tokens, every span connection of the
       session is aborted, the client resumes both streams and decodes 8
       more: tokens identical to a fault-free run of E, zero replay, one
       resume on each server.
   (h) two standbys (one per span) join; F (1000 tokens,
       `kv_repl_every=4`) decodes 64 tokens; once the standbys' installed
       pages stop growing (at most 10 s) the [16, 32) server of F's route
       stops; the client recovers onto the standbys, replaying at most
       (4 + 1) x 16 tokens, and decodes 8 more, held teacher-forced over
       F's 72 positions.
   Prints each session's time to first token and prefill wire bytes, the
   resume's and the kv_put sweeps' times, the kv_put count and bytes, the
   launches by kernel, and the card's name and power limit.
8. Server-side multi-step decode (decode_n) served in bf16 over phase 4's
   weights, three runs, each with its own registry and port BlockServers
   given the client's parameters and `max_batch=1`, 1024-page arenas,
   push sessions with 1000-token prompts; each session generates per
   step, then on a fresh session with `server_decode=True` (chunk 32),
   launch counts reset and read around each (paths "decode_n_*" and
   "decode_n_*_per_step"):
   (i) fused: one server over [0, 32), one session, 64 tokens (the
       device loop of `executor.decode_n`);
   (ii) chained: [0, 16) and [16, 32), four sessions, 32 tokens each;
   (iii) stepped: one [0, 32) server over an int4 arena, one session, 32
       tokens.
   Tokens identical to the per-step run; paged decode (int4 decode)
   launches = each server's layers x its steps (`decode_n_steps`). Prints
   time to first token, per-token time, the replies' dispatch time per
   token and the decode_n round trips, and the card's name and power
   limit.
9. The CLI, each span in its own process: a random checkpoint at
   Llama-3-8B width with 8 layers in a temporary directory (removed at
   the end), `python -m bloombee_tpu_torch.cli.run_registry` and two
   `...cli.run_server --device cuda` processes ([0, 4), [4, 8)); a port
   client in this process generates 32 tokens from a 1000-token prompt
   per step and with `server_decode=True` (chained): identical tokens,
   equal to an in-process solo executor's over the same checkpoint; the
   servers' launch counts (`rpc_info` `kernel_launches`, path "cli");
   `cli.health --probe` lists both spans ONLINE; SIGTERM stops each
   server with exit code 0.
10. The Llama-like families through the port's registry (published
   configs mapped by `models.auto`, random bf16 weights), each served by
   two port BlockServers (`max_batch=1`) and the port client, after the
   Llama phases' weights are freed; launch counts reset and read around
   each run's sessions (paths "family_qwen3", "family_qwen2",
   "family_mistral"):
   (a) Qwen3-8B at published width and depth (36 layers, q/k norms),
       [0, 18) + [18, 36): 2 sessions of 32 tokens from 1000-token
       prompts and a 24-token follow-up with 2 more; tokens identical to
       the solo executor, held teacher-forced against an f32 truth;
       flash, paged decode and chunk launched at the counts the path
       implies;
   (b) Qwen2.5-3B at published width, 4 layers (q/k/v biases, tied
       embeddings), written as a `qwen2` checkpoint: servers built from
       the directory, the client from `from_pretrained`, the same
       sessions; tokens identical to a solo executor over the
       checkpoint's weights;
   (c) Mistral-7B-v0.1 at published width, 2 layers, window 4096: 2
       sessions of 32 tokens from 4400-token prompts prefilled in
       64-token chunks (`prefill_chunk=64`), so the chunk and decode
       kernels carry the window; tokens identical to the solo executor,
       held teacher-forced against an f32 truth on the dense route; no
       flash launch.
   Prints each run's time to first token and per-token medians and the
   card's name and power limit.
11. The Gemma families through the port's registry (published configs,
   random bf16 weights, tied heads), two port BlockServers over the
   halves and the port client; launch counts reset and read around each
   run's sessions (paths "gemma2", "gemma3", "gemma3_mixed"):
   (a) Gemma-2-27B at published width (attention and final logit
       soft-caps), 8 layers, `max_batch=1`: 2 sessions of 32 tokens from
       1000-token prompts and a 24-token follow-up with 2 more; tokens
       identical to the solo executor, held teacher-forced against an f32
       truth; no kernel launched (soft-capped attention stays dense);
   (b) Gemma-3-27B at published width (q/k norms, window 1024 on five
       layers of six, local and global rope bases), 12 layers: run 1 as
       (a) from 1500-token prompts, the sliding layers' window on the
       paged decode and chunk kernels (launches exactly 32 and 1 a layer
       a session), tokens identical, held against an f32 truth on the
       dense route; run 2 with `mixed_batch=True`, `prefill_chunk=32`,
       `max_batch=8`, BBTPU_PAGED_MIN_CONTEXT=0, a 20 ms gather window
       and a third, late session: ragged, decode and chunk launches
       equal to the servers' layers x their ragged dispatches, decode
       dispatches, and unfused chunks plus follow-ups; held
       teacher-forced; no flash.
   Prints each run's time to first token and per-token medians and the
   card's name and power limit.
12. The MoE families through the port's registry (published configs,
   random bf16 weights), two port BlockServers over the halves and the
   port client, after the earlier phases' weights are freed; launch
   counts reset and read around each run's sessions (paths "moe_qwen3",
   "moe_mixtral", "moe_mixtral_mixed", "moe_qwen3_ckpt"):
   (a) Qwen3-30B-A3B at published width and all 48 layers (128 experts,
       top-8), `max_batch=1`: 2 sessions of 32 tokens from 1000-token
       prompts and a 24-token follow-up with 2 more; tokens identical to
       the solo executor over the same tensors; flash, paged decode and
       chunk launched at the counts the path implies;
   (b) Mixtral-8x7B-v0.1 at published width, 2 layers, written as a
       `mixtral` checkpoint: servers built from the directory, the client
       from `from_pretrained`; run 1 as (a), tokens identical to a solo
       executor over the checkpoint; run 2 with `mixed_batch=True`,
       `prefill_chunk=32`, `max_batch=8` and a third, late session
       (decode rows sharing ragged launches with its chunks), launches
       equal to the servers' dispatch counters; both runs held
       teacher-forced against an f32 truth, the bf16-vs-f32 routing flips
       counted;
   (c) Qwen3-30B-A3B at published width, 4 layers, written as a
       `qwen3_moe` checkpoint, served and held as run 1 of (b): its
       softmax-then-top-8 router against an f32 truth.
   Prints the byte reckoning, each run's time to first token, per-token
   medians and peak allocated memory, the phase's seconds, and the
   card's name and power limit.
13. The Bloom family through the port's registry (published configs,
   random bf16 weights: LayerNorms and projections with biases, the
   embedding LayerNorm, a tied head), port BlockServers and the port
   client, after the earlier phases' weights are freed; ALiBi keeps every
   attention step dense (no kernel has the bias, as in the JAX package),
   so no path launches any kernel; launch counts reset and read around
   each run's sessions (paths "bloom7b", "bloom7b_dn", "bloom176",
   "bloom176_mixed"):
   (a) bloom-7b1 at published width and all 30 layers, [0, 15) +
       [15, 30), `max_batch=1`: 2 sessions of 32 tokens from 1000-token
       prompts and a 24-token follow-up with 2 more; tokens identical to
       the solo executor, held teacher-forced against an f32 truth; then
       the same sessions with `server_decode=True` on one [0, 30) server
       (the fused decode loop with the embedding LayerNorm and the
       LayerNorm head): tokens identical to the per-step run;
   (b) BLOOM-176B at published width (112 heads), 2 layers, written as a
       `bloom` checkpoint in the hub's layout (fused per-head QKV):
       servers built from the directory, the client from
       `from_pretrained` with the chunked head; run 1 as (a), tokens
       identical to a solo executor over the checkpoint, held against an
       f32 truth; run 2 with `mixed_batch=True`, `prefill_chunk=32`,
       `max_batch=8` and a third, late session (ALiBi on the dense ragged
       route), held teacher-forced.
   Prints the byte reckoning, each run's time to first token, per-token
   medians and peak allocated memory, the phase's seconds, and the
   card's name and power limit.
14. The Falcon family through the port's registry (published configs,
   random bf16 weights: LayerNorms with biases, bias-free projections,
   the parallel residual, a tied head), port BlockServers and the port
   client; the kernels take Falcon's GQA groups (71 and 16) at run time;
   launch counts reset and read around each run's sessions (paths
   "falcon7b", "falcon7b_dn", "falcon40b", "falcon40b_mixed"):
   (a) Falcon-7B at published width and all 32 layers (71 heads of 64
       over one KV head), [0, 16) + [16, 32), `max_batch=1`: 2 sessions
       of 32 tokens from 1000-token prompts and a 16-token follow-up with
       2 more; tokens and hidden states bit for bit the solo executor's,
       held teacher-forced against an f32 truth; flash, paged decode and
       chunk at their formulas; then `server_decode=True` on one [0, 32)
       server: tokens identical, every call fused;
   (b) Falcon-40B at published width (128 heads over 8, two LayerNorms),
       2 of 60 layers, written as a `falcon` checkpoint in HF's grouped
       fused-QKV layout: run 1 as (a) against a solo executor over the
       checkpoint; run 2 with `mixed_batch=True`, `prefill_chunk=8`,
       `max_batch=8` and a third, late session: the ragged kernel at
       group 16, launches at the servers' counters, held teacher-forced.
   Prints the byte reckoning, each run's time to first token, per-token
   medians and peak allocated memory, the phase's seconds, and the
   card's name and power limit.

Prints the card's name and power limit, per-phase results, each phase's
end time (`[timing]`), a
`{"kernels": [...]}` line, and as its last line
`{"ok": true, "device": {...}}`. Any failed phase exits non-zero with no
result line; so does a machine without CUDA or a directory without the
package.
"""

from __future__ import annotations

import argparse
import asyncio
import concurrent.futures
import contextlib
import json
import pathlib
import signal
import subprocess
import sys
import time
import traceback

REPO = pathlib.Path(__file__).resolve().parent
H, HKV, HD, PS = 32, 8, 128, 16
PEAK_BYTES = 3.35e12  # H100 SXM HBM3, bytes/s
PEAK_OPS = {"bfloat16": 989e12, "float32": 67e12}  # dense, FLOP/s
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
    sources = build.sources()
    logs = build.build(sources)
    say(f"[build] {sources} built in "
        f"{time.perf_counter() - t0:.1f} s (cached: "
        f"{[s for s in sources if s not in logs]})")
    for name, log in logs.items():
        for kernel, report in ptxas_report(log):
            say(f"[build] {name}: {kernel}: {report}")
        for line in log.splitlines():
            if "Performance Loss" in line:  # e.g. serialized wgmma
                say(f"[build] {name}: {line.strip()}")
    with concurrent.futures.ThreadPoolExecutor(len(sources)) as pool:
        ops = list(pool.map(lambda n: tensor_core_ops(build, n), sources))
    for name, counts in zip(sources, ops):
        say(f"[build] {name}: tensor-core instructions in the SASS "
            f"(cuobjdump): {counts}")


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
        phase_kernels_groups(gen, dtype, check)

    # times at the serving run's bf16 shapes (phase 4)
    extra: dict[str, dict] = {}  # per kernel: times beyond the row's own
    flash_row, extra["flash_attention"] = time_flash(gen)
    decode_row, extra["paged_decode_attention"] = time_decode(gen)
    rows = [flash_row, decode_row]
    chunk_row, extra["paged_chunk_attention"] = time_chunk(gen, check)
    rows.append(chunk_row)
    rows += time_ragged_int4(gen, extra)
    time_groups(gen, extra)

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
    chunk, chunks = pa.decode_split(64, PS, 4, HKV, H // HKV)
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
    [1,8,32,128], an 8-node tree, 1040 tokens; `tree_*` keys), phase 7's
    adopted-prefix suffix prefill (q [1,64,32,128], t_real 40, 1000
    tokens, a 64-page table; `suffix_*` keys), each warm,
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
        ("suffix_", 1, 64, 40, 1000, 64, False),
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
    chunk, chunks = pa.decode_split(64, PS, 8, HKV, H // HKV)
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
    chunk, chunks = pa.decode_split(500, PS, 1, HKV, H // HKV)
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
    chunk, chunks = pa.decode_split(64, PS, 8, HKV, H // HKV)
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
    chunk, chunks = pa.decode_split(500, PS, 1, HKV, H // HKV)
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


# the GQA groups of phase 2's widened domain: (label, H, Hkv, hd)
GROUP_GEOMETRIES = (
    ("Falcon-7B", 71, 1, 64),
    ("Falcon-40B", 128, 8, 64),
    ("Falcon-180B", 232, 8, 64),
    ("group 3", 24, 8, 128),
)


def phase_kernels_groups(gen, dtype, check):
    """Phase 2 cases of all five kernels at the wide and odd groups of
    `GROUP_GEOMETRIES` (Falcon-7B's 71 query heads over one KV head,
    Falcon-40B's 16, Falcon-180B's 29, and 3 at hd 128): several head
    tiles a KV head, and tiles with masked heads. Flash causal and not with a lens=0
    row; decode and int4 decode with a window and a lens=0 row; chunk: a
    follow-up (t_real < T, padding rows exact zeros) and a tree; ragged:
    a chunk's rows, decode rows, a lens=0 row and padding rows, with and
    without a window, and two trees with padding rows. Every paged case is
    launched twice, equal bit for bit."""
    import torch

    from bloombee_tpu_torch.kv.quant import quantize
    from bloombee_tpu_torch.ops.cuda import flash_attention as fa
    from bloombee_tpu_torch.ops.cuda import paged_attention as pa

    i32 = dict(dtype=torch.int32, device="cuda")

    def zeros(name, case, x):
        if torch.count_nonzero(x).item():
            raise AssertionError(f"{name} {case}: a dead row is not zeros")

    for label, h, hkv, hd in GROUP_GEOMETRIES:
        geo = f"{label} H={h} Hkv={hkv} hd={hd}"
        q = _unit(gen, (3, 100, h, hd), dtype)
        k = _unit(gen, (3, 150, hkv, hd), dtype)
        v = _unit(gen, (3, 150, hkv, hd), dtype)
        st = torch.tensor([37, 0, 13], **i32)
        ln = torch.tensor([137, 0, 150], **i32)
        for causal in (True, False):
            case = f"{geo} causal={causal} lens {ln.tolist()}"
            args = (q, k, v, causal, None, st, ln)
            got = fa.flash_attention(*args)
            check("flash_attention", dtype, case, got,
                  fa.flash_attention_reference(*args))
            zeros("flash_attention", case, got[1])

        ks = _unit(gen, (256 * PS, hkv, hd), dtype)
        vs = _unit(gen, (256 * PS, hkv, hd), dtype)
        kq, vq = quantize(ks.float()), quantize(vs.float())
        pt = _page_table(gen, 4, 64, 256)
        lens = torch.tensor([1000, 17, 0, 1024], **i32)
        qd = _unit(gen, (4, h, hd), dtype)
        for window in (0, 100):
            case = f"{geo} lens {lens.tolist()} window={window}"
            args = (qd, ks, vs, pt, lens, PS, None, window)
            got = twice("paged_decode_attention", dtype, case, check,
                        lambda: pa.paged_decode_attention(*args),
                        pa.paged_decode_attention_reference(*args))
            zeros("paged_decode_attention", case, got[2])
            args = (qd, kq, vq, pt, lens, PS, None, window)
            got = twice("paged_decode_attention_int4", dtype, case, check,
                        lambda: pa.paged_decode_attention_int4(*args),
                        pa.paged_decode_attention_int4_reference(*args))
            zeros("paged_decode_attention_int4", case, got[2])

        lens = torch.tensor([600, 0, 77], **i32)
        pt3 = pt[:3].contiguous()
        args = (_unit(gen, (3, 24, h, hd), dtype), ks, vs, pt3, lens, PS,
                None, None, 0, 20)
        case = f"{geo} follow-up T=24 t_real=20 lens {lens.tolist()}"
        got = twice("paged_chunk_attention", dtype, case, check,
                    lambda: pa.paged_chunk_attention(*args),
                    pa.paged_chunk_attention_reference(*args))
        zeros("paged_chunk_attention", case, got[1])
        zeros("paged_chunk_attention", case, got[:, 20:])
        tree = torch.stack([_tree(8, gen) for _ in range(3)]).cuda()
        args = (_unit(gen, (3, 8, h, hd), dtype), ks, vs, pt3,
                lens.clamp_min(8), PS, tree, None, 0, 8)
        case = f"{geo} tree T=8 lens {lens.clamp_min(8).tolist()}"
        twice("paged_chunk_attention", dtype, case, check,
              lambda: pa.paged_chunk_attention(*args),
              pa.paged_chunk_attention_reference(*args))

        # ragged mixed: 5 rows of a chunk of sequence 0, decode rows of
        # sequences 1 and 3, a row of the lens=0 sequence 2, padding rows
        lens = torch.tensor([600, 300, 0, 1024], **i32)
        q_seq = torch.tensor([0] * 5 + [1, 2, 3, 4, 4], **i32)
        q_pos = torch.tensor([595, 596, 597, 598, 599, 299, 0, 1023, 0, 0],
                             **i32)
        for window in (0, 100):
            case = (f"{geo} 5-row chunk + 2 decode + lens=0 + 2 padding "
                    f"window={window}")
            args = (_unit(gen, (10, h, hd), dtype), ks, vs, pt, lens, q_seq,
                    q_pos, PS, None, window)
            got = twice("paged_ragged_attention", dtype, case, check,
                        lambda: pa.paged_ragged_attention(*args),
                        pa.paged_ragged_attention_reference(*args))
            zeros("paged_ragged_attention", case, got[[6, 8, 9]])
        nt = torch.tensor([8, 8, 0, 0], **i32)
        lens = torch.tensor([508, 208, 0, 0], **i32)
        tree_rows = torch.cat([_tree(8, gen), _tree(8, gen)]).to(
            torch.int32).cuda()
        tree_rows = torch.cat([tree_rows, torch.zeros((3, 8), **i32)])
        q_seq = torch.tensor([0] * 8 + [1] * 8 + [4] * 3, **i32)
        args = (_unit(gen, (19, h, hd), dtype), ks, vs, pt, lens, q_seq,
                torch.zeros((19,), **i32), PS)
        tr = dict(nt=nt, tree_rows=tree_rows)
        case = f"{geo} tree 2 x 8 rows + 3 padding"
        got = twice("paged_ragged_attention", dtype, case, check,
                    lambda: pa.paged_ragged_attention(*args, **tr),
                    pa.paged_ragged_attention_reference(*args, **tr))
        zeros("paged_ragged_attention", case, got[16:])


def time_groups(gen, extra) -> None:
    """bf16 times of the five kernels at Falcon-7B's heads (71 over one KV
    head, hd 64; phase 14's shapes) into `extra` under `falcon7b_*` keys,
    each beside its plain version and bound: flash at a 512-token prefill
    chunk over 1024 keys (B=2, starts 512, lens 1000) beside SDPA; decode
    and int4 decode of 2 sessions at 1001 tokens; chunk at a 24-token
    follow-up over 1056 (a 128-page table); ragged at 2 decode rows + a
    32-token chunk + 30 padding rows."""
    import torch

    from bloombee_tpu_torch.kv.quant import quantize
    from bloombee_tpu_torch.ops.attention import repeat_kv
    from bloombee_tpu_torch.ops.cuda import flash_attention as fa
    from bloombee_tpu_torch.ops.cuda import paged_attention as pa

    dt = torch.bfloat16
    h, hkv, hd = 71, 1, 64
    i32 = dict(dtype=torch.int32, device="cuda")
    scale = hd**-0.5

    def put(name, ms, plain, b, library=None):
        extra.setdefault(name, {}).update({
            "falcon7b_ms": ms, "falcon7b_plain_ms": plain,
            "falcon7b_bound_ms": b[0], "falcon7b_bound_by": b[1],
            **({} if library is None else {"falcon7b_library_ms": library}),
        })

    q = _unit(gen, (2, 512, h, hd), dt)
    k = _unit(gen, (2, 1024, hkv, hd), dt)
    v = _unit(gen, (2, 1024, hkv, hd), dt)
    starts = torch.full((2,), 512, **i32)
    lens = torch.full((2,), 1000, **i32)
    args = (q, k, v, True, scale, starts, lens)
    pos_q = starts[:, None] + torch.arange(512, device="cuda")
    kpos = torch.arange(1024, device="cuda")
    mask = ((kpos[None, None] <= pos_q[:, :, None])
            & (kpos[None, None] < lens[:, None, None]))[:, None]
    qt_, kt_, vt_ = (x.transpose(1, 2) for x in
                     (q, repeat_kv(k, h), repeat_kv(v, h)))
    library = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        qt_, kt_, vt_, attn_mask=mask, scale=scale))
    put("flash_attention", cuda_ms(lambda: fa.flash_attention(*args)),
        cuda_ms(lambda: fa.flash_attention_reference(*args), iters=5),
        bound(nbytes(q, k[:, :1000], v[:, :1000], q, starts, lens),
              4 * mask.sum().item() * h * hd, dt), library)

    ks = _unit(gen, (1024 * PS, hkv, hd), dt)
    vs = _unit(gen, (1024 * PS, hkv, hd), dt)
    pt = _page_table(gen, 2, 64, 1024)
    lens = torch.full((2,), 1001, **i32)
    qd = _unit(gen, (2, h, hd), dt)
    args = (qd, ks, vs, pt, lens, PS, scale, 0)
    put("paged_decode_attention",
        cuda_ms(lambda: pa.paged_decode_attention(*args)),
        cuda_ms(lambda: pa.paged_decode_attention_reference(*args)),
        bound(2 * 2 * 1001 * hkv * hd * 2 + nbytes(qd, qd, pt, lens),
              4 * 2 * 1001 * h * hd, dt))
    kq, vq = quantize(ks.float()), quantize(vs.float())
    args = (qd, kq, vq, pt, lens, PS, scale, 0)
    per_row = hd // 2 + 2 * (hd // 32) * 2  # codes + f16 scale and zero
    put("paged_decode_attention_int4",
        cuda_ms(lambda: pa.paged_decode_attention_int4(*args)),
        cuda_ms(lambda: pa.paged_decode_attention_int4_reference(*args)),
        bound(2 * 2 * 1001 * hkv * per_row + nbytes(qd, qd, pt, lens),
              4 * 2 * 1001 * h * hd, dt))

    qc = _unit(gen, (1, 32, h, hd), dt)
    pt1 = _page_table(gen, 1, 128, 1024)
    lens = torch.tensor([1056], **i32)
    args = (qc, ks, vs, pt1, lens, PS, None, scale, 0, 24)
    pairs = sum(1032 + i + 1 for i in range(24))
    put("paged_chunk_attention",
        cuda_ms(lambda: pa.paged_chunk_attention(*args)),
        cuda_ms(lambda: pa.paged_chunk_attention_reference(*args)),
        bound(2 * 1056 * hkv * hd * 2 + nbytes(qc, qc, lens)
              + 66 * 4, 4 * pairs * h * hd, dt))

    lens = torch.tensor([1001, 1001, 32], **i32)
    q_seq = torch.tensor([0, 1] + [2] * 32 + [3] * 30, **i32)
    q_pos = torch.cat([lens[:2] - 1, torch.arange(32, **i32),
                       torch.zeros((30,), **i32)])
    pt3 = _page_table(gen, 3, 128, 1024)
    args = (_unit(gen, (64, h, hd), dt), ks, vs, pt3, lens, q_seq, q_pos,
            PS, scale, 0)
    pairs = 2 * 1001 + 32 * 33 // 2
    put("paged_ragged_attention",
        cuda_ms(lambda: pa.paged_ragged_attention(*args)),
        cuda_ms(lambda: pa.paged_ragged_attention_reference(*args)),
        bound(2 * (2 * 1001 + 32) * hkv * hd * 2 + 2 * 34 * h * hd * 2
              + nbytes(pt3[:, :63], lens, q_seq[:34], q_pos[:34]),
              4 * pairs * h * hd, dt))


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
    """Random layers (`init_block_params`: unit norms, the family's
    extras) and client parameters from one seeded generator on the card:
    an N(0, 1) embedding and an N(0, 1/D) head or, for a tied spec, an
    N(0, 1/D) embedding whose transpose is the head (a view, no second
    copy), so tied logits are unit-scale too; then the family's client
    extras (`Family.client_extras`) in their order: a unit embedding
    LayerNorm, and biases of standard deviation 0.1."""
    import torch

    from bloombee_tpu_torch.models.auto import get_family
    from bloombee_tpu_torch.models.llama.block import init_block_params

    gen = torch.Generator(device="cuda").manual_seed(seed)
    layers = [
        init_block_params(gen, spec, dtype=dtype, device="cuda")
        for _ in range(spec.num_hidden_layers)
    ]
    d, vocab = spec.hidden_size, spec.vocab_size
    embed = torch.randn((vocab, d), generator=gen, device="cuda")
    if spec.tie_word_embeddings:
        embed = embed * d**-0.5
    client = {
        "embed": embed.to(dtype),
        "norm": torch.ones((d,), device="cuda", dtype=dtype),
    }
    del embed
    if spec.tie_word_embeddings:
        client["lm_head"] = client["embed"].t()
    else:
        client["lm_head"] = (
            torch.randn((d, vocab), generator=gen, device="cuda") * d**-0.5
        ).to(dtype)
    for name in get_family(spec.family).client_extras:
        if name == "embed_norm":
            client[name] = torch.ones_like(client["norm"])
        else:  # a LayerNorm's bias
            client[name] = (torch.randn((d,), generator=gen, device="cuda")
                            * 0.1).to(dtype)
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
    f32_routing(24, 8, 128, on_kernels=True)  # GQA group 3
    f32_routing(12, 4, 256, on_kernels=False)  # head_dim 256


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


def f32_routing(h: int, hkv: int, hd: int, on_kernels: bool):
    """Phase 3, routing by the kernels' shape domain: H, Hkv, hd, 2 layers
    at width 3072 in f32. A 600-token prefill (a 512-token flash bucket and
    an 88-token chunk) and 4 decodes past the paged crossover must match
    block_forward + dense_attend, and take the kernels at exact counts
    (`on_kernels`, as at GQA group 3 with hd 128: flash for both prefill
    chunks and paged decode for the decodes, 4 and 8 launches, no other
    kernel) or, outside the domain (hd 256), the dense routes with no
    launch."""
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
        num_attention_heads=h, num_key_value_heads=hkv, head_dim=hd,
        num_hidden_layers=2, vocab_size=32000, rms_norm_eps=1e-5,
        rope_theta=500000.0,
    )
    gen = torch.Generator(device="cuda").manual_seed(3)
    layers = [
        init_block_params(gen, spec, dtype=torch.float32, device="cuda")
        for _ in range(2)
    ]
    manager = CacheManager(2, 64, PS, hkv, hd, dtype=torch.float32,
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
        cos, sin = rotary_cos_sin(pos, hd, spec.rope_theta)
        for p in layers:
            ref, _ = block_forward(p, spec, ref, cos, sin, dense_attend())
    err = (out - ref).abs().max().item()
    lim = 1e-3 * ref.abs().max().item()
    route = "kernel" if on_kernels else "dense"
    say(f"[f32-routing] H={h} Hkv={hkv} hd={hd}, 2 layers: prefill 600 + 4 "
        f"decodes on the {route} routes (paged_supported="
        f"{ex.paged_supported}, flash_supported={ex.flash_supported}) vs "
        f"dense reference: max_abs_err={err:.3e} (limit {lim:.3e}), "
        f"launches {launches}")
    # on the kernels, per layer: flash for both prefill chunks (512 tokens,
    # and 88 bucketed to 128, which is no short chunk for the chunk
    # kernel), paged decode for each of the 4 decodes; nothing else
    want = {"flash_attention": 2 * 2, "paged_decode_attention": 2 * 4}
    got = {k: n for k, n in launches.items() if n}
    if on_kernels:
        routed = ex.paged_supported and ex.flash_supported and got == want
    else:
        routed = not (ex.paged_supported or ex.flash_supported or got)
    if not (routed and err <= lim and torch.isfinite(out).all().item()):
        raise AssertionError(f"H={h} Hkv={hkv} hd={hd} routing check "
                             "failed")


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


async def start_span_servers(layers, spec, uid, spans, dtype, num_pages,
                             reg=None, model_dir=None, **server_kw):
    """A port registry (or `reg`, already running) and one port BlockServer
    per span [(start, end)] on the card, over slices of `layers` (shared
    tensors, no copy) or, given `model_dir`, each loading its span from
    that checkpoint; `server_kw` (max_batch, mixed_batch, prefill_chunk,
    prefix_cache, session_lease_s) goes to each."""
    from bloombee_tpu_torch.server.block_server import BlockServer
    from bloombee_tpu_torch.swarm.registry import (
        RegistryClient,
        RegistryServer,
    )

    if reg is None:
        reg = RegistryServer(host="127.0.0.1")
        await reg.start()
    servers = []
    for start, end in spans:
        server = BlockServer(
            model_uid=uid, start=start, end=end,
            params=None if model_dir else layers[start:end],
            spec=None if model_dir else spec, model_dir=model_dir,
            registry=RegistryClient("127.0.0.1", reg.port),
            num_pages=num_pages, page_size=PS, compute_dtype=dtype,
            max_chunk_tokens=512, throughput=1.0, device="cuda",
            **server_kw,
        )
        await server.start()
        servers.append(server)
    return reg, servers


async def stop_span_servers(reg, servers):
    for server in servers:
        await server.stop()
        await server.registry.close()
    await reg.stop()


def port_client(client, spec, reg_port, uid, **config):
    """The port's DistributedModelForCausalLM over the in-memory client
    parameters, routing with a RemoteSequenceManager over the port
    registry (push on; `config`: more ClientConfig fields). The caller
    closes `model.manager.registry`."""
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
        spec, client, manager, config=ClientConfig(use_push=True, **config),
        device="cuda",
    )


def tap(session, model, on_embed=None) -> dict:
    """Record, without changing them, what an open session's steps return
    ("outs") and when each returned ("stepped": host clock), every reply
    meta its span streams receive ("metas": (span, meta)) and when the
    model embeds ("embeds": host clock). generate
    embeds the prompt first and then each token as soon as it is selected
    (the selection's copy to the host has synchronized the device), so the
    first gap is the time to the first token and later gaps are per-token
    times: step + head + embed. `on_embed(n)` runs after the n-th embed."""
    rec = {"outs": [], "metas": [], "embeds": [], "stepped": []}
    step, embed = session.step, model.embed

    async def tapped_step(*args, **kwargs):
        out = await step(*args, **kwargs)
        rec["outs"].append(out)
        rec["stepped"].append(time.perf_counter())
        return out

    def tapped_embed(ids):
        rec["embeds"].append(time.perf_counter())
        if on_embed is not None:
            on_embed(len(rec["embeds"]))
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
    for phase in (phase_served, phase_spec, phase_prefix, phase_decode_n):
        t0 = time.perf_counter()
        launches.update(phase(layers, spec, client, gen))
        say(f"[timing] {phase.__name__} took "
            f"{time.perf_counter() - t0:.1f} s")
    launches.update(phase_cli(gen))
    return launches


# ------------------------------------------------------------- phase 5
SERVED_RUNS = (
    # (path, label, server keyword arguments)
    ("served", "(a) unbatched", {"max_batch": 1}),
    ("served_batched", "(b) server defaults", {}),
    ("served_mixed", "(c) mixed", {"mixed_batch": True, "prefill_chunk": 32}),
)
BATCH_KEYS = ("batched_steps", "batch_dispatches", "batch_solo_steps",
              "mean_batch_width", "prefill_chunks", "prefill_chunk_tokens",
              "decode_steps_interleaved", "mixed_batch", "mixed_dispatches",
              "mixed_tokens", "ragged_group_dispatches",
              "ragged_cross_kind_dispatches", "ragged_declines")


class ReplayWatch:
    """Collects the port server's "replaying row-by-row" / "replaying solo"
    warnings (a failed merged or mixed dispatch replayed per member) while
    installed as a handler on its logger."""

    def __init__(self):
        import logging

        class Handler(logging.Handler):
            def emit(inner, record):
                msg = record.getMessage()
                if "replaying row-by-row" in msg or "replaying solo" in msg:
                    self.seen.append(msg)

        self.seen: list[str] = []
        self.handler = Handler(logging.WARNING)
        self.logger = logging.getLogger(
            "bloombee_tpu_torch.server.block_server"
        )

    def __enter__(self) -> "ReplayWatch":
        self.logger.addHandler(self.handler)
        return self

    def __exit__(self, *exc) -> None:
        self.logger.removeHandler(self.handler)


@contextlib.contextmanager
def env_set(name: str, value: str):
    """Set an environment variable for the block, restoring it after."""
    import os

    saved = os.environ.get(name)
    os.environ[name] = value
    try:
        yield
    finally:
        if saved is None:
            os.environ.pop(name, None)
        else:
            os.environ[name] = saved


def served_reference(layers, spec, local, prompts, follows, n_new,
                     feed=None, chunk=0, dtype=None, max_len=1100,
                     dense=False):
    """The sessions (one per prompt: a [n, L] tensor or a list of [L_i]
    tensors) solo on one in-process SpanExecutor with the server's
    calls (prefill for T>1, in `chunk`-token chunks as a chunking server
    cuts a prompt; B=1 decode for T=1): the prompt, n_new - 1 decodes and
    (unless `follows` is None) the follow-up turn and one decode, in bf16
    or (`dtype`, `layers` in it) in f32 on the same bf16 inputs. Each
    decode feeds the
    reference's own greedy token (the client's head on the executor's
    output gathered in f32) or, teacher-forced, `feed[i]`: the tokens the
    served run chose. Sessions hold up to `max_len` tokens; `dense` builds
    the executor with BBTPU_PAGED_MIN_CONTEXT past any context, so every
    step takes the dense attention route. Returns per session
    (last-position hidden states [n_new (+ 2), D] f32, the reference's
    greedy tokens) and the decode steps' wall times."""
    import torch

    from bloombee_tpu_torch.kv.cache_manager import CacheManager
    from bloombee_tpu_torch.runtime.executor import SpanExecutor

    bf16, n_layers = torch.bfloat16, spec.num_hidden_layers
    dtype = dtype or bf16
    manager = CacheManager(n_layers, 1024, PS, spec.num_key_value_heads,
                           spec.head_dim, dtype=dtype, device="cuda")
    with (env_set("BBTPU_PAGED_MIN_CONTEXT", str(1 << 30)) if dense
          else contextlib.nullcontext()):
        ex = SpanExecutor(layers, spec, manager, max_chunk_tokens=512,
                          compute_dtype=dtype, device="cuda")
    sessions, step_s = [], []

    def embed(ids):
        # what the wire carries
        return local.embed(ids).to(bf16).to(dtype)

    def head(out):
        return local.logits(out[:, -1:].float())[:, 0].argmax(-1)

    def decode(h, token):
        hid = embed(token[:, None])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = ex.decode(h, hid, fetch=False)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        return out

    async def run():
        for i in range(len(prompts)):
            fed = None if feed is None else feed[i].to("cuda")

            def nxt(k, tokens):
                return tokens[-1] if fed is None else fed[k : k + 1]

            async with manager.allocate(1, max_len) as h:
                prompt = embed(prompts[i][None])
                outs = [
                    ex.prefill_chunked(h, prompt, chunk, fetch=False)
                    if chunk else ex.prefill(h, prompt, fetch=False)
                ]
                tokens = [head(outs[-1])]
                for k in range(n_new - 1):
                    outs.append(decode(h, nxt(k, tokens)))
                    tokens.append(head(outs[-1]))
                if follows is not None:
                    outs.append(ex.prefill(h, embed(follows[i][None]),
                                           fetch=False))
                    tokens.append(head(outs[-1]))
                    outs.append(decode(h, nxt(n_new, tokens)))
                    tokens.append(head(outs[-1]))
                sessions.append((
                    torch.cat([o[:, -1] for o in outs]).float(),
                    torch.cat(tokens).cpu(),
                ))

    asyncio.run(run())
    del ex, manager
    torch.cuda.empty_cache()
    return sessions, step_s


def served_run(layers, spec, client, prompts, follows, n_new, server_kw,
               late=False, alone=False) -> dict:
    """One served run: a port registry and two port BlockServers
    (`server_kw`) on a ServerLoop, 4 port-client sessions on this thread's
    loop. Each session `generate`s n_new tokens from its prompt, then a
    follow-up turn with 2 more tokens; with `late`, sessions 0-2 start
    together and session 3 sends its prompt once each of them has decoded
    8 tokens. Launch counts are reset just before the sessions step and
    read just after; with `alone`, session 0 then steps 8 more tokens by
    itself. Returns what the run recorded, both servers' rpc_info and the
    replay warnings seen."""
    import torch

    from bloombee_tpu_torch.ops.cuda import build
    from bloombee_tpu_torch.wire import tensor_codec

    n_layers = spec.num_hidden_layers
    spans = ((0, n_layers // 2), (n_layers // 2, n_layers))

    async def one_session(model, session, i, start=None):
        if start is not None:
            await start
        ids = await model.generate(prompts[i : i + 1], max_new_tokens=n_new,
                                   session=session)
        more = await model.generate(follows[i : i + 1], max_new_tokens=2,
                                    session=session)
        return torch.cat([ids[0, -n_new:], more[0, -2:]])

    async def served(reg_port):
        models = [port_client(client, spec, reg_port, "llama3-8b")
                  for _ in range(4)]
        decoded_8 = [asyncio.Event() for _ in range(3)]

        def on_embed(i):
            # the prompt's embed, then one per selected token
            return lambda n: n == 9 and decoded_8[i].set()

        try:
            async with contextlib.AsyncExitStack() as stack:
                sessions = [
                    await stack.enter_async_context(
                        m.inference_session(1100, 1)
                    )
                    for m in models
                ]
                recs = [
                    tap(s, m, on_embed(i) if late and i < 3 else None)
                    for i, (s, m) in enumerate(zip(sessions, models))
                ]
                start3 = (asyncio.gather(*(e.wait() for e in decoded_8))
                          if late else None)
                torch.cuda.synchronize()
                build.reset_launch_counts()
                before = tensor_codec.transport_stats()
                t0 = time.perf_counter()
                tokens = await asyncio.gather(*(
                    one_session(models[i], sessions[i], i,
                                start3 if i == 3 else None)
                    for i in range(4)
                ))
                torch.cuda.synchronize()
                wall_s = time.perf_counter() - t0
                launches = dict(build.LAUNCHES)
                after = tensor_codec.transport_stats()
                summaries = [s.timing_summary() for s in sessions]
                firsts = [
                    (len(r["embeds"]), len(r["metas"])) for r in recs
                ]
                rest = None
                if alone:
                    # 8 more decode steps of session 0 alone: the served
                    # step without other sessions in the queues, and its
                    # wire bytes
                    k0 = len(sessions[0].timings)
                    tx0 = tensor_codec.transport_stats()["tx"]
                    await models[0].generate(tokens[0][-1:][None],
                                             max_new_tokens=8,
                                             session=sessions[0])
                    tx1 = tensor_codec.transport_stats()["tx"]
                    rest = {
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
        return {
            "route": route, "tokens": [t.cpu() for t in tokens],
            "recs": recs, "firsts": firsts, "summaries": summaries,
            "launches": launches, "wall_s": wall_s,
            "codec": (before, after), "alone": rest,
        }

    with ReplayWatch() as watch, ServerLoop() as servers_loop:
        reg, servers = servers_loop.run(start_span_servers(
            layers, spec, "llama3-8b", spans, torch.bfloat16, 1024,
            **server_kw
        ))
        try:
            out = asyncio.run(served(reg.port))
            out["infos"] = [servers_loop.run(s._rpc_info({}, []))[0]
                            for s in servers]
            out["server_layers"] = [s.end_block - s.start_block
                                    for s in servers]
        finally:
            servers_loop.run(stop_span_servers(reg, servers))
            del servers
    out["replays"] = list(watch.seen)
    torch.cuda.empty_cache()
    return out


def served_numbers(run, n_new) -> dict:
    """Time to first token, per-token medians and the replies' dispatch
    and fetch medians of one served run (ms)."""
    def med(xs):
        xs = sorted(xs)
        return xs[len(xs) // 2]

    def gaps(ts):
        return [(b - a) * 1e3 for a, b in zip(ts, ts[1:])]

    recs, firsts = run["recs"], run["firsts"]
    n_hops = len(run["route"])
    out = {
        # embeds of the first generate: the prompt, then tokens 1..n-1
        "ttft_ms": [gaps(r["embeds"][:2])[0] for r in recs],
        "per_token_ms_median": [med(gaps(r["embeds"][1:n_new]))
                                for r in recs],
        "reply_ms_median": {
            f"server{k}": {
                key: med([m[key] for r, (_, m0) in zip(recs, firsts)
                          for kk, m in r["metas"][:m0]
                          if kk == k and key in m])
                for key in ("t_dispatch_ms", "t_fetch_ms")
            }
            for k in range(n_hops)
        },
        "served_run_s": run["wall_s"],
        "timing_summary": [
            {k: s[k] for k in ("steps", "mean_total_ms",
                               "mean_compute_ms_per_span",
                               "mean_wire_and_overhead_ms")}
            for s in run["summaries"]
        ],
        "launches": run["launches"],
        "batching": [{k: info[k] for k in BATCH_KEYS}
                     for info in run["infos"]],
        "replays": len(run["replays"]),
    }
    alone = run["alone"]
    if alone is not None:
        out["one_session_alone"] = {
            "decode_step_ms_median": med(
                [t["total_ms"] for t in alone["timings"]]
            ),
            "per_token_ms_median": med(gaps(alone["embeds"])),
            **{
                f"server{k}_{key}": med([m[key] for kk, m in alone["metas"]
                                         if kk == k and key in m])
                for k in range(n_hops)
                for key in ("t_dispatch_ms", "t_fetch_ms")
            },
        }
        tx0, tx1 = alone["tx"]
        out["decode_step_wire"] = {
            k: (tx1[k] - tx0[k]) / len(alone["timings"])
            for k in ("n", "raw_bytes", "wire_bytes", "compressed")
        }
    st0, st1 = run["codec"]
    total = {k: st1["tx"][k] - st0["tx"][k]
             for k in ("n", "raw_bytes", "wire_bytes", "compressed")}
    # codec seconds, summed over the threads that ran them
    total["encode_s"] = st1["tx"]["s"] - st0["tx"]["s"]
    total["decode_s"] = st1["rx"]["s"] - st0["rx"]["s"]
    out["served_run_wire"] = total
    return out


def served_last_hidden(run, n_new):
    """Each session's last-position outputs of its n_new + 2 steps (the
    steps after them, if any, are the alone steps)."""
    import torch

    return [torch.cat([o[:, -1] for o in r["outs"][: n_new + 2]]).float()
            for r in run["recs"]]


def hold_teacher_forced(local, lasts, tokens, ref, truth) -> dict:
    """A served run's last-position outputs and tokens per session against
    the solo executor fed the tokens the served run chose, in bf16 (`ref`)
    and in f32 (`truth`, the same bf16 inputs).

    - A greedy token may differ from the bf16 reference's only where the
      reference's top-1 minus top-2 logit gap is below the largest logit
      difference between the served and the reference output at that
      position.
    - At every step the served last hidden state is no further from the f32
      truth than 1.5 x the bf16 reference's own distance (relative norms):
      the served path is as accurate as the solo path. Two bf16
      computations that round differently (GEMMs at M = width, the ragged
      kernel for a fused chunk) are each ~3% from the f32 truth at 32
      layers and as far from each other, so the elementwise 1e-2 x |ref| +
      1e-3 of run (a) cannot hold between them; the elements over that
      limit against the bf16 reference are reported, not gated.

    Returns the verdict, the tolerated flips, whether the hidden states
    came out bit for bit, and per session the worst ratio of the served to
    the reference distance from the truth, the elements over the
    elementwise limit and the relative norm against the bf16 reference."""
    import torch

    def rel(a, b):
        return (a - b).norm(dim=-1) / b.norm(dim=-1)  # per step

    ok, bitwise, worst, flips, sessions = True, True, 0.0, 0, []
    for last, toks, (ref_last, ref_toks), (true_last, _) in zip(
        lasts, tokens, ref, truth
    ):
        diff = (last - ref_last).abs()
        limit = 1e-2 * ref_last.abs() + 1e-3
        worst = max(worst, diff.max().item())
        bitwise = bitwise and torch.equal(last, ref_last)
        e_served, e_ref = rel(last, true_last), rel(ref_last, true_last)
        sessions.append({
            "served_over_ref_err_vs_f32": (e_served / e_ref).max().item(),
            "ref_err_vs_f32": [e_ref.min().item(), e_ref.max().item()],
            "over_limit_vs_ref": int((diff > limit).sum().item()),
            "rel_norm_vs_ref": (diff.norm() / ref_last.norm()).item(),
        })
        ok = ok and bool((e_served <= 1.5 * e_ref).all()) and \
            torch.isfinite(last).all().item()
        for k in (toks != ref_toks).nonzero().flatten().tolist():
            got = local.logits(last[k][None, None])[0, 0]
            want = local.logits(ref_last[k][None, None])[0, 0]
            top2 = want.topk(2).values
            gap = (top2[0] - top2[1]).item()
            if gap < (got - want).abs().max().item():
                flips += 1
            else:
                ok = False
    return {"ok": ok, "max_abs_err": worst, "tolerated_flips": flips,
            "bit_for_bit": bitwise, "sessions": sessions}


def phase_served(layers, spec, client, gen) -> dict:
    """Phase 5: the whole Llama-3-8B served on the wire to the port's own
    client, three runs on phase 4's weights (two port BlockServers over
    blocks [0, 16) and [16, 32), 1024-page arenas each, a port registry,
    four port-client sessions with bf16 client parameters and push; each
    session `generate`s 32 greedy tokens from a 1000-token prompt, then a
    24-token follow-up turn with 2 more tokens):

    (a) `max_batch=1`: tokens identical to the sessions solo on one
        executor + the client's head, last hidden states within
        1e-2 x |ref| + 1e-3, one decode launch per layer per session step;
    (b) the server defaults (`max_batch=8`, monolithic prefill): merged
        decode dispatches on both servers (mean width >= 2), decode
        launches equal to each server's layers x its dispatches carrying
        decode rows;
    (c) `mixed_batch=True`, `prefill_chunk=32`, session 3's prompt sent
        once sessions 0-2 have decoded 8 tokens each: mixed dispatches,
        decode steps interleaved with chunks, the ragged kernel launched.

    (b) and (c) are held teacher-forced against the solo executor in bf16
    and an f32 truth (`hold_teacher_forced`). No run may
    replay a failed group, and no server may decline the ragged path.
    Returns each run's launch counts by path."""
    import torch

    from bloombee_tpu_torch.client import DistributedModelForCausalLM

    vocab, n_new = spec.vocab_size, 32
    prompts = torch.randint(0, vocab, (4, 1000), generator=gen, device="cuda")
    follows = torch.randint(0, vocab, (4, 24), generator=gen, device="cuda")
    local = DistributedModelForCausalLM(spec, client, None, device="cuda")

    ref_a, ref_step_s = served_reference(layers, spec, local, prompts,
                                         follows, n_new)
    # the head's device time on one f32 position (bf16 parameters: the
    # per-call upcast of lm_head to f32 included)
    h1 = ref_a[0][0][-1:][None]
    head_ms = cuda_ms(lambda: local.logits(h1))
    head_bound = bound(nbytes(client["norm"], client["lm_head"], h1)
                       + 4 * vocab, 2 * spec.hidden_size * vocab,
                       torch.float32)
    say(f"[served] head {head_ms:.4f} ms on the device (bound "
        f"{head_bound[0]:.4f} ms, {head_bound[1]}); the executor's solo B=1 "
        f"decode step {sorted(ref_step_s)[len(ref_step_s) // 2] * 1e3:.3f} "
        f"ms (median)")

    # the f32 truth of runs (b) and (c): f32 copies of the layers, TF32 off
    torch.backends.cuda.matmul.allow_tf32 = False
    by_path, failures, layers32 = {}, [], None
    for path, label, server_kw in SERVED_RUNS:
        run = served_run(layers, spec, client, prompts, follows, n_new,
                         server_kw, late=path == "served_mixed",
                         alone=path == "served")
        launches = by_path[path] = run["launches"]
        stats = served_numbers(run, n_new)
        stats["route"] = [list(r) for r in run["route"]]
        if path == "served":
            worst, same = 0.0, True
            for last, toks, (ref_last, ref_toks) in zip(
                served_last_hidden(run, n_new), run["tokens"], ref_a
            ):
                diff = (last - ref_last).abs()
                worst = max(worst, diff.max().item())
                same = same and torch.equal(toks, ref_toks) and bool(
                    (diff <= 1e-2 * ref_last.abs() + 1e-3).all()
                ) and torch.isfinite(last).all().item()
            held = {"ok": same, "max_abs_err": worst,
                    "tokens_identical": same}
        else:
            if layers32 is None:
                layers32 = [{k: v.float() for k, v in layer.items()}
                            for layer in layers]
            ref, truth = (
                served_reference(
                    ls, spec, local, prompts, follows, n_new,
                    feed=run["tokens"], dtype=dt,
                    chunk=server_kw.get("prefill_chunk", 0),
                )[0]
                for ls, dt in ((layers, None), (layers32, torch.float32))
            )
            held = hold_teacher_forced(
                local, served_last_hidden(run, n_new), run["tokens"], ref,
                truth,
            )
        stats["held"] = held
        infos = run["infos"]
        decode_dispatches = [i["batch_dispatches"] + i["batch_solo_steps"]
                             for i in infos]
        want_decode = sum(n * d for n, d in zip(run["server_layers"],
                                                decode_dispatches))
        stats["decode_launches_want"] = (
            spec.num_hidden_layers * 4 * n_new if path == "served"
            else want_decode
        )
        say(f"[{path}] {label}: Llama-3-8B bf16 over {stats['route']}, 4 "
            f"port-client sessions; held against the solo executor: "
            f"{held}; time to first token "
            f"{[round(x, 2) for x in stats['ttft_ms']]} ms; per-token "
            f"medians {[round(x, 3) for x in stats['per_token_ms_median']]}"
            f" ms; replies' medians {stats['reply_ms_median']}; launches "
            f"{launches} (decode launches wanted "
            f"{stats['decode_launches_want']}); batching "
            f"{stats['batching']}; replays {run['replays']}")
        say(f"[{path}] " + json.dumps(stats))
        if not held["ok"]:
            failures.append(f"{path}: differs from the solo executor")
        if run["replays"]:
            failures.append(f"{path}: group replays {run['replays']}")
        if any(i["ragged_declines"] for i in infos):
            failures.append(f"{path}: ragged declines")
        # a chunking server never prefills a bucket of 128+ tokens: its
        # prompts run as 32-token chunks (paged chunk or, fused, ragged)
        wanted = (("paged_decode_attention", "paged_chunk_attention",
                   "paged_ragged_attention") if path == "served_mixed"
                  else ("flash_attention", "paged_decode_attention",
                        "paged_chunk_attention"))
        missing = [k for k in wanted if not launches.get(k)]
        if path == "served_mixed":
            if not (sum(i["mixed_dispatches"] for i in infos) > 0
                    and sum(i["decode_steps_interleaved"] for i in infos) > 0):
                failures.append(f"{path}: no mixed or interleaved dispatch")
        if missing:
            failures.append(f"{path}: never launched {missing}")
        if path != "served_mixed" and launches.get(
            "paged_decode_attention"
        ) != stats["decode_launches_want"]:
            failures.append(
                f"{path}: {launches.get('paged_decode_attention')} decode "
                f"launches, want {stats['decode_launches_want']}"
            )
        if path == "served_batched" and not all(
            i["batch_dispatches"] > 0 and i["mean_batch_width"] >= 2
            for i in infos
        ):
            failures.append(f"{path}: a server merged no decode dispatch")
    del layers32
    torch.cuda.empty_cache()
    say(card_line())
    if failures:
        raise AssertionError("served runs failed: " + "; ".join(failures))
    return by_path


# ------------------------------------------------------------- phase 6
SPEC_RUNS = (
    # (path, label, server keyword arguments, drafter depth (None: every
    # layer, the self-drafter), gather window in ms)
    ("spec_solo", "(d) solo tree verify, self-drafter", {}, None, 0),
    ("spec_batched", "(e) spec_batch, 2-layer drafter",
     {"spec_batch": True}, 2, 100),
)


def spec_tap(session) -> dict:
    """Record, without changing them, what an open session's steps return
    ("outs"), when they returned ("times") and how long each took
    ("step_ms"), the accept that each step and the final `send_accept`
    carry ("accepts"), and each span's replies' `t_dispatch_ms`
    ("dispatch_ms", per span)."""
    rec = {"outs": [], "times": [], "step_ms": [], "accepts": [],
           "dispatch_ms": [[] for _ in session._spans]}
    step, send_accept = session.step, session.send_accept

    async def tapped_step(*args, **kwargs):
        t0 = time.perf_counter()
        out = await step(*args, **kwargs)
        rec["times"].append(time.perf_counter())
        rec["step_ms"].append((rec["times"][-1] - t0) * 1e3)
        rec["outs"].append(out)
        rec["accepts"].append(kwargs.get("accept"))
        return out

    async def tapped_accept(accept, per_span=None):
        rec["accepts"].append(accept)
        return await send_accept(accept, per_span=per_span)

    def tapped_recv(k, recv):
        async def recv_meta():
            item = await recv()
            if item is not None and "t_dispatch_ms" in item[0]:
                rec["dispatch_ms"][k].append(item[0]["t_dispatch_ms"])
            return item
        return recv_meta

    session.step, session.send_accept = tapped_step, tapped_accept
    for k, span in enumerate(session._spans):
        span.stream.recv = tapped_recv(k, span.stream.recv)
    return rec


def spec_committed(rec):
    """A B=1 speculative session's outputs at its committed positions,
    [n_new, D] f32: the prompt's last position, then each round's accepted
    tree nodes in path order (round r's accept rides round r + 1's step,
    the last one the final `send_accept`)."""
    import torch

    rows = [rec["outs"][0][0, -1:]]
    for out, acc in zip(rec["outs"][1:], rec["accepts"][2:]):
        idx = torch.as_tensor(acc[0], dtype=torch.long, device=out.device)
        rows.append(out[0, idx])
    return torch.cat(rows).float()


def spec_run(layers, spec, client, prompts, n_new, server_kw, draft_depth,
             window_ms) -> dict:
    """One speculative served run: a port registry and two port
    BlockServers (`server_kw`) on a ServerLoop, and 4 port-client sessions
    on this thread's loop, each `generate_speculative`-ing n_new greedy
    tokens from its prompt with its own GreedyTreeDrafter (2, 2, 1) over a
    LocalDraftModel of the target's first `draft_depth` layers (all of them
    when None) and the client's parameters, sharing their tensors. Each
    session closes when its generation ends. Launch counts are reset just
    before the sessions step and read just after; the gather window is
    `window_ms` for the run."""
    import dataclasses
    import os

    import torch

    from bloombee_tpu_torch.client.speculative import generate_speculative
    from bloombee_tpu_torch.ops.cuda import build
    from bloombee_tpu_torch.spec.drafter import (
        GreedyTreeDrafter,
        LocalDraftModel,
    )
    from bloombee_tpu_torch.spec.shape import tree_nodes

    n_layers = spec.num_hidden_layers
    spans = ((0, n_layers // 2), (n_layers // 2, n_layers))
    depth = draft_depth or n_layers
    draft = LocalDraftModel(
        dataclasses.replace(spec, num_hidden_layers=depth), layers[:depth],
        client, device="cuda",
    )
    drafters = [GreedyTreeDrafter(draft) for _ in range(4)]
    max_length = (prompts.shape[1] + n_new
                  + 2 * (tree_nodes(drafters[0].branching) + 1))
    draft_ms = [[] for _ in drafters]

    def timed_build(build_batch, into):
        # the drafter's logits reach the host inside build_batch, so its
        # host time includes the device work
        def build(contexts):
            t0 = time.perf_counter()
            out = build_batch(contexts)
            into.append((time.perf_counter() - t0) * 1e3)
            return out
        return build

    for d, into in zip(drafters, draft_ms):
        d.build_batch = timed_build(d.build_batch, into)

    async def one_session(model, i):
        async with model.inference_session(max_length, 1) as session:
            rec = spec_tap(session)
            rec["draft_ms"] = draft_ms[i]
            rec["t0"] = time.perf_counter()
            ids = await generate_speculative(
                model, drafters[i], prompts[i : i + 1],
                max_new_tokens=n_new, session=session,
            )
        rec["tokens"] = ids[0, -n_new:]
        return rec

    async def served(reg_port):
        models = [port_client(client, spec, reg_port, "llama3-8b")
                  for _ in range(4)]
        try:
            torch.cuda.synchronize()
            build.reset_launch_counts()
            t0 = time.perf_counter()
            recs = await asyncio.gather(*(
                one_session(models[i], i) for i in range(4)
            ))
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0
            launches = dict(build.LAUNCHES)
        finally:
            for m in models:
                await m.manager.registry.close()
        return {"recs": recs, "launches": launches, "wall_s": wall_s}

    old_window = os.environ.get("BBTPU_BATCH_WINDOW_MS")
    os.environ["BBTPU_BATCH_WINDOW_MS"] = str(window_ms)
    try:
        with ReplayWatch() as watch, ServerLoop() as servers_loop:
            reg, servers = servers_loop.run(start_span_servers(
                layers, spec, "llama3-8b", spans, torch.bfloat16, 1024,
                **server_kw
            ))
            try:
                out = asyncio.run(served(reg.port))
                out["infos"] = [servers_loop.run(s._rpc_info({}, []))[0]
                                for s in servers]
                out["server_layers"] = [s.end_block - s.start_block
                                        for s in servers]
            finally:
                servers_loop.run(stop_span_servers(reg, servers))
                del servers
    finally:
        if old_window is None:
            os.environ.pop("BBTPU_BATCH_WINDOW_MS", None)
        else:
            os.environ["BBTPU_BATCH_WINDOW_MS"] = old_window
    out["replays"] = list(watch.seen)
    out["drafters"] = drafters
    del draft
    torch.cuda.empty_cache()
    return out


SPEC_KEYS = ("spec_batch", "tree_steps", "tree_rows", "spec_tokens_drafted",
             "spec_tokens_accepted", "spec_accept_rate",
             "tree_group_dispatches", "tree_group_members",
             "mean_tree_batch_width", "batch_solo_steps",
             "ragged_group_dispatches", "ragged_declines")


def spec_numbers(run, n_new) -> dict:
    """Time to first token, per-token time, rounds, tokens per round and
    acceptance of one speculative run (ms unless marked)."""
    def med(xs):
        xs = sorted(xs)
        return xs[len(xs) // 2]

    recs = run["recs"]
    levels = [(d.levels_accepted, d.levels_drafted) for d in run["drafters"]]
    rounds = [len(r["outs"]) - 1 for r in recs]
    return {
        # per round (the prefill excluded): the drafter's build_batch, the
        # tree step's round trip and each server's reply dispatch time
        "draft_ms_median": [med(r["draft_ms"]) for r in recs],
        "verify_step_ms_median": [med(r["step_ms"][1:]) for r in recs],
        "t_dispatch_ms_median": [
            med([x for r in recs for x in r["dispatch_ms"][k][1:]])
            for k in range(len(recs[0]["dispatch_ms"]))
        ],
        "ttft_ms": [(r["times"][0] - r["t0"]) * 1e3 for r in recs],
        # after the first token: the rounds' wall time over the n_new - 1
        # tokens they committed
        "per_token_ms": [
            (r["times"][-1] - r["times"][0]) * 1e3 / (n_new - 1)
            for r in recs
        ],
        "rounds": rounds,
        "tokens_per_round": [(n_new - 1) / k for k in rounds],
        "drafter_accept_rate": [d.accept_rate for d in run["drafters"]],
        "drafter_accept_rate_all": (
            sum(a for a, _ in levels) / max(sum(d for _, d in levels), 1)
        ),
        "servers": [{k: info[k] for k in SPEC_KEYS} for info in run["infos"]],
        "launches": run["launches"],
        "served_run_s": run["wall_s"],
        "replays": len(run["replays"]),
    }


def phase_spec(layers, spec, client, gen) -> dict:
    """Phase 6: speculative decoding served at full width on phase 4's
    weights, two runs (two port BlockServers over blocks [0, 16) and [16,
    32), 1024-page arenas, a port registry, four push sessions of the port
    client, each `generate_speculative`-ing 32 greedy tokens from a
    1000-token prompt, so every tree verify sees more than 512 tokens of
    context):

    (d) server defaults, the self-drafter (all 32 layers and the client's
        head, shared tensors): every tree verify is a solo dispatch on the
        paged chunk kernel, chunk launches = each server's layers x its
        tree steps; the drafters' accept rate above 0.5;
    (e) `spec_batch=True`, a 2-layer drafter, a 100 ms gather window:
        tree groups on both servers (mean width > 1), ragged launches =
        each server's layers x its tree groups, chunk launches = layers x
        its solo tree dispatches.

    Both are held teacher-forced on their committed positions against the
    solo executor in bf16 and an f32 truth (`hold_teacher_forced`). No run
    may replay a group or decline the ragged path. Returns each run's
    launch counts by path."""
    import torch

    from bloombee_tpu_torch.client import DistributedModelForCausalLM

    vocab, n_new = spec.vocab_size, 32
    prompts = torch.randint(0, vocab, (4, 1000), generator=gen, device="cuda")
    local = DistributedModelForCausalLM(spec, client, None, device="cuda")
    runs = {}
    for path, label, server_kw, depth, window_ms in SPEC_RUNS:
        runs[path] = spec_run(layers, spec, client, prompts, n_new,
                              server_kw, depth, window_ms)
    torch.backends.cuda.matmul.allow_tf32 = False
    layers32 = [{k: v.float() for k, v in layer.items()} for layer in layers]
    by_path, failures = {}, []
    for path, label, server_kw, depth, window_ms in SPEC_RUNS:
        run = runs[path]
        tokens = [r["tokens"] for r in run["recs"]]
        lasts = [spec_committed(r) for r in run["recs"]]
        if any(last.shape[0] != n_new for last in lasts):
            failures.append(f"{path}: committed outputs "
                            f"{[last.shape[0] for last in lasts]} != {n_new}")
            continue
        ref, truth = (
            served_reference(ls, spec, local, prompts, None, n_new,
                             feed=tokens, dtype=dt)[0]
            for ls, dt in ((layers, None), (layers32, torch.float32))
        )
        held = hold_teacher_forced(local, lasts, tokens, ref, truth)
        stats = spec_numbers(run, n_new)
        stats["held"] = held
        launches = by_path[path] = run["launches"]
        infos, per = run["infos"], run["server_layers"]
        if path == "spec_solo":
            want = {"paged_chunk_attention": sum(
                n * i["tree_steps"] for n, i in zip(per, infos)
            )}
            if stats["drafter_accept_rate_all"] <= 0.5:
                failures.append(f"{path}: drafter accept rate "
                                f"{stats['drafter_accept_rate_all']:.3f}")
        else:
            want = {
                "paged_ragged_attention": sum(
                    n * i["tree_group_dispatches"] for n, i in zip(per, infos)
                ),
                "paged_chunk_attention": sum(
                    n * (i["tree_steps"] - i["tree_group_members"])
                    for n, i in zip(per, infos)
                ),
            }
            if not all(i["tree_group_dispatches"] > 0
                       and i["mean_tree_batch_width"] > 1 for i in infos):
                failures.append(f"{path}: a server formed no tree group")
        stats["launches_want"] = want
        say(f"[{path}] {label}: Llama-3-8B bf16, 4 port-client sessions x "
            f"{n_new} tokens by generate_speculative; held against the "
            f"solo executor: {held}; per-token "
            f"{[round(x, 2) for x in stats['per_token_ms']]} ms (drafter "
            f"{[round(x, 1) for x in stats['draft_ms_median']]}, verify "
            f"step {[round(x, 1) for x in stats['verify_step_ms_median']]}"
            f" ms a round, medians); rounds "
            f"{stats['rounds']}; tokens per round "
            f"{[round(x, 2) for x in stats['tokens_per_round']]}; drafter "
            f"accept rate {stats['drafter_accept_rate_all']:.4f}; servers' "
            f"spec_accept_rate "
            f"{[round(i['spec_accept_rate'], 4) for i in infos]}; launches "
            f"{launches} (wanted {want}); replays {run['replays']}")
        say(f"[{path}] " + json.dumps(stats))
        if not held["ok"]:
            failures.append(f"{path}: differs from the solo executor")
        if run["replays"]:
            failures.append(f"{path}: group replays {run['replays']}")
        if any(i["ragged_declines"] for i in infos):
            failures.append(f"{path}: ragged declines")
        if not all(i["tree_steps"] > 0 for i in infos):
            failures.append(f"{path}: a server verified no tree")
        for name, n in want.items():
            if launches.get(name, 0) != n:
                failures.append(f"{path}: {launches.get(name, 0)} {name} "
                                f"launches, want {n}")
        # the prompts' flash prefill, and the path's own tree kernel
        main = ("paged_chunk_attention" if path == "spec_solo"
                else "paged_ragged_attention")
        missing = [k for k in ("flash_attention", main)
                   if not launches.get(k)]
        if missing:
            failures.append(f"{path}: never launched {missing}")
    del layers32
    torch.cuda.empty_cache()
    say(card_line())
    if failures:
        raise AssertionError("speculative runs failed: "
                             + "; ".join(failures))
    return by_path


# ------------------------------------------------------------- phase 7
PREFIX_SERVER_KW = {"prefix_cache": True, "session_lease_s": 30.0,
                    "max_batch": 1}


def prefill_wire(session) -> dict:
    """Fill the returned dict with the wire traffic (every hop: the
    client's send, the push between the servers, the reply) of the
    session's next step, which must be its only step in flight."""
    from bloombee_tpu_torch.wire import tensor_codec

    box, step = {}, session.step

    async def first_step(*args, **kwargs):
        session.step = step
        t0 = tensor_codec.transport_stats()["tx"]
        out = await step(*args, **kwargs)
        t1 = tensor_codec.transport_stats()["tx"]
        box.update({k: t1[k] - t0[k]
                    for k in ("n", "raw_bytes", "wire_bytes", "compressed")})
        return out

    session.step = first_step
    return box


def outs_last(rec):
    """A tapped session's last-position step outputs, [steps, D] f32."""
    import torch

    return torch.cat([o[:, -1] for o in rec["outs"]]).float()


def settled(servers, timeout_s: float = 10.0) -> list[dict]:
    """Each server's page counts once its sessions' asynchronous teardown
    has released every referenced page (or the timeout passed)."""
    deadline = time.monotonic() + timeout_s
    while True:
        counts = [s.manager.table.counts() for s in servers]
        if all(c["referenced"] == 0 for c in counts) or \
                time.monotonic() > deadline:
            return counts
        time.sleep(0.05)


def phase_prefix(layers, spec, client, gen) -> dict:
    """Phase 7: the shared-prefix cache, session leases and standby
    replication served at full width on phase 4's weights: a port registry
    and port BlockServers over blocks [0, 16) and [16, 32) with the
    prefix cache on, 30 s leases, 1024-page arenas and `max_batch=1`;
    push sessions of the port client; launch counts reset and read around
    each run (paths "prefix", "lease", "repl").

    (f) prefix: A (992 tokens, 62 pages) runs first and publishes its
        pages; then B and C (A's first 960 tokens + 40 of their own: each
        adopts 60 pages and prefills 40 tokens on the chunk kernel) and D
        (A again: adopts 62 pages, trimmed to 991, its one-token suffix
        copies the shared last page and runs on the decode kernel), each
        16 greedy tokens. Each server: 3 hits of 960 + 960 + 991 tokens,
        a copy-on-write, no page referenced after close. Flash launches
        for A's prefill only (2 a layer), chunk launches = layers x 2,
        decode launches = layers x decode steps. B, C and D held
        teacher-forced against the solo executor prefilling each full
        prompt (`hold_teacher_forced`).
    (g) lease: E (1000 tokens) decodes 8 tokens, every span connection of
        the session is aborted, the client resumes and decodes 8 more:
        tokens identical to a fault-free run of E on the same servers,
        2 streams resumed, no decline, zero replay, one resume per server.
    (h) replication: two more servers (standbys, one per span) join; F
        (1000 tokens, `kv_repl_every=4`) decodes 64 tokens; once the
        standbys' installed pages stop growing (at most 10 s), the
        [16, 32) server of F's route stops; the client recovers onto the
        standbys and decodes 8 more. Both standbys installed pages, the
        replay is at most (4 + 1) x 16 tokens, and F's 72 positions are
        held teacher-forced over its whole history.

    Prints each session's time to first token and prefill wire bytes, the
    resume's and the kv_put sweeps' times, the kv_put count and bytes, the
    launch counts by kernel, and the card's name and power limit. Returns
    each run's launch counts by path."""
    import torch

    from bloombee_tpu_torch.client import DistributedModelForCausalLM
    from bloombee_tpu_torch.ops.cuda import build

    t_phase = time.perf_counter()
    n_layers, vocab = spec.num_hidden_layers, spec.vocab_size
    spans = ((0, n_layers // 2), (n_layers // 2, n_layers))

    def rand(n):
        return torch.randint(0, vocab, (n,), generator=gen, device="cuda")

    a = rand(992)
    b = torch.cat([a[:960], rand(40)])
    c = torch.cat([a[:960], rand(40)])
    e, f = rand(1000), rand(1000)
    local = DistributedModelForCausalLM(spec, client, None, device="cuda")
    uid = "llama3-8b-prefix"
    by_path, failures, report = {}, [], {}

    async def prefix_run(reg_port):
        model = port_client(client, spec, reg_port, uid, prefix_cache=True)
        out = {}
        try:
            for name, p in (("A", a), ("B", b), ("C", c), ("D", a)):
                async with model.inference_session(1100, 1) as session:
                    rec = tap(session, model)
                    wire = prefill_wire(session)
                    ids = await model.generate(p[None], max_new_tokens=16,
                                               session=session)
                out[name] = {
                    "tokens": ids[0, -16:].cpu(), "lasts": outs_last(rec),
                    "ttft_ms": (rec["embeds"][1] - rec["embeds"][0]) * 1e3,
                    "prefill_wire": wire,
                }
        finally:
            await model.manager.registry.close()
        return out

    async def lease_run(reg_port):
        model = port_client(client, spec, reg_port, uid, prefix_cache=False)
        try:
            async with model.inference_session(1100, 1) as session:
                plain = await model.generate(e[None], max_new_tokens=16,
                                             session=session)
            async with model.inference_session(1100, 1) as session:
                def abort_at_9(n):
                    # the 9th embed: 8 tokens chosen, the next step fails
                    if n == 9:
                        for sp in session._spans:
                            sp.conn.abort("chip_smoke: injected failure")

                tap(session, model, abort_at_9)
                resume, resume_ms = session._try_resume, []

                async def timed_resume():
                    t0 = time.perf_counter()
                    ok = await resume()
                    resume_ms.append((time.perf_counter() - t0) * 1e3)
                    return ok

                session._try_resume = timed_resume
                ids = await model.generate(e[None], max_new_tokens=16,
                                           session=session)
                counters = {k: getattr(session, k) for k in (
                    "resumed_streams", "resume_declines",
                    "failover_replayed_tokens")}
        finally:
            await model.manager.registry.close()
        return plain[0, -16:].cpu(), ids[0, -16:].cpu(), counters, resume_ms

    async def repl_run(reg_port, servers, stop_on_server_loop):
        model = port_client(client, spec, reg_port, uid, prefix_cache=True,
                            kv_repl_every=4, ban_timeout=0.5, ban_max=2.0)
        by_id = {s.server_id: s for s in servers}
        try:
            async with model.inference_session(1100, 1) as session:
                rec = tap(session, model)
                primaries = [by_id[s.span.peer_id] for s in session._spans]
                standbys = [by_id[r["peer"]] for r in session._repl]
                ids = await model.generate(f[None], max_new_tokens=64,
                                           session=session)
                t0, last, stable_since = time.perf_counter(), None, None
                while time.perf_counter() - t0 < 10.0:
                    now = [s.manager.repl_pages_installed for s in standbys]
                    if now != last:
                        last, stable_since = now, time.perf_counter()
                    elif min(now) > 0 and \
                            time.perf_counter() - stable_since >= 1.0:
                        break
                    await asyncio.sleep(0.1)
                wait_s = time.perf_counter() - t0
                sent = [p.repl_pages_sent for p in primaries]
                await asyncio.wrap_future(stop_on_server_loop(primaries[1]))
                more = await model.generate(ids[:, -1:], max_new_tokens=8,
                                            session=session)
                counters = {k: getattr(session, k) for k in (
                    "resumed_streams", "resume_declines",
                    "failover_replayed_tokens")}
                route_after = [s.span.peer_id for s in session._spans]
        finally:
            await model.manager.registry.close()
        tokens = torch.cat([ids[0, -64:], more[0, -8:]]).cpu()
        return {
            "tokens": tokens, "lasts": outs_last(rec), "counters": counters,
            "installed": [s.manager.repl_pages_installed for s in standbys],
            "sent": sent, "wait_s": wait_s, "primaries": primaries,
            "standbys": standbys,
            "route_after_is_standbys": [
                pid == s.server_id for pid, s in zip(route_after, standbys)
            ],
        }

    def reference(prompts, feeds, n_new, layers32):
        return [
            served_reference(ls, spec, local, prompts, None, n_new,
                             feed=feeds, dtype=dt)[0]
            for ls, dt in ((layers, None), (layers32, torch.float32))
        ]

    with ReplayWatch() as watch, ServerLoop() as servers_loop:
        reg, servers = servers_loop.run(start_span_servers(
            layers, spec, uid, spans, torch.bfloat16, 1024,
            **PREFIX_SERVER_KW
        ))
        stopped = []
        try:
            # (f) prefix
            torch.cuda.synchronize()
            build.reset_launch_counts()
            pf = asyncio.run(prefix_run(reg.port))
            torch.cuda.synchronize()
            launches = by_path["prefix"] = dict(build.LAUNCHES)
            counts_f = settled(servers)
            infos = [servers_loop.run(s._rpc_info({}, []))[0]
                     for s in servers]
            hits = [(i["prefix_hits"], i["prefix_hit_tokens"],
                     i["cow_copies"]) for i in infos]
            # decode steps: 15 each for A, B and C; D's one-token suffix
            # and its 15
            want = {
                "flash_attention": 2 * n_layers,
                "paged_chunk_attention": 2 * n_layers,
                "paged_decode_attention": (15 * 3 + 16) * n_layers,
            }
            report["prefix"] = {
                "ttft_ms": {k: v["ttft_ms"] for k, v in pf.items()},
                "prefill_wire": {k: v["prefill_wire"] for k, v in pf.items()},
                "hits_hit_tokens_cow": hits, "counts_after_close": counts_f,
                "launches": launches, "launches_want": want,
            }
            for name, n in want.items():
                if launches.get(name, 0) != n:
                    failures.append(f"prefix: {launches.get(name, 0)} "
                                    f"{name} launches, want {n}")
            if any(h[:2] != (3, 960 + 960 + 991) or h[2] < 1 for h in hits):
                failures.append(f"prefix: hits/tokens/copies {hits}")
            if any(c["referenced"] for c in counts_f):
                failures.append(f"prefix: pages referenced after close "
                                f"{counts_f}")
            # (g) lease
            torch.cuda.synchronize()
            build.reset_launch_counts()
            plain, resumed, lease_c, resume_ms = asyncio.run(
                lease_run(reg.port)
            )
            torch.cuda.synchronize()
            by_path["lease"] = dict(build.LAUNCHES)
            resumed_srv = [s.sessions_resumed for s in servers]
            report["lease"] = {
                "tokens_identical": torch.equal(plain, resumed),
                "client": lease_c, "resume_ms": resume_ms,
                "sessions_resumed": resumed_srv,
                "launches": by_path["lease"],
            }
            if not torch.equal(plain, resumed):
                failures.append(f"lease: tokens {resumed.tolist()} != "
                                f"fault-free {plain.tolist()}")
            if lease_c != {"resumed_streams": 2, "resume_declines": 0,
                           "failover_replayed_tokens": 0} or \
                    resumed_srv != [1, 1]:
                failures.append(f"lease: {lease_c}, servers resumed "
                                f"{resumed_srv}")
            # (h) replication: two standbys join the same registry
            _, more = servers_loop.run(start_span_servers(
                layers, spec, uid, spans, torch.bfloat16, 1024, reg=reg,
                **PREFIX_SERVER_KW
            ))
            servers += more
            puts = {"n": 0, "pages": 0, "bytes": 0, "ms": []}
            sweeps_ms = []
            for s in servers:
                put, sweep = s._kv_put, s._replicate_pass

                async def timed_put(meta, tensors, put=put):
                    t0 = time.perf_counter()
                    out = await put(meta, tensors)
                    puts["ms"].append((time.perf_counter() - t0) * 1e3)
                    puts["n"] += 1
                    puts["pages"] += len(meta.get("hashes") or [])
                    puts["bytes"] += sum(t.numel() * t.element_size()
                                         for t in tensors)
                    return out

                async def timed_sweep(session, sweep=sweep):
                    t0 = time.perf_counter()
                    progress = await sweep(session)
                    if progress:
                        sweeps_ms.append((time.perf_counter() - t0) * 1e3)
                    return progress

                s._kv_put, s._replicate_pass = timed_put, timed_sweep
                s.rpc.unary_handlers["kv_put"] = timed_put
            torch.cuda.synchronize()
            build.reset_launch_counts()
            hr = asyncio.run(repl_run(
                reg.port, servers,
                lambda s: asyncio.run_coroutine_threadsafe(
                    s.stop(), servers_loop.loop
                ),
            ))
            torch.cuda.synchronize()
            by_path["repl"] = dict(build.LAUNCHES)
            stopped.append(hr["primaries"][1])
            replayed = hr["counters"]["failover_replayed_tokens"]
            report["repl"] = {
                "client": hr["counters"], "installed": hr["installed"],
                "primaries_sent": hr["sent"], "wait_s": hr["wait_s"],
                "route_after_is_standbys": hr["route_after_is_standbys"],
                "kv_put": {"n": puts["n"], "pages": puts["pages"],
                           "bytes": puts["bytes"],
                           "ms_median": sorted(puts["ms"])[
                               len(puts["ms"]) // 2] if puts["ms"] else None},
                "sweep_ms": sweeps_ms, "launches": by_path["repl"],
            }
            if not all(n > 0 for n in hr["installed"]):
                failures.append(f"repl: standbys installed {hr['installed']}")
            if not 0 < replayed <= (4 + 1) * PS:
                failures.append(f"repl: {replayed} tokens replayed, want 1.."
                                f"{(4 + 1) * PS}")
        finally:
            servers_loop.run(stop_span_servers(
                reg, [s for s in servers if s not in stopped]
            ))
            for s in stopped:
                servers_loop.run(s.registry.close())
            del servers
    torch.cuda.empty_cache()
    # teacher-forced: B, C and D, then F's whole history
    torch.backends.cuda.matmul.allow_tf32 = False
    layers32 = [{k: v.float() for k, v in layer.items()} for layer in layers]
    names = ("B", "C", "D")
    ref, truth = reference([b, c, a], [pf[k]["tokens"] for k in names], 16,
                           layers32)
    held_f = hold_teacher_forced(local, [pf[k]["lasts"] for k in names],
                                 [pf[k]["tokens"] for k in names], ref, truth)
    ref, truth = reference([f], [hr["tokens"]], 72, layers32)
    held_h = hold_teacher_forced(local, [hr["lasts"]], [hr["tokens"]], ref,
                                 truth)
    del layers32
    torch.cuda.empty_cache()
    report["prefix"]["held"] = held_f
    report["repl"]["held"] = held_h
    if not held_f["ok"]:
        failures.append("prefix: differs from the solo executor")
    if not held_h["ok"] or hr["lasts"].shape[0] != 72:
        failures.append("repl: differs from the solo executor")
    if watch.seen:
        failures.append(f"group replays {watch.seen}")
    ttft = report["prefix"]["ttft_ms"]
    say(f"[prefix] (f) Llama-3-8B bf16 over {[list(s) for s in spans]}, "
        f"time to first token A {ttft['A']:.1f} ms, B {ttft['B']:.1f}, C "
        f"{ttft['C']:.1f}, D {ttft['D']:.1f}; prefill wire bytes (all "
        f"hops) {({k: v['wire_bytes'] for k, v in report['prefix']['prefill_wire'].items()})}; "
        f"hits/tokens/copies per server {hits}; launches {by_path['prefix']}"
        f" (wanted {want}); held against the solo executor: {held_f}")
    say(f"[lease] (g) resume after aborting both connections: tokens "
        f"identical {report['lease']['tokens_identical']}, {lease_c}, "
        f"resume {[round(x, 2) for x in resume_ms]} ms, servers resumed "
        f"{resumed_srv}; launches {by_path['lease']}")
    say(f"[repl] (h) kv_repl_every=4: standbys installed {hr['installed']} "
        f"pages (primaries sent {hr['sent']}, settled in "
        f"{hr['wait_s']:.2f} s); kv_put {report['repl']['kv_put']}; sweeps "
        f"{[round(x, 1) for x in sweeps_ms]} ms; after the [16, 32) "
        f"primary stopped: {hr['counters']}, route on standbys "
        f"{hr['route_after_is_standbys']}; launches {by_path['repl']}; "
        f"held against the solo executor over 72 positions: {held_h}")
    say("[prefix] " + json.dumps(report, default=str))
    say(f"[prefix] phase 7 took {time.perf_counter() - t_phase:.1f} s")
    say(card_line())
    if failures:
        raise AssertionError("prefix/lease/repl runs failed: "
                             + "; ".join(failures))
    return by_path


# ------------------------------------------------------------- phase 8
DN_RUNS = (
    # (path, label, spans, server keyword arguments, sessions, new tokens)
    ("decode_n_fused", "(i) fused", ((0, 32),), {}, 1, 64),
    ("decode_n_chained", "(ii) chained", ((0, 16), (16, 32)), {}, 4, 32),
    ("decode_n_int4", "(iii) stepped, int4 arena", ((0, 32),),
     {"kv_quant": "int4"}, 1, 32),
    # (i)'s work through the stepped loop: what the fused loop saves
    ("decode_n_stepped", "(iv) stepped, bf16 arena (fused loop off)",
     ((0, 32),), {"decode_n_fused": False}, 1, 64),
)


async def dn_generate(model, session, prompt, n_new, server_decode) -> dict:
    """One `generate` of n_new greedy tokens from `prompt` [L] on an open
    session, per step or with server-side decode: the tokens, the time to
    the prefill step's reply (time to first token), the mean time of each
    later token, and what the session recorded (reply metas, timings)."""
    import torch

    rec = tap(session, model)
    step, marks = session.step, []

    async def timed_step(*args, **kwargs):
        out = await step(*args, **kwargs)
        marks.append(time.perf_counter())
        return out

    session.step = timed_step
    t0 = time.perf_counter()
    ids = await model.generate(prompt[None], max_new_tokens=n_new,
                               session=session, server_decode=server_decode)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    return {
        "tokens": ids[0, -n_new:].cpu(),
        "ttft_ms": (marks[0] - t0) * 1e3,
        "per_token_ms": (t1 - marks[0]) * 1e3 / (n_new - 1),
        "metas": rec["metas"],
        "timings": list(session.timings),
    }


def dn_run(layers, spec, client, prompts, spans, server_kw, n_new) -> dict:
    """A port registry and port BlockServers over `spans` (the client's
    parameters given, `max_batch=1`) on a ServerLoop; the port client's
    sessions (one per prompt, concurrent) generate n_new tokens per step,
    then on fresh sessions with `server_decode=True` (chunk 32). Launch
    counts and the servers' decode_n counters are read around each mode."""
    import torch

    from bloombee_tpu_torch.ops.cuda import build

    uid = f"llama3-8b-dn-{len(spans)}-{server_kw.get('kv_quant', 'bf16')}"

    async def drive(reg_port, servers):
        models = [port_client(client, spec, reg_port, uid,
                              server_decode_chunk=32) for _ in prompts]
        out = {}
        try:
            for mode, sd in (("per_step", False), ("server_decode", True)):
                async with contextlib.AsyncExitStack() as stack:
                    sessions = [
                        await stack.enter_async_context(
                            m.inference_session(1100, 1)
                        )
                        for m in models
                    ]
                    torch.cuda.synchronize()
                    steps0 = [s.decode_n_steps for s in servers]
                    calls0 = [s.decode_n_calls for s in servers]
                    fused0 = [s.decode_n_fused_calls for s in servers]
                    build.reset_launch_counts()
                    runs = await asyncio.gather(*(
                        dn_generate(m, s, p, n_new, sd)
                        for m, s, p in zip(models, sessions, prompts)
                    ))
                    torch.cuda.synchronize()
                    out[mode] = {
                        "runs": runs,
                        "launches": dict(build.LAUNCHES),
                        "steps": [s.decode_n_steps - k
                                  for s, k in zip(servers, steps0)],
                        "calls": [s.decode_n_calls - k
                                  for s, k in zip(servers, calls0)],
                        "fused_calls": [s.decode_n_fused_calls - k
                                        for s, k in zip(servers, fused0)],
                    }
        finally:
            for m in models:
                await m.manager.registry.close()
        return out

    with ReplayWatch() as watch, ServerLoop() as servers_loop:
        reg, servers = servers_loop.run(start_span_servers(
            layers, spec, uid, spans, torch.bfloat16, 1024,
            client_params=client, max_batch=1, **server_kw
        ))
        try:
            out = asyncio.run(drive(reg.port, servers))
            out["server_layers"] = [s.end_block - s.start_block
                                    for s in servers]
        finally:
            servers_loop.run(stop_span_servers(reg, servers))
            del servers
    out["replays"] = list(watch.seen)
    torch.cuda.empty_cache()
    return out


def dn_numbers(mode: dict) -> dict:
    """Medians over a mode's sessions (ms): time to first token, per-token
    time, the replies' t_dispatch_ms (per step; per token of a decode_n
    reply), and for decode_n each RPC's round trip and its time per
    token."""
    def med(xs):
        xs = sorted(xs)
        return round(xs[len(xs) // 2], 3) if xs else None

    runs = mode["runs"]
    dispatch, rpc, rpc_tok = [], [], []
    for r in runs:
        for k, meta in r["metas"]:
            if meta.get("t_dispatch_ms") is None:
                continue
            n = 1
            for t in r["timings"]:
                if t.get("decode_n") and t["step"] == meta.get("step"):
                    n = t["tokens"]
            dispatch.append(meta["t_dispatch_ms"] / n)
        for t in r["timings"]:
            if t.get("decode_n"):
                rpc.append(t["total_ms"])
                rpc_tok.append(t["total_ms"] / t["tokens"])
    return {
        "ttft_ms": med([r["ttft_ms"] for r in runs]),
        "per_token_ms": med([r["per_token_ms"] for r in runs]),
        "t_dispatch_ms_per_token": med(dispatch),
        "decode_n_rpcs": len(rpc),
        "decode_n_rpc_ms": med(rpc),
        "decode_n_rpc_ms_per_token": med(rpc_tok),
    }


def phase_decode_n(layers, spec, client, gen) -> dict:
    """Phase 8: server-side multi-step decode served at full width on
    phase 4's weights, each run on its own registry and port BlockServers
    given the client's parameters, `max_batch=1` (so a per-step run and a
    decode_n run are comparable step for step), 1024-page arenas, push
    sessions of the port client with 1000-token prompts:

    (i) fused: one server over [0, 32), one session, 64 tokens;
    (ii) chained: servers over [0, 16) and [16, 32), four sessions, 32
         tokens each;
    (iii) stepped: one [0, 32) server over an int4 arena, one session, 32
         tokens;
    (iv) (i) with the fused loop switched off (`decode_n_fused=False`):
         the same calls through the stepped loop, over the same dense
         arena.

    Each session generates per step, then on a fresh session with
    `server_decode=True` (chunk 32): the tokens must be identical. Decode
    launches (paged decode, or int4 decode on the int4 arena) must equal
    each server's layers x the steps it ran (its `decode_n_steps` counter
    in the decode_n run; layers x sessions x (n - 1) per step), and every
    decode_n call of (i) must have taken the fused loop (the servers'
    `decode_n_fused_calls`), none of the others'. Prints the
    time to first token, per-token time, the replies' dispatch time per
    token and the decode_n round trips, beside phase 5's, and the card's
    name and power limit. Returns each run's launch counts by path."""
    import torch

    t_phase = time.perf_counter()
    prompts = torch.randint(0, spec.vocab_size, (4, 1000), generator=gen,
                            device="cuda")
    by_path, failures = {}, []
    for path, label, spans, server_kw, n_sess, n_new in DN_RUNS:
        run = dn_run(layers, spec, client, prompts[:n_sess], spans,
                     server_kw, n_new)
        kernel = ("paged_decode_attention_int4" if server_kw.get("kv_quant")
                  else "paged_decode_attention")
        ps, sd = run["per_step"], run["server_decode"]
        same = all(
            torch.equal(a["tokens"], b["tokens"])
            for a, b in zip(ps["runs"], sd["runs"])
        )
        used = all(any(t.get("decode_n") for t in r["timings"])
                   for r in sd["runs"])
        want_ps = spec.num_hidden_layers * n_sess * (n_new - 1)
        want_sd = sum(n * k for n, k in zip(run["server_layers"],
                                            sd["steps"]))
        stats = {
            "route": [list(s) for s in spans],
            "tokens_identical": same,
            "decode_n_used": used,
            "per_step": dn_numbers(ps),
            "server_decode": dn_numbers(sd),
            "decode_n_steps": sd["steps"],
            "decode_n_calls": sd["calls"],
            "decode_n_fused_calls": sd["fused_calls"],
            "launches": {"per_step": ps["launches"],
                         "server_decode": sd["launches"]},
            "decode_launches_want": {"per_step": want_ps,
                                     "server_decode": want_sd},
        }
        by_path[f"{path}_per_step"] = ps["launches"]
        by_path[path] = sd["launches"]
        say(f"[{path}] {label}: Llama-3-8B bf16 over {stats['route']}, "
            f"{n_sess} session(s) x {n_new} tokens from 1000; tokens "
            f"identical to per step: {same}; per step "
            f"{stats['per_step']}; server_decode {stats['server_decode']}; "
            f"decode_n steps per server {sd['steps']}; launches "
            f"{stats['launches']} (decode wanted "
            f"{stats['decode_launches_want']})")
        say(f"[{path}] " + json.dumps(stats))
        if not same:
            failures.append(f"{path}: tokens differ from the per-step run")
        if not used:
            failures.append(f"{path}: a session never ran decode_n")
        if any(k != n_sess * (n_new - 1) for k in sd["steps"]):
            failures.append(f"{path}: decode_n steps {sd['steps']}")
        want_fused = sd["calls"] if path == "decode_n_fused" else [
            0 for _ in sd["calls"]
        ]
        if sd["fused_calls"] != want_fused:
            failures.append(f"{path}: fused calls {sd['fused_calls']} of "
                            f"decode_n calls {sd['calls']}, want "
                            f"{want_fused}")
        if ps["launches"].get(kernel) != want_ps:
            failures.append(f"{path}: {ps['launches'].get(kernel)} {kernel} "
                            f"launches per step, want {want_ps}")
        if sd["launches"].get(kernel) != want_sd:
            failures.append(f"{path}: {sd['launches'].get(kernel)} {kernel} "
                            f"launches with decode_n, want {want_sd}")
        if not sd["launches"].get("flash_attention"):
            failures.append(f"{path}: the prefill never launched flash")
        if run["replays"]:
            failures.append(f"{path}: group replays {run['replays']}")
    say(f"[decode_n] phase took {time.perf_counter() - t_phase:.1f} s")
    say(card_line())
    if failures:
        raise AssertionError("decode_n runs failed: " + "; ".join(failures))
    return by_path


def dn_fused_vs_stepped(layers, spec, client, gen, rounds: int = 2) -> dict:
    """Phase 8's runs (i) and (iv) alone, in the order fused, stepped,
    stepped, fused (`rounds` times), so that neither loop always runs
    first on a host shared with other machines: one session over one
    [0, 32) server, 64 tokens from a 1000-token prompt per step, then with
    `server_decode=True`. Not part of the script's main path; run after
    `phase_build()` (README). Prints each run's numbers, then each loop's
    medians over its runs, and the card's name and power limit."""
    import torch

    prompt = torch.randint(0, spec.vocab_size, (1, 1000), generator=gen,
                           device="cuda")
    loops = {"fused": {}, "stepped": {"decode_n_fused": False}}
    order = ["fused", "stepped", "stepped", "fused"] * rounds
    seen = {name: [] for name in loops}
    for name in order:
        run = dn_run(layers, spec, client, prompt, ((0, 32),), loops[name],
                     64)
        ps, sd = run["per_step"], run["server_decode"]
        same = torch.equal(ps["runs"][0]["tokens"], sd["runs"][0]["tokens"])
        fused = sd["fused_calls"] == (sd["calls"] if name == "fused"
                                      else [0])
        if not (same and fused):
            raise AssertionError(f"{name}: tokens identical {same}, fused "
                                 f"calls {sd['fused_calls']} of {sd['calls']}")
        row = {"per_step": dn_numbers(ps), "server_decode": dn_numbers(sd)}
        seen[name].append(row)
        say(f"[dn_ab] {name} " + json.dumps(row))

    def med(xs):
        xs = sorted(xs)
        return round(xs[len(xs) // 2], 3)

    out = {
        name: {
            key: med([r["server_decode"][key] for r in rows])
            for key in ("per_token_ms", "t_dispatch_ms_per_token",
                        "decode_n_rpc_ms_per_token")
        }
        for name, rows in seen.items()
    }
    say("[dn_ab] medians " + json.dumps(out))
    say(card_line())
    return out


# ------------------------------------------------------------- phase 9
CLI_LAYERS = 8


# the family extras of a layer: the port's key -> its HF suffix
HF_EXTRA_KEYS = {
    "q_bias": "self_attn.q_proj.bias", "k_bias": "self_attn.k_proj.bias",
    "v_bias": "self_attn.v_proj.bias", "q_norm": "self_attn.q_norm.weight",
    "k_norm": "self_attn.k_norm.weight",
}


def llama_layer_tensors(layer: dict, i: int, spec) -> dict:
    """A port layer under HF's Llama names (`model.layers.{i}.*`, matrices
    transposed to [out, in]) with the family's extras (`HF_EXTRA_KEYS`)
    and, for an MoE spec, its router and each expert's matrices under the
    family's names (`Family.moe_keys`)."""
    from bloombee_tpu_torch.models.auto import get_family
    from bloombee_tpu_torch.models.llama.block import (
        HF_ATTENTION_KEYS,
        HF_BLOCK_KEYS,
    )

    p = f"model.layers.{i}"
    keys = HF_ATTENTION_KEYS if spec.num_experts else HF_BLOCK_KEYS
    out = {
        f"{p}.{key}": layer[name].t() if transpose else layer[name]
        for key, (name, transpose) in keys.items()
    }
    if spec.num_experts:
        router, experts, names = get_family(spec.family).moe_keys
        out[f"{p}.{router}.weight"] = layer["router"].t()
        for e in range(spec.num_experts):
            for key, name in zip(("experts_gate", "experts_up",
                                  "experts_down"), names):
                out[f"{p}.{experts}.{e}.{name}.weight"] = layer[key][e].t()
    out.update({f"{p}.{key}": layer[name]
                for name, key in HF_EXTRA_KEYS.items() if name in layer})
    return out


def llama_head_tensors(gen, spec) -> dict:
    """Llama's embeddings (N(0, 1)) and unit final norm."""
    import torch

    d = spec.hidden_size
    return {
        "model.embed_tokens.weight": torch.randn(
            (spec.vocab_size, d), generator=gen, device="cuda"
        ).to(torch.bfloat16),
        "model.norm.weight": torch.ones((d,), dtype=torch.bfloat16,
                                        device="cuda"),
    }


def bloom_layer_tensors(layer: dict, i: int, spec) -> dict:
    """A port Bloom layer under the hub's BLOOM names (`h.{i}.*`, no
    `transformer.` prefix): the q/k/v projections fused into
    `self_attention.query_key_value` with its rows per head as [q, k, v]
    (and its bias so), every other matrix transposed to [out, in]."""
    import torch

    p = f"h.{i}"
    d, n_head = spec.hidden_size, spec.num_attention_heads
    hd = layer["q_proj"].shape[1] // n_head
    out = {}
    for ln in ("input_layernorm", "post_attention_layernorm"):
        out[f"{p}.{ln}.weight"] = layer[ln]
        out[f"{p}.{ln}.bias"] = layer[f"{ln}_bias"]
    qkv = [layer[f"{x}_proj"].t().reshape(n_head, hd, d) for x in "qkv"]
    out[f"{p}.self_attention.query_key_value.weight"] = torch.stack(
        qkv, dim=1).reshape(3 * n_head * hd, d)
    out[f"{p}.self_attention.query_key_value.bias"] = torch.stack(
        [layer[f"{x}_bias"].reshape(n_head, hd) for x in "qkv"], dim=1
    ).reshape(-1)
    for key, hf in (("o", "self_attention.dense"),
                    ("up", "mlp.dense_h_to_4h"),
                    ("down", "mlp.dense_4h_to_h")):
        out[f"{p}.{hf}.weight"] = layer[f"{key}_proj"].t()
        out[f"{p}.{hf}.bias"] = layer[f"{key}_bias"]
    return out


def bloom_head_tensors(gen, spec) -> dict:
    """BLOOM's `word_embeddings` (N(0, 1/D), tied to the head), its
    LayerNorm and `ln_f`, unit weights and biases of standard deviation
    0.1."""
    import torch

    d = spec.hidden_size
    head = {"word_embeddings.weight": (torch.randn(
        (spec.vocab_size, d), generator=gen, device="cuda"
    ) * d**-0.5).to(torch.bfloat16)}
    for norm in ("word_embeddings_layernorm", "ln_f"):
        head[f"{norm}.weight"] = torch.ones((d,), dtype=torch.bfloat16,
                                            device="cuda")
        head[f"{norm}.bias"] = (torch.randn(
            (d,), generator=gen, device="cuda") * 0.1).to(torch.bfloat16)
    return head


def falcon_layer_tensors(layer: dict, i: int, spec) -> dict:
    """A port Falcon layer under HF's `FalconForCausalLM` names
    (`transformer.h.{i}.*`): the q/k/v projections fused into
    `self_attention.query_key_value`, for the new decoder architecture
    with its rows grouped per KV head as [n_rep q | 1 k | 1 v] (else [H q
    | Hkv k | Hkv v]), `ln_attn` / `ln_mlp` for two LayerNorms (else
    `input_layernorm`), every matrix transposed to [out, in]."""
    import torch

    p = f"transformer.h.{i}"
    d, hd = spec.hidden_size, spec.head_dim
    hkv = spec.num_key_value_heads
    q, k, v = (layer[f"{x}_proj"].t() for x in "qkv")
    if spec.num_ln_in_parallel_attn == 2:
        norms = {"ln_attn": "input_layernorm", "ln_mlp": "mlp_layernorm"}
        qkv = torch.cat([q.reshape(hkv, -1, hd, d),
                         k.reshape(hkv, 1, hd, d),
                         v.reshape(hkv, 1, hd, d)], dim=1).reshape(-1, d)
    else:
        norms = {"input_layernorm": "input_layernorm"}
        qkv = torch.cat([q, k, v])
    out = {f"{p}.self_attention.query_key_value.weight": qkv}
    for hf, key in norms.items():
        out[f"{p}.{hf}.weight"] = layer[key]
        out[f"{p}.{hf}.bias"] = layer[f"{key}_bias"]
    for key, hf in (("o", "self_attention.dense"),
                    ("up", "mlp.dense_h_to_4h"),
                    ("down", "mlp.dense_4h_to_h")):
        out[f"{p}.{hf}.weight"] = layer[f"{key}_proj"].t()
    return out


def falcon_head_tensors(gen, spec) -> dict:
    """Falcon's `transformer.word_embeddings` (N(0, 1/D), tied to the
    head) and `transformer.ln_f`, a unit weight and a bias of standard
    deviation 0.1."""
    import torch

    d = spec.hidden_size
    return {
        "transformer.word_embeddings.weight": (torch.randn(
            (spec.vocab_size, d), generator=gen, device="cuda"
        ) * d**-0.5).to(torch.bfloat16),
        "transformer.ln_f.weight": torch.ones(
            (d,), dtype=torch.bfloat16, device="cuda"),
        "transformer.ln_f.bias": (torch.randn(
            (d,), generator=gen, device="cuda") * 0.1).to(torch.bfloat16),
    }


# a family's HF checkpoint layout, (layer tensors, head tensors), by
# model_type; a family not listed is written in Llama's
CHECKPOINT_LAYOUTS = {
    "bloom": (bloom_layer_tensors, bloom_head_tensors),
    "falcon": (falcon_layer_tensors, falcon_head_tensors),
}


def write_checkpoint(path: pathlib.Path, spec, seed: int,
                     config: dict | None = None) -> None:
    """A random checkpoint at `spec`'s width and depth in the family's HF
    layout (`CHECKPOINT_LAYOUTS`: config.json, one safetensors file per
    layer plus one for the embeddings, final norm and head, an index),
    written a layer at a time. `config` is the config.json to write
    (default: a Llama one from `spec`); the layers carry the family's
    extras (`init_block_params`), and a tied spec writes no lm_head."""
    import torch
    from safetensors.torch import save_file

    from bloombee_tpu_torch.models.llama.block import init_block_params

    gen = torch.Generator(device="cuda").manual_seed(seed)
    d, vocab = spec.hidden_size, spec.vocab_size
    config = config or {
        "model_type": "llama", "architectures": ["LlamaForCausalLM"],
        "hidden_size": d, "intermediate_size": spec.intermediate_size,
        "num_attention_heads": spec.num_attention_heads,
        "num_key_value_heads": spec.num_key_value_heads,
        "head_dim": spec.head_dim,
        "num_hidden_layers": spec.num_hidden_layers, "vocab_size": vocab,
        "rms_norm_eps": spec.rms_norm_eps, "rope_theta": spec.rope_theta,
        "max_position_embeddings": 8192, "tie_word_embeddings": False,
        "torch_dtype": "bfloat16",
    }
    (path / "config.json").write_text(json.dumps(config))
    weight_map = {}
    layer_tensors, head_tensors = CHECKPOINT_LAYOUTS.get(
        spec.family, (llama_layer_tensors, llama_head_tensors))

    def save(tensors: dict, name: str) -> None:
        save_file({k: v.contiguous().cpu() for k, v in tensors.items()},
                  str(path / name))
        weight_map.update({k: name for k in tensors})

    for i in range(spec.num_hidden_layers):
        layer = init_block_params(gen, spec, dtype=torch.bfloat16,
                                  device="cuda")
        save(layer_tensors(layer, i, spec), f"layer-{i:02d}.safetensors")
        del layer
    head = head_tensors(gen, spec)
    if not spec.tie_word_embeddings:
        head["lm_head.weight"] = (
            torch.randn((vocab, d), generator=gen, device="cuda") * d**-0.5
        ).to(torch.bfloat16)
    save(head, "head.safetensors")
    (path / "model.safetensors.index.json").write_text(
        json.dumps({"metadata": {}, "weight_map": weight_map})
    )


def cli_spawn(args: list[str], log: pathlib.Path, home: pathlib.Path):
    """A `python -m bloombee_tpu_torch.cli.*` process from the repo root,
    logging to `log`, with `home` as its HOME (the throughput cache)."""
    import os

    proc = subprocess.Popen(
        [sys.executable, "-m", *args], cwd=REPO,
        stdout=open(log, "w"), stderr=subprocess.STDOUT,
        env={**os.environ, "HOME": str(home)},
    )
    proc.log = log
    return proc


def cli_logs(procs) -> str:
    return "\n".join(f"--- {p.log.name} ---\n" + p.log.read_text()[-3000:]
                     for p in procs)


def phase_cli(gen) -> dict:
    """Phase 9: each span in its own process, started through the CLI. A
    random checkpoint at Llama-3-8B width with 8 layers (~5.6 GB with the
    128256-token embeddings and head) is written to a temporary
    directory; `python -m bloombee_tpu_torch.cli.run_registry` and two
    `...cli.run_server` processes (`--blocks 0:4` and `4:8`, `--device
    cuda --warmup-batches 1 --drain-timeout 5`) serve it. A port client in
    this process generates 32 tokens from a 1000-token prompt per step,
    then with `server_decode=True` (chained): both runs' tokens must equal
    each other and an in-process solo SpanExecutor's with the client's
    head over the same checkpoint. The servers' own launch counts
    (`rpc_info` `kernel_launches`) must show flash and paged decode;
    `cli.health --probe` must list both spans ONLINE; SIGTERM must stop
    each server with exit code 0 within its drain timeout + 10 s. Prints
    the time to first token and per-token time of both runs and the
    card's name and power limit; returns the servers' launches by path
    ("cli")."""
    import shutil
    import socket
    import tempfile

    import torch

    from bloombee_tpu_torch.client import (
        ClientConfig,
        DistributedModelForCausalLM,
    )
    from bloombee_tpu_torch.models.checkpoint import (
        load_client_params,
        load_span_params,
    )
    from bloombee_tpu_torch.swarm.registry import RegistryClient
    from bloombee_tpu_torch.wire.rpc import connect

    t_phase = time.perf_counter()
    spec = llama3_8b(CLI_LAYERS)
    uid, n_new, drain_s = "llama3-8b-cli", 32, 5
    tmp = pathlib.Path(tempfile.mkdtemp(prefix="bbtpu-cli-"))
    model_dir = tmp / "model"
    model_dir.mkdir()
    procs, failures, stats = [], [], {}
    try:
        t0 = time.perf_counter()
        write_checkpoint(model_dir, spec, seed=23)
        stats["checkpoint_write_s"] = round(time.perf_counter() - t0, 2)
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            reg_port = s.getsockname()[1]
        registry = f"127.0.0.1:{reg_port}"
        procs.append(cli_spawn(
            ["bloombee_tpu_torch.cli.run_registry", "--host", "127.0.0.1",
             "--port", str(reg_port)], tmp / "registry.log", tmp,
        ))
        # a server announces at start: the registry must listen first
        t0 = time.perf_counter()
        while True:
            try:
                socket.create_connection(("127.0.0.1", reg_port), 1).close()
                break
            except OSError:
                if procs[0].poll() is not None or (
                    time.perf_counter() - t0 > 60
                ):
                    raise AssertionError("the CLI registry never came up\n"
                                         + cli_logs(procs))
                time.sleep(0.1)
        t0 = time.perf_counter()
        servers = [
            cli_spawn(
                ["bloombee_tpu_torch.cli.run_server", str(model_dir),
                 "--model-uid", uid, "--registry", registry, "--blocks",
                 blocks, "--host", "127.0.0.1", "--device", "cuda",
                 "--warmup-batches", "1", "--drain-timeout", str(drain_s)],
                tmp / f"server-{blocks.replace(':', '-')}.log", tmp,
            )
            for blocks in (f"0:{CLI_LAYERS // 2}",
                           f"{CLI_LAYERS // 2}:{CLI_LAYERS}")
        ]
        procs += servers

        async def swarm_up():
            reader = RegistryClient("127.0.0.1", reg_port)
            try:
                while time.perf_counter() - t0 < 300:
                    if any(p.poll() is not None for p in procs):
                        raise AssertionError(
                            "a CLI process exited\n" + cli_logs(procs)
                        )
                    try:
                        infos = await reader.get_module_infos(
                            uid, range(CLI_LAYERS)
                        )
                        if all(i.servers for i in infos):
                            return {
                                sid: (i.host, i.port)
                                for m in infos
                                for sid, i in m.servers.items()
                            }
                    except OSError:
                        pass  # the registry is still starting
                    await asyncio.sleep(0.5)
                raise AssertionError("the CLI swarm never came up\n"
                                     + cli_logs(procs))
            finally:
                await reader.close()

        async def launches(addrs):
            out = {}
            for host, port in addrs:
                conn = await connect(host, port)
                try:
                    info, _ = await conn.call("rpc_info", {})
                finally:
                    await conn.close()
                for k, v in info["kernel_launches"].items():
                    out[k] = out.get(k, 0) + v
            return out

        addrs = sorted(asyncio.run(swarm_up()).values())
        stats["swarm_up_s"] = round(time.perf_counter() - t0, 2)
        prompt = torch.randint(0, spec.vocab_size, (1000,), generator=gen,
                               device="cuda")

        async def clients():
            rc = RegistryClient("127.0.0.1", reg_port)
            model = DistributedModelForCausalLM.from_pretrained(
                str(model_dir), rc, model_uid=uid, device="cuda",
                config=ClientConfig(server_decode_chunk=32),
            )
            try:
                before = await launches(addrs)
                runs = {}
                for mode, sd in (("per_step", False),
                                 ("server_decode", True)):
                    async with model.inference_session(1100, 1) as session:
                        runs[mode] = await dn_generate(
                            model, session, prompt, n_new, sd
                        )
                after = await launches(addrs)
                return runs, before, after
            finally:
                await rc.close()

        runs, before, after = asyncio.run(clients())
        ps, sd = runs["per_step"], runs["server_decode"]
        cli_launches = {k: after[k] - before.get(k, 0) for k in after}

        layers8, _ = load_span_params(str(model_dir), 0, CLI_LAYERS,
                                      dtype=torch.bfloat16, device="cuda")
        local = DistributedModelForCausalLM(
            spec, load_client_params(str(model_dir), device="cuda"), None,
            device="cuda",
        )
        ref = served_reference(layers8, spec, local, prompt[None], None,
                               n_new)[0][0][1]
        del layers8, local
        torch.cuda.empty_cache()

        health = subprocess.run(
            [sys.executable, "-m", "bloombee_tpu_torch.cli.health", uid,
             "--num-blocks", str(CLI_LAYERS), "--registry", registry,
             "--probe"],
            capture_output=True, text=True, timeout=60, cwd=REPO,
        )
        span_lines = [ln for ln in health.stdout.splitlines()
                      if " blocks [" in ln]
        health_ok = (health.returncode == 0
                     and "COMPLETE" in health.stdout
                     and len(span_lines) == 2
                     and all("ONLINE" in ln for ln in span_lines))

        exits = []
        for p in servers:
            t0 = time.perf_counter()
            p.send_signal(signal.SIGTERM)
            try:
                rc = p.wait(timeout=drain_s + 10)
            except subprocess.TimeoutExpired:
                rc = None
            exits.append((rc, round(time.perf_counter() - t0, 2)))

        want_decode = spec.num_hidden_layers * 2 * (n_new - 1)
        stats.update({
            "per_step": dn_numbers({"runs": [ps]}),
            "server_decode": dn_numbers({"runs": [sd]}),
            "tokens_identical": torch.equal(ps["tokens"], sd["tokens"]),
            "tokens_equal_solo_executor": torch.equal(ps["tokens"],
                                                      ref.cpu()),
            "servers_launches": cli_launches,
            "decode_launches_want": want_decode,
            "health_ok": health_ok,
            "sigterm_exits": exits,
        })
        say(f"[cli] Llama-3-8B width, {CLI_LAYERS} layers, two CLI server "
            f"processes {addrs} + a CLI registry; 32 tokens from 1000 per "
            f"step and with server_decode: {json.dumps(stats)}")
        say("[cli] health --probe:\n" + health.stdout.rstrip())
        if not stats["tokens_identical"]:
            failures.append("server_decode tokens differ from per step")
        if not stats["tokens_equal_solo_executor"]:
            failures.append("served tokens differ from the solo executor")
        if cli_launches.get("paged_decode_attention") != want_decode:
            failures.append(
                f"{cli_launches.get('paged_decode_attention')} paged decode "
                f"launches in the servers, want {want_decode}"
            )
        if not cli_launches.get("flash_attention"):
            failures.append("the servers never launched flash")
        if not health_ok:
            failures.append("health --probe: " + health.stdout
                            + health.stderr)
        if any(rc != 0 for rc, _ in exits):
            failures.append(f"SIGTERM exits {exits}\n" + cli_logs(servers))
    finally:
        for p in procs:
            if p.poll() is None:
                p.terminate()
        for p in procs:
            try:
                p.wait(timeout=15)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
        shutil.rmtree(tmp, ignore_errors=True)
    say(f"[cli] phase took {time.perf_counter() - t_phase:.1f} s")
    say(card_line())
    if failures:
        raise AssertionError("CLI run failed: " + "; ".join(failures))
    return {"cli": cli_launches}


# ------------------------------------------------------------- phase 10
# published HF configs (each model's config.json on the hub), the fields
# the port's registry reads; random weights, depth cut per run
FAMILY_CONFIGS = {
    "qwen3-8b": {  # Qwen/Qwen3-8B
        "model_type": "qwen3", "architectures": ["Qwen3ForCausalLM"],
        "hidden_size": 4096, "intermediate_size": 12288,
        "num_attention_heads": 32, "num_key_value_heads": 8,
        "head_dim": 128, "num_hidden_layers": 36, "vocab_size": 151936,
        "rms_norm_eps": 1e-6, "rope_theta": 1000000.0,
        "max_position_embeddings": 40960, "tie_word_embeddings": False,
        "use_sliding_window": False, "sliding_window": None,
        "torch_dtype": "bfloat16",
    },
    "qwen2.5-3b": {  # Qwen/Qwen2.5-3B
        "model_type": "qwen2", "architectures": ["Qwen2ForCausalLM"],
        "hidden_size": 2048, "intermediate_size": 11008,
        "num_attention_heads": 16, "num_key_value_heads": 2,
        "num_hidden_layers": 36, "vocab_size": 151936,
        "rms_norm_eps": 1e-6, "rope_theta": 1000000.0,
        "max_position_embeddings": 32768, "tie_word_embeddings": True,
        "use_sliding_window": False, "sliding_window": 32768,
        "torch_dtype": "bfloat16",
    },
    "mistral-7b-v0.1": {  # mistralai/Mistral-7B-v0.1
        "model_type": "mistral", "architectures": ["MistralForCausalLM"],
        "hidden_size": 4096, "intermediate_size": 14336,
        "num_attention_heads": 32, "num_key_value_heads": 8,
        "num_hidden_layers": 32, "vocab_size": 32000, "rms_norm_eps": 1e-5,
        "rope_theta": 10000.0, "max_position_embeddings": 32768,
        "sliding_window": 4096, "tie_word_embeddings": False,
        "torch_dtype": "bfloat16",
    },
    "gemma-2-27b": {  # google/gemma-2-27b
        "model_type": "gemma2", "architectures": ["Gemma2ForCausalLM"],
        "hidden_size": 4608, "intermediate_size": 36864,
        "num_attention_heads": 32, "num_key_value_heads": 16,
        "head_dim": 128, "num_hidden_layers": 46, "vocab_size": 256000,
        "rms_norm_eps": 1e-6, "rope_theta": 10000.0,
        "query_pre_attn_scalar": 144, "sliding_window": 4096,
        "attn_logit_softcapping": 50.0, "final_logit_softcapping": 30.0,
        "hidden_activation": "gelu_pytorch_tanh",
        "max_position_embeddings": 8192,
        # HF's Gemma2 pattern written out: even layers sliding
        "layer_types": ["sliding_attention", "full_attention"] * 23,
    },
    "gemma-3-27b": {  # google/gemma-3-27b-it, the text tower
        "model_type": "gemma3",
        "architectures": ["Gemma3ForConditionalGeneration"],
        # the hub's text_config, with the fields HF's Gemma3TextConfig
        # fills in by default (vocab, eps, the two rope bases) and its
        # layer_types (five sliding layers to one full) written out; the
        # global layers' rope_scaling (linear, factor 8) is read by
        # neither package (ROADMAP Queue 1 item 15)
        "text_config": {
            "model_type": "gemma3_text", "hidden_size": 5376,
            "intermediate_size": 21504, "num_attention_heads": 32,
            "num_key_value_heads": 16, "head_dim": 128,
            "num_hidden_layers": 62, "vocab_size": 262208,
            "rms_norm_eps": 1e-6, "rope_theta": 1000000.0,
            "rope_local_base_freq": 10000.0, "query_pre_attn_scalar": 168,
            "sliding_window": 1024, "max_position_embeddings": 131072,
            "rope_scaling": {"factor": 8.0, "rope_type": "linear"},
            "layer_types": [
                "full_attention" if (i + 1) % 6 == 0
                else "sliding_attention"
                for i in range(62)
            ],
        },
        "torch_dtype": "bfloat16",
    },
    "qwen3-30b-a3b": {  # Qwen/Qwen3-30B-A3B
        "model_type": "qwen3_moe", "architectures": ["Qwen3MoeForCausalLM"],
        "hidden_size": 2048, "intermediate_size": 6144,
        "moe_intermediate_size": 768, "num_attention_heads": 32,
        "num_key_value_heads": 4, "head_dim": 128, "num_hidden_layers": 48,
        "num_experts": 128, "num_experts_per_tok": 8, "norm_topk_prob": True,
        "decoder_sparse_step": 1, "mlp_only_layers": [],
        "vocab_size": 151936, "rms_norm_eps": 1e-6,
        "rope_theta": 1000000.0, "max_position_embeddings": 40960,
        "tie_word_embeddings": False, "use_sliding_window": False,
        "sliding_window": None, "torch_dtype": "bfloat16",
    },
    "mixtral-8x7b-v0.1": {  # mistralai/Mixtral-8x7B-v0.1
        "model_type": "mixtral", "architectures": ["MixtralForCausalLM"],
        "hidden_size": 4096, "intermediate_size": 14336,
        "num_attention_heads": 32, "num_key_value_heads": 8,
        "num_hidden_layers": 32, "num_local_experts": 8,
        "num_experts_per_tok": 2, "vocab_size": 32000,
        "rms_norm_eps": 1e-5, "rope_theta": 1000000.0,
        "max_position_embeddings": 32768, "sliding_window": None,
        "tie_word_embeddings": False, "torch_dtype": "bfloat16",
    },
    "bloom-7b1": {  # bigscience/bloom-7b1
        "model_type": "bloom", "architectures": ["BloomForCausalLM"],
        "hidden_size": 4096, "n_head": 32, "n_layer": 30,
        "vocab_size": 250880, "layer_norm_epsilon": 1e-5,
        "apply_residual_connection_post_layernorm": False,
        "torch_dtype": "bfloat16",
    },
    "bloom": {  # bigscience/bloom (BLOOM-176B)
        "model_type": "bloom", "architectures": ["BloomForCausalLM"],
        "hidden_size": 14336, "n_head": 112, "n_layer": 70,
        "vocab_size": 250880, "layer_norm_epsilon": 1e-5,
        "apply_residual_connection_post_layernorm": False,
        "torch_dtype": "bfloat16",
    },
    "falcon-7b": {  # tiiuae/falcon-7b
        "model_type": "falcon", "architectures": ["FalconForCausalLM"],
        "hidden_size": 4544, "num_attention_heads": 71,
        "num_hidden_layers": 32, "vocab_size": 65024, "multi_query": True,
        "parallel_attn": True, "new_decoder_architecture": False,
        "bias": False, "alibi": False, "layer_norm_epsilon": 1e-5,
        "torch_dtype": "bfloat16",
    },
    "falcon-40b": {  # tiiuae/falcon-40b
        "model_type": "falcon", "architectures": ["FalconForCausalLM"],
        "hidden_size": 8192, "num_attention_heads": 128,
        "num_kv_heads": 8, "num_hidden_layers": 60, "vocab_size": 65024,
        "parallel_attn": True, "new_decoder_architecture": True,
        "bias": False, "alibi": False, "layer_norm_epsilon": 1e-5,
        "torch_dtype": "bfloat16",
    },
}


def family_config(name: str, layers: int) -> tuple[dict, object]:
    """A published config cut to `layers` (a nested `text_config` too, and
    its `layer_types`; Bloom's `n_layer`) and the port registry's spec of
    it."""
    from bloombee_tpu_torch.models.auto import spec_from_config_dict

    config = json.loads(json.dumps(FAMILY_CONFIGS[name]))
    text = config.get("text_config", config)
    text["n_layer" if "n_layer" in text else "num_hidden_layers"] = layers
    if "layer_types" in text:
        text["layer_types"] = text["layer_types"][:layers]
    return config, spec_from_config_dict(config)


def family_run(uid, spec, prompts, follows, n_new, server_kw, layers=None,
               client=None, model_dir=None, late=False, spans=None,
               client_kw=None) -> dict:
    """A port registry and two port BlockServers (`max_batch=1` unless
    `server_kw` says otherwise, plus `server_kw`) over the halves of the
    model (or over `spans`), on a ServerLoop: over in-memory `layers`, or
    each built from `model_dir`. The port client (over `client` or, given
    `model_dir`, `from_pretrained`; `client_kw`: more ClientConfig fields)
    opens one session per prompt; the sessions concurrently `generate`
    n_new tokens, then (unless `follows` is None) a follow-up turn with 2
    more; with `late`, the last session sends its prompt once each of the
    others has decoded 8 tokens. Launch counts are reset just before the
    sessions step and read just after. Returns the tokens, each session's
    last-position outputs, time to first token, per-token median (with
    `server_decode`, whose tokens the client never embeds: the first
    generate's time after the prefill step over n_new - 1), the launches
    and the servers' rpc_info and layers."""
    import torch

    from bloombee_tpu_torch.client import (
        ClientConfig,
        DistributedModelForCausalLM,
    )
    from bloombee_tpu_torch.ops.cuda import build
    from bloombee_tpu_torch.swarm.registry import RegistryClient

    n = spec.num_hidden_layers
    spans = spans or ((0, n // 2), (n // 2, n))
    max_len = prompts.shape[1] + n_new + (0 if follows is None else 32)
    client_kw = client_kw or {}
    ends = [None] * len(prompts)
    loaded = {}

    def model_for(reg_port):
        # the first session's client loads the checkpoint's parameters;
        # the others share its tensors (one embedding on the card, not one
        # a session)
        if model_dir is None or loaded:
            return port_client(loaded.get("params", client), spec, reg_port,
                               uid, **client_kw)
        model = DistributedModelForCausalLM.from_pretrained(
            str(model_dir), RegistryClient("127.0.0.1", reg_port),
            model_uid=uid, device="cuda",
            config=ClientConfig(use_push=True, **client_kw),
        )
        loaded["params"] = model.params
        return model

    async def one(model, session, i, start=None):
        if start is not None:
            await start
        ids = await model.generate(prompts[i : i + 1], max_new_tokens=n_new,
                                   session=session)
        ends[i] = time.perf_counter()
        toks = [ids[0, -n_new:]]
        if follows is not None:
            more = await model.generate(follows[i : i + 1], max_new_tokens=2,
                                        session=session)
            toks.append(more[0, -2:])
        return torch.cat(toks).cpu()

    async def sessions(reg_port):
        models = [model_for(reg_port) for _ in prompts]
        last = len(models) - 1
        decoded_8 = [asyncio.Event() for _ in range(last if late else 0)]

        def on_embed(i):
            # the prompt's embed, then one per selected token
            return lambda n: n == 9 and decoded_8[i].set()

        try:
            async with contextlib.AsyncExitStack() as stack:
                opened = [
                    await stack.enter_async_context(
                        m.inference_session(max_len, 1)
                    )
                    for m in models
                ]
                recs = [tap(s, m, on_embed(i) if i < len(decoded_8) else None)
                        for i, (s, m) in enumerate(zip(opened, models))]
                start_last = (asyncio.gather(*(e.wait() for e in decoded_8))
                              if late else None)
                torch.cuda.synchronize()
                build.reset_launch_counts()
                t0 = time.perf_counter()
                tokens = await asyncio.gather(*(
                    one(m, s, i, start_last if i == last else None)
                    for i, (m, s) in enumerate(zip(models, opened))
                ))
                torch.cuda.synchronize()
                wall_s = time.perf_counter() - t0
                launches = dict(build.LAUNCHES)
        finally:
            for m in models:
                await m.manager.registry.close()

        def gaps(ts):
            return [(b - a) * 1e3 for a, b in zip(ts, ts[1:])]

        if client_kw.get("server_decode"):
            ttft = [(r["stepped"][0] - r["embeds"][0]) * 1e3 for r in recs]
            per_token = [(end - r["stepped"][0]) * 1e3 / (n_new - 1)
                         for r, end in zip(recs, ends)]
        else:
            ttft = [gaps(r["embeds"][:2])[0] for r in recs]
            per_token = [sorted(gaps(r["embeds"][1:n_new]))[(n_new - 2) // 2]
                         for r in recs]
        return {
            "tokens": tokens, "launches": launches, "wall_s": wall_s,
            "lasts": [torch.cat([o[:, -1] for o in r["outs"]]).float()
                      for r in recs],
            "ttft_ms": ttft, "per_token_ms_median": per_token,
        }

    with ReplayWatch() as watch, ServerLoop() as servers_loop:
        reg, servers = servers_loop.run(start_span_servers(
            layers, spec, uid, spans, torch.bfloat16, 1024,
            model_dir=None if model_dir is None else str(model_dir),
            **{"max_batch": 1, **server_kw},
        ))
        try:
            out = asyncio.run(sessions(reg.port))
            out["infos"] = [servers_loop.run(s._rpc_info({}, []))[0]
                            for s in servers]
            out["server_layers"] = [s.end_block - s.start_block
                                    for s in servers]
        finally:
            servers_loop.run(stop_span_servers(reg, servers))
            del servers
    out["replays"] = list(watch.seen)
    torch.cuda.empty_cache()
    return out


def family_check(by_path, failures, path, run, spec, ref_tokens, want,
                 held=None, identical=True) -> None:
    """Record a family run's launches under `path` in `by_path` (the
    wanted kernels' zeros included) and print its numbers; append to
    `failures` what misses: tokens other than the solo executor's
    `ref_tokens` (only gated when `identical`: merged and ragged
    dispatches round differently from the solo path, and `held` gates
    such a run), outputs that are not finite, launches other than `want`,
    a replayed group, a failed teacher-forced gate."""
    import torch

    launches = by_path[path] = {**dict.fromkeys(want, 0), **run["launches"]}
    if ref_tokens is None:
        # no solo run: the teacher-forced reference's own greedy picks
        # stand in (equal everywhere iff it flipped none)
        same = held["ok"] and held["tolerated_flips"] == 0
    else:
        same = all(torch.equal(t, r)
                   for t, r in zip(run["tokens"], ref_tokens))
    finite = all(torch.isfinite(x).all().item() for x in run["lasts"])
    got = {k: launches.get(k, 0) for k in want}
    stats = {
        "layers": spec.num_hidden_layers, "window": spec.sliding_window,
        "tokens_identical_to_solo_executor": same, "finite": finite,
        "ttft_ms": [round(x, 2) for x in run["ttft_ms"]],
        "per_token_ms_median": [round(x, 3)
                                for x in run["per_token_ms_median"]],
        "run_s": round(run["wall_s"], 3), "launches": launches,
        "launches_want": want, "replays": len(run["replays"]),
    }
    if held is not None:
        stats["held"] = held
    say(f"[{path}] " + json.dumps(stats))
    if not finite or (identical and not same):
        failures.append(f"{path}: tokens differ from the solo executor "
                        f"or outputs not finite")
    if got != want:
        failures.append(f"{path}: launches {got}, want {want}")
    if run["replays"]:
        failures.append(f"{path}: replays {run['replays']}")
    if held is not None and not held["ok"]:
        failures.append(f"{path}: fails the teacher-forced gate")


def family_teacher_forced(layers, spec, local, prompts, follows, run, n_new,
                          chunk=0, dense_truth=False) -> dict:
    """`hold_teacher_forced` of a family run: the solo executor fed the
    run's tokens in bf16 (the run's routes) and, as the truth, over f32
    copies of the layers (`dense_truth`: on the dense route)."""
    import torch

    max_len = prompts.shape[1] + n_new + 32
    ref = served_reference(layers, spec, local, prompts, follows, n_new,
                           feed=run["tokens"], chunk=chunk,
                           max_len=max_len)[0]
    layers32 = [{k: v.float() for k, v in layer.items()} for layer in layers]
    truth = served_reference(layers32, spec, local, prompts, follows, n_new,
                             feed=run["tokens"], chunk=chunk,
                             dtype=torch.float32, max_len=max_len,
                             dense=dense_truth)[0]
    del layers32
    torch.cuda.empty_cache()
    return hold_teacher_forced(local, run["lasts"], run["tokens"], ref, truth)


def paged_prefill_chunks(prompt_len: int, chunk: int) -> int:
    """How many of a chunking server's prefill chunks take the paged chunk
    kernel at the default BBTPU_PAGED_MIN_CONTEXT (512): those whose
    context's page bucket covers 512 tokens (`SpanExecutor._step`)."""
    from bloombee_tpu_torch.runtime.executor import (
        next_pow2,
        plan_prefill_chunks,
    )

    return sum(
        1 for _, e in plan_prefill_chunks(prompt_len, chunk, cap=512)
        if next_pow2(-(-e // PS), floor=4) * PS >= 512
    )


def phase_families() -> dict:
    """Phase 10: the Llama-like families through the port's registry,
    served by two port BlockServers (`max_batch=1`, 1024-page arenas) and
    the port client, each run's launch counts reset and read around its
    sessions (paths "family_qwen3", "family_qwen2", "family_mistral"):

    (a) Qwen3-8B at published width and depth (36 layers, bf16, random
        weights with unit q/k norms), spans [0, 18) and [18, 36): 2
        sessions of 1000-token prompts generate 32 tokens, then a 24-token
        follow-up with 2 more. Tokens identical to the sessions solo on
        one executor, held teacher-forced against an f32 truth
        (`hold_teacher_forced`); flash = 2 a layer per session (512 + 488),
        paged decode = n_new a layer per session, chunk = 1 a layer per
        session (the follow-up).
    (b) Qwen2.5-3B at published width, 4 layers, tied embeddings and q/k/v
        biases, written as a `qwen2` checkpoint: servers built from the
        directory, the client from `from_pretrained`; the same sessions
        and launch counts; tokens identical to an in-process solo executor
        over the same checkpoint.
    (c) Mistral-7B-v0.1 at published width, 2 layers, window 4096: 2
        sessions of 4400-token prompts through `prefill_chunk=64` servers
        (the chunk kernel carries the window past 4096 tokens), then 32
        tokens (the decode kernel carries it). Tokens identical to the
        solo executor (same chunks), held teacher-forced against an f32
        truth on the dense route; chunk launches = the chunks past the
        paged threshold, decode = 31 a layer per session, no flash.

    Prints each run's time to first token and per-token medians and the
    card's name and power limit; returns the launches by path."""
    import gc
    import shutil
    import tempfile

    import torch

    from bloombee_tpu_torch.client import DistributedModelForCausalLM
    from bloombee_tpu_torch.models.checkpoint import (
        load_client_params,
        load_span_params,
    )

    t_phase = time.perf_counter()
    # the earlier phases' models and servers sit in reference cycles:
    # collect them before Qwen3-8B and its f32 truth (~46 GiB together)
    gc.collect()
    torch.cuda.empty_cache()
    say(f"[families] {torch.cuda.memory_allocated() / 2**30:.2f} GiB "
        f"allocated before the phase")
    torch.backends.cuda.matmul.allow_tf32 = False
    by_path, failures = {}, []
    n_new, sessions = 32, 2

    # (a) Qwen3-8B, 36 layers
    _, spec = family_config("qwen3-8b", 36)
    layers, client, gen = random_model(spec, torch.bfloat16, seed=31)
    torch.cuda.synchronize()
    say(f"[family_qwen3] Qwen3-8B bf16, {spec.num_hidden_layers} layers, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card")
    prompts = torch.randint(0, spec.vocab_size, (sessions, 1000),
                            generator=gen, device="cuda")
    follows = torch.randint(0, spec.vocab_size, (sessions, 24),
                            generator=gen, device="cuda")
    local = DistributedModelForCausalLM(spec, client, None, device="cuda")
    run = family_run("qwen3-8b", spec, prompts, follows, n_new, {},
                     layers=layers, client=client)
    solo = served_reference(layers, spec, local, prompts, follows, n_new)[0]
    per = spec.num_hidden_layers * sessions
    family_check(
        by_path, failures, "family_qwen3", run, spec,
        [t for _, t in solo],
        {"flash_attention": 2 * per, "paged_decode_attention": n_new * per,
         "paged_chunk_attention": per},
        family_teacher_forced(layers, spec, local, prompts, follows, run,
                              n_new),
    )
    del layers, client, local, run, solo
    torch.cuda.empty_cache()

    # (b) Qwen2.5-3B, 4 layers, from a checkpoint
    config, spec = family_config("qwen2.5-3b", 4)
    tmp = pathlib.Path(tempfile.mkdtemp(prefix="bbtpu-qwen2-"))
    try:
        t0 = time.perf_counter()
        write_checkpoint(tmp, spec, seed=37, config=config)
        say(f"[family_qwen2] checkpoint written in "
            f"{time.perf_counter() - t0:.2f} s")
        gen = torch.Generator(device="cuda").manual_seed(41)
        prompts = torch.randint(0, spec.vocab_size, (sessions, 1000),
                                generator=gen, device="cuda")
        follows = torch.randint(0, spec.vocab_size, (sessions, 24),
                                generator=gen, device="cuda")
        run = family_run("qwen2.5-3b", spec, prompts, follows, n_new, {},
                         model_dir=tmp)
        layers, _ = load_span_params(str(tmp), 0, spec.num_hidden_layers,
                                     dtype=torch.bfloat16, device="cuda")
        if not all({"q_bias", "k_bias", "v_bias"} <= set(p) for p in layers):
            failures.append("family_qwen2: the loader dropped the biases")
        local = DistributedModelForCausalLM(
            spec, load_client_params(str(tmp), device="cuda"), None,
            device="cuda",
        )
        solo = served_reference(layers, spec, local, prompts, follows,
                                n_new)[0]
        per = spec.num_hidden_layers * sessions
        family_check(by_path, failures, "family_qwen2", run, spec,
                     [t for _, t in solo],
                     {"flash_attention": 2 * per,
                      "paged_decode_attention": n_new * per,
                      "paged_chunk_attention": per})
        del layers, local, run, solo
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()

    # (c) Mistral-7B-v0.1, 2 layers, window 4096
    _, spec = family_config("mistral-7b-v0.1", 2)
    layers, client, gen = random_model(spec, torch.bfloat16, seed=43)
    prompt_len, chunk = 4400, 64
    prompts = torch.randint(0, spec.vocab_size, (sessions, prompt_len),
                            generator=gen, device="cuda")
    local = DistributedModelForCausalLM(spec, client, None, device="cuda")
    run = family_run("mistral-7b", spec, prompts, None, n_new,
                     {"prefill_chunk": chunk}, layers=layers, client=client)
    solo = served_reference(layers, spec, local, prompts, None, n_new,
                            chunk=chunk, max_len=prompt_len + n_new)[0]
    per = spec.num_hidden_layers * sessions
    family_check(
        by_path, failures, "family_mistral", run, spec,
        [t for _, t in solo],
        {"flash_attention": 0,
         "paged_decode_attention": (n_new - 1) * per,
         "paged_chunk_attention":
             paged_prefill_chunks(prompt_len, chunk) * per},
        family_teacher_forced(layers, spec, local, prompts, None, run, n_new,
                              chunk=chunk, dense_truth=True),
    )
    del layers, client, local, run, solo
    torch.cuda.empty_cache()

    say(f"[families] phase took {time.perf_counter() - t_phase:.1f} s")
    say(card_line())
    if failures:
        raise AssertionError("family runs failed: " + "; ".join(failures))
    return by_path


# ------------------------------------------------------------- phase 11
KERNELS = tuple(REPLACES)


def session_inputs(gen, vocab: int, n: int, prompt_len: int):
    """n random prompts of `prompt_len` tokens and n 24-token follow-ups,
    on the card."""
    import torch

    return (torch.randint(0, vocab, (n, prompt_len), generator=gen,
                          device="cuda"),
            torch.randint(0, vocab, (n, 24), generator=gen, device="cuda"))


def mixed_check(by_path, failures, path, run, spec, held,
                dense=False) -> None:
    """`family_check` of a mixed run (`mixed_batch`, `prefill_chunk`,
    BBTPU_PAGED_MIN_CONTEXT=0, a late session): the launches its servers'
    counters imply, each server's layers x its ragged dispatches
    (ragged), its decode dispatches (decode), and its prefill chunks run
    alone plus each session's 24-token follow-up (chunk), no flash (with
    `dense`, a spec off every kernel: none at all); held teacher-forced;
    some chunk mixed with decodes and no ragged decline."""
    infos = run["infos"]

    def per_server(**signs):
        # each server's layers x its counters, summed over the servers
        return sum(n * sum(sg * info[k] for k, sg in signs.items())
                   for n, info in zip(run["server_layers"], infos))

    say(f"[{path}] batching "
        + json.dumps([{k: i[k] for k in BATCH_KEYS} for i in infos]))
    want = dict.fromkeys(KERNELS, 0)
    if not dense:
        want.update({
            "paged_ragged_attention": per_server(ragged_group_dispatches=1),
            "paged_decode_attention": per_server(batch_dispatches=1,
                                                 batch_solo_steps=1),
            "paged_chunk_attention": per_server(prefill_chunks=1,
                                                mixed_dispatches=-1)
            + sum(run["server_layers"]) * len(run["tokens"]),
        })
    family_check(by_path, failures, path, run, spec, None, want, held,
                 identical=False)
    if not sum(i["mixed_dispatches"] for i in infos):
        failures.append(f"{path}: no chunk mixed with decodes")
    if any(i["ragged_declines"] for i in infos):
        failures.append(f"{path}: ragged declines")


def phase_gemma() -> dict:
    """Phase 11: the Gemma families through the port's registry (published
    configs, random bf16 weights with tied heads), each run served by two
    port BlockServers over the halves of the model and the port client,
    launch counts reset and read around each run's sessions (paths
    "gemma2", "gemma3", "gemma3_mixed"):

    (a) Gemma-2-27B at published width (32/16 heads of 128, window 4096
        on even layers, query scale 144^-0.5, attention and final logit
        soft-caps 50 and 30), 8 layers, [0, 4) + [4, 8), `max_batch=1`: 2
        sessions of 32 tokens from 1000-token prompts and a 24-token
        follow-up with 2 more. Tokens identical to the solo executor, held
        teacher-forced against an f32 truth; no kernel launched at all:
        soft-capped attention stays dense inside the kernels' domain, as
        the JAX gates keep it.
    (b) Gemma-3-27B at published width (32/16 heads of 128, q/k norms,
        window 1024 on five layers of six, rope bases 1e4 sliding and 1e6
        full, query scale 168^-0.5), 12 layers (full layers 5 and 11),
        [0, 6) + [6, 12):
        run 1, `max_batch=1`: 2 sessions of 32 tokens from 1500-token
        prompts (past the window) and a 24-token follow-up with 2 more;
        tokens identical to the solo executor, held teacher-forced
        against an f32 truth on the dense route; paged decode = 32 a layer
        a session (31 + the follow-up's), chunk = 1 a layer a session
        (the follow-up), no flash (a window keeps it off), no ragged;
        run 2, `mixed_batch=True`, `prefill_chunk=32`, `max_batch=8`,
        BBTPU_PAGED_MIN_CONTEXT=0 (every attention step on a kernel), a
        20 ms gather window (BBTPU_BATCH_WINDOW_MS): the two sessions and
        a third sent once they have decoded 8 tokens;
        ragged = each server's layers x its ragged dispatches, decode =
        its layers x its decode dispatches, chunk = its layers x its
        prefill chunks run alone plus the 3 follow-ups, flash 0; held
        teacher-forced against the solo executor cutting the prompts into
        the same chunks and an f32 truth on the dense route.

    Prints each run's time to first token and per-token medians and the
    card's name and power limit; returns the launches by path."""
    import gc

    import torch

    from bloombee_tpu_torch.client import DistributedModelForCausalLM

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    say(f"[gemma] {torch.cuda.memory_allocated() / 2**30:.2f} GiB "
        f"allocated before the phase")
    torch.backends.cuda.matmul.allow_tf32 = False
    by_path, failures = {}, []
    n_new, sessions = 32, 2

    # (a) Gemma-2-27B, 8 layers: every route dense
    _, spec = family_config("gemma-2-27b", 8)
    layers, client, gen = random_model(spec, torch.bfloat16, seed=47)
    torch.cuda.synchronize()
    say(f"[gemma2] Gemma-2-27B bf16, {spec.num_hidden_layers} layers, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card")
    prompts, follows = session_inputs(gen, spec.vocab_size, sessions, 1000)
    local = DistributedModelForCausalLM(spec, client, None, device="cuda")
    run = family_run("gemma-2-27b", spec, prompts, follows, n_new, {},
                     layers=layers, client=client)
    solo = served_reference(layers, spec, local, prompts, follows, n_new)[0]
    family_check(by_path, failures, "gemma2", run, spec,
                 [t for _, t in solo], dict.fromkeys(KERNELS, 0),
                 family_teacher_forced(layers, spec, local, prompts,
                                       follows, run, n_new))
    del layers, client, local, run, solo
    torch.cuda.empty_cache()

    # (b) Gemma-3-27B, 12 layers: sliding layers on the paged kernels
    _, spec = family_config("gemma-3-27b", 12)
    layers, client, gen = random_model(spec, torch.bfloat16, seed=53)
    torch.cuda.synchronize()
    say(f"[gemma3] Gemma-3-27B bf16, {spec.num_hidden_layers} layers, "
        f"windows {[spec.window_for_layer(i) for i in range(12)]}, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card")
    prompts, follows = session_inputs(gen, spec.vocab_size, 3, 1500)
    local = DistributedModelForCausalLM(spec, client, None, device="cuda")
    run = family_run("gemma-3-27b", spec, prompts[:sessions],
                     follows[:sessions], n_new, {}, layers=layers,
                     client=client)
    solo = served_reference(layers, spec, local, prompts[:sessions],
                            follows[:sessions], n_new,
                            max_len=prompts.shape[1] + n_new + 32)[0]
    per = spec.num_hidden_layers * sessions
    family_check(
        by_path, failures, "gemma3", run, spec, [t for _, t in solo],
        {**dict.fromkeys(KERNELS, 0), "paged_decode_attention": n_new * per,
         "paged_chunk_attention": per},
        family_teacher_forced(layers, spec, local, prompts[:sessions],
                              follows[:sessions], run, n_new,
                              dense_truth=True),
    )
    del run, solo

    # a 20 ms gather window: with 6-layer dispatches of a few ms the queue
    # is mostly empty, and without one a chunk and a decode step rarely
    # meet in it (on an H100, a run without one fused no chunk at all)
    chunk = 32
    with env_set("BBTPU_PAGED_MIN_CONTEXT", "0"), \
            env_set("BBTPU_BATCH_WINDOW_MS", "20"):
        run = family_run(
            "gemma-3-27b-mixed", spec, prompts, follows, n_new,
            {"max_batch": 8, "mixed_batch": True, "prefill_chunk": chunk},
            layers=layers, client=client, late=True,
        )
        held = family_teacher_forced(layers, spec, local, prompts, follows,
                                     run, n_new, chunk=chunk,
                                     dense_truth=True)
    mixed_check(by_path, failures, "gemma3_mixed", run, spec, held)
    del layers, client, local, run
    torch.cuda.empty_cache()

    say(f"[gemma] phase took {time.perf_counter() - t_phase:.1f} s")
    say(card_line())
    if failures:
        raise AssertionError("gemma runs failed: " + "; ".join(failures))
    return by_path


# ------------------------------------------------------------- phase 12
def moe_bytes(spec) -> dict:
    """The byte reckoning of an MoE spec in bf16: experts and attention a
    layer, the whole span's weights, the client's embedding and head, the
    KV a token across the layers (GB, KB)."""
    d, i, e = spec.hidden_size, spec.intermediate_size, spec.num_experts
    h, kv, hd = spec.num_attention_heads, spec.num_key_value_heads, \
        spec.head_dim
    experts = 3 * e * d * i * 2
    attention = (2 * d * h * hd + 2 * d * kv * hd) * 2
    return {
        "experts_gb_a_layer": experts / 1e9,
        "attention_gb_a_layer": attention / 1e9,
        "layers_gb": spec.num_hidden_layers * (experts + attention) / 1e9,
        "embed_and_head_gb": 2 * spec.vocab_size * d * 2 / 1e9,
        "kv_kb_a_token": spec.num_hidden_layers * 2 * kv * hd * 2 / 1e3,
    }


def routing_flips(layers, spec, local, prompts, follows, tokens,
                  n_new) -> dict:
    """Where the bf16 layers and their f32 copies pick different experts
    on a run's teacher-forced sequences: each session's prompt, the tokens
    it was fed (the run's own), its follow-up and the token after it, run
    whole through the layers (dense causal attention) in each dtype from
    the same bf16 embeddings; at each layer the picks are the nonzero
    `ops.moe.router_topk_weights` of its post-attention-normed input.
    Returns the (layer, position) decisions compared and how many differ,
    per layer."""
    import torch

    from bloombee_tpu_torch.models.llama.block import (
        attention_inputs,
        dense_attend,
        mlp,
        proj,
    )
    from bloombee_tpu_torch.ops import rms_norm
    from bloombee_tpu_torch.ops.moe import router_topk_weights
    from bloombee_tpu_torch.runtime.step import rotary_tables

    eps = spec.rms_norm_eps
    flips, decisions = [0] * len(layers), 0
    for i in range(len(prompts)):
        fed = tokens[i].to("cuda")
        parts = [prompts[i], fed[: n_new - 1]]
        if follows is not None:
            parts += [follows[i], fed[n_new : n_new + 1]]
        ids = torch.cat(parts)[None]
        x = local.embed(ids).to(torch.bfloat16)
        pos = torch.arange(ids.shape[1], device="cuda")[None]
        picks = {}
        for dtype in (torch.bfloat16, torch.float32):
            cos, sin = rotary_tables(spec, pos, dtype, (0,))[0]
            h = x.to(dtype)
            for l, layer in enumerate(layers):
                p = {k: v.to(dtype) for k, v in layer.items()}
                q, k, v = attention_inputs(
                    p, spec, rms_norm(h, p["input_layernorm"], eps), cos,
                    sin,
                )
                attn, _ = dense_attend()(q, k, v)
                h = h + proj(attn.flatten(-2), p, "o_proj")
                normed = rms_norm(h, p["post_attention_layernorm"], eps)
                w = router_topk_weights(
                    normed @ p["router"], spec.num_experts_per_tok,
                    spec.moe_pre_softmax, spec.moe_norm_topk,
                )
                picks.setdefault(l, []).append(w[0] > 0)
                h = h + mlp(p, spec, normed)
            del h
        for l, (bf16, f32) in picks.items():
            flips[l] += int((bf16 != f32).any(-1).sum().item())
        decisions += len(layers) * ids.shape[1]
    torch.cuda.empty_cache()
    return {"decisions": decisions, "flipped": sum(flips),
            "flipped_by_layer": flips}


def reset_peak() -> None:
    """Just before a run's servers start, garbage (an earlier run's
    servers in reference cycles) collected: the peak is the run's weights,
    arenas and transients."""
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()


def say_peak(path: str) -> None:
    import torch

    gib = torch.cuda.max_memory_allocated() / 2**30
    say(f"[{path}] peak torch.cuda.max_memory_allocated {gib:.2f} GiB")


def moe_checkpoint_run(by_path, failures, path, uid, tmp, spec, prompts,
                       follows, n_new):
    """`max_batch=1` sessions on servers built from the checkpoint in
    `tmp` and a `from_pretrained` client; tokens identical to an
    in-process solo executor over the checkpoint; flash = 2 a layer a
    session (512 + 488), paged decode = n_new and chunk = 1 a layer a
    session; held teacher-forced against an f32 truth, the routing flips
    counted. Returns the solo executor's layers and client model."""
    import torch

    from bloombee_tpu_torch.client import DistributedModelForCausalLM
    from bloombee_tpu_torch.models.checkpoint import (
        load_client_params,
        load_span_params,
    )

    reset_peak()
    run = family_run(uid, spec, prompts, follows, n_new, {}, model_dir=tmp)
    say_peak(path)
    layers, _ = load_span_params(str(tmp), 0, spec.num_hidden_layers,
                                 dtype=torch.bfloat16, device="cuda")
    local = DistributedModelForCausalLM(
        spec, load_client_params(str(tmp), device="cuda"), None,
        device="cuda",
    )
    solo = served_reference(layers, spec, local, prompts, follows, n_new)[0]
    per = spec.num_hidden_layers * len(prompts)
    held = family_teacher_forced(layers, spec, local, prompts, follows, run,
                                 n_new)
    held["routing_flips"] = routing_flips(
        layers, spec, local, prompts, follows, run["tokens"], n_new,
    )
    family_check(
        by_path, failures, path, run, spec, [t for _, t in solo],
        {**dict.fromkeys(KERNELS, 0), "flash_attention": 2 * per,
         "paged_decode_attention": n_new * per,
         "paged_chunk_attention": per},
        held,
    )
    return layers, local


def phase_moe() -> dict:
    """Phase 12: the MoE families through the port's registry (published
    configs, random bf16 weights), each run served by two port
    BlockServers over the halves of the model and the port client, launch
    counts reset and read around each run's sessions (paths "moe_qwen3",
    "moe_mixtral", "moe_mixtral_mixed", "moe_qwen3_ckpt"):

    (a) Qwen3-30B-A3B at published width and all 48 layers (32/4 heads of
        128, q/k norms, 128 experts of 768 with top-8 renormalised),
        [0, 24) + [24, 48), `max_batch=1`: 2 sessions of 32 tokens from
        1000-token prompts and a 24-token follow-up with 2 more. Tokens
        identical to the sessions solo on one executor over the same
        parameter tensors (no second copy fits); flash = 2 a layer a
        session (512 + 488), paged decode = n_new a layer a session, chunk
        = 1 a layer a session (the follow-up). No f32 truth at this depth:
        (c) holds the family's router against one.
    (b) Mixtral-8x7B-v0.1 at published width (32/8 heads of 128, 8
        experts of 14336 with top-2), 2 layers, written as a `mixtral`
        checkpoint with HF names: servers built from the directory over
        [0, 1) + [1, 2), the client from `from_pretrained`;
        run 1, `max_batch=1` (`moe_checkpoint_run`): the sessions and
        launch counts of (a), tokens identical to an in-process solo
        executor over the checkpoint;
        run 2, `mixed_batch=True`, `prefill_chunk=32`, `max_batch=8`,
        BBTPU_PAGED_MIN_CONTEXT=0 and a 20 ms gather window: the two
        sessions and a third sent once they have decoded 8 tokens, so
        decode rows share ragged launches with its prefill chunks; ragged,
        decode and chunk launches equal to the servers' layers x their
        ragged dispatches, decode dispatches, and unfused chunks plus
        follow-ups; no flash.
        Both runs held teacher-forced against an f32 truth of the 2 layers
        (`hold_teacher_forced`); the positions where the bf16 and f32
        routers pick different experts on each run's sequences are
        counted (`routing_flips`).
    (c) Qwen3-30B-A3B at published width, 4 layers, written as a
        `qwen3_moe` checkpoint (`mlp.gate`, `mlp.experts.{e}.*_proj`),
        served over [0, 2) + [2, 4) as run 1 of (b): tokens identical to
        the solo executor over the checkpoint, the launches of (a), held
        teacher-forced against an f32 truth of the 4 layers, routing flips
        counted.

    Prints the byte reckoning, each run's time to first token, per-token
    medians and peak `torch.cuda.max_memory_allocated`, the phase's
    seconds, and the card's name and power limit; returns the launches by
    path."""
    import gc
    import shutil
    import tempfile

    import torch

    from bloombee_tpu_torch.client import DistributedModelForCausalLM

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    say(f"[moe] {torch.cuda.memory_allocated() / 2**30:.2f} GiB "
        f"allocated before the phase")
    torch.backends.cuda.matmul.allow_tf32 = False
    by_path, failures = {}, []
    n_new, sessions = 32, 2

    def bytes_line(path, spec):
        say(f"[{path}] bytes " + json.dumps(
            {k: round(v, 4) for k, v in moe_bytes(spec).items()}
        ))

    def written(path, spec, config, seed):
        tmp = pathlib.Path(tempfile.mkdtemp(prefix=f"bbtpu-{path}-"))
        t0 = time.perf_counter()
        write_checkpoint(tmp, spec, seed=seed, config=config)
        say(f"[{path}] checkpoint written in "
            f"{time.perf_counter() - t0:.2f} s")
        return tmp

    # (a) Qwen3-30B-A3B, all 48 layers
    _, spec = family_config("qwen3-30b-a3b", 48)
    bytes_line("moe_qwen3", spec)
    layers, client, gen = random_model(spec, torch.bfloat16, seed=59)
    torch.cuda.synchronize()
    say(f"[moe_qwen3] Qwen3-30B-A3B bf16, {spec.num_hidden_layers} layers, "
        f"{spec.num_experts} experts top-{spec.num_experts_per_tok}, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card")
    prompts, follows = session_inputs(gen, spec.vocab_size, sessions, 1000)
    local = DistributedModelForCausalLM(spec, client, None, device="cuda")
    reset_peak()
    run = family_run("qwen3-30b-a3b", spec, prompts, follows, n_new, {},
                     layers=layers, client=client)
    say_peak("moe_qwen3")
    solo = served_reference(layers, spec, local, prompts, follows, n_new)[0]
    per = spec.num_hidden_layers * sessions
    family_check(
        by_path, failures, "moe_qwen3", run, spec, [t for _, t in solo],
        {**dict.fromkeys(KERNELS, 0), "flash_attention": 2 * per,
         "paged_decode_attention": n_new * per,
         "paged_chunk_attention": per},
    )
    del layers, client, local, run, solo
    gc.collect()
    torch.cuda.empty_cache()

    # (b) Mixtral-8x7B-v0.1, 2 layers, from a checkpoint
    config, spec = family_config("mixtral-8x7b-v0.1", 2)
    bytes_line("moe_mixtral", spec)
    tmp = written("moe_mixtral", spec, config, seed=61)
    try:
        gen = torch.Generator(device="cuda").manual_seed(67)
        prompts, follows = session_inputs(gen, spec.vocab_size, 3, 1000)
        layers, local = moe_checkpoint_run(
            by_path, failures, "moe_mixtral", "mixtral-8x7b", tmp, spec,
            prompts[:sessions], follows[:sessions], n_new,
        )

        chunk = 32
        reset_peak()
        with env_set("BBTPU_PAGED_MIN_CONTEXT", "0"), \
                env_set("BBTPU_BATCH_WINDOW_MS", "20"):
            run = family_run(
                "mixtral-8x7b-mixed", spec, prompts, follows, n_new,
                {"max_batch": 8, "mixed_batch": True,
                 "prefill_chunk": chunk},
                model_dir=tmp, late=True,
            )
            say_peak("moe_mixtral_mixed")
            held = family_teacher_forced(layers, spec, local, prompts,
                                         follows, run, n_new, chunk=chunk)
        held["routing_flips"] = routing_flips(
            layers, spec, local, prompts, follows, run["tokens"], n_new,
        )
        mixed_check(by_path, failures, "moe_mixtral_mixed", run, spec, held)
        say(f"[moe_mixtral_mixed] ragged launches "
            f"{run['launches'].get('paged_ragged_attention', 0)}")
        del layers, local, run
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()

    # (c) Qwen3-30B-A3B, 4 layers, from a checkpoint, against an f32 truth
    config, spec = family_config("qwen3-30b-a3b", 4)
    bytes_line("moe_qwen3_ckpt", spec)
    tmp = written("moe_qwen3_ckpt", spec, config, seed=71)
    try:
        gen = torch.Generator(device="cuda").manual_seed(73)
        prompts, follows = session_inputs(gen, spec.vocab_size, sessions,
                                          1000)
        moe_checkpoint_run(by_path, failures, "moe_qwen3_ckpt",
                           "qwen3-30b-a3b-4", tmp, spec, prompts, follows,
                           n_new)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()

    say(f"[moe] phase took {time.perf_counter() - t_phase:.1f} s")
    say(card_line())
    if failures:
        raise AssertionError("moe runs failed: " + "; ".join(failures))
    return by_path

# ------------------------------------------------------------- phase 13
def bloom_bytes(spec) -> dict:
    """The byte reckoning of a Bloom spec in bf16: a layer (12 D^2
    weights and 13 D biases and LayerNorm parameters), the whole model's
    layers, the embedding (the head is its view), the KV a token across
    the layers and one 1024-page arena of half the layers (GB, KB)."""
    d, n = spec.hidden_size, spec.num_hidden_layers
    layer = (12 * d * d + 13 * d) * 2
    kv_token = 2 * spec.num_key_value_heads * spec.head_dim * 2
    return {
        "layer_gb": layer / 1e9,
        "layers_gb": n * layer / 1e9,
        "embed_and_head_gb": spec.vocab_size * d * 2 / 1e9,
        "kv_kb_a_token": n * kv_token / 1e3,
        "arena_gb_a_half_span": 1024 * PS * (n // 2) * kv_token / 1e9,
    }


def phase_bloom() -> dict:
    """Phase 13: the Bloom family through the port's registry (published
    configs, random bf16 weights: LayerNorms with biases, every projection
    biased, the embedding LayerNorm, a tied head), each run served by port
    BlockServers and the port client, launch counts reset and read around
    each run's sessions (paths "bloom7b", "bloom7b_dn", "bloom176",
    "bloom176_mixed"). ALiBi keeps every attention step on the dense
    routes (no kernel has the bias, as in the JAX package), so every path
    launches no kernel at all.

    (a) bloom-7b1 at published width and all 30 layers (32 heads of 128,
        vocab 250880), [0, 15) + [15, 30), `max_batch=1`: 2 sessions of 32
        tokens from 1000-token prompts and a 24-token follow-up with 2
        more. Tokens identical to the sessions solo on one executor, held
        teacher-forced against an f32 truth. Then the same sessions with
        `server_decode=True` on one [0, 30) server given the client's
        parameters (the fused decode loop: the embedding LayerNorm and the
        LayerNorm head on the server): tokens identical to the per-step
        run, every decode_n call fused.
    (b) BLOOM-176B at published width (112 heads of 128: 64 slopes of the
        power of two and 48 of the extension), 2 layers, written as a
        `bloom` checkpoint in the hub's layout (`h.{i}.*`, the fused
        per-head QKV): servers built from the directory over [0, 1) +
        [1, 2), the client from `from_pretrained` with `use_chunked_head`
        (the unchunked head would upcast a 14.4 GB f32 copy of the tied
        head); run 1 as (a), tokens identical to an in-process solo
        executor over the checkpoint, held teacher-forced against an f32
        truth; run 2 with `mixed_batch=True`, `prefill_chunk=32`,
        `max_batch=8`, a 20 ms gather window, the wire uncompressed
        (BBTPU_WIRE_COMPRESSION=0) and a third session sent once the two
        have decoded 8 tokens, so ALiBi runs on the dense ragged route:
        chunks mixed with decodes, held teacher-forced.

    Prints the byte reckoning, each run's time to first token, per-token
    medians and peak allocated memory, the phase's seconds, and the card's
    name and power limit; returns the launches by path."""
    import gc
    import shutil
    import tempfile

    import torch

    from bloombee_tpu_torch.client import DistributedModelForCausalLM
    from bloombee_tpu_torch.models.checkpoint import (
        load_client_params,
        load_span_params,
    )

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    say(f"[bloom] {torch.cuda.memory_allocated() / 2**30:.2f} GiB "
        f"allocated before the phase")
    torch.backends.cuda.matmul.allow_tf32 = False
    by_path, failures = {}, []
    n_new, sessions = 32, 2
    zeros = dict.fromkeys(KERNELS, 0)

    def bytes_line(path, spec):
        say(f"[{path}] bytes " + json.dumps(
            {k: round(v, 4) for k, v in bloom_bytes(spec).items()}
        ))

    # (a) bloom-7b1, all 30 layers
    _, spec = family_config("bloom-7b1", 30)
    bytes_line("bloom7b", spec)
    layers, client, gen = random_model(spec, torch.bfloat16, seed=79)
    torch.cuda.synchronize()
    say(f"[bloom7b] bloom-7b1 bf16, {spec.num_hidden_layers} layers, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card")
    prompts, follows = session_inputs(gen, spec.vocab_size, sessions, 1000)
    local = DistributedModelForCausalLM(spec, client, None, device="cuda")
    reset_peak()
    run = family_run("bloom-7b1", spec, prompts, follows, n_new, {},
                     layers=layers, client=client)
    say_peak("bloom7b")
    solo = served_reference(layers, spec, local, prompts, follows, n_new)[0]
    family_check(by_path, failures, "bloom7b", run, spec,
                 [t for _, t in solo], zeros,
                 family_teacher_forced(layers, spec, local, prompts,
                                       follows, run, n_new))
    del solo
    reset_peak()
    dn = family_run(
        "bloom-7b1-dn", spec, prompts, follows, n_new,
        {"client_params": client}, layers=layers, client=client,
        spans=((0, spec.num_hidden_layers),),
        client_kw={"server_decode": True, "server_decode_chunk": 32},
    )
    say_peak("bloom7b_dn")
    family_check(by_path, failures, "bloom7b_dn", dn, spec, run["tokens"],
                 zeros)
    info = dn["infos"][0]
    say(f"[bloom7b_dn] decode_n calls {info['decode_n_calls']}, fused "
        f"{info['decode_n_fused_calls']}, steps {info['decode_n_steps']}")
    if not info["decode_n_fused_calls"] == info["decode_n_calls"] > 0:
        failures.append("bloom7b_dn: not every decode_n call fused")
    del layers, client, local, run, dn
    gc.collect()
    torch.cuda.empty_cache()

    # (b) BLOOM-176B, 2 layers, from a checkpoint
    config, spec = family_config("bloom", 2)
    bytes_line("bloom176", spec)
    tmp = pathlib.Path(tempfile.mkdtemp(prefix="bbtpu-bloom176-"))
    try:
        t0 = time.perf_counter()
        write_checkpoint(tmp, spec, seed=83, config=config)
        say(f"[bloom176] checkpoint written in "
            f"{time.perf_counter() - t0:.2f} s")
        chunked = {"use_chunked_head": True}
        gen = torch.Generator(device="cuda").manual_seed(89)
        prompts, follows = session_inputs(gen, spec.vocab_size, 3, 1000)
        reset_peak()
        run = family_run("bloom-176b", spec, prompts[:sessions],
                         follows[:sessions], n_new, {}, model_dir=tmp,
                         client_kw=chunked)
        say_peak("bloom176")
        layers, _ = load_span_params(str(tmp), 0, spec.num_hidden_layers,
                                     dtype=torch.bfloat16, device="cuda")
        local = DistributedModelForCausalLM(
            spec, load_client_params(str(tmp), device="cuda"), None,
            device="cuda",
        )
        local.config.use_chunked_head = True
        solo = served_reference(layers, spec, local, prompts[:sessions],
                                follows[:sessions], n_new)[0]
        family_check(by_path, failures, "bloom176", run, spec,
                     [t for _, t in solo], zeros,
                     family_teacher_forced(layers, spec, local,
                                           prompts[:sessions],
                                           follows[:sessions], run, n_new))
        del run, solo

        # the late prompt's 28.7 MB of hidden states take seconds through
        # zlib on each hop (run 1's first token): uncompressed, its chunks
        # reach the servers while the others still decode
        chunk = 32
        reset_peak()
        with env_set("BBTPU_BATCH_WINDOW_MS", "20"), \
                env_set("BBTPU_WIRE_COMPRESSION", "0"):
            run = family_run(
                "bloom-176b-mixed", spec, prompts, follows, n_new,
                {"max_batch": 8, "mixed_batch": True,
                 "prefill_chunk": chunk},
                model_dir=tmp, late=True, client_kw=chunked,
            )
            say_peak("bloom176_mixed")
            held = family_teacher_forced(layers, spec, local, prompts,
                                         follows, run, n_new, chunk=chunk)
        mixed_check(by_path, failures, "bloom176_mixed", run, spec, held,
                    dense=True)
        del layers, local, run
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()

    say(f"[bloom] phase took {time.perf_counter() - t_phase:.1f} s")
    say(card_line())
    if failures:
        raise AssertionError("bloom runs failed: " + "; ".join(failures))
    return by_path


def falcon_bytes(spec) -> dict:
    """The byte reckoning of a Falcon spec in bf16: a layer (q, k, v and o,
    the 4h MLP's two matrices, one or two LayerNorms with biases), the
    whole model's layers, the embedding (the head is its view) and the KV a
    token a layer (GB, MB, B)."""
    d, n = spec.hidden_size, spec.num_hidden_layers
    q = spec.num_attention_heads * spec.head_dim
    kv = spec.num_key_value_heads * spec.head_dim
    norms = 2 * d * spec.num_ln_in_parallel_attn
    layer = (2 * d * q + 2 * d * kv + 2 * d * spec.intermediate_size
             + norms) * 2
    return {
        "layer_mb": layer / 1e6,
        "layers_gb": n * layer / 1e9,
        "embed_and_head_mb": spec.vocab_size * d * 2 / 1e6,
        "kv_b_a_token_a_layer": 2 * kv * 2,
    }


def phase_falcon() -> dict:
    """Phase 14: the Falcon family through the port's registry (published
    configs, random bf16 weights: LayerNorms with biases, bias-free
    projections, the parallel residual, a tied head), each run served by
    port BlockServers and the port client, launch counts reset and read
    around each run's sessions (paths "falcon7b", "falcon7b_dn",
    "falcon40b", "falcon40b_mixed"). The five kernels take any GQA group:
    Falcon-7B's 71 query heads over one KV head and Falcon-40B's 128 over
    8 run on them, as in the JAX package.

    (a) Falcon-7B at published width and all 32 layers (71 heads of 64
        over one KV head, vocab 65024), [0, 16) + [16, 32), `max_batch=1`:
        2 sessions of 32 tokens from 1000-token prompts and a 16-token
        follow-up with 2 more (16 x 71 query rows: inside the chunk
        kernel's 2048-row budget). Tokens and last hidden states bit for
        bit the sessions solo on one executor, held teacher-forced against
        an f32 truth; flash 2 a layer a session (512 + 488), paged decode
        32 and paged chunk 1 (the follow-up). Then the same sessions with
        `server_decode=True` on one [0, 32) server given the client's
        parameters (the fused decode loop with the LayerNorm head):
        tokens identical to the per-step run, every decode_n call fused,
        decode launches the layers x the server's decode_n steps.
    (b) Falcon-40B at published width (128 heads of 64 over 8, the new
        decoder architecture's two LayerNorms), 2 of 60 layers, written as
        a `falcon` checkpoint in HF's grouped fused-QKV layout: servers
        built from the directory over [0, 1) + [1, 2), the client from
        `from_pretrained`; run 1 as (a), tokens and hidden states bit for
        bit an in-process solo executor over the checkpoint, held against
        an f32 truth, launches as (a); run 2 with `mixed_batch=True`,
        `prefill_chunk=8` (a chunk and the decode rows within the ragged
        kernel's 2048 rows x heads: 16 rows at 128 heads),
        `max_batch=8`, BBTPU_PAGED_MIN_CONTEXT=0, a 20 ms gather window,
        the wire uncompressed (BBTPU_WIRE_COMPRESSION=0), 8-token
        follow-ups (one chunk each) and a third session sent once the two
        have decoded 8 tokens: the ragged kernel at group 16, launches
        equal to the servers' counters, held teacher-forced.

    Prints the byte reckoning, each run's time to first token, per-token
    medians and peak allocated memory, the phase's seconds, and the card's
    name and power limit; returns the launches by path."""
    import gc
    import shutil
    import tempfile

    import torch

    from bloombee_tpu_torch.client import DistributedModelForCausalLM
    from bloombee_tpu_torch.models.checkpoint import (
        load_client_params,
        load_span_params,
    )

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    say(f"[falcon] {torch.cuda.memory_allocated() / 2**30:.2f} GiB "
        f"allocated before the phase")
    torch.backends.cuda.matmul.allow_tf32 = False
    by_path, failures = {}, []
    n_new, sessions = 32, 2

    def bytes_line(path, spec):
        say(f"[{path}] bytes " + json.dumps(
            {k: round(v, 4) for k, v in falcon_bytes(spec).items()}
        ))

    def served_launches(spec):
        per = spec.num_hidden_layers * sessions
        return {**dict.fromkeys(KERNELS, 0), "flash_attention": 2 * per,
                "paged_decode_attention": n_new * per,
                "paged_chunk_attention": per}

    def bitwise(path, held):
        if not held["bit_for_bit"]:
            failures.append(f"{path}: hidden states not bit for bit the "
                            f"solo executor's")

    def follow_ups(gen, vocab, n, t):
        return torch.randint(0, vocab, (n, t), generator=gen,
                             device="cuda")

    # (a) Falcon-7B, all 32 layers
    _, spec = family_config("falcon-7b", 32)
    bytes_line("falcon7b", spec)
    layers, client, gen = random_model(spec, torch.bfloat16, seed=97)
    torch.cuda.synchronize()
    say(f"[falcon7b] Falcon-7B bf16, {spec.num_hidden_layers} layers, "
        f"H={spec.num_attention_heads} Hkv={spec.num_key_value_heads} "
        f"hd={spec.head_dim}, {torch.cuda.memory_allocated() / 2**30:.2f} "
        f"GiB on the card")
    prompts = session_inputs(gen, spec.vocab_size, sessions, 1000)[0]
    follows = follow_ups(gen, spec.vocab_size, sessions, 16)
    local = DistributedModelForCausalLM(spec, client, None, device="cuda")
    reset_peak()
    run = family_run("falcon-7b", spec, prompts, follows, n_new, {},
                     layers=layers, client=client)
    say_peak("falcon7b")
    solo = served_reference(layers, spec, local, prompts, follows, n_new)[0]
    held = family_teacher_forced(layers, spec, local, prompts, follows, run,
                                 n_new)
    family_check(by_path, failures, "falcon7b", run, spec,
                 [t for _, t in solo], served_launches(spec), held)
    bitwise("falcon7b", held)
    del solo
    reset_peak()
    dn = family_run(
        "falcon-7b-dn", spec, prompts, follows, n_new,
        {"client_params": client}, layers=layers, client=client,
        spans=((0, spec.num_hidden_layers),),
        client_kw={"server_decode": True, "server_decode_chunk": 32},
    )
    say_peak("falcon7b_dn")
    info = dn["infos"][0]
    want = {**served_launches(spec), "paged_decode_attention":
            spec.num_hidden_layers * info["decode_n_steps"]}
    family_check(by_path, failures, "falcon7b_dn", dn, spec, run["tokens"],
                 want)
    say(f"[falcon7b_dn] decode_n calls {info['decode_n_calls']}, fused "
        f"{info['decode_n_fused_calls']}, steps {info['decode_n_steps']}")
    if not info["decode_n_fused_calls"] == info["decode_n_calls"] > 0:
        failures.append("falcon7b_dn: not every decode_n call fused")
    del layers, client, local, run, dn
    gc.collect()
    torch.cuda.empty_cache()

    # (b) Falcon-40B's width, 2 layers, from a checkpoint
    config, spec = family_config("falcon-40b", 2)
    bytes_line("falcon40b", spec)
    tmp = pathlib.Path(tempfile.mkdtemp(prefix="bbtpu-falcon40b-"))
    try:
        t0 = time.perf_counter()
        write_checkpoint(tmp, spec, seed=101, config=config)
        say(f"[falcon40b] checkpoint written in "
            f"{time.perf_counter() - t0:.2f} s")
        gen = torch.Generator(device="cuda").manual_seed(103)
        prompts = session_inputs(gen, spec.vocab_size, 3, 1000)[0]
        follows = follow_ups(gen, spec.vocab_size, 3, 16)
        reset_peak()
        run = family_run("falcon-40b", spec, prompts[:sessions],
                         follows[:sessions], n_new, {}, model_dir=tmp)
        say_peak("falcon40b")
        layers, _ = load_span_params(str(tmp), 0, spec.num_hidden_layers,
                                     dtype=torch.bfloat16, device="cuda")
        if not all("mlp_layernorm" in p for p in layers):
            failures.append("falcon40b: the loader dropped ln_mlp")
        local = DistributedModelForCausalLM(
            spec, load_client_params(str(tmp), device="cuda"), None,
            device="cuda",
        )
        solo = served_reference(layers, spec, local, prompts[:sessions],
                                follows[:sessions], n_new)[0]
        held = family_teacher_forced(layers, spec, local, prompts[:sessions],
                                     follows[:sessions], run, n_new)
        family_check(by_path, failures, "falcon40b", run, spec,
                     [t for _, t in solo], served_launches(spec), held)
        bitwise("falcon40b", held)
        del run, solo

        # uncompressed, the late prompt's 16.4 MB reach the servers while
        # the others still decode (through zlib they arrived after the
        # others had decoded, and nothing mixed)
        chunk = 8
        follows = follows[:, :chunk].contiguous()
        reset_peak()
        with env_set("BBTPU_PAGED_MIN_CONTEXT", "0"), \
                env_set("BBTPU_BATCH_WINDOW_MS", "20"), \
                env_set("BBTPU_WIRE_COMPRESSION", "0"):
            run = family_run(
                "falcon-40b-mixed", spec, prompts, follows, n_new,
                {"max_batch": 8, "mixed_batch": True,
                 "prefill_chunk": chunk},
                model_dir=tmp, late=True,
            )
            say_peak("falcon40b_mixed")
            held = family_teacher_forced(layers, spec, local, prompts,
                                         follows, run, n_new, chunk=chunk)
        mixed_check(by_path, failures, "falcon40b_mixed", run, spec, held)
        del layers, local, run
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()

    say(f"[falcon] phase took {time.perf_counter() - t_phase:.1f} s")
    say(card_line())
    if failures:
        raise AssertionError("falcon runs failed: " + "; ".join(failures))
    return by_path


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
    t_start = time.perf_counter()

    def timed(label, fn, *args):
        out = fn(*args)
        say(f"[timing] {label} done at {time.perf_counter() - t_start:.1f} "
            f"s")
        return out

    try:
        timed("phase 1 (build)", phase_build)
        kernels = timed("phase 2 (kernels)", phase_kernels)
        if args.quick:
            say(json.dumps({"kernels": kernels}))
            return 3
        timed("phase 3 (f32 path)", phase_f32_path)
        torch.cuda.empty_cache()
        by_path = timed("phases 4-9 (Llama-3-8B)", phase_serving,
                        args.profile)
        for label, phase in (("phase 10 (families)", phase_families),
                             ("phase 11 (gemma)", phase_gemma),
                             ("phase 12 (moe)", phase_moe),
                             ("phase 13 (bloom)", phase_bloom),
                             ("phase 14 (falcon)", phase_falcon)):
            by_path.update(timed(label, phase))
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

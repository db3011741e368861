"""SpanExecutor: host-side orchestration around the span step (port of
bloombee_tpu/runtime/executor.py: `prefill`, `prefill_chunk(ed)`, `decode`,
the ragged dispatch `ragged_group` with its delegations `decode_group`,
`mixed_group` and `tree_group`, `fetch` and `_step`).

Every step is padded to the JAX package's pow2 buckets — batch (or ragged
rows and sequences), step tokens and cache pages — so each bucket can later
become one captured CUDA graph. The attention route follows the JAX
package's eligibility rules: the paged kernels for T=1 steps (dense or int4
arena) and for short (T*H <= 2048) multi-token steps over a dense arena
once the bucketed context reaches BBTPU_PAGED_MIN_CONTEXT, the flash kernel
for prefill buckets of 128+ tokens, the dense path otherwise; the ragged
kernel for a ragged step of at most 2048 rows x heads over a dense arena
past the same context threshold, the dense `attend_ragged` otherwise. On a
CUDA device those routes launch the Hopper kernels; on the CPU (tests) the
kernels' plain versions run. A kernel failure raises: nothing retries on
another route.

The CUDA kernels take fewer shapes than the Pallas ones (head_dim 64 or
128, f32 or bf16; any GQA group H/Hkv, as the Pallas kernels: `supports`
beside each wrapper's constants). A step outside that domain, or of a spec with an attention
logit soft-cap (Gemma2) or ALiBi (Bloom; no kernel has either, in either
package), takes the dense route, on the CPU as on the card: the route is a function of the
spec, the dtype and the buckets alone, decided before any launch.

The thresholds are the JAX package's TPU-derived defaults; the port's own
come from measurements on the card in a later slice.
"""

from __future__ import annotations

import numpy as np
import torch

from bloombee_tpu_torch.kv.arena import write_plan
from bloombee_tpu_torch.kv.cache_manager import CacheHandle, CacheManager
from bloombee_tpu_torch.models.spec import ModelSpec
from bloombee_tpu_torch.ops.cuda import flash_attention as cuda_flash
from bloombee_tpu_torch.ops.cuda import paged_attention as cuda_paged
from bloombee_tpu_torch.runtime.layer_body import unsupported
from bloombee_tpu_torch.runtime.step import span_step, span_step_ragged
from bloombee_tpu_torch.utils import env
from bloombee_tpu_torch.utils.device import resolve_device

env.declare(
    "BBTPU_PAGED_MIN_CONTEXT", int, 512,
    "use the paged kernels only when the bucketed context is at least this "
    "many tokens (TPU-derived default, not yet measured on the GPU)",
)
env.declare(
    "BBTPU_PREFILL_CHUNK", int, 0,
    "stall-free scheduling (Sarathi-Serve): split prefills into chunks of "
    "at most this many tokens, each a separate compute-queue task so "
    "queued decode steps run between chunks (0 = monolithic prefill, one "
    "queue task for the whole prompt). Rounded to a power of two so every "
    "chunk lands in the same bucket",
)


def next_pow2(n: int, floor: int = 1) -> int:
    v = floor
    while v < n:
        v *= 2
    return v


def plan_prefill_chunks(
    t: int, budget: int, cap: int | None = None
) -> list[tuple[int, int]]:
    """Split a t-token prefill into [start, end) spans of at most `budget`
    tokens, the budget rounded DOWN to a power of two (and halved until it
    is at most `cap`) so every full chunk lands in the same bucket.
    budget <= 0 or t <= budget: one whole-prompt span."""
    if budget <= 0 or t <= budget:
        return [(0, t)]
    b = next_pow2(int(budget))
    if b > budget:
        b //= 2
    if cap is not None:
        while b > cap:
            b //= 2
    b = max(1, b)
    if t <= b:
        return [(0, t)]
    return [(s, min(s + b, t)) for s in range(0, t, b)]


class SpanExecutor:
    def __init__(
        self,
        params: list[dict],  # per-layer params of the span's layers
        spec: ModelSpec,
        manager: CacheManager,
        max_chunk_tokens: int = 512,
        compute_dtype=torch.bfloat16,
        start_block: int = 0,
        device="cuda",
    ):
        self.device = resolve_device(device)
        if manager.device != self.device:
            raise ValueError(
                f"cache manager on {manager.device}, executor on "
                f"{self.device}"
            )
        reason = unsupported(spec)
        if reason is not None:
            raise ValueError(f"span serving does not cover {reason}")
        if len(params) != manager.num_layers:
            raise ValueError(
                f"{len(params)} layers of params, {manager.num_layers} in "
                "the arena"
            )
        self.params = params
        self.spec = spec
        self.manager = manager
        # per-layer sliding windows, indexed by ABSOLUTE block id
        self.windows = tuple(
            spec.window_for_layer(start_block + i)
            for i in range(manager.num_layers)
        )
        self.max_chunk_tokens = max_chunk_tokens
        self.compute_dtype = compute_dtype
        self.start_block = start_block
        self.page_size = manager.page_size
        self.paged_min_context = env.get("BBTPU_PAGED_MIN_CONTEXT")
        # the CUDA kernels' shape domain: outside it every route is dense.
        # The kernels have no logit soft-cap and no ALiBi bias, so a
        # soft-capped (Gemma2) or ALiBi (Bloom) spec stays dense inside the
        # domain too, as the JAX gates keep it
        geometry = (
            spec.num_attention_heads, spec.num_key_value_heads,
            spec.head_dim, compute_dtype,
        )
        kernels_ok = not spec.attn_logit_softcap and not spec.alibi
        self.paged_supported = kernels_ok and cuda_paged.supports(*geometry)
        self.flash_supported = kernels_ok and cuda_flash.supports(*geometry)

    # ------------------------------------------------------------------ steps
    def prefill(
        self,
        handle: CacheHandle,
        hidden,  # [B, T, D] tensor or numpy array
        commit: bool = True,
        layers: tuple[int, int] | None = None,
        fetch: bool = True,
    ):
        """Full-sequence prefill in chunks of at most `max_chunk_tokens`
        (bounds the attention working set). fetch=False keeps the result on
        the device for the caller to fetch off the compute path."""
        hidden = torch.as_tensor(hidden)
        outs = [
            self._step(
                handle, hidden[:, s : s + self.max_chunk_tokens],
                commit=commit, layers=layers, fetch=fetch,
            )
            for s in range(0, hidden.shape[1], self.max_chunk_tokens)
        ]
        return outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)

    def prefill_chunk(
        self,
        handle: CacheHandle,
        hidden,  # [B, T, D], T <= max_chunk_tokens
        commit: bool = False,
        layers: tuple[int, int] | None = None,
        fetch: bool = False,
    ):
        """One chunk of a resumable chunked prefill (the caller slices the
        prompt with `plan_prefill_chunks`). Positions carry across chunks
        through the handle's written (speculative) length; the caller
        commits once after the last chunk."""
        hidden = torch.as_tensor(hidden)
        if hidden.shape[1] > self.max_chunk_tokens:
            raise ValueError(
                f"prefill chunk of {hidden.shape[1]} tokens exceeds "
                f"max_chunk_tokens={self.max_chunk_tokens}"
            )
        return self._step(
            handle, hidden, commit=commit, layers=layers, fetch=fetch
        )

    def prefill_chunked(
        self,
        handle: CacheHandle,
        hidden,  # [B, T, D]
        chunk_tokens: int,
        commit: bool = True,
        layers: tuple[int, int] | None = None,
        fetch: bool = True,
    ):
        """Whole-prompt prefill through `prefill_chunk`, all chunks in one
        call; token-identical to `prefill` with max_chunk_tokens equal to
        the chunk size. Writes stay speculative until the last chunk; a
        failure rolls the handle back while its sequences still exist."""
        hidden = torch.as_tensor(hidden)
        spans = plan_prefill_chunks(
            hidden.shape[1], chunk_tokens, cap=self.max_chunk_tokens
        )
        try:
            outs = [
                self.prefill_chunk(
                    handle, hidden[:, s:e], commit=False, layers=layers,
                    fetch=fetch,
                )
                for s, e in spans
            ]
        except Exception:
            if self.manager.epoch_valid(handle):
                self.manager.rollback(handle)
            raise
        if commit:
            self.manager.commit(handle)
        return outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)

    def decode(
        self,
        handle: CacheHandle,
        hidden,  # [B, T, D]
        commit: bool = True,
        tree_mask=None,  # [B, T, T] bool: tree-verify step
        layers: tuple[int, int] | None = None,
        depths=None,  # [B, T] tree depths (rotary positions)
        fetch: bool = True,
    ):
        return self._step(
            handle, torch.as_tensor(hidden), commit=commit,
            tree_mask=tree_mask, layers=layers, depths=depths, fetch=fetch,
        )

    def decode_group(
        self,
        handles: list[CacheHandle],
        hiddens: list,  # per-member [b_i, t_i, D]
        layers: tuple[int, int] | None = None,
    ):
        """Row-stack several sessions' steps into ONE span dispatch
        (continuous batching over the paged arena: each row reads only its
        own pages). KV writes are speculative: the caller commits or rolls
        back the returned combined handle. A thin delegation onto
        `ragged_group`, whose pure single-token fast path is the batched
        `_step`.

        Returns (out [R, 1, D] on the device, combined handle)."""
        out, combined = self.ragged_group(handles, hiddens, layers=layers)
        return out[:, None, :], combined

    def ragged_unsupported(self, has_tree: bool = False) -> str | None:
        """Why this executor cannot run a ragged dispatch; None when it can.
        Tree rows exclude sliding-window layers: the tree mask replaces
        causality outright, and window clipping against depth-positioned
        tree tokens exists only on the solo path."""
        if has_tree and any(w > 0 for w in self.windows):
            return "sliding-window layers"
        return None

    def tree_group_unsupported(self) -> str | None:
        """Why tree-verify rows cannot join a ragged dispatch: the server's
        `spec_batch` gate, a delegation onto `ragged_unsupported`."""
        return self.ragged_unsupported(has_tree=True)

    def mixed_unsupported(self) -> str | None:
        """Why causal (decode + chunk) ragged dispatch is unavailable: the
        server's mixed-batch gate, a delegation onto `ragged_unsupported`."""
        return self.ragged_unsupported(has_tree=False)

    def mixed_group(
        self,
        handles: list[CacheHandle],
        hiddens: list,  # per-member [b_i, t_i, D]
        layers: tuple[int, int] | None = None,
    ):
        """Causal ragged dispatch: single-token decodes plus one multi-token
        prefill chunk (the Sarathi-Serve fused iteration)."""
        return self.ragged_group(handles, hiddens, layers=layers)

    def tree_group(
        self,
        handles: list[CacheHandle],
        hiddens: list,  # per-member [b_i, t_i, D]
        tree_masks: list,  # per-member [b_i, t_i, t_i] bool
        depths_list: list,  # per-member [b_i, t_i] int
        layers: tuple[int, int] | None = None,
    ):
        """Tree-verify ragged dispatch: several sessions' linearized
        speculative trees verified in one span step."""
        reason = self.ragged_unsupported(has_tree=True)
        if reason is not None:
            raise ValueError(f"tree_group unsupported: {reason}")
        return self.ragged_group(
            handles, hiddens, tree_masks=tree_masks,
            depths_list=depths_list, layers=layers,
        )

    def ragged_group(
        self,
        handles: list[CacheHandle],
        hiddens: list,  # per-member [b_i, t_i, D]
        tree_masks: list | None = None,  # per-member [b_i, t_i, t_i] bool,
        # or None for a causal member (decode rows, the prefill chunk)
        depths_list: list | None = None,  # per-member [b_i, t_i], None for
        # a causal member (positions run on from its start)
        layers: tuple[int, int] | None = None,
    ):
        """THE ragged dispatch: several sessions' rows — single-token
        decodes, linearized tree-verify rows, at most one multi-token
        prefill chunk — packed row-major into ONE pow2 bucket [1, R, D] and
        run as one span step over an ephemeral combined handle. Per-row
        (q_seq, q_pos) carry the member structure into attention. When any
        tree member is present the whole dispatch takes the tree variant,
        and causal members ride along as lower-triangular rows at
        sequential depths: exactly causality, so the fused step matches
        the members run alone.

        KV writes are speculative for every member; the caller commits,
        rolls back or truncates each member.

        Returns (out, combined handle): `out` is [R, D] on the device in
        member-major row order (b_i * t_i rows per member)."""
        n_members = len(handles)
        tree_masks = tree_masks or [None] * n_members
        depths_list = depths_list or [None] * n_members
        has_tree = any(tm is not None for tm in tree_masks)
        hiddens = [torch.as_tensor(h) for h in hiddens]
        if not has_tree and all(h.shape[1] == 1 for h in hiddens):
            # pure single-token decodes: the batched _step is this dispatch
            combined = self.manager.combine_handles(handles)
            out = self._step(
                combined, torch.cat(hiddens, dim=0), commit=False,
                layers=layers, fetch=False,
            )
            return out[:, 0], combined
        reason = self.ragged_unsupported(has_tree=has_tree)
        if reason is not None:
            raise ValueError(f"ragged_group unsupported: {reason}")
        spec = self.spec
        d = spec.hidden_size
        counts: list[int] = []
        for h in hiddens:
            b_i, t_i, d_i = h.shape
            if d_i != d:
                raise ValueError(f"hidden size {d_i} != {d}")
            counts.extend([t_i] * b_i)
        n_seqs = len(counts)
        r = sum(counts)
        # the tree variant keeps one in-step width for the whole mix
        t_max = next_pow2(max(counts)) if has_tree else 0

        combined = self.manager.combine_handles(handles)
        starts = self.manager.context_lens(combined)  # [B] before write
        slots = self.manager.write_slots_ragged(
            combined, counts, commit=False
        )  # [R]
        total_lens = self.manager.context_lens(combined)  # [B] after write

        rb = next_pow2(r)
        sb = next_pow2(n_seqs)
        pb = self._page_bucket(total_lens)
        positions = np.zeros((1, rb), dtype=np.int32)
        # padding rows own no sequence (q_seq >= B): they see no key
        q_seq = np.full((rb,), sb, dtype=np.int32)
        nt = np.zeros((sb,), dtype=np.int32)
        tree_rows = np.zeros((rb, t_max), dtype=np.int32)
        off = s_i = 0
        for h, tm, dep in zip(hiddens, tree_masks, depths_list):
            b_i, t_i, _ = h.shape
            if tm is not None:
                tm = np.asarray(tm, dtype=bool)
                dep = np.asarray(dep, dtype=np.int32)
            for row in range(b_i):
                rel = dep[row] if tm is not None else np.arange(t_i)
                positions[0, off : off + t_i] = starts[s_i] + rel
                q_seq[off : off + t_i] = s_i
                if has_tree:
                    nt[s_i] = t_i
                    # causal rows under the tree variant: token j sees
                    # in-step tokens 0..j, the lower triangle
                    tree_rows[off : off + t_i, :t_i] = (
                        tm[row] if tm is not None
                        else np.tril(np.ones((t_i, t_i), dtype=np.int32))
                    )
                off += t_i
                s_i += 1
        pt_pad = np.zeros((sb, pb), dtype=np.int32)
        pt_pad[:n_seqs] = self.manager.page_table(combined, pb)
        lens_pad = np.zeros((sb,), dtype=np.int32)
        lens_pad[:n_seqs] = total_lens
        rows, dst = write_plan(slots, self.manager.capacity_tokens, "cpu")
        tree_parts = (nt, tree_rows) if has_tree else ()
        pt_dev, pos_dev, lens_dev, q_seq_dev, rows_dev, dst_dev, *tree = (
            self._upload(
                pt_pad, positions, lens_pad, q_seq, rows.numpy(),
                dst.numpy(), *tree_parts,
            )
        )

        # ragged-kernel eligibility, as in the JAX executor (dense arena,
        # rb * H <= 2048, contexts past the paged crossover), inside the
        # kernel's shape domain
        use_kernel = bool(
            self.paged_supported
            and self.manager.quant is None
            and rb * spec.num_attention_heads <= 2048
            and pb * self.page_size >= self.paged_min_context
        )
        h_pad = torch.zeros(
            (1, rb, d), dtype=self.compute_dtype, device=self.device
        )
        h_pad[0, :r] = torch.cat([h.reshape(-1, d) for h in hiddens]).to(
            device=self.device, dtype=self.compute_dtype
        )
        arena = self.manager.arena
        out = span_step_ragged(
            self.params, arena["k"], arena["v"], h_pad,
            (rows_dev.long(), dst_dev.long()), pt_dev, pos_dev, lens_dev,
            q_seq_dev, self._layer_active(layers), *tree,
            spec=spec, page_size=self.page_size, windows=self.windows,
            use_kernel=use_kernel,
        )
        return out[0, :r], combined

    def decode_n(
        self,
        handle: CacheHandle,
        ids,  # [B] int: the input token of the first step
        n: int,
        client_params: dict,  # embed + norm + lm_head (the client's trio)
        eos_token_id: int | None = None,
        finished=None,  # [B] bool rows already at EOS
    ) -> torch.Tensor:
        """Run n greedy decode steps on the device and return the [B, n]
        selected token ids as a device tensor (the caller fetches it off
        the compute queue). `runtime/decode_loop.py` runs embed -> span ->
        norm + head -> argmax per step over plans built here, all before
        the first step. Valid only when this span is the whole model (the
        server checks) over a dense arena.

        The n steps' slots are committed up front. Each step's plan is the
        per-step path's (batch bucket, page bucket of its own length); the
        route is fixed for the call from the STARTING length's page bucket
        (the bucket the per-step path sees on the call's first step), so a
        call that starts below BBTPU_PAGED_MIN_CONTEXT stays dense like its
        per-step equivalent. A call that crosses the threshold keeps one
        route where the per-step path would switch mid-way; the routes
        agree to ~1e-5, so only an exact argmax tie at the crossing could
        differ (the JAX executor's caveat)."""
        if self.manager.quant is not None:
            raise ValueError("decode_n + quantized KV arena not supported")
        from bloombee_tpu_torch.runtime.decode_loop import (
            StepPlan,
            decode_loop_impl,
        )

        ids = torch.as_tensor(np.asarray(ids)).reshape(-1)
        b = int(ids.shape[0])
        bb = next_pow2(b)
        lens_now = self.manager.context_lens(handle)
        pb_start = self._page_bucket(lens_now + 1)
        use_paged = bool(
            self.paged_supported
            and pb_start * self.page_size >= self.paged_min_context
        )
        oob = self.manager.capacity_tokens
        parts = []
        for _ in range(int(n)):
            slots = self.manager.write_slots(handle, 1, commit=True)
            total_lens = self.manager.context_lens(handle)
            pb = self._page_bucket(total_lens)
            slots_pad = np.full((bb,), oob, dtype=np.int32)
            slots_pad[:b] = slots
            pt_pad = np.zeros((bb, pb), dtype=np.int32)
            pt_pad[:b] = self.manager.page_table(handle, pb)
            lens_pad = np.zeros((bb,), dtype=np.int32)
            lens_pad[:b] = total_lens
            pos_pad = np.zeros((bb, 1), dtype=np.int32)
            pos_pad[:b, 0] = total_lens - 1
            rows, dst = write_plan(slots_pad, oob, "cpu")
            parts.extend(
                (pt_pad, pos_pad, lens_pad, rows.numpy(), dst.numpy())
            )
        views = self._upload(*parts) if parts else []
        plans = []
        for k in range(0, len(views), 5):
            pt, pos, lens, rows, dst = views[k : k + 5]
            plans.append(StepPlan((rows.long(), dst.long()), pt, pos, lens))
        ids_pad = torch.zeros((bb,), dtype=torch.int64)
        ids_pad[:b] = ids.to(torch.int64)
        fin_pad = torch.ones((bb,), dtype=torch.bool)
        fin_pad[:b] = (
            torch.as_tensor(np.asarray(finished, dtype=bool))
            if finished is not None else False
        )
        arena = self.manager.arena
        toks = decode_loop_impl(
            client_params, self.params, arena["k"], arena["v"],
            ids_pad.to(self.device), fin_pad.to(self.device), plans,
            self._layer_active(None),
            spec=self.spec, page_size=self.page_size,
            eos_id=-1 if eos_token_id is None else int(eos_token_id),
            compute_dtype=self.compute_dtype, windows=self.windows,
            use_paged=use_paged, rows=b,
        )
        return toks[:b]

    def fetch(self, out) -> torch.Tensor:
        """Copy a fetch=False result to the host (a list of per-chunk
        results concatenates along the token axis)."""
        if isinstance(out, (list, tuple)):
            out = torch.cat(list(out), dim=1)
        return out.detach().cpu()

    # --------------------------------------------------------------- internals
    def _step(
        self,
        handle: CacheHandle,
        hidden: torch.Tensor,
        commit: bool,
        tree_mask=None,
        layers: tuple[int, int] | None = None,
        depths=None,
        fetch: bool = True,
    ):
        spec = self.spec
        b, t, d = hidden.shape
        if d != spec.hidden_size:
            raise ValueError(f"hidden size {d} != {spec.hidden_size}")

        starts = self.manager.context_lens(handle)  # [B] before write
        slots = self.manager.write_slots(handle, t, commit=commit)  # [B*T]
        total_lens = self.manager.context_lens(handle)  # [B] after write

        # buckets; tree steps keep T exact (the tree mask's key arithmetic
        # assumes the written token count equals T)
        bb = next_pow2(b)
        tb = t if (t == 1 or tree_mask is not None) else next_pow2(t)
        pb = self._page_bucket(total_lens)

        oob = self.manager.capacity_tokens  # out-of-bounds => dropped write
        slots_pad = np.full((bb, tb), oob, dtype=np.int32)
        slots_pad[:b, :t] = slots.reshape(b, t)
        positions = np.zeros((bb, tb), dtype=np.int32)
        if depths is not None:
            positions[:b, :t] = starts[:, None] + np.asarray(depths)[:, :t]
        else:
            positions[:b, :t] = (
                starts[:, None] + np.arange(t, dtype=np.int32)[None, :]
            )
        pt_pad = np.zeros((bb, pb), dtype=np.int32)
        pt_pad[:b] = self.manager.page_table(handle, pb)
        lens_pad = np.zeros((bb,), dtype=np.int32)
        lens_pad[:b] = total_lens

        # eligibility, as in the JAX executor (executor.py:1174-1221):
        # T=1 over a dense or an int4 arena, short chunks over a dense one;
        # each route only inside its kernel's shape domain
        h_heads = spec.num_attention_heads
        t1_ok = tb == 1
        chunk_ok = (
            1 < tb < 128
            and self.manager.quant is None
            and tb * h_heads <= 2048
            and (tree_mask is None or all(w == 0 for w in self.windows))
        )
        use_paged = bool(
            self.paged_supported
            and pb * self.page_size >= self.paged_min_context
            and (t1_ok or chunk_ok)
        )
        s_ctx = pb * self.page_size
        use_flash = bool(
            self.flash_supported
            and tree_mask is None
            and tb >= 128
            and tb % 128 == 0
            and s_ctx % 128 == 0
            and s_ctx >= tb
            and all(w == 0 for w in self.windows)
            and np.all(total_lens == starts + t)
        )

        # padding rows (slot == capacity) are dropped here, on the host
        rows, dst = write_plan(slots_pad.reshape(-1), oob, "cpu")
        pt_dev, pos_dev, lens_dev, rows_dev, dst_dev = self._upload(
            pt_pad, positions, lens_pad, rows.numpy(), dst.numpy()
        )

        h_pad = torch.zeros(
            (bb, tb, d), dtype=self.compute_dtype, device=self.device
        )
        h_pad[:b, :t] = hidden.to(device=self.device, dtype=self.compute_dtype)
        tm_dev = None
        if tree_mask is not None:
            tm_pad = np.zeros((bb, tb, tb), dtype=bool)
            tm_pad[:b, :t, :t] = np.asarray(tree_mask, dtype=bool)
            tm_dev = torch.from_numpy(tm_pad).to(self.device)

        arena = self.manager.arena
        out = span_step(
            self.params, arena["k"], arena["v"], h_pad,
            (rows_dev.long(), dst_dev.long()), pt_dev, pos_dev, lens_dev,
            self._layer_active(layers), tm_dev,
            spec=spec, page_size=self.page_size, windows=self.windows,
            use_flash=use_flash, use_paged=use_paged, t_real=t,
        )
        out = out[:b, :t]
        if not fetch:
            return out
        return self.fetch(out)

    def _page_bucket(self, total_lens) -> int:
        """Pow2 page bucket (at least 4) covering every sequence's pages,
        capped at the arena."""
        pages_needed = max(-(-int(n) // self.page_size) for n in total_lens)
        return min(
            next_pow2(max(pages_needed, 1), floor=4),
            self.manager.capacity_tokens // self.page_size,
        )

    def _layer_active(self, layers: tuple[int, int] | None) -> np.ndarray:
        """[L] ints: run layer l iff set (`layers` = a session's sub-span)."""
        active = np.ones((self.manager.num_layers,), dtype=np.int32)
        if layers is not None:
            active[:] = 0
            active[layers[0] : layers[1]] = 1
        return active

    def _upload(self, *parts: np.ndarray) -> list[torch.Tensor]:
        """One host->device copy of a step's int32 control arrays; returns
        a device view of each, in its own shape."""
        flat = np.concatenate([np.ravel(p) for p in parts]).astype(np.int32)
        dev = torch.from_numpy(flat).to(self.device)
        views, off = [], 0
        for p in parts:
            views.append(dev[off : off + p.size].view(p.shape))
            off += p.size
        return views

"""SpanExecutor: host-side orchestration around the span step (port of
bloombee_tpu/runtime/executor.py: `prefill`, `decode`, `decode_group`,
`fetch` and `_step`).

Every step is padded to the JAX package's pow2 buckets — batch, step tokens
and cache pages — so each bucket can later become one captured CUDA graph.
The attention route follows the JAX package's eligibility rules: the paged
kernels for T=1 steps and for short (T*H <= 2048) multi-token steps once the
bucketed context reaches BBTPU_PAGED_MIN_CONTEXT, the flash kernel for
prefill buckets of 128+ tokens, the dense path otherwise. On a CUDA device
those routes launch the Hopper kernels; on the CPU (tests) the kernels'
plain versions run. A kernel failure raises: nothing retries on another
route.

The thresholds are the JAX package's TPU-derived defaults; the port's own
come from measurements on the card in a later slice.
"""

from __future__ import annotations

import numpy as np
import torch

from bloombee_tpu_torch.kv.arena import write_plan
from bloombee_tpu_torch.kv.cache_manager import CacheHandle, CacheManager
from bloombee_tpu_torch.models.spec import ModelSpec
from bloombee_tpu_torch.runtime.step import span_step
from bloombee_tpu_torch.utils import env
from bloombee_tpu_torch.utils.device import resolve_device

env.declare(
    "BBTPU_PAGED_MIN_CONTEXT", int, 512,
    "use the paged kernels only when the bucketed context is at least this "
    "many tokens (TPU-derived default, not yet measured on the GPU)",
)


def next_pow2(n: int, floor: int = 1) -> int:
    v = floor
    while v < n:
        v *= 2
    return v


def unsupported(spec: ModelSpec) -> str | None:
    """Why this slice's layer body cannot serve `spec`; None when it can
    (Llama-structured blocks only)."""
    if spec.heterogeneous:
        return "heterogeneous head_dim layers"
    if spec.norm_type != "rms" or spec.mlp_type != "silu":
        return f"{spec.norm_type} norm / {spec.mlp_type} MLP"
    if spec.num_experts or spec.qk_norm or spec.k_eq_v_full:
        return "MoE / qk-norm / shared K=V projections"
    if spec.alibi or spec.attn_logit_softcap:
        return "ALiBi / attention logit soft-cap"
    if spec.parallel_attn or spec.sandwich_norms:
        return "parallel or sandwich residual"
    if spec.rope_local_theta and spec.rope_local_theta != spec.rope_theta:
        return "per-layer rope theta"
    return None


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
        hiddens: list,  # per-member [b_i, 1, D]
        layers: tuple[int, int] | None = None,
    ):
        """Row-stack several sessions' single-token decode steps into ONE
        span dispatch (continuous batching over the paged arena: each row
        reads only its own pages). KV writes are speculative: the caller
        commits or rolls back the returned combined handle.

        Returns (out [sum(b_i), 1, D] on the device, combined handle)."""
        hiddens = [torch.as_tensor(h) for h in hiddens]
        if any(h.shape[1] != 1 for h in hiddens):
            raise ValueError(
                "decode_group takes single-token members only in this port"
            )
        combined = self.manager.combine_handles(handles)
        out = self._step(
            combined, torch.cat(hiddens, dim=0), commit=False,
            layers=layers, fetch=False,
        )
        return out, combined

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
        arena_tokens = self.manager.capacity_tokens
        pages_needed = int(
            max(-(-int(l) // self.page_size) for l in total_lens)
        )
        pb = min(
            next_pow2(max(pages_needed, 1), floor=4),
            arena_tokens // self.page_size,
        )

        oob = arena_tokens  # out-of-bounds slot => dropped write
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
        layer_active = np.ones((self.manager.num_layers,), dtype=np.int32)
        if layers is not None:
            layer_active[:] = 0
            layer_active[layers[0] : layers[1]] = 1

        # eligibility, as in the JAX executor (executor.py:1174-1221)
        h_heads = spec.num_attention_heads
        t1_ok = tb == 1
        chunk_ok = (
            1 < tb < 128
            and tb * h_heads <= 2048
            and (tree_mask is None or all(w == 0 for w in self.windows))
        )
        use_paged = bool(
            pb * self.page_size >= self.paged_min_context
            and (t1_ok or chunk_ok)
        )
        s_ctx = pb * self.page_size
        use_flash = bool(
            tree_mask is None
            and tb >= 128
            and tb % 128 == 0
            and s_ctx % 128 == 0
            and s_ctx >= tb
            and all(w == 0 for w in self.windows)
            and np.all(total_lens == starts + t)
        )

        # one host->device copy for all int32 control data; padding rows
        # (slot == capacity) are dropped here, on the host
        rows, dst = write_plan(slots_pad.reshape(-1), oob, "cpu")
        plan = np.concatenate(
            [pt_pad.ravel(), positions.ravel(), lens_pad, rows.numpy(),
             dst.numpy()]
        ).astype(np.int32)
        plan_dev = torch.from_numpy(plan).to(self.device)
        o1 = bb * pb
        o2 = o1 + bb * tb
        o3 = o2 + bb
        o4 = o3 + len(rows)
        pt_dev = plan_dev[:o1].view(bb, pb)
        pos_dev = plan_dev[o1:o2].view(bb, tb)
        lens_dev = plan_dev[o2:o3]
        write = (plan_dev[o3:o4].long(), plan_dev[o4:].long())

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
            self.params, arena["k"], arena["v"], h_pad, write, pt_dev,
            pos_dev, lens_dev, layer_active, tm_dev,
            spec=spec, page_size=self.page_size, windows=self.windows,
            use_flash=use_flash, use_paged=use_paged, t_real=t,
        )
        out = out[:b, :t]
        if not fetch:
            return out
        return self.fetch(out)

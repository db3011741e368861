"""CacheManager: token-budget admission + the session cache lifecycle (the
core of bloombee_tpu/kv/cache_manager.py).

Kept: token-budget admission with timeout (`allocate`), handle -> per-
sequence cache state freed on context exit, speculative write / commit /
rollback / truncate over the PagedKVTable, the speculative accept
(`accept_speculative`), ragged per-sequence writes,
the combined handle of a batched step, and the int4 arena
(`quant="int4"`, an explicit argument here; the server's default comes
from BBTPU_KV_QUANT).
Left for later slices: host/disk parking, the prefix pool and
heterogeneous arenas.
"""

from __future__ import annotations

import asyncio
import contextlib
import dataclasses
import functools
import itertools
import threading
import time

import numpy as np
import torch

from bloombee_tpu_torch.kv import arena as arena_ops
from bloombee_tpu_torch.kv.paged import OutOfPages, PagedKVTable
from bloombee_tpu_torch.utils.device import resolve_device


class AllocationTimeout(RuntimeError):
    pass


def _locked(fn):
    """Serialize table mutations across the compute thread and the event
    loop."""

    @functools.wraps(fn)
    def wrapper(self, *args, **kwargs):
        with self._lock:
            return fn(self, *args, **kwargs)

    return wrapper


@dataclasses.dataclass
class CacheHandle:
    handle_id: int
    seq_ids: list[int]
    max_length: int

    @property
    def batch_size(self) -> int:
        return len(self.seq_ids)


class CacheManager:
    def __init__(
        self,
        num_layers: int,
        num_pages: int,
        page_size: int,
        n_kv_heads: int,
        head_dim: int,
        dtype=torch.bfloat16,
        device="cuda",
        quant: str | None = None,  # None | "int4"
    ):
        self.device = resolve_device(device)
        self.quant = None if quant in (None, "none") else quant
        self.table = PagedKVTable(num_pages, page_size)
        self.arena = arena_ops.make_arena(
            num_layers, num_pages, page_size, n_kv_heads, head_dim, dtype,
            self.device, quant=self.quant,
        )
        self.num_layers = num_layers
        self.page_size = page_size
        self.capacity_tokens = num_pages * page_size
        self._reserved_tokens = 0
        self._cond: asyncio.Condition | None = None
        self._seq_counter = itertools.count()
        self._handle_counter = itertools.count()
        self._lock = threading.RLock()

    @property
    def tokens_left(self) -> int:
        return self.capacity_tokens - self._reserved_tokens

    def _condition(self) -> asyncio.Condition:
        if self._cond is None:
            self._cond = asyncio.Condition()
        return self._cond

    @contextlib.asynccontextmanager
    async def allocate(
        self, batch_size: int, max_length: int, timeout: float | None = None
    ):
        """Async context manager reserving `batch_size * max_length` tokens
        (page-granular); waits until the budget fits or the timeout
        elapses, and frees everything on exit."""
        per_seq = -(-max_length // self.page_size) * self.page_size
        need = batch_size * per_seq
        if need > self.capacity_tokens:
            raise AllocationTimeout(
                f"request for {need} tokens exceeds capacity "
                f"{self.capacity_tokens}"
            )
        cond = self._condition()
        deadline = None if timeout is None else time.monotonic() + timeout
        async with cond:
            while self._reserved_tokens + need > self.capacity_tokens:
                remaining = None
                if deadline is not None:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        raise AllocationTimeout(
                            f"timed out waiting for {need} cache tokens"
                        )
                try:
                    await asyncio.wait_for(cond.wait(), remaining)
                except asyncio.TimeoutError:
                    raise AllocationTimeout(
                        f"timed out waiting for {need} cache tokens"
                    ) from None
            self._reserved_tokens += need
        handle = CacheHandle(
            handle_id=next(self._handle_counter),
            seq_ids=[next(self._seq_counter) for _ in range(batch_size)],
            max_length=max_length,
        )
        with self._lock:
            for sid in handle.seq_ids:
                self.table.add_seq(sid)
        try:
            yield handle
        finally:
            with self._lock:
                for sid in handle.seq_ids:
                    if self.table.has_seq(sid):
                        self.table.drop_seq(sid)
            async with cond:
                self._reserved_tokens -= need
                cond.notify_all()

    def write_slots(
        self, handle: CacheHandle, num_tokens: int, commit: bool = True
    ) -> np.ndarray:
        """[B * num_tokens] flat slots for this step's new tokens (batch-then-
        token order, matching hidden.reshape(B*T, ...)). Atomic across the
        batch: page availability is checked before any sequence is touched."""
        return self.write_slots_ragged(
            handle, [num_tokens] * handle.batch_size, commit=commit
        )

    @_locked
    def write_slots_ragged(
        self, handle: CacheHandle, counts: list[int], commit: bool = False
    ) -> np.ndarray:
        """write_slots with a per-sequence token count: [sum(counts)] flat
        slots, sequence-major in handle.seq_ids order (the ragged packing,
        where a decode member writes 1 token and a prefill chunk its whole
        chunk). Atomic like write_slots: page availability is checked for
        all members before any is touched."""
        if len(counts) != len(handle.seq_ids):
            raise ValueError(
                f"{len(counts)} counts for {len(handle.seq_ids)} sequences"
            )
        table = self.table
        need = 0
        for sid, n in zip(handle.seq_ids, counts):
            st = table.seq(sid)
            need += max(
                0, -(-(st.l_seq + int(n)) // self.page_size) - st.num_pages
            )
        if need > table.free_pages:
            raise OutOfPages(
                f"write needs {need} pages, only {table.free_pages} free"
            )
        return np.concatenate(
            [
                table.assign_write_slots(sid, int(n), commit=commit)
                for sid, n in zip(handle.seq_ids, counts)
            ]
        )

    @_locked
    def truncate_speculative(
        self, handle: CacheHandle, lengths: list[int]
    ) -> None:
        """Partial rollback to a pre-dispatch l_seq snapshot."""
        for sid, length in zip(handle.seq_ids, lengths):
            self.table.truncate_speculative(sid, int(length))

    def page_table(self, handle: CacheHandle, max_pages: int) -> np.ndarray:
        return self.table.page_table(handle.seq_ids, max_pages)

    def context_lens(
        self, handle: CacheHandle, committed_only: bool = False
    ) -> np.ndarray:
        return self.table.context_lens(handle.seq_ids, committed_only)

    @_locked
    def commit(self, handle: CacheHandle, lengths: list[int] | None = None):
        for i, sid in enumerate(handle.seq_ids):
            self.table.commit(sid, None if lengths is None else lengths[i])

    @_locked
    def rollback(self, handle: CacheHandle):
        for sid in handle.seq_ids:
            self.table.rollback(sid)

    @_locked
    def accept_speculative(
        self, handle: CacheHandle, accepted_indices: list
    ) -> None:
        """Compact surviving speculative KV rows onto the committed prefix
        and commit them (the on-device replacement for the reference's async
        reorder thread, memory_cache_manager.py:2011-2160): one gather, then
        one scatter, over every layer of both slabs.

        `accepted_indices[i]` lists row i's surviving tree-relative indices
        in path order (depth 0, 1, ...). (The JAX manager first unparks the
        handle; the port has no parking yet, ROADMAP item 12.)"""
        src_all, dst_all = [], []
        for sid, idx in zip(handle.seq_ids, accepted_indices):
            st = self.table.seq(sid)
            idx = np.asarray(idx, dtype=np.int64)
            spec_slots = self.table.range_slots(sid, st.l_acc, st.l_seq)
            src_all.append(spec_slots[idx])
            dst_all.append(spec_slots[: len(idx)])
            self.table.accept(sid, len(idx))
        src = np.concatenate(src_all) if src_all else np.zeros(0, np.int32)
        dst = np.concatenate(dst_all) if dst_all else np.zeros(0, np.int32)
        keep = src != dst  # in-place rows need no move
        src, dst = src[keep], dst[keep]
        if len(src) == 0:
            return
        # the moved rows only: no bucket padding, so no out-of-bounds slot
        # ever reaches the device
        arena_ops.arena_reorder(
            self.arena["k"], self.arena["v"],
            torch.from_numpy(src.astype(np.int64)).to(self.device),
            torch.from_numpy(dst.astype(np.int64)).to(self.device),
        )

    @_locked
    def epoch_valid(self, handle: CacheHandle) -> bool:
        """True while every sequence of `handle` still holds its KV (the
        JAX package also tracks arena rebuilds, which the port does not
        have): a failed chunked prefill rolls back only then."""
        return all(self.table.has_seq(sid) for sid in handle.seq_ids)

    @_locked
    def combine_handles(self, handles: list[CacheHandle]) -> CacheHandle:
        """Merged view over several live handles for ONE batched decode
        step. Ephemeral (handle_id=-1): it borrows the members' sequences
        for one dispatch and frees nothing."""
        return CacheHandle(
            handle_id=-1,
            seq_ids=[sid for h in handles for sid in h.seq_ids],
            max_length=max(h.max_length for h in handles),
        )

"""CacheManager: token-budget admission + the session cache lifecycle (a
port of bloombee_tpu/kv/cache_manager.py).

Kept: token-budget admission with timeout (`allocate`), handle -> per-
sequence cache state freed on context exit, speculative write / commit /
rollback / truncate over the PagedKVTable, the speculative accept
(`accept_speculative`), ragged per-sequence writes, the combined handle of
a batched step, the int4 arena (`quant="int4"`, an explicit argument here;
the server's default comes from BBTPU_KV_QUANT), and the three users of
the table's shared page pool:

- the shared-prefix cache (`prefix_cache`, else BBTPU_PREFIX_CACHE):
  `adopt_prefix` maps pooled prompt pages into a new session, and
  `trim_adopted` settles the skip the client uses; copy-on-write pairs
  drain into the arena (`arena_reorder`) before the step's scatter;
- standby replication: `export_pages` gathers a session's sealed pages,
  `install_replicated` installs a primary's pages as cached pool entries;
- session leases: `lease_park` hands a stream-dead session's pages to the
  pool as evictable cached entries and returns its admission budget;
  `lease_resume` re-pins them all-or-nothing.

Left for later slices: host/disk parking with over-subscription (the
port's table always has the pool, so a lease park never needs it) and
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
from bloombee_tpu_torch.kv import prefix  # noqa: F401 (BBTPU_PREFIX_CACHE)
from bloombee_tpu_torch.kv.paged import OutOfPages, PagedKVTable
from bloombee_tpu_torch.utils import env
from bloombee_tpu_torch.utils.device import resolve_device

env.declare(
    "BBTPU_PREFIX_MAX_PAGES", int, 0,
    "cap on refcount-0 pages retained in the prefix pool "
    "(0 = bounded only by allocation pressure / LRU eviction)",
)


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
        prefix_cache: bool | None = None,  # None -> BBTPU_PREFIX_CACHE
    ):
        self.device = resolve_device(device)
        self.quant = None if quant in (None, "none") else quant
        if prefix_cache is None:
            prefix_cache = env.get("BBTPU_PREFIX_CACHE")
        self.prefix_cache = bool(prefix_cache)
        self.table = PagedKVTable(num_pages, page_size)
        if self.prefix_cache:
            self.table.max_cached_pages = env.get("BBTPU_PREFIX_MAX_PAGES")
        # prefix-cache serving counters (rpc_info)
        self.prefix_hits = 0
        self.prefix_hit_tokens = 0
        # pages installed through kv_put (replication receive side)
        self.repl_pages_installed = 0
        # probe-adopted token counts per seq, consumed by trim_adopted once
        # the prefill's final skip arrives (also the idempotency guard: a
        # retried prefill must not trim real committed tokens)
        self._adopted: dict[int, int] = {}
        # session-lease parking: seq_id -> (per-page pool keys, committed
        # length); the pages stay device-resident as refcount-0 cached
        # pool entries
        self._lease_parked: dict[int, tuple[list[str], int]] = {}
        # handles whose token reservation went back at lease-park time
        # (allocate()'s exit must not subtract it a second time)
        self._lease_released: set[int] = set()
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
                    self._adopted.pop(sid, None)
                    entry = self._lease_parked.pop(sid, None)
                    if entry is not None:
                        self.table.purge_parked(entry[0])
            async with cond:
                if handle.handle_id in self._lease_released:
                    # the reservation already went back at lease-park time
                    self._lease_released.discard(handle.handle_id)
                else:
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
        slots = np.concatenate(
            [
                table.assign_write_slots(sid, int(n), commit=commit)
                for sid, n in zip(handle.seq_ids, counts)
            ]
        )
        # copy-on-write pairs queued by the assigns land on the device
        # BEFORE the step scatters into `slots` (one stream: launch order
        # is device order)
        self._apply_pending_copies()
        return slots

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
        in path order (depth 0, 1, ...). (The JAX manager first unparks a
        host-parked handle; the port has no host parking.)"""
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

    # ------------------------------------------------------- prefix cache
    def _apply_pending_copies(self) -> None:
        """Drain the table's queued copy-on-write page pairs into one
        in-place copy over every layer of both slabs (bf16 or int4).
        Caller holds the lock (the write paths)."""
        pairs = self.table.take_pending_copies()
        if not pairs:
            return
        ps = self.page_size
        offs = np.arange(ps, dtype=np.int64)
        src = np.concatenate([s * ps + offs for s, _ in pairs])
        dst = np.concatenate([d * ps + offs for _, d in pairs])
        arena_ops.arena_reorder(
            self.arena["k"], self.arena["v"],
            torch.from_numpy(src).to(self.device),
            torch.from_numpy(dst).to(self.device),
        )

    @_locked
    def adopt_prefix(self, handle: CacheHandle, chains) -> list[int]:
        """Map each row's longest pooled prompt prefix into its (empty)
        sequence; returns per-row adopted token counts. Rows with no chain
        or non-empty state adopt nothing. Adopted pages are refcount-pinned
        until the prefill's trim_adopted settles the final skip, or session
        teardown drops them."""
        out: list[int] = []
        for sid, chain in zip(handle.seq_ids, chains):
            matched = 0
            if self.prefix_cache and chain:
                st = self.table.seq(sid)
                if not (st.l_seq or st.l_acc or st.pages):
                    matched = self.table.adopt_prefix(
                        sid, chain, max_tokens=handle.max_length
                    )
                    if matched:
                        self._adopted[sid] = matched
                elif st.hashes is None:
                    # active seq (e.g. a retried probe): just attach the
                    # chain so its committed pages publish
                    self.table.set_seq_hashes(sid, chain)
            out.append(matched)
        return out

    @_locked
    def trim_adopted(self, handle: CacheHandle, keep_tokens: int) -> None:
        """Settle a probe: shrink each adopted prefix to the chain-wide
        skip the client actually uses (min across spans, capped below the
        prompt length so the last position still computes) and record the
        hit. Idempotent: only sequences with an outstanding adoption are
        touched, so a retried prefill can't trim real tokens."""
        for sid in handle.seq_ids:
            adopted = self._adopted.pop(sid, None)
            if adopted is None:
                continue
            kept = min(keep_tokens, adopted)
            if kept < adopted:
                self.table.trim_adopted(sid, kept)
            if kept > 0:
                self.prefix_hits += 1
                self.prefix_hit_tokens += kept

    def has_adopted(self, handle: CacheHandle) -> bool:
        """True while a probe's adoption awaits its prefill's settle."""
        return any(sid in self._adopted for sid in handle.seq_ids)

    @_locked
    def prefix_stats(self) -> dict:
        """Prefix-cache observability for rpc_info (the JAX keys;
        `arena_epoch` stays 0: the port never rebuilds its arena)."""
        return {
            "prefix_hits": int(self.prefix_hits),
            "prefix_hit_tokens": int(self.prefix_hit_tokens),
            "cow_copies": int(self.table.cow_count),
            "prefix_cached_pages": int(self.table.cached_pages),
            "repl_pages_installed": int(self.repl_pages_installed),
            "arena_epoch": 0,
        }

    # ------------------------------------------------------- kv replication
    @property
    def repl_supported(self) -> bool:
        """Pages export and install byte-exact only on a dense arena (an
        int4 slab has no single canonical page layout on the wire) with
        the prefix pool there to hold them."""
        return self.prefix_cache and self.quant is None

    @_locked
    def export_pages(self, seq_id: int, lo_page: int, hi_page: int):
        """Gather sealed pages [lo_page, hi_page) of one sequence for
        replication. Returns (k_dev, v_dev, hi): device tensors of shape
        [L, n * page_size, kv, hd] (the caller copies them to the host off
        the compute thread) and the page bound actually exported, clamped
        to the fully committed (sealed) prefix. None when the sequence has
        nothing exportable (lease-parked, adoption unsettled, replication
        unsupported)."""
        if not self.repl_supported or not self.table.has_seq(seq_id):
            return None
        if seq_id in self._lease_parked or seq_id in self._adopted:
            return None
        state = self.table.seq(seq_id)
        sealed = state.l_acc // self.page_size
        hi = min(hi_page, sealed, state.num_pages)
        if hi <= max(lo_page, 0):
            return None
        slots = self.table.range_slots(
            seq_id, lo_page * self.page_size, hi * self.page_size
        )
        idx = torch.from_numpy(slots.astype(np.int64)).to(self.device)
        return (
            self.arena["k"].index_select(1, idx),
            self.arena["v"].index_select(1, idx),
            hi,
        )

    @_locked
    def install_replicated(self, hashes, k_pages, v_pages) -> int:
        """kv_put receive path: install replicated pages into the prefix
        pool as refcount-0 cached entries and scatter their bytes into the
        arena. `k_pages`/`v_pages` are host tensors [n, L, page_size, kv,
        hd] aligned with `hashes` (chain order, parents first). Pages the
        pool already holds, or that no free/cached page can back, are
        skipped; returns the number actually installed."""
        if not self.repl_supported:
            return 0
        want = (
            self.num_layers, self.page_size,
        ) + tuple(self.arena["k"].shape[2:])
        k_pages = torch.as_tensor(k_pages)
        v_pages = torch.as_tensor(v_pages)
        if (
            tuple(k_pages.shape) != (len(hashes),) + want
            or v_pages.shape != k_pages.shape
        ):
            raise ValueError(
                f"replicated page payload {tuple(k_pages.shape)} does not "
                f"match arena geometry {(len(hashes),) + want}"
            )
        pages, rows = [], []
        for i, h in enumerate(hashes):
            page = self.table.install_cached(h)
            if page is not None:
                pages.append(page)
                rows.append(i)
        if not pages:
            return 0
        ps = self.page_size
        offs = np.arange(ps, dtype=np.int64)
        slots = torch.from_numpy(
            np.concatenate([p * ps + offs for p in pages])
        ).to(self.device)
        sel = torch.tensor(rows, dtype=torch.long)
        for name, payload in (("k", k_pages), ("v", v_pages)):
            slab = self.arena[name]
            # [m, L, ps, kv, hd] -> [L, m*ps, kv, hd]
            flat = payload.index_select(0, sel).transpose(0, 1).reshape(
                slab.shape[0], len(rows) * ps, *slab.shape[2:]
            )
            slab.index_copy_(
                1, slots, flat.to(device=self.device, dtype=slab.dtype)
            )
        self.repl_pages_installed += len(pages)
        return len(pages)

    @_locked
    def extend_seq_hashes(self, handle: CacheHandle, chains) -> None:
        """Attach each row's full-history hash chain (replication keeps
        them growing past the prompt) so the primary's own sealed decode
        pages publish locally too. Extend-only: a shorter chain than the
        one on record is ignored (a stale replication message)."""
        if not self.prefix_cache:
            return
        for sid, chain in zip(handle.seq_ids, chains):
            if not chain or not self.table.has_seq(sid):
                continue
            if sid in self._lease_parked or sid in self._adopted:
                continue
            st = self.table.seq(sid)
            if st.hashes is not None and len(chain) < len(st.hashes):
                continue
            self.table.set_seq_hashes(sid, chain)

    # ------------------------------------------------------ session leases
    def _handle_need(self, handle: CacheHandle) -> int:
        """The token reservation allocate() charged for this handle."""
        per_seq = -(-handle.max_length // self.page_size) * self.page_size
        return handle.batch_size * per_seq

    async def lease_park(self, handle: CacheHandle) -> None:
        """Park a stream-dead session for the lease window: speculative
        tokens roll back, then every sequence's pages go to the prefix pool
        as refcount-0 cached entries, immediately evictable under
        allocation pressure (a parked session never pins memory) yet
        device-resident for an exact resume while memory lasts. The
        session's token reservation returns to the admission budget for
        the duration of the park."""
        with self._lock:
            for sid in handle.seq_ids:
                if not self.table.has_seq(sid) or sid in self._lease_parked:
                    continue
                self.table.rollback(sid)
                # an unsettled probe adoption parks as plain committed
                # pages (their hashes are real: resume re-pins them)
                self._adopted.pop(sid, None)
                self._lease_parked[sid] = self.table.park_seq_cached(sid)
            self._lease_released.add(handle.handle_id)
        cond = self._condition()
        async with cond:
            self._reserved_tokens -= self._handle_need(handle)
            cond.notify_all()

    async def lease_resume(self, handle: CacheHandle) -> bool:
        """Re-pin a lease-parked session on reconnect. All-or-nothing:
        True means every sequence is back exactly as parked (same pages,
        same committed lengths: zero recompute); False means some page was
        evicted and the caller treats the session as lost."""
        cond = self._condition()
        async with cond:
            if handle.handle_id in self._lease_released:
                # re-take the reservation; it may pass capacity for a
                # moment, but the pages backing the resume were evictable
                # all along, so this cannot run the arena out
                self._reserved_tokens += self._handle_need(handle)
                self._lease_released.discard(handle.handle_id)
        with self._lock:
            if not self.epoch_valid(handle):
                return False
            for sid in handle.seq_ids:
                entry = self._lease_parked.get(sid)
                if entry is None:
                    continue
                keys, l_acc = entry
                if not self.table.unpark_seq_cached(sid, keys, l_acc):
                    return False
                del self._lease_parked[sid]
            return True

    @_locked
    def lease_reclaim(self, handle: CacheHandle) -> None:
        """Final reclaim of a reaped (or unresumable) session: its
        synthetic park entries go back to the free list now; real-hash
        pages stay pooled for the prefix cache. The rest of the teardown
        (drop_seq, reservation) happens at allocate() exit."""
        for sid in handle.seq_ids:
            entry = self._lease_parked.pop(sid, None)
            if entry is not None:
                self.table.purge_parked(entry[0])

    def has_lease_parked(self, handle: CacheHandle) -> bool:
        return any(sid in self._lease_parked for sid in handle.seq_ids)

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

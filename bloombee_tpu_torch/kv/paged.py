"""Paged KV table: the host-side control plane (a copy of
bloombee_tpu/kv/paged.py).

Page-granular allocation from a LIFO free list, per-sequence page lists,
committed length `l_acc` vs written length `l_seq`, commit/rollback freeing
orphaned pages, and the speculative accept (`accept`, with `range_slots`
naming the slots the caller compacts). The table never touches tensors:
`assign_write_slots` returns flat arena slot ids (page * page_size +
offset) that the device step scatters into.

The shared-prefix pool: every page carries a refcount; fully committed
pages whose content hash is known are published into a hash-indexed pool,
and a published page whose last reference drops parks in an LRU of
reclaimable cached pages instead of the free list. A later sequence whose
prompt chain matches adopts it; allocation pressure evicts from the LRU's
cold end. A write into a shared or pooled page copies it first
(copy-on-write: the (src, dst) page pair queues for the caller's device
copy). Session leases park a sequence's pages in the same pool
(`park_seq_cached`), and replication installs pages into it
(`install_cached`).

Slot assignment, refcounts, pool keys and pending copies match the JAX
package's table call for call.
"""

from __future__ import annotations

import collections
import dataclasses

import numpy as np

DEFAULT_PAGE_SIZE = 16


class OutOfPages(RuntimeError):
    """Raised when the arena has no free pages for a reservation."""


@dataclasses.dataclass
class SeqState:
    pages: list[int]
    l_acc: int = 0  # committed token count
    l_seq: int = 0  # total written (committed + speculative)
    # prefix-cache identity: chained page hashes of this sequence's prompt
    # (kv/prefix.py) and how many leading pages have been offered to the
    # shared pool so far (publication is monotone per seq, clamped when the
    # committed prefix shrinks)
    hashes: list[str] | None = None
    published: int = 0

    @property
    def num_pages(self) -> int:
        return len(self.pages)


class PagedKVTable:
    """Page allocator + per-sequence length bookkeeping (host side).

    Prefix-cache extension (vLLM block sharing + SGLang-style reuse): every
    page carries a refcount; fully-committed pages whose content hash is
    known are *published* into a hash-indexed pool. When the last reference
    drops, a published page parks in an LRU of reclaimable cached pages
    instead of the free list — a later sequence whose prompt chain matches
    adopts it (refcount back up, prefill skipped), while allocation pressure
    evicts from the LRU's cold end. A write into a page that is shared
    (ref > 1) or still advertised in the pool triggers copy-on-write: the
    writer gets a fresh page and the (src, dst) pair is queued for the
    device-side page copy (drained by CacheManager before the step's
    scatter lands).

    The table has no lock of its own: CacheManager serializes every
    mutation under its lock.
    """

    def __init__(self, num_pages: int, page_size: int = DEFAULT_PAGE_SIZE):
        if num_pages <= 0 or page_size <= 0:
            raise ValueError("num_pages and page_size must be positive")
        self.num_pages = num_pages
        self.page_size = page_size
        self._free: list[int] = list(range(num_pages - 1, -1, -1))
        self._seqs: dict[int, SeqState] = {}
        # prefix-cache state. _pool and _page_hash are exact inverses:
        # _pool[h] == p  <=>  _page_hash[p] == h. _lru holds refcount-0
        # published pages, oldest-released first (eviction order).
        self._ref: list[int] = [0] * num_pages
        self._pool: dict[str, int] = {}
        self._page_hash: dict[int, str] = {}
        self._lru: collections.OrderedDict[int, None] = (
            collections.OrderedDict()
        )
        self._pending_copies: list[tuple[int, int]] = []
        self.cow_count = 0
        # optional cap on the cached pool (BBTPU_PREFIX_MAX_PAGES); 0 = no
        # cap beyond what allocation pressure evicts naturally
        self.max_cached_pages = 0

    # ------------------------------------------------------------- lifecycle
    @property
    def free_pages(self) -> int:
        """Allocatable pages: truly free + reclaimable cached (LRU)."""
        return len(self._free) + len(self._lru)

    @property
    def free_tokens(self) -> int:
        return self.free_pages * self.page_size

    @property
    def cached_pages(self) -> int:
        """Refcount-0 pages held in the prefix pool (LRU-evictable)."""
        return len(self._lru)

    def has_seq(self, seq_id: int) -> bool:
        return seq_id in self._seqs

    def seq(self, seq_id: int) -> SeqState:
        return self._seqs[seq_id]

    def add_seq(self, seq_id: int) -> None:
        if seq_id in self._seqs:
            raise ValueError(f"sequence {seq_id} already exists")
        self._seqs[seq_id] = SeqState(pages=[])

    def drop_seq(self, seq_id: int) -> None:
        state = self._seqs.pop(seq_id)
        for page in state.pages:
            self._release_page(page)

    # ------------------------------------------------------------ allocation
    def _pages_for(self, tokens: int) -> int:
        return -(-tokens // self.page_size)

    def _alloc_page(self) -> int:
        """One refcount-1 page: free list first, else evict the coldest
        cached page (de-publishing it — its content is about to be
        overwritten)."""
        if self._free:
            page = self._free.pop()
        elif self._lru:
            page, _ = self._lru.popitem(last=False)
            self._unpublish(page)
        else:
            raise OutOfPages("no free or cached pages left")
        self._ref[page] = 1
        return page

    def _release_page(self, page: int) -> None:
        """Drop one reference; at zero, published pages park in the cached
        LRU (warm for future adoption), unpublished pages free."""
        self._ref[page] -= 1
        assert self._ref[page] >= 0, f"page {page} refcount underflow"
        if self._ref[page] > 0:
            return
        if page in self._page_hash:
            self._lru[page] = None
            self._lru.move_to_end(page)
            if self.max_cached_pages > 0:
                while len(self._lru) > self.max_cached_pages:
                    cold, _ = self._lru.popitem(last=False)
                    self._unpublish(cold)
                    self._free.append(cold)
        else:
            self._free.append(page)

    def _unpublish(self, page: int) -> None:
        h = self._page_hash.pop(page, None)
        if h is not None:
            del self._pool[h]

    def reserve(self, seq_id: int, new_total_len: int) -> None:
        """Grow the sequence's page list to cover `new_total_len` tokens."""
        state = self._seqs[seq_id]
        need = self._pages_for(new_total_len) - len(state.pages)
        if need <= 0:
            return
        if need > self.free_pages:
            raise OutOfPages(
                f"need {need} pages, only {self.free_pages} free"
            )
        for _ in range(need):
            state.pages.append(self._alloc_page())

    # --------------------------------------------------------------- writing
    def assign_write_slots(
        self, seq_id: int, num_tokens: int, commit: bool = True
    ) -> np.ndarray:
        """Assign flat arena slots for the next `num_tokens` tokens.

        Tokens land at positions [l_seq, l_seq + num_tokens); reserves pages
        as needed. `commit=False` marks them speculative (rollback-able).
        Returns int32 flat slot ids (page * page_size + offset).
        """
        if num_tokens < 0:
            raise ValueError(f"num_tokens must be >= 0, got {num_tokens}")
        state = self._seqs[seq_id]
        start = state.l_seq
        if commit and state.l_acc != start:
            # validate BEFORE reserving: an invalid write must not mutate
            # the table (pages/lengths) on its way to the exception
            raise ValueError(
                "committed write must follow the committed prefix "
                f"(l_acc={state.l_acc}, write starts at {start})"
            )
        # copy-on-write: a write landing in a page that is shared (ref > 1)
        # or still advertised in the prefix pool must not mutate the shared
        # bytes — swap in a private copy first. Checked against the full
        # availability (reserve need + cow need) so a mid-batch OutOfPages
        # cannot leave the sequence half-diverged.
        cow_idx: list[int] = []
        if num_tokens > 0 and state.pages:
            first = start // self.page_size
            last = (start + num_tokens - 1) // self.page_size
            for i in range(first, min(last + 1, len(state.pages))):
                page = state.pages[i]
                if self._ref[page] > 1 or page in self._page_hash:
                    cow_idx.append(i)
        need = max(
            0, self._pages_for(start + num_tokens) - len(state.pages)
        )
        if need + len(cow_idx) > self.free_pages:
            raise OutOfPages(
                f"need {need + len(cow_idx)} pages "
                f"({len(cow_idx)} copy-on-write), only "
                f"{self.free_pages} free"
            )
        for i in cow_idx:
            src = state.pages[i]
            dst = self._alloc_page()
            self._pending_copies.append((src, dst))
            state.pages[i] = dst
            self._release_page(src)
            self.cow_count += 1
            # the diverged copy no longer matches the hash chain from this
            # page on: truncate so it can never be (re)published stale
            if state.hashes is not None and i < len(state.hashes):
                state.hashes = state.hashes[:i]
            state.published = min(state.published, i)
        self.reserve(seq_id, start + num_tokens)
        positions = np.arange(start, start + num_tokens)
        pages = np.asarray(state.pages, dtype=np.int64)[
            positions // self.page_size
        ]
        slots = pages * self.page_size + positions % self.page_size
        state.l_seq = start + num_tokens
        if commit:
            state.l_acc = state.l_seq
            self._publish(state)
        return slots.astype(np.int32)

    # ------------------------------------------------------ commit / rollback
    def commit(self, seq_id: int, length: int | None = None) -> None:
        """Promote speculative tokens to committed; free pages past the end.
        `length` defaults to l_seq (commit everything written)."""
        state = self._seqs[seq_id]
        if length is None:
            length = state.l_seq
        if not (state.l_acc <= length <= state.l_seq):
            raise ValueError(
                f"commit length {length} outside [{state.l_acc}, {state.l_seq}]"
            )
        state.l_acc = length
        state.l_seq = length
        self._trim(state)
        self._publish(state)

    def accept(self, seq_id: int, num_accepted: int) -> None:
        """Keep the first `num_accepted` speculative tokens (after the caller
        compacted the arena rows onto them) and discard the rest."""
        state = self._seqs[seq_id]
        if not 0 <= num_accepted <= state.l_seq - state.l_acc:
            raise ValueError(
                f"accept {num_accepted} outside speculative window "
                f"[0, {state.l_seq - state.l_acc}]"
            )
        state.l_acc += num_accepted
        state.l_seq = state.l_acc
        self._trim(state)
        self._publish(state)

    def range_slots(self, seq_id: int, start: int, end: int) -> np.ndarray:
        """Flat slot ids for positions [start, end) (must be materialized)."""
        state = self._seqs[seq_id]
        if end > len(state.pages) * self.page_size:
            raise ValueError("range beyond allocated pages")
        positions = np.arange(start, end)
        pages = np.asarray(state.pages, dtype=np.int64)[
            positions // self.page_size
        ]
        return (pages * self.page_size + positions % self.page_size).astype(
            np.int32
        )

    def rollback(self, seq_id: int) -> None:
        """Discard speculative tokens; free orphaned pages."""
        state = self._seqs[seq_id]
        state.l_seq = state.l_acc
        self._trim(state)

    def truncate_speculative(self, seq_id: int, length: int) -> None:
        """Partial rollback: drop speculative tokens past `length` but keep
        the ones below it. A failed dispatch stacked atop EARLIER
        still-speculative tokens (a mid-stream prefill chunk in a mixed
        batch) must undo only its own writes — a full rollback() would
        discard the earlier chunks too."""
        state = self._seqs[seq_id]
        if not state.l_acc <= length <= state.l_seq:
            raise ValueError(
                f"truncate length {length} outside "
                f"[{state.l_acc}, {state.l_seq}]"
            )
        state.l_seq = length
        self._trim(state)

    def reset_seq(self, seq_id: int) -> None:
        """Drop ALL tokens (committed included) and free the pages, keeping
        the sequence registered — the parking primitive."""
        state = self._seqs[seq_id]
        state.l_acc = 0
        state.l_seq = 0
        self._trim(state)

    def restore_committed(self, seq_id: int, l_acc: int) -> None:
        """Set the committed watermark without touching l_seq (unparking
        re-materializes tokens speculatively, then restores l_acc)."""
        state = self._seqs[seq_id]
        if not 0 <= l_acc <= state.l_seq:
            raise ValueError(
                f"l_acc {l_acc} outside [0, {state.l_seq}]"
            )
        state.l_acc = l_acc
        self._publish(state)

    def _trim(self, state: SeqState) -> None:
        keep = self._pages_for(max(state.l_seq, state.l_acc))
        while len(state.pages) > keep:
            self._release_page(state.pages.pop())
        state.published = min(
            state.published, state.l_acc // self.page_size
        )

    # ---------------------------------------------------------- prefix cache
    def set_seq_hashes(self, seq_id: int, hashes: list[str]) -> None:
        """Attach the prompt's page-hash chain (kv/prefix.py) so this
        sequence's fully-committed prompt pages get published to the pool
        as they commit."""
        self._seqs[seq_id].hashes = list(hashes)

    def _publish(self, state: SeqState) -> None:
        """Offer newly fully-committed hash-covered pages to the pool.

        A hash already pooled (another copy of the same content) is skipped
        — the pool keeps one canonical page per chain hash. `published` is
        monotone per call so retried commits don't re-offer."""
        if state.hashes is None:
            return
        limit = min(state.l_acc // self.page_size, len(state.hashes))
        for i in range(state.published, limit):
            h = state.hashes[i]
            page = state.pages[i]
            if h not in self._pool and page not in self._page_hash:
                self._pool[h] = page
                self._page_hash[page] = h
        state.published = max(state.published, limit)

    def match_prefix(self, hashes: list[str]) -> int:
        """Tokens of the chain currently servable from the pool (a probe —
        no state change; adoption may still race an eviction)."""
        n = 0
        for h in hashes:
            if h not in self._pool:
                break
            n += 1
        return n * self.page_size

    def adopt_prefix(
        self, seq_id: int, hashes: list[str], max_tokens: int | None = None
    ) -> int:
        """Map the longest pooled prefix of `hashes` into an EMPTY sequence.

        Adopted pages are refcounted up (pulled out of the LRU — pinned
        against eviction until released) and the sequence starts life with
        a committed prefix of the returned token count. The chain is kept so
        pages this sequence computes itself get published in turn.
        """
        state = self._seqs[seq_id]
        if state.pages or state.l_seq or state.l_acc:
            raise ValueError("adopt_prefix target must be empty")
        state.hashes = list(hashes)
        max_pages = (
            len(hashes) if max_tokens is None
            else min(len(hashes), max_tokens // self.page_size)
        )
        n = 0
        for i in range(max_pages):
            page = self._pool.get(hashes[i])
            if page is None:
                break
            state.pages.append(page)
            self._ref[page] += 1
            self._lru.pop(page, None)
            n += 1
        tokens = n * self.page_size
        state.l_acc = tokens
        state.l_seq = tokens
        state.published = n
        return tokens

    def install_cached(self, h: str) -> int | None:
        """Install one externally-supplied page under hash `h` as a
        refcount-0 cached pool entry (the replication receive path).

        The page is immediately evictable — installing can displace only
        other cached pages, never referenced ones, so replication cannot
        OOM a healthy server. Returns the page id the caller must fill
        with the hash's content, or None when the hash is already pooled
        (nothing to do) or no free/cached page is reclaimable."""
        if h in self._pool:
            return None
        if self.max_cached_pages > 0 and self.max_cached_pages <= len(
            self._lru
        ):
            # keep the cap by evicting the coldest cached page first;
            # installing at the cap must not grow the pool
            cold, _ = self._lru.popitem(last=False)
            self._unpublish(cold)
            self._free.append(cold)
        if self._free:
            page = self._free.pop()
        elif self._lru:
            page, _ = self._lru.popitem(last=False)
            self._unpublish(page)
        else:
            return None
        self._pool[h] = page
        self._page_hash[page] = h
        self._ref[page] = 0
        self._lru[page] = None
        self._lru.move_to_end(page)
        return page

    def trim_adopted(self, seq_id: int, keep_tokens: int) -> None:
        """Shrink an adopted (still-unwritten) committed prefix to
        `keep_tokens` — the span chain agreed on a smaller common hit, or
        the client keeps the last prompt position uncached so the final
        step has an output. No-op when already at or below the target."""
        state = self._seqs[seq_id]
        if keep_tokens < 0:
            raise ValueError(f"keep_tokens must be >= 0, got {keep_tokens}")
        if keep_tokens >= state.l_acc or state.l_seq != state.l_acc:
            return
        state.l_acc = keep_tokens
        state.l_seq = keep_tokens
        self._trim(state)

    # ------------------------------------------------------- session parking
    def park_seq_cached(self, seq_id: int) -> tuple[list[str], int]:
        """Hand every page of `seq_id` to the pool as refcount-0 cached
        entries (session-lease park: wire/lease layer, not host d2h).

        Pages whose content is already pool-published keep their real hash;
        the rest get a synthetic "~parked:" identity so they too land in
        the cached LRU — immediately evictable under allocation pressure
        (a parked session can never OOM the server) yet resident for a
        cheap exact resume while memory lasts. Returns (per-page keys,
        committed length) — everything `unpark_seq_cached` needs."""
        state = self._seqs[seq_id]
        keys: list[str] = []
        l_acc = state.l_acc
        for i, page in enumerate(state.pages):
            h = self._page_hash.get(page)
            if h is None:
                h = f"~parked:{seq_id}:{i}:{page}"
                self._pool[h] = page
                self._page_hash[page] = h
            keys.append(h)
            self._release_page(page)
        state.pages = []
        state.l_acc = 0
        state.l_seq = 0
        state.published = 0
        state.hashes = None
        return keys, l_acc

    def unpark_seq_cached(
        self, seq_id: int, keys: list[str], l_acc: int
    ) -> bool:
        """Re-pin a cached-parked sequence: all-or-nothing. If any page was
        evicted (or the pool invalidated by an arena rebuild) the resume is
        impossible and the caller falls back to full replay. On success the
        sequence is exactly as it was at park time — same pages, same
        committed length, zero recompute."""
        state = self._seqs[seq_id]
        if state.pages or state.l_seq or state.l_acc:
            raise ValueError("unpark_seq_cached target must be empty")
        pages: list[int] = []
        for h in keys:
            page = self._pool.get(h)
            if page is None:
                return False  # evicted — nothing pinned yet, nothing leaks
            pages.append(page)
        for h, page in zip(keys, pages):
            self._ref[page] += 1
            self._lru.pop(page, None)
            if h.startswith("~parked:"):
                # the synthetic identity served its purpose; a private page
                # must not stay adoptable under a hash nobody can match
                self._unpublish(page)
        state.pages = pages
        state.l_acc = l_acc
        state.l_seq = l_acc
        return True

    def purge_parked(self, keys: list[str]) -> int:
        """Final reclaim of a reaped session's synthetic park entries:
        still-cached "~parked:" pages drop straight to the free list (their
        content is unreachable — no prefix chain ever hashes to them).
        Real-hash pages stay cached; they remain useful to the prefix
        cache. Returns pages freed."""
        freed = 0
        for h in keys:
            if not h.startswith("~parked:"):
                continue
            page = self._pool.get(h)
            if page is not None and self._ref[page] == 0:
                self._lru.pop(page, None)
                self._unpublish(page)
                self._free.append(page)
                freed += 1
        return freed

    def take_pending_copies(self) -> list[tuple[int, int]]:
        """Drain queued copy-on-write (src_page, dst_page) pairs; the
        caller applies the device copies before the write that triggered
        them scatters."""
        out = self._pending_copies
        self._pending_copies = []
        return out

    def invalidate_pool(self) -> None:
        """Forget every cached page (arena rebuilt — device bytes are
        garbage). Cached LRU pages drop to the free list; referenced pages
        just lose their pool identity."""
        for page in self._lru:
            self._free.append(page)
        self._lru.clear()
        self._pool.clear()
        self._page_hash.clear()
        for state in self._seqs.values():
            state.published = 0
            state.hashes = None

    def counts(self) -> dict:
        """Page accounting for the leak invariant:
        free + referenced + cached == num_pages."""
        referenced = sum(1 for r in self._ref if r > 0)
        return {
            "free": len(self._free),
            "referenced": referenced,
            "cached": len(self._lru),
        }

    # ---------------------------------------------------------- device plans
    def page_table(
        self, seq_ids: list[int], max_pages: int
    ) -> np.ndarray:
        """[B, max_pages] int32 page ids, padded with 0 (masked by length)."""
        out = np.zeros((len(seq_ids), max_pages), dtype=np.int32)
        for i, sid in enumerate(seq_ids):
            pages = self._seqs[sid].pages
            if len(pages) > max_pages:
                raise ValueError(
                    f"sequence {sid} has {len(pages)} pages > bucket {max_pages}"
                )
            out[i, : len(pages)] = pages
        return out

    def context_lens(
        self, seq_ids: list[int], committed_only: bool = False
    ) -> np.ndarray:
        """Per-sequence visible lengths; `committed_only` clamps to l_acc."""
        return np.asarray(
            [
                self._seqs[s].l_acc if committed_only else self._seqs[s].l_seq
                for s in seq_ids
            ],
            dtype=np.int32,
        )

    def prefix_slots(self, seq_id: int, committed_only: bool = True) -> np.ndarray:
        """Flat slot ids of the sequence prefix, clamped to l_acc by default."""
        state = self._seqs[seq_id]
        n = state.l_acc if committed_only else state.l_seq
        positions = np.arange(n)
        pages = np.asarray(state.pages, dtype=np.int64)[
            positions // self.page_size
        ]
        return (pages * self.page_size + positions % self.page_size).astype(
            np.int32
        )

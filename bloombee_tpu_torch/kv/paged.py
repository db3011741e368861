"""Paged KV table: the host-side control plane (a copy of
bloombee_tpu/kv/paged.py without the prefix pool and the parking
primitives, which this slice does not serve).

Page-granular allocation from a LIFO free list, per-sequence page lists,
committed length `l_acc` vs written length `l_seq`, commit/rollback freeing
orphaned pages, and the speculative accept (`accept`, with `range_slots`
naming the slots the caller compacts). The table never touches tensors: `assign_write_slots`
returns flat arena slot ids (page * page_size + offset) that the device step
scatters into. Slot assignment matches the JAX package's table call for call.
"""

from __future__ import annotations

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

    @property
    def num_pages(self) -> int:
        return len(self.pages)


class PagedKVTable:
    """Page allocator + per-sequence length bookkeeping (host side). It has
    no lock of its own: CacheManager serializes every mutation."""

    def __init__(self, num_pages: int, page_size: int = DEFAULT_PAGE_SIZE):
        if num_pages <= 0 or page_size <= 0:
            raise ValueError("num_pages and page_size must be positive")
        self.num_pages = num_pages
        self.page_size = page_size
        self._free: list[int] = list(range(num_pages - 1, -1, -1))
        self._seqs: dict[int, SeqState] = {}

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def free_tokens(self) -> int:
        return self.free_pages * self.page_size

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
        self._free.extend(state.pages)

    def _pages_for(self, tokens: int) -> int:
        return -(-tokens // self.page_size)

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
            state.pages.append(self._free.pop())

    def assign_write_slots(
        self, seq_id: int, num_tokens: int, commit: bool = True
    ) -> np.ndarray:
        """Flat arena slots for the next `num_tokens` tokens, at positions
        [l_seq, l_seq + num_tokens), reserving pages as needed.
        `commit=False` marks them speculative (rollback-able)."""
        if num_tokens < 0:
            raise ValueError(f"num_tokens must be >= 0, got {num_tokens}")
        state = self._seqs[seq_id]
        start = state.l_seq
        if commit and state.l_acc != start:
            # validate BEFORE reserving: an invalid write must not mutate
            # the table on its way to the exception
            raise ValueError(
                "committed write must follow the committed prefix "
                f"(l_acc={state.l_acc}, write starts at {start})"
            )
        self.reserve(seq_id, start + num_tokens)
        positions = np.arange(start, start + num_tokens)
        pages = np.asarray(state.pages, dtype=np.int64)[
            positions // self.page_size
        ]
        slots = pages * self.page_size + positions % self.page_size
        state.l_seq = start + num_tokens
        if commit:
            state.l_acc = state.l_seq
        return slots.astype(np.int32)

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
        the ones below it."""
        state = self._seqs[seq_id]
        if not state.l_acc <= length <= state.l_seq:
            raise ValueError(
                f"truncate length {length} outside "
                f"[{state.l_acc}, {state.l_seq}]"
            )
        state.l_seq = length
        self._trim(state)

    def _trim(self, state: SeqState) -> None:
        keep = self._pages_for(max(state.l_seq, state.l_acc))
        while len(state.pages) > keep:
            self._free.append(state.pages.pop())

    def page_table(self, seq_ids: list[int], max_pages: int) -> np.ndarray:
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

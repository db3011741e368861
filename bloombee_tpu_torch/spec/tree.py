"""Draft-tree structures: linearization, ancestor masks, depths (a copy of
bloombee_tpu/spec/tree.py: numpy only, shared by the client's drafter and
the server's pruner).

Port of the invariants of the reference's bloombee/models/llama/
spe_dec_tree.py: linearized node order, the O(n*depth) parent-walk ancestor
matrix (:139-179 — the arch-reform replacement for the O(n^3) matmul), and
incremental tree attention masks (:180-363). Nodes are NEW draft tokens only;
parent == -1 means "child of the last committed token".
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class DraftTree:
    tokens: np.ndarray  # [T] int64 draft token ids, linearized
    parents: np.ndarray  # [T] int32, index into tokens; -1 = root level

    def __post_init__(self):
        self.tokens = np.asarray(self.tokens, dtype=np.int64)
        self.parents = np.asarray(self.parents, dtype=np.int32)
        if np.any(self.parents >= np.arange(len(self.parents))):
            raise ValueError("parents must precede children in linear order")

    @property
    def size(self) -> int:
        return len(self.tokens)

    def depths(self) -> np.ndarray:
        """[T] depth of each node (root level = 0); O(n*depth) parent walk."""
        d = np.zeros(self.size, dtype=np.int32)
        for i in range(self.size):
            p = self.parents[i]
            d[i] = 0 if p < 0 else d[p] + 1
        return d

    def ancestors_or_self(self) -> np.ndarray:
        """[T, T] bool: A[i, j] = node j is an ancestor of i (or i itself)."""
        t = self.size
        a = np.zeros((t, t), dtype=bool)
        for i in range(t):
            j = i
            while j >= 0:
                a[i, j] = True
                j = self.parents[j]
        return a

    def path_to(self, node: int) -> list[int]:
        """Linear indices from root level down to `node` inclusive."""
        path = []
        j = node
        while j >= 0:
            path.append(j)
            j = self.parents[j]
        return path[::-1]

    def children_of(self, node: int) -> np.ndarray:
        """Linear indices of `node`'s children (-1 for the root level)."""
        return np.nonzero(self.parents == node)[0]


def tree_attention_mask(tree: DraftTree) -> np.ndarray:
    """[T, T] visibility among the tree's tokens (ancestor-or-self).

    The committed-prefix part of the mask is handled inside the span step
    (runtime/step.py _attend_paged: prefix keys always visible)."""
    return tree.ancestors_or_self()


def pruned_step_arrays(
    mask: np.ndarray,  # [B, T, T] full tree mask
    depths: np.ndarray,  # [B, T]
    keep: np.ndarray,  # [B, K] kept linear indices, -1 padded
) -> tuple[np.ndarray, np.ndarray]:
    """Tree mask + depths restricted to kept nodes per row (what a pruning
    span forwards downstream — reference block_functions.py:423-531 works in
    the inverse direction, restoring pruned rows). Padded entries get an
    all-False mask row (they still see the committed prefix in the step) and
    depth 0."""
    b, k = keep.shape
    mask_k = np.zeros((b, k, k), dtype=bool)
    depths_k = np.zeros((b, k), dtype=np.int32)
    for i in range(b):
        valid = np.nonzero(keep[i] >= 0)[0]
        idx = keep[i][valid]
        mask_k[i][np.ix_(valid, valid)] = mask[i][np.ix_(idx, idx)]
        depths_k[i][valid] = depths[i][idx]
    return mask_k, depths_k


def chain_tree(tokens: np.ndarray) -> DraftTree:
    """Degenerate tree: a single chain (classic draft-K speculative decode)."""
    t = len(tokens)
    return DraftTree(tokens=tokens, parents=np.arange(-1, t - 1, dtype=np.int32))

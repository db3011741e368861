"""Server-side draft-tree pruning: MidLMHead + the probability pruner (the
port of bloombee_tpu/spec/pruner.py's "simple" method).

Port of the reference's speculative_pruner/ (pruner_manager.py:13-186,
simple_probability_pruner.py:11-241, mid_layer_LM_head.py): a linear head
scores mid-network hidden states of draft-tree nodes; children whose
renormalized parent-conditioned probability clears a threshold are kept,
the rest are pruned before the remaining (deeper) blocks run.

Not ported: the online trainers (`MidHeadTrainer.train_step` and
`save`, `NeuralPrunerTrainer`) and the learned "neural" method, which
learn by gradient (ROADMAP Queue 1 item 17, training). `MidHeadTrainer`
here only reads a saved head (`load`, `ckpt_path`); `PrunerManager`
refuses method="neural" naming that item.
"""

from __future__ import annotations

import dataclasses
import heapq

import numpy as np
import torch

from bloombee_tpu_torch.ops.norms import rms_norm
from bloombee_tpu_torch.spec.tree import DraftTree


class MidLMHead:
    """Linear head over mid-network hidden states. An optional RMS norm
    weight is applied first ("logit lens"): raw mid-layer hidden states
    have a growing scale that makes untrained-head softmaxes
    uninformative."""

    def __init__(self, weight: torch.Tensor, norm=None, eps: float = 1e-5):
        self.weight = weight  # [D, V]
        self.norm = norm  # [D] or None
        self.eps = eps

    @torch.no_grad()
    def probs(self, hidden) -> np.ndarray:
        """hidden [N, D] -> softmax rows [N, V] (f32 numpy). The product
        promotes as JAX's does (f32 hidden against bf16 weights: an f32
        product), softmax in f32."""
        h = torch.as_tensor(hidden).to(self.weight.device)
        if self.norm is not None:
            h = rms_norm(h, self.norm, self.eps)
        dt = torch.promote_types(h.dtype, self.weight.dtype)
        logits = (h.to(dt) @ self.weight.to(dt)).float()
        return torch.softmax(logits, dim=-1).cpu().numpy()


def _cap_kept_by_score(
    tree: DraftTree, keep: np.ndarray, scores: np.ndarray, cap: int
) -> np.ndarray:
    """Shrink a keep mask to `cap` nodes by repeatedly dropping the
    lowest-SCORING kept leaf (a kept node with no kept children), so the
    survivors are the best-scoring tree-consistent subset.

    Heap-driven: dropping a leaf may expose its parent as the new
    lowest-scoring leaf, so each drop is a pop + at most one push,
    O(k log k) in all. Ties resolve by (score, index)."""
    n_kept = int(keep.sum())
    if n_kept <= cap:
        return keep
    kept_child_count = np.zeros(tree.size, dtype=np.int32)
    for c in np.nonzero(keep)[0]:
        parent = int(tree.parents[c])
        if parent >= 0 and keep[parent]:
            kept_child_count[parent] += 1
    heap = [
        (float(scores[i]), int(i))
        for i in np.nonzero(keep)[0]
        if kept_child_count[i] == 0
    ]
    heapq.heapify(heap)
    while n_kept > cap and heap:
        _, i = heapq.heappop(heap)
        if not keep[i] or kept_child_count[i] != 0:
            continue  # stale entry (node re-pushed or no longer a leaf)
        keep[i] = False
        n_kept -= 1
        parent = int(tree.parents[i])
        if parent >= 0 and keep[parent]:
            kept_child_count[parent] -= 1
            if kept_child_count[parent] == 0:
                heapq.heappush(heap, (float(scores[parent]), parent))
    return keep


@dataclasses.dataclass
class SimpleProbabilityPruner:
    """Keep children whose parent-conditioned renormalized probability
    clears `threshold` (reference simple_probability_pruner.py)."""

    threshold: float = 0.05
    max_keep: int | None = None

    def keep_indices(
        self,
        tree: DraftTree,
        probs: np.ndarray,  # [T, V]: the head's distribution after node i
        root_probs: np.ndarray,  # [V]: after the last committed token
    ) -> np.ndarray:
        """Kept linear indices, padded with -1 to max_keep (or tree size).
        A node is kept iff its own conditional prob clears the threshold
        AND its parent is kept (subtree pruning)."""
        t = tree.size
        keep = np.zeros(t, dtype=bool)
        node_p = np.zeros(t, dtype=np.float64)  # for score-ordered capping
        # renormalize within each sibling group
        for parent in [-1] + list(range(t)):
            children = tree.children_of(parent)
            if len(children) == 0:
                continue
            dist = root_probs if parent < 0 else probs[parent]
            child_p = np.asarray(
                [dist[int(tree.tokens[c])] for c in children], np.float64
            )
            z = child_p.sum()
            if z <= 0:
                continue
            child_p = child_p / z
            for c, p in zip(children, child_p):
                parent_ok = parent < 0 or keep[parent]
                keep[c] = parent_ok and (p >= self.threshold)
                node_p[c] = p
        cap = self.max_keep or t
        keep = _cap_kept_by_score(tree, keep, node_p, cap)
        kept = np.nonzero(keep)[0]
        out = np.full(cap, -1, dtype=np.int32)
        out[: len(kept)] = kept
        return out


class MidHeadTrainer:
    """Reader of a saved MidLMHead checkpoint (.npz with `weight`, optional
    `norm`, `eps` and `steps`, as the JAX package's MidHeadTrainer.save
    writes it): the head and the train steps it had taken."""

    def __init__(self, head: MidLMHead, steps: int = 0):
        self.head = head
        self.steps = steps

    @staticmethod
    def ckpt_path(path: str) -> str:
        """np.savez appends .npz when missing: normalize so save and the
        resume-existence check agree on one file name."""
        return path if path.endswith(".npz") else path + ".npz"

    @classmethod
    def load(cls, path: str, dtype=None, device="cuda") -> "MidHeadTrainer":
        from bloombee_tpu_torch.utils.device import resolve_device

        device = resolve_device(device)
        data = np.load(cls.ckpt_path(path))

        def tensor(name):
            t = torch.from_numpy(np.asarray(data[name], dtype=np.float32))
            return t.to(device=device, dtype=dtype or torch.float32)

        norm = tensor("norm") if "norm" in data else None
        head = MidLMHead(tensor("weight"), norm, float(data["eps"]))
        return cls(head, int(data["steps"]))


class PrunerManager:
    """Lazy head init + method dispatch (reference pruner_manager.py and
    pruner_factory.py): owns the MidLMHead and the "simple" probability
    pruner."""

    def __init__(self, threshold: float = 0.05, method: str = "simple"):
        if method == "neural":
            raise NotImplementedError(
                "the neural pruner learns by gradient, which the port does "
                "not have yet (ROADMAP Queue 1 item 17, training)"
            )
        if method != "simple":
            raise ValueError(f"unknown pruner method {method!r}")
        self._head: MidLMHead | None = None
        self.method = method
        self._pruner = SimpleProbabilityPruner(threshold=threshold)

    def set_request_threshold(self, threshold: float) -> None:
        self._pruner.threshold = threshold

    def ensure_head(
        self, lm_head_weight, norm=None, eps: float = 1e-5
    ) -> MidLMHead:
        if self._head is None:
            self._head = MidLMHead(lm_head_weight, norm, eps)
        return self._head

    def prune(
        self,
        tree: DraftTree,
        hidden,  # [T, D] mid-network hidden states of the nodes
        root_hidden,  # [D] last committed token's hidden
        lm_head_weight,
    ) -> np.ndarray:
        head = self.ensure_head(lm_head_weight)
        rows = torch.cat([
            torch.as_tensor(root_hidden)[None], torch.as_tensor(hidden)
        ])
        all_rows = head.probs(rows)
        return self._pruner.keep_indices(tree, all_rows[1:], all_rows[0])

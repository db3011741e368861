"""Speculative decoding: client drafter + tree verify over the swarm (the
port of bloombee_tpu/spec/).

A client-side drafter builds token trees, one distributed step verifies
every row's linearized tree against the target model (tree attention mask
+ per-node depth positions), SpecInfer-style accept picks the surviving
path, and servers compact the surviving KV slots onto the committed prefix
(`CacheManager.accept_speculative`). The tree, accept and shape modules
are numpy copies of the JAX package's; the drafter and the pruner's head
run in PyTorch.
"""

from bloombee_tpu_torch.spec.drafter import GreedyTreeDrafter, LocalDraftModel
from bloombee_tpu_torch.spec.tree import DraftTree, tree_attention_mask
from bloombee_tpu_torch.spec.verify import accept_greedy, accept_sampling

__all__ = [
    "DraftTree",
    "tree_attention_mask",
    "accept_greedy",
    "accept_sampling",
    "GreedyTreeDrafter",
    "LocalDraftModel",
]

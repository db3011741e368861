"""Acceptance rules for tree speculative decoding (a copy of
bloombee_tpu/spec/verify.py: numpy, with the caller's np.random.Generator,
so a seeded run draws what the JAX client draws).

Port of the semantics of the reference's bloombee/models/llama/
spec_decoding_verify.py:44-154 (SpecInfer-style): greedy path-matching, and
multi-round rejection sampling against the draft distribution with residual
fallback. Greedy speculative decode is exactly equivalent to plain greedy
decode — the e2e test asserts token equality.

Inputs are per-sequence: `logits` [T, V] target logits for every tree node
(logits[i] predicts the token AFTER node i), `root_logits` [V] target logits
at the last committed token (predicting the first tree level).
"""

from __future__ import annotations

import numpy as np

from bloombee_tpu_torch.spec.tree import DraftTree


def accept_greedy(
    tree: DraftTree,
    root_logits: np.ndarray,  # [V]
    logits: np.ndarray,  # [T, V]
    verifiable: np.ndarray | None = None,  # [T] bool: node has real logits
) -> tuple[list[int], int]:
    """Returns (accepted_node_indices in path order, bonus_token).

    Walk from the root level: at each step the target's argmax picks the
    required token; descend into the child carrying it, else stop. The bonus
    token is the target's argmax after the last accepted node (or at the
    root if nothing was accepted).

    `verifiable` marks nodes whose logits are real (mid-chain pruning drops
    the rest — reference backend.py:395-410). Descent stops at an
    unverifiable child, but no token is lost: the bonus IS that child's
    token (the argmax that selected it).
    """
    accepted: list[int] = []
    cur = -1  # -1 = root level (children of the last committed token)
    cur_logits = root_logits
    while True:
        want = int(np.argmax(cur_logits))
        children = tree.children_of(cur)
        nxt = -1
        for c in children:
            if int(tree.tokens[c]) == want and (
                verifiable is None or verifiable[c]
            ):
                nxt = int(c)
                break
        if nxt < 0:
            return accepted, want
        accepted.append(nxt)
        cur = nxt
        cur_logits = logits[nxt]


def _softmax(x: np.ndarray) -> np.ndarray:
    x = x - x.max(axis=-1, keepdims=True)
    e = np.exp(x)
    return e / e.sum(axis=-1, keepdims=True)


def accept_sampling(
    tree: DraftTree,
    root_logits: np.ndarray,
    logits: np.ndarray,
    draft_probs: np.ndarray,  # [T, V]; kept for API compat (sibling order)
    rng: np.random.Generator,
    temperature: float = 1.0,
) -> tuple[list[int], int]:
    """Exact sampling accept for DETERMINISTICALLY proposed candidates.

    Our drafter proposes each level's children by greedy top-k — with
    probability 1, not drawn from its softmax — so the SpecInfer
    min(1, p/q) rule (which assumes candidates sampled from q) would bias
    the output. For deterministic proposals the exact scheme is sequential
    enumeration: try the children in order, accepting child c with the
    tempered target's residual-normalized probability
    P(c | not any earlier sibling); if all fail, sample the bonus from the
    remaining residual. By the chain rule the emitted token at every level
    is distributed EXACTLY as softmax(target / temperature), regardless of
    which or how many candidates the drafter proposed (verified by a
    total-variation harness in tests).
    """
    accepted: list[int] = []
    cur = -1
    cur_logits = root_logits
    while True:
        p = _softmax(cur_logits / max(temperature, 1e-6))
        children = list(tree.children_of(cur))
        nxt = -1
        residual = p.copy()
        for c in children:
            tok = int(tree.tokens[c])
            mass = float(residual.sum())
            if mass <= 0.0:
                break
            if rng.random() < residual[tok] / mass:
                nxt = int(c)
                break
            residual[tok] = 0.0  # rejected => condition on "not tok"
        if nxt < 0:
            mass = float(residual.sum())
            if mass <= 0.0:  # numerically all mass was on rejected tokens
                bonus = int(np.argmax(p))
            else:
                bonus = int(rng.choice(len(residual), p=residual / mass))
            return accepted, bonus
        accepted.append(nxt)
        cur = nxt
        cur_logits = logits[nxt]

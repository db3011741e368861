"""Adaptive tree-shape selection from acceptance statistics (a copy of
bloombee_tpu/spec/shape.py).

Role of the reference's Sequoia-style shape optimizer
(the reference's bloombee/models/llama/spec_decoding_tree_shape.py
:116-250: width optimization driven by an acceptance histogram). The model:
each round the verifier walks one path; depth d is reached iff every level
before it accepted. From observed per-level conditional acceptance rates
p_d (any drafted child at level d matched | level d-1 matched), a candidate
branching (w_1..w_D) yields expected accepted tokens

    E = sum_d prod_{i<=d} a_i(w_i),   a_i(w) = 1 - (1 - q_i)^w

where q_i is the per-child acceptance estimate at level i (p_i observed at
the width that produced it, deflated to a single child). The chooser picks
the candidate with the best E under a node budget (tree size bounds the
verify step's compute and the session's KV spike).
"""

from __future__ import annotations

import dataclasses

import numpy as np


def tree_nodes(branching: tuple[int, ...]) -> int:
    """Node count of the verify tree (incl. the certain root node)."""
    total, width = 1, 1
    for w in branching:
        width *= w
        total += width
    return total


@dataclasses.dataclass
class AcceptanceStats:
    """Per-depth acceptance counters with exponential forgetting."""

    max_depth: int = 8
    decay: float = 0.98
    prior_hits: float = 1.0
    prior_tries: float = 2.0

    def __post_init__(self):
        self.hits = np.zeros(self.max_depth)
        self.tries = np.zeros(self.max_depth)
        self.widths = np.ones(self.max_depth)  # width each level was observed at

    def observe(
        self, accepted_len: int, branching: tuple[int, ...]
    ) -> None:
        """One round for one row: the tree had levels `branching` (per-level
        widths) and `accepted_len` of them matched (0..len(branching)).

        Decay is PER LEVEL, applied only when that level is actually
        reached: an unreached level keeps its last measured rate instead
        of fading back to the optimistic prior. Under acceptance collapse
        level 0's rate falls monotonically while the frozen deeper rates
        stay put, so the chooser's preferred tree shrinks monotonically
        rather than oscillating as stale levels re-inflate."""
        depth = len(branching)
        for d in range(min(depth, self.max_depth)):
            if d > accepted_len:
                break  # level d was never reached
            self.hits[d] *= self.decay
            self.tries[d] *= self.decay
            self.tries[d] += 1
            self.widths[d] = branching[d]  # rate observed at THIS width
            if d < accepted_len:
                self.hits[d] += 1

    def per_level_rate(self, d: int) -> float:
        i = min(d, self.max_depth - 1)
        return float(
            (self.hits[i] + self.prior_hits)
            / (self.tries[i] + self.prior_tries)
        )

    def per_child_rate(self, d: int) -> float:
        """Deflate the level's observed rate to a single child using the
        width it was actually observed at."""
        i = min(d, self.max_depth - 1)
        p = min(self.per_level_rate(d), 0.999)
        w = max(float(self.widths[i]), 1.0)
        return 1.0 - (1.0 - p) ** (1.0 / w)


def expected_accepted(
    branching: tuple[int, ...], stats: AcceptanceStats
) -> float:
    """Expected accepted tokens per round for a candidate branching."""
    e, reach = 0.0, 1.0
    for d, w in enumerate(branching):
        q = stats.per_child_rate(d)
        a = 1.0 - (1.0 - q) ** w
        reach *= a
        e += reach
    return e


DEFAULT_CANDIDATES = (
    (2,), (4,), (2, 1), (2, 2), (4, 2), (2, 2, 1), (2, 2, 2), (4, 2, 1),
)


def choose_branching(
    stats: AcceptanceStats,
    candidates=DEFAULT_CANDIDATES,
    budget_nodes: int = 16,
    cost_per_node: float = 0.0,
    current: tuple[int, ...] | None = None,
    grow_margin: float = 0.0,
) -> tuple[int, ...]:
    """Best candidate under the node budget; ties prefer fewer nodes
    (cheaper verify step).

    `cost_per_node` charges every tree node a fixed expected-token cost:
    E alone is monotone in node count (each extra level or child can only
    add expected accepts), so without a cost the chooser always maxes the
    budget. With one, collapsed acceptance makes every node a net loss and
    the tree shrinks toward the smallest candidate.

    `current`/`grow_margin` add growth hysteresis: a LARGER tree than
    `current` is adopted only when its score beats current's by the
    margin. The per-child rate estimate shifts with the width it was
    observed at, so near-tied small candidates can flap on width changes
    alone — shrinking is always allowed, growing must clear real signal."""
    viable = [c for c in candidates if tree_nodes(c) <= budget_nodes]
    if not viable:
        viable = [min(candidates, key=tree_nodes)]

    def score(c):
        return expected_accepted(c, stats) - cost_per_node * tree_nodes(c)

    best = max(viable, key=lambda c: (score(c), -tree_nodes(c)))
    if (
        current is not None
        and tree_nodes(best) > tree_nodes(current)
        and score(best) < score(tuple(current)) + grow_margin
    ):
        return tuple(current)
    return best

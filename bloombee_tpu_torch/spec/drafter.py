"""Client-side drafter: builds token trees with a small local model (the
port of bloombee_tpu/spec/drafter.py).

Role of the reference's MultiSSMDrafter (spec_decoding_drafter.py:67-110,
small HF models in threads). The draft model runs client-side through the
dense block forward with its own KV (`runtime.layer_body.
dense_block_forward`) and the plain `ops.attention.masked_attention`, as
the JAX drafter does: no kernel runs here. Tree shapes are static
branching tuples (e.g. (2, 2, 1)); contexts are right-padded to pow2
buckets as in the JAX drafter, so both packages compute on the same
shapes. Families the port's layer body cannot run raise (ROADMAP Queue 1
item 15).
"""

from __future__ import annotations

import numpy as np
import torch

from bloombee_tpu_torch.models.head import embed_impl, norm_head_impl
from bloombee_tpu_torch.models.spec import ModelSpec
from bloombee_tpu_torch.ops.attention import causal_mask, masked_attention
from bloombee_tpu_torch.ops.rotary import rotary_cos_sin
from bloombee_tpu_torch.runtime.layer_body import (
    attn_scale,
    dense_block_forward,
    dense_unsupported,
)
from bloombee_tpu_torch.spec.shape import (
    AcceptanceStats,
    choose_branching,
    tree_nodes,
)
from bloombee_tpu_torch.spec.tree import DraftTree
from bloombee_tpu_torch.spec.verify import _softmax
from bloombee_tpu_torch.utils.device import resolve_device


class LocalDraftModel:
    """A small dense model run locally (the counterpart of the JAX
    package's LocalJaxDraftModel). `block_params` and `client_params` are
    the port's per-layer dicts and its {"embed", "norm", "lm_head"}; they
    are moved to `device` with `.to`, so tensors already there are shared,
    not copied (a drafter over a server's own layers costs no memory)."""

    def __init__(self, spec: ModelSpec, block_params: list,
                 client_params: dict, device="cuda"):
        reason = dense_unsupported(spec)
        if reason is not None:
            raise NotImplementedError(
                f"family {spec.family!r} cannot draft locally: {reason}"
            )
        self.spec = spec
        self.device = resolve_device(device)
        self.blocks = [
            {k: v.to(self.device) for k, v in p.items()} for p in block_params
        ]
        self.client = {k: v.to(self.device) for k, v in client_params.items()}

    @classmethod
    def from_dir(cls, model_dir: str, dtype=None,
                 device="cuda") -> "LocalDraftModel":
        """The whole model of a local checkpoint directory of a family the
        registry serves (`models.auto`)."""
        from bloombee_tpu_torch.models.checkpoint import (
            load_client_params,
            load_span_params,
            load_spec,
        )

        spec = load_spec(model_dir)
        blocks, _ = load_span_params(
            model_dir, 0, spec.num_hidden_layers, dtype=dtype, device=device
        )
        client = load_client_params(model_dir, dtype=dtype, device=device)
        return cls(spec, blocks, client, device=device)

    def _embed(self, ids: np.ndarray) -> torch.Tensor:
        return embed_impl(
            self.client,
            torch.as_tensor(ids, dtype=torch.int64).to(self.device),
            self.spec.embedding_multiplier, "embed_norm" in self.client,
            self.spec.rms_norm_eps,
        )

    def _head(self, h_last: torch.Tensor) -> torch.Tensor:
        return norm_head_impl(self.client, h_last, self.spec.rms_norm_eps,
                              self.spec.logits_soft_cap, self.spec.norm_type)

    def _rotary(self, positions: torch.Tensor):
        return rotary_cos_sin(positions, self.spec.head_dim,
                              self.spec.rope_theta)

    def _causal_attend(self, s: int):
        mask = causal_mask(s, device=self.device)[None]
        scale = attn_scale(self.spec)

        def attend(q, k, v):
            return masked_attention(q, k, v, mask, scale=scale), None

        return attend

    def _forward(self, ids: np.ndarray, last: np.ndarray):
        """ids [N, S_bucket] right-padded, last [N] = true_len - 1 ->
        (per-layer (k, v) [N, Sb, Hkv, hd], logits at `last` [N, V] f32).
        The causal mask keeps the padding invisible to the real tokens."""
        h = self._embed(ids)
        b, s, _ = h.shape
        positions = torch.arange(s, device=self.device)[None].expand(b, s)
        cos, sin = self._rotary(positions)
        attend = self._causal_attend(s)
        caches = []
        for p in self.blocks:
            h, (k, v) = dense_block_forward(p, self.spec, h, cos, sin, attend)
            caches.append((k, v))
        rows = torch.arange(b, device=self.device)
        h_last = h[rows, torch.as_tensor(last, device=self.device).long()]
        return caches, self._head(h_last)

    # ------------------------------------------------- prefix-KV cached path
    @torch.no_grad()
    def _suffix_logits(
        self,
        caches,  # per-layer (k, v) [N, Sb, Hkv, hd]
        ctx_lens: np.ndarray,  # [N]
        row_of: np.ndarray,  # [M] which cache row each path uses
        suffix_ids: np.ndarray,  # [M, d] path tokens beyond the context
    ) -> np.ndarray:
        """Logits after each path's last suffix token, attending to its
        row's cached prefix (masked to ctx_len) plus the suffix causally.
        Returns [M, V] f32 on the host."""
        dev = self.device
        m, d = suffix_ids.shape
        row_t = torch.as_tensor(np.asarray(row_of), device=dev).long()
        lens = torch.as_tensor(np.asarray(ctx_lens), device=dev).long()[row_t]
        h = self._embed(suffix_ids)
        positions = lens[:, None] + torch.arange(d, device=dev)[None, :]
        cos, sin = self._rotary(positions)

        sb = caches[0][0].shape[1]
        col = torch.arange(sb + d, device=dev)[None, None, :]
        q_idx = torch.arange(d, device=dev)[None, :, None]
        prefix_ok = (col < sb) & (col < lens[:, None, None])
        suffix_ok = (col >= sb) & ((col - sb) <= q_idx)
        mask = prefix_ok | suffix_ok  # [M, d, Sb+d]
        scale = attn_scale(self.spec)

        def attend_for(pk, pv):
            def attend(q, k, v):
                k_all = torch.cat([pk, k], dim=1)
                v_all = torch.cat([pv, v], dim=1)
                return masked_attention(q, k_all, v_all, mask,
                                        scale=scale), None

            return attend

        for p, (k_c, v_c) in zip(self.blocks, caches):
            h, _ = dense_block_forward(
                p, self.spec, h, cos, sin, attend_for(k_c[row_t], v_c[row_t])
            )
        return self._head(h[:, -1]).float().cpu().numpy()

    @torch.no_grad()
    def prefill_ragged(self, seqs: list[list[int]]):
        """(caches, ctx_lens, last_logits [N, V] f32 numpy) for ragged
        contexts (pow2 bucket)."""
        padded, lens = self._pad_ragged(seqs)
        caches, logits = self._forward(padded, lens - 1)
        return caches, lens, logits.float().cpu().numpy()

    @staticmethod
    def _pad_ragged(seqs: list[list[int]]):
        """Right-pad ragged sequences to a pow2 bucket (the shared shape
        discipline of the cached and uncached drafter paths)."""
        from bloombee_tpu_torch.runtime.executor import next_pow2

        n = len(seqs)
        lens = np.asarray([len(q) for q in seqs], np.int32)
        sb = next_pow2(int(lens.max()), floor=8)
        padded = np.zeros((n, sb), dtype=np.int64)
        for i, q in enumerate(seqs):
            padded[i, : len(q)] = q
        return padded, lens

    @torch.no_grad()
    def last_logits_ragged(self, seqs: list[list[int]]) -> np.ndarray:
        """Per-sequence next-token logits [N, V] (f32 numpy) for ragged
        contexts, recomputed from the whole context (no cache)."""
        padded, lens = self._pad_ragged(seqs)
        return self._forward(padded, lens - 1)[1].float().cpu().numpy()


class GreedyTreeDrafter:
    """Top-k tree expansion with static branching per depth (a copy of the
    JAX package's GreedyTreeDrafter over a port draft model).

    `adaptive=True` retunes the branching tuple every few rounds from the
    observed per-depth acceptance histogram, under the initial tree's node
    budget (reference spec_decoding_tree_shape.py:116-250, Sequoia-style
    width optimization)."""

    def __init__(
        self, model: LocalDraftModel, branching=(2, 2, 1),
        adaptive: bool = False, retune_every: int = 8,
        shape_cost_per_node: float = 0.05,
    ):
        self.model = model
        self.branching = tuple(branching)
        self.adaptive = adaptive
        self.retune_every = retune_every
        self.shape_cost_per_node = float(shape_cost_per_node)
        self.stats = AcceptanceStats()
        self._budget_nodes = tree_nodes(self.branching)
        self._rounds = 0
        self.levels_drafted = 0
        self.levels_accepted = 0

    @property
    def accept_rate(self) -> float:
        """Accepted drafted levels over drafted levels, across every
        observed round: the client-side mirror of the server's
        spec_accept_rate counter."""
        return self.levels_accepted / max(self.levels_drafted, 1)

    def observe(self, accepted_lens: list[int]) -> None:
        """Feed per-row accepted DRAFTED-level counts from a verify round;
        periodically re-choose the branching when adaptive."""
        depth = len(self.branching)
        for a in accepted_lens:
            self.stats.observe(int(a), self.branching)
            self.levels_drafted += depth
            self.levels_accepted += min(int(a), depth)
        self._rounds += 1
        if self.adaptive and self._rounds % self.retune_every == 0:
            self.branching = choose_branching(
                self.stats, budget_nodes=self._budget_nodes,
                cost_per_node=self.shape_cost_per_node,
                current=self.branching,
                grow_margin=2.0 * self.shape_cost_per_node,
            )

    def build_batch(
        self, contexts: list[list[int]]
    ) -> tuple[list[DraftTree], list[np.ndarray]]:
        """Per-row trees with one drafter call per depth (all rows'
        frontiers batch into one bucketed forward).

        All trees share the same static branching, hence identical parents/
        depths/mask structure: only tokens differ per row. draft_probs[r][i]
        is row r's drafter distribution at node i (for accept_sampling).
        """
        bsz = len(contexts)
        tokens = [[] for _ in range(bsz)]
        parents: list[int] = []  # shared across rows
        probs = [[] for _ in range(bsz)]
        # one context pass builds per-layer KV caches; each level reruns
        # only its short path suffix against them
        caches, ctx_lens, logits0 = self.model.prefill_ragged(contexts)
        logits = logits0[:, None, :]  # [bsz, 1, V]: level-0 frontier
        # per-row frontier: list of (parent_index, suffix_token_list)
        frontiers = [[(-1, [])] for _ in range(bsz)]
        for level, width in enumerate(self.branching):
            p = _softmax(logits)
            top = np.argsort(-logits, axis=-1)[..., :width]  # [bsz, n, w]
            for r in range(bsz):
                new_frontier = []
                for fi, (parent, suffix) in enumerate(frontiers[r]):
                    for tok in top[r, fi]:
                        idx = len(tokens[r])
                        tokens[r].append(int(tok))
                        probs[r].append(p[r, fi])
                        new_frontier.append((idx, suffix + [int(tok)]))
                        if r == 0:
                            parents.append(parent)  # structure shared
                frontiers[r] = new_frontier
            if level + 1 < len(self.branching):
                n = len(frontiers[0])
                suffix_ids = np.asarray(
                    [f[1] for fr in frontiers for f in fr], np.int64
                )  # [bsz*n, level+1]
                row_of = np.repeat(np.arange(bsz), n)
                logits = self.model._suffix_logits(
                    caches, ctx_lens, row_of, suffix_ids
                ).reshape(bsz, n, -1)
        par = np.asarray(parents, dtype=np.int32)
        trees = [
            DraftTree(tokens=np.asarray(tokens[r]), parents=par.copy())
            for r in range(bsz)
        ]
        return trees, [np.stack(pr) for pr in probs]

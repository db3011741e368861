"""Speculative generation over the swarm, batched (the port of
bloombee_tpu/client/speculative.py).

Reference DistributedLlamaForSpeculativeGeneration.generate
(speculative_model.py:33-117): draft per-row trees, verify every row's
linearized tree in ONE distributed step (tree mask + depth positions, KV
written speculatively), accept a path per row, and tell the servers which
speculative slots survive per row (they compact and commit on the device).
Greedy mode gives exactly the tokens of plain greedy decode.

Batching: all rows share the drafter's static branching, so every row's
tree has the same structure (parents, depths, mask); only tokens differ.
Rows accept different counts per round; the paged cache tracks per-row
lengths and failover replays by ragged token ids.

Round structure: every round's tree has node 0 = the bonus token of the
previous round (certain, always accepted) with the drafter's tree under
it, so the certain token's KV is written in the same step as the drafts,
and the accept rides the NEXT round's step (no extra round trip).

The accept rules and the sampling draws are numpy with one
`np.random.default_rng(seed)`, as in the JAX client, so a seeded run on
the same logits draws the same tokens.
"""

from __future__ import annotations

import numpy as np
import torch

from bloombee_tpu_torch.client.model import DistributedModelForCausalLM, _ids
from bloombee_tpu_torch.spec.drafter import GreedyTreeDrafter
from bloombee_tpu_torch.spec.shape import tree_nodes
from bloombee_tpu_torch.spec.tree import DraftTree, tree_attention_mask
from bloombee_tpu_torch.spec.verify import (
    _softmax,
    accept_greedy,
    accept_sampling,
)


def _host(logits) -> np.ndarray:
    """f32 logits (a device tensor) as a host array."""
    return logits.float().cpu().numpy()


def _pick(
    logits: np.ndarray, do_sample: bool, temperature: float,
    rng: np.random.Generator,
) -> np.ndarray:
    """Per-row token choice [B, V] -> [B] int64: argmax, or a draw from
    the tempered softmax with `rng` (the JAX client's `_select` at
    top_p 1, whose draws this reproduces)."""
    if not do_sample:
        return np.argmax(logits, axis=-1).astype(np.int64)
    probs = _softmax(logits / max(temperature, 1e-6))
    return np.stack(
        [rng.choice(probs.shape[-1], p=p) for p in probs]
    ).astype(np.int64)


def _per_span_accepts(
    accepts: list, keep: np.ndarray, n_spans: int
) -> list:
    """Translate original-space accepts into each span's KV row space:
    span 0 saw the full tree; downstream spans hold KV in kept-row order
    (every accepted node is verifiable, hence present in keep)."""
    kept_space = []
    for i, acc in enumerate(accepts):
        pos = {int(orig): p for p, orig in enumerate(keep[i]) if orig >= 0}
        kept_space.append(np.asarray([pos[int(a)] for a in acc], np.int64))
    return [accepts] + [kept_space] * (n_spans - 1)


async def generate_speculative(
    model: DistributedModelForCausalLM,
    drafter: GreedyTreeDrafter,
    input_ids,  # [B, S] int (tensor or numpy)
    max_new_tokens: int,
    session=None,
    prune_threshold: float | None = None,  # mid-chain pruning (relay mode)
    prune_max_keep: int | None = None,
    do_sample: bool = False,  # SpecInfer rejection sampling per row
    temperature: float = 1.0,
    seed: int = 0,
) -> torch.Tensor:
    """Prompt plus exactly `max_new_tokens` new tokens per row, [B, S + n]
    int64 on the host, as `generate` returns them. Every returned token but
    each row's last is committed on the servers (the same resume contract
    as plain `generate`)."""
    input_ids = _ids(input_ids).numpy()
    b, s = input_ids.shape
    max_length = s + max_new_tokens + (tree_nodes(drafter.branching) + 1) * 2
    if do_sample and prune_threshold is not None:
        raise ValueError(
            "sampling accept needs real logits at every node; mid-chain "
            "pruning zeroes pruned rows — use one or the other"
        )
    rng = np.random.default_rng(seed)
    own = session is None
    if own:
        session = model.inference_session(max_length, b)
        await session.__aenter__()
    if session.embed_fn is None:
        raise ValueError(
            "speculative generation records token-id history; the session "
            "must be built with embed_fn (model.inference_session does)"
        )
    try:
        rows = [list(r) for r in input_ids]
        # prefill -> logits at each row's last prompt token
        out = await session.step(model.embed(input_ids), ids=input_ids)
        root_logits = _host(model.logits(out[:, -1:])[:, 0])  # [B, V]
        bonus = _pick(root_logits, do_sample, temperature, rng)  # [B]
        new_rows = [[int(bonus[i])] for i in range(b)]
        pending_accept = None  # original-space accepts per row
        pending_spans = None  # per-span accepts for pruned chains

        while min(len(r) for r in new_rows) < max_new_tokens:
            # live-row window: finished rows at the batch edges stop
            # burning tree slots (the contiguous [lo, hi) window of
            # unfinished rows ships as `rows`). Interior done rows draft
            # from a 1-token context; their speculative writes roll back
            # through empty accepts. Pruned chains keep the full batch:
            # per-span accept translation is indexed in full-batch space.
            live = [
                i for i in range(b) if len(new_rows[i]) < max_new_tokens
            ]
            if prune_threshold is not None:
                lo, hi = 0, b
            else:
                lo, hi = live[0], live[-1] + 1
            w = hi - lo
            contexts = [
                (rows[i] + new_rows[i])
                if len(new_rows[i]) < max_new_tokens
                else [new_rows[i][-1]]
                for i in range(lo, hi)
            ]
            subs, probs = drafter.build_batch(contexts)
            # per-row tree: node 0 = that row's last (certain) token, the
            # drafter's tree under it; structure shared across rows
            toks = np.stack(
                [
                    np.concatenate([[new_rows[lo + j][-1]], subs[j].tokens])
                    for j in range(w)
                ]
            )  # [W, T]
            parents = np.concatenate(
                [[-1], np.where(subs[0].parents < 0, 0, subs[0].parents + 1)]
            ).astype(np.int32)
            tree0 = DraftTree(tokens=toks[0], parents=parents)
            t = tree0.size
            mask = np.broadcast_to(
                tree_attention_mask(tree0)[None], (w, t, t)
            )
            depths = np.broadcast_to(tree0.depths()[None], (w, t))

            h_tree = model.embed(toks)
            verifiable = None
            if prune_threshold is None:
                # the servers settle speculative rows when the NEXT step's
                # accept arrives; a dead session's pages free at close
                out = await session.step(
                    h_tree,
                    commit=False,
                    tree_mask=mask,
                    depths=depths,
                    accept=pending_accept,
                    rows=None if (lo, hi) == (0, b) else (lo, hi),
                )
                logits = _host(model.logits(out))  # [W, T, V]
            else:
                # mid-chain pruning: span 0 keeps only MidLMHead survivors,
                # downstream spans verify the smaller tree; kept logits map
                # back onto the original node indices
                prune_meta = {
                    "threshold": float(prune_threshold),
                    "max_keep": int(prune_max_keep or t),
                    "tokens": toks.tolist(),
                    "parents": parents.tolist(),
                }
                out_k, keep = await session.step(
                    h_tree,
                    commit=False,
                    tree_mask=mask,
                    depths=depths,
                    prune=prune_meta,
                    accept_per_span=pending_spans,
                )
                logits_k = _host(model.logits(out_k))  # [B, K, V]
                if keep is None:  # pruning span had no pruner head
                    logits = logits_k
                    keep = np.broadcast_to(np.arange(t), (b, t))
                else:
                    logits = np.zeros((b, t, logits_k.shape[-1]), np.float32)
                    verifiable = np.zeros((b, t), dtype=bool)
                    for i in range(b):
                        valid = keep[i] >= 0
                        logits[i][keep[i][valid]] = logits_k[i][valid]
                        verifiable[i][keep[i][valid]] = True

            pending_accept = []
            committed_rows = []
            drafted_accepts = []  # acceptance feedback for tree shaping
            for i in range(b):
                room = max_new_tokens - len(new_rows[i])
                if room <= 0:
                    # row done: accept nothing (its speculative rows roll
                    # back), so its cache stays "all committed but the
                    # final bonus" while slow rows continue
                    pending_accept.append(np.asarray([], dtype=np.int64))
                    committed_rows.append([])
                    continue
                j = i - lo  # this row's index in the shipped window
                if do_sample:
                    # rejection sampling over the drafter's sub-tree (node
                    # 0 is the committed bonus; targets at its children
                    # come from logits[0])
                    accepted_sub, nxt = accept_sampling(
                        subs[j], logits[j][0], logits[j][1:], probs[j],
                        rng, temperature,
                    )
                    accepted = [0] + [a + 1 for a in accepted_sub]
                else:
                    tree_i = DraftTree(tokens=toks[j], parents=parents)
                    accepted, _ = accept_greedy(
                        tree_i, root_logits[i], logits[j],
                        verifiable=(
                            None if verifiable is None else verifiable[j]
                        ),
                    )
                assert accepted and accepted[0] == 0
                drafted_accepts.append(len(accepted) - 1)  # excl. node 0
                # cap so the row lands on EXACTLY max_new_tokens with its
                # last token an uncommitted bonus
                full_len = len(accepted)
                accepted = accepted[: 1 + max(room - 1, 0)]
                if do_sample:
                    if len(accepted) < full_len:
                        # truncated: the discarded children were never
                        # rejected, so the bonus is a plain sample from the
                        # last kept node's target distribution
                        nxt = int(_pick(
                            logits[j][accepted[-1]][None], True,
                            temperature, rng,
                        )[0])
                else:
                    nxt = int(np.argmax(logits[j][accepted[-1]]))
                pending_accept.append(np.asarray(accepted))
                committed_rows.append([int(toks[j][a]) for a in accepted])
                root_logits[i] = logits[j][accepted[-1]]
                new_rows[i].extend(int(toks[j][a]) for a in accepted[1:])
                new_rows[i].append(nxt)
            # accepted nodes' token ids ARE the committed history
            session.record_history_ids(committed_rows)
            if drafted_accepts and prune_threshold is None:
                # (pruner-induced stops would read as draft misses and bias
                # shaping toward shallow trees)
                drafter.observe(drafted_accepts)
            if prune_threshold is not None:
                pending_spans = _per_span_accepts(
                    pending_accept, keep, len(session._spans)
                )

        if pending_accept is not None:
            await session.send_accept(pending_accept, per_span=pending_spans)
        return torch.tensor([rows[i] + new_rows[i] for i in range(b)],
                            dtype=torch.int64)
    finally:
        if own:
            await session.__aexit__(None, None, None)

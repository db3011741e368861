"""Span computation from per-block server records (a copy of
bloombee_tpu/swarm/spans.py).

Reference utils/dht.py:119-153 `compute_spans`: collapse {block_idx ->
{server_id -> info}} into each server's contiguous span. A server
announcing disjoint ranges yields its longest contiguous run (the
reference assumes contiguity by construction).
"""

from __future__ import annotations

from bloombee_tpu_torch.swarm.data import (
    ModuleInfo,
    RemoteSpanInfo,
    ServerState,
)


def compute_spans(
    module_infos: list[ModuleInfo],
    min_state: ServerState = ServerState.ONLINE,
    include_draining: bool = True,
) -> dict[str, RemoteSpanInfo]:
    """server_id -> RemoteSpanInfo covering its contiguous live blocks.

    DRAINING servers are included by default (their open sessions must keep
    resolving them); pass include_draining=False for views that pick targets
    for NEW work (routing handles this via _active_spans; block selection
    should not count a departing server as coverage)."""
    spans: dict[str, RemoteSpanInfo] = {}
    for block_idx, info in enumerate(module_infos):
        if info is None:
            continue
        for peer_id, server in info.servers.items():
            if server.state < min_state:
                continue
            if not include_draining and server.state == ServerState.DRAINING:
                continue
            span = spans.get(peer_id)
            if span is None:
                spans[peer_id] = RemoteSpanInfo(
                    peer_id, block_idx, block_idx + 1, server
                )
            elif span.end == block_idx:
                span.end = block_idx + 1
            # non-contiguous announcement: keep the first run
    return spans

"""Swarm health check: which blocks are covered, by whom, in what state
(the port of bloombee_tpu/cli/health.py).

    python -m bloombee_tpu_torch.cli.health MODEL_UID --num-blocks 32 \\
        --registry 127.0.0.1:7700 [--probe]
    python -m bloombee_tpu_torch.cli.health --switches

Coverage comes from the registry's records (`swarm/spans.py`
`compute_spans`; JOINING servers are shown but do not cover). `--probe`
calls `rpc_info` on the registry and on every server and prints the
nonzero counters of each group; a key the port's `rpc_info` lacks is
left out, not invented. `--switches` prints the `BBTPU_*` table.
Exits 1 when a block is missing.
"""

from __future__ import annotations

import argparse
import asyncio

# rpc_info counter groups printed by --probe when nonzero, in this order
PROBE_GROUPS = (
    # replication and failover
    ("repl_pages_sent", "repl_pages_installed", "repl_lag_pages",
     "failover_replayed_tokens"),
    # stall-free chunked prefill
    ("prefill_chunks", "prefill_chunk_tokens", "decode_steps_interleaved"),
    # mixed batch and dispatches per token
    ("mixed_dispatches", "mixed_tokens", "step_dispatches", "step_tokens"),
    # continuous batching
    ("batched_steps", "batch_dispatches", "batch_solo_steps"),
    # speculative decoding
    ("tree_steps", "tree_rows", "spec_tokens_drafted",
     "spec_tokens_accepted", "tree_group_dispatches"),
    # the universal ragged dispatch
    ("ragged_group_dispatches", "ragged_cross_kind_dispatches"),
    # server-side decode_n
    ("decode_n_calls", "decode_n_steps"),
    # the prefix cache
    ("prefix_hits", "prefix_hit_tokens", "cow_copies",
     "prefix_cached_pages"),
    # the lock witness
    ("lock_order_edges", "lock_violations"),
    # session leases and resume
    ("sessions_reaped", "sessions_resumed", "steps_deduped",
     "keepalives_sent", "pushes_dropped", "deadlines_expired"),
)


def probe_line(probe: dict) -> str:
    """The --probe suffix of one server's line."""
    line = "  [reachable]"
    for keys in PROBE_GROUPS:
        nonzero = {k: probe[k] for k in keys if probe.get(k)}
        if nonzero:
            line += "  " + " ".join(
                f"{k}={v}" for k, v in sorted(nonzero.items())
            )
    for k, fmt in (("mean_batch_width", "{:.2f}"),
                   ("dispatches_per_token", "{:.3f}"),
                   ("spec_accept_rate", "{:.3f}"),
                   ("mean_tree_batch_width", "{:.2f}")):
        if probe.get(k):
            line += f"  {k}=" + fmt.format(probe[k])
    for reason, n in sorted((probe.get("ragged_declines") or {}).items()):
        line += f"  ragged_decline[{reason}]={n}"
    flavors = [k for k in ("decode_n", "decode_n_fused", "decode_n_first",
                           "decode_n_last") if probe.get(k)]
    if flavors:
        line += "  serves=" + ",".join(flavors)
    if probe.get("decode_n_decline"):
        line += f"  decode_n_decline=[{probe['decode_n_decline']}]"
    if probe.get("draining"):
        line += "  DRAINING"
    # the wire: bytes shipped vs raw, codec seconds, the off-loop pipeline
    transport = probe.get("transport") or {}
    for direction in ("tx", "rx"):
        d = transport.get(direction) or {}
        if d.get("n"):
            line += (
                f"  {direction}_wire_bytes={d['wire_bytes']}"
                f"  {direction}_ratio={d['ratio']:.3f}"
                f"  {direction}_codec_s={d['s']:.3f}"
            )
    pipe = probe.get("wire_pipeline") or {}
    if pipe.get("tx_jobs") or pipe.get("rx_jobs"):
        line += "  pipeline=" + ("on" if pipe.get("enabled") else "off")
        for k in ("tx_jobs", "rx_jobs", "rx_depth_max",
                  "rx_backpressure_waits", "tx_limit"):
            if pipe.get(k):
                line += f"  {k}={pipe[k]}"
    if probe.get("sessions_parked"):
        line += f"  sessions_parked={probe['sessions_parked']}"
    for k in ("active_sessions",):
        if probe.get(k):
            line += f"  {k}={probe[k]}"
    for k in ("session_oldest_s", "session_oldest_idle_s"):
        if probe.get(k):
            line += f"  {k}={probe[k]:.1f}"
    waits = probe.get("queue_wait_ms") or {}
    for cls in ("prefill", "decode"):
        w = waits.get(cls) or {}
        if w.get("p95"):
            line += f"  {cls}_wait_p95={w['p95']:.1f}ms"
    return line


async def _rpc_info(host: str, port: int) -> dict:
    from bloombee_tpu_torch.wire.rpc import connect

    conn = await connect(host, port)
    try:
        probe, _ = await asyncio.wait_for(conn.call("rpc_info", {}), 5)
        return probe
    finally:
        await conn.close()


async def report(model_uid: str, num_blocks: int, registry: str,
                 probe: bool) -> int:
    """Print the swarm's coverage; returns the exit code (1 when a block
    is missing)."""
    from bloombee_tpu_torch.swarm.data import ServerState
    from bloombee_tpu_torch.swarm.registry import RegistryClient
    from bloombee_tpu_torch.swarm.spans import compute_spans

    host, port = registry.rsplit(":", 1)
    if probe:
        # the discovery plane is a server too: its audited error swallows
        line = f"  registry {registry}"
        try:
            info = await _rpc_info(host, int(port))
            line += "  [reachable]"
            for k in ("keys", "registry_swallowed_errors"):
                if info.get(k):
                    line += f"  {k}={info[k]}"
        except Exception as e:
            line += f"  [UNREACHABLE: {type(e).__name__}]"
        print(line)
    reg = RegistryClient(host, int(port))
    try:
        infos = await reg.get_module_infos(model_uid, range(num_blocks))
    finally:
        await reg.close()
    # JOINING included so standbys are visible; coverage counts only the
    # servers routing uses (ONLINE, DRAINING)
    spans = compute_spans(infos, min_state=ServerState.JOINING)
    covered = {
        b
        for s in spans.values()
        if s.server_info.state >= ServerState.ONLINE
        for b in range(s.start, s.end)
    }
    missing = [b for b in range(num_blocks) if b not in covered]
    print(f"model {model_uid}: {len(spans)} server(s)")
    for sid, span in sorted(spans.items(), key=lambda kv: kv[1].start):
        info = span.server_info
        line = (
            f"  {sid}  blocks [{span.start}:{span.end})  "
            f"{info.host}:{info.port}  {info.state.name}  "
            f"throughput={info.throughput:.2f}"
        )
        if info.cache_tokens_left is not None:
            line += f"  cache_tokens_left={info.cache_tokens_left}"
        if info.kv_repl:
            line += "  kv_repl"
        if info.decode_n_max:
            line += f"  decode_n_max={info.decode_n_max}"
        if probe:
            try:
                line += probe_line(await _rpc_info(info.host, info.port))
            except Exception as e:
                line += f"  [UNREACHABLE: {type(e).__name__}]"
        print(line)
    if missing:
        print(f"  MISSING blocks: {missing}")
        return 1
    print("  swarm is COMPLETE")
    return 0


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("model_uid", nargs="?", default=None)
    parser.add_argument("--num-blocks", type=int)
    parser.add_argument("--registry", default="127.0.0.1:7700",
                        help="registry address host:port")
    parser.add_argument("--probe", action="store_true",
                        help="also call rpc_info on the registry and every "
                        "server")
    parser.add_argument("--switches", action="store_true",
                        help="print the BBTPU_* switch table and exit")
    args = parser.parse_args(argv)
    if args.switches:
        from bloombee_tpu_torch.utils import env

        env.import_declaring_modules()
        print(env.describe())
        return
    if args.model_uid is None or args.num_blocks is None:
        parser.error("model_uid and --num-blocks are required")
    if "," in args.registry:
        parser.error(
            "--registry with several replicas asks for a replicated "
            "registry, which the port does not have yet (ROADMAP Queue 1 "
            "item 19)"
        )
    code = asyncio.run(report(args.model_uid, args.num_blocks, args.registry,
                              args.probe))
    if code:
        raise SystemExit(code)


if __name__ == "__main__":
    main()

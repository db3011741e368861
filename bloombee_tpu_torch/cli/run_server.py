"""Run a port server hosting a span of blocks (the port of
bloombee_tpu/cli/run_server.py).

    python -m bloombee_tpu_torch.cli.run_server /path/to/model \\
        --registry 10.0.0.1:7700 --blocks 0:16 --port 7800

The model is a local HF directory (config.json + safetensors) of a family
the port serves (Llama, Mistral, Qwen2, Qwen3, Gemma2, Gemma3; any other
exits non-zero with its ROADMAP item before anything is announced); the span's
layers load onto `--device` (cuda unless asked for cpu, which raises on a
machine without a GPU). The command line of a JAX deployment starts a
port server unchanged as long as it leaves the JAX-only flags at their
defaults: a flag set for what the port lacks is refused with its ROADMAP
item (`UNPORTED_FLAGS`), never ignored.

Before the first announce, `--warmup-batches` builds and loads every CUDA
library (`ops/cuda/build.py`; two servers starting together on one card
build safely: each writes its own temporary file and renames it into
place), runs one decode step per listed batch bucket and, on the first
and the last span, loads the checkpoint's embeddings and head for
decode_n, so no client pays the build or the load. The measured
throughput is folded into later announces.
SIGTERM and SIGINT drain the server (up to `--drain-timeout` seconds for
live sessions) and exit 0.
"""

from __future__ import annotations

import argparse
import asyncio
import logging
import os
import signal

# flag (argparse dest) -> (the JAX default, what it asks for, ROADMAP
# Queue 1 item). A flag is refused only when set away from its default
UNPORTED_FLAGS = {
    "adapters": (None, "per-request LoRA adapters", 16),
    "adapter_dirs": (None, "merged LoRA adapters", 16),
    "offload_layers": (0, "weight offload", 16),
    "attn_sparsity": (1.0, "sparse decode attention", 16),
    "weight_quant": (None, "weight quantization", 14),
    "tp": (1, "tensor parallelism", 18),
    "sp": (1, "sequence parallelism", 18),
    "oversubscribe": (1.0, "KV over-subscription with host parking", "12b"),
    "idle_park_s": (5.0, "idle-session parking", "12b"),
    "admit": (None, "admission control", 19),
    "admit_high_ms": (None, "admission control", 19),
    "standby": (False, "warm standbys and promotion", 19),
    "promote_high_ms": (None, "standby promotion", 19),
    "promote_low_ms": (None, "standby promotion", 19),
    "promote_sustain_s": (None, "standby promotion", 19),
    "promote_jitter_s": (None, "standby promotion", 19),
    "rebalance_period": (None, "span rebalancing", 19),
    "artifact_dir": (None, "the shared compile-artifact store", 19),
    "load_advert_s": (None, "load adverts", 19),
    "num_blocks": (None, "automatic block selection", 19),
}


def _unported(args) -> str | None:
    """Why this command line asks for what the port lacks; None when it
    does not."""
    if args.blocks is None:
        return (
            "a missing --blocks asks for automatic block selection, which "
            "the port does not have yet (ROADMAP Queue 1 item 19)"
        )
    if "," in args.registry:
        return (
            "--registry with several replicas asks for a replicated "
            "registry, which the port does not have yet (ROADMAP Queue 1 "
            "item 19)"
        )
    for dest, (default, what, item) in UNPORTED_FLAGS.items():
        value = getattr(args, dest)
        if dest == "weight_quant" and value == "none":
            continue  # the default's spelled-out form
        if dest == "rebalance_period" and value == 0:
            continue  # rebalancing off: what the port does
        if value != default:
            flag = "--" + dest.replace("_", "-")
            return (
                f"{flag}={value!r} asks for {what}, which the port does not "
                f"have yet (ROADMAP Queue 1 item {item})"
            )
    return None


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("model_dir", help="local HF model directory")
    p.add_argument("--model-uid", default=None,
                   help="swarm uid (default: the model directory's name)")
    p.add_argument("--registry", default="127.0.0.1:7700",
                   help="registry address host:port")
    p.add_argument("--blocks", default=None, help="'start:end'")
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--public-host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=0)
    p.add_argument("--num-pages", type=int, default=256)
    p.add_argument("--page-size", type=int, default=16)
    p.add_argument("--max-chunk-tokens", type=int, default=512)
    p.add_argument("--max-batch", type=int, default=8,
                   help="continuous batching: coalesce up to this many "
                        "sessions' single-token decode steps into one span "
                        "dispatch (1 disables; gather window "
                        "BBTPU_BATCH_WINDOW_MS)")
    p.add_argument("--mixed-batch", action="store_true", default=None,
                   help="fuse a prefill chunk and queued decode steps into "
                        "one ragged dispatch (needs --prefill-chunk; default "
                        "BBTPU_MIXED_BATCH)")
    p.add_argument("--prefill-chunk", type=int, default=None,
                   help="split prefills into chunks of at most this many "
                        "tokens, each its own compute-queue task (0 = "
                        "monolithic; default BBTPU_PREFILL_CHUNK)")
    p.add_argument("--dtype", default="bfloat16",
                   choices=["bfloat16", "float32"])
    p.add_argument("--announce-period", type=float, default=5.0)
    p.add_argument("--drain-timeout", type=float, default=30.0,
                   help="how long a drain (SIGTERM/SIGINT shutdown) waits "
                        "for live sessions before exiting")
    p.add_argument("--kv-quant", default=None, choices=["none", "int4"],
                   help="KV cache quantization (default BBTPU_KV_QUANT)")
    p.add_argument("--prefix-cache", action="store_true", default=None,
                   help="share KV pages of common prompt prefixes across "
                        "sessions (default BBTPU_PREFIX_CACHE)")
    p.add_argument("--session-lease-s", type=float, default=None,
                   help="park a session whose client went silent this long, "
                        "resumable for one more lease (0 disables; default "
                        "BBTPU_SESSION_LEASE_S)")
    p.add_argument("--keepalive-s", type=float, default=None,
                   help="wire keepalive interval (0 disables; default "
                        "BBTPU_KEEPALIVE_S)")
    p.add_argument("--warmup-batches", default="1",
                   help="comma-separated batch buckets to warm before the "
                        "first announce ('' = skip)")
    p.add_argument("--device", default="cuda",
                   help="torch device of the span (cuda, or cpu)")
    p.add_argument("--log-level", default="INFO")
    # the JAX flags the port refuses unless left at their defaults
    p.add_argument("--num-blocks", type=int, default=None)
    p.add_argument("--adapter-dirs", nargs="*", default=None)
    p.add_argument("--adapters", nargs="*", default=None)
    p.add_argument("--offload-layers", type=int, default=0)
    p.add_argument("--attn-sparsity", type=float, default=1.0)
    p.add_argument("--weight-quant", default=None,
                   choices=["none", "int8", "int4"])
    p.add_argument("--tp", type=int, default=1)
    p.add_argument("--sp", type=int, default=1)
    p.add_argument("--oversubscribe", type=float, default=1.0)
    p.add_argument("--idle-park-s", type=float, default=5.0)
    p.add_argument("--admit", action="store_true", default=None)
    p.add_argument("--admit-high-ms", type=float, default=None)
    p.add_argument("--standby", action="store_true")
    p.add_argument("--promote-high-ms", type=float, default=None)
    p.add_argument("--promote-low-ms", type=float, default=None)
    p.add_argument("--promote-sustain-s", type=float, default=None)
    p.add_argument("--promote-jitter-s", type=float, default=None)
    p.add_argument("--rebalance-period", type=float, default=None)
    p.add_argument("--artifact-dir", default=None)
    p.add_argument("--load-advert-s", type=float, default=None)
    return p


async def warmup(server, batches) -> None:
    """Build and load every CUDA library (on a card), run one decode step
    per batch bucket and load the client parameters of a first or last
    span, before the server announces (nothing else runs on the loop yet,
    so the device work runs inline)."""
    import torch

    from bloombee_tpu_torch.ops.cuda import build

    if server.device.type == "cuda":
        names = build.sources()
        build.build(names)
        for name in names:
            build.library(name)
    ex = server.executor
    for b in batches:
        async with server.manager.allocate(b, 2) as handle:
            hidden = torch.zeros((b, 1, server.spec.hidden_size))
            ex.fetch(ex.decode(handle, hidden, fetch=False))
    if server.start_block == 0 or (
        server.end_block == server.spec.num_hidden_layers
    ):
        # the first and the last span play decode_n's embed and head
        # roles: load the checkpoint's client parameters now, not in the
        # first decode_n call
        await server._ensure_client_params()
    logging.info("warmed up: batch buckets %s", list(batches))


def main(argv=None):
    p = parser()
    args = p.parse_args(argv)
    reason = _unported(args)
    if reason is not None:
        p.error(reason)
    if not os.path.isdir(args.model_dir):
        p.error(
            f"{args.model_dir!r} is not a local model directory (hub names "
            f"are resolved by ROADMAP Queue 1 item 19)"
        )
    from bloombee_tpu_torch.models.checkpoint import load_spec

    try:
        # a family the port does not serve yet is refused before any
        # weight loads or anything is announced
        load_spec(args.model_dir)
    except NotImplementedError as e:
        p.error(str(e))
    logging.basicConfig(level=args.log_level)

    import torch

    from bloombee_tpu_torch.server.block_server import BlockServer
    from bloombee_tpu_torch.server.throughput import measure_and_announce
    from bloombee_tpu_torch.swarm.registry import RegistryClient

    dtype = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32
    start, end = (int(x) for x in args.blocks.split(":"))
    model_uid = args.model_uid or args.model_dir.rstrip("/").split("/")[-1]
    reg_host, reg_port = args.registry.rsplit(":", 1)
    server = BlockServer(
        model_uid=model_uid, start=start, end=end,
        model_dir=args.model_dir,
        registry=RegistryClient(reg_host, int(reg_port)),
        host=args.host, port=args.port, public_host=args.public_host,
        num_pages=args.num_pages, page_size=args.page_size,
        compute_dtype=dtype, max_chunk_tokens=args.max_chunk_tokens,
        max_batch=args.max_batch, mixed_batch=args.mixed_batch,
        prefill_chunk=args.prefill_chunk,
        announce_period=args.announce_period,
        kv_quant=args.kv_quant, prefix_cache=args.prefix_cache,
        session_lease_s=args.session_lease_s, keepalive_s=args.keepalive_s,
        drain_timeout=args.drain_timeout, device=args.device,
    )
    batches = tuple(int(x) for x in args.warmup_batches.split(",") if x)

    async def run():
        if batches:
            await warmup(server, batches)
        await server.start()
        # a strong reference: the loop holds tasks only weakly
        server._throughput_task = asyncio.create_task(
            measure_and_announce(server)
        )
        logging.info(
            "server %s serving %s[%d:%d) on port %d", server.server_id,
            model_uid, start, end, server.port,
        )
        # graceful shutdown: SIGTERM/SIGINT announce DRAINING, flush
        # replication, wait for live sessions up to --drain-timeout, revoke
        # the span and exit
        stop_requested = asyncio.Event()
        loop = asyncio.get_running_loop()
        for sig in (signal.SIGTERM, signal.SIGINT):
            loop.add_signal_handler(
                sig,
                lambda s=sig: (
                    logging.info("received %s: draining before exit",
                                 signal.Signals(s).name),
                    stop_requested.set(),
                ),
            )
        await stop_requested.wait()
        server._throughput_task.cancel()
        await server.drain()
        await server.registry.close()

    asyncio.run(run())


if __name__ == "__main__":
    main()

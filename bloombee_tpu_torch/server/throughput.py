"""Server throughput measurement (port of bloombee_tpu/server/throughput.py).

Measures real decode steps through the span executor, caches the result on
disk keyed by (model, span, dtype, device), and folds it into the announced
ServerInfo so client routing can rank servers. The device in the key is the
card's name (`torch.cuda.get_device_name`), or "cpu". A server given
`throughput=` measures nothing; this runs only when a caller asks for it.
"""

from __future__ import annotations

import hashlib
import json
import logging
import pathlib

import torch

from bloombee_tpu_torch.server.compute_queue import PRIORITY_TRAINING
from bloombee_tpu_torch.utils import clock

logger = logging.getLogger(__name__)

CACHE_PATH = (
    pathlib.Path.home() / ".cache" / "bloombee_tpu_torch" / "throughput.json"
)


def _device_name(device: torch.device) -> str:
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return device.type


def _cache_key(server) -> str:
    raw = json.dumps(
        [
            server.model_uid,
            server.start_block,
            server.end_block,
            str(server.executor.compute_dtype),
            _device_name(server.executor.device),
        ]
    )
    return hashlib.sha1(raw.encode()).hexdigest()[:16]


def _load_cache() -> dict:
    try:
        with open(CACHE_PATH) as f:
            return json.load(f)
    except Exception:
        return {}


def _store_cache(cache: dict) -> None:
    CACHE_PATH.parent.mkdir(parents=True, exist_ok=True)
    with open(CACHE_PATH, "w") as f:
        json.dump(cache, f)


def _synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


async def measure_and_announce(
    server, batch: int = 1, steps: int = 8
) -> float:
    """Measure (or load cached) inference rps and fold into announcements."""
    key = _cache_key(server)
    cache = _load_cache()
    if key in cache:
        rps = cache[key]
        logger.info("throughput cache hit: %.2f rps", rps)
    else:
        ex = server.executor
        d = server.spec.hidden_size
        async with server.manager.allocate(batch, steps + 8) as handle:
            hidden = torch.zeros((batch, 1, d), dtype=torch.float32)

            def decode():
                return ex.decode(handle, hidden, fetch=False)

            # through the compute queue: the one serialization point for
            # device work and the shared KV arena
            await server.compute.submit(PRIORITY_TRAINING, decode)  # warm up
            await server.compute.submit(PRIORITY_TRAINING, _synchronize,
                                        ex.device)
            # real wall time on purpose: a hardware measurement, not a
            # timing decision
            t0 = clock.perf_counter()
            for _ in range(steps):
                await server.compute.submit(PRIORITY_TRAINING, decode)
            await server.compute.submit(PRIORITY_TRAINING, _synchronize,
                                        ex.device)
            rps = steps / max(clock.perf_counter() - t0, 1e-9)
        cache[key] = rps
        try:
            _store_cache(cache)
        except Exception as e:
            logger.warning("throughput cache store failed: %s", e)
        logger.info("measured %.2f inference rps", rps)
    server.throughput = rps
    server.inference_rps = rps
    return rps

"""The asyncio lock constructor named by hierarchy key (the API of
bloombee_tpu/utils/lockwatch.py, without its witness).

The JAX package can wrap its locks in a runtime lock-order witness
(``BBTPU_LOCKWATCH=1``, off by default). The port keeps the call sites and
their keys, so the witness can be ported behind them later, and returns
the plain asyncio lock the JAX package returns with the witness off.
"""

from __future__ import annotations

import asyncio


def async_lock(key: str) -> asyncio.Lock:
    """An asyncio.Lock for hierarchy key `key`."""
    return asyncio.Lock()


def counters() -> dict:
    """rpc_info's lock-witness counters: no witness, nothing observed."""
    return {"lock_order_edges": 0, "lock_violations": 0}

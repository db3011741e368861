"""Fault and recovery coverage ledger (a copy of the counters of
bloombee_tpu/utils/ledger.py).

Every fault-injection site calls ``fault(name)`` and every exercised
recovery path ``recovery(name)`` (the client's ban, overload backoff,
quarantine and reroute-and-replay); the counters are process-wide and
thread-safe. With ``BBTPU_CHAOS_LEDGER`` set, the process appends one JSON
line ``{"faults": {...}, "recoveries": {...}}`` to that path at exit, in
the JAX package's format, so one reader merges both packages' lines.
"""

from __future__ import annotations

import atexit
import collections
import json
import threading

from bloombee_tpu_torch.utils import env

env.declare(
    "BBTPU_CHAOS_LEDGER", str, "",
    "path to append this process's fault/recovery coverage ledger to at "
    "exit (one JSON line per process); empty = in-memory only",
)

_lock = threading.Lock()
_faults: collections.Counter = collections.Counter()
_recoveries: collections.Counter = collections.Counter()
_atexit_registered = False


def _ensure_atexit() -> None:
    global _atexit_registered
    if not _atexit_registered:
        _atexit_registered = True
        if env.get("BBTPU_CHAOS_LEDGER"):
            atexit.register(flush)


def fault(name: str, n: int = 1) -> None:
    """Record an injected fault at a named point."""
    with _lock:
        _faults[name] += n
    _ensure_atexit()


def recovery(name: str, n: int = 1) -> None:
    """Record an exercised recovery path at a named point."""
    with _lock:
        _recoveries[name] += n
    _ensure_atexit()


def snapshot() -> dict:
    with _lock:
        return {"faults": dict(_faults), "recoveries": dict(_recoveries)}


def reset() -> None:
    with _lock:
        _faults.clear()
        _recoveries.clear()


def flush(path: str | None = None) -> None:
    """Append this process's ledger as one JSON line (the atexit hook)."""
    path = path or env.get("BBTPU_CHAOS_LEDGER")
    if not path:
        return
    snap = snapshot()
    if not snap["faults"] and not snap["recoveries"]:
        return
    try:
        with open(path, "a") as f:
            f.write(json.dumps(snap, sort_keys=True) + "\n")
    except OSError:  # the ledger must never take down the process it audits
        pass

"""Shared load-advert interpretation (a copy of bloombee_tpu/swarm/load.py):
one defensive translation from an untrusted `ServerInfo.load` wire advert
into a predicted queue delay, the same reading the client router, block
selection and standby promotion apply. Adverts are hostile wire input
everywhere; there must be one bounded, monotone, staleness-discounted
reading of them.
"""

from __future__ import annotations

import math

from bloombee_tpu_torch.utils import clock

LOAD_STALE_S = 30.0  # advert age at which the load term decays to zero
LOAD_DELAY_CAP_S = 10.0  # hard cap on the load term: a garbage/hostile
# advert can inflate only its OWN server's cost, and only this far
LOAD_SHED_PENALTY_S = 1.0  # an actively-shedding server would refuse new
# work anyway; make it about as unattractive as a missing-cache server
_QUEUE_DEPTH_COST_S = 0.05  # per queued task, a rough serialized-step cost


def _finite_pos(x) -> float:
    """Clamp an untrusted advert number to a finite value >= 0 (NaN, inf,
    negatives, non-numbers all collapse to 0 = 'no load evidence')."""
    try:
        v = float(x)
    except (TypeError, ValueError):
        return 0.0
    if not math.isfinite(v) or v < 0.0:
        return 0.0
    return v


def predicted_queue_delay_s(server_info, now: float | None = None) -> float:
    """Predicted extra queueing delay (seconds) at this server, derived
    from its live load advert. Properties every consumer depends on
    (enforced here, property-tested in tests/test_overload_routing.py):

    - always finite, >= 0, <= LOAD_DELAY_CAP_S: added to a positive edge
      cost, Dijkstra stays valid no matter what the advert claims;
    - monotone non-decreasing in reported load (delay/p95/queue depth), so
      a server cannot make itself MORE attractive by advertising load —
      the no-advert baseline (0) is the floor, meaning a malicious advert
      can only repel traffic from its own server, never capture it;
    - staleness-discounted: the term decays linearly to zero by
      LOAD_STALE_S of advert age (load["ts"], writer wall clock, falling
      back to the registry record's writer-stamped stored_at), so a dead
      server's last hot advert doesn't repel traffic forever and a stale
      cool advert doesn't attract a stampede.
    """
    load = getattr(server_info, "load", None)
    if not isinstance(load, dict):
        return 0.0
    if now is None:
        now = clock.now()
    ts = load.get("ts")
    if not isinstance(ts, (int, float)) or not math.isfinite(float(ts)):
        ts = getattr(server_info, "advert_stored_at", None)
    if isinstance(ts, (int, float)) and math.isfinite(float(ts)):
        age = min(max(now - float(ts), 0.0), LOAD_STALE_S)
    else:
        age = 0.0  # unstamped advert: treat as fresh (only repels traffic
        # from the advertiser itself, so assuming fresh is the safe side)
    weight = 1.0 - age / LOAD_STALE_S
    if weight <= 0.0:
        return 0.0
    delay = _finite_pos(load.get("delay_ms")) / 1000.0
    wait = load.get("decode_wait_ms") or load.get("wait_ms")
    if isinstance(wait, dict):
        delay = max(delay, _finite_pos(wait.get("p95")) / 1000.0)
    delay += _QUEUE_DEPTH_COST_S * min(
        _finite_pos(load.get("queue_depth")), 100.0
    )
    if load.get("shedding"):
        delay += LOAD_SHED_PENALTY_S
    return weight * min(delay, LOAD_DELAY_CAP_S)

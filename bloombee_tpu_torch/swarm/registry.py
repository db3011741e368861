"""Registry service: the swarm's discovery plane (a copy of
bloombee_tpu/swarm/registry.py's `RegistryServer` and `RegistryClient`,
with the `_Store` disk persistence).

Servers periodically store `{uid}.{block}` -> {server_id: (info, expiry)};
records expire, and expiry IS the failure detector (a dead server's records
vanish after `expiration` seconds). Clients fetch many uids at once to build
the routing table. The records and RPCs are the JAX package's, so a port
server announces to a JAX registry and a JAX client reads a port registry.
"""

from __future__ import annotations

import asyncio
import json
import logging
import os

from bloombee_tpu_torch.swarm.data import ModuleInfo, ServerInfo
from bloombee_tpu_torch.utils import clock, lockwatch
from bloombee_tpu_torch.wire.rpc import Connection, RpcServer, connect

logger = logging.getLogger(__name__)


class _Store:
    # deletes live this long as tombstones so a replica that missed the
    # delete can't resurrect the record in a merged read (must outlive the
    # stale record's own expiration, default 30s announces)
    TOMBSTONE_TTL = 60.0

    def __init__(self):
        # key -> subkey -> (value dict | None, expiration, stored_at)
        # value None = tombstone (deleted; newer than any older live record)
        self._data: dict[
            str, dict[str, tuple[dict | None, float, float]]
        ] = {}

    def store(
        self, key: str, subkey: str, value: dict, expiration: float,
        stored_at: float | None = None,
    ):
        # stored_at is stamped by the WRITER (server/client), not this
        # replica's clock: one actor's clock then orders its own
        # announce/revoke sequence identically on every replica, so the
        # replicated merge is immune to cross-replica clock skew
        self._data.setdefault(key, {})[subkey] = (
            value, expiration, clock.now() if stored_at is None else stored_at,
        )

    # --------------------------------------------------------- persistence
    def snapshot(self) -> list:
        """Live records (and tombstones) as a JSON-serializable list."""
        now = clock.now()
        return [
            {"key": k, "subkey": sk, "value": v, "expiration": exp,
             "stored_at": t}
            for k, sub in self._data.items()
            for sk, (v, exp, t) in sub.items()
            if exp > now
        ]

    def load_snapshot(self, records: list) -> None:
        now = clock.now()
        for r in records:
            if r["expiration"] > now:
                self._data.setdefault(r["key"], {})[r["subkey"]] = (
                    r["value"], r["expiration"],
                    r.get("stored_at", now),
                )

    def get(self, key: str) -> dict[str, tuple[dict | None, float]]:
        """subkey -> (value | None-for-tombstone, stored_at), expired pruned."""
        now = clock.now()
        out = {}
        sub = self._data.get(key)
        if not sub:
            return out
        dead = []
        for sk, (v, exp, t) in sub.items():
            if exp < now:
                dead.append(sk)
            else:
                out[sk] = (v, t)
        for sk in dead:
            del sub[sk]
        return out

    def delete(
        self, key: str, subkey: str, ttl: float | None = None,
        stored_at: float | None = None,
    ):
        now = clock.now()
        self._data.setdefault(key, {})[subkey] = (
            None,
            now + (self.TOMBSTONE_TTL if ttl is None else ttl),
            now if stored_at is None else stored_at,
        )


class RegistryServer:
    """Standalone registry node (bootstrap peer).

    `persist_path` makes the record store survive restarts: records are
    snapshotted to disk every `persist_period` seconds (and on stop) and
    reloaded at start — a restarted registry immediately knows the swarm
    instead of waiting an announce period for every server (the reference's
    DHT survives via peer replication; a single-node registry needs a disk
    snapshot instead).
    """

    def __init__(
        self,
        host: str = "0.0.0.0",
        port: int = 0,
        persist_path: str | None = None,
        persist_period: float = 5.0,
    ):
        self._store = _Store()
        self.persist_path = persist_path
        self.persist_period = persist_period
        self._persist_task: asyncio.Task | None = None
        # audited error swallows: persistence failures must not take down
        # the discovery plane, but they must not be silent either —
        # surfaced via rpc_info so `cli/health --probe` sees them
        self.swallowed_errors = 0
        self._swallow_logged: set[tuple[str, str]] = set()
        self.rpc = RpcServer(
            unary_handlers={
                "registry_store": self._rpc_store,
                "registry_get": self._rpc_get,
                "registry_delete": self._rpc_delete,
                "rpc_info": self._rpc_info,
            },
            host=host,
            port=port,
        )

    @property
    def port(self) -> int:
        return self.rpc.port

    def _note_swallow(self, site: str, exc: Exception) -> None:
        """Count a deliberately-survived error, warning once per
        (site, exception type) so a persistent cause logs exactly one
        line instead of one per period — or zero."""
        self.swallowed_errors += 1
        cause = (site, type(exc).__name__)
        if cause not in self._swallow_logged:
            self._swallow_logged.add(cause)
            logger.warning(
                "registry: %s failed (%s: %s) — continuing; counted in "
                "registry_swallowed_errors", site, type(exc).__name__, exc,
            )

    async def start(self):
        if self.persist_path and os.path.exists(self.persist_path):
            try:
                # read + parse off-loop: a registry restarting into a big
                # swarm snapshot must not stall peers already reconnecting
                snap = await asyncio.to_thread(self._read_snapshot)
                self._store.load_snapshot(snap)
            except Exception as e:
                # a corrupt snapshot must not block bootstrap
                self._note_swallow("snapshot load", e)
        await self.rpc.start()
        if self.persist_path:
            self._persist_task = asyncio.create_task(self._persist_loop())

    async def stop(self):
        if self._persist_task is not None:
            self._persist_task.cancel()
            try:
                # an in-flight to_thread write keeps running through
                # cancel(); await it so the final write can't race it on
                # the same .tmp file
                await self._persist_task
            except (asyncio.CancelledError, Exception):
                pass
            # final write off-loop too: stop() runs while peer
            # connections are still draining on this loop
            await asyncio.to_thread(self._write_snapshot)
        await self.rpc.stop()

    def _read_snapshot(self) -> dict:
        with open(self.persist_path) as f:
            return json.load(f)

    def _write_snapshot(self) -> None:
        tmp = f"{self.persist_path}.tmp"
        with open(tmp, "w") as f:
            json.dump(self._store.snapshot(), f)
        os.replace(tmp, self.persist_path)

    async def _persist_loop(self) -> None:
        while True:
            await clock.async_sleep(self.persist_period)
            try:
                await asyncio.to_thread(self._write_snapshot)
            except asyncio.CancelledError:
                raise
            except Exception as e:
                # a failed periodic write must not kill the loop (the
                # next period retries), but it must be counted
                self._note_swallow("snapshot write", e)

    async def _rpc_store(self, meta: dict, tensors):
        now = clock.now()
        for rec in meta["records"]:
            self._store.store(
                rec["key"], rec["subkey"], rec["value"],
                now + rec["expiration"],
                stored_at=rec.get("stored_at"),
            )
        return {"ok": True}, []

    async def _rpc_get(self, meta: dict, tensors):
        # each record ships as {"v": value-or-None, "t": stored_at} so a
        # replicated reader can do latest-write-wins across replicas
        return {
            "results": {
                k: {
                    sk: {"v": v, "t": t}
                    for sk, (v, t) in self._store.get(k).items()
                }
                for k in meta["keys"]
            }
        }, []

    async def _rpc_info(self, meta: dict, tensors):
        """Probe endpoint (cli/health --probe reaches every advertised rpc
        server with this): registry identity + the swallowed-error audit."""
        return {
            "kind": "registry",
            "registry_swallowed_errors": self.swallowed_errors,
            "keys": len(self._store._data),
            "server_time": clock.now(),
        }, []

    async def _rpc_delete(self, meta: dict, tensors):
        for rec in meta["records"]:
            self._store.delete(
                rec["key"], rec["subkey"], ttl=rec.get("ttl"),
                stored_at=rec.get("stored_at"),
            )
        return {"ok": True}, []


class RegistryClient:
    """Client handle to the registry (used by servers and model clients)."""

    def __init__(self, host: str, port: int):
        self.host = host
        self.port = port
        self._conn: Connection | None = None
        self._lock = lockwatch.async_lock("registry.client")

    async def _connection(self) -> Connection:
        async with self._lock:
            if self._conn is None or self._conn.is_closing():
                self._conn = await connect(self.host, self.port)
            return self._conn

    async def close(self):
        if self._conn is not None:
            await self._conn.close()
            self._conn = None

    async def declare_blocks(
        self,
        model_uid: str,
        server_id: str,
        blocks: range,
        info: ServerInfo,
        expiration: float = 30.0,
    ) -> None:
        """reference: declare_active_modules (utils/dht.py:28-73)."""
        conn = await self._connection()
        now = clock.now()
        records = [
            {
                "key": f"{model_uid}.{i}",
                "subkey": server_id,
                "value": info.to_wire(),
                "expiration": expiration,
                "stored_at": now,  # writer's clock orders announce vs revoke
            }
            for i in blocks
        ]
        await conn.call("registry_store", {"records": records})

    async def revoke_blocks(
        self, model_uid: str, server_id: str, blocks: range,
        expiration: float = 60.0,
    ) -> None:
        """`expiration` must be >= the announce expiration so the tombstone
        outlives any stale live record on a replica that missed the
        delete."""
        conn = await self._connection()
        now = clock.now()
        records = [
            {
                "key": f"{model_uid}.{i}",
                "subkey": server_id,
                "ttl": expiration,
                "stored_at": now,
            }
            for i in blocks
        ]
        await conn.call("registry_delete", {"records": records})

    async def get_records(
        self, model_uid: str, blocks: range
    ) -> list[dict[str, tuple[dict | None, float]]]:
        """Per-block raw record maps: server_id -> (wire value | None for a
        tombstone, stored_at). The replicated reader merges these by
        latest-write-wins."""
        conn = await self._connection()
        keys = [f"{model_uid}.{i}" for i in blocks]
        meta, _ = await conn.call("registry_get", {"keys": keys})
        return [
            {
                sid: (rec["v"], rec["t"])
                for sid, rec in meta["results"].get(key, {}).items()
            }
            for key in keys
        ]

    async def get_module_infos(
        self, model_uid: str, blocks: range
    ) -> list[ModuleInfo]:
        """reference: get_remote_module_infos (utils/dht.py:74-117)."""
        raw = await self.get_records(model_uid, blocks)
        return _records_to_infos(model_uid, blocks, raw)


def _records_to_infos(
    model_uid: str, blocks, raw: list[dict]
) -> list[ModuleInfo]:
    """Raw (value|tombstone, stored_at) maps -> ModuleInfo list."""
    out = []
    for i, sub in zip(blocks, raw):
        servers = {}
        for sid, (v, t) in sub.items():
            if v is None:  # drop tombstones
                continue
            info = ServerInfo.from_wire(v)
            # advert freshness for load-aware routing: stored_at is stamped
            # by the WRITER (same clock as the load snapshot's own ts), so
            # it's the staleness fallback when an advert carries a load
            # dict without a usable ts. Non-wire attribute on purpose —
            # to_wire()/asdict never re-publish it.
            info.advert_stored_at = t
            servers[sid] = info
        out.append(ModuleInfo(uid=f"{model_uid}.{i}", servers=servers))
    return out

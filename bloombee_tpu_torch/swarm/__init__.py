"""Swarm discovery of the port (copies of bloombee_tpu/swarm/): the
registry service, server records and RTT measurement."""

from bloombee_tpu_torch.swarm.data import (
    ModuleInfo,
    RemoteSpanInfo,
    ServerInfo,
    ServerState,
)
from bloombee_tpu_torch.swarm.registry import RegistryClient, RegistryServer

__all__ = [
    "ServerInfo",
    "ServerState",
    "RemoteSpanInfo",
    "ModuleInfo",
    "RegistryServer",
    "RegistryClient",
]

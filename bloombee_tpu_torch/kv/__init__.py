"""Paged KV-cache substrate of the port: the host-side `PagedKVTable`
(control plane), the device arena ops (data plane) and `CacheManager`
(admission + handle lifecycle)."""

from bloombee_tpu_torch.kv.arena import arena_write, gather_pages, make_arena
from bloombee_tpu_torch.kv.cache_manager import CacheHandle, CacheManager
from bloombee_tpu_torch.kv.paged import OutOfPages, PagedKVTable

__all__ = [
    "PagedKVTable",
    "OutOfPages",
    "make_arena",
    "arena_write",
    "gather_pages",
    "CacheManager",
    "CacheHandle",
]

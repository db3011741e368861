"""Declared environment switches (a small copy of bloombee_tpu/utils/env.py).

Every switch is declared once, next to the code that reads it, with a type,
a default and a help string. The names keep the `BBTPU_` prefix, so one
environment configures both packages the same way. Reads are uncached:
whoever reads a switch decides when (the executor reads its thresholds
when it is built).
"""

from __future__ import annotations

import dataclasses
import logging
import os

logger = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class Flag:
    name: str
    kind: type  # bool | int | float | str
    default: object
    help: str


_REGISTRY: dict[str, Flag] = {}


def declare(name: str, kind: type, default, help_: str) -> Flag:
    flag = Flag(name, kind, default, help_)
    _REGISTRY[name] = flag
    return flag


def _parse(flag: Flag, raw: str):
    if flag.kind is bool:
        return raw.strip().lower() in ("1", "true", "yes", "on")
    try:
        return flag.kind(raw)
    except ValueError:
        logger.warning(
            "ignoring unparsable %s=%r (want %s)", flag.name, raw,
            flag.kind.__name__,
        )
        return flag.default


def get(name: str):
    """Read a declared switch from the environment (or its default); an
    undeclared name is a typo and raises KeyError."""
    flag = _REGISTRY[name]
    raw = os.environ.get(flag.name)
    if raw is None:
        return flag.default
    return _parse(flag, raw)


def import_declaring_modules() -> None:
    """Import every port module that declares switches, so describe() is
    complete (kept next to the registry: a new declare() site is added
    here once)."""
    import bloombee_tpu_torch.client.integrity  # noqa: F401
    import bloombee_tpu_torch.client.session  # noqa: F401
    import bloombee_tpu_torch.kv.cache_manager  # noqa: F401
    import bloombee_tpu_torch.kv.prefix  # noqa: F401
    import bloombee_tpu_torch.runtime.executor  # noqa: F401
    import bloombee_tpu_torch.server.block_server  # noqa: F401
    import bloombee_tpu_torch.server.compute_queue  # noqa: F401
    import bloombee_tpu_torch.utils.clock  # noqa: F401
    import bloombee_tpu_torch.utils.ledger  # noqa: F401
    import bloombee_tpu_torch.wire.faults  # noqa: F401
    import bloombee_tpu_torch.wire.pipeline  # noqa: F401
    import bloombee_tpu_torch.wire.rpc  # noqa: F401
    import bloombee_tpu_torch.wire.tensor_codec  # noqa: F401


def describe() -> str:
    """The switch table as Markdown, in the JAX package's format (the
    declared switches only: call import_declaring_modules() first for all
    of them)."""
    lines = ["| switch | type | default | description |", "|---|---|---|---|"]
    for flag in sorted(_REGISTRY.values(), key=lambda f: f.name):
        lines.append(
            f"| {flag.name} | {flag.kind.__name__} | {flag.default!r} "
            f"| {flag.help} |"
        )
    return "\n".join(lines)

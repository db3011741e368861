"""Model family registry (port of bloombee_tpu/models/auto.py).

Keyed by the HF `model_type`: each family maps a config to a ModelSpec and
loads one layer's parameters from a checkpoint (and, where its names or
conventions differ from Llama's, the client's embeddings, final norm and
head). The port serves llama, mistral, qwen2, qwen3, gemma2, gemma3,
gemma3_text, mixtral, qwen3_moe, bloom and falcon. Every other family the JAX
package serves raises NotImplementedError naming what it needs
(`UNPORTED`, ROADMAP Queue 1 item 15); a model_type neither package knows
raises KeyError.
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import Any, Callable

from bloombee_tpu_torch.models.spec import ModelSpec

_REGISTRY: dict[str, "Family"] = {}

# model_type -> what the port lacks to serve it
UNPORTED = {
    "gemma4": "heterogeneous attention layers (runtime/hetero.py)",
}


class Family:
    """One model family: `spec_fn(config) -> ModelSpec`, a per-layer
    `loader(reader, layer_idx, dtype=, device=) -> dict` and, where the
    client's parameters are not under the Llama names as they are
    (`checkpoint.load_client_params`), a `client_loader(reader, dtype=,
    device=) -> {"embed", "norm", "lm_head", *client_extras}`
    (`client_extras`: Bloom's "embed_norm", "embed_norm_bias" and
    "norm_bias"; Falcon's "norm_bias"). An MoE family also names its
    MLP's HF keys, `moe_keys` (`checkpoint.load_moe_block`)."""

    def __init__(
        self,
        name: str,
        spec_fn: Callable[[Any], ModelSpec],
        loader: Callable,
        client_loader: Callable | None = None,
        moe_keys: tuple | None = None,
        client_extras: tuple[str, ...] = (),
    ):
        self.name = name
        self._spec_fn = spec_fn
        self._loader = loader
        self.client_loader = client_loader
        self.moe_keys = moe_keys
        self.client_extras = client_extras

    def spec_from_config_dict(self, config: dict) -> ModelSpec:
        return self._spec_fn(SimpleNamespace(**config))

    def load_block_params(self, reader, layer_idx: int, dtype=None,
                          device="cuda") -> dict:
        return self._loader(reader, layer_idx, dtype=dtype, device=device)


def register_family(family: Family) -> None:
    _REGISTRY[family.name] = family


def get_family(model_type: str) -> Family:
    if model_type in UNPORTED:
        raise NotImplementedError(
            f"model family {model_type!r} needs {UNPORTED[model_type]}, "
            f"which the port does not have yet (ROADMAP Queue 1 item 15)"
        )
    if model_type not in _REGISTRY:
        raise KeyError(
            f"unknown model family {model_type!r}; known: {sorted(_REGISTRY)}"
        )
    return _REGISTRY[model_type]


def spec_from_hf_config(config: Any) -> ModelSpec:
    return get_family(config.model_type)._spec_fn(config)


def spec_from_config_dict(config: dict) -> ModelSpec:
    return get_family(config.get("model_type", "llama")).spec_from_config_dict(
        config
    )


# ---------------------------------------------------------------- built-ins
def _register_builtins() -> None:
    from bloombee_tpu_torch.models.llama.block import load_hf_block
    from bloombee_tpu_torch.models.llama.config import llama_spec_from_hf

    register_family(Family("llama", llama_spec_from_hf, load_hf_block))
    # side-effect registrations
    import bloombee_tpu_torch.models.bloom  # noqa: F401
    import bloombee_tpu_torch.models.falcon  # noqa: F401
    import bloombee_tpu_torch.models.gemma2  # noqa: F401
    import bloombee_tpu_torch.models.mistral  # noqa: F401
    import bloombee_tpu_torch.models.mixtral  # noqa: F401
    import bloombee_tpu_torch.models.qwen2  # noqa: F401
    import bloombee_tpu_torch.models.qwen3  # noqa: F401


_register_builtins()

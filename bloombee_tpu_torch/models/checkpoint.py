"""HF checkpoint reading for the port (port of
bloombee_tpu/models/checkpoint.py), for every family of the registry
(`models.auto`: Llama, Mistral, Qwen2, Qwen3, Gemma2, Gemma3, Mixtral,
Qwen3-MoE, Bloom, Falcon).

A server loads only its span's layers; a client loads only the embeddings,
the final norm and the LM head. Model directories are local paths
(config.json + *.safetensors [+ index]). `safetensors` is imported inside the
reader, so the package imports where it is not installed. A checkpoint of a
family the port does not serve yet raises NotImplementedError before any
weight is read.
"""

from __future__ import annotations

import json
import pathlib

import torch

from bloombee_tpu_torch.models.llama.block import (
    HF_ATTENTION_KEYS,
    load_hf_block,
)
from bloombee_tpu_torch.models.spec import ModelSpec
from bloombee_tpu_torch.utils.device import resolve_device


class CheckpointReader:
    """Lazy tensor reader over a local HF model directory."""

    def __init__(self, model_dir: str | pathlib.Path):
        from safetensors import safe_open

        self._safe_open = safe_open
        self.dir = pathlib.Path(model_dir)
        with open(self.dir / "config.json") as f:
            self.config = json.load(f)
        index_path = self.dir / "model.safetensors.index.json"
        if index_path.exists():
            with open(index_path) as f:
                self._weight_map = json.load(f)["weight_map"]
        else:
            files = sorted(self.dir.glob("*.safetensors"))
            if not files:
                raise FileNotFoundError(f"no safetensors in {self.dir}")
            self._weight_map = {}
            for fp in files:
                with safe_open(fp, framework="pt") as f:
                    for k in f.keys():
                        self._weight_map[k] = fp.name
        self._handles: dict[str, object] = {}

    def keys(self):
        return self._weight_map.keys()

    def has(self, name: str) -> bool:
        return name in self._weight_map

    def tensor(self, name: str) -> torch.Tensor:
        fname = self._weight_map[name]
        h = self._handles.get(fname)
        if h is None:
            h = self._safe_open(self.dir / fname, framework="pt")
            self._handles[fname] = h
        return h.get_tensor(name)

    def model_type(self) -> str:
        return self.config.get("model_type", "llama")


def read_tensor(reader: CheckpointReader, name: str, dtype=None,
                device="cuda") -> torch.Tensor:
    """One tensor on `device`, cast to `dtype` when given (the shared
    helper of the family loaders)."""
    w = reader.tensor(name)
    return w.to(device=resolve_device(device), dtype=dtype).contiguous()


def stack_expert_weights(
    reader: CheckpointReader, expert_fmt: str, gate_name: str, up_name: str,
    down_name: str, n_experts: int, dtype=None, device="cuda",
) -> dict:
    """Per-expert gate/up/down matrices stacked into `experts_gate` /
    `experts_up` [E, D, I] and `experts_down` [E, I, D] on `device` (the
    dense-over-experts layout of the Mixtral and Qwen3-MoE loaders).
    `expert_fmt` receives the expert index. Each expert's tensor is read
    alone, moved to the device, transposed to [in, out] and copied into
    its slot of the stacked tensor, allocated once: the host holds one
    expert's matrix at a time and the device the layer's experts plus
    one."""
    device = resolve_device(device)
    out = {}
    for key, name in (("experts_gate", gate_name), ("experts_up", up_name),
                      ("experts_down", down_name)):
        stacked = None
        for e in range(n_experts):
            w = reader.tensor(f"{expert_fmt.format(e)}.{name}.weight")
            if stacked is None:  # [out, in] in the checkpoint
                stacked = torch.empty(
                    (n_experts, w.shape[1], w.shape[0]),
                    dtype=dtype or w.dtype, device=device,
                )
            stacked[e].copy_(w.to(device=device, dtype=stacked.dtype).t())
        out[key] = stacked
    return out


def load_moe_block(reader, layer_idx: int, moe_keys: tuple, dtype=None,
                   device="cuda") -> dict:
    """An MoE layer of a checkpoint (Mixtral, Qwen3-MoE): the norms and
    attention projections under the Llama names, the router as [D, E] and
    the experts stacked (`stack_expert_weights`), under the family's
    `moe_keys` = (router, experts' prefix, (gate, up, down)) below the
    layer's prefix (`Family.moe_keys`, e.g. `models.mixtral.HF_MOE_KEYS`)."""
    router, experts, names = moe_keys
    p = f"model.layers.{layer_idx}"
    params = load_hf_block(reader, layer_idx, dtype=dtype, device=device,
                           keys=HF_ATTENTION_KEYS)
    params["router"] = read_tensor(
        reader, f"{p}.{router}.weight", dtype, device
    ).t().contiguous()
    params.update(stack_expert_weights(
        reader, f"{p}.{experts}.{{}}", *names, params["router"].shape[1],
        dtype, device,
    ))
    return params


def load_spec(model_dir: str) -> ModelSpec:
    """ModelSpec from a local model dir via the family registry."""
    from bloombee_tpu_torch.models.auto import spec_from_config_dict

    return spec_from_config_dict(CheckpointReader(model_dir).config)


def load_span_params(
    model_dir: str, start: int, end: int, dtype=None, device="cuda"
) -> tuple[list[dict], ModelSpec]:
    """Per-layer params for blocks [start, end) (a list of dicts) and the
    model's spec."""
    from bloombee_tpu_torch.models.auto import get_family

    device = resolve_device(device)
    reader = CheckpointReader(model_dir)
    family = get_family(reader.model_type())
    spec = family.spec_from_config_dict(reader.config)
    layers = [
        family.load_block_params(reader, i, dtype=dtype, device=device)
        for i in range(start, end)
    ]
    return layers, spec


def load_client_params(model_dir: str, dtype=None, device="cuda") -> dict:
    """Embeddings + final norm + LM head ([D, V]; the embedding's transpose
    when the checkpoint ties them), through the family's `client_loader`
    when it has one (Gemma; Bloom, with its embedding LayerNorm and the
    final norm's bias), else under the Llama names."""
    from bloombee_tpu_torch.models.auto import get_family

    device = resolve_device(device)
    reader = CheckpointReader(model_dir)
    family = get_family(reader.model_type())  # an unported family raises
    if family.client_loader is not None:
        return family.client_loader(reader, dtype=dtype, device=device)
    embed = reader.tensor("model.embed_tokens.weight")
    norm = reader.tensor("model.norm.weight")
    if reader.has("lm_head.weight"):
        head = reader.tensor("lm_head.weight").t()
    else:  # tied embeddings
        head = embed.t()
    return {
        name: x.to(device=device, dtype=dtype).contiguous()
        for name, x in (("embed", embed), ("norm", norm), ("lm_head", head))
    }
